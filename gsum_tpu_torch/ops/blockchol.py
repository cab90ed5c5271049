R"""Blocked batched Cholesky for large N (counterpart of
``gsum_tpu/ops/blockchol.py``).

The left-looking column-block factorization puts nearly all of the N³/3
FLOPs into batched GEMMs:

- at step k the k-th column block is updated with ONE product against all
  finished columns (the history GEMM);
- its diagonal block goes to :func:`~gsum_tpu_torch.ops.chol_inv.chol_inv_block`
  (factor and triangular inverse in one CUDA kernel) for f32 input;
- the panel below the diagonal is a GEMM against that inverse, the usual
  accelerator rewrite of a triangular solve;
- the logpdf's forward substitution reuses the same inverses, N/block
  sequential GEMM steps instead of N.

Two functions are differentiable, each a ``torch.autograd.Function`` with
the JAX package's hand-written backward (its ``custom_vjp``):
:func:`batched_blocked_cholesky` (the Murray adjoint as two blocked
upper-triangular solves) and :func:`blocked_spd_solve_logdet` (the
differentiable lml core: four GEMM passes that reuse the forward's
diagonal-block inverses, so its backward launches no diagonal kernel).

``precision`` is accepted for the JAX package's signatures: every value
computes in full f32.  (JAX's ``Precision.HIGH`` is bf16×3 on the TPU,
for speed; on an NVIDIA H100 3xTF32 products took 1.1 times as long as
full f32 on the blocked pipeline and doubled its error.)
"""
from __future__ import annotations

import torch

from .._config import promoted
from ..profiling import count
from .chol_inv import (MAX_NB, _cholesky_nan, _tri_inv, chol_inv_block,
                       chol_inv_block_plain)

__all__ = ['batched_blocked_cholesky', 'blocked_chol_solve_logdet',
           'blocked_factor', 'blocked_cho_solve', 'blocked_spd_solve_logdet',
           'blocked_tri_inv_diag', 'blocked_solve_lower']


def _check_precision(value, name='precision'):
    """Refuses a ``value`` of ``name`` other than None, ``'highest'`` or
    ``'high'`` (any case); all three compute in full f32."""
    if value is not None and not (isinstance(value, str)
                                  and value.lower() in ('highest', 'high')):
        raise ValueError("%s must be None, 'highest' or 'high', got %r"
                         % (name, value))


def _diag_engine(K, block, diag):
    """``'kernel'`` (the CUDA diagonal kernel, or its plain version for a CPU
    tensor) where the kernel takes the blocks, else ``'recursive'``
    (``torch.linalg``)."""
    if diag != 'auto':
        return diag
    if (K.dtype == torch.float32 and K.ndim == 3 and block % 32 == 0
            and block <= MAX_NB):
        return 'kernel'
    return 'recursive'


def _factor_diag(Akk, engine):
    """(L, Minv) of a (B, block, block) SPD diagonal block."""
    if engine == 'kernel':
        return chol_inv_block(Akk.contiguous())
    if engine == 'recursive':
        return chol_inv_block_plain(Akk)
    if engine == 'hier':
        return _factor_diag_hier(Akk)
    raise ValueError(f"unknown diagonal engine {engine!r} "
                     f"(expected 'auto', 'kernel', 'recursive' or 'hier')")


_HIER_SUB = 128   # the base width of the 'hier' engine


def _factor_diag_hier(Akk, sub=_HIER_SUB):
    """(L, Minv) of a (..., b, b) SPD diagonal block by recursive 2×2
    splitting down to ``sub``-wide bases, each factored by the ``'auto'``
    diagonal engine (the CUDA kernel for f32 on the card).

    Three products per split (the panel as a product with the inverse, the
    Schur update, the inverse's off-diagonal block
    ``[[M1, 0], [−M2 L21 M1, M2]]``), so a wide column block keeps a wide
    history product while its diagonal runs at the base width.
    """
    b = Akk.shape[-1]
    if b <= sub:
        return _factor_diag(Akk, _diag_engine(Akk, b, 'auto'))
    h = max(b // sub // 2, 1) * sub        # the lower split, a sub multiple
    L11, M1 = _factor_diag_hier(Akk[..., :h, :h], sub)
    L21 = Akk[..., h:, :h] @ M1.mT
    L22, M2 = _factor_diag_hier(Akk[..., h:, h:] - L21 @ L21.mT, sub)
    z = Akk.new_zeros(Akk.shape[:-2] + (h, b - h))
    L = torch.cat([torch.cat([L11, z], -1), torch.cat([L21, L22], -1)], -2)
    M21 = -(M2 @ (L21 @ M1))
    Minv = torch.cat([torch.cat([M1, z], -1), torch.cat([M21, M2], -1)], -2)
    return L, Minv


def _blocked_factor(K, block, engine):
    """Left-looking blocked factorization of K, N a multiple of ``block``.

    Returns (L, minvs): the factor and the list of diagonal-block inverses.
    L is one preallocated buffer written column block by column block in
    place (where JAX writes ``L.at[...].set``); the history GEMM reads
    strided views of it.
    """
    N = K.shape[-1]
    L = torch.zeros_like(K)
    minvs = []
    for k in range(N // block):
        s = k * block
        A_col = K[..., s:, s:s + block]             # (..., N-s, b)
        if k:
            # one GEMM against all finished columns: rows s:, cols :s
            A_col = A_col - torch.matmul(L[..., s:, :s],
                                         L[..., s:s + block, :s].mT)
        Lkk, Minv = _factor_diag(A_col[..., :block, :], engine)
        minvs.append(Minv)
        L[..., s:s + block, s:s + block] = Lkk
        if s + block < N:
            L[..., s + block:, s:s + block] = torch.matmul(
                A_col[..., block:, :], Minv.mT)
    return L, minvs


def _pad_spd(K, block):
    """Pads K to a block multiple with an identity extension."""
    N = K.shape[-1]
    pad = -N % block
    if not pad:
        return K, 0
    Kp = K.new_zeros(K.shape[:-2] + (N + pad, N + pad))
    Kp[..., :N, :N] = K
    Kp[..., N:, N:].diagonal(dim1=-2, dim2=-1).fill_(1)
    return Kp, pad


def _pad_rows(Y, pad):
    return torch.nn.functional.pad(Y, (0, 0, 0, pad)) if pad else Y


def _blocked_lower_solve(L, minvs, Y):
    """Solves ``L w = Y`` by blocked forward substitution against the
    diagonal-block inverses; shapes pre-padded."""
    block = minvs[0].shape[-1]
    w = torch.empty_like(Y)
    for k, Minv in enumerate(minvs):
        s = k * block
        rhs = Y[..., s:s + block, :]
        if k:
            rhs = rhs - torch.matmul(L[..., s:s + block, :s], w[..., :s, :])
        w[..., s:s + block, :] = torch.matmul(Minv, rhs)
    return w


def _blocked_upperT_solve(L, minvs, Y):
    """Solves ``Lᵀ x = Y`` by blocked backward substitution; shapes
    pre-padded."""
    block = minvs[0].shape[-1]
    nb = len(minvs)
    x = torch.empty_like(Y)
    for k in reversed(range(nb)):
        s = k * block
        rhs = Y[..., s:s + block, :]
        if k < nb - 1:
            L_below = L[..., s + block:, s:s + block]          # (..., r, b)
            rhs = rhs - torch.matmul(L_below.mT, x[..., s + block:, :])
        x[..., s:s + block, :] = torch.matmul(minvs[k].mT, rhs)
    return x


def _logdet_from_chol(L):
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def blocked_chol_solve_logdet(K, Y, block=256, leaf=32, precision=None,
                              diag='auto'):
    R"""Factors K, solves ``L w = Y``, and returns (w, logdet K) in one pass.

    Parameters
    ----------
    K : (..., N, N) SPD;  Y : (..., N, m) — an f32 Y beside an f64 K (or
        the reverse) is promoted, as JAX's arithmetic promotes
    block : column-block width; N ≤ block factors K in one piece
    leaf : accepted for the JAX signature; it has no effect (the JAX
        package's leaf recursion of the diagonal blocks is its TPU
        kernel's, and the port factors a diagonal block whole)
    precision : None | 'highest' | 'high' — accepted for the JAX
        signature; every value computes in full f32
    diag : 'auto' | 'kernel' | 'recursive' | 'hier' — diagonal-block engine

    Returns
    -------
    (w, logdet): ``w = L⁻¹ Y`` with ``K = L Lᵀ``, and log|K| (...,)
    """
    K, Y = promoted(K, Y)
    N = K.shape[-1]
    _check_precision(precision)
    if N <= block:
        L = _cholesky_nan(K)
        w = torch.linalg.solve_triangular(L, Y, upper=False)
        return w, _logdet_from_chol(L)

    engine = _diag_engine(K, block, diag)
    Kp, pad = _pad_spd(K, block)
    L, minvs = _blocked_factor(Kp, block, engine)
    w = _blocked_lower_solve(L, minvs, _pad_rows(Y, pad))
    if pad:
        w = w[..., :N, :]
        L = L[..., :N, :N]
    return w, _logdet_from_chol(L)


def blocked_factor(K, block=128, leaf=32, precision=None, diag='auto'):
    R"""Factors (..., N, N) SPD K, returning ``(L, minvs)`` for reuse.

    N is padded to a block multiple internally; L comes back un-padded, the
    diagonal-block inverses ``minvs`` padded (the trailing identity block
    solves the padded rows as identity, which :func:`blocked_cho_solve`
    slices away).  Not differentiable.  ``leaf`` is accepted for the JAX
    signature and has no effect (see :func:`blocked_chol_solve_logdet`);
    so is ``precision``: every value computes in full f32.
    """
    _check_precision(precision)
    N = K.shape[-1]
    Kp, pad = _pad_spd(K, block)
    L, minvs = _blocked_factor(Kp, block, _diag_engine(K, block, diag))
    if pad:
        L = L[..., :N, :N]
    return L, minvs


def blocked_cho_solve(L, minvs, Y, precision=None):
    R"""Solves ``(L Lᵀ) X = Y`` from :func:`blocked_factor`'s output.

    nb forward and nb backward blocked-substitution steps, each a batched
    GEMM against the diagonal-block inverses; only the lower triangle of L
    is read.  ``precision`` is accepted for the JAX signature: every value
    computes in full f32.
    """
    _check_precision(precision)
    block = minvs[0].shape[-1]
    N = Y.shape[-2]
    pad = len(minvs) * block - N
    Lp, _ = _pad_spd(L, block)
    w = _blocked_lower_solve(Lp, minvs, _pad_rows(Y, pad))
    x = _blocked_upperT_solve(Lp, minvs, w)
    return x[..., :N, :] if pad else x


def blocked_tri_inv_diag(L, block=128, leaf=32):
    R"""Differentiable diagonal-block inverses of a blocked factor.

    The list of (..., block, block) inverses of L's diagonal blocks, the
    trailing one identity-padded when N is not a block multiple (the
    padding convention of :func:`blocked_cho_solve`), each a triangular
    solve against the identity (``torch.linalg``, differentiable by
    autograd).  ``leaf`` is accepted for the JAX signature and ignored.
    """
    N = L.shape[-1]
    minvs = []
    for s in range(0, N, block):
        blk = L[..., s:s + block, s:s + block]
        pad = block - blk.shape[-1]
        if pad:
            blk, _ = _pad_spd(blk, block)
        minvs.append(_tri_inv(blk))
    return minvs


def blocked_solve_lower(L, Y, leaf=32):
    """Solves ``L X = Y`` for lower-triangular L (``smallchol``'s batched
    triangular solve; ``leaf`` is accepted and ignored).  The fused
    factor-and-solve path is :func:`blocked_chol_solve_logdet`, which reuses
    the factorization's diagonal-block inverses."""
    return torch.linalg.solve_triangular(L, Y, upper=False)


def _blocked_cholesky_raw(K, block, diag):
    N = K.shape[-1]
    if N <= block:
        return _cholesky_nan(K)
    Kp, pad = _pad_spd(K, block)
    L, _ = _blocked_factor(Kp, block, _diag_engine(K, block, diag))
    return L[..., :N, :N] if pad else L


class _BlockedCholesky(torch.autograd.Function):
    """L = chol(K) with the analytic Cholesky adjoint (Murray 2016):
    ``K̄ = ½ sym(L⁻ᵀ Φ(Lᵀ L̄) L⁻¹)``, the sandwich run as two blocked
    upper-triangular solves with N right-hand sides."""

    @staticmethod
    def forward(ctx, K, block, diag):
        ctx.block = block
        L = _blocked_cholesky_raw(K, block, diag)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        block = ctx.block
        n = L.shape[-1]
        W = L.mT @ Lbar
        W = torch.tril(W) - 0.5 * W * torch.eye(n, dtype=L.dtype,
                                                device=L.device)
        if n <= block:
            M = _tri_inv(L)
            Abar = M.mT @ (W @ M)
        else:
            # the identity extension keeps Lp triangular; the diagonal
            # blocks are triangular, so their inverses are triangular
            # solves, not the SPD diagonal kernel
            Lp, pad = _pad_spd(L, block)
            if pad:
                W = torch.nn.functional.pad(W, (0, pad, 0, pad))
            minvs = [_tri_inv(Lp[..., s:s + block, s:s + block])
                     for s in range(0, Lp.shape[-1], block)]
            # T = W L⁻¹ via Tᵀ = L⁻ᵀ Wᵀ;  then  K̄ = L⁻ᵀ T
            Tt = _blocked_upperT_solve(Lp, minvs, W.mT)
            Abar = _blocked_upperT_solve(Lp, minvs, Tt.mT)
            if pad:
                Abar = Abar[..., :n, :n]
        return 0.5 * (Abar + Abar.mT), None, None


def batched_blocked_cholesky(K, block=256, leaf=32, precision=None,
                             diag='auto'):
    R"""Cholesky of (..., N, N) SPD matrices with GEMM-dominated blocking,
    differentiable.

    Parameters
    ----------
    K : (..., N, N) SPD matrices (batch dims lead)
    block : column-block width; N ≤ block factors K in one piece
    leaf : accepted for the JAX signature and ignored
    precision : None | 'highest' | 'high' — accepted for the JAX
        signature; every value computes in full f32
    diag : 'auto' | 'kernel' | 'recursive' | 'hier' — diagonal-block
        engine of the forward ('auto': the CUDA kernel for f32 3-D input)

    The same factor as ``torch.linalg.cholesky`` to round-off; a matrix
    whose factorization fails gives a non-finite or non-positive diagonal.
    The backward launches no diagonal kernel.
    """
    _check_precision(precision)
    return _BlockedCholesky.apply(K, block, diag)


class _BlockedSpdSolveLogdet(torch.autograd.Function):
    """``(K⁻¹Y, log|K|, ok)`` with the four-GEMM backward:

        M = L⁻¹            (one blocked N-RHS forward substitution)
        Ȳ = K⁻¹ X̄ = Mᵀ(M X̄)
        K̄ = l̄·MᵀM − Ȳ Xᵀ   (zeroed where ``ok`` is False)
    """

    @staticmethod
    def forward(ctx, K, Y, block, diag):
        N = K.shape[-1]
        Kp, pad = _pad_spd(K, block)
        L, minvs = _blocked_factor(Kp, block, _diag_engine(K, block, diag))
        d = torch.diagonal(L, dim1=-2, dim2=-1)[..., :N]
        ok = torch.all(torch.isfinite(d) & (d > 0), dim=-1)
        x = _blocked_upperT_solve(
            L, minvs, _blocked_lower_solve(L, minvs, _pad_rows(Y, pad)))
        if pad:
            x = x[..., :N, :]
        logdet = 2.0 * torch.sum(torch.log(d), dim=-1)
        ctx.mark_non_differentiable(ok)
        ctx.save_for_backward(x, ok, L, *minvs)
        return x, logdet, ok

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, xbar, lbar, _):
        x, ok, L, *minvs = ctx.saved_tensors
        N = x.shape[-2]
        pad = L.shape[-1] - N
        # the padded tail of L is an identity block and inverts to itself
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        M = _blocked_lower_solve(L, minvs, eye.expand_as(L))
        Mt = M.mT
        ybar = Mt @ (M @ _pad_rows(xbar, pad))               # K⁻¹ X̄
        kbar = lbar[..., None, None] * (Mt @ M) \
            - ybar @ _pad_rows(x, pad).mT
        if pad:
            kbar = kbar[..., :N, :N]
            ybar = ybar[..., :N, :]
        # a failed factorization carries NaN through L and M: its gradients
        # are zeroed, not propagated as 0·NaN
        okc = ok[..., None, None]
        return (torch.where(okc, kbar, 0.0), torch.where(okc, ybar, 0.0),
                None, None)


def blocked_spd_solve_logdet(K, Y, block=128, leaf=32, precision=None,
                             diag='auto'):
    R"""``(K⁻¹Y, log|K|, ok)`` for batched SPD K, differentiable in K and
    Y: the large-N log-marginal-likelihood core.

    A log-marginal likelihood uses the factorization only through
    ``K⁻¹[y, basis]`` and ``log|K|``, so the backward is written at that
    boundary: four blocked GEMM passes that reuse the forward's
    diagonal-block inverses (no diagonal kernel runs in the backward).
    ``ok`` (per matrix: the factor's diagonal is finite and positive) is an
    output; callers mask ``-inf`` themselves, and the gradients of a failed
    matrix are zero.

    Parameters
    ----------
    K : (..., N, N) SPD;  Y : (..., N, m)
    block : column-block width (N is padded to a multiple of it)
    leaf : accepted for the JAX signature and ignored
    precision : None | 'highest' | 'high' — accepted for the JAX
        signature; every value computes in full f32
    diag : 'auto' | 'kernel' | 'recursive' | 'hier' — diagonal-block engine

    Each matrix of K counts once in ``chol.matrices``.
    """
    _check_precision(precision)
    count('chol.matrices', K.shape[:-2].numel())
    return _BlockedSpdSolveLogdet.apply(*promoted(K, Y), block, diag)
