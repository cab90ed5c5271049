R"""Dense linear algebra for the conjugate-process models (counterpart of
``gsum_tpu/linalg.py``).

Cholesky, pivoted Cholesky, Cholesky and triangular solves, the symmetric
eigendecomposition, and the whitening / Mahalanobis helpers built on them,
on ``torch.linalg`` (cuSOLVER on the card, LAPACK on the CPU).  Every
function is differentiable by autograd and follows its inputs' device and
dtype.

A failed factorization gives NaN, as JAX's Cholesky does, never an
exception: ``torch.linalg.cholesky`` raises and ``cholesky_ex`` returns a
partial factor, so :func:`cholesky` fills the factor of a failed matrix
with NaN, and :func:`safe_cholesky` and the jitter ladder test for finite
diagonals as in JAX.

f64 products on the card are true f64 and f32 products run in full f32
(TF32 off, PyTorch's default), so the JAX package's ``f64_precision`` scope
has nothing to do here and is kept as a no-op for its callers.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch

from .ops.chol_inv import _cholesky_nan

__all__ = [
    'stabilize', 'cholesky', 'safe_cholesky', 'cho_solve', 'solve_sqrt',
    'pivoted_cholesky', 'cholesky_errors', 'mahalanobis', 'eigh_sqrt',
    'logdet_sqrt', 'spd_solve', 'spd_inv', 'spd_logdet', 'robust_spd_solve',
    'robust_cholesky', 'robust_cho_solve', 'general_solve', 'f64_precision',
]


def f64_precision(dtype):
    """No-op context, kept for the JAX package's API: the TPU needed a
    matmul-precision scope for f64 products; the card does not."""
    return nullcontext()


def _eye(M):
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def _diag(M):
    return torch.diagonal(M, dim1=-2, dim2=-1)


def stabilize(M, jitter=1e-5):
    """Adds diagonal jitter to a square matrix."""
    return M + jitter * _eye(M)


def cholesky(M):
    """Lower Cholesky factor; all NaN where the factorization fails."""
    return _cholesky_nan(M)


def safe_cholesky(M):
    """Cholesky factor plus a success flag.

    Returns
    -------
    L : lower Cholesky factor (NaN on failure)
    ok : bool tensor, True where the factorization succeeded
    """
    L = _cholesky_nan(M)
    ok = torch.all(torch.isfinite(_diag(L)), dim=-1)
    return L, ok


def cho_solve(L, b):
    """Solves ``M x = b`` given the lower Cholesky factor of M; ``b`` may be
    a vector (``torch.cholesky_solve`` itself takes matrices only)."""
    if b.ndim == L.ndim - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)


def spd_solve(M, b):
    """Solves ``M x = b`` for symmetric positive-definite M via Cholesky."""
    return cho_solve(_cholesky_nan(M), b)


def robust_cholesky(M, jitters=(0.0, 1e-12, 1e-9, 1e-6)):
    """``(L, ok)``: the first successful factor over an escalating
    relative-jitter ladder.

    Factors ``M + j * max(diag(M)) * I`` for each jitter in order and keeps
    the first that succeeds; every step is computed and the choice made by
    ``where``, so nothing waits on the device.  ``ok`` is False (and L the
    identity) only when every step failed.
    """
    eye = _eye(M)
    scale = torch.max(_diag(M))

    L_sel = None
    ok_sel = None
    for j in jitters:
        L_j = _cholesky_nan(M + (j * scale) * eye)
        ok_j = torch.all(torch.isfinite(_diag(L_j)))
        if L_sel is None:
            L_sel, ok_sel = L_j, ok_j
        else:
            take = (~ok_sel) & ok_j
            L_sel = torch.where(take, L_j, L_sel)
            ok_sel = ok_sel | ok_j
    # sanitize in case every ladder step failed so downstream stays finite
    L_sel = torch.where(ok_sel, L_sel, eye)
    return L_sel, ok_sel


def robust_cho_solve(Lok, b):
    """Solves with a :func:`robust_cholesky` ``(L, ok)`` pair; NaN when the
    whole ladder failed."""
    L, ok = Lok
    x = cho_solve(L, b)
    return torch.where(ok, x, torch.full_like(x, float('nan')))


def robust_spd_solve(M, b, jitters=(0.0, 1e-12, 1e-9, 1e-6)):
    """SPD solve with an escalating relative-jitter ladder: one
    :func:`robust_cholesky` and a solve."""
    return robust_cho_solve(robust_cholesky(M, jitters), b)


def spd_inv(M):
    """Inverse of a symmetric positive-definite matrix via Cholesky."""
    return cho_solve(_cholesky_nan(M), _eye(M))


def spd_logdet(M):
    """log|M| for symmetric positive-definite M."""
    return 2.0 * torch.sum(torch.log(_diag(_cholesky_nan(M))), dim=-1)


def eigh_sqrt(M):
    """Symmetric eigendecomposition ``(eig, Q)``, the 'eig' backend."""
    eig, Q = torch.linalg.eigh(M)
    return eig, Q


def general_solve(A, b):
    R"""Solves ``A x = b`` for a general square A through the normal
    equations ``(AᵀA) x = Aᵀ b`` and the SPD solver, as the JAX package
    does (it had no f64 LU on the TPU); kept so that results match.  For
    the square roots S of M = S Sᵀ passed here, cond(AᵀA) = cond(M).
    """
    At = A.mT
    AtA = At @ A
    Atb = At @ (b if b.ndim > 1 else b[:, None])
    x = robust_spd_solve(AtA, Atb)
    return x if b.ndim > 1 else x[:, 0]


def solve_sqrt(sqrt_mat, y, decomposition):
    R"""Solves ``M x = y`` given a square root of M.

    - ``'cholesky'``: ``sqrt_mat`` is lower-triangular L with M = L Lᵀ.
    - ``'eig'``: ``sqrt_mat`` is either a tuple ``(eig, Q)`` with
      M = Q diag(eig) Qᵀ, or a general square root matrix S with M = S Sᵀ.
    """
    if decomposition == 'cholesky':
        return cho_solve(sqrt_mat, y)
    elif decomposition == 'eig':
        if isinstance(sqrt_mat, tuple):
            eig, Q = sqrt_mat
            if y.ndim > 1:
                return Q @ ((Q.mT @ y).mT / eig).mT
            return Q @ ((Q.mT @ y) / eig)
        return robust_spd_solve(sqrt_mat @ sqrt_mat.mT, y)
    else:
        raise ValueError('decomposition must be either "cholesky" or "eig"')


def logdet_sqrt(sqrt_mat, decomposition):
    """log|M| from a square root of M (cholesky L or (eig, Q) tuple)."""
    if decomposition == 'cholesky':
        return 2 * torch.sum(torch.log(_diag(sqrt_mat)), dim=-1)
    elif decomposition == 'eig':
        eig, _ = sqrt_mat
        return torch.sum(torch.log(eig), dim=-1)
    raise ValueError('decomposition must be either "cholesky" or "eig"')


def pivoted_cholesky(M, return_pivots=False):
    R"""Pivoted Cholesky factorization G with ``M = G Gᵀ``.

    The JAX package's fixed-trip reimplementation of LAPACK ``dpstrf``, a
    rank-1 step per column: the largest remaining diagonal entry is chosen
    as pivot, rows and columns are exchanged, and a masked outer-product
    update is applied; once a pivot falls below ``N·eps·max(diag)`` the
    factorization stops (the rank stops advancing).  Rows of the returned
    factor are restored to the original ordering.

    Parameters
    ----------
    M : (N, N) symmetric positive-semidefinite tensor
    return_pivots : also return the pivot order and the numerical rank
    """
    N = M.shape[0]
    tol = N * torch.finfo(M.dtype).eps * torch.max(torch.diagonal(M))
    idx = torch.arange(N, device=M.device)
    A, piv = M, idx.clone()
    rank = torch.zeros((), dtype=idx.dtype, device=M.device)
    for k in range(N):
        d_masked = torch.where(idx >= k, torch.diagonal(A), -torch.inf)
        j = torch.argmax(d_masked)
        pivot_ok = (d_masked[j] > tol) & (rank == k)

        perm = idx.clone()
        perm[k] = j
        perm[j] = k
        A = A[perm][:, perm]
        piv = piv[perm]

        akk = torch.sqrt(torch.clamp(A[k, k], min=0.0))
        inv_akk = torch.where(pivot_ok & (akk > 0), 1.0 / akk, 0.0)
        # below-diagonal part of L's column k (all zero when the pivot is
        # not OK); the masked outer product touches only the trailing block
        col = torch.where(idx > k, A[:, k] * inv_akk, 0.0)
        A = A - torch.outer(col, col)
        col = col.clone()
        col[k] = torch.where(pivot_ok, akk, 0.0)
        A[:, k] = col
        rank = rank + pivot_ok.to(rank.dtype)
    L = torch.tril(A)
    G = L[torch.argsort(piv)]
    if return_pivots:
        return G, piv, rank
    return G


def _T(a):
    """JAX's ``.T`` of a vector or a matrix of row vectors: a 1-D vector is
    its own transpose (torch's ``.mT`` refuses it)."""
    return a.mT if a.ndim >= 2 else a


def cholesky_errors(y, mean, chol):
    R"""Whitened residuals ``L^{-1}(y - mean)`` (row vectors in and out; a
    1-D ``y`` gives one whitened vector)."""
    r = _T(y - mean)
    if r.ndim == 1:
        return torch.linalg.solve_triangular(chol, r[:, None], upper=False)[:, 0]
    return _T(torch.linalg.solve_triangular(chol, r, upper=False))


def mahalanobis(y, mean, chol=None, inv=None, sqrt_mat=None):
    R"""Mahalanobis distance via a Cholesky factor, inverse, or general
    square root; one distance per row of ``y``, a scalar for a 1-D ``y``."""
    given = sum(x is not None for x in (chol, inv, sqrt_mat))
    if given > 1:
        raise ValueError('Only one of chol, inv, or sqrt_mat can be given')
    if chol is not None:
        err = cholesky_errors(y, mean, chol)
        return torch.linalg.norm(err, dim=-1)
    if sqrt_mat is not None:
        err = _T(general_solve(sqrt_mat, _T(y - mean)))
        return torch.linalg.norm(err, dim=-1)
    diff = torch.atleast_2d(y) - mean
    return torch.squeeze(torch.sqrt(torch.einsum('ij,jk,ik->i', diff, inv, diff)))
