R"""Blocked Cholesky that returns its diagonal-block inverses, and the solve
that uses them (counterpart of ``gsum_tpu/ops/scanchol.py``).

The JAX package runs the factorization as a ``lax.scan`` over column slabs
to keep its compiled program a constant size in N, at the price of a
full-height history product every step (about 6× the N³/3 FLOPs).  PyTorch
compiles nothing, so the port keeps the interface and drops that trade:
the same left-looking column-block factorization, each step's history
product over the rows at and below its diagonal only, each diagonal block
factored and inverted through ``ops.smallchol`` (``torch.linalg``, not the
CUDA diagonal kernel, as the JAX scan body uses ``smallchol``).  The
factor is built column block by column block out of place, so autograd
differentiates it.

reference: no counterpart in ``gsum`` — it runs LAPACK ``dpotrf`` once
per matrix.
"""
from __future__ import annotations

import torch

from .blockchol import _pad_spd
from .smallchol import batched_small_cholesky, batched_small_tri_inv

__all__ = ['scan_blocked_cholesky', 'scan_cho_solve']


def scan_blocked_cholesky(A, block=64, leaf=16):
    R"""Cholesky of (G, N, N) SPD matrices by column blocks.

    Returns ``(L, minvs)``: the (G, N, N) lower factor and the stacked
    (nb, G, block, block) inverses of its diagonal blocks, the trailing
    one identity-padded when N is not a block multiple (consumed by
    :func:`scan_cho_solve`, whose solves are then products).

    The same factor as ``torch.linalg.cholesky`` to round-off; a matrix
    whose factorization fails gives NaN from its failed diagonal block on,
    flagged by a non-finite diagonal as with the other engines.
    """
    G, N0, _ = A.shape
    A, pad = _pad_spd(A, block)
    N = A.shape[-1]
    cols, minvs = [], []
    for k in range(N // block):
        s = k * block
        A_col = A[:, s:, s:s + block]                  # (G, N-s, b)
        if k:
            Lf = torch.cat(cols, -1)[:, s:, :]          # finished columns
            A_col = A_col - Lf @ Lf[:, :block, :].mT
        Ld = batched_small_cholesky(A_col[:, :block, :], leaf)
        Minv = batched_small_tri_inv(Ld, leaf)
        panel = A_col[:, block:, :] @ Minv.mT
        cols.append(torch.cat([A.new_zeros((G, s, block)), Ld, panel], -2))
        minvs.append(Minv)
    L = torch.cat(cols, -1)
    if pad:
        L = L[:, :N0, :N0]
    return L, torch.stack(minvs)


def scan_cho_solve(L, minvs, B, block=None):
    R"""Solves ``L Lᵀ X = B`` with the factor of :func:`scan_blocked_cholesky`
    and its diagonal-block inverses: nb forward and nb backward block steps,
    each a batched product.

    Parameters
    ----------
    L : (G, N, N) lower factor
    minvs : (nb, G, block, block) diagonal-block inverses
    B : (G, N, m) right-hand sides
    block : inferred from ``minvs`` (its trailing dimension); given
        explicitly, it must agree
    """
    if block is None:
        block = minvs.shape[-1]
    elif block != minvs.shape[-1]:
        raise ValueError('block=%d does not match the factorization block '
                         '%d (minvs.shape[-1])' % (block, minvs.shape[-1]))
    N0 = B.shape[-2]
    nb = minvs.shape[0]
    pad = nb * block - N0
    if pad:
        L, _ = _pad_spd(L, block)
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))

    # forward: L w = B, block rows in order
    ws = []
    for k in range(nb):
        s = k * block
        rhs = B[:, s:s + block, :]
        if k:
            rhs = rhs - L[:, s:s + block, :s] @ torch.cat(ws, -2)
        ws.append(minvs[k] @ rhs)
    w = torch.cat(ws, -2)

    # backward: Lᵀ x = w, block rows in reverse
    xs = []
    for k in reversed(range(nb)):
        s = k * block
        rhs = w[:, s:s + block, :]
        if xs:
            rhs = rhs - L[:, s + block:, s:s + block].mT @ torch.cat(xs, -2)
        xs.insert(0, minvs[k].mT @ rhs)
    x = torch.cat(xs, -2)
    return x[:, :N0, :] if pad else x
