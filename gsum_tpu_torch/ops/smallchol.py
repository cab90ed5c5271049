R"""Batched Cholesky, triangular solve and triangular inverse for small and
medium N (counterpart of ``gsum_tpu/ops/smallchol.py``).

The JAX package writes these as recursive 2×2 blockings with unrolled
leaves because XLA's batched Cholesky is latency-bound on a TPU at small
N.  On the card, ``torch.linalg``'s batched routines (cuSOLVER / cuBLAS)
take the batch directly, so each function here is a thin wrapper over
them; ``leaf`` is accepted for the JAX signature and ignored.

Failures follow the JAX package: a matrix whose factorization fails comes
back NaN in its lower triangle (``chol_inv._cholesky_nan``), so the test
``isfinite(diag) & (diag > 0)`` flags it exactly as in JAX.

Gradients are torch's own.  Its Cholesky backward is the symmetrised
Murray adjoint ``½ L⁻ᵀ (Φ + Φᵀ) L⁻¹`` with ``Φ = tril(Lᵀ L̄)`` less half
its diagonal, the JAX package's custom VJP; its triangular-solve backward
keeps the lower triangle, which for the identity right-hand side is JAX's
``tril(−Mᵀ M̄ Mᵀ)``.  ``tests/test_torch_smallchol.py`` holds both against
``jax.vjp``.
"""
from __future__ import annotations

import math

import torch

from .chol_inv import _cholesky_nan, _tri_inv

__all__ = ['batched_small_cholesky', 'batched_small_solve_triangular',
           'batched_small_tri_inv', 'batched_grid_lml']

_LOG_2PI = math.log(2 * math.pi)


def batched_small_cholesky(A, leaf=16):
    """Lower Cholesky factors of a batch of SPD matrices (..., n, n); NaN
    in the lower triangle where the factorization fails."""
    return _cholesky_nan(A)


def batched_small_solve_triangular(L, B, leaf=16):
    """Solves ``L X = B`` for lower-triangular L (only its lower triangle is
    read); L (..., n, n), B (..., n, m)."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def batched_small_tri_inv(L, leaf=16):
    """Inverses of a batch of lower-triangular matrices (..., n, n)."""
    return _tri_inv(L)


def _flag(L):
    """Per matrix: the factor's diagonal is finite and positive."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(d) & (d > 0), dim=-1)


def batched_grid_lml(Ks, y, leaf=16):
    R"""MVN log-marginal likelihood over a batch of covariance matrices.

    Parameters
    ----------
    Ks : (G, N, N) covariance matrices (e.g. one per hyperparameter-grid
        point)
    y : (N, m) or (G, N, m) residuals

    Returns
    -------
    (G,) tensor of Σ_curves log N(y_c | 0, K_g); ``-inf`` where K_g is not
    positive definite.
    """
    G, N, _ = Ks.shape
    L = batched_small_cholesky(Ks, leaf)
    ok = _flag(L)
    L = torch.where(ok[:, None, None], L,
                    torch.eye(N, dtype=L.dtype, device=L.device))
    if y.ndim == 2:
        y = y.expand((G,) + y.shape)
    w = batched_small_solve_triangular(L, y, leaf)
    quad = torch.sum(w * w, dim=(-1, -2))
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    m = y.shape[-1]
    lml = -0.5 * (quad + m * (logdet + N * _LOG_2PI))
    return torch.where(ok, lml, -torch.inf)
