R"""Batched covariance build, Cholesky and MVN logpdf (counterpart of
``gsum_tpu/ops/batched.py``).

The reference's hot loop is covariance build → Cholesky → solves → logdet
for each log-marginal-likelihood evaluation; here the same work runs
batched over leading dimensions.  :func:`batched_chol_logpdf` is the
pipeline that ``bench.py`` measures for the JAX package.

GEMMs run in full f32 by default: one TF32 product keeps about three
decimal digits, enough to break positive-definiteness of a large
covariance.  ``batched_chol_logpdf(precision='high')`` runs the blocked
route's factorization as 3xTF32 products (``ops.blockchol``), the
counterpart of JAX's ``precision=Precision.HIGH``.
"""
from __future__ import annotations

import math

import torch

from .blockchol import _logdet_from_chol, blocked_chol_solve_logdet
from .chol_inv import _cholesky_nan
from .fusedchol import fused_chol_solve_logdet

_LOG_2PI = math.log(2 * math.pi)

__all__ = ['rbf_covariance', 'batched_cholesky', 'batched_mvn_logpdf',
           'batched_chol_logpdf']


def _batch_scalar(v, X, trailing):
    """``v`` as a Python number, or as a tensor of X's batch shape followed
    by ``trailing`` unit dimensions, in X's dtype and on X's device."""
    if isinstance(v, (int, float)):
        return v
    t = torch.as_tensor(v, dtype=X.dtype, device=X.device)
    return t.reshape(t.shape + (1,) * trailing)


def rbf_covariance(X, length_scale, amplitude=1.0, noise=0.0):
    R"""RBF covariance by the dot-product expansion, batched over X's leading
    dimensions.

    ``K = amplitude * exp(-0.5 ||x_i - x_j||^2 / ls^2) + noise * I``.

    Parameters
    ----------
    X : (..., N, d)
    length_scale, amplitude, noise : numbers, or tensors of X's batch shape
        (``noise=None`` adds no nugget)

    Uses the ``x^2 + y^2 - 2xy`` expansion, so the (..., N, N, d) differences
    never materialize and the inner product is a GEMM.
    """
    Xs = X / _batch_scalar(length_scale, X, 2)
    sq = torch.sum(Xs * Xs, dim=-1)
    gram = torch.matmul(Xs, Xs.transpose(-1, -2))
    # From here every step updates one (..., N, N) buffer in place where JAX
    # builds a new array; the rounding is JAX's: (sq_i + sq_j) - 2·gram.
    K = sq[..., :, None] + sq[..., None, :]
    K.sub_(gram, alpha=2.0)
    del gram
    K.clamp_min_(0.0).mul_(-0.5).exp_().mul_(_batch_scalar(amplitude, X, 2))
    if noise is not None:
        K.diagonal(dim1=-2, dim2=-1).add_(_batch_scalar(noise, X, 1))
    return K


def batched_cholesky(K):
    """Cholesky over a batch of matrices (``torch.linalg``); a failed
    factorization comes back all NaN, as JAX's does."""
    return _cholesky_nan(K)


def _logpdf_from_chol(L, diff):
    """MVN logpdf given the Cholesky factor and (..., N, m) residuals."""
    N = L.shape[-1]
    w = torch.linalg.solve_triangular(L, diff, upper=False)
    maha = torch.sum(w * w, dim=-2)
    return -0.5 * (maha + _logdet_from_chol(L)[..., None] + N * _LOG_2PI)


def batched_mvn_logpdf(K, diff):
    """logpdf of residual columns under N(0, K), batched over leading dims.

    Parameters
    ----------
    K : (..., N, N)
    diff : (..., N, m) — m residual vectors per batch element

    Returns
    -------
    (..., m) log-densities
    """
    return _logpdf_from_chol(batched_cholesky(K), diff)


def batched_chol_logpdf(X, y, length_scale, amplitude, noise, method='auto',
                        precision=None, diag='auto', block=None):
    R"""Pipeline: covariance build → Cholesky → MVN logpdf.

    Parameters
    ----------
    X : (B, N, d)
    y : (B, N, m)
    length_scale, amplitude, noise : numbers or (B,) tensors
    method : 'auto' | 'blocked' | 'fused' | 'xla' — factorization engine.
        'blocked' is the left-looking blocked factorization
        (``ops.blockchol``) whose diagonal blocks go to the CUDA kernel for
        f32 input; 'fused' is the same factorization in one kernel launch
        (``ops.fusedchol``, f32 only, N a multiple of the block); 'xla' is
        ``torch.linalg.cholesky`` (the name is the JAX package's); 'auto'
        selects 'blocked' for N > 512.
    precision : None (= 'highest') | 'highest' | 'high' — arithmetic of
        the blocked route's factorization GEMMs ('high' is 3xTF32, three
        TF32 tensor-core products on split operands,
        ``ops.blockchol._mm``).  The covariance build and the solve stay
        full f32, as in JAX, and the fused route's kernel and the diagonal
        kernel do FFMA arithmetic, unaffected.
    diag : the blocked factorization's diagonal-block engine, 'auto' |
        'kernel' | 'recursive' (``torch.linalg``)
    block : column-block width, or None for the selected engine's default
        (blocked: 128, fused: 256)

    Returns
    -------
    (B, m) log-densities
    """
    N = X.shape[-2]
    K = rbf_covariance(X, length_scale, amplitude, noise)
    if method == 'auto':
        method = 'blocked' if N > 512 else 'xla'
    if method == 'fused':
        w, logdet = fused_chol_solve_logdet(K, y, block=block or 256)
    elif method == 'blocked':
        w, logdet = blocked_chol_solve_logdet(K, y, block=block or 128,
                                              diag=diag, precision=precision)
    elif method == 'xla':
        return _logpdf_from_chol(batched_cholesky(K), y)
    else:
        raise ValueError(f"unknown method {method!r} (expected 'auto', "
                         f"'blocked', 'xla' or 'fused')")
    maha = torch.sum(w * w, dim=-2)
    return -0.5 * (maha + logdet[..., None] + N * _LOG_2PI)
