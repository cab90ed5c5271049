R"""Closed-form normal–scaled-inverse-χ² conjugate posterior updates
(counterpart of ``gsum_tpu/conjugate.py``).

Given curves ``y`` drawn iid from a GP with correlation R, basis B, and a
prior (center η₀, dispersion V₀, df ν₀, scale τ₀), these functions compute
the posterior (η, V, ν, τ²).  They are plain functions of tensors,
differentiable by autograd; the models differentiate the log-marginal
likelihood built from them instead of hand-derived gradients.

The prior hyperparameters are concrete (Python / numpy) values, so the
delta-function-mean limit (V₀ = 0) and the known-scale limit (ν₀ = ∞) are
static Python checks, with no NaN-producing branch.  Results are in the
library's default dtype (f64) on the device of ``y``.
"""
from __future__ import annotations

import numpy as np
import torch

from ._config import default_dtype, device_constant
from .linalg import solve_sqrt, spd_inv, spd_solve

__all__ = [
    'avg_y', 'num_y', 'compute_center', 'compute_disp', 'compute_df',
    'compute_scale_sq', 'compute_scale_sq_v2', 'compute_cov_factor',
]


def num_y(y):
    """Number of curves in y (y is (n_samples,) or (n_samples, n_curves))."""
    if y.ndim == 2:
        return y.shape[1]
    return 1


def avg_y(y):
    """Average of y over the curves axis."""
    if y.ndim == 1:
        return y
    elif y.ndim == 2:
        return torch.mean(y, dim=1)
    raise ValueError('y must be at most two-dimensional')


def _is_zero_disp(disp0):
    """Static check for the delta-function prior on the mean (V₀ = 0)."""
    return bool(np.all(np.asarray(disp0) == 0))


def _is_inf_df(df0):
    """Static check for the known-scale prior (ν₀ = ∞)."""
    return bool(np.isinf(np.asarray(df0)))


def _prior(value, like, ndmin):
    """A prior hyperparameter as a tensor of the default dtype on the
    device of ``like``, at least ``ndmin``-dimensional."""
    if isinstance(value, torch.Tensor):
        t = value.to(dtype=default_dtype(), device=like.device)
    else:
        t = device_constant(value, like.device)
    return torch.atleast_1d(t) if ndmin == 1 else torch.atleast_2d(t)


def compute_center(y, sqrt_R, basis, center0, disp0, decomposition='cholesky'):
    R"""Posterior regression-coefficient center η.

    η = V (V₀⁻¹ η₀ + n_y Bᵀ R⁻¹ ȳ); η = η₀ when V₀ = 0.
    """
    center0 = _prior(center0, y, 1)
    if _is_zero_disp(disp0):
        return center0

    disp0_m = _prior(disp0, y, 2)
    ybar = avg_y(y)
    ny = num_y(y)
    invR_y_avg = solve_sqrt(sqrt_R, ybar, decomposition=decomposition)
    disp = compute_disp(y=y, sqrt_R=sqrt_R, basis=basis, disp0=disp0,
                        decomposition=decomposition)
    factor = spd_solve(disp0_m, center0) + ny * basis.mT @ invR_y_avg
    return disp @ factor


def compute_disp(y, sqrt_R, basis, disp0, decomposition='cholesky'):
    R"""Posterior dispersion V = (V₀⁻¹ + n_y Bᵀ R⁻¹ B)⁻¹."""
    if _is_zero_disp(disp0):  # static check before any conversion
        return torch.zeros(np.atleast_2d(np.asarray(disp0)).shape,
                           dtype=default_dtype(), device=y.device)
    disp0 = _prior(disp0, y, 2)
    ny = num_y(y)
    quad = basis.mT @ solve_sqrt(sqrt_R, basis, decomposition=decomposition)
    return spd_inv(spd_inv(disp0) + ny * quad)


def compute_df(y, df0):
    """Posterior degrees of freedom ν = ν₀ + y.size."""
    return df0 + np.prod(y.shape)


def compute_scale_sq(y, sqrt_R, basis, center0, disp0, df0, scale0,
                     decomposition='cholesky'):
    R"""Posterior squared scale τ² via the Woodbury form of Melendez
    Eq. (A31).  Returns τ₀² unchanged when ν₀ = ∞."""
    if _is_inf_df(df0):
        return _prior(scale0, y, 1)[0] ** 2

    if y.ndim == 1:
        y = y[:, None]
    ybar = avg_y(y)
    N = ybar.shape[0]
    ny = num_y(y)
    center0 = _prior(center0, y, 1).to(y.dtype)

    y_centered = y - ybar[:, None]
    invR_yc = solve_sqrt(sqrt_R, y_centered, decomposition=decomposition)
    quad = torch.trace(y_centered.mT @ invR_yc)

    avg_y_centered = ybar - basis @ center0
    disp = compute_disp(y=y, sqrt_R=sqrt_R, basis=basis, disp0=disp0,
                        decomposition=decomposition)
    invR_basis = solve_sqrt(sqrt_R, basis, decomposition=decomposition)
    invR_avg_yc = solve_sqrt(sqrt_R, avg_y_centered,
                             decomposition=decomposition)
    mat = torch.eye(N, dtype=y.dtype, device=y.device) \
        - ny * invR_basis @ disp @ basis.mT
    mat_invR_avg_yc = ny * mat @ invR_avg_yc
    quad2 = avg_y_centered @ mat_invR_avg_yc

    df = compute_df(y=y, df0=df0)
    return (float(df0 * np.asarray(scale0) ** 2) + quad + quad2) / float(df)


def compute_scale_sq_v2(y, sqrt_R, basis, center0, disp0, df0, scale0,
                        decomposition='cholesky'):
    R"""Alternative (non-Woodbury) form of the τ² update, kept as a
    numerical cross-check of :func:`compute_scale_sq`; the V₀ → 0 limit is
    taken explicitly."""
    if _is_inf_df(df0):
        return _prior(scale0, y, 1)[0] ** 2

    if y.ndim == 1:
        y = y[:, None]
    ybar = avg_y(y)
    ny = num_y(y)
    center0 = _prior(center0, y, 1).to(y.dtype)

    if _is_zero_disp(disp0):
        center = center0
        invR_diff0 = solve_sqrt(sqrt_R, 2 * ybar - basis @ center,
                                decomposition=decomposition)
        mean_terms = -ny * center0 @ basis.mT @ invR_diff0
    else:
        disp0_m = _prior(disp0, y, 2).to(y.dtype)
        center = compute_center(y=y, sqrt_R=sqrt_R, basis=basis,
                                center0=center0, disp0=disp0,
                                decomposition=decomposition)
        disp = compute_disp(y=y, sqrt_R=sqrt_R, basis=basis, disp0=disp0,
                            decomposition=decomposition)
        mean_terms = center0 @ spd_solve(disp0_m, center0) \
            - center @ spd_solve(disp, center)

    invR_y = solve_sqrt(sqrt_R, y, decomposition=decomposition)
    quad = torch.trace(y.mT @ invR_y)
    df = compute_df(y=y, df0=df0)
    return (float(df0 * np.asarray(scale0) ** 2) + mean_terms + quad) / float(df)


def compute_cov_factor(scale_sq, df):
    R"""Correlation→covariance factor σ² = ν τ² / (ν − 2) (= τ² when ν = ∞)."""
    if _is_inf_df(df):
        return scale_sq
    return float(df) * scale_sq / (float(df) - 2)
