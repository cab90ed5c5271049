R"""The flagship step of the port: the twin of
``__graft_entry__._flagship_step`` of the JAX package.

:func:`flagship_step` returns ``(step, kernel)``: ``step(theta, X, y2,
Xnew)`` fits the conjugate GP at the kernel's log-parameters ``theta`` and
predicts at ``Xnew``: covariance build → Cholesky → conjugate posterior →
predictive mean and covariance, and the log-marginal likelihood.  It is
differentiable in ``theta`` by autograd.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import conjugate as conj
from ._config import default_dtype, resolve_device
from .kernels import RBF, ConstantKernel, WhiteKernel
from .linalg import cholesky, solve_sqrt

__all__ = ['flagship_step']

_LOG_2PI = math.log(2 * math.pi)


def flagship_step(device):
    """``(step, kernel)``: the flagship conjugate-GP step on ``device``.

    ``step(theta, X, y2, Xnew) -> (m_pred, K_pred, lml)``; its inputs may be
    tensors or numpy arrays and are moved to ``device``; ``kernel`` is
    ``ConstantKernel(1) * RBF(1) + WhiteKernel(1e-6, 'fixed')``, whose
    ``theta`` is the step's default point.
    """
    device = resolve_device(device)
    kernel = ConstantKernel(1.0) * RBF(1.0) + WhiteKernel(1e-6, 'fixed')
    frozen = kernel.clone()
    nugget = 1e-10
    df0, scale0 = 3.0, 1.0
    center0 = np.atleast_1d(0.0)
    disp0 = np.atleast_2d(0.0)

    def step(theta, X, y2, Xnew):
        """Fit the conjugate GP at theta and predict at Xnew."""
        theta, X, y2, Xnew = (
            torch.as_tensor(a, device=device).to(default_dtype())
            for a in (theta, X, y2, Xnew))
        N = X.shape[0]
        basis = torch.ones((N, 1), dtype=X.dtype, device=device)
        R = frozen.value_fn(theta, X, None)
        L = cholesky(R + nugget * torch.eye(N, dtype=R.dtype, device=device))

        center = conj.compute_center(y2, L, basis, center0, disp0)
        df = conj.compute_df(y2, df0)
        scale_sq = conj.compute_scale_sq(y2, L, basis, center0, disp0, df0,
                                         scale0)
        var = conj.compute_cov_factor(scale_sq, df)

        mean_old = basis @ center
        basis_new = torch.ones((Xnew.shape[0], 1), dtype=X.dtype,
                               device=device)
        mean_new = basis_new @ center

        R_on = frozen.value_fn(theta, X, Xnew)
        alpha = solve_sqrt(L, y2 - mean_old[:, None], 'cholesky')
        m_pred = mean_new[:, None] + R_on.mT @ alpha

        R_nn = frozen.value_fn(theta, Xnew, None)
        R_pred = R_nn - R_on.mT @ solve_sqrt(L, R_on, 'cholesky')
        K_pred = var * R_pred

        logdet = 2 * torch.sum(torch.log(torch.diagonal(L)))
        y_c = y2 - mean_old[:, None]
        quad = torch.sum(y_c * solve_sqrt(L, y_c, 'cholesky')) / var
        ncurves = y2.shape[1]
        lml = -0.5 * (quad + ncurves * (logdet + N * torch.log(var)
                                        + N * _LOG_2PI))
        return m_pred, K_pred, lml

    return step, kernel
