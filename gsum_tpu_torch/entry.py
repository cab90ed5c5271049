R"""The flagship step of the port: the twin of
``__graft_entry__._flagship_step`` of the JAX package.

:func:`flagship_step` returns ``(step, kernel)``: ``step(theta, X, y2,
Xnew)`` fits the conjugate GP at the kernel's log-parameters ``theta`` and
predicts at ``Xnew``: covariance build → Cholesky → conjugate posterior →
predictive mean and covariance, and the log-marginal likelihood.  It is
differentiable in ``theta`` by autograd.

:func:`dryrun_multichip` is the twin of ``__graft_entry__.dryrun_multichip``:
the sharded legs on an n-device mesh, with the same sizes and tolerances.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import conjugate as conj
from ._config import default_dtype, resolve_device
from .kernels import RBF, ConstantKernel, WhiteKernel
from .linalg import cholesky, solve_sqrt

__all__ = ['flagship_step', 'dryrun_multichip']

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


def _mesh_devices(n_devices, device):
    """``n_devices`` distinct cards where so many are visible and
    ``device`` is a card (or None), else ``device`` repeated: the
    counterpart of JAX's virtual-device subprocess."""
    device = resolve_device('cuda' if device is None else device)
    if device.type == 'cuda' and torch.cuda.device_count() >= n_devices:
        return [torch.device('cuda', i) for i in range(n_devices)]
    return [device] * n_devices


def _assert_close(got, want, rtol=0.0, atol=0.0, what=''):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, dtype=float)
    np.testing.assert_allclose(got, np.asarray(want, dtype=float), rtol=rtol,
                               atol=atol, err_msg=what)


def dryrun_multichip(n_devices, device=None):
    """One sharded step of each multi-device path on an ``n_devices`` mesh.

    The legs of ``__graft_entry__._dryrun_multichip_body``, same sizes and
    tolerances: a sharded ``batched_fit`` on a 2-D mesh;
    ``batched_posterior_at`` (against the unsharded call) and
    ``batched_predict`` on a 'batch' mesh; ``sharded_cholesky`` and
    ``sharded_mvn_lml`` at N = 16·n against numpy and scipy;
    ``sharded_kernel_lml``; ``sharded_fit`` against the dense fixed-trip
    fit through the same objective (|Δθ| ≤ 1e-5, its lml to 1e-9); and
    ``pointwise_evidence_grid`` against ``TruncationPointwise``.  A failed
    check raises ``AssertionError``.

    ``device``: where the mesh runs; None is the CUDA card.  With
    ``n_devices`` cards visible the mesh takes them, else it repeats
    ``device`` (``'cpu'`` runs the legs on the CPU).
    """
    import scipy.linalg as sla

    from .helpers import partials
    from .kernels import Matern
    from .models import TruncationPointwise
    from .optimize import fixed_lbfgs_bounded
    from .parallel import (Mesh, batched_fit, batched_posterior_at,
                           batched_predict, pointwise_evidence_grid,
                           sharded_cholesky, sharded_fit, sharded_kernel_lml,
                           sharded_mvn_lml)
    from .parallel.pchol import _cgp_lml_from_gram

    devices = _mesh_devices(n_devices, device)
    dev = devices[0]
    f64 = dict(dtype=torch.float64, device=dev)

    # data-parallel: a batched MAP fit over the 'batch' axis of a 2-D mesh
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_batch = n_devices // n_model
    mesh = Mesh(np.asarray(devices, dtype=object).reshape(n_batch, n_model),
                ('batch', 'model'))
    N = 8
    B = n_batch * 2
    rng = np.random.RandomState(0)
    X = np.linspace(0.0, 1.0, N)[:, None]
    y_batch = np.sin(3 * X.T) + 0.1 * rng.randn(B, N)
    kernel = RBF(1.0, (1e-2, 1e2))
    post = batched_fit(kernel, torch.tensor(X, **f64),
                       torch.tensor(y_batch, **f64), df=3, scale=1.0,
                       maxiter=10, mesh=mesh)
    assert post.theta.shape == (B, 1), post.theta.shape

    # data-parallel posterior states at θ draws and per-draw predictions
    mesh_b = Mesh(devices, ('batch',))
    thetas = torch.tensor(np.log(np.linspace(0.5, 2.0, n_devices))[:, None],
                          **f64)
    Xt, y0 = torch.tensor(X, **f64), torch.tensor(y_batch[0], **f64)
    post_d = batched_posterior_at(kernel, Xt, y0, thetas, df=3, nugget=1e-8,
                                  mesh=mesh_b)
    post_l = batched_posterior_at(kernel, Xt, y0, thetas, df=3, nugget=1e-8)
    _assert_close(post_d.lml, post_l.lml.cpu(), rtol=1e-10,
                  what='batched_posterior_at on the mesh')
    yb = y0[None, :, None].expand(n_devices, N, 1)
    m_d, _ = batched_predict(kernel, post_d, Xt, yb, Xt, mesh=mesh_b)
    assert bool(torch.isfinite(m_d).all()), 'batched_predict on the mesh'

    # model-parallel: blocked Cholesky and MVN lml over sharded rows
    mesh_m = Mesh(devices, ('model',))
    Nm = 16 * n_devices
    Xm = np.linspace(0.0, 1.0, Nm)[:, None]
    diff = Xm[:, None, :] - Xm[None, :, :]
    K_full = np.exp(-0.5 * np.sum(diff * diff, axis=-1) / 0.25 ** 2) \
        + 1e-6 * np.eye(Nm)
    ym = np.sin(3.0 * Xm[:, 0])
    L_sh = sharded_cholesky(torch.tensor(K_full, **f64), mesh_m)
    Lr = np.linalg.cholesky(K_full)
    _assert_close(L_sh, Lr, atol=1e-8, what='sharded_cholesky')
    lml = sharded_mvn_lml(torch.tensor(K_full, **f64),
                          torch.tensor(ym, **f64), mesh_m)
    w = sla.solve_triangular(Lr, ym, lower=True)
    want = -0.5 * (w @ w + 2 * np.sum(np.log(np.diag(Lr)))
                   + Nm * _LOG_2PI)
    _assert_close(lml.squeeze(), want, rtol=1e-10, what='sharded_mvn_lml')

    # model-parallel with the covariance built on shard
    k_rbf = RBF(0.25, (1e-2, 1e2))
    th_rbf = torch.tensor(k_rbf.theta, **f64)
    Xm_t = torch.tensor(Xm, **f64)
    K_k = k_rbf.value_fn(th_rbf, Xm_t, None).cpu().numpy() \
        + 1e-6 * np.eye(Nm)
    lml_os = sharded_kernel_lml(k_rbf.value_fn, th_rbf, Xm_t,
                                torch.tensor(ym, **f64), mesh_m, nugget=1e-6)
    Lk = np.linalg.cholesky(K_k)
    wk = sla.solve_triangular(Lk, ym, lower=True)
    want_k = -0.5 * (wk @ wk + 2 * np.sum(np.log(np.diag(Lk)))
                     + Nm * _LOG_2PI)
    _assert_close(lml_os.squeeze(), want_k, rtol=1e-9,
                  what='sharded_kernel_lml')

    # model-parallel MAP fit, against the dense fixed-trip fit through the
    # same objective
    k_fit = Matern(0.5, (1e-2, 1e2), nu=1.5)
    gen = Matern(0.2, (1e-2, 1e2), nu=1.5)
    Kg = gen.value_fn(torch.tensor(gen.theta, **f64), Xm_t, None) \
        .cpu().numpy() + 1e-8 * np.eye(Nm)
    y_fit = np.linalg.cholesky(Kg) @ rng.randn(Nm, 2)
    basis_m = np.ones((Nm, 1))
    c0f, V0f = np.zeros(1), np.zeros((1, 1))
    y_fit_t, basis_t = torch.tensor(y_fit, **f64), torch.tensor(basis_m, **f64)
    th_s, lml_s = sharded_fit(k_fit, Xm_t, y_fit_t, basis_t, c0f, V0f, 3.0,
                              1.0, mesh_m, nugget=1e-8, maxiter=10)
    Z = torch.cat([y_fit_t, basis_t], 1)
    eye = torch.eye(Nm, **f64)

    def dense_obj(th):
        L = torch.linalg.cholesky(k_fit.value_fn(th, Xm_t, None)
                                  + 1e-8 * eye)
        W = torch.linalg.solve_triangular(L, Z, upper=False)
        return -_cgp_lml_from_gram(
            W.mT @ W, 2.0 * torch.sum(torch.log(torch.diagonal(L))), Nm, 2,
            c0f, V0f, 3.0, 1.0)

    bnds = np.asarray(k_fit.bounds, float).reshape(-1, 2)
    th_d, _ = fixed_lbfgs_bounded(dense_obj, torch.tensor(k_fit.theta, **f64),
                                  bnds[:, 0], bnds[:, 1], maxiter=10)
    # the two trajectories see objectives ~1e-13 apart (shard against dense
    # accumulation order), so a line-search acceptance can flip: θ agrees
    # at the optimizer's noise, and the reported lml is the dense
    # objective's at the sharded θ
    _assert_close(th_s, th_d.cpu(), atol=1e-5, what='sharded_fit θ')
    with torch.no_grad():
        _assert_close(lml_s, -dense_obj(th_s).cpu(), rtol=1e-9,
                      what='sharded_fit lml')

    # data-parallel evidence sweep: a Λ_b grid over 'batch'
    orders = np.arange(4)
    Q = 0.3 + 0.05 * np.sin(7.0 * Xm[:16, 0])
    coeffs = rng.randn(16, 4)
    yd = partials(torch.tensor(coeffs, **f64), ratio=torch.tensor(Q, **f64),
                  ref=2.0, orders=orders)
    ratios = np.stack([Q / lam
                       for lam in np.linspace(0.8, 1.3, 2 * n_devices)])
    ev = pointwise_evidence_grid(yd, orders, torch.tensor(ratios, **f64),
                                 ref=2.0, df=0, scale=1, mesh=mesh_b)
    tp = TruncationPointwise(df=0, device=dev).fit(
        yd, ratio=torch.tensor(Q, **f64), ref=2.0, orders=orders)
    want_ev = [float(tp.log_likelihood(ratio=torch.tensor(r, **f64)))
               for r in ratios]
    _assert_close(ev, want_ev, rtol=1e-10, what='pointwise_evidence_grid')
