"""The ``mesh=`` paths of ``parallel.batched`` on the CPU: the port's
``make_mesh(devices=['cpu'] * 8)`` against its own unsharded calls and
against ``gsum_tpu``'s sharded calls on JAX's 8-virtual-device mesh;
``_fit_one``'s lockstep batch against single runs; the twin of
``__graft_entry__.dryrun_multichip`` at n = 8.

Data: ``tests/test_torch_parallel_fit.py``'s (N = 16, a ConstantKernel ×
RBF kernel, a 1e-3 nugget, condition numbers below 1e5), 8 of everything
(one per shard).  A sharded call runs each shard's slice through the
unsharded engine, so it equals the unsharded port to 1e-12 (measured: bit
for bit); against JAX, values at 1e-10 relative and fitted θ at 1e-8 (the
same lml to 1e-13, as in ``tests/test_torch_parallel_fit.py``).
"""
import numpy as np
import pytest
import torch

import gsum_tpu as gj
from gsum_tpu.parallel import batched as jb
from gsum_tpu.parallel import make_mesh as jax_mesh
from gsum_tpu_torch.convert import to_torch_kernel, to_torch_posterior
from gsum_tpu_torch.entry import dryrun_multichip
from gsum_tpu_torch.parallel import batched as tb
from gsum_tpu_torch.parallel import make_mesh
from _port import one_intra_op_thread  # noqa: F401 (autouse)

N, B = 16, 8
PRIOR = dict(df=3, scale=1.5, nugget=1e-3)
FIELDS = ('theta', 'lml', 'center', 'disp', 'df', 'scale_sq', 'cov_factor',
          'chol')


def _kernel_j():
    return gj.ConstantKernel(1.0, (1e-2, 1e2)) * gj.RBF(0.3, (1e-2, 1e1))


def _data():
    rng = np.random.RandomState(5)
    X = np.linspace(0, 1, N)[:, None]
    Y = np.stack([np.sin(3 * X[:, 0] + 6.28 * rng.rand()) for _ in range(B)])
    thetas = np.log(np.stack([np.linspace(0.5, 2.0, B),
                              np.linspace(0.1, 0.6, B)], 1))
    return X, Y + 0.1 * rng.randn(B, N), thetas


def t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _posts_close(post, want, tol, theta_tol=None):
    for f in FIELDS:
        _close(getattr(post, f), getattr(want, f),
               theta_tol if f == 'theta' and theta_tol else tol)


@pytest.fixture(scope='module')
def meshes():
    return make_mesh(devices=['cpu'] * 8), jax_mesh(n_batch=8, n_model=1)


def test_batched_lml_grid_on_the_mesh(meshes):
    X, Y, th = _data()
    kt = to_torch_kernel(_kernel_j())
    got = tb.batched_lml_grid(kt, t(X), t(Y.T), t(th), mesh=meshes[0],
                              **PRIOR)
    _close(got, tb.batched_lml_grid(kt, t(X), t(Y.T), t(th), **PRIOR),
           1e-12)
    _close(got, jb.batched_lml_grid(_kernel_j(), X, Y.T, th, mesh=meshes[1],
                                    **PRIOR), 1e-10)


def test_batched_fit_on_the_mesh(meshes):
    """JAX's route (``_fit_one`` per curve) with a restart: against the
    unsharded route on one device, and against JAX's sharded fit."""
    X, Y, _ = _data()
    kt = to_torch_kernel(_kernel_j())
    kw = dict(maxiter=5, n_restarts=1, **PRIOR)
    got = tb.batched_fit(kt, t(X), t(Y), mesh=meshes[0], **kw)
    lower, upper = (t(b) for b in np.asarray(kt.bounds).T)
    starts = tb._restart_starts(t(kt.theta), lower, upper, 1, 0)
    one = tb._fit_one(kt.clone(), t(X), t(Y)[:, :, None],
                      torch.ones((N, 1), dtype=torch.float64), starts, lower,
                      upper, np.zeros(1), np.zeros((1, 1)), 3, 1.5, 1e-3, 5)
    _posts_close(got, one, 1e-12)
    # JAX draws its restart from its own key: both take the port's start
    want = jb.batched_fit(_kernel_j(), X, Y, mesh=meshes[1], maxiter=5,
                          theta0=kt.theta, **PRIOR)
    plain = tb.batched_fit(kt, t(X), t(Y), mesh=meshes[0], maxiter=5,
                           **PRIOR)
    _posts_close(plain, to_torch_posterior(want, 'cpu'), 1e-10,
                 theta_tol=1e-8)


def test_fit_one_batch_equals_single_runs():
    """The lockstep batch of 4 (curve, start) pairs iterates each pair as
    its own run would."""
    X, Y, _ = _data()
    kt = to_torch_kernel(_kernel_j())
    lower, upper = (t(b) for b in np.asarray(kt.bounds).T)
    starts = t(kt.theta)[None]
    args = (torch.ones((N, 1), dtype=torch.float64), starts, lower, upper,
            np.zeros(1), np.zeros((1, 1)), 3, 1.5, 1e-3, 6)
    Ys = t(Y[:4])[:, :, None]
    batch = tb._fit_one(kt.clone(), t(X), Ys, *args)
    for i in range(4):
        single = tb._fit_one(kt.clone(), t(X), Ys[i:i + 1], *args)
        for f in FIELDS:
            _close(getattr(batch, f)[i:i + 1], getattr(single, f), 1e-12)


def test_pointwise_evidence_grid_on_the_mesh(meshes):
    rng = np.random.RandomState(3)
    orders = np.arange(5)
    Q = 0.3 + 0.1 * rng.rand(12)
    yd = np.asarray(gj.partials(rng.randn(12, 5), ratio=Q, ref=2.0,
                                orders=orders))
    ratios = np.stack([Q / lam for lam in np.linspace(0.7, 1.4, 16)])
    kw = dict(ref=2.0, df=3, scale=1.0)
    got = tb.pointwise_evidence_grid(t(yd), orders, t(ratios),
                                     mesh=meshes[0], **kw)
    _close(got, tb.pointwise_evidence_grid(t(yd), orders, t(ratios), **kw),
           1e-12)
    _close(got, jb.pointwise_evidence_grid(yd, orders, ratios,
                                           mesh=meshes[1], **kw), 1e-10)


@pytest.mark.parametrize('student', [False, True])
def test_posterior_at_and_predict_on_the_mesh(meshes, student):
    X, Y, th = _data()
    kj = _kernel_j()
    kt = to_torch_kernel(kj)
    y = Y[0]
    Xnew = np.linspace(0.05, 0.95, 5)[:, None]
    yb = np.broadcast_to(y[None, :, None], (B, N, 1))
    # chunk=3 unsharded: the mesh bypasses chunk, as in JAX
    post = tb.batched_posterior_at(kt, t(X), t(y), t(th), mesh=meshes[0],
                                   chunk=3, **PRIOR)
    _posts_close(post, tb.batched_posterior_at(kt, t(X), t(y), t(th),
                                               chunk=3, **PRIOR), 1e-12)
    post_j = jb.batched_posterior_at(kj, X, y, th, mesh=meshes[1], **PRIOR)
    _posts_close(post, to_torch_posterior(post_j, 'cpu'), 1e-10)
    got = tb.batched_predict(kt, post, t(X), t(yb.copy()), t(Xnew),
                             mesh=meshes[0], student=student)
    plain = tb.batched_predict(kt, post, t(X), t(yb.copy()), t(Xnew),
                               student=student)
    want = jb.batched_predict(kj, post_j, X, yb, Xnew, mesh=meshes[1],
                              student=student)
    for g, p, w in zip(got, plain, want):
        _close(g, p.detach().numpy(), 1e-12)
        _close(g, np.asarray(w), 1e-10)


def test_mixed_precision_fit_refuses_a_mesh(meshes):
    X, Y, _ = _data()
    with pytest.raises(ValueError, match='single-device only'):
        tb.batched_fit(to_torch_kernel(_kernel_j()), t(X), t(Y),
                       mesh=meshes[0], precision='mixed')


def test_numpy_inputs_follow_the_mesh():
    """numpy goes to the mesh's first device (the CPU here), not to the
    default card."""
    X, Y, th = _data()
    got = tb.batched_lml_grid(to_torch_kernel(_kernel_j()), X, Y.T, th,
                              mesh=make_mesh(devices=['cpu'] * 2), **PRIOR)
    assert got.device.type == 'cpu' and got.shape == (B,)


def test_dryrun_multichip_on_eight_cpu_shards():
    dryrun_multichip(8, device='cpu')

