"""``parallel.mesh`` and ``parallel.pchol`` of the port against
``gsum_tpu.parallel`` on the CPU: the port's ``Mesh(['cpu'] * 8)`` against
JAX's 8-virtual-device mesh (``tests/conftest.py``), D = 8 shards of 8 rows
at N = 64.

- ``sharded_cholesky`` and ``sharded_mvn_lml`` on A·Aᵀ + N·I (condition
  below 10): 1e-12 against JAX, numpy and scipy;
- ``sharded_kernel_lml``, ``sharded_gram_logdet`` and ``sharded_cgp_lml``
  (value and gradient) on RBF and Matern ν = 1.5 covariances with nuggets
  1e-3 and 1e-4 (condition numbers 4e4 and 8e5): 1e-10 relative against
  JAX's sharded functions at the same θ (both factor by shards of 8 rows,
  in other orders); the dense lml at 1e-9;
- a non-SPD tile: −inf and a zero gradient, as JAX;
- ``sharded_fit`` against the port's dense ``fixed_lbfgs_bounded`` through
  the same objective (JAX's own contract, ``tests/test_parallel.py``):
  |Δθ| ≤ 1e-5, the reported lml the dense objective's at θ to 1e-9.
  JAX's ``sharded_fit`` is not run here: its compile takes minutes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch
from jax.sharding import Mesh as JaxMesh

import gsum_tpu as gm
import gsum_tpu_torch as gt
from gsum_tpu.parallel import pchol as jp
from gsum_tpu_torch.optimize import fixed_lbfgs_bounded
from gsum_tpu_torch.parallel import Mesh, make_mesh, shard_batch
from gsum_tpu_torch.parallel import mesh as tmesh
from gsum_tpu_torch.parallel import pchol as tp

N, D = 64, 8
TOL = 1e-10
NUG = 1e-3       # condition numbers about 4e4 at N = 64 (cond·ε 9e-12)


@pytest.fixture(autouse=True, scope='module')
def _one_intra_op_thread():
    """Many tiny torch operations (a loop over 8 shards): in the suite's six
    workers, intra-op threads cost more in contention than they save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def jmesh():
    return JaxMesh(np.array(jax.devices()).reshape(D), axis_names=('model',))


@pytest.fixture(scope='module')
def mesh():
    return Mesh(['cpu'] * D, ('model',))


def t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.shape(got) == want.shape, (np.shape(got), want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _spd(seed):
    A = np.random.RandomState(seed).randn(N, N)
    return A @ A.T + N * np.eye(N)


def test_make_mesh_shapes_and_axes():
    devs = ['cpu'] * 8
    m = make_mesh(devices=devs)
    assert m.axis_names == ('batch', 'model')
    assert m.shape == {'batch': 8, 'model': 1} and m.size == 8
    m2 = make_mesh(n_batch=4, n_model=2, devices=devs)
    assert m2.shape == {'batch': 4, 'model': 2}
    assert m2.devices.shape == (4, 2)
    assert all(d == torch.device('cpu') for d in m2.devices.flat)
    assert make_mesh(n_model=4, devices=devs).shape == {'batch': 2,
                                                        'model': 4}
    assert tmesh._axis_devices(m2, 'model') == [torch.device('cpu')] * 2
    with pytest.raises(ValueError, match='needs 16 devices'):
        make_mesh(n_batch=8, n_model=2, devices=devs)
    with pytest.raises(ValueError, match='axis names'):
        Mesh(devs, ('batch', 'model'))


def test_meshes_on_missing_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        make_mesh()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        Mesh(['cuda:0'] * 4, ('model',))
    with pytest.raises(RuntimeError, match='is_available'):
        make_mesh(devices=['cuda:0'] * 4)


def test_shard_batch():
    m = make_mesh(n_batch=4, n_model=2, devices=['cpu'] * 8)
    a = np.arange(24.0).reshape(8, 3)
    parts = shard_batch(m, a)
    assert len(parts) == 4
    _close(torch.cat(parts), a, 0)
    assert all(p.shape == (2, 3) and p.device.type == 'cpu' for p in parts)
    pa, pb = shard_batch(m, a, t(np.arange(8)))
    assert [p.tolist() for p in pb] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match='not divisible'):
        shard_batch(m, np.zeros(6))


def test_sharded_cholesky_matches_jax_and_numpy(mesh, jmesh):
    K = _spd(1)
    L = tp.sharded_cholesky(t(K), mesh)
    scale = np.abs(np.linalg.cholesky(K)).max()
    _close(L, np.linalg.cholesky(K), 0, 1e-12 * scale)
    Lj = jax.jit(lambda k: jp.sharded_cholesky(k, jmesh))(jnp.asarray(K))
    _close(L, np.asarray(Lj), 0, 1e-12 * scale)
    assert torch.equal(L, torch.tril(L))


def test_sharded_cholesky_flags_non_spd_rows(mesh):
    K = _spd(1)
    K[40, 40] = -1e4              # shard 5's tile is not positive definite
    L = tp.sharded_cholesky(t(K), mesh).numpy()
    assert np.isfinite(L[:40]).all() and np.isnan(L[40:48]).any()


@pytest.mark.parametrize('ndim', [2, 1])
def test_sharded_mvn_lml_matches_jax_and_scipy(mesh, jmesh, ndim):
    K = _spd(2)
    y = np.random.RandomState(2).randn(N, 3)
    y = y if ndim == 2 else y[:, 0]
    got = tp.sharded_mvn_lml(t(K), t(y), mesh)
    y2 = y.reshape(N, -1)
    want = np.array([st.multivariate_normal(np.zeros(N), K).logpdf(c)
                     for c in y2.T])
    assert got.shape == (y2.shape[1],)
    _close(got, want, 1e-12)
    want_j = jax.jit(lambda k, v: jp.sharded_mvn_lml(k, v, jmesh))(
        jnp.asarray(K), jnp.asarray(y))
    _close(got, np.asarray(want_j), 1e-12)


def _inputs(seed, m=2):
    rng = np.random.RandomState(seed)
    X = np.sort(rng.rand(N))[:, None]
    return X, rng.randn(N, m)


@pytest.mark.parametrize('case', ['rbf 2-D y', 'const*rbf 1-D y'])
def test_sharded_kernel_lml_matches_jax_and_dense(mesh, jmesh, case):
    X, y = _inputs(3)
    if case == 'rbf 2-D y':
        kj, nug = gm.RBF(0.25, (1e-2, 1e2)), NUG
    else:
        kj, nug = gm.ConstantKernel(2.0, (1e-2, 1e2)) \
            * gm.RBF(0.3, (1e-2, 1e2)), 1e-4
        y = y[:, 0]
    kt = gt.convert.to_torch_kernel(kj)
    got = tp.sharded_kernel_lml(kt.value_fn, t(kt.theta), t(X), t(y), mesh,
                                nugget=nug)
    want = np.asarray(jax.jit(lambda th: jp.sharded_kernel_lml(
        kj.value_fn, th, jnp.asarray(X), jnp.asarray(y), jmesh,
        nugget=nug))(jnp.asarray(kj.theta)))
    _close(got, want, TOL)
    K = kt.value_fn(t(kt.theta), t(X)).numpy() + nug * np.eye(N)
    dense = [st.multivariate_normal(np.zeros(N), K).logpdf(c)
             for c in y.reshape(N, -1).T]
    _close(got, dense, 1e-9)


def test_sharded_gram_logdet_matches_jax(mesh, jmesh):
    X, y = _inputs(4)
    Z = np.column_stack([y, np.ones(N), X[:, 0]])
    kj = gm.Matern(0.3, (1e-2, 1e2), nu=1.5)
    kt = gt.convert.to_torch_kernel(kj)
    gram, logdet, ok = tp.sharded_gram_logdet(kt.value_fn, t(kt.theta),
                                              t(X), t(Z), mesh, nugget=NUG)
    gj, lj, okj = jax.jit(lambda th: jp.sharded_gram_logdet(
        kj.value_fn, th, jnp.asarray(X), jnp.asarray(Z), jmesh,
        nugget=NUG))(jnp.asarray(kj.theta))
    _close(gram, np.asarray(gj), TOL)
    _close(logdet, np.asarray(lj), TOL)
    assert bool(ok) and bool(okj)


PRIORS = {'V0, df 3': (4.0, 3.0), 'V0 = 0, df 3': (0.0, 3.0),
          'V0, df inf': (4.0, np.inf)}


def _cgp_setup(seed=11, m=3):
    X, y = _inputs(seed, m)
    basis = np.column_stack([np.ones(N), X[:, 0]])
    kj = gm.Matern(0.3, (1e-2, 1e2), nu=1.5)
    return X, 1.5 * y, basis, kj, gt.convert.to_torch_kernel(kj)


@pytest.mark.parametrize('prior', list(PRIORS))
def test_sharded_cgp_lml_matches_jax(mesh, jmesh, prior):
    X, y, basis, kj, kt = _cgp_setup()
    v0, df0 = PRIORS[prior]
    c0, V0 = np.zeros(2), np.eye(2) * v0
    got = tp.sharded_cgp_lml(kt.value_fn, t(kt.theta), t(X), t(y), t(basis),
                             c0, V0, df0, 0.7, mesh, nugget=NUG)
    want = float(jax.jit(lambda th: jp.sharded_cgp_lml(
        kj.value_fn, th, X, y, basis, c0, V0, df0, 0.7, jmesh,
        nugget=NUG))(jnp.asarray(kj.theta)))
    _close(got, np.asarray(want), TOL)


def test_sharded_cgp_lml_gradient_matches_jax(mesh, jmesh):
    X, y, basis, kj, kt = _cgp_setup(12, 2)
    kj = gm.ConstantKernel(1.5, (1e-2, 1e2)) * kj
    kt = gt.convert.to_torch_kernel(kj)
    c0, V0, df0, s0 = np.zeros(2), np.eye(2) * 4.0, 3.0, 0.7
    theta = t(kj.theta).requires_grad_(True)
    val = tp.sharded_cgp_lml(kt.value_fn, theta, t(X), t(y), t(basis), c0,
                             V0, df0, s0, mesh, nugget=NUG)
    (grad,) = torch.autograd.grad(val, theta)
    vj, gj = jax.jit(jax.value_and_grad(lambda th: jp.sharded_cgp_lml(
        kj.value_fn, th, X, y, basis, c0, V0, df0, s0, jmesh,
        nugget=NUG)))(jnp.asarray(kj.theta))
    _close(val, np.asarray(vj), TOL)
    _close(grad, np.asarray(gj), TOL)
    # and a central difference of the port's value
    h = 1e-5
    fd = [(tp.sharded_cgp_lml(kt.value_fn, t(kj.theta + h * e), t(X), t(y),
                              t(basis), c0, V0, df0, s0, mesh, nugget=NUG)
           - tp.sharded_cgp_lml(kt.value_fn, t(kj.theta - h * e), t(X),
                                t(y), t(basis), c0, V0, df0, s0, mesh,
                                nugget=NUG)).item() / (2 * h)
          for e in np.eye(2)]
    _close(grad, np.array(fd), 1e-5)


def test_sharded_cgp_lml_non_spd_tile(mesh, jmesh):
    """A negative nugget leaves the RBF tiles indefinite: −inf and a zero
    gradient, in both packages."""
    X, y, basis, _, _ = _cgp_setup(13, 2)
    kj = gm.RBF(0.3, (1e-2, 1e2))
    kt = gt.convert.to_torch_kernel(kj)
    args = (basis, np.zeros(2), np.eye(2), 3.0, 0.7)
    theta = t(kj.theta).requires_grad_(True)
    val = tp.sharded_cgp_lml(kt.value_fn, theta, t(X), t(y),
                             *(t(a) if i == 0 else a
                               for i, a in enumerate(args)), mesh,
                             nugget=-2.0)
    (grad,) = torch.autograd.grad(val, theta)
    vj, gj = jax.jit(jax.value_and_grad(lambda th: jp.sharded_cgp_lml(
        kj.value_fn, th, X, y, *args, jmesh, nugget=-2.0)))(
            jnp.asarray(kj.theta))
    assert val.item() == -np.inf and float(vj) == -np.inf
    assert grad.tolist() == [0.0] and np.asarray(gj).tolist() == [0.0]


def test_bwd_substitute_solves_k(mesh):
    """Forward, then backward substitution over the shards solves K a = Z."""
    K = _spd(5)
    Z = np.random.RandomState(5).randn(N, 2)
    devs = tmesh._axis_devices(mesh, 'model')
    Nl = N // D
    L_rows = tp._factor_body(tp._matrix_rows(t(K), devs, Nl), devs)
    w = tp._fwd_substitute(L_rows, tp._row_blocks(t(Z), devs, Nl), devs)
    a = tp._bwd_substitute(L_rows, w, devs)
    _close(torch.cat(a), np.linalg.solve(K, Z), 1e-12)


class _NoForwardMode(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return x.exp()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.saved_tensors[0]


class _OpaqueRBF(gt.RBF):
    """An RBF whose length scale passes through a function without a
    forward-mode formula."""

    def value_fn(self, theta, X, Y=None):
        return super().value_fn(torch.log(_NoForwardMode.apply(theta)), X, Y)

    def __repr__(self):
        return 'OpaqueRBF()'


def test_kernel_without_forward_mode_raises(mesh):
    X, y, basis, _, _ = _cgp_setup(14, 2)
    k = _OpaqueRBF(0.3, (1e-2, 1e2))
    theta = t(k.theta).requires_grad_(True)
    val = tp.sharded_cgp_lml(k.value_fn, theta, t(X), t(y), t(basis),
                             np.zeros(2), np.eye(2), 3.0, 0.7, mesh,
                             nugget=NUG)
    assert np.isfinite(val.item())
    with pytest.raises(RuntimeError, match='OpaqueRBF.*forward-mode'):
        torch.autograd.grad(val, theta)


def test_non_divisible_n_raises(mesh):
    with pytest.raises(ValueError, match='N=60 must divide over 8 shards'):
        tp.sharded_mvn_lml(t(np.eye(60)), t(np.ones(60)), mesh)


def test_sharded_fit_matches_dense_fit(mesh):
    """JAX's contract for ``sharded_fit`` (``tests/test_parallel.py``) on
    the port's dense fixed-trip fit through the same objective."""
    rng = np.random.RandomState(13)
    Xs = np.linspace(0, 1, N)[:, None]
    gen = gt.Matern(0.2, (1e-2, 1e2), nu=1.5)
    Kg = gen.value_fn(t(gen.theta), t(Xs)).numpy() + 1e-8 * np.eye(N)
    ys = np.linalg.cholesky(Kg) @ rng.randn(N, 4)
    basis = np.ones((N, 1))
    kernel = gt.Matern(0.5, (1e-2, 1e2), nu=1.5)
    c0, V0, df0, s0, nug = np.zeros(1), np.zeros((1, 1)), 3.0, 0.7, 1e-8

    th_s, lml_s = tp.sharded_fit(kernel, t(Xs), t(ys), t(basis), c0, V0,
                                 df0, s0, mesh, nugget=nug, maxiter=30)
    Z = torch.cat([t(ys), t(basis)], 1)

    def dense(th):
        L = torch.linalg.cholesky(kernel.value_fn(th, t(Xs))
                                  + nug * torch.eye(N, dtype=torch.float64))
        W = torch.linalg.solve_triangular(L, Z, upper=False)
        return tp._cgp_lml_from_gram(
            W.mT @ W, 2 * torch.log(torch.diagonal(L)).sum(), N, 4, c0, V0,
            df0, s0)

    b = np.asarray(kernel.bounds, float).reshape(-1, 2)
    th_d, f_d = fixed_lbfgs_bounded(lambda th: -dense(th), t(kernel.theta),
                                    b[:, 0], b[:, 1], maxiter=30)
    assert b[0, 0] + 0.1 < th_d.item() < b[0, 1] - 0.1
    _close(th_s, th_d.numpy(), 0, 1e-5)
    with torch.no_grad():
        _close(lml_s, dense(th_s).numpy(), 1e-9)
    _close(lml_s, -f_d.numpy(), 1e-10)
