"""Mixed dtypes, the flat namespace and JAX's signatures: the port against
``gsum_tpu`` on the CPU.

- f32 data beside f64 covariances: (a) f64 θ, (b) a fixed hyperparameter
  (``WhiteKernel(1e-3, 'fixed')``, an f64 constant in both packages).  JAX
  promotes the data where they meet; the port does the same, so
  ``batched_fit``, ``batched_lml_grid``, ``truncation_lml_grid`` and
  ``batched_posterior_at`` return JAX's values and dtypes, and the 'scan'
  engine raises in both (JAX's ``TypeError`` from
  ``lax.dynamic_update_slice``).  Both packages build the f32 part of the
  covariance in f32 (XLA's and torch's f32 ``exp`` round differently) and
  compute in f64 after the promotion, so the f32 data's tolerance holds:
  lml grids 1e-5 relative (measured 4.7e-6 with f32 θ, 1e-14 with f64
  θ); the two-iteration fits, whose line searches see those differences,
  θ 2e-4 absolute (the JAX package's own limit between its f32 and f64
  fits, ``tests/test_parallel.py``) and the lml and state 1e-4 relative
  to their largest entry (measured: 8.1e-5 and 2.9e-5).  Every engine of
  the port is held to
  JAX's 'scalar' engine, whose lml they all compute after the promotion
  (JAX's own engines agree to 1e-12 here; its 'grid' fits compile for
  17–35 s and its 'blocked' ones for longer).
- The public top-level names of ``gsum_tpu`` are a subset of the port's.
- The signatures of ``ops.blocked_chol_solve_logdet``,
  ``ops.blockchol.blocked_factor``, ``ops.batched_chol_logpdf`` and
  ``parallel.make_lml_fn`` are JAX's: names, order and defaults (the port's
  ``precision=None`` is JAX's ``Precision.HIGHEST``), and ``make_lml_fn``
  takes JAX's ``chol_fn=None`` and a callable.

N=32 points, B=2 curves, maxiter 2; one intra-op torch thread.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

import gsum_tpu as gj
import gsum_tpu_torch as gt
from gsum_tpu.ops import batched as jops_batched
from gsum_tpu.ops import blockchol as jblockchol
from gsum_tpu.parallel import batched as jb
from gsum_tpu_torch.convert import to_torch_kernel
from gsum_tpu_torch.ops import batched as tops_batched
from gsum_tpu_torch.ops import blockchol as tblockchol
from gsum_tpu_torch.parallel import batched as tb
from _port import one_intra_op_thread  # noqa: F401 (autouse)

N, B = 32, 2
RTOL = 1e-5
FIT = dict(df=3, scale=1.5, nugget=1e-3, maxiter=2, ls_steps=4, chunk=None)
GRID = dict(df=3, scale=1.5, nugget=1e-3)
THETAS = np.log(np.array([[1.0, 0.3], [0.5, 0.2]]))


def _data():
    rng = np.random.RandomState(0)
    X = np.linspace(0, 1, N)[:, None].astype(np.float32)
    Y = (np.sin(3 * X[:, 0])[None] + 0.1 * rng.randn(B, N)).astype(np.float32)
    return X, Y


def _kernel(fixed):
    k = gj.ConstantKernel(1.0, (1e-2, 1e2)) * gj.RBF(0.3, (1e-2, 1e1))
    return k + gj.WhiteKernel(1e-3, 'fixed') if fixed else k


def t(a):
    return torch.tensor(np.asarray(a))


def _same(got, want, rtol=RTOL, atol=None):
    want = np.asarray(want)
    assert got.dtype == getattr(torch, str(want.dtype)), (got.dtype,
                                                          want.dtype)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol,
        atol=rtol * np.abs(want).max() if atol is None else atol)


@pytest.fixture(scope='module')
def jax_fits():
    X, Y = _data()
    k = _kernel(True)
    return {p: jb.batched_fit(k, X, Y, engine='scalar', precision=p, **FIT)
            for p in ('f32', 'mixed')}


@pytest.mark.parametrize('engine', ['auto', 'grid', 'blocked', 'scalar'])
@pytest.mark.parametrize('precision', ['f32', 'mixed'])
def test_batched_fit_f32_with_a_fixed_hyperparameter(jax_fits, precision,
                                                     engine):
    X, Y = _data()
    post = tb.batched_fit(to_torch_kernel(_kernel(True)), t(X), t(Y),
                          engine=engine, precision=precision, **FIT)
    want = jax_fits[precision]
    _same(post.theta, want.theta, rtol=0.0, atol=2e-4)
    for field in ('lml', 'center', 'scale_sq', 'chol'):
        _same(getattr(post, field), getattr(want, field), rtol=1e-4)


@pytest.mark.parametrize('precision', ['f32', 'mixed'])
def test_the_scan_engine_raises_in_both(precision):
    X, Y = _data()
    with pytest.raises(TypeError):
        jb.batched_fit(_kernel(True), X, Y, engine='scan',
                       precision=precision, **FIT)
    with pytest.raises(TypeError):
        tb.batched_fit(to_torch_kernel(_kernel(True)), t(X), t(Y),
                       engine='scan', precision=precision, **FIT)
    with pytest.raises(TypeError):
        tb.batched_lml_grid(to_torch_kernel(_kernel(False)), t(X), t(Y[0]),
                            t(THETAS), engine='scan', **GRID)


@pytest.fixture(scope='module')
def jax_grids():
    X, Y = _data()
    return {'f64 theta': jb.batched_lml_grid(
        _kernel(False), X, Y[0], THETAS, engine='scalar', **GRID),
        'fixed, f32': jb.batched_lml_grid(
            _kernel(True), X, Y[0], THETAS, engine='scalar', precision='f32',
            **GRID)}


@pytest.mark.parametrize('engine', ['auto', 'grid', 'blocked', 'scalar'])
@pytest.mark.parametrize('case,precision', [('f64 theta', 'f64'),
                                            ('f64 theta', 'mixed'),
                                            ('fixed, f32', 'f32')])
def test_batched_lml_grid_f32_data(jax_grids, case, precision, engine):
    """f32 X and y with f64 θ at precision 'f64' and 'mixed' (every point
    re-evaluated at f64: top_k exceeds the grid), and at 'f32' with a fixed
    hyperparameter: f64 values, as JAX's."""
    X, Y = _data()
    k = to_torch_kernel(_kernel(case.startswith('fixed')))
    got = tb.batched_lml_grid(k, t(X), t(Y[0]), t(THETAS), engine=engine,
                              precision=precision, **GRID)
    _same(got, jax_grids[case])


@pytest.mark.parametrize('process', ['gp', 'tp'])
def test_truncation_lml_grid_f32_data(process):
    """f32 X and partial sums with f64 θ: JAX's f64 values."""
    X, Y = _data()
    orders = np.arange(3)
    y = np.stack([Y[0] * 0.5 ** k for k in orders], 1).cumsum(1)
    y = y.astype(np.float32)
    kj = gj.RBF(0.3, (1e-2, 10)) + gj.WhiteKernel(1e-3, 'fixed')
    thetas = np.log(np.array([[0.2], [0.4]]))
    ratios = np.array([0.4, 0.6])
    prior = dict(center=0, disp=0, df=3 if process == 'gp' else 5, scale=1)
    got = tb.truncation_lml_grid(to_torch_kernel(kj), t(X), t(y), orders,
                                 t(ratios), t(thetas), ref=2.0,
                                 process=process, **prior)
    want = jb.truncation_lml_grid(kj, X, y, orders, ratios, thetas, ref=2.0,
                                  process=process, **prior)
    _same(got, want)


def test_batched_posterior_at_f32_data_with_a_fixed_hyperparameter():
    X, Y = _data()
    th = THETAS.astype(np.float32)
    want = jb.batched_posterior_at(_kernel(True), X, Y[0], th, **GRID)
    got = tb.batched_posterior_at(to_torch_kernel(_kernel(True)), t(X),
                                  t(Y[0]), t(th), **GRID)
    for field in ('lml', 'center', 'scale_sq', 'cov_factor', 'chol'):
        _same(getattr(got, field), getattr(want, field))


def test_same_dtypes_promote_nothing():
    """Where the dtypes agree the promotion returns the tensors themselves:
    the f32 pipelines do the work they did."""
    from gsum_tpu_torch._config import promoted

    R = torch.eye(3, dtype=torch.float32)[None]
    y = torch.ones(3, 1, dtype=torch.float32)
    assert all(a is b for a, b in zip(promoted(R, y), (R, y)))
    R64, y64 = promoted(R.double(), y)
    assert R64.dtype == y64.dtype == torch.float64


def test_flat_namespace_has_every_top_level_name():
    """``import gsum_tpu_torch as gm`` is the drop-in ``gsum_tpu`` is (no
    top-level name of ``gsum_tpu`` is among ROADMAP A4's non-ports)."""
    names = {n for n in dir(gj) if not n.startswith('_')}
    assert names <= set(dir(gt)), sorted(names - set(dir(gt)))
    assert set(gt.__all__) <= set(dir(gt))
    assert names - {'jax', 'np'} <= set(gt.__all__) | {
        n for n in dir(gt) if inspect.ismodule(getattr(gt, n))}


@pytest.mark.parametrize('jax_fn,port_fn', [
    (jblockchol.blocked_chol_solve_logdet,
     tblockchol.blocked_chol_solve_logdet),
    (jblockchol.blocked_factor, tblockchol.blocked_factor),
    (jops_batched.batched_chol_logpdf, tops_batched.batched_chol_logpdf),
    (jb.make_lml_fn, tb.make_lml_fn)],
    ids=['blocked_chol_solve_logdet', 'blocked_factor',
         'batched_chol_logpdf', 'make_lml_fn'])
def test_signatures_are_jax(jax_fn, port_fn):
    want = inspect.signature(jax_fn).parameters
    got = inspect.signature(port_fn).parameters
    assert list(got) == list(want)
    for name, p in want.items():
        expected = None if name == 'precision' else p.default
        assert got[name].default == expected, name


def test_leaf_is_accepted():
    rng = np.random.RandomState(1)
    A = rng.randn(2, 40, 40)
    K = t(A @ A.transpose(0, 2, 1) / 40 + np.eye(40))
    Y = t(rng.randn(2, 40, 3))
    w, logdet = tblockchol.blocked_chol_solve_logdet(K, Y, block=16, leaf=8)
    w0, logdet0 = tblockchol.blocked_chol_solve_logdet(K, Y, block=16)
    assert torch.equal(w, w0) and torch.equal(logdet, logdet0)
    L, _ = tblockchol.blocked_factor(K, 16, 8)
    assert torch.allclose(L, torch.linalg.cholesky(K), rtol=1e-10,
                          atol=1e-12)
    np.testing.assert_allclose(logdet.numpy(),
                               np.linalg.slogdet(K.numpy())[1], rtol=1e-12)


@pytest.mark.parametrize('chol_fn', ['default', 'callable'])
def test_make_lml_fn_chol_fn(chol_fn):
    """``chol_fn=None`` is ``torch.linalg`` (JAX's default) and a callable
    is the factorization used; both give JAX's lml (1e-12)."""
    X, Y = _data()
    X64, y2 = X.astype(np.float64), Y[0].astype(np.float64)[:, None]
    basis = np.ones((N, 1))
    theta = THETAS[0]
    kw = dict(df=3, scale=1.5, nugget=1e-3)
    want = jax.jit(jb.make_lml_fn(_kernel(False), **kw))(theta, X64, y2,
                                                          basis)
    calls = []

    def chol(R):
        calls.append(R.shape)
        return torch.linalg.cholesky(R)

    fn = tb.make_lml_fn(to_torch_kernel(_kernel(False)),
                        chol_fn=None if chol_fn == 'default' else chol, **kw)
    got = fn(t(theta), t(X64), t(y2), t(basis))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
    assert bool(calls) == (chol_fn == 'callable')
