"""``parallel.batched_fit`` of the port against ``gsum_tpu``'s on the CPU:
every engine, restarts, 'mixed' precision and chunking.

Data: B=3 curves at N=16 points, a ConstantKernel × RBF kernel, a 1e-3
nugget (condition numbers below 1e5), maxiter 5, ls_steps 4.  The lockstep
L-BFGS does JAX's arithmetic on the same lml (to 1e-13 here), so the
iterates, and with them θ, agree to 1e-8 and the lml and the posterior
state to 1e-10 relative (measured: 1e-12).

JAX's 'scan' and 'blocked' fit engines compile their factorizations for
20–40 s on the CPU at any N (the blocked one pads to its 128-wide block),
so the port's 'scan' and 'blocked' fits are held to JAX's 'grid' fit,
which optimizes the same lml (the engines' lml agree to 1e-12,
``tests/test_torch_gridlml.py``).  Restarts and 'mixed' run on the scalar
engine, JAX's quickest to compile.
"""
import numpy as np
import pytest
import torch

import gsum_tpu as gj
from gsum_tpu.parallel import batched as jb
from gsum_tpu_torch.convert import to_torch_kernel
from gsum_tpu_torch.parallel import batched as tb

N, B, MAXITER, LS = 16, 3, 5, 4
FIT = dict(df=3, scale=1.5, nugget=1e-3, maxiter=MAXITER, ls_steps=LS)
FIELDS = ('theta', 'lml', 'center', 'disp', 'df', 'scale_sq', 'cov_factor',
          'chol')


def _kernel_j():
    return gj.ConstantKernel(1.0, (1e-2, 1e2)) * gj.RBF(0.3, (1e-2, 1e1))


def _data():
    rng = np.random.RandomState(5)
    X = np.linspace(0, 1, N)[:, None]
    Y = np.stack([np.sin(3 * X[:, 0] + 6.28 * rng.rand()) for _ in range(B)])
    return X, Y + 0.1 * rng.randn(B, N)


def t(a):
    return torch.tensor(np.asarray(a))


def _same(post, post_j, theta_tol=1e-8, tol=1e-10):
    for f in FIELDS:
        got = getattr(post, f).detach().numpy()
        want = np.asarray(getattr(post_j, f))
        assert got.shape == want.shape and got.dtype == want.dtype, f
        lim = theta_tol if f == 'theta' else tol
        np.testing.assert_allclose(got, want, rtol=lim,
                                   atol=lim * np.abs(want).max(), err_msg=f)


@pytest.fixture(scope='module')
def jax_fits():
    X, Y = _data()
    k = _kernel_j()
    out = {e: jb.batched_fit(k, X, Y, engine=e, chunk=None, **FIT)
           for e in ('grid', 'scalar')}
    return out


@pytest.mark.parametrize('engine', ['grid', 'scan', 'blocked', 'scalar'])
def test_batched_fit_engines(jax_fits, engine):
    X, Y = _data()
    post = tb.batched_fit(to_torch_kernel(_kernel_j()), t(X), t(Y),
                          engine=engine, chunk=None, **FIT)
    _same(post, jax_fits['scalar' if engine == 'scalar' else 'grid'])


def test_batched_fit_chunking_changes_no_fit(jax_fits):
    """Chunks of 2 (the last one short) give the fits of one chunk."""
    X, Y = _data()
    k = to_torch_kernel(_kernel_j())
    whole = tb.batched_fit(k, t(X), t(Y), chunk=None, **FIT)
    parts = tb.batched_fit(k, t(X), t(Y), chunk=2, **FIT)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(parts, f).numpy(),
                                   getattr(whole, f).numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_batched_fit_restarts_match_jax():
    """Two restarts drawn from the port's ``torch.Generator`` (seed 3),
    fed to JAX's ``_batched_fit_wide`` as its starts: the best fit per data
    set equals JAX's."""
    X, Y = _data()
    kj = _kernel_j()
    k = to_torch_kernel(kj)
    post = tb.batched_fit(k, t(X), t(Y), n_restarts=2, seed=3,
                          engine='scalar', chunk=None, **FIT)
    bounds = np.asarray(kj.bounds)
    lo, hi = t(bounds[:, 0]), t(bounds[:, 1])
    starts = tb._restart_starts(t(kj.theta), lo, hi, 2, 3)
    assert torch.equal(starts, tb._restart_starts(t(kj.theta), lo, hi, 2, 3))
    assert ((starts[1:] >= lo) & (starts[1:] <= hi)).all()
    import jax.numpy as jnp

    want = jb._batched_fit_wide(
        kj.clone(), jnp.asarray(X), jnp.asarray(Y)[:, :, None],
        jnp.ones((N, 1)), jnp.asarray(starts.numpy()),
        jnp.asarray(bounds[:, 0]), jnp.asarray(bounds[:, 1]),
        np.atleast_1d(0), np.atleast_2d(0), FIT['df'], FIT['scale'],
        FIT['nugget'], MAXITER, None, 'scalar', LS)
    _same(post, want)
    single = tb.batched_fit(k, t(X), t(Y), engine='scalar', chunk=None,
                            **FIT)
    assert (post.lml >= single.lml - 1e-9).all()
    with pytest.raises(ValueError, match='finite bounds'):
        tb.batched_fit(to_torch_kernel(gj.RBF(0.3, (1e-2, np.inf))), t(X),
                       t(Y), n_restarts=1, **FIT)


def test_batched_fit_mixed_precision_matches_jax():
    """'mixed': the f32 sweep then f64 polish iterations from each fit's
    f32 optimum, the state in f64.  The f32 sweeps take other paths (JAX
    solves in f32, the port's scalar lml in f64 after an f32 factor), so
    both run to convergence (60 + 25 iterations with 10 line-search
    steps, as JAX's own test of 'mixed') and are held where the
    optimum is: θ to 2e-4 (JAX's own limit between 'mixed' and f64 in
    tests/test_parallel.py) and the lml to 1e-8 relative."""
    X, Y = _data()
    kw = dict(FIT, engine='scalar', chunk=None, precision='mixed',
              polish_iters=25, maxiter=60, ls_steps=10)
    want = jb.batched_fit(_kernel_j(), X, Y, **kw)
    post = tb.batched_fit(to_torch_kernel(_kernel_j()), t(X), t(Y), **kw)
    for f in FIELDS:
        assert getattr(post, f).dtype == torch.float64, f
    np.testing.assert_allclose(post.theta.numpy(), np.asarray(want.theta),
                               atol=2e-4)
    np.testing.assert_allclose(post.lml.numpy(), np.asarray(want.lml),
                               rtol=1e-8)
    with pytest.raises(ValueError, match='precision'):
        tb.batched_fit(to_torch_kernel(_kernel_j()), t(X), t(Y),
                       precision='bf16', **FIT)
