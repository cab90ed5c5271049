"""``ops.gridlml`` of the port against ``gsum_tpu.ops.gridlml`` on the CPU:
``cgp_lml_grid`` (engines 'unrolled', 'scan', 'blocked'), ``csp_lml_grid``,
``cgp_lml_grid2`` and ``csp_lml_grid2``; V₀ = 0 and SPD, ν₀ finite and ∞,
shared and per-point y; a grid point whose factorization fails; and the
gradient with respect to the correlation matrices.

Inputs: N=12 points, RBF correlations with a 1e-3 nugget (condition
numbers up to about 1e4), a two-column basis [1, x] where V₀ is SPD.  f64
values are held to 1e-10 relative and gradients to 1e-8 (measured: 1e-13
and 1e-12).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsum_tpu.ops import gridlml as jg
from gsum_tpu_torch.ops import gridlml as tg
from _port import one_intra_op_thread  # noqa: F401 (autouse)

N, M = 12, 2
VTOL, GTOL = 1e-10, 1e-8
LS = (0.15, 0.3, 0.6)
PRIORS = {  # name: (center0, disp0, basis columns)
    'disp0=0': (0.3, 0, 1),
    'disp0 SPD': ([0.3, -0.2], [[2.0, 0.3], [0.3, 0.5]], 2),
}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = np.sort(rng.rand(N))
    Rs = np.stack([np.exp(-0.5 * (X[:, None] - X[None]) ** 2 / ls ** 2)
                   + 1e-3 * np.eye(N) for ls in LS])
    y = rng.randn(N, M)
    yg = rng.randn(len(LS), N, M)
    Ys = rng.randn(4, N, M)
    return X, Rs, y, yg, Ys


def _basis(X, p):
    return np.stack([np.ones(N), X][:p], 1)


def _both(fn_name, args, kw_j=None, kw_t=None):
    want = np.asarray(getattr(jg, fn_name)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
        **(kw_j or {})))
    got = getattr(tg, fn_name)(
        *(torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args),
        **(kw_t or kw_j or {})).numpy()
    return got, want


def _close(got, want, tol=VTOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=tol)


CGP_CASES = [(engine, prior, df0, per_point)
             for prior in PRIORS for df0 in (3.0, np.inf)
             for per_point in (False, True) for engine in ('unrolled',)] + [
    (engine, prior, df0, per_point)
    for engine in ('scan', 'blocked')
    for prior, df0, per_point in (('disp0 SPD', 3.0, False),
                                  ('disp0=0', np.inf, True))]


@pytest.mark.parametrize('engine,prior,df0,per_point', CGP_CASES)
def test_cgp_lml_grid_matches_jax(engine, prior, df0, per_point):
    X, Rs, y, yg, _ = _data()
    c0, V0, p = PRIORS[prior]
    kw = dict(engine=engine, block=8 if engine == 'blocked' else None)
    got, want = _both('cgp_lml_grid', (Rs, yg if per_point else y,
                                       _basis(X, p), c0, V0, df0, 1.5), kw)
    _close(got, want)


@pytest.mark.parametrize('prior,df0', [('disp0=0', 3.0), ('disp0 SPD', 3.0),
                                       ('disp0=0', np.inf)])
def test_csp_lml_grid_matches_jax(prior, df0):
    """ν₀ = ∞ gives NaN in both (gammaln(∞) − ∞·log ∞), as JAX's; mirrored."""
    X, Rs, y, _, _ = _data()
    c0, V0, p = PRIORS[prior]
    got, want = _both('csp_lml_grid', (Rs, y, _basis(X, p), c0, V0, df0,
                                       1.5))
    if np.isinf(df0):
        assert np.isnan(got).all() and np.isnan(want).all()
    else:
        _close(got, want)


@pytest.mark.parametrize('fn,df0', [('cgp_lml_grid2', 3.0),
                                    ('cgp_lml_grid2', np.inf),
                                    ('csp_lml_grid2', 3.0)])
def test_grid2_matches_jax(fn, df0):
    X, Rs, _, _, Ys = _data()
    got, want = _both(fn, (Rs, Ys, _basis(X, 1), 0.3, 0, df0, 1.5))
    assert got.shape == (len(LS), len(Ys))
    _close(got, want)


def test_grid2_refuses_what_jax_refuses():
    X, Rs, _, _, Ys = _data()
    args = (torch.tensor(Rs), torch.tensor(Ys), torch.tensor(_basis(X, 1)),
            0.3)
    for fn in (tg.cgp_lml_grid2, tg.csp_lml_grid2):
        with pytest.raises(NotImplementedError):
            fn(*args, 1.0, 3.0, 1.5)
    with pytest.raises(NotImplementedError):
        tg.csp_lml_grid2(*args, 0, np.inf, 1.5)
    with pytest.raises(ValueError, match='engine'):
        tg.cgp_lml_grid(args[0], torch.tensor(_data()[2]), args[2], 0.3, 0,
                        3.0, 1.5, engine='nope')


@pytest.mark.parametrize('engine', ['unrolled', 'scan', 'blocked'])
def test_failed_grid_point_is_minus_inf(engine):
    """A non-positive-definite member gives -inf; the others JAX's values,
    and the gradient stays finite (the failed member's is zero)."""
    X, Rs, y, _, _ = _data()
    Rs = Rs.copy()
    Rs[1] -= 2.0 * np.eye(N)
    kw = dict(engine=engine, block=8 if engine == 'blocked' else None)
    got, want = _both('cgp_lml_grid', (Rs, y, _basis(X, 1), 0.3, 0, 3.0,
                                       1.5), kw)
    assert got[1] == want[1] == -np.inf
    _close(got, want)
    R = torch.tensor(Rs, requires_grad=True)
    out = tg.cgp_lml_grid(R, torch.tensor(y), torch.tensor(_basis(X, 1)),
                          0.3, 0, 3.0, 1.5, **kw)
    (g,) = torch.autograd.grad(out[[0, 2]].sum(), R)
    assert torch.isfinite(g).all() and (g[1] == 0).all()


@pytest.mark.parametrize('engine', ['unrolled', 'blocked'])
def test_gradient_wrt_Rs_matches_jax(engine):
    """d(Σ_g w_g lml_g)/dRs against ``jax.grad`` (the blocked engine's
    hand-written backward, the unrolled engine's Cholesky adjoint)."""
    X, Rs, y, _, _ = _data(1)
    c0, V0, p = PRIORS['disp0 SPD']
    basis = _basis(X, p)
    w = np.array([0.5, -1.0, 2.0])
    kw = dict(engine=engine, block=8 if engine == 'blocked' else None)

    def fj(R):
        return jnp.sum(jnp.asarray(w) * jg.cgp_lml_grid(
            R, jnp.asarray(y), jnp.asarray(basis), c0, V0, 3.0, 1.5, **kw))

    want = np.asarray(jax.jit(jax.grad(fj))(jnp.asarray(Rs)))
    R = torch.tensor(Rs, requires_grad=True)
    out = tg.cgp_lml_grid(R, torch.tensor(y), torch.tensor(basis), c0, V0,
                          3.0, 1.5, **kw)
    (got,) = torch.autograd.grad((torch.tensor(w) * out).sum(), R)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GTOL * np.abs(want).max())


def test_f32_and_mxu_precision():
    """f32 grids stay f32 (JAX's dtype); 'high' changes nothing on the CPU
    and an unknown precision is refused."""
    X, Rs, y, _, _ = _data()
    args = (torch.tensor(Rs, dtype=torch.float32),
            torch.tensor(y, dtype=torch.float32),
            torch.ones(N, 1, dtype=torch.float32), 0.3, 0, 3.0, 1.5)
    lo = tg.cgp_lml_grid(*args, engine='blocked', block=8)
    hi = tg.cgp_lml_grid(*args, engine='blocked', block=8,
                         mxu_precision='high')
    assert lo.dtype == torch.float32
    assert torch.equal(lo, hi)
    ref = tg.cgp_lml_grid(torch.tensor(Rs), torch.tensor(y),
                          torch.ones(N, 1, dtype=torch.float64), 0.3, 0, 3.0,
                          1.5)
    np.testing.assert_allclose(lo.double().numpy(), ref.numpy(), rtol=1e-3)
    with pytest.raises(ValueError, match='mxu_precision'):
        tg.cgp_lml_grid(*args, engine='blocked', block=8,
                        mxu_precision='medium')
