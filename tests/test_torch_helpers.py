"""The port's series algebra and data generators (``gsum_tpu_torch.helpers``
and ``.datasets``) against ``gsum_tpu`` on the same seeded inputs, f64 on
the CPU.

Deterministic functions agree to 1e-12 (relative, with an absolute floor
at 1e-12 of the largest entry).  The draws come from another generator than
JAX's, so the generators are held to JAX's formula evaluated on the port's
own standard-normal draws (the same ``torch.Generator`` seeded alike), at
1e-10: the Cholesky factors of the two sides differ by round-off.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsum_tpu as gm
from gsum_tpu import datasets as jds
from gsum_tpu import helpers as jh
from gsum_tpu_torch import datasets as tds
from gsum_tpu_torch import helpers as th

from _port import compare
from _port import one_intra_op_thread  # noqa: F401 (autouse)

RTOL = 1e-12
rng = np.random.RandomState(0)
N = 9
X = np.sort(rng.rand(N))[:, None]
X2 = rng.rand(N, 2)
Y = np.cumsum(rng.randn(N, 5), axis=1)
RATIO = 0.3 + 0.4 * rng.rand(N)
REF = 1 + rng.rand(N)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


SERIES_CASES = {
    'cartesian': (jh.cartesian, th.cartesian,
                  (np.arange(3.), np.linspace(0, 1, 4), np.array([2., 5.]))),
    'coefficients scalar ratio and ref':
        (lambda y: jh.coefficients(y, 0.5, 10),
         lambda y: th.coefficients(y, 0.5, 10), (Y,)),
    'coefficients per-point ratio and ref':
        (jh.coefficients, th.coefficients, (Y, RATIO, REF)),
    'coefficients orders from 2':
        (lambda y, r: jh.coefficients(y, r, 2.0, np.arange(2, 7)),
         lambda y, r: th.coefficients(y, r, 2.0, np.arange(2, 7)),
         (Y, RATIO)),
    'partials scalar ratio and ref':
        (lambda c: jh.partials(c, 0.5, 10), lambda c: th.partials(c, 0.5, 10),
         (Y,)),
    'partials per-point ratio, orders from 3':
        (lambda c, r, f: jh.partials(c, r, f, np.arange(3, 8)),
         lambda c, r, f: th.partials(c, r, f, np.arange(3, 8)),
         (Y, RATIO, REF)),
    'geometric_sum finite end': (lambda x: jh.geometric_sum(x, 1, 6),
                                 lambda x: th.geometric_sum(x, 1, 6),
                                 (RATIO,)),
    'geometric_sum infinite end': (lambda x: jh.geometric_sum(x, 4, np.inf),
                                   lambda x: th.geometric_sum(x, 4, np.inf),
                                   (RATIO,)),
    'geometric_sum finite end, excluded':
        (lambda x: jh.geometric_sum(x, 0, 5, excluded=[1, 3, 9]),
         lambda x: th.geometric_sum(x, 0, 5, excluded=[1, 3, 9]), (RATIO,)),
    'geometric_sum infinite end, excluded, numpy bounds':
        (lambda x: jh.geometric_sum(x, np.int64(2), np.inf,
                                    excluded=np.array([2, 4])),
         lambda x: th.geometric_sum(x, np.int64(2), np.inf,
                                    excluded=np.array([2, 4])),
         (np.outer(RATIO, RATIO),)),
    'gaussian': (lambda a, b: jh.gaussian(a, b, ls=0.3),
                 lambda a, b: th.gaussian(a, b, ls=0.3), (X2, X2[:4])),
    'gaussian one argument': (lambda a: jh.gaussian(a, ls=0.7),
                              lambda a: th.gaussian(a, ls=0.7), (X,)),
    'rbf': (lambda a, b: jh.rbf(a, b, ls=0.4),
            lambda a, b: th.rbf(a, b, ls=0.4), (X2, X2[2:6])),
    'rbf ls=0': (lambda a: jh.rbf(a, ls=0), lambda a: th.rbf(a, ls=0),
                 (np.concatenate([X, X[:2]]),)),
}


@pytest.mark.parametrize('case', list(SERIES_CASES))
def test_series_algebra_matches_jax(case):
    jax_fn, torch_fn, args = SERIES_CASES[case]
    compare(jax_fn, torch_fn, args, rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize('orders', [np.arange(5), np.arange(2, 7)])
def test_coefficients_and_partials_round_trip(orders):
    """``partials(coefficients(y))`` gives y back, per-point ratio and ref,
    orders from 0 and from 2."""
    c = th.coefficients(_t(Y), _t(RATIO), _t(REF), orders)
    _close(th.partials(c, _t(RATIO), _t(REF), orders), Y)


def test_series_algebra_errors_match_jax():
    with pytest.raises(ValueError, match='y must be 2d'):
        th.coefficients(_t(Y[:, 0]), 0.5)
    with pytest.raises(ValueError, match='same length'):
        th.coefficients(_t(Y), 0.5, orders=np.arange(3))
    with pytest.raises(ValueError, match='greater than or equal'):
        th.geometric_sum(_t(RATIO), 3, 2)


def test_numpy_inputs_go_to_the_card():
    """A numpy input goes to the CUDA card; where none is visible the call
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    with pytest.raises(RuntimeError, match='is_available'):
        th.coefficients(Y, 0.5)


def _draws(seed, shape):
    """The standard-normal draws the port makes from ``seed``."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64).numpy()


def _jax_coefficients(K, mean, z):
    """JAX's sampling formula ``mean + z Lᵀ`` on given draws z."""
    return np.asarray(mean + z @ jnp.linalg.cholesky(K).T)


@pytest.mark.parametrize('seed', [0, 7])
def test_generate_coefficients_is_jax_formula_on_its_draws(seed):
    """sd, noise, a two-column basis with β, and ``ls`` for ``gaussian``."""
    def basis_j(x):
        return jnp.stack([jnp.ones(x.shape[0]), x[:, 0]], axis=1)

    def basis_t(x):
        return torch.stack([torch.ones_like(x[:, 0]), x[:, 0]], dim=1)

    got = th.generate_coefficients(_t(X2), size=4, basis=basis_t,
                                   beta=[0.5, -1.0], sd=1.5, noise=1e-3,
                                   rng=seed, ls=0.4)
    K = 1.5 ** 2 * jh.gaussian(X2, ls=0.4) + 1e-6 * jnp.eye(N)
    want = _jax_coefficients(K, basis_j(jnp.asarray(X2))
                             @ jnp.asarray([0.5, -1.0]), _draws(seed, (4, N)))
    _close(got, want, 1e-10)
    assert torch.equal(got, th.generate_coefficients(
        _t(X2), size=4, basis=basis_t, beta=[0.5, -1.0], sd=1.5, noise=1e-3,
        rng=torch.Generator().manual_seed(seed), ls=0.4))


def test_toy_data_is_jax_formula_on_its_draws():
    """Five orders at nine points (the JAX package's corrected orientation:
    any number of orders), with ``rbf`` as the correlation; noise 1e-2 keeps
    the condition number of K near 1e4, so the two Cholesky factors agree
    to 1e-12."""
    orders = np.arange(5)
    got = th.toy_data(_t(X), orders, corr=th.rbf, ratio=0.4, ref=3, rng=2,
                      noise=1e-2, ls=0.5)
    assert got.shape == (N, 5)
    K = jh.rbf(X, ls=0.5) + 1e-4 * jnp.eye(N)
    coeffs = _jax_coefficients(K, jnp.zeros(N), _draws(2, (5, N)))
    _close(got, jh.partials(coeffs.T, 0.4, 3, orders), 1e-10)
    assert not torch.equal(got, th.toy_data(_t(X), orders, rng=3))


def _jax_partial_sums(X, z, ratio, ref, orders, nugget=0):
    """JAX's ``make_gaussian_partial_sums`` on given draws z, RBF(0.5)."""
    K = gm.RBF(0.5)(X) + (nugget + 1e-10) * jnp.eye(X.shape[0])
    coeffs = _jax_coefficients(K, jnp.zeros(X.shape[0]), z).T
    return jh.partials(coeffs, ratio, ref, orders)


def test_make_gaussian_partial_sums_is_jax_formula_on_its_draws():
    """Callable ratio and ref, and a nugget; ``orders`` as an int."""
    def ratio_j(x):
        return 0.3 + 0.2 * x[:, 0]

    def ref_j(x):
        return 1 + x[:, 1]

    got = tds.make_gaussian_partial_sums(
        _t(X2), orders=4, ratio=lambda x: 0.3 + 0.2 * x[:, 0],
        ref=lambda x: 1 + x[:, 1], nugget=1e-6, random_state=5)
    want = _jax_partial_sums(X2, _draws(5, (4, N)), ratio_j(X2), ref_j(X2),
                             np.arange(4), nugget=1e-6)
    _close(got, want, 1e-10)


def test_uniform_and_grid_datasets():
    """Uniform: X from the first of two generators spawned from the seed, y
    JAX's formula on the second's draws; reproducible, and another seed
    differs.  Grid: the JAX package's corrected n_features > 1 grid (to
    1e-12: the two linspaces differ in the last bit), and y JAX's formula on
    the seed's draws."""
    X, y = tds.make_gaussian_partial_sums_uniform(
        n_samples=12, n_features=2, orders=3, ratio=0.4, random_state=3,
        device='cpu')
    gx, gy = tds._two_generators(3, torch.device('cpu'))
    assert torch.equal(X, torch.rand((12, 2), generator=gx,
                                     dtype=torch.float64))
    z = torch.randn((3, 12), generator=gy, dtype=torch.float64).numpy()
    _close(y, _jax_partial_sums(X.numpy(), z, 0.4, 1., np.arange(3)), 1e-10)
    X_again, y_again = tds.make_gaussian_partial_sums_uniform(
        n_samples=12, n_features=2, orders=3, ratio=0.4, random_state=3,
        device='cpu')
    assert torch.equal(X, X_again) and torch.equal(y, y_again)
    assert not torch.equal(X, tds.make_gaussian_partial_sums_uniform(
        n_samples=12, n_features=2, random_state=4, device='cpu')[0])

    Xg, yg = tds.make_gaussian_partial_sums_on_grid(
        n_samples=4, n_features=2, orders=3, random_state=1, device='cpu')
    Xg_j, _ = jds.make_gaussian_partial_sums_on_grid(n_samples=4,
                                                     n_features=2, orders=3)
    _close(Xg, Xg_j)
    _close(yg, _jax_partial_sums(np.asarray(Xg_j), _draws(1, (3, 16)), 0.3,
                                 1., np.arange(3)), 1e-10)
    X1, y1 = tds.make_gaussian_partial_sums_on_grid(n_samples=5, orders=2,
                                                    device='cpu')
    assert X1.shape == (5, 1) and y1.shape == (5, 2)
