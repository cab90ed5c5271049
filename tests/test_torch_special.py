"""The port's incomplete-beta functions and inverses
(``gsum_tpu_torch.stats._special``, plain PyTorch on the CPU) against
``jax.scipy.special.betainc`` / ``gsum_tpu.stats._special`` and scipy, f64.

Tolerances:

- ``betainc``: relative 1e-12, plus the condition of XLA's prefactor
  ``exp(a log x + b log1p(-x) - log B(a, b))``: its exponent is a sum of
  terms as large as S = |a log x| + |b log1p(-x)| + |lgamma(a)| + |lgamma(b)|
  + |lgamma(a + b)|, each rounded, and the continued fraction adds up to a
  few dozen roundings.  So the limit is
  ``1e-12 |ref| + 4 eps (S + 64) |r'|``, with r' the value before the
  symmetry swap's ``1 - r'`` (r' = ref, or 1 - ref where the swap is taken).
  At a, b <= 30 that is within a few 1e-13 of 1e-12; at a = 4000 JAX itself
  is 9.7e-11 from scipy, and the limit there is 5.2e-11 relative to r'.
- ``betaincinv`` / ``gammaincinv``: relative 1e-10 against the JAX package,
  plus the error of the forward function divided by its slope (the density
  at the root): 4 eps (S + 64) for ``betainc`` (as above), and for
  ``gammaincinv`` the measured distance of ``torch.special.gammainc`` from
  scipy's at the root.  torch's ``gammainc`` is within 1e-15 of scipy for
  a <= 20 but 3.4e-10 (absolute) away at a = 30 and 2e-11 at a = 4000, and
  6e-10 relative in the far lower tail; the quantile inherits that.  At p
  near 1 the quantile is ill-conditioned (1 - p carries p's rounding), so
  the second term dominates there.
- Two points where the JAX package's 50 bracketed Newton steps do not reach
  the root (a = 30 or 4000, b = 1, p = 1e-10: Newton creeps from x₀ near 1)
  are a limit of the algorithm that the port mirrors: which of the two ends
  2.4e-7 from the root depends on the last bits of the slope, so there both
  are only held to 1e-6 of scipy's quantile.
- Edge values (x in {0, 1}, a = 0, b = inf, NaN, negative or out-of-domain
  arguments) are compared exactly, NaN for NaN.  XLA on the CPU flushes
  subnormal arguments to 0 and torch does not (nor does the card in
  float64), so a subnormal a or b is compared only where that cannot
  matter (x strictly inside (0, 1) for a tiny a).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import torch
from jax.scipy.special import betainc as jax_betainc

from gsum_tpu.stats import _special as jsp
from gsum_tpu_torch.stats import _special as tsp

EPS = np.finfo(np.float64).eps
GRID = (0.1, 0.5, 1.0, 2.5, 5.0, 30.0, 500.0, 4000.0)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _grid():
    """Every (a, b) of GRID with x at 0, 1, the swap point and its two
    neighbours, the mean a/(a+b), and spread values."""
    rows = []
    for a in GRID:
        for b in GRID:
            s = (a + 1) / (a + b + 2)
            for x in (0.0, 1.0, s, np.nextafter(s, 0), np.nextafter(s, 1),
                      0.01, 0.3, 0.5, 0.7, 0.99, a / (a + b)):
                rows.append((a, b, x))
    return np.array(rows).T


def _limit(a, b, x, ref):
    swap = ~(x < (a + 1) / (a + b + 2))
    a2, b2 = np.where(swap, b, a), np.where(swap, a, b)
    x2 = np.where(swap, 1 - x, x)
    with np.errstate(divide='ignore', invalid='ignore'):
        S = (np.abs(a2 * np.log(x2)) + np.abs(b2 * np.log1p(-x2))
             + np.abs(sp.gammaln(a2)) + np.abs(sp.gammaln(b2))
             + np.abs(sp.gammaln(a2 + b2)))
    S = np.nan_to_num(S, nan=0.0, posinf=0.0)
    r = np.abs(np.where(swap, 1 - ref, ref))
    return 1e-12 * np.abs(ref) + 4 * EPS * (S + 64) * r


@pytest.mark.parametrize('against', ['jax', 'scipy'])
def test_betainc_grid(against):
    a, b, x = _grid()
    got = tsp.betainc(_t(a), _t(b), _t(x)).numpy()
    want = (np.asarray(jax_betainc(a, b, x)) if against == 'jax'
            else sp.betainc(a, b, x))
    err = np.abs(got - want)
    assert np.all(err <= _limit(a, b, x, want)), \
        np.max(err / np.maximum(_limit(a, b, x, want), 1e-300))
    small = (a <= 30) & (b <= 30) & (want != 0)
    assert np.all(got[want == 0] == 0)
    assert np.max(err[small] / np.abs(want[small])) < 2e-12


def test_betainc_broadcast_and_types():
    """Broadcasting, the weak Python scalars of JAX's promotion, float32,
    and the default device for scalars given alone (here asked for as
    the CPU through a tensor argument)."""
    x = np.linspace(0.0, 1.0, 7)
    a = np.array([[0.5], [2.0], [7.0]])
    got = tsp.betainc(_t(a), 1.5, _t(x))
    assert got.shape == (3, 7) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_betainc(a, 1.5, x)),
                               rtol=1e-12, atol=1e-15)
    x32 = torch.tensor(x, dtype=torch.float32)
    got32 = tsp.betainc(torch.tensor(2.0, dtype=torch.float32), 1.5, x32)
    want32 = np.asarray(jax_betainc(np.float32(2.0), 1.5,
                                    x.astype(np.float32)))
    assert got32.dtype == torch.float32 and want32.dtype == np.float32
    np.testing.assert_allclose(got32.numpy(), want32, rtol=2e-6, atol=1e-7)


EDGES = [
    # (a, b, x): x at the ends, a = 0 / b = inf, b = 0 / a = inf, NaNs,
    # negative and out-of-domain arguments, both "zero"
    (2.0, 3.0, 0.0), (2.0, 3.0, 1.0), (0.0, 3.0, 0.5), (0.0, 3.0, 0.0),
    (2.0, np.inf, 0.5), (2.0, np.inf, 0.0), (2.0, 0.0, 0.5),
    (2.0, 0.0, 1.0), (np.inf, 3.0, 0.5), (np.inf, 3.0, 1.0),
    (0.0, 0.0, 0.5), (np.inf, np.inf, 0.5), (np.nan, 3.0, 0.5),
    (2.0, np.nan, 0.5), (2.0, 3.0, np.nan), (-1.0, 3.0, 0.5),
    (2.0, -1.0, 0.5), (2.0, 3.0, -0.1), (2.0, 3.0, 1.1),
    (1e-320, 3.0, 0.5),
]


@pytest.mark.parametrize('a,b,x', EDGES)
def test_betainc_edges(a, b, x):
    got = tsp.betainc(_t(a), _t(b), _t(x)).item()
    want = float(jax_betainc(jnp.float64(a), jnp.float64(b), jnp.float64(x)))
    assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(
        want, rel=1e-12, abs=0.0), (got, want)


def test_betaln():
    """lgamma(a) + lgamma(b) - lgamma(a + b), to the rounding of its
    terms."""
    a = np.array([0.1, 2.5, 30.0, 4000.0])
    b = a[::-1].copy()
    terms = (np.abs(sp.gammaln(a)) + np.abs(sp.gammaln(b))
             + np.abs(sp.gammaln(a + b)))
    err = np.abs(tsp.betaln(_t(a), _t(b)).numpy() - sp.betaln(a, b))
    assert np.all(err <= 1e-13 * np.abs(sp.betaln(a, b)) + 4 * EPS * terms)


P_GRID = (0.0, 1e-10, 0.01, 0.2, 0.5, 0.8, 0.99, 1 - 1e-10, 1.0)
UNCONVERGED = ((30.0, 1.0, 1e-10), (4000.0, 1.0, 1e-10))


def _inverse_cases():
    a, b = (g.ravel() for g in np.meshgrid(GRID, GRID, indexing='ij'))
    a = np.repeat(a[:, None], len(P_GRID), 1).ravel()
    b = np.repeat(b[:, None], len(P_GRID), 1).ravel()
    return a, b, np.tile(P_GRID, len(GRID) ** 2)


def test_betaincinv_grid():
    a, b, p = _inverse_cases()
    got = tsp.betaincinv(_t(a), _t(b), _t(p)).numpy()
    want = np.asarray(jsp.betaincinv(a, b, p))
    exact = sp.betaincinv(a, b, p)
    assert np.isfinite(got).all()
    ends = (p == 0) | (p == 1)
    assert np.array_equal(got[ends], want[ends])
    slow = np.zeros(a.shape, bool)
    for case in UNCONVERGED:
        slow |= (a == case[0]) & (b == case[1]) & (p == case[2])
    np.testing.assert_allclose(got[slow], exact[slow], rtol=1e-6)
    np.testing.assert_allclose(want[slow], exact[slow], rtol=1e-6)
    hold = ~ends & ~slow
    x = want[hold]
    density = np.exp(-sp.betaln(a[hold], b[hold])
                     + (a[hold] - 1) * np.log(x) + (b[hold] - 1) * np.log1p(-x))
    fwd = _limit(a[hold], b[hold], x, sp.betainc(a[hold], b[hold], x))
    limit = 1e-10 * np.abs(x) + (fwd + 4 * EPS) / density
    assert np.all(np.abs(got[hold] - x) <= limit), \
        np.max(np.abs(got[hold] - x) / limit)


def test_gammaincinv_grid():
    a = np.repeat(np.array(GRID)[:, None], len(P_GRID), 1).ravel()
    p = np.tile(P_GRID, len(GRID))
    got = tsp.gammaincinv(_t(a), _t(p)).numpy()
    want = np.asarray(jsp.gammaincinv(a, p))
    assert np.all(got[p == 1.0] == np.inf) and np.all(got[p == 0.0] == 0.0)
    hold = (p > 0) & (p < 1)
    x, ah = want[hold], a[hold]
    fwd = np.abs(torch.special.gammainc(_t(ah), _t(x)).numpy()
                 - sp.gammainc(ah, x))
    density = np.exp(-sp.gammaln(ah) + (ah - 1) * np.log(x) - x)
    limit = 1e-10 * x + 2 * (fwd + 4 * EPS) / density
    assert np.all(np.abs(got[hold] - x) <= limit), \
        np.max(np.abs(got[hold] - x) / limit)
    exact = ah <= 20
    np.testing.assert_allclose(got[hold][exact & (p[hold] >= 0.01)],
                               x[exact & (p[hold] >= 0.01)], rtol=1e-10)


@pytest.mark.parametrize('p', [-0.1, 1.5, np.nan])
def test_inverses_out_of_domain(p):
    """p outside [0, 1] gives NaN, as in scipy and the JAX package."""
    for got, want in (
            (tsp.betaincinv(_t(3.0), _t(5.0), _t(p)),
             jsp.betaincinv(3.0, 5.0, p)),
            (tsp.gammaincinv(_t(4.0), _t(p)), jsp.gammaincinv(4.0, p))):
        got, want = got.item(), float(want)
        assert (np.isnan(got) and np.isnan(want)) or got == want
        if not np.isnan(p):
            assert np.isnan(got)


def test_betaincinv_roundtrip_and_float32():
    """betainc(betaincinv(p)) = p; float32 arguments stay float32."""
    a = np.array([0.5, 1.5, 2.5, 15.0])
    b = np.array([0.5, 0.5, 4.0, 2.0])
    p = np.array([0.05, 0.3, 0.6, 0.95])
    x = tsp.betaincinv(_t(a), _t(b), _t(p))
    np.testing.assert_allclose(tsp.betainc(_t(a), _t(b), x).numpy(), p,
                               rtol=1e-12)
    f = [torch.tensor(v, dtype=torch.float32) for v in (a, b, p)]
    x32 = tsp.betaincinv(*f)
    want32 = np.asarray(jsp.betaincinv(*(v.astype(np.float32)
                                         for v in (a, b, p))))
    assert x32.dtype == torch.float32
    np.testing.assert_allclose(x32.numpy(), want32, rtol=1e-5)


def test_cuda_tensors_raise_without_a_card():
    """A CUDA request never falls back to the plain version: with no card
    visible, asking for the card raises."""
    if torch.cuda.is_available():
        pytest.skip('a card is visible: the GPU tests cover the kernel')
    with pytest.raises(RuntimeError):
        tsp.betainc(0.5, 0.5, 0.3)
    with pytest.raises(RuntimeError):
        tsp.betaincinv(0.5, 0.5, 0.3)
