"""The port's chi2, F, binomial and multivariate distributions and its
random draws
(``gsum_tpu_torch.stats``) against ``gsum_tpu.stats`` on the same
parameters and points, f64 on the CPU, mirroring ``tests/test_stats.py``.

Densities, quantiles and moments are held at relative 1e-10 (an absolute
floor of 1e-300); the binomial quantiles are integers and compared exactly.
chi2's ``cdf`` / ``ppf`` rest on ``torch.special.gammainc``, exact to 1e-15
for df <= 40, the degrees of freedom tested here.

Random draws come from another generator than JAX's, so they are held by
reproducibility (equal seeds, equal draws) and by their moments: each
sample mean within 5 σ/√n of the distribution's mean, at n = 20000.
"""
import numpy as np
import pytest
import torch

from gsum_tpu import stats as jst
from gsum_tpu_torch import stats as tst

RTOL = 1e-10
N_DRAWS = 20000
rng = np.random.RandomState(1)
CPU = 'cpu'


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-300)


def _methods(jd, td, x, q, scale=1.0):
    """Densities and cdf at ``x``, quantiles at ``q`` and the 68% interval
    (against JAX's quantiles at 0.16 and 0.84, taken in the same call: each
    call of a JAX quantile compiles its loop anew); a quantile near ``loc``
    is ``loc + scale z`` with a small z, so it is held to 1e-10 of
    ``scale`` too."""
    for name in ('pdf', 'logpdf', 'cdf', 'sf'):
        _close(getattr(td, name)(x), getattr(jd, name)(x))
    q = np.concatenate([q, [0.16, 0.84]])
    want = np.asarray(jd.ppf(q))
    np.testing.assert_allclose(td.ppf(q).numpy(), want, rtol=RTOL,
                               atol=RTOL * scale)
    lo, hi = td.interval(0.68)
    np.testing.assert_allclose([lo.item(), hi.item()], want[-2:], rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize('df', [1, 3, 6, 20])
def test_chi2(df):
    jd, td = jst.chi2(df=df), tst.chi2(df=df, device=CPU)
    _methods(jd, td, np.linspace(0.1, 30, 25), np.linspace(0.02, 0.98, 13))
    for name in ('mean', 'std'):
        _close(getattr(td, name)(), getattr(jd, name)())


def test_f_dist():
    jd = jst.f(dfn=6, dfd=10, scale=1.5)
    td = tst.f(dfn=6, dfd=10, scale=1.5, device=CPU)
    _methods(jd, td, np.linspace(0.05, 8, 25), np.linspace(0.02, 0.98, 13))
    for name in ('mean', 'std', 'median'):
        _close(getattr(td, name)(), getattr(jd, name)())


def test_binom():
    n, p = 50, 0.37
    jd, td = jst.binom(n=n, p=p), tst.binom(n=n, p=p, device=CPU)
    k = np.arange(0, n + 1)
    _close(td.pmf(k), jd.pmf(k))
    _close(td.cdf(np.arange(-2, n + 3)), jd.cdf(np.arange(-2, n + 3)))
    q = np.array([0.0, 0.025, 0.16, 0.5, 0.84, 0.975, 1.0])
    np.testing.assert_array_equal(td.ppf(q).numpy(), np.asarray(jd.ppf(q)))
    for got, want in zip(td.interval(0.68), jd.interval(0.68)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(td.mean(), jd.mean())
    _close(td.std(), jd.std())


def test_binom_vector_p():
    n = 30
    p = np.array([0.2, 0.5, 0.8])
    jd, td = jst.binom(n=n, p=p), tst.binom(n=n, p=p, device=CPU)
    conf = np.atleast_2d([0.68, 0.95]).T
    for got, want in zip(td.interval(conf), jd.interval(conf)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(td.logpmf(np.array([3.0, 15.0, 24.0])),
           jd.logpmf(np.array([3.0, 15.0, 24.0])))


def _spd(n):
    A = rng.randn(n, n)
    return A @ A.T + n * np.eye(n)


def test_mvn():
    mean, cov = rng.randn(5), _spd(5)
    jd = jst.multivariate_normal(mean=mean, cov=cov)
    td = tst.multivariate_normal(mean=mean, cov=cov, device=CPU)
    x = rng.randn(7, 5)
    _close(td.logpdf(x), jd.logpdf(x))
    _close(td.logpdf(x[0]), jd.logpdf(x[0]))
    _close(td.pdf(x), jd.pdf(x))
    _close(tst.multivariate_normal.logpdf(x, mean, cov, device=CPU),
           jst.multivariate_normal.logpdf(x, mean, cov))
    js = jst.multivariate_normal(mean, cov, allow_singular=True)
    ts = tst.multivariate_normal(mean, cov, allow_singular=True, device=CPU)
    _close(ts.logpdf(x), js.logpdf(x))


def test_mvt():
    mean, sigma = rng.randn(4), _spd(4)
    for df in (7, 7.5):
        jd = jst.multivariate_t(mean=mean, sigma=sigma, df=df)
        td = tst.multivariate_t(mean=mean, sigma=sigma, df=df, device=CPU)
        x = rng.randn(6, 4)
        _close(td.logpdf(x), jd.logpdf(x))
        _close(td.pdf(x[1]), jd.pdf(x[1]))
        _close(td.cov(), jd.cov())
    assert tst.MVT is type(td)


def test_tensor_parameters_keep_their_device_and_type():
    """A float32 tensor parameter is computed in float64 (JAX's promotion
    with the library's default) on the tensor's device; numbers go to the
    device asked for."""
    loc = torch.tensor([0.5, 1.0], dtype=torch.float32)
    d = tst.norm(loc=loc, scale=2.0)
    assert d.device == loc.device and d.loc.dtype == torch.float64
    _close(d.cdf(np.array([0.1, 0.7])),
           jst.norm(loc=np.array([0.5, 1.0]), scale=2.0).cdf(
               np.array([0.1, 0.7])))
    with pytest.raises((RuntimeError, ValueError)):
        if torch.cuda.is_available():
            raise RuntimeError('a card is visible: the device default works')
        tst.norm(0.0, 1.0)


# --- random draws -------------------------------------------------------
def _draw_cases():
    mean, cov = rng.randn(3), _spd(3)
    return {
        'norm': (tst.norm(1.0, 2.0, device=CPU), 1.0, 2.0),
        't': (tst.t(5.0, 0.5, 1.5, device=CPU), 0.5,
              1.5 * np.sqrt(5.0 / 3.0)),
        'chi2': (tst.chi2(np.array([2.0, 5.0]), device=CPU),
                 np.array([2.0, 5.0]), np.sqrt(2 * np.array([2.0, 5.0]))),
        'f': (tst.f(4.0, 9.0, device=CPU), 9.0 / 7.0,
              np.sqrt(2 * 81 * 11 / (4 * 49 * 5))),
        'beta': (tst.beta(np.array([1.0, 2.0, 3.0]), 2.0, device=CPU),
                 np.array([1.0, 2.0, 3.0]) / np.array([3.0, 4.0, 5.0]),
                 np.sqrt(np.array([2.0, 4.0, 6.0])
                         / (np.array([9.0, 16.0, 25.0])
                            * np.array([4.0, 5.0, 6.0])))),
        'binom': (tst.binom(6, np.array([0.2, 0.8]), device=CPU),
                  6 * np.array([0.2, 0.8]),
                  np.sqrt(6 * 0.2 * 0.8) * np.ones(2)),
        'mvn': (tst.multivariate_normal(mean, cov, device=CPU), mean,
                np.sqrt(np.diag(cov))),
        'mvt': (tst.multivariate_t(mean, cov, 7.0, device=CPU), mean,
                np.sqrt(np.diag(cov) * 7.0 / 5.0)),
    }


@pytest.mark.parametrize('name', ['norm', 't', 'chi2', 'f', 'beta', 'binom',
                                  'mvn', 'mvt'])
def test_rvs(name):
    dist, mu, sd = _draw_cases()[name]
    a = dist.rvs(N_DRAWS, random_state=3)
    b = dist.rvs(N_DRAWS, random_state=3)
    assert torch.equal(a, b)
    assert not torch.equal(a, dist.rvs(N_DRAWS, random_state=4))
    assert a.shape[0] == N_DRAWS and torch.isfinite(a).all()
    mean = a.numpy().mean(axis=0)
    assert np.all(np.abs(mean - mu) <= 5 * sd / np.sqrt(N_DRAWS)), (mean, mu)
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(dist.rvs(N_DRAWS, random_state=gen), a)


def test_rvs_shapes():
    """Parameter shapes are appended to the size; size 1 is squeezed."""
    assert tst.chi2(np.array([2.0, 5.0]), device=CPU).rvs(
        4, random_state=0).shape == (4, 2)
    assert tst.f(np.array([2.0, 4.0]), 7.0, device=CPU).rvs(
        3, random_state=1).shape == (3, 2)
    out = tst.beta(np.array([1.0, 2.0, 3.0]), 2.0, device=CPU).rvs(
        5, random_state=2)
    assert out.shape == (5, 3) and ((out >= 0) & (out <= 1)).all()
    out = tst.binom(6, np.array([0.2, 0.8]), device=CPU).rvs(
        3, random_state=3)
    assert out.shape == (3, 2) and ((out >= 0) & (out <= 6)).all()
    assert tst.norm(0.0, 1.0, device=CPU).rvs().shape == ()
    assert tst.multivariate_normal(np.zeros(3), np.eye(3), device=CPU).rvs(
        (2, 4)).shape == (2, 4, 3)
