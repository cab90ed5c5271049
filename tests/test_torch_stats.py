"""The port's frozen distributions (``gsum_tpu_torch.stats``) against
``gsum_tpu.stats`` on the same parameters and points, f64 on the CPU,
mirroring ``tests/test_stats.py``.

The normal, Student-t and beta families; chi2, F, the binomial, the
multivariate families and the random draws are in
``tests/test_torch_stats_mv.py``.

Every method is held at relative 1e-10 (an absolute floor of 1e-300 for
values that underflow alike); a quantile near ``loc`` also to 1e-10 of the
scale.
"""
import numpy as np
import pytest
import torch

from gsum_tpu import stats as jst
from gsum_tpu_torch import stats as tst

RTOL = 1e-10
N_DRAWS = 20000
rng = np.random.RandomState(0)
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


def test_norm():
    jd, td = jst.norm(loc=1.5, scale=2.0), tst.norm(1.5, 2.0, device=CPU)
    _methods(jd, td, np.linspace(-5, 8, 31), np.linspace(0.01, 0.99, 21),
             scale=2.0)
    for name in ('mean', 'std', 'var', 'median'):
        _close(getattr(td, name)(), getattr(jd, name)())
    _close(tst.norm.ppf(0.3, 1.0, 2.0, device=CPU),
           jst.norm.ppf(0.3, 1.0, 2.0))


@pytest.mark.parametrize('df', [1.0, 2.5, 5.0, 30.0])
def test_t(df):
    jd = jst.t(df=df, loc=0.5, scale=1.3)
    td = tst.t(df=df, loc=0.5, scale=1.3, device=CPU)
    _methods(jd, td, np.linspace(-6, 7, 27), np.linspace(0.01, 0.99, 21),
             scale=1.3)
    for name in ('mean', 'std', 'median'):
        _close(getattr(td, name)(), getattr(jd, name)())
    _close(tst.t.cdf(0.7, df, device=CPU), jst.t.cdf(0.7, df))


def test_t_array_params():
    """The pointwise model freezes an (n_points, n_orders) family at once;
    an array df reaches the device normalizer."""
    locs = rng.randn(4, 3)
    scales = 0.5 + rng.rand(4, 3)
    dfs = np.array([2.5, 6.0, 11.0])
    for df in (6.0, dfs):
        jd = jst.t(df=df, loc=locs, scale=scales)
        td = tst.t(df=df, loc=locs, scale=scales, device=CPU)
        conf = np.array([0.68, 0.95])[:, None, None]
        for got, want in zip(td.interval(conf), jd.interval(conf)):
            _close(got, want)
        _close(td.logpdf(locs + 0.3), jd.logpdf(locs + 0.3))
        _close(td.std(), jd.std())


def test_beta():
    jd, td = jst.beta(2.5, 4.0), tst.beta(2.5, 4.0, device=CPU)
    _methods(jd, td, np.linspace(0.01, 0.99, 21), np.linspace(0.02, 0.98, 13))
    for name in ('mean', 'std'):
        _close(getattr(td, name)(), getattr(jd, name)())
    a = np.array([[1.5], [3.0]])
    _close(tst.beta.ppf(np.array([0.1, 0.9]), a, 2.0, device=CPU),
           jst.beta.ppf(np.array([0.1, 0.9]), a, 2.0))


def test_ppf_out_of_domain_nan():
    q = np.array([1.5, -0.1])
    for td, jd in ((tst.beta(3.0, 5.0, device=CPU), jst.beta(3.0, 5.0)),
                   (tst.chi2(df=4, device=CPU), jst.chi2(df=4)),
                   (tst.t(4.0, device=CPU), jst.t(4.0))):
        assert np.isnan(td.ppf(q).numpy()).all()
        assert np.isnan(np.asarray(jd.ppf(q))).all()


def test_support():
    """ppf(0) and ppf(1), the JAX package's ``support``."""
    for td, want in ((tst.beta(3.0, 5.0, device=CPU), (0.0, 1.0)),
                     (tst.t(4.0, device=CPU), (-np.inf, np.inf)),
                     (tst.chi2(4.0, device=CPU), (0.0, np.inf))):
        assert tuple(v.item() for v in td.support()) == want


def test_logpdf_normalizers_stay_on_host(monkeypatch):
    """Normalizers of scalar parameters are host float64 numbers: the
    tensor lgamma and betaln are never reached for them."""
    import gsum_tpu_torch.stats as S

    def boom(*a, **k):
        raise AssertionError('device special function reached for scalar '
                             'parameters')

    monkeypatch.setattr(S, 'betaln', boom)
    monkeypatch.setattr(S.torch, 'lgamma', boom)
    x = np.linspace(0.1, 3.0, 5)
    for td, jd in ((tst.t(3.0, 0.5, 2.0, device=CPU), jst.t(3.0, 0.5, 2.0)),
                   (tst.chi2(4.0, device=CPU), jst.chi2(4.0)),
                   (tst.f(3.0, 7.0, device=CPU), jst.f(3.0, 7.0))):
        _close(td.logpdf(x), jd.logpdf(x))
    xb = np.linspace(0.05, 0.95, 5)
    _close(tst.beta(2.0, 3.0, device=CPU).logpdf(xb),
           jst.beta(2.0, 3.0).logpdf(xb))
