"""The port's ``diagnostics.Diagnostic`` and the statistics helpers of
``gsum_tpu_torch.helpers`` against ``gsum_tpu`` on the same seeded inputs,
f64 on the CPU.

Tolerances:

- ``Diagnostic``: each result goes through a Cholesky, pivoted-Cholesky or
  eigen solve with the covariance, so it is held to ``cond(cov)·eps·10``
  relative to its largest entry (at least 1e-12); the covariance here has
  condition number 10³ and distinct eigenvalues.  ``eigen_errors`` are compared row by row up
  to each row's sign (an eigenvector's sign is LAPACK's choice).
  Coverages (``credible_interval``) to 1e-15, the rounding of their mean.
  ``samples`` are draws of another generator: held by their sample mean,
  within 5 σ/√n per point.
- ``kl_gauss``, ``general_sqrt_errors``, ``predictions``, ``median_pdf``,
  ``hpd_pdf``: relative 1e-10 (1e-12 where no solve is involved).
- ``hpd``: its length to 2e-8 and its ends to 1e-4 / pdf(end), what
  ``scipy.optimize.fmin``'s stopping rule (ftol 1e-8, xtol 1e-4) allows.

``VariogramFourthRoot`` and ``hyp2f1_variogram`` are in
``tests/test_torch_variogram.py``.
"""
import jax
import numpy as np
import pytest
import scipy.stats as st
import torch

import gsum_tpu as gm
from gsum_tpu import helpers as jh
from gsum_tpu_torch import helpers as th
from gsum_tpu_torch import stats as tst
from gsum_tpu_torch.diagnostics import Diagnostic

CPU = 'cpu'
EPS = np.finfo(float).eps
rng = np.random.RandomState(3)
N = 24
X = np.sort(rng.rand(N))[:, None]
MEAN = np.sin(4 * X[:, 0])
# distinct eigenvalues from 1 down to 1e-3, so that each eigenvector is
# defined up to its sign
_Q = np.linalg.qr(rng.randn(N, N))[0]
COV = (_Q * np.geomspace(1.0, 1e-3, N)) @ _Q.T
COND = np.linalg.cond(COV)
Y = MEAN[:, None] + np.linalg.cholesky(COV) @ rng.randn(N, 3)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _pair(df=None):
    return (gm.Diagnostic(MEAN, COV, df=df),
            Diagnostic(MEAN, COV, df=df, device=CPU))


@pytest.mark.parametrize('df', [None, 5.0])
def test_diagnostic_errors(df):
    jd, td = _pair(df)
    tol = max(1e-12, COND * EPS * 10)
    for y in (Y, Y[:, 0]):
        for name in ('individual_errors', 'cholesky_errors',
                     'pivoted_cholesky_errors', 'chi2', 'md_squared'):
            _close(getattr(td, name)(y), getattr(jd, name)(y), tol)
        got, want = _np(td.eigen_errors(y)), _np(jd.eigen_errors(y))
        # a 1-D y gives (n, n) in both: the JAX package broadcasts the
        # whitened vector (along the columns) against its column of scales,
        # so there each column carries an eigenvector's sign
        assert got.shape == want.shape == (N, N if y.ndim == 1 else 3)
        signs = np.sign(np.sum(got * want, axis=0 if y.ndim == 1 else 1,
                               keepdims=True))
        _close(signs * got, want, tol)
    np.testing.assert_array_equal(_np(td._piv), _np(jd._piv))
    _close(td._eig_vals, jd._eig_vals, tol)


@pytest.mark.parametrize('df', [None, 5.0])
def test_diagnostic_kl_and_coverage(df):
    jd, td = _pair(df)
    tol = max(1e-12, COND * EPS * 10)
    m0 = MEAN + 0.1
    c0 = 1.5 * COV
    _close(td.kl(m0, c0), jd.kl(m0, c0), tol)
    intervals = np.linspace(0.1, 0.9, 5)
    for y in (Y, Y[:, 1]):
        _close(td.credible_interval(y, intervals),
               jd.credible_interval(y, intervals), 1e-15)


@pytest.mark.parametrize('df', [None, 5.0])
def test_diagnostic_samples(df):
    td = Diagnostic(MEAN, COV, df=df, device=CPU)
    n = 4000
    s = td.samples(n)
    assert s.shape == (N, n) and torch.equal(s, td.samples(n))
    sd = np.sqrt(np.diag(COV) * (1 if df is None else df / (df - 2)))
    assert np.all(np.abs(_np(s).mean(1) - MEAN) <= 5 * sd / np.sqrt(n))


def test_kl_gauss_and_general_sqrt_errors():
    m1 = MEAN + 0.05
    c1 = 0.8 * COV + 0.01 * np.eye(N)
    tol = max(1e-10, COND * EPS * 10)
    _close(th.kl_gauss(torch.from_numpy(MEAN), COV, m1, cov1=c1),
           jh.kl_gauss(MEAN, COV, m1, cov1=c1), tol)
    chol = np.linalg.cholesky(c1)
    _close(th.kl_gauss(torch.from_numpy(MEAN), COV, m1, chol1=chol),
           jh.kl_gauss(MEAN, COV, m1, chol1=chol), tol)
    for kw in ({}, {'cov1': c1, 'chol1': chol}):
        with pytest.raises(ValueError):
            th.kl_gauss(torch.from_numpy(MEAN), COV, m1, **kw)
    e, v = np.linalg.eigh(COV)
    sqrt_mat = v * np.sqrt(e)
    for y in (Y.T, Y[:, 0]):
        _close(th.general_sqrt_errors(torch.from_numpy(y), MEAN, sqrt_mat),
               jh.general_sqrt_errors(y, MEAN, sqrt_mat), tol)


def test_predictions_hpd_and_tabulated_pdf():
    td = tst.t(5.0, loc=MEAN[:4], scale=2.0, device=CPU)
    jd = gm.stats.t(5.0, loc=MEAN[:4], scale=2.0)
    _close(th.predictions(td), jh.predictions(jd), 1e-12)
    dob = np.array([0.68, 0.95])
    for g, w in zip(th.predictions(td, dob), jh.predictions(jd, dob)):
        _close(g, w, 1e-10)

    got = th.hpd(tst.beta, 0.68, 3.0, 5.0, device=CPU)
    frozen = gm.stats.beta(3.0, 5.0)
    frozen.ppf = jax.jit(frozen.ppf)    # one compile, not one per call
    want = jh.hpd(frozen, 0.68)
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got[1] - got[0], want[1] - want[0], atol=2e-8)
    assert np.all(np.abs(got - want) <= 1e-4 / st.beta(3, 5).pdf(want))

    x = np.linspace(-4, 6, 301)
    pdf = st.norm(1.0, 1.3).pdf(x) + 0.3 * st.norm(-2, 0.5).pdf(x)
    _close(th.hpd_pdf(torch.from_numpy(pdf), 0.68, x),
           jh.hpd_pdf(pdf, 0.68, x), 1e-12)
    _close(th.median_pdf(torch.from_numpy(pdf), x), jh.median_pdf(pdf, x),
           1e-12)
    flat = np.full(5, 0.01)
    _close(th.median_pdf(torch.from_numpy(flat), np.arange(5.0)),
           jh.median_pdf(flat, np.arange(5.0)), 1e-12)


def _host(deco):
    """An object whose methods use each decorator of ``deco`` (the JAX
    package's helpers or the port's)."""
    class Host:
        def __init__(self):
            self.calls = 0
            self.y = np.arange(3.0)
            self._corr_chol = np.eye(3)
            self.x_ = 'x from self'
            self.args_ = (1, 2)

        @deco.lazy_property
        def prop(self):
            self.calls += 1
            return self.calls

        @deco.lazy
        def cached(self, y=None, corr_chol=None):
            self.calls += 1
            return float(np.sum(_np(y))) + float(np.trace(corr_chol))

        @deco.default_attributes(x='x_', args='args_')
        def filled(self, x=None, *args):
            return x, args
    return Host()


@pytest.mark.parametrize('deco', [jh, th], ids=['jax', 'port'])
def test_decorators(deco):
    """The port's decorators behave as the JAX package's (each case is run
    on both)."""
    h = _host(deco)
    assert (h.prop, h.prop, h.calls) == (1, 1, 1)
    assert h.cached() == 6.0 and h.cached() == 6.0 and h.calls == 2
    assert h.cached(y=np.arange(3.0)) == 6.0 and h.calls == 2
    assert h.cached(y=np.ones(3)) == 6.0 and h.calls == 3
    assert h.cached(y=torch.ones(3) if deco is th else np.ones(3)) == 6.0
    assert h.filled() == ('x from self', (1, 2))
    assert h.filled('given') == ('given', (1, 2))
    assert h.filled('given', 5) == ('given', (5,))
    arr = np.zeros(2) if deco is jh else torch.zeros(2)
    assert h.filled(arr)[0] is arr
