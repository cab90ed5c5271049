"""The model-checking slice whole, on the CPU at N = 40, against the JAX
package: a ``TruncationGP`` (at a fixed θ) gives its coefficient process's
mean and covariance at 20 validation points; ``Diagnostic`` checks the
coefficient curves there; ``TruncationPointwise`` is fitted on the same
partial sums and its ``credible_diagnostic`` run with binomial and beta
bands.  The port's models are built from the JAX ones by
``convert.to_torch_model``.

Tolerances: the coefficient process's mean and covariance at relative
1e-10 (``tests/test_torch_truncation.py``'s limit); every ``Diagnostic``
result at cond(cov)·(δ + 10 eps) relative to its largest entry, where δ is
the measured relative difference of the two sides' covariances (a solve
with that matrix amplifies both).  ``pivoted_cholesky_errors``: the
covariance's diagonal is constant (a stationary kernel), so the pivot order
rests on ties that round-off breaks; where the two sides' pivots differ, the
errors are another square root's and only their sum of squares per curve,
the squared Mahalanobis distance, is held.  ``eigen_errors``: the covariance's small
eigenvalues cluster at the White term, where eigenvectors are defined only
up to a rotation within the cluster, so each curve's sum of squares is held
to its squared Mahalanobis distance, and a row only where its eigenvalue is
apart from the others (gap >= 1e-3 of the largest), up to its sign, at the
limit scaled by largest eigenvalue / gap (the eigenvector's condition);
coverages to 1e-15; the pointwise model's intervals at 1e-10, the binomial
bands exactly and the beta bands at what ``scipy.optimize.fmin``'s stopping
rule allows (length 2e-8, ends 1e-4 / pdf(end)).
"""
import jax
import numpy as np
import scipy.stats as st
import torch

import gsum_tpu as gm
from gsum_tpu import helpers as jh
from gsum_tpu_torch.convert import to_torch_model
from gsum_tpu_torch.diagnostics import Diagnostic
from _port import one_intra_op_thread  # noqa: F401 (autouse)

EPS = np.finfo(float).eps
rng = np.random.RandomState(11)
N, N_VAL = 40, 20
X = np.linspace(0.05, 1.0, N)[:, None]
XV = (X[::2] + 0.0125)
ORDERS = np.arange(5)
RATIO, REF = 0.5, 10.0
COEFFS = np.sin(3 * X + ORDERS) + 0.05 * rng.randn(N, 5)
Y = np.array(gm.partials(COEFFS, RATIO, REF, ORDERS))
CV = np.sin(3 * XV + ORDERS) + 0.05 * rng.randn(N_VAL, 5)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_truncation_to_diagnostic_to_pointwise():
    kernel = gm.RBF(0.3, (1e-2, 10)) + gm.WhiteKernel(1e-4, (1e-8, 1e-1))
    jm = gm.TruncationGP(kernel, ratio=RATIO, ref=REF, center=0, disp=0, df=3,
                         scale=1, optimizer=None).fit(X, Y, orders=ORDERS)
    tm = to_torch_model(jm, 'cpu').fit(torch.from_numpy(X),
                                       torch.from_numpy(Y), orders=ORDERS)
    jc, tc = jm.coeffs_process, tm.coeffs_process
    mean_j, cov_j = np.asarray(jc.mean(XV)), np.asarray(jc.cov(XV))
    mean_t, cov_t = tc.mean(XV), tc.cov(XV)
    _close(mean_t, mean_j, 1e-10)
    _close(cov_t, cov_j, 1e-10)

    delta = np.abs(_np(cov_t) - cov_j).max() / np.abs(cov_j).max()
    cond = np.linalg.cond(cov_j)
    tol = cond * (delta + 10 * EPS)
    jd, td = gm.Diagnostic(mean_j, cov_j), Diagnostic(mean_t, cov_t)
    for name in ('individual_errors', 'cholesky_errors', 'md_squared',
                 'chi2'):
        _close(getattr(td, name)(CV), getattr(jd, name)(CV), tol)
    md2 = _np(jd.md_squared(CV))
    got, want = td.pivoted_cholesky_errors(CV), jd.pivoted_cholesky_errors(CV)
    if np.array_equal(_np(td._piv), _np(jd._piv)):
        _close(got, want, tol)
    np.testing.assert_allclose(np.sum(_np(got) ** 2, axis=0), md2, rtol=tol)
    hold_eigen_errors(_np(td.eigen_errors(CV)), _np(jd.eigen_errors(CV)),
                      np.linalg.eigvalsh(cov_j)[::-1], md2, tol)
    _close(td.kl(mean_j + 0.1, 2 * cov_j), jd.kl(mean_j + 0.1, 2 * cov_j),
           tol)
    dobs = np.linspace(0.1, 0.9, 9)
    _close(td.credible_interval(CV, dobs), jd.credible_interval(CV, dobs),
           1e-15)

    jp = gm.TruncationPointwise(df=1, scale=1).fit(Y, RATIO, REF, ORDERS)
    tp = to_torch_model(jp, 'cpu')
    _close(tp.interval(0.68), np.asarray(jp.interval(0.68)), 1e-10)
    data = Y + 0.02 * rng.randn(*Y.shape)
    band_dobs = np.array([0.3, 0.7])
    d_t, b_t = tp.credible_diagnostic(data, dobs, band_intervals=[0.68, 0.95],
                                      band_dobs=band_dobs, beta=False)
    d_j, b_j = jp.credible_diagnostic(data, dobs, band_intervals=[0.68, 0.95],
                                      band_dobs=band_dobs, beta=False)
    _close(d_t, d_j, 1e-15)
    np.testing.assert_array_equal(b_t, np.asarray(b_j))

    _, b_t = tp.credible_diagnostic(data, dobs, band_intervals=[0.68],
                                    band_dobs=band_dobs[:1])
    s = band_dobs[0]
    frozen = gm.stats.beta(N * s + 1, N - N * s + 1)
    frozen.ppf = jax.jit(frozen.ppf)     # one compile, not one per call
    want = jh.hpd(frozen, 0.68)
    assert b_t.shape == (1, 2, 1)
    got = b_t[0, :, 0]
    np.testing.assert_allclose(got[1] - got[0], want[1] - want[0], atol=2e-8)
    pdf = st.beta(N * s + 1, N - N * s + 1).pdf(want)
    assert np.all(np.abs(got - want) <= 1e-4 / pdf)


def hold_eigen_errors(got, want, eigvals, md2, tol):
    """``eigen_errors`` of the two sides (see the module's docstring)."""
    assert got.shape == want.shape
    np.testing.assert_allclose(np.sum(got ** 2, axis=0), md2, rtol=tol)
    gaps = np.array([np.min(np.abs(np.delete(eigvals, i) - e))
                     for i, e in enumerate(eigvals)]) / eigvals[0]
    apart = gaps >= 1e-3
    assert apart.sum() >= 3
    signs = np.sign(np.sum(got * want, axis=1, keepdims=True))
    for i in np.nonzero(apart)[0]:
        np.testing.assert_allclose(signs[i] * got[i], want[i], rtol=0,
                                   atol=tol / gaps[i] * np.abs(want).max())
