"""``diagnostics.GraphicalDiagnostic`` and ``viz`` of the port against
``gsum_tpu``'s on the CPU, with JAX's reference draws put into the port's
object (its ``samples`` set and ``_ref_err_cache`` cleared), so that both
whiten and summarize the same numbers.

Setup: N=24 points, 3 data curves, nref=48 draws, a covariance of condition
number 10³ with distinct eigenvalues (the one of
``tests/test_torch_diagnostics.py``), a Student-t reference (df=6: the
standardized quantiles and intervals go through the incomplete beta
function, the MD² reference is an F).

Tolerances:

- whitened errors go through one solve with the covariance (or its pivoted
  factor or eigenbasis), so QQ order statistics and their envelopes are
  held to ``10·cond·EPS`` relative (2e-12); the eigen map after aligning
  each eigenvector's sign to JAX's (a sign is LAPACK's choice);
- the t quantiles (theoretical QQ quantiles, interval ends): 1e-12
  relative, the agreement of the two ``betaincinv`` implementations
  (``tests/test_torch_special.py``); coverages are means of counts, held
  to 1e-15, the rounding of the mean (no point lies on an interval's
  end);
- the MD² reference grid (F quantiles and pdf): 1e-11 relative.

``kl_data`` is in ``tests/test_torch_graphical_kl.py``, the panels and
dashboards in ``tests/test_torch_graphical_panels.py``.
"""
import numpy as np
import pytest
import torch

import gsum_tpu as gm
import gsum_tpu_torch as gt
from gsum_tpu_torch import viz

EPS = np.finfo(float).eps
rng = np.random.RandomState(3)
N, NREF, DF = 24, 48, 6.0
X = np.sort(rng.rand(N))[:, None]
MEAN = np.sin(4 * X[:, 0])
_Q = np.linalg.qr(rng.randn(N, N))[0]
COV = (_Q * np.geomspace(1.0, 1e-3, N)) @ _Q.T
LIM = 10 * np.linalg.cond(COV) * EPS
Y = MEAN[:, None] + np.linalg.cholesky(COV) @ rng.randn(N, 3)
COLORS = ['C0', 'C1', 'C2']
INTERVALS = np.linspace(0.1, 0.9, 5)


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope='module')
def pair():
    """JAX's object and the port's, with JAX's draws in both."""
    jg = gm.GraphicalDiagnostic(Y, MEAN, COV, df=DF, nref=NREF,
                                colors=COLORS)
    tg = gt.GraphicalDiagnostic(torch.from_numpy(Y), torch.from_numpy(MEAN),
                                torch.from_numpy(COV), df=DF, nref=NREF,
                                colors=COLORS)
    assert tg.samples.shape == (N, NREF)
    tg.samples = torch.from_numpy(np.array(jg.samples))
    tg._ref_err_cache = {}
    # align each eigenvector's sign to JAX's
    v_j = np.asarray(jg.diagnostic._eig_vecs)
    d = tg.diagnostic
    signs = np.sign(np.sum(v_j * d._eig_vecs.numpy(), axis=0))
    d._eig_vecs = d._eig_vecs * torch.from_numpy(signs)
    d._eig = d._eig_vecs @ torch.diag(torch.sqrt(d._eig_vals))
    return jg, tg


def _same_qq(got, want, rtol):
    (tq, sd, bands), (tq_j, sd_j, bands_j) = got, want
    _close(tq, tq_j, 1e-12)
    _close(sd, sd_j, rtol)
    assert len(bands) == len(bands_j)
    for (lo, hi), (lo_j, hi_j) in zip(bands, bands_j):
        _close(lo, lo_j, rtol)
        _close(hi, hi_j, rtol)


@pytest.mark.parametrize('name', ['individual', 'cholesky',
                                  'pivoted_cholesky', 'eigen'])
def test_qq_band_data_matches_jax(pair, name):
    jg, tg = pair
    _same_qq(tg.qq_band_data(name), jg.qq_band_data(name), LIM)


def test_coverage_and_md_reference_match_jax(pair):
    jg, tg = pair
    cov, bands = tg.coverage_band_data(INTERVALS)
    cov_j, bands_j = jg.coverage_band_data(INTERVALS)
    _close(cov, cov_j, 1e-15)
    for (lo, hi), (lo_j, hi_j) in zip(bands, bands_j):
        _close(lo, lo_j, 1e-15)
        _close(hi, hi_j, 1e-15)
    xs, pdf = tg._dist_grid(tg.md_ref_dist, n=40)
    xs_j, pdf_j = jg._dist_grid(jg.md_ref_dist, n=40)
    _close(xs, xs_j, 1e-11)
    _close(pdf, pdf_j, 1e-11)


def test_variogram_data_matches_jax(pair):
    """The panel's numbers: JAX computes them inside ``variogram``; here
    they are its steps, through JAX's ``Diagnostic.variogram``."""
    jg, tg = pair
    d = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    bounds = np.linspace(0.0, d.max(), 7)[1:-1]
    _, loc_j, g_j, lo_j, hi_j = jg.diagnostic.variogram(X, Y.T, bounds)
    loc, g, lo, hi = tg.variogram_data(X, n_bins=6)
    _close(loc, loc_j, 1e-13)
    for got, want in ((g, g_j), (lo, lo_j), (hi, hi_j)):
        _close(got, np.atleast_2d(np.asarray(want).T), 1e-12)


def test_envelopes_take_quantiles_from_the_sorted_tensor():
    """``sorted_sample_envelope`` / ``coverage_envelope`` against numpy's
    'linear' quantiles of the sorted draws (JAX's rule), exactly but for
    the interpolation's last bit."""
    draws = np.random.RandomState(0).randn(7, 101)
    bands = viz.sorted_sample_envelope(torch.from_numpy(draws), [0.5, 0.9])
    s = np.sort(draws, axis=0)
    for (lo, hi), (qlo, qhi) in zip(bands, [(0.25, 0.75), (0.05, 0.95)]):
        _close(lo, np.quantile(s, qlo, axis=1), 1e-15)
        _close(hi, np.quantile(s, qhi, axis=1), 1e-15)
    cov = np.random.RandomState(1).rand(64, 5)
    ((lo, hi),) = viz.coverage_envelope(torch.from_numpy(cov), [0.68])
    _close(lo, np.quantile(cov, 0.16, axis=0), 1e-15)
    _close(hi, np.quantile(cov, 0.84, axis=0), 1e-15)
