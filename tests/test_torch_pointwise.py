"""The port's ``TruncationPointwise`` against ``gsum_tpu``'s, built from it by
``convert.to_torch_model`` (rebuilt from its prior and refitted on its data),
f64 on the CPU.

Tolerances: the fitted state, intervals, densities, std and the log
likelihood at relative 1e-10 (the intervals go through ``betaincinv``, held
to 1e-10 in ``tests/test_torch_special.py``); the credible-interval coverage
to 1e-15, the rounding of its mean (it counts points inside intervals that
agree to 1e-10, and no data point lies that close to an edge); binomial bands exactly (integer
quantiles over N).  Beta bands come from ``hpd``, a ``scipy.optimize.fmin``
over the beta quantile with ``ftol=1e-8``: fmin's stopping rule holds the
interval's length to 1e-8 and its start to fmin's ``xtol`` (1e-4) in
probability, so the band's length is held to 2e-8 and its ends to
1e-4 / pdf(end).
"""
import numpy as np
import pytest
import scipy.stats as st
import torch

import gsum_tpu as gm
from gsum_tpu import helpers as jh
from gsum_tpu_torch import models as tm
from gsum_tpu_torch.convert import to_torch_model
from _port import one_intra_op_thread  # noqa: F401 (autouse)

RTOL = 1e-10
CPU = 'cpu'
rng = np.random.RandomState(7)
N = 40
ORDERS = np.arange(5)
COEFFS = rng.randn(N, len(ORDERS))
RATIO = 0.3 + 0.4 * rng.rand(N)
REF = 1.0 + rng.rand(N)
Y = np.asarray(jh.partials(COEFFS, RATIO, REF, orders=ORDERS))
DATA = Y + 0.05 * rng.randn(*Y.shape)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-300)


def _pair(ratio=RATIO, ref=REF, orders=ORDERS, **kw):
    params = {'df': 1, 'scale': 1}
    params.update(kw)
    jm = gm.TruncationPointwise(**params).fit(Y, ratio=ratio, ref=ref,
                                              orders=orders)
    return jm, to_torch_model(jm, CPU)


PRIORS = {'df=1, scale=1': {},
          'scale invariant df=0, excluded=[0]': {'df': 0, 'excluded': [0]},
          'df=3, per-point scale, excluded=[1]':
              {'df': 3, 'scale': 0.5 + rng.rand(N), 'excluded': [1]}}


@pytest.mark.parametrize('prior', list(PRIORS))
def test_fit_and_predictions(prior):
    jm, tp = _pair(**PRIORS[prior])
    assert isinstance(tp, tm.TruncationPointwise) and tp._fit
    assert tp.df_ == jm.df_
    np.testing.assert_array_equal(tp.orders_mask_, jm.orders_mask_)
    for name in ('coeffs_', 'scale_', 'y_masked_'):
        _close(getattr(tp, name), getattr(jm, name))
    _close((tp.interval(np.array([0.68, 0.95]))),
           np.asarray(jm.interval(np.array([0.68, 0.95]))))
    _close(tp.std(), jm.std())
    yy = Y[:, -1] + 0.1
    _close(tp.pdf(yy), jm.pdf(yy))
    _close(tp.logpdf(yy), jm.logpdf(yy))
    _close(tp.coeffs_dist_.std(), jm.coeffs_dist_.std())


@pytest.mark.parametrize('orders', [3, [2, 4]])
def test_order_indices(orders):
    """A single order gives a 0-d index (the dimension goes), a list keeps
    it, as numpy's squeeze of the JAX package's index does."""
    jm, tp = _pair()
    _close((tp.interval(np.array([0.68, 0.95]), orders=orders)),
           np.asarray(jm.interval(np.array([0.68, 0.95]), orders=orders)))
    _close((tp.interval(0.9, orders=orders)),
           np.asarray(jm.interval(0.9, orders=orders)))
    yy = Y[:, -1]
    _close(tp.logpdf(yy, orders=orders), jm.logpdf(yy, orders=orders))


@pytest.mark.parametrize('prior', list(PRIORS))
def test_log_likelihood(prior):
    jm, tp = _pair(**PRIORS[prior])
    _close(tp.log_likelihood(), jm.log_likelihood())
    for r in (0.3, 0.45, 0.6, RATIO[::-1].copy()):
        _close(tp.log_likelihood(ratio=r), jm.log_likelihood(ratio=r))
    _close(tp.log_likelihood(ratio=0.5, ref=2.0),
           jm.log_likelihood(ratio=0.5, ref=2.0))


def test_scalar_ratio_and_ref():
    jm, tp = _pair(ratio=0.5, ref=10.0)
    _close(tp.scale_, jm.scale_)
    _close(tp.log_likelihood(ratio=0.4), jm.log_likelihood(ratio=0.4))
    _close((tp.interval(0.68)), np.asarray(jm.interval(0.68)))


def test_unfitted_and_unfitted_conversion():
    jm = gm.TruncationPointwise(df=2, scale=3, excluded=[0])
    tp = to_torch_model(jm, CPU)
    assert (tp.df0, tp.scale0, tp.excluded, tp._fit) == (2, 3, [0], False)
    with pytest.raises(ValueError):
        tp.log_likelihood()
    with pytest.raises(ValueError):
        tm.TruncationPointwise(device=CPU).fit(Y, 0.5, orders=np.arange(3))


def test_credible_diagnostic():
    jm, tp = _pair()
    dobs = np.linspace(0.1, 0.9, 5)
    _close(tp.credible_diagnostic(DATA, dobs),
           jm.credible_diagnostic(DATA, dobs), rtol=1e-15)
    band_dobs = np.array([0.25, 0.75])
    d_t, b_t = tp.credible_diagnostic(DATA, dobs, band_intervals=[0.68, 0.95],
                                      band_dobs=band_dobs, beta=False)
    d_j, b_j = jm.credible_diagnostic(DATA, dobs, band_intervals=[0.68, 0.95],
                                      band_dobs=band_dobs, beta=False)
    _close(d_t, d_j, rtol=1e-15)
    np.testing.assert_array_equal(b_t, np.asarray(b_j))
    assert b_t.shape == (2, 2, 2)

    d_t, b_t = tp.credible_diagnostic(DATA[:, -1], dobs, band_intervals=[0.68],
                                      band_dobs=band_dobs)
    _close(d_t, jm.credible_diagnostic(DATA[:, -1], dobs), rtol=1e-15)
    hold_beta_bands(b_t, jax_beta_bands([0.68], band_dobs, N), [0.68],
                    band_dobs, N)


def jax_beta_bands(intervals, band_dobs, n):
    """The JAX package's beta bands, as its ``credible_diagnostic`` makes
    them (``helpers.hpd`` of ``stats.beta(N s + 1, N - N s + 1)``), with the
    quantile compiled once: an eager JAX quantile compiles its loop at every
    call, some hundred calls per band."""
    import jax

    bands = np.zeros((len(intervals), 2, len(band_dobs)))
    for i, p in enumerate(intervals):
        for j, s in enumerate(band_dobs):
            frozen = gm.stats.beta(n * s + 1, n - n * s + 1)
            frozen.ppf = jax.jit(frozen.ppf)
            bands[i, :, j] = jh.hpd(frozen, p)
    return bands


def hold_beta_bands(got, want, intervals, band_dobs, n):
    """Beta bands from ``hpd``, at the tolerance fmin's stopping rule allows
    (see the module's docstring)."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, 1] - got[:, 0], want[:, 1] - want[:, 0],
                               rtol=0, atol=2e-8)
    for i, _ in enumerate(intervals):
        for j, s in enumerate(band_dobs):
            pdf = st.beta(n * s + 1, n - n * s + 1).pdf(want[i, :, j])
            assert np.all(np.abs(got[i, :, j] - want[i, :, j])
                          <= 1e-4 / pdf), (got[i, :, j], want[i, :, j])
