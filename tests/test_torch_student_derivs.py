"""Derivative data in the port's Student-t process and derivative
constraints of its truncation models against ``gsum_tpu``: the
``ConjugateStudentProcess`` ``fit(dorders=)`` / ``predict(dorders=)`` (the
cases and limits of ``tests/test_torch_models_derivs.py``), and
``TruncationGP`` / ``TruncationTP`` ``fit(dderivs=)`` with slope
constraints and predictions with derivative rows, f64 on the CPU.

Limits: a prediction goes through one factorization of the interpolant's
K_oo and one of the constraint covariance, so it is held to
``10·cond(K_oo)·EPS`` relative to its largest entry (at least 1e-12).  The
interpolant's K_oo is noise-free; at ℓ = 0.1 it is well conditioned (cond
10²–10³, the jitter ladder's first rung on both sides).  The slope of the
constrained truncation band's mean at the slope points is 0 to that limit
times the band's scale, and its std to the square root of it (a variance
pinned to 0 is a difference of O(1) terms).

JAX's predictions are jitted once per model (eager JAX compiles each
nested-gradient operation).
"""
import jax
import numpy as np
import pytest

import gsum_tpu as gm
from gsum_tpu_torch.convert import to_torch_model

from _derivs import (_close, _limit, _t, check_fit_state_and_lml,
                     check_predict_with_derivatives)

N = 10
X = np.linspace(0.0, 1.0, N)[:, None]
ORDERS = np.arange(4)
RATIO, REF = 0.45, 2.0
COEFFS = np.sin(3 * X + np.arange(4)) \
    + 0.05 * np.random.RandomState(4).randn(N, 4)
YT = np.asarray(gm.partials(COEFFS, RATIO, REF, ORDERS))
DX = np.array([[1.0], [1.0], [1.2]])
DY = np.zeros(3)
DDER = np.array([[0], [1], [1]])
TPRIORS = {'TruncationGP': dict(center=0, disp=0, df=3, scale=1),
           'TruncationTP': dict(center=0, disp=1, df=5, scale=1)}
XT = np.linspace(0.05, 1.1, 5)[:, None]
DT = np.array([1, 0, 1, 2, 1])[:, None]


def test_student_fit_state_and_lml_match_jax():
    check_fit_state_and_lml('ConjugateStudentProcess')


def test_student_predict_with_derivatives_matches_jax():
    check_predict_with_derivatives('ConjugateStudentProcess')


@pytest.mark.parametrize('name', list(TPRIORS))
def test_truncation_slope_constraints_match_jax(name):
    """Value and slope constraints of the truncation error at x = 1 and a
    slope constraint at 1.2, ℓ = 0.1 (θ fixed): the 'both' prediction with
    derivative rows (the interpolant's and the constrained truncation
    band's derivative paths) and the value band, against JAX; the
    constrained slope of the truncation band's mean is 0 at the slope
    points to round-off."""
    jm = getattr(gm, name)(gm.RBF(0.1, (1e-2, 10)), ratio=RATIO, ref=REF,
                           nugget=1e-10, optimizer=None, **TPRIORS[name])
    jm.fit(X, YT, ORDERS, dX=DX, dy=DY, dderivs=DDER)
    tm = to_torch_model(jm, 'cpu')
    np.testing.assert_array_equal(tm.dderivs_, DDER)
    tm.fit(_t(X), _t(YT), ORDERS, dX=tm.dX_, dy=tm.dy_, dderivs=tm.dderivs_)
    lim = _limit(tm.cov(X=_t(X), Xp=_t(X), start=0, end=2))

    def jax_pred(Xn):
        return (jm.predict(Xn, 2, return_cov=True, dorders=DT),
                jm.predict(Xn, 2, return_std=True))

    want = jax.jit(jax_pred)(XT)
    got = (tm.predict(_t(XT), 2, return_cov=True, dorders=DT),
           tm.predict(_t(XT), 2, return_std=True))
    for g, w in zip(got, want):
        for gi, wi in zip(g, w):
            _close(gi, wi, lim)
    # the kinds add up: 'interp' + 'trunc' is 'both' (each alone is the
    # same code path as in 'both')
    parts = [tm.predict(_t(XT), 2, return_cov=True, dorders=DT, kind=k)
             for k in ('interp', 'trunc')]
    if name == 'TruncationGP':
        _close(parts[0][0] + parts[1][0], got[0][0], lim)
        _close(parts[0][1] + parts[1][1], got[0][1], lim)
    # the slope of the constrained truncation band at the slope points
    m, s = tm.predict(_t(DX[1:]), 2, kind='trunc', dorders=[[1], [1]],
                      return_std=True)
    scale = float(parts[1][1].diagonal().max().sqrt())
    assert float(m.abs().max()) <= lim * scale
    assert float(s.max()) <= np.sqrt(lim) * scale
    # dderivs of all zeros are value constraints, as in JAX
    tm.fit(_t(X), _t(YT), ORDERS, dX=_t(DX), dy=_t(DY),
           dderivs=np.zeros((3, 1), int))
    assert tm.dderivs_ is None
