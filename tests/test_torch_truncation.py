"""The port's truncation models (``gsum_tpu_torch.models.TruncationGP`` /
``TruncationTP``) against their ``gsum_tpu`` twins on the same seeded
inputs, f64 on the CPU, outside ``predict`` (which
``test_torch_truncation_predict.py`` holds): fit, the lml at ratio keywords
with its gradient, excluded orders, the prior before fit, the errors and
``convert.to_torch_model``.  The port's models are built from the JAX ones
by ``convert.to_torch_model``; data and helpers are in ``_truncation.py``.

Tolerances: the coefficients at 1e-12; the lml at 1e-10 and its autograd
gradient against ``jax.grad`` at 1e-10; predictions of the truncation band
('trunc') at 1e-10 and of the interpolant at cond·ε of its K_oo (see
``test_torch_truncation_predict.py``); fitted θ at atol 1e-5 (two L-BFGS-B
runs on objectives that differ by round-off).  Tolerances are relative,
with an absolute floor at the tolerance times the largest entry.
"""
import numpy as np
import pytest
import torch

import gsum_tpu as gm
import gsum_tpu_torch as gt
from gsum_tpu_torch.convert import to_torch_model

from _truncation import (DX, DY, N, ORDERS, PRIORS, RATIO, REF, RTOL, THETA,
                         X, XNEW, Y, at_theta, close, interp_tol, jax_kernel,
                         models, pairs, ratio_jax, t)


@pytest.fixture(scope='module')
def fitted():
    """The two JAX models fitted with the free kernel (one L-BFGS-B fit
    each), shared by the tests that read a fitted model."""
    out = {}
    for name in PRIORS:
        jm, _ = models(name)
        out[name] = jm.fit(X, Y, orders=ORDERS)
    return out


@pytest.mark.parametrize('name', list(PRIORS))
def test_fit_matches_jax(fitted, name):
    """Coefficients at 1e-12; θ at atol 1e-5; each side's lml at the other
    side's θ at 1e-10."""
    jm = fitted[name]
    _, tm = models(name)
    tm.fit(t(X), t(Y), orders=ORDERS)
    close(tm.coeffs_, jm.coeffs_, 1e-12)
    jc, tc = jm.coeffs_process, tm.coeffs_process
    np.testing.assert_allclose(tc.kernel_.theta, jc.kernel_.theta, atol=1e-5)
    np.testing.assert_allclose(
        tc.log_marginal_likelihood_value_,
        float(jc.log_marginal_likelihood(tc.kernel_.theta)), rtol=RTOL)
    for attr in ('mean', 'cov', 'basis'):
        close(getattr(tm, attr)(t(XNEW), start=1, end=3),
               getattr(jm, attr)(XNEW, start=1, end=3))


@pytest.mark.parametrize('name', list(PRIORS))
def test_log_marginal_likelihood_at_ratio_keywords_matches_jax(fitted, name):
    """The lml with its gradient at one θ away from the optimum (where the
    gradient is near 0), at the model's ratio and at ``ratio=0.3`` (the
    scalar ratio's keyword), and at other ``X`` / ``y`` / ``orders``: 1e-10;
    the change of variables does not depend on θ, so the gradient is the
    coefficient process's."""
    jm = fitted[name]
    tm = to_torch_model(jm, 'cpu').fit(t(X), t(Y), orders=ORDERS)
    theta = THETA
    for kw in (dict(), dict(ratio=0.3),
               dict(X=X[:8], y=Y[:8, :4], orders=ORDERS[:4])):
        lml_j, grad_j = jm.log_marginal_likelihood(theta, True, **kw)
        lml, grad = tm.log_marginal_likelihood(
            theta, True, **{k: t(v) if k in ('X', 'y') else v
                            for k, v in kw.items()})
        close(lml, lml_j)
        close(grad, grad_j)
        close(tm.log_marginal_likelihood(theta, **{
            k: t(v) if k in ('X', 'y') else v for k, v in kw.items()}),
            lml_j)
    lml_c, _ = tm.coeffs_process.log_marginal_likelihood(theta, True)
    change = N * (5 * np.log(REF) + ORDERS.sum() * np.log(RATIO))
    close(tm.log_marginal_likelihood(theta), lml_c - change)


def test_excluded_orders_match_jax():
    """``excluded=[1]`` (TruncationProcess code, shared by both models): the
    coefficients drop order 1, the geometric sums skip it, and the change of
    variables counts four orders."""
    for name in ['TruncationGP']:
        jm, tm = models(name, 0.1, optimizer=None, excluded=[1])
        jm.fit(X, Y, orders=ORDERS)
        tm.fit(t(X), t(Y), orders=ORDERS)
        assert tm.coeffs_.shape == (N, 4)
        close(tm.coeffs_, jm.coeffs_, 1e-12)
        tol, _ = interp_tol(jm, tm, 3)
        for kind in ('both', 'trunc'):
            for g, w in pairs(tm.predict(t(XNEW), order=3, kind=kind,
                                          return_std=True),
                               jm.predict(XNEW, order=3, kind=kind,
                                          return_std=True)):
                close(g, w, RTOL if kind == 'trunc' else tol)
        theta = THETA
        for g, w in zip(tm.log_marginal_likelihood(theta, True),
                        jm.log_marginal_likelihood(theta, True)):
            close(g, w)


def test_unfitted_predict_returns_the_prior():
    """Before ``fit`` both models return the prior of the band above the
    order (``underlying_properties``); TruncationTP adds no second
    dispersion term (its coefficient process's prior cov already holds
    it), unlike ``ConjugateStudentProcess.predict``."""
    for name in PRIORS:
        jm, tm = models(name, 0.4)
        for kw in (dict(), dict(return_std=True), dict(return_cov=True)):
            want = jm.predict(XNEW, order=2, **kw)
            got = tm.predict(t(XNEW), order=2, **kw)
            for g, w in pairs(got, want):
                close(g, w)
        _, cov = tm.predict(t(XNEW), order=2, return_cov=True)
        assert torch.equal(cov, tm.underlying_properties(
            t(XNEW), 2, return_cov=True)[1])


def test_errors_and_derivatives_not_ported():
    """JAX's errors (a 1-D y, an unknown kind, an order not fitted, dderivs
    without dX), and the derivative arguments, now ported: with this
    file's WhiteKernel term a derivative prediction is refused as in JAX,
    a slope constraint is kept, and all-zero orders are the plain path
    (their values are held to JAX in ``test_torch_models_derivs.py``)."""
    jm, tm = at_theta('TruncationGP', 0.1)
    for model, conv in ((jm, np.asarray), (tm, t)):
        with pytest.raises(ValueError, match='y must be 2d'):
            model.fit(conv(X), conv(Y[:, 0]), orders=ORDERS[:1])
        with pytest.raises(ValueError, match='dderivs requires'):
            model.fit(conv(X), conv(Y), orders=ORDERS, dderivs=[[0]])
        model.fit(conv(X), conv(Y), orders=ORDERS)
        with pytest.raises(ValueError, match='kind must be one of'):
            model.predict(conv(XNEW), order=3, kind='all')
        with pytest.raises(ValueError, match='order must be in orders'):
            model.predict(conv(XNEW), order=7)
    tm.fit(t(X), t(Y), orders=ORDERS, dX=t(DX), dy=t(DY),
           dderivs=[[1], [0]])
    np.testing.assert_array_equal(tm.dderivs_, [[1], [0]])
    tm.fit(t(X), t(Y), orders=ORDERS, dX=t(DX), dy=t(DY),
           dderivs=[[0], [0]])
    assert tm.dderivs_ is None
    for model, conv in ((jm, np.asarray), (tm, t)):
        with pytest.raises(ValueError, match='incompatible with WhiteKernel'):
            model.predict(conv(XNEW), order=3, dorders=np.ones((7, 1), int))


def test_to_torch_model_carries_the_settings_and_the_fitted_kernel(fitted):
    """A fitted JAX truncation model becomes an unfitted port model with its
    fitted kernel and no optimizer, whose fit on the same data reproduces
    the fitted state at 1e-10; an unfitted one keeps its free kernel and
    optimizer; a user callable must be given its torch twin."""
    for name, jm in fitted.items():
        tm = to_torch_model(jm, 'cpu')
        assert type(tm).__name__ == name and not tm._fit
        cp = tm.coeffs_process
        assert cp.optimizer is None and cp.device == torch.device('cpu')
        np.testing.assert_array_equal(cp.kernel.theta,
                                      jm.coeffs_process.kernel_.theta)
        assert tm.excluded is None and tm.ratio_kws == {}
        close(tm.ratio(t(X)), np.full(N, RATIO))
        close(tm.ref(t(X)), np.full(N, REF))
        tm.fit(t(X), t(Y), orders=ORDERS)
        for attr in ('center_', 'disp_', 'scale_', 'cov_factor_'):
            close(getattr(cp, attr), getattr(jm.coeffs_process, attr))
    unfitted = to_torch_model(models('TruncationTP')[0], 'cpu')
    assert unfitted.coeffs_process.optimizer == 'fmin_l_bfgs_b'
    assert unfitted.coeffs_process.disp0.item() == 1
    jm = gm.TruncationGP(jax_kernel(), ratio=ratio_jax)
    with pytest.raises(ValueError, match='ratio'):
        to_torch_model(jm, 'cpu')
    cgp = to_torch_model(gm.ConjugateGaussianProcess(jax_kernel(), sd=2.0),
                         'cpu')
    assert isinstance(cgp, gt.ConjugateGaussianProcess)
    assert cgp.df0 == np.inf and cgp.scale0 == 2.0
    with pytest.raises(TypeError, match='no model'):
        to_torch_model(object(), 'cpu')
