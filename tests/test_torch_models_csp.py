"""The port's Student-t process (``gsum_tpu_torch.models.
ConjugateStudentProcess``) against its ``gsum_tpu`` twin on the same seeded
inputs, f64 on the CPU; the port's models are built from the JAX ones by
``convert.to_torch_model``.

At one θ, the lml agrees to 1e-10 and its autograd gradient to ``jax.grad``
at 1e-10; predictions and the fitted state to 1e-10 (relative, with an
absolute floor at 1e-10 of the largest entry).  Fits run scipy's L-BFGS-B
on objectives that differ by round-off, so the fitted θ agree to optimizer
noise (atol 1e-5).  Two behaviours of the JAX package are mirrored and
pinned: before ``fit`` ``predict`` counts the prior dispersion twice, and
with ``sd=`` (ν₀ = ∞) the lml is NaN while its gradient is finite.
"""
import jax
import numpy as np
import pytest
import torch

import gsum_tpu as gm
from gsum_tpu_torch.convert import to_torch_model
from _port import one_intra_op_thread  # noqa: F401 (autouse)

RTOL = 1e-10
N = 20
rng = np.random.RandomState(0)
X = np.sort(rng.rand(N))[:, None]
Y = np.stack([np.sin(3 * X[:, 0] + k) for k in range(3)], axis=1) \
    + 0.01 * rng.randn(N, 3)
XNEW = np.linspace(0.02, 0.98, 7)[:, None]
THETA = np.log([0.25, 1e-3])
# JAX's gradient through eigh is wrong where a smooth kernel's eigenvalues
# cluster (ROADMAP §C); at ℓ = 0.05 they are spread
THETA_EIG = np.log([0.05, 1e-3])


def jax_kernel():
    return gm.RBF(0.3, (1e-2, 10)) + gm.WhiteKernel(1e-4, (1e-8, 1e-1))


def _basis2_jax(x):
    return jax.numpy.stack([jax.numpy.ones(x.shape[0]), x[:, 0]], axis=1)


def _basis2_torch(x):
    return torch.stack([torch.ones_like(x[:, 0]), x[:, 0]], dim=1)


CONFIGS = {
    'V0=0': dict(center=0, disp=0, df=3, scale=1),
    'V0!=0 two-column basis': dict(center=[0.1, -0.2],
                                   disp=np.diag([1.0, 2.0]), df=4, scale=1.5,
                                   basis=True),
    'eig': dict(center=0, disp=0.5, df=3, scale=1, decomposition='eig'),
}


def models(config, **extra):
    """The JAX model and its twin in the port (on the CPU)."""
    kw = dict(CONFIGS[config], **extra)
    basis = kw.pop('basis', False)
    jm = gm.ConjugateStudentProcess(
        kernel=jax_kernel(), basis=_basis2_jax if basis else None, **kw)
    tm = to_torch_model(jm, 'cpu',
                        **({'basis': _basis2_torch} if basis else {}))
    return jm, tm


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize('config', list(CONFIGS))
def test_lml_and_gradient_match_jax(config):
    jm, tm = models(config)
    theta = THETA_EIG if config == 'eig' else THETA
    lml_j, grad_j = jm.log_marginal_likelihood(theta, eval_gradient=True,
                                               X=X, y=Y)
    lml, grad = tm.log_marginal_likelihood(theta, eval_gradient=True,
                                           X=_t(X), y=_t(Y))
    _close(lml, lml_j)
    _close(grad, grad_j)
    _close(tm.log_marginal_likelihood(theta, X=_t(X), y=_t(Y[:, 0])),
           jm.log_marginal_likelihood(theta, X=X, y=Y[:, 0]))


def test_lml_with_sd_is_nan_with_a_finite_gradient():
    """ν₀ = ∞ (``sd=``): the normalizer is gammaln(∞) − ∞·log(∞) = NaN on
    both sides; the gradient, which only the logdet term reaches, is finite
    and agrees at 1e-10."""
    jm = gm.ConjugateStudentProcess(jax_kernel(), center=0.3, sd=1.5)
    tm = to_torch_model(jm, 'cpu')
    lml_j, grad_j = jm.log_marginal_likelihood(THETA, True, X=X, y=Y)
    lml, grad = tm.log_marginal_likelihood(THETA, True, X=_t(X), y=_t(Y))
    assert np.isnan(float(lml_j)) and torch.isnan(lml)
    assert torch.isfinite(grad).all()
    _close(grad, grad_j)


def test_fit_matches_jax():
    """θ at atol 1e-5 (optimizer noise); each side's reported lml against
    the other side's lml at the same θ at 1e-10."""
    jm, tm = models('V0!=0 two-column basis')
    jm.fit(X, Y)
    tm.fit(_t(X), _t(Y))
    np.testing.assert_allclose(tm.kernel_.theta, jm.kernel_.theta, atol=1e-5)
    np.testing.assert_allclose(
        tm.log_marginal_likelihood_value_,
        float(jm.log_marginal_likelihood(tm.kernel_.theta)), rtol=RTOL)
    np.testing.assert_allclose(
        float(tm.log_marginal_likelihood(jm.kernel_.theta)),
        jm.log_marginal_likelihood_value_, rtol=RTOL)


PREDICT_VARIANTS = [dict(), dict(return_std=True), dict(return_cov=True),
                    dict(return_cov=True, pred_noise=True),
                    dict(return_cov=True, y=Y[:, :2]),
                    dict(return_std=True, Xc=X[::2], y=Y[::2, 0]),
                    dict(return_cov=True, Xc=X[1::3], y=Y[1::3])]


@pytest.mark.parametrize('config', list(CONFIGS))
def test_fitted_state_and_predict_match_jax(config):
    """At one θ (``optimizer=None``): the fitted state, the covariance, and
    predict on the training set and with the ``Xc`` / ``y`` overrides (the
    port adds the mean-uncertainty term on every fitted path; JAX's eager
    branch adds it for the overrides)."""
    theta = THETA_EIG if config == 'eig' else THETA
    jm, tm = models(config, optimizer=None)
    jm.kernel = jm.kernel.clone_with_theta(theta)
    tm.kernel = tm.kernel.clone_with_theta(theta)
    jm.fit(X, Y)
    tm.fit(_t(X), _t(Y))
    for name in ('center_', 'disp_', 'scale_', 'cov_factor_', 'corr_'):
        _close(getattr(tm, name), getattr(jm, name))
    assert tm.df_ == jm.df_
    _close(tm.log_marginal_likelihood_value_, jm.log_marginal_likelihood_value_)
    _close(tm.cov(_t(XNEW)), jm.cov(XNEW))
    _close(tm.cov(_t(XNEW), _t(X[:5])), jm.cov(XNEW, X[:5]))
    for kw in PREDICT_VARIANTS:
        want = jm.predict(XNEW, **kw)
        got = tm.predict(_t(XNEW), **{k: _t(v) if k in ('Xc', 'y') else v
                                      for k, v in kw.items()})
        for g, w in zip(*((got, want) if isinstance(want, tuple)
                          else ((got,), (want,)))):
            _close(g, w)


def test_unfitted_predict_counts_the_prior_dispersion_twice():
    """Before ``fit``, ``cov`` already holds var·B V₀ Bᵀ and ``predict`` adds
    it again, as the JAX package does: at disp=2, df=5, scale=1, five
    points, RBF(0.3), the predicted covariance exceeds cov(X) by exactly
    var·disp = 5/3·2 = 3.3333 on the diagonal, on both sides; the std adds
    its square root; the mean alone is the prior mean."""
    jm = gm.ConjugateStudentProcess(gm.RBF(0.3), center=0.5, disp=2, df=5,
                                    scale=1)
    tm = to_torch_model(jm, 'cpu')
    Xs = np.linspace(0, 1, 5)[:, None]
    offset = 5 / 3 * 2
    for model, x in ((jm, Xs), (tm, _t(Xs))):
        _, cov = model.predict(x, return_cov=True)
        np.testing.assert_allclose(np.diag(np.asarray(cov) - np.asarray(
            model.cov(x))), offset, rtol=1e-14)
    for kw in (dict(), dict(return_std=True), dict(return_cov=True)):
        want = jm.predict(Xs, **kw)
        got = tm.predict(_t(Xs), **kw)
        for g, w in zip(*((got, want) if isinstance(want, tuple)
                          else ((got,), (want,)))):
            _close(g, w)
    _, std = tm.predict(_t(Xs), return_std=True)
    np.testing.assert_allclose(
        std.numpy(), np.sqrt(np.diag(tm.cov(_t(Xs)).numpy()))
        + np.sqrt(offset), rtol=1e-14)


def test_cov_needs_df_above_two_and_derivatives_are_not_ported():
    jm = gm.ConjugateStudentProcess(jax_kernel(), df=2)
    tm = to_torch_model(jm, 'cpu')
    for model in (jm, tm):
        with pytest.raises(ValueError, match='df must be greater than 2'):
            model.cov(XNEW if model is jm else _t(XNEW))
    # derivative observations are ported (test_torch_models_derivs.py);
    # with this file's WhiteKernel term both packages refuse them alike
    jm, tm = models('V0=0', optimizer=None)
    for model, conv in ((jm, np.asarray), (tm, _t)):
        model.fit(conv(X), conv(Y))
        with pytest.raises(ValueError, match='incompatible with WhiteKernel'):
            model.predict(conv(XNEW), dorders=np.ones((7, 1), int))
        with pytest.raises(ValueError, match='incompatible with WhiteKernel'):
            model.fit(conv(X), conv(Y), dorders=np.ones((N, 1), int))
