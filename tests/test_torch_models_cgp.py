"""The port's conjugate GP (``gsum_tpu_torch.models.ConjugateGaussianProcess``)
and flagship step (``gsum_tpu_torch.entry.flagship_step``) against their
``gsum_tpu`` twins on the same seeded inputs, f64 on the CPU.

At one θ, values agree to 1e-10 (lml, predictions, fitted state) and
gradients to 1e-10 (autograd against ``jax.grad``).  Fits run scipy's
L-BFGS-B on both sides, on objectives that differ by round-off, so the
fitted θ agree to optimizer noise (atol 1e-5, as ``__graft_entry__.py``
compares two fits) and each side's reported lml is held against the other
side's lml at the same θ.  Fit-parity kernels have an interior optimum
(RBF + free White): a free ``ConstantKernel`` amplitude is degenerate with
the conjugate scale and runs to its bound.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import gsum_tpu as gm
import gsum_tpu_torch as gt
from gsum_tpu_torch.convert import to_torch_kernel

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from __graft_entry__ import entry  # noqa: E402

RTOL = 1e-10
N = 20
rng = np.random.RandomState(0)
X = np.sort(rng.rand(N))[:, None]
Y = np.stack([np.sin(3 * X[:, 0] + k) for k in range(3)], axis=1) \
    + 0.01 * rng.randn(N, 3)
XNEW = np.linspace(0.02, 0.98, 7)[:, None]
THETA = np.log([0.25, 1e-3])


def jax_kernel():
    return gm.RBF(0.3, (1e-2, 10)) + gm.WhiteKernel(1e-4, (1e-8, 1e-1))


def _basis2_jax(x):
    return jax.numpy.stack([jax.numpy.ones(x.shape[0]), x[:, 0]], axis=1)


def _basis2_torch(x):
    return torch.stack([torch.ones_like(x[:, 0]), x[:, 0]], dim=1)


CONFIGS = {
    'V0=0': dict(center=0, disp=0, df=3, scale=1),
    'V0!=0 two-column basis': dict(center=[0.1, -0.2],
                                   disp=np.diag([1.0, 2.0]), df=3, scale=1.5,
                                   basis=True),
    'sd (df0=inf)': dict(center=0.3, disp=0, sd=1.5),
    'eig': dict(center=0, disp=0.5, df=3, scale=1, decomposition='eig'),
    'chol_engine=xla': dict(center=0, disp=0, df=3, scale=1,
                            chol_engine='xla'),
    'chol_engine=blocked': dict(center=0, disp=0, df=3, scale=1,
                                chol_engine='blocked'),
}


def models(config, **extra):
    """The JAX model and the port's (on the CPU) with the same settings."""
    kw = dict(CONFIGS[config], **extra)
    basis = kw.pop('basis', False)
    jm = gm.ConjugateGaussianProcess(
        kernel=jax_kernel(), basis=_basis2_jax if basis else None, **kw)
    tm = gt.ConjugateGaussianProcess(
        kernel=to_torch_kernel(jax_kernel()),
        basis=_basis2_torch if basis else None, device='cpu', **kw)
    return jm, tm


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=RTOL):
    """Element-wise rtol, with an absolute floor at rtol times the largest
    entry (entries near zero carry the round-off of the largest)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize('config', list(CONFIGS))
def test_lml_and_gradient_match_jax(config):
    """lml at 1e-10 everywhere; the autograd gradient against ``jax.grad``
    at 1e-10 for the Cholesky decomposition.  For 'eig' the gradient is held
    against the port's own Cholesky gradient and a central difference:
    JAX's gradient through ``eigh`` at this θ (clustered eigenvalues of a
    smooth kernel) disagrees with its own finite difference by 8%."""
    jm, tm = models(config)
    lml_j, grad_j = jm.log_marginal_likelihood(THETA, eval_gradient=True,
                                               X=X, y=Y)
    lml, grad = tm.log_marginal_likelihood(THETA, eval_gradient=True,
                                           X=_t(X), y=_t(Y))
    _close(lml, lml_j)
    if CONFIGS[config].get('decomposition') != 'eig':
        _close(grad, grad_j)
        return
    _, chol = models('eig', decomposition='cholesky')
    _, grad_chol = chol.log_marginal_likelihood(THETA, True, X=_t(X), y=_t(Y))
    _close(grad, grad_chol, rtol=1e-10)
    h = 1e-6
    fd = [(tm.log_marginal_likelihood(THETA + h * e, X=_t(X), y=_t(Y))
           - tm.log_marginal_likelihood(THETA - h * e, X=_t(X), y=_t(Y)))
          / (2 * h) for e in np.eye(2)]
    np.testing.assert_allclose(grad.numpy(), fd, rtol=1e-6)


@pytest.mark.parametrize('restarts', [0, 2])
def test_fit_matches_jax(restarts):
    """θ at atol 1e-5 (optimizer noise); each side's reported lml against
    the other side's lml at the same θ at 1e-10; ``n_restarts_optimizer=2``
    draws its starts from ``random_state=0`` on both sides."""
    jm, tm = models('V0=0', n_restarts_optimizer=restarts, random_state=0)
    jm.fit(X, Y)
    tm.fit(_t(X), _t(Y))
    np.testing.assert_allclose(tm.kernel_.theta, jm.kernel_.theta, atol=1e-5)
    np.testing.assert_allclose(
        tm.log_marginal_likelihood_value_,
        float(jm.log_marginal_likelihood(tm.kernel_.theta)), rtol=RTOL)
    np.testing.assert_allclose(
        float(tm.log_marginal_likelihood(jm.kernel_.theta)),
        jm.log_marginal_likelihood_value_, rtol=RTOL)
    lo, hi = tm.kernel_.bounds.T
    assert np.all((lo < tm.kernel_.theta) & (tm.kernel_.theta < hi))


@pytest.mark.parametrize('config', list(CONFIGS))
def test_fitted_state_and_predict_match_jax(config):
    """At one θ (``optimizer=None``): the fitted state, and predict's cov;
    for three of the configurations also the mean alone, std, cov with
    ``pred_noise``, and the ``Xc`` / ``y`` override."""
    jm, tm = models(config, optimizer=None)
    jm.fit(X, Y)
    tm.fit(_t(X), _t(Y))
    for name in ('center_', 'disp_', 'scale_', 'cov_factor_', 'corr_'):
        _close(getattr(tm, name), getattr(jm, name))
    assert tm.df_ == jm.df_
    _close(tm.log_marginal_likelihood_value_, jm.log_marginal_likelihood_value_)
    variants = [dict(return_cov=True)]
    if config in ('V0=0', 'V0!=0 two-column basis', 'eig'):
        variants += [dict(), dict(return_std=True),
                     dict(return_cov=True, pred_noise=True),
                     dict(return_std=True, Xc=X[::2], y=Y[::2, :2])]
    for kw in variants:
        want = jm.predict(XNEW, **kw)
        got = tm.predict(_t(XNEW), **{k: _t(v) if k in ('Xc', 'y') else v
                                      for k, v in kw.items()})
        for g, w in zip(*((got, want) if isinstance(want, tuple)
                          else ((got,), (want,)))):
            _close(g, w)


def test_accessors_prior_and_likelihood_match_jax():
    """Before fit: mean / cov / predict give the prior; after (at one θ):
    center(), disp(), scale(), likelihood(log=False) and
    underlying_properties."""
    jm, tm = models('V0!=0 two-column basis', optimizer=None)
    _close(tm.predict(_t(XNEW), return_cov=True)[1],
           jm.predict(XNEW, return_cov=True)[1])
    _close(tm.mean(_t(XNEW)), jm.mean(XNEW))
    jm.fit(X, Y)
    tm.fit(_t(X), _t(Y))
    for name in ('center', 'disp', 'scale'):
        _close(getattr(tm, name)(), getattr(jm, name)())
    _close(tm.likelihood(log=False, theta=THETA),
           jm.likelihood(log=False, theta=THETA))
    for g, w in zip(tm.underlying_properties(_t(XNEW), return_std=True),
                    jm.underlying_properties(XNEW, return_std=True)):
        _close(g, w)


def test_non_spd_theta_gives_minus_inf_with_a_finite_gradient():
    """A θ whose correlation matrix is not positive definite (a negative
    nugget) gives lml = −inf and a finite (zero) gradient, as in JAX."""
    kj = gm.RBF(0.3, (1e-3, 10))
    jm = gm.ConjugateGaussianProcess(kernel=kj, nugget=-0.5, df=3)
    tm = gt.ConjugateGaussianProcess(kernel=to_torch_kernel(kj), nugget=-0.5,
                                     df=3, device='cpu')
    lml_j, grad_j = jm.log_marginal_likelihood(np.log([0.3]), True, X=X, y=Y)
    lml, grad = tm.log_marginal_likelihood(np.log([0.3]), True, X=_t(X),
                                           y=_t(Y))
    assert float(lml_j) == float(lml) == -np.inf
    assert torch.isfinite(grad).all()
    np.testing.assert_array_equal(grad.numpy(), np.asarray(grad_j))


def test_f32_input_is_promoted_to_f64():
    """An f32 X gives f64 results equal to JAX's, whose x64 promotion casts
    it against the f64 θ (torch alone would keep f32 against a 0-d f64
    operand).  f32 data are cast to f64 on entry, so an f32 y gives exactly
    the f64 results of its rounded values (JAX keeps some of y's sums in
    f32 and differs from both by f32 round-off)."""
    X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
    jm, tm = models('V0=0', optimizer=None)
    jm.fit(X32, Y)
    tm.fit(_t(X32), _t(Y))
    lml, grad = tm.log_marginal_likelihood(THETA, True)
    assert lml.dtype == grad.dtype == torch.float64
    _close(lml, jm.log_marginal_likelihood(THETA))
    m, s = tm.predict(_t(XNEW.astype(np.float32)), return_std=True)
    assert m.dtype == s.dtype == torch.float64
    m_j, s_j = jm.predict(XNEW.astype(np.float32), return_std=True)
    _close(m, m_j)
    _close(s, s_j)

    tm.fit(_t(X32), _t(Y32))
    _, t64 = models('V0=0', optimizer=None)
    t64.fit(_t(X32.astype(np.float64)), _t(Y32.astype(np.float64)))
    assert tm.y_train_.dtype == torch.float64
    for a, b in zip(tm.log_marginal_likelihood(THETA, True),
                    t64.log_marginal_likelihood(THETA, True)):
        assert torch.equal(a, b)


def test_sample_y_shape_reproducibility_and_moments():
    """Draws differ from JAX's at equal seeds (another generator), so the
    test holds shapes, reproducibility and moments: 4000 draws' mean within
    5 standard errors of the predictive mean, their covariance within 0.1
    of the predictive covariance's scale."""
    _, tm = models('V0=0', optimizer=None)
    tm.fit(_t(X), _t(Y[:, 0]))
    xs = _t(XNEW)
    draws = tm.sample_y(xs, n_samples=4000, random_state=3)
    assert draws.shape == (7, 4000)
    assert torch.equal(draws, tm.sample_y(xs, n_samples=4000, random_state=3))
    assert not torch.equal(draws, tm.sample_y(xs, n_samples=4000,
                                              random_state=4))
    mean, cov = tm.predict(xs, return_cov=True)
    se = torch.sqrt(torch.diag(cov) / 4000)
    assert torch.all((draws.mean(1) - mean).abs() <= 5 * se + 1e-12)
    assert (torch.cov(draws) - cov).abs().max() <= 0.1 * cov.abs().max()
    tm.fit(_t(X), _t(Y))
    assert tm.sample_y(xs, n_samples=5).shape == (7, 3, 5)
    assert tm.sample_y(xs, n_samples=5, underlying=True).shape == (7, 5)


def test_derivative_observations_are_not_ported_yet():
    """Derivative observations are ported (``tests/test_torch_models_derivs.py``);
    with this file's kernel, which has a WhiteKernel term, both packages
    refuse them with the same error, and all-zero orders are the plain
    path."""
    jm, tm = models('V0=0', optimizer=None)
    for model, conv in ((jm, np.asarray), (tm, _t)):
        with pytest.raises(ValueError, match='incompatible with WhiteKernel'):
            model.fit(conv(X), conv(Y), dorders=np.ones((N, 1), int))
        model.fit(conv(X), conv(Y), dorders=np.zeros((N, 1), int))
        assert model.dorders_ is None
        with pytest.raises(ValueError, match='incompatible with WhiteKernel'):
            model.predict(conv(XNEW), dorders=np.ones((7, 1), int))


def test_default_device_cuda_raises_without_a_card():
    """The models' default device is the CUDA card; where none is visible
    the constructor raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    with pytest.raises(RuntimeError, match='is_available'):
        gt.ConjugateGaussianProcess(kernel=gt.RBF(0.3))
    with pytest.raises(RuntimeError, match='is_available'):
        gt.entry.flagship_step('cuda')


def test_flagship_step_matches_jax():
    """``flagship_step`` at ``__graft_entry__.entry()``'s inputs: m_pred and
    lml at 1e-10; K_pred, a difference of two terms of the prior
    covariance's size, at 1e-10 of that size (its entries are 7e-4 of it, so
    the element-wise round-off of the subtraction is larger than 1e-10 of
    K_pred itself); the lml's autograd gradient against ``jax.grad`` at
    1e-8."""
    fn, args = entry()
    args_np = [np.array(a) for a in args]
    m_j, K_j, lml_j = jax.jit(fn)(*args)
    step, kernel = gt.entry.flagship_step('cpu')
    np.testing.assert_array_equal(kernel.theta, args_np[0])
    m, K, lml = step(*args_np)
    _close(m, m_j)
    _close(lml, lml_j)
    far = step(args_np[0], args_np[1], args_np[2], args_np[3] + 1e3)[1]
    prior_scale = far.abs().max().item()
    np.testing.assert_allclose(K.numpy(), np.asarray(K_j), rtol=0,
                               atol=RTOL * prior_scale)

    g_j = jax.jit(jax.grad(lambda t: fn(t, *args[1:])[2]))(args[0])
    theta = _t(args_np[0]).requires_grad_(True)
    (g,) = torch.autograd.grad(step(theta, *args_np[1:])[2], theta)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-8)
