"""Shared data and checks of the derivative-observation parity tests
(``test_torch_models_derivs.py``, ``test_torch_student_derivs.py``): the
seeded data with its derivative orders, the JAX models and their twins in
the port, and the checks both files run (limits as described there).
"""
import functools

import jax
import numpy as np
import torch

import gsum_tpu as gm
from gsum_tpu_torch.convert import to_torch_model

EPS = np.finfo(float).eps
N = 10
X = np.linspace(0.0, 1.0, N)[:, None]
Y = np.sin(3 * X[:, 0]) + 0.3 * X[:, 0]
DORD = np.array([0, 1, 0, 0, 1, 0, 2, 0, 0, 1])[:, None]
XNEW = np.linspace(0.05, 0.95, 4)[:, None]
DNEW = np.array([1, 0, 2, 1])[:, None]
THETA = np.log([1.3, 0.25])
PRIORS = {'ConjugateGaussianProcess': dict(center=0, disp=0, df=3, scale=1),
          'ConjugateStudentProcess': dict(center=0, disp=1, df=5, scale=1)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _limit(R):
    """10·cond(R)·EPS, at least 1e-12."""
    return max(1e-12, 10 * np.linalg.cond(_np(R)) * EPS)


def _kernel(mod):
    return mod.ConstantKernel(1.0, (1e-2, 1e2)) * mod.RBF(0.3, (1e-2, 10))


@functools.lru_cache(maxsize=None)
def fitted(name):
    """The JAX model fitted at θ with derivative observations, and its
    twin in the port fitted the same way; kept for the module, since each
    new JAX model compiles its lml and fitted state anew."""
    jm = getattr(gm, name)(_kernel(gm), nugget=1e-8, optimizer=None,
                           **PRIORS[name])
    jm.kernel = jm.kernel.clone_with_theta(THETA)
    jm.fit(X, Y, dorders=DORD)
    tm = to_torch_model(jm, 'cpu')
    np.testing.assert_array_equal(tm.dorders_, DORD)
    tm.fit(_t(X), _t(Y), dorders=tm.dorders_)
    return jm, tm


def check_fit_state_and_lml(name):
    jm, tm = fitted(name)
    lim = _limit(tm.corr_)
    for f in ('corr_', 'corr_L_', 'center_', 'disp_', 'scale_',
              'cov_factor_', 'basis_train_'):
        _close(getattr(tm, f), getattr(jm, f), lim)
    _close(tm.log_marginal_likelihood_value_,
           jm.log_marginal_likelihood_value_, lim)


def check_predict_with_derivatives(name):
    """The value process conditioned on derivative data, and the posterior
    of derivatives at new points: JAX's covariance for the Gaussian
    process, its std (with the mean-uncertainty term) for the Student
    process."""
    jm, tm = fitted(name)
    lim = _limit(tm.corr_)
    m, s = tm.predict(_t(XNEW), return_std=True)
    mj, sj = jm.predict(XNEW, return_std=True)
    _close(m, mj, lim)
    _close(s, sj, lim)
    gaussian = name == 'ConjugateGaussianProcess'
    kw = dict(return_cov=True) if gaussian else dict(return_std=True)
    mj, second_j = jax.jit(lambda Xn: jm.predict(Xn, dorders=DNEW, **kw))(
        XNEW)
    m, second = tm.predict(_t(XNEW), dorders=DNEW, **kw)
    _close(m, mj, lim)
    _close(second, second_j, lim)
    if gaussian:
        _, s = tm.predict(_t(XNEW), dorders=DNEW, return_std=True)
        _close(s, np.sqrt(np.diag(_np(second))), 1e-15)
