"""Derivative observations in the port's Gaussian process against
``gsum_tpu``: ``fit(dorders=)`` / ``predict(dorders=)``, the lml with its θ
gradient and the MAP fit, f64 on the CPU (the Student-t process and the
truncation models' slope constraints are in
``tests/test_torch_student_derivs.py``, which imports this file's data).

Limits, each derived from the conditioning of the matrix the result is
solved with (``EPS`` = 2.2e-16):

- a fitted state, a prediction or an lml goes through one factorization
  of the (derivative) correlation matrix R, so it is held to
  ``10·cond(R)·EPS`` relative to its largest entry (at least 1e-12); the
  value of cond(R) is computed in each test from the port's matrix;
- the θ gradient of the lml is held to JAX's at the same limit, and to a
  central difference (step 1e-5) at 1e-6 relative: the difference's
  truncation error is O(h²·f''') ≈ 1e-10 of the gradient, and its round
  off cond(R)·EPS·|lml|/h, below 1e-6 at the cond(R) ≈ 1e3–1e5 here.

JAX's derivative predictions are jitted once per case (eager JAX compiles
each nested-gradient operation, about 10 s a prediction).
"""
import numpy as np
import pytest

import gsum_tpu as gm
import gsum_tpu_torch as gt
from _derivs import (DNEW, DORD, PRIORS, THETA, XNEW, X, Y, N, _kernel,
                     _close, _limit, _t, check_fit_state_and_lml,
                     check_predict_with_derivatives, fitted)
from _port import one_intra_op_thread  # noqa: F401 (autouse)


def test_fit_state_and_lml_match_jax():
    check_fit_state_and_lml('ConjugateGaussianProcess')


def test_lml_gradient_matches_jax_and_a_central_difference():
    """On the Gaussian process (the Student process's lml shares the
    derivative correlation builder)."""
    jm, tm = fitted('ConjugateGaussianProcess')
    th = THETA + np.array([0.1, -0.2])
    lj, gj = jm.log_marginal_likelihood(th, eval_gradient=True)
    lt, gt_ = tm.log_marginal_likelihood(th, eval_gradient=True)
    lim = _limit(tm.corr_)
    _close(lt, lj, lim)
    _close(gt_, gj, lim)
    h = 1e-5
    fd = [(float(tm.log_marginal_likelihood(th + h * e))
           - float(tm.log_marginal_likelihood(th - h * e))) / (2 * h)
          for e in np.eye(2)]
    _close(gt_, np.array(fd), 1e-6)
    # the lml at X (every row carries the fitted orders) is the same
    _close(tm.log_marginal_likelihood(th, X=_t(X), y=_t(Y)), lt, 1e-15)
    with pytest.raises(ValueError, match='fitted with derivative'):
        tm.log_marginal_likelihood(th, X=_t(X[:5]), y=_t(Y[:5]))


def test_predict_with_derivatives_matches_jax():
    check_predict_with_derivatives('ConjugateGaussianProcess')


def test_map_fit_with_derivatives_matches_jax():
    """The port's own L-BFGS-B fit with derivative data reaches JAX's θ:
    the same scipy optimizer on objectives equal to ~1e-13 follows the same
    iterates to its stopping rule (pgtol 1e-5), so θ agrees to 1e-6.  The
    JAX model of :func:`fitted` is reused (its compiled lml), then put
    back at its θ."""
    jm, _ = fitted('ConjugateGaussianProcess')
    jm.optimizer, jm.kernel = 'fmin_l_bfgs_b', _kernel(gm)
    try:
        jm.fit(X, Y, dorders=DORD)
        theta_jax = jm.kernel_.theta
    finally:
        jm.optimizer = None
        jm.kernel = _kernel(gm).clone_with_theta(THETA)
        jm.fit(X, Y, dorders=DORD)
    tm = gt.ConjugateGaussianProcess(_kernel(gt), nugget=1e-8, device='cpu',
                                     **PRIORS['ConjugateGaussianProcess'])
    tm.fit(_t(X), _t(Y), dorders=DORD)
    np.testing.assert_allclose(tm.kernel_.theta, theta_jax, rtol=0,
                               atol=1e-6)


def test_errors_match_jax():
    """Derivative predictions need a fitted model; a WhiteKernel term is
    refused; orders beyond the kernel's limit are refused; all-zero
    orders are the plain path."""
    white = gm.RBF(0.3) + gm.WhiteKernel(1e-4)
    for mod, conv in ((gm, np.asarray), (gt, _t)):
        kw = {} if mod is gm else {'device': 'cpu'}
        m = mod.ConjugateGaussianProcess(_kernel(mod), optimizer=None, **kw)
        with pytest.raises(ValueError, match='require a fitted model'):
            m.predict(conv(XNEW), dorders=DNEW)
        m.fit(conv(X), conv(Y), dorders=np.zeros((N, 1), int))
        assert m.dorders_ is None
        k = white if mod is gm else gt.convert.to_torch_kernel(white)
        with pytest.raises(ValueError, match='incompatible with WhiteKernel'):
            mod.ConjugateGaussianProcess(k, optimizer=None, **kw).fit(
                conv(X), conv(Y), dorders=DORD)
        mat = mod.Matern(0.3, nu=1.5)
        with pytest.raises(ValueError, match='only supports order'):
            mod.ConjugateGaussianProcess(mat, optimizer=None, **kw).fit(
                conv(X), conv(Y), dorders=DORD)
