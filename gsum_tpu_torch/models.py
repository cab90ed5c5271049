R"""Conjugacy-based Gaussian- and Student-t-process models and the
truncation-error models (counterpart of ``gsum_tpu/models.py``).

``ConjugateGaussianProcess``, ``ConjugateStudentProcess``, their base class
``BaseConjugateProcess``, and ``TruncationGP`` / ``TruncationTP`` over them
(base class ``TruncationProcess``) keep the JAX package's public API
(constructor arguments, ``fit`` / ``predict`` / ``log_marginal_likelihood``
/ ``sample_y``, the trailing-underscore fitted attributes), with PyTorch
inside:

- The log-marginal likelihood is one plain function of the kernel's
  log-parameter tensor; its gradient comes from autograd.  PyTorch runs
  eagerly, so the JAX package's per-structure jit caches have no
  counterpart, and there is one body each for the lml, the fitted state
  and the prediction.
- A failed Cholesky gives NaN (``linalg.cholesky``), never an exception:
  the lml is ``where(ok, lml, -inf)``, computed on a sanitized
  re-factorization so that its gradient stays finite.
- The delta-mean (V₀ = 0) and known-scale (ν₀ = ∞) limits are resolved from
  the concrete prior values in Python.

Devices and dtypes: a model lives on ``device`` (the CUDA card unless
``device='cpu'`` is given); its data, whatever they come as, are moved
there and cast to the promoted dtype of themselves and float64, as JAX's
x64 promotion gives, so an f32 ``X`` gives f64 results.

``TruncationPointwise`` is the pointwise (uncorrelated) truncation model:
conjugate iid coefficients and a Student-t truncation error per point, on
``stats.t``; its ``credible_diagnostic`` draws reference bands from
``stats.beta`` (through ``helpers.hpd``) or ``stats.binom``.

Derivative observations (``fit(dorders=)``, ``predict(dorders=)``,
``TruncationProcess.fit(dderivs=)``) take their cross-covariances from
:mod:`gsum_tpu_torch.derivs`; x-dependent ``ratio`` / ``ref`` callables must
then be written in torch operations that ``torch.func`` transforms.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import conjugate as _conj
from ._config import as_input, device_constant, resolve_device, result_dtype
from .derivs import (_as_float, _check_kernel_orders, deriv_basis, deriv_cov,
                     deriv_mean, normalize_orders, wrap_value_fn_with_orders)
from .helpers import _generator, _on, coefficients, geometric_sum, hpd
from .kernels import RBF, ConstantKernel
from .linalg import (cholesky, eigh_sqrt, logdet_sqrt, robust_cho_solve,
                     robust_cholesky, solve_sqrt, spd_logdet)
from .ops.blockchol import batched_blocked_cholesky
from .optimize import ConvergenceWarning, scipy_lbfgsb

_LOG_2PI = math.log(2 * math.pi)

__all__ = ['BaseConjugateProcess', 'ConjugateGaussianProcess',
           'ConjugateStudentProcess', 'TruncationProcess', 'TruncationGP',
           'TruncationTP', 'TruncationPointwise', 'ConvergenceWarning']


def _default_basis(X):
    return torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)


def _normalize_predict_dorders_for(kernel, is_fit, X, dorders):
    """Validated (N, n_features) orders of the PREDICTION points, or None
    where they are absent or all zero (the plain value path)."""
    if dorders is None:
        return None
    d = normalize_orders(dorders, X.shape[0], X.shape[1])
    if not np.any(d):
        return None
    if not is_fit:
        raise ValueError(
            'derivative predictions (predict(dorders=)) require a fitted '
            'model')
    _check_kernel_orders(kernel, d)
    if _contains_white(kernel):
        raise ValueError(
            'derivative predictions are incompatible with WhiteKernel '
            'terms (a delta correlation has no derivatives) — drop the '
            'WhiteKernel and use the nugget parameter for uniform '
            'observation noise')
    return d


def _contains_white(kernel):
    """True if a WhiteKernel term appears anywhere in the composition: its
    two-argument form, from which derivative cross-covariances are built,
    is zero, so its noise would vanish from derivative data."""
    from . import kernels as _k

    if isinstance(kernel, _k.WhiteKernel):
        return True
    if isinstance(kernel, _k.KernelOperator):
        return _contains_white(kernel.k1) or _contains_white(kernel.k2)
    if isinstance(kernel, _k.Exponentiation):
        return _contains_white(kernel.kernel)
    return False


class BaseConjugateProcess:
    R"""Base class for the conjugate stochastic-process estimators.

    Parameters
    ----------
    kernel : Kernel, optional — defaults to ``1**2 * RBF(1.0)`` with fixed
        hyperparameters.
    center : float or array — prior mean-coefficient center η₀
    disp : float or array — prior dispersion V₀ (0 ⇒ mean known exactly)
    df : float — prior degrees of freedom ν₀ (∞ ⇒ scale known exactly)
    scale : float — prior scale τ₀
    sd : float, optional — shortcut for ν₀=∞, τ₀=sd
    basis : callable, optional — X ↦ (n, p) basis matrix for the mean
    nugget : float — diagonal jitter added to the correlation matrix
    optimizer : 'fmin_l_bfgs_b', callable, or None
    n_restarts_optimizer : int
    copy_X_train : bool
    random_state : int or None — seeds the optimizer restarts and
        ``sample_y``'s default generator
    decomposition : 'cholesky' or 'eig'
    chol_engine : 'auto', 'xla', or 'blocked' — Cholesky engine of the
        lml, fit and predict.  'xla' is ``torch.linalg.cholesky_ex``
        (the name is the JAX package's); 'blocked' is
        ``ops.batched_blocked_cholesky``; 'auto' picks between them (see
        ``_auto_chol``).
    device : where the model computes; the CUDA card by default.  It is
        refused where no card is visible (no CPU fallback).
    """

    def __init__(self, kernel=None, center=0, disp=0, df=1, scale=1, sd=None,
                 basis=None, nugget=1e-10, optimizer='fmin_l_bfgs_b',
                 n_restarts_optimizer=0, copy_X_train=True, random_state=None,
                 decomposition='cholesky', chol_engine='auto', device='cuda'):
        self.kernel = kernel

        self._center_0 = np.atleast_1d(center)
        self._disp_0 = np.atleast_2d(disp)
        if sd is not None:
            self._df_0 = np.inf
            self._scale_0 = sd
        else:
            self._df_0 = df
            self._scale_0 = scale

        self._fit = False
        self.X_train_ = None
        self.y_train_ = None
        self.dorders_ = None
        self.corr_L_ = self.corr_sqrt_ = None
        self.corr_ = None
        self.center_ = None
        self.disp_ = None
        self.df_ = None
        self.scale_ = None
        self.cov_factor_ = None
        self.cbar_sq_mean_ = None
        self.kernel_ = None
        self._eigh_tuple_ = None
        self.log_marginal_likelihood_value_ = None

        self.nugget = nugget
        self.copy_X_train = copy_X_train
        self.random_state = random_state
        self.n_restarts_optimizer = n_restarts_optimizer
        self.optimizer = optimizer
        self.decomposition = decomposition
        self.chol_engine = chol_engine
        _resolve_chol_fn(chol_engine)  # validate eagerly
        self.device = resolve_device(device)

        self._default_kernel = ConstantKernel(1.0, constant_value_bounds='fixed') * \
            RBF(1.0, length_scale_bounds='fixed')

        if basis is None:
            self.basis = _default_basis
        else:
            self.basis = basis
        self.basis_train_ = None

    # ------------------------------------------------------------------
    # Inputs
    # ------------------------------------------------------------------
    def _tensor(self, a):
        """``a`` on the model's device, in the promoted dtype of its own
        and float64."""
        t = as_input(a, device=self.device)
        return t.to(device=self.device, dtype=result_dtype(t.dtype))

    def _points(self, X):
        return torch.atleast_2d(self._tensor(X))

    def _basis(self, X):
        return self._tensor(self.basis(X))

    def _theta(self):
        return self._tensor(self.kernel_.theta)

    # ------------------------------------------------------------------
    # Prior accessors
    # ------------------------------------------------------------------
    @property
    def center0(self):
        return self._center_0

    @property
    def disp0(self):
        return self._disp_0

    @property
    def df0(self):
        return self._df_0

    @property
    def scale0(self):
        return self._scale_0

    # ------------------------------------------------------------------
    # Conjugate updates: thin wrappers over gsum_tpu_torch.conjugate
    # ------------------------------------------------------------------
    @classmethod
    def compute_center(cls, y, sqrt_R, basis, center0, disp0,
                       decomposition='cholesky'):
        return _conj.compute_center(y, sqrt_R, basis, center0, disp0,
                                    decomposition=decomposition)

    @classmethod
    def compute_disp(cls, y, sqrt_R, basis, disp0, decomposition='cholesky'):
        return _conj.compute_disp(y, sqrt_R, basis, disp0,
                                  decomposition=decomposition)

    @classmethod
    def compute_df(cls, y, df0):
        return _conj.compute_df(y, df0)

    @classmethod
    def compute_scale_sq(cls, y, sqrt_R, basis, center0, disp0, df0, scale0,
                         decomposition='cholesky'):
        return _conj.compute_scale_sq(y, sqrt_R, basis, center0, disp0, df0,
                                      scale0, decomposition=decomposition)

    @classmethod
    def compute_scale_sq_v2(cls, y, sqrt_R, basis, center0, disp0, df0,
                            scale0, decomposition='cholesky'):
        """Direct (non-Woodbury) form of the scale update, kept as a
        numerical cross-check."""
        return _conj.compute_scale_sq_v2(y, sqrt_R, basis, center0, disp0,
                                         df0, scale0,
                                         decomposition=decomposition)

    @staticmethod
    def solve_sqrt(sqrt_mat, y, decomposition):
        return solve_sqrt(sqrt_mat, y, decomposition)

    @staticmethod
    def compute_cov_factor(scale_sq, df):
        return _conj.compute_cov_factor(scale_sq, df)

    @staticmethod
    def num_y(y):
        return _conj.num_y(y)

    @staticmethod
    def avg_y(y):
        return _conj.avg_y(y)

    # ------------------------------------------------------------------
    # Posterior hyperparameter accessors
    # ------------------------------------------------------------------
    def _sqrt_R_train(self):
        if self.decomposition == 'cholesky':
            return self.corr_sqrt_
        elif self.decomposition == 'eig':
            return self._eigh_tuple_
        raise ValueError('decomposition must be either "cholesky" or "eig"')

    def center(self):
        return self.compute_center(
            y=self.y_train_, sqrt_R=self._sqrt_R_train(), basis=self.basis_train_,
            center0=self.center0, disp0=self.disp0, decomposition=self.decomposition)

    def disp(self):
        return self.compute_disp(
            y=self.y_train_, sqrt_R=self._sqrt_R_train(), basis=self.basis_train_,
            disp0=self.disp0, decomposition=self.decomposition)

    def df(self):
        return self.compute_df(y=self.y_train_, df0=self.df0)

    def scale(self):
        scale_sq = self.compute_scale_sq(
            y=self.y_train_, sqrt_R=self._sqrt_R_train(), basis=self.basis_train_,
            center0=self.center0, disp0=self.disp0, df0=self.df0,
            scale0=self.scale0, decomposition=self.decomposition)
        return torch.sqrt(scale_sq)

    # ------------------------------------------------------------------
    # Mean / covariance of the underlying process
    # ------------------------------------------------------------------
    def mean(self, X):
        """MAP mean of the process at X (not the interpolant — see predict)."""
        X = self._points(X)
        center = self.center_ if self._fit else self._tensor(
            np.atleast_1d(np.asarray(self.center0, dtype=float)))
        return self._basis(X) @ center

    def cov(self, X, Xp=None):
        X = self._points(X)
        if Xp is not None:
            Xp = self._points(Xp)
        if not self._fit:
            if self.df0 <= 2:
                raise ValueError('df must be greater than 2 for the covariance to exist')
            cov_factor = self.compute_cov_factor(scale_sq=self.scale0 ** 2, df=self.df0)
            kernel = self.kernel if self.kernel is not None else self._default_kernel
        else:
            cov_factor = self.cov_factor_
            kernel = self.kernel_
        # Xp deliberately not defaulted to X: WhiteKernel(X) and
        # WhiteKernel(X, X) differ
        return cov_factor * kernel(X, Xp)

    # ------------------------------------------------------------------
    # The log-marginal likelihood
    # ------------------------------------------------------------------
    def _kernel_for_lml(self):
        if self.kernel_ is not None:
            return self.kernel_
        if self.kernel is None:
            return self._default_kernel
        return self.kernel

    # ------------------------------------------------------------------
    # Derivative training data (gsum_tpu_torch.derivs)
    # ------------------------------------------------------------------
    def _wrap_corr_fn(self, value_fn):
        """The correlation builder of the lml, the fitted state and the
        prediction: the kernel's ``value_fn``, or its order-aware wrapper
        when the training rows are derivative observations."""
        if self.dorders_ is None:
            return value_fn
        return wrap_value_fn_with_orders(value_fn, np.asarray(self.dorders_))

    def _deriv_cross_corr(self, Xa, da, Xb=None, db=None):
        """Correlation blocks between rows carrying derivative orders, at
        the fitted hyperparameters.  ``da`` / ``db`` of None mean value
        rows; ``Xb`` of None means the (Xa, da) self-block."""
        kernel = self.kernel_
        theta = self._theta()

        def cov_fn(x, xp):
            return kernel.value_fn(theta, x[None, :], xp[None, :])[0, 0]

        def value_block(A, B):
            return kernel.value_fn(theta, A, B)

        Xa = _as_float(Xa)
        nf = Xa.shape[1]
        da = np.zeros((Xa.shape[0], nf), int) if da is None else np.asarray(da)
        if Xb is None:
            return deriv_cov(cov_fn, Xa, da, value_block_fn=value_block)
        Xb = _as_float(Xb)
        db = np.zeros((Xb.shape[0], nf), int) if db is None else np.asarray(db)
        return deriv_cov(cov_fn, Xa, da, Xb, db, value_block_fn=value_block)

    def _derivatized_basis(self, X, d):
        """The mean basis with row i differentiated to orders ``d[i]``,
        consistent with the derivative correlation blocks."""
        return deriv_basis(lambda x: self._basis(x[None, :])[0],
                           _as_float(X), np.asarray(d))

    def _derivatized_basis_train(self, X):
        return self._derivatized_basis(X, np.asarray(self.dorders_))

    def _normalize_predict_dorders(self, X, dorders):
        return _normalize_predict_dorders_for(self.kernel_, self._fit, X,
                                              dorders)

    def _lml(self, kernel, theta, X, y2, basis):
        """The log-marginal likelihood at ``theta`` (a tensor), as a
        differentiable 0-d tensor; each model class writes its own.  With
        derivative training data the rows of ``X`` carry ``dorders_``."""
        raise NotImplementedError

    def _lml_and_grad(self, kernel, theta, X, y2, basis, eval_gradient):
        """The lml at ``theta``, and with ``eval_gradient`` its autograd
        gradient in θ; both detached."""
        if not eval_gradient:
            with torch.no_grad():
                return self._lml(kernel, theta, X, y2, basis)
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            lml = self._lml(kernel, theta, X, y2, basis)
            (grad,) = torch.autograd.grad(lml, theta, allow_unused=True)
        if grad is None:            # no free hyperparameter reaches the lml
            grad = torch.zeros_like(theta)
        return lml.detach(), grad

    def log_marginal_likelihood(self, theta=None, eval_gradient=False, X=None, y=None):
        """Log-marginal likelihood of theta for the training data (or for
        ``X`` / ``y``); with ``eval_gradient``, ``(lml, dlml/dθ)``."""
        if theta is None:
            if self._fit:
                if eval_gradient:
                    raise ValueError('Gradient can only be evaluated for theta!=None')
                return self.log_marginal_likelihood_value_
            theta = self._kernel_for_lml().theta

        kernel = self._kernel_for_lml()
        X_is_train = X is None
        X = self._points(self.X_train_ if X is None else X)
        y = self._tensor(self.y_train_ if y is None else y)
        y2 = y[:, None] if y.ndim == 1 else y
        if self.dorders_ is None:
            basis = self._basis(X)
        elif X_is_train:
            basis = self.basis_train_      # derivatized by fit
        else:
            # every row of X carries the fitted orders, so X must match
            # them row for row and its basis is derivatized the same way
            if X.shape[0] != np.asarray(self.dorders_).shape[0]:
                raise ValueError(
                    'this model was fitted with derivative observation '
                    'orders for %d rows; log_marginal_likelihood(X=...) '
                    'got %d rows' % (np.asarray(self.dorders_).shape[0],
                                     X.shape[0]))
            basis = self._derivatized_basis_train(X)
        return self._lml_and_grad(kernel, self._tensor(theta), X, y2,
                                  basis, eval_gradient)

    # ------------------------------------------------------------------
    # Kernel calibration
    # ------------------------------------------------------------------
    def _constrained_optimization(self, obj_func, initial_theta, bounds):
        if self.optimizer == 'fmin_l_bfgs_b':
            return scipy_lbfgsb(obj_func, initial_theta, bounds)
        elif callable(self.optimizer):
            return self.optimizer(obj_func, initial_theta, bounds=bounds)
        raise ValueError('Unknown optimizer %s.' % self.optimizer)

    def _calibrate_kernel(self):
        if self.optimizer is not None and self.kernel_.n_dims > 0:
            kernel = self.kernel_.clone()
            X, basis = self.X_train_, self.basis_train_
            y2 = self.y_train_[:, None] if self.y_train_.ndim == 1 else self.y_train_

            def obj_func(theta, eval_gradient=True):
                theta = self._tensor(theta)
                if eval_gradient:
                    lml, grad = self._lml_and_grad(kernel, theta, X, y2, basis,
                                                   True)
                    # one device-to-host copy per evaluation
                    out = torch.cat([lml[None], grad]).cpu().numpy()
                    return -out[0], -out[1:]
                return -self._lml_and_grad(kernel, theta, X, y2, basis,
                                           False).item()

            optima = [self._constrained_optimization(
                obj_func, self.kernel_.theta, self.kernel_.bounds)]

            if self.n_restarts_optimizer > 0:
                if not np.isfinite(self.kernel_.bounds).all():
                    raise ValueError(
                        'Multiple optimizer restarts (n_restarts_optimizer>0) '
                        'requires that all bounds are finite.')
                bounds = self.kernel_.bounds
                rng = np.random.RandomState(
                    self.random_state if isinstance(self.random_state, (int, np.integer))
                    else None)
                for _ in range(self.n_restarts_optimizer):
                    theta_initial = rng.uniform(bounds[:, 0], bounds[:, 1])
                    optima.append(self._constrained_optimization(
                        obj_func, theta_initial, bounds))

            lml_values = [opt[1] for opt in optima]
            best = int(np.argmin(lml_values))
            self.kernel_.theta = optima[best][0]
            self.log_marginal_likelihood_value_ = -np.min(lml_values)
        else:
            self.log_marginal_likelihood_value_ = self.log_marginal_likelihood(
                self.kernel_.theta)

    # ------------------------------------------------------------------
    # Fit
    # ------------------------------------------------------------------
    def fit(self, X, y, dorders=None):
        R"""Fits the process to data (X, y) and updates all hyperparameters.

        ``dorders``: per-dimension derivative orders of each observation
        row — ``y[i]`` is then an observation of :math:`\partial^{dorders[i]}
        f` at ``X[i]``.  Differentiation is linear, so the joint vector of
        values and derivatives is Gaussian with the cross-covariances of
        :mod:`gsum_tpu_torch.derivs` as its correlation matrix and the
        derivatized basis as its basis, and the conjugate updates apply
        unchanged; predictions are of the value process.  Incompatible
        with ``WhiteKernel`` terms (use ``nugget`` for uniform noise).
        """
        if self.kernel is None:
            self.kernel_ = self._default_kernel.clone()
        else:
            self.kernel_ = self.kernel.clone()

        X = self._points(X)
        y = self._tensor(y)
        if dorders is not None:
            dorders = normalize_orders(dorders, X.shape[0], X.shape[1])
            if not np.any(dorders):
                dorders = None      # all values: the plain path
            else:
                _check_kernel_orders(self.kernel_, dorders)
                if _contains_white(self.kernel_):
                    raise ValueError(
                        'derivative training data is incompatible with '
                        'WhiteKernel terms (a delta correlation has no '
                        'derivative observations) — drop the WhiteKernel '
                        'and use the nugget parameter for uniform '
                        'observation noise')
        self.dorders_ = dorders
        if self.copy_X_train:
            self.X_train_ = X.clone()
            self.y_train_ = y.clone()
        else:
            self.X_train_ = X
            self.y_train_ = y
        if dorders is None:
            self.basis_train_ = self._basis(self.X_train_)
        else:
            self.basis_train_ = self._derivatized_basis_train(self.X_train_)

        self._calibrate_kernel()

        y2 = self.y_train_[:, None] if self.y_train_.ndim == 1 else self.y_train_
        with torch.no_grad():
            state = self._fit_state(self.kernel_, self._theta(), self.X_train_,
                                    y2, self.basis_train_)

        self.corr_ = state['corr']
        if self.decomposition == 'cholesky':
            self.corr_L_ = self.corr_sqrt_ = state['sqrt_R']
        else:
            self._eigh_tuple_ = state['sqrt_R']
            self.corr_L_ = self.corr_sqrt_ = state['corr_L']
        self.center_ = state['center']
        self.disp_ = state['disp']
        self.df_ = self.compute_df(y=self.y_train_, df0=self.df0)
        self.scale_ = state['scale']
        self.cov_factor_ = self.cbar_sq_mean_ = state['cov_factor']
        self._fit = True
        return self

    def _fit_state(self, kernel, theta, X, y2, basis):
        """The fitted posterior state at ``theta``."""
        decomposition = self.decomposition
        R = self._wrap_corr_fn(kernel.value_fn)(theta, X, None)
        N = X.shape[0]
        R_reg = R + self.nugget * torch.eye(N, dtype=R.dtype, device=R.device)
        if decomposition == 'cholesky':
            L = _resolve_chol_fn(self.chol_engine)(R_reg)
            sqrt_R, corr_L = L, L
        else:
            eig, Q = eigh_sqrt(R_reg)
            sqrt_R = (eig, Q)
            corr_L = Q @ torch.diag(torch.sqrt(eig))
        center = _conj.compute_center(
            y2, sqrt_R, basis, self.center0, self.disp0,
            decomposition=decomposition)
        disp = _conj.compute_disp(
            y2, sqrt_R, basis, self.disp0, decomposition=decomposition)
        df = _conj.compute_df(y2, self.df0)
        scale_sq = _conj.compute_scale_sq(
            y2, sqrt_R, basis, self.center0, self.disp0, self.df0, self.scale0,
            decomposition=decomposition)
        cov_factor = _conj.compute_cov_factor(scale_sq, df)
        return {'corr': R, 'sqrt_R': sqrt_R, 'corr_L': corr_L,
                'center': center, 'disp': disp,
                'scale': torch.sqrt(scale_sq), 'cov_factor': cov_factor}

    def underlying_properties(self, X, return_std=False, return_cov=False):
        y_mean = self.mean(X)
        if return_cov:
            return y_mean, self.cov(X)
        elif return_std:
            return y_mean, torch.sqrt(torch.diag(self.cov(X)))
        return y_mean

    # ------------------------------------------------------------------
    # Predict
    # ------------------------------------------------------------------
    def predict(self, X, return_std=False, return_cov=False, Xc=None, y=None,
                pred_noise=False, dorders=None):
        R"""GP-regression prediction at points X.

        ``Xc`` / ``y`` override the conditioning set without affecting the
        hyperparameter updates; before ``fit`` the prior is returned.
        ``dorders``: per-dimension derivative orders of each PREDICTION
        row — the posterior of :math:`\partial^{d} f` at ``X`` (fitted
        models only; derivative training data composes with it).
        """
        if return_std and return_cov:
            raise RuntimeError('Only one of return_std or return_cov may be True')

        X = self._points(X)
        d_new = self._normalize_predict_dorders(X, dorders)

        if not self._fit:
            return self.underlying_properties(X=X, return_std=return_std,
                                              return_cov=return_cov)

        d_train = self.dorders_ if Xc is None else None
        if Xc is None:
            Xc = self.X_train_
            sqrt_R = self._sqrt_R_train()
            basis_old = self.basis_train_
        else:
            Xc = self._points(Xc)
            kk = self.kernel_(Xc) + self.nugget * torch.eye(
                Xc.shape[0], dtype=Xc.dtype, device=Xc.device)
            if self.decomposition == 'cholesky':
                sqrt_R = _resolve_chol_fn(self.chol_engine)(kk)
            elif self.decomposition == 'eig':
                sqrt_R = eigh_sqrt(kk)
            else:
                raise ValueError('decomposition must be "cholesky" or "eig"')
            basis_old = self._basis(Xc)
        y = self.y_train_ if y is None else self._tensor(y)
        y2 = y[:, None] if y.ndim == 1 else y
        var = self.compute_cov_factor(scale_sq=self.scale_ ** 2, df=self.df_)
        with torch.no_grad():
            # derivative rows on either side: order-aware correlation
            # blocks and a basis derivatized the same way
            R_on = R_nn = None
            basis_new = self._basis(X)
            if d_train is not None or d_new is not None:
                R_on = self._deriv_cross_corr(Xc, d_train, X, d_new)
            if d_new is not None:
                R_nn = self._deriv_cross_corr(X, d_new)
                basis_new = self._derivatized_basis(X, d_new)
            return self._predict_core(
                self._theta(), Xc, X, y2, sqrt_R, self.center_, var,
                basis_old, basis_new, return_std, return_cov, pred_noise,
                *self._fused_extra(), R_on=R_on, R_nn=R_nn)

    # subclasses whose prediction adds terms set this: the Student-t
    # process ('tp') adds the mean-uncertainty term
    _fused_kind = 'gp'

    def _fused_extra(self):
        """Extra arguments of :meth:`_predict_core` (the Student-t process
        passes its posterior dispersion)."""
        return ()

    def _predict_core(self, theta, Xc, X, y2, sqrt_R, center, var, basis_old,
                      basis_new, return_std, return_cov, pred_noise, *extra,
                      R_on=None, R_nn=None):
        """The prediction, conditioned on (Xc, y2) with the factor sqrt_R.
        ``R_on`` / ``R_nn`` (derivative blocks) replace the kernel's
        value blocks where given."""
        kind = type(self)._fused_kind
        decomp = self.decomposition
        kernel = self.kernel_
        m_old = basis_old @ center
        m_new = basis_new @ center
        if R_on is None:
            R_on = kernel.value_fn(theta, Xc, X)
        R_no = R_on.mT
        alpha = solve_sqrt(sqrt_R, y2 - m_old[:, None], decomposition=decomp)
        m_pred = torch.squeeze(m_new[:, None] + R_no @ alpha)
        if kind == 'tp':
            # Student-t mean uncertainty: conditional basis
            # B_c = B_new − R_no R_oo⁻¹ B_old
            (disp,) = extra
            basis_cond = basis_new - R_no @ solve_sqrt(
                sqrt_R, basis_old, decomposition=decomp)
            mean_cov = var * (basis_cond @ disp @ basis_cond.mT)
        if not (return_std or return_cov):
            return m_pred
        if R_nn is None:
            R_nn = kernel.value_fn(theta, X, None)
        R_pred = R_nn - R_no @ solve_sqrt(sqrt_R, R_on, decomposition=decomp)
        if pred_noise:
            R_pred = R_pred + self.nugget * torch.eye(
                X.shape[0], dtype=R_pred.dtype, device=R_pred.device)
        K_pred = torch.squeeze(var * R_pred)
        if return_std:
            # interpolation pins the variance to exactly zero; clamp the
            # round-off-negative diagonal before the square root
            std = torch.sqrt(torch.clamp(torch.diag(K_pred), min=0.0))
            if kind == 'tp':
                # standard deviations add, not variances
                std = std + torch.sqrt(torch.clamp(torch.diag(mean_cov),
                                                   min=0.0))
            return m_pred, std
        if kind == 'tp':
            K_pred = K_pred + torch.squeeze(mean_cov)
        return m_pred, K_pred

    def sample_y(self, X, n_samples=1, random_state=0, underlying=False):
        """Draws samples from the (predictive or underlying) process at X.

        Draws use a ``torch.Generator`` on the model's device seeded with
        ``random_state`` (an int; None draws a fresh seed; a generator is
        used as given) and a jittered Cholesky factor, so they differ from
        the JAX package's at equal seeds; the distribution is the same.
        """
        gen = _generator(random_state, self.device)
        if underlying:
            y_mean, y_cov = self.underlying_properties(X=X, return_cov=True)
        else:
            y_mean, y_cov = self.predict(X, return_cov=True)

        y_cov = torch.atleast_2d(y_cov)
        N = y_cov.shape[0]
        L = cholesky(y_cov + 1e-12 * torch.eye(N, dtype=y_cov.dtype,
                                               device=y_cov.device))

        def draw():
            return torch.randn((n_samples, N), generator=gen,
                               dtype=y_cov.dtype, device=y_cov.device)

        if y_mean.ndim == 1:
            return (y_mean + draw() @ L.mT).mT
        return torch.stack([(y_mean[:, i] + draw() @ L.mT).mT
                            for i in range(y_mean.shape[1])], dim=1)


def _blocked_chol(R):
    """Cholesky through ``ops.batched_blocked_cholesky`` (GEMM-dominated
    blocks; differentiable)."""
    if R.ndim == 2:
        return batched_blocked_cholesky(R[None])[0]
    return batched_blocked_cholesky(R)


def _auto_chol(R):
    """Batch-, size- and dtype-routed Cholesky.

    The blocked engine wins on batches: on an NVIDIA H100 (700 W) the
    blocked pipeline took 22.1 ms against 47.9 ms for ``torch.linalg`` at
    B=16, N=4096, f32 (PERF.md §6, from ``chip_smoke.py``).  So a batch
    (B ≥ 2) of large (N > 512) f32 matrices on a CUDA device goes to the
    blocked engine; a single matrix (the models' one matrix per lml) and
    every f64 matrix go to ``torch.linalg.cholesky_ex`` (cuSOLVER).
    """
    if (R.ndim >= 3 and R.shape[0] >= 2 and R.shape[-1] > 512
            and R.dtype == torch.float32 and R.device.type == 'cuda'):
        return _blocked_chol(R)
    return cholesky(R)


_CHOL_ENGINES = {'auto': _auto_chol, 'xla': cholesky, 'blocked': _blocked_chol}


def _resolve_chol_fn(engine):
    """Maps a ``chol_engine`` name ('auto' | 'xla' | 'blocked') to the
    Cholesky function of the lml, fit and predict."""
    try:
        return _CHOL_ENGINES[engine]
    except KeyError:
        raise ValueError('chol_engine must be one of %s, got %r'
                         % (sorted(_CHOL_ENGINES), engine))


def _safe_sqrt_R(R_reg, decomposition, chol_fn=None):
    """Factors R with a success flag; re-factors a sanitized matrix so
    that gradients stay finite where the factorization fails."""
    eye = torch.eye(R_reg.shape[0], dtype=R_reg.dtype, device=R_reg.device)
    if chol_fn is None:
        chol_fn = cholesky
    if decomposition == 'cholesky':
        L0 = chol_fn(R_reg)
        ok = torch.all(torch.isfinite(torch.diagonal(L0, dim1=-2, dim2=-1)),
                       dim=-1)
        R_safe = torch.where(ok, R_reg, eye)
        L = chol_fn(R_safe)
        return L, ok
    elif decomposition == 'eig':
        eig, Q = eigh_sqrt(R_reg)
        ok = torch.all(eig > 0)
        eig = torch.where(ok, eig, torch.ones_like(eig))
        return (eig, Q), ok
    raise ValueError('decomposition must be "cholesky" or "eig"')


class ConjugateGaussianProcess(BaseConjugateProcess):
    R"""Conjugacy-based Gaussian process.

    The log-marginal likelihood folds the conjugacy-updated mean and
    variance into the standard GP marginal likelihood (an extension of
    GPML Algorithm 2.1).
    """

    def _lml(self, kernel, theta, X, y, basis):
        decomposition = self.decomposition
        center0, disp0 = self.center0, self.disp0
        df0, scale0 = self.df0, self.scale0
        N = X.shape[0]
        R = self._wrap_corr_fn(kernel.value_fn)(theta, X, None)
        R_reg = R + self.nugget * torch.eye(N, dtype=R.dtype, device=R.device)
        sqrt_R, ok = _safe_sqrt_R(R_reg, decomposition,
                                  _resolve_chol_fn(self.chol_engine))
        # f32 data (the batched fits' scalar engine; the models hold f64):
        # factor in f32, then solve and update in f64, where JAX promotes
        wide = result_dtype(R.dtype)
        if wide != R.dtype:
            sqrt_R = (sqrt_R.to(wide) if decomposition == 'cholesky'
                      else tuple(t.to(wide) for t in sqrt_R))
            y, basis = y.to(wide), basis.to(wide)

        df = _conj.compute_df(y=y, df0=df0)
        center = _conj.compute_center(y, sqrt_R, basis, center0=center0,
                                      disp0=disp0, decomposition=decomposition)
        scale2 = _conj.compute_scale_sq(
            y=y, sqrt_R=sqrt_R, basis=basis, center0=center0, disp0=disp0,
            df0=df0, scale0=scale0, decomposition=decomposition)
        mean = basis @ center
        var = _conj.compute_cov_factor(scale_sq=scale2, df=df)

        logdet_R = logdet_sqrt(sqrt_R, decomposition)
        logdet_K = N * torch.log(var) + logdet_R

        y_train = y - mean[:, None]
        # alpha = K^{-1} y_train = R^{-1} y_train / var
        alpha = solve_sqrt(sqrt_R, y_train, decomposition=decomposition) / var

        log_likelihood_dims = -0.5 * torch.einsum('ik,ik->k', y_train, alpha)
        log_likelihood_dims = log_likelihood_dims - 0.5 * logdet_K
        log_likelihood_dims = log_likelihood_dims - N / 2 * _LOG_2PI
        log_likelihood = log_likelihood_dims.sum(-1)
        return torch.where(ok, log_likelihood, -torch.inf)

    def likelihood(self, log=True, X=None, y=None, theta=None):
        """Marginal likelihood of the data at theta."""
        log_like = self.log_marginal_likelihood(theta=theta, X=X, y=y)
        if log:
            return log_like
        return torch.exp(torch.as_tensor(log_like))


def _log_norm(df, scale_sq, disp, disp_zero):
    """log of the normal-scaled-inverse-χ² normalizer.  ``df`` is always a
    concrete number (ν₀, or ν₀ plus the count of y), so its log-gamma is
    taken on the host; ν = ∞ (``sd=``) gives inf − inf = NaN, as in the JAX
    package."""
    df = float(df)
    norm = math.lgamma(df / 2.) - df / 2. * torch.log(df * scale_sq / 2.)
    if not disp_zero:
        norm = norm + 0.5 * spd_logdet(2 * math.pi * disp)
    return norm


class ConjugateStudentProcess(BaseConjugateProcess):
    R"""Conjugacy-based Student-t process.

    The mean and the marginal variance are integrated out, which gives a
    multivariate-t likelihood, written as a ratio of
    normal-scaled-inverse-χ² normalizers.  Predictions add the
    mean-uncertainty term var·(B_c V B_cᵀ) with the conditional basis
    B_c = B_new − R_no R_oo⁻¹ B_old.
    """

    def _disp0_tensor(self):
        return device_constant(np.atleast_2d(np.asarray(self.disp0, float)),
                               self.device)

    def cov(self, X, Xp=None):
        X = self._points(X)
        Xp_arr = None if Xp is None else self._points(Xp)
        if not self._fit:
            df, scale, disp = self.df0, self.scale0, self._disp0_tensor()
            kernel = self.kernel if self.kernel is not None else self._default_kernel
        else:
            df, scale, disp = self.df_, self.scale_, self.disp_
            kernel = self.kernel_

        if df <= 2:
            raise ValueError('df must be greater than 2 for the covariance to exist')

        corr = kernel(X, Xp_arr)
        if Xp_arr is None:
            Xp_arr = X
        var = self.compute_cov_factor(scale_sq=scale ** 2, df=df)
        return var * (corr + self._basis(X) @ disp @ self._basis(Xp_arr).mT)

    _fused_kind = 'tp'

    def _fused_extra(self):
        return (self.disp_,)

    def predict(self, X, return_std=False, return_cov=False, Xc=None, y=None,
                pred_noise=False, dorders=None):
        R"""GP prediction plus the mean-uncertainty term var·(B_c V B_cᵀ).

        Fitted, every path (training set, ``Xc``, ``y``) adds the term in
        :meth:`_predict_core`.  Before ``fit`` the JAX package adds the
        prior's var·(B V₀ Bᵀ) on top of :meth:`cov`, which already holds
        it, so the prior dispersion counts twice; that is mirrored here.
        """
        pred = super().predict(X, return_std=return_std,
                               return_cov=return_cov, Xc=Xc, y=y,
                               pred_noise=pred_noise, dorders=dorders)
        if self._fit or not (return_std or return_cov):
            return pred
        basis = self._basis(self._points(X))
        var = self.compute_cov_factor(scale_sq=self.scale0 ** 2, df=self.df0)
        mean_cov = var * (basis @ self._disp0_tensor() @ basis.mT)
        mean, second = pred
        if return_std:
            return mean, second + torch.sqrt(torch.clamp(torch.diag(mean_cov),
                                                         min=0.0))
        return mean, second + mean_cov

    def _lml(self, kernel, theta, X, y, basis):
        decomposition = self.decomposition
        center0, disp0 = self.center0, self.disp0
        df0, scale0 = self.df0, self.scale0
        disp0_zero = bool(np.all(np.asarray(disp0) == 0))
        N, ny = X.shape[0], y.shape[1]
        R = self._wrap_corr_fn(kernel.value_fn)(theta, X, None)
        R_reg = R + self.nugget * torch.eye(N, dtype=R.dtype, device=R.device)
        sqrt_R, ok = _safe_sqrt_R(R_reg, decomposition,
                                  _resolve_chol_fn(self.chol_engine))

        df = _conj.compute_df(y=y, df0=df0)
        disp = _conj.compute_disp(y=y, sqrt_R=sqrt_R, basis=basis,
                                  disp0=disp0, decomposition=decomposition)
        scale_sq = _conj.compute_scale_sq(
            y=y, sqrt_R=sqrt_R, basis=basis, center0=center0, disp0=disp0,
            df0=df0, scale0=scale0, decomposition=decomposition)
        logdet_R = logdet_sqrt(sqrt_R, decomposition)

        scale0_sq = torch.full((), float(scale0) ** 2, dtype=R.dtype,
                               device=R.device)
        log_like = _log_norm(df, scale_sq, disp, disp0_zero) \
            - _log_norm(df0, scale0_sq, self._disp0_tensor(), disp0_zero) \
            - ny / 2. * (N * _LOG_2PI + logdet_R)
        return torch.where(ok, log_like, -torch.inf)


def _columns(a, mask):
    """The columns of ``a`` where the numpy boolean ``mask`` is True, picked
    by Python index (a boolean tensor index would wait for the device)."""
    idx = np.flatnonzero(mask)
    if len(idx) == a.shape[-1]:
        return a
    return torch.stack([a[..., int(i)] for i in idx], dim=-1)


class TruncationProcess:
    R"""Truncation-error process over partial sums of a power series.

    Wraps a coefficient process (CGP or CSP): ``fit`` extracts the
    coefficients ``c_n = Δy_n / (ref·Qⁿ)`` and fits the process to them;
    predictions of the partial sum y_k and of the truncation error
    y_∞ − y_k follow from geometric sums of the ratio Q.

    Parameters
    ----------
    kernel : Kernel
    ratio : scalar or callable ``X ↦ (n,)`` tensor (X is the model's f64
        points on its device)
    ref : scalar or callable, as ``ratio``
    excluded : 1-D array of ints, optional — orders excluded from the sums
    ratio_kws : dict, optional — keywords of ``ratio``
    **kwargs : forwarded to the coefficient process (``device`` too)
    """

    def __init__(self, kernel=None, ratio=0.5, ref=1, excluded=None,
                 ratio_kws=None, **kwargs):
        self.coeffs_process = BaseConjugateProcess(kernel=kernel, **kwargs)
        self.device = device = self.coeffs_process.device

        def ones(X):
            return torch.ones(X.shape[0], dtype=torch.float64, device=device)

        if not callable(ref):
            self.ref = lambda X, ref=ref: ref * ones(X)
        else:
            self.ref = ref
        if not callable(ratio):
            self.ratio = lambda X, ratio=ratio: ratio * ones(X)
        else:
            self.ratio = ratio

        self.kernel = kernel
        self.excluded = excluded
        self.ratio_kws = {} if ratio_kws is None else ratio_kws

        self._fit = False
        self.X_train_ = None
        self.y_train_ = None
        self.orders_ = None
        self.dX_ = None
        self.dy_ = None
        self.dderivs_ = None
        self.coeffs_ = None

    def _points(self, X):
        return self.coeffs_process._points(X)

    def _ratio(self, X, **ratio_kws):
        return self.coeffs_process._tensor(self.ratio(X, **ratio_kws))

    def _ref(self, X):
        return self.coeffs_process._tensor(self.ref(X))

    def mean(self, X, start=0, end=np.inf):
        """Mean of the sum of orders in [start, end]."""
        X = self._points(X)
        coeff_mean = self.coeffs_process.mean(X=X)
        ratio_sum = geometric_sum(x=self._ratio(X, **self.ratio_kws),
                                  start=start, end=end, excluded=self.excluded)
        return self._ref(X) * ratio_sum * coeff_mean

    def cov(self, X, Xp=None, start=0, end=np.inf):
        """Covariance of the sum of orders in [start, end]."""
        X = self._points(X)
        if Xp is not None:
            Xp = self._points(Xp)
        coeff_cov = self.coeffs_process.cov(X=X, Xp=Xp)
        Xp = X if Xp is None else Xp
        ratio_mat = self._ratio(X, **self.ratio_kws)[:, None] \
            * self._ratio(Xp, **self.ratio_kws)
        ratio_sum = geometric_sum(x=ratio_mat, start=start, end=end,
                                  excluded=self.excluded)
        ref_mat = self._ref(X)[:, None] * self._ref(Xp)
        return ref_mat * ratio_sum * coeff_cov

    def basis(self, X, start=0, end=np.inf):
        """Basis of the summed process."""
        X = self._points(X)
        cn_basis = self.coeffs_process._basis(X)
        ratio = self._ratio(X, **self.ratio_kws)[:, None]
        ratio_sum = geometric_sum(x=ratio, start=start, end=end,
                                  excluded=self.excluded)
        return self._ref(X)[:, None] * ratio_sum * cn_basis

    def underlying_properties(self, X, order, return_std=False, return_cov=False):
        y_mean = self.mean(X, start=order + 1)
        if return_cov:
            return y_mean, self.cov(X, start=order + 1)
        elif return_std:
            return y_mean, torch.sqrt(torch.diag(self.cov(X, start=order + 1)))
        return y_mean

    def _trunc_scalar_fns(self, start, end):
        """One-point forms of :meth:`mean`, :meth:`cov` and :meth:`basis`
        of the sum of orders in [start, end], for derivative observations:
        each takes ``(n_features,)`` points and reproduces the matrix form,
        with the x-dependence of ``ratio`` / ``ref`` and, for a Student-t
        coefficient process, the basis-dispersion term of its covariance."""
        proc = self.coeffs_process
        ratio_kws = self.ratio_kws
        excluded = self.excluded

        def cov_fn(x, xp):
            X1, X2 = x[None, :], xp[None, :]
            ratio_mat = self._ratio(X1, **ratio_kws)[:, None] \
                * self._ratio(X2, **ratio_kws)
            rsum = geometric_sum(x=ratio_mat, start=start, end=end,
                                 excluded=excluded)
            ref_mat = self._ref(X1)[:, None] * self._ref(X2)
            return (ref_mat * rsum * proc.cov(X=X1, Xp=X2))[0, 0]

        def mean_fn(x):
            X1 = x[None, :]
            rsum = geometric_sum(x=self._ratio(X1, **ratio_kws), start=start,
                                 end=end, excluded=excluded)
            return (self._ref(X1) * rsum * proc.mean(X=X1))[0]

        def basis_fn(x):
            return self.basis(X=x[None, :], start=start, end=end)[0]

        return cov_fn, mean_fn, basis_fn

    def _deriv_constraint_ctx(self, X, order):
        """The derivative-constrained conditioning's shared setup (for
        :meth:`predict` and ``TruncationTP.predict``): the constraint
        points, their orders, zero orders for the prediction points, and
        the one-point truncation-band functions."""
        Xd = _as_float(self.dX_)
        zeros_n = np.zeros((X.shape[0], Xd.shape[1]), dtype=int)
        fns = self._trunc_scalar_fns(start=order + 1, end=np.inf)
        return (Xd, self.dderivs_, zeros_n) + fns

    def fit(self, X, y, orders, dX=None, dy=None, dderivs=None):
        """Extracts the coefficients and fits the coefficient process.

        ``(dX, dy)`` constrain the truncation error to ``dy`` at ``dX``.
        ``dderivs``: per-dimension derivative orders of the constraints —
        ``dderivs=[[1]]`` makes ``dy[0]`` a constraint on the slope of the
        truncation error at ``dX[0]``; None or zeros are value
        constraints.  Their cross-covariances are derivatives of the whole
        truncation covariance (with the x-dependence of ``ratio`` /
        ``ref``) taken by ``torch.func``, so ``ratio`` / ``ref`` callables
        must then be torch-traceable.
        """
        X = self._points(X)
        y = self.coeffs_process._tensor(y)
        orders = np.asarray(orders)
        self.X_train_ = X
        self.y_train_ = y
        self.orders_ = orders
        orders_mask = ~np.isin(orders, self.excluded)

        self.dX_ = None if dX is None else self._points(dX)
        self.dy_ = None if dy is None else self.coeffs_process._tensor(dy)
        if dderivs is not None:
            if dX is None:
                raise ValueError('dderivs requires constraint points dX')
            dderivs = normalize_orders(dderivs, self.dX_.shape[0],
                                       self.dX_.shape[1])
            if not np.any(dderivs):
                dderivs = None      # all zero: value constraints
            else:
                # beyond the kernel's differentiability the coincident
                # limits (the constraint covariance's diagonal) do not
                # exist and the Taylor guards would return 0 variance
                k_check = (self.kernel if self.kernel is not None
                           else self.coeffs_process._default_kernel)
                _check_kernel_orders(k_check, dderivs)
        self.dderivs_ = dderivs

        ratio = self._ratio(X, **self.ratio_kws)
        ref = self._ref(X)
        if torch.atleast_1d(ratio).ndim > 1:
            raise ValueError('ratio must return a 1d array or a scalar')
        if torch.atleast_1d(ref).ndim > 1:
            raise ValueError('ref must return a 1d array or a scalar')
        self.coeffs_ = _columns(
            coefficients(y=y, ratio=ratio, ref=ref, orders=orders), orders_mask)
        self.coeffs_process.fit(X=X, y=self.coeffs_)
        self._fit = True
        return self

    def _normalize_predict_dorders(self, X, dorders):
        return _normalize_predict_dorders_for(
            self.coeffs_process.kernel_ if self._fit else None, self._fit,
            X, dorders)

    def predict(self, X, order, return_std=False, return_cov=False, Xc=None,
                y=None, pred_noise=False, kind='both', dorders=None,
                _parts_out=None):
        R"""Predictive distribution of y_order (+ truncation error) at X.

        ``kind`` selects the interpolant ('interp'), the truncation error
        ('trunc'), or their sum ('both').  ``pred_noise`` is accepted and
        ignored, as in the JAX package.  ``dorders``: per-dimension
        derivative orders of each prediction row — the posterior of that
        partial derivative of the selected band (the slope of the
        truncation error, say), differentiated through the whole summed
        process with x-dependent ``ratio`` / ``ref``, which must then be
        torch-traceable.  ``_parts_out`` (private): a dict that receives
        the jitter-ladder factors and the constraint cross-covariance, so
        that ``TruncationTP.predict`` reuses them.
        """
        X = self._points(X)
        d_new = self._normalize_predict_dorders(X, dorders)
        if not self._fit:
            return self.underlying_properties(X, order, return_cov=return_cov,
                                              return_std=return_std)

        Xc = self.X_train_ if Xc is None else self._points(Xc)
        if y is None:
            if order not in self.orders_:
                raise ValueError('order must be in orders passed to `fit`')
            if self.y_train_.ndim == 1:
                y = self.y_train_
            else:
                y = torch.squeeze(_columns(self.y_train_, self.orders_ == order))
        else:
            y = self.coeffs_process._tensor(y)

        if kind not in ['both', 'interp', 'trunc']:
            raise ValueError('kind must be one of "both", "interp" or "trunc"')

        m_pred, K_pred = 0, 0
        if kind in ('both', 'interp'):
            m_old = self.mean(X=Xc, start=0, end=order)
            # Xp given: no white-noise term (a noise-free Gram matrix), so
            # the jitter ladder decides the factor
            K_oo = self.cov(start=0, end=order, X=Xc, Xp=Xc)
            if d_new is not None:
                # derivative prediction rows: the summed process's mean and
                # covariance differentiated (the conditioning rows are
                # values)
                cov_i, mean_i, _ = self._trunc_scalar_fns(start=0, end=order)

                def vb_i(A, B):
                    return self.cov(start=0, end=order, X=A, Xp=B)

                m_new = deriv_mean(mean_i, X, d_new)
                K_on = deriv_cov(cov_i, Xc, None, X, d_new,
                                 value_block_fn=vb_i)
                K_nn = deriv_cov(cov_i, X, d_new, value_block_fn=vb_i)
                if _parts_out is not None:
                    _parts_out['K_on_interp'] = K_on
            else:
                m_new = self.mean(X=X, start=0, end=order)
                K_on = self.cov(start=0, end=order, X=Xc, Xp=X)
                K_nn = self.cov(start=0, end=order, X=X, Xp=X)
            K_no = K_on.mT

            # one jitter-ladder factorization serves every K_oo solve
            Lok_oo = robust_cholesky(K_oo)
            if _parts_out is not None:
                _parts_out['Lok_oo'] = Lok_oo
            alpha = robust_cho_solve(Lok_oo, y - m_old)
            m_pred = m_pred + m_new + K_no @ alpha
            if return_std or return_cov:
                K_pred = K_pred + K_nn - K_no @ robust_cho_solve(Lok_oo, K_on)

        if kind in ('both', 'trunc'):
            if d_new is not None:
                cov_t, mean_t, _ = self._trunc_scalar_fns(start=order + 1,
                                                          end=np.inf)

                def vb_t(A, B):
                    return self.cov(start=order + 1, end=np.inf, X=A, Xp=B)

                m_new_trunc = deriv_mean(mean_t, X, d_new)
                K_nn_trunc = deriv_cov(cov_t, X, d_new, value_block_fn=vb_t)
            else:
                m_new_trunc = self.mean(X=X, start=order + 1, end=np.inf)
                K_nn_trunc = self.cov(X=X, Xp=X, start=order + 1, end=np.inf)

            X_trunc = self.dX_
            if X_trunc is not None:  # the truncation error is constrained
                if self.dderivs_ is not None or d_new is not None:
                    # derivative rows on either side: derivative
                    # cross-covariances of the whole truncation covariance;
                    # value-by-value blocks through the matrix form
                    Xd, dd, zeros_n, cov_fn, mean_fn, _ = \
                        self._deriv_constraint_ctx(X, order)

                    def vb_c(A, B):
                        return self.cov(X=A, Xp=B, start=order + 1,
                                        end=np.inf)

                    if dd is None:
                        m_old_trunc = self.mean(X=X_trunc, start=order + 1,
                                                end=np.inf)
                        K_oo_trunc = self.cov(X=X_trunc, Xp=X_trunc,
                                              start=order + 1, end=np.inf)
                    else:
                        m_old_trunc = deriv_mean(mean_fn, Xd, dd)
                        K_oo_trunc = deriv_cov(cov_fn, Xd, dd,
                                               value_block_fn=vb_c)
                    K_on_trunc = deriv_cov(
                        cov_fn, Xd, dd, X,
                        zeros_n if d_new is None else d_new,
                        value_block_fn=vb_c)
                else:
                    m_old_trunc = self.mean(X=X_trunc, start=order + 1,
                                            end=np.inf)
                    K_oo_trunc = self.cov(X=X_trunc, Xp=X_trunc,
                                          start=order + 1, end=np.inf)
                    K_on_trunc = self.cov(X=X_trunc, Xp=X, start=order + 1,
                                          end=np.inf)
                K_no_trunc = K_on_trunc.mT
                Lok_trunc = robust_cholesky(K_oo_trunc)
                if _parts_out is not None:
                    _parts_out['K_no_trunc'] = K_no_trunc
                    _parts_out['Lok_trunc'] = Lok_trunc
                alpha_trunc = robust_cho_solve(Lok_trunc, self.dy_ - m_old_trunc)
                m_pred = m_pred + m_new_trunc + K_no_trunc @ alpha_trunc
                if return_std or return_cov:
                    K_pred = K_pred + K_nn_trunc \
                        - K_no_trunc @ robust_cho_solve(Lok_trunc, K_on_trunc)
            else:
                m_pred = m_pred + m_new_trunc
                if return_std or return_cov:
                    K_pred = K_pred + K_nn_trunc

        if return_cov:
            return m_pred, K_pred
        if return_std:
            # conditioning on (dX, dy) pins the variance to exactly zero at
            # the constraint points; clamp the round-off-negative diagonal
            return m_pred, torch.sqrt(torch.clamp(torch.diag(K_pred), min=0.0))
        return m_pred

    def _joint_lml(self, theta, X, y, orders, **ratio_kws):
        """The joint log-likelihood of (θ, ratio) as a differentiable 0-d
        tensor, in θ and in the tensors of ``ratio_kws`` (the sampler's
        target)."""
        cp = self.coeffs_process
        ref = self._ref(X)
        ratio = self._ratio(X, **ratio_kws)
        orders_mask = ~np.isin(orders, self.excluded)
        coeffs = _columns(coefficients(y=y, ratio=ratio, ref=ref, orders=orders),
                          orders_mask)
        coeff_log_like = cp._lml(cp._kernel_for_lml(), theta, X, coeffs,
                                 cp._basis(X))
        orders_in = orders[orders_mask]
        n = len(orders_in)
        det_factor = torch.sum(n * torch.log(torch.abs(ref))
                               + float(np.sum(orders_in))
                               * torch.log(torch.abs(ratio)))
        return coeff_log_like - det_factor

    def log_marginal_likelihood(self, theta, eval_gradient=False, X=None, y=None,
                                orders=None, **ratio_kws):
        R"""Joint log-likelihood of (θ, ratio) with the change-of-variables
        determinant y → c.  ``ratio_kws`` go to ``ratio`` in place of the
        model's own (``ratio=0.4`` re-evaluates a scalar ratio at 0.4).  The
        determinant does not depend on θ, so the gradient is the coefficient
        process's."""
        X = self.X_train_ if X is None else self._points(X)
        y = self.y_train_ if y is None else self.coeffs_process._tensor(y)
        orders = self.orders_ if orders is None else np.asarray(orders)
        theta = self.coeffs_process._tensor(theta)
        if not eval_gradient:
            with torch.no_grad():
                return self._joint_lml(theta, X, y, orders, **ratio_kws)
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            lml = self._joint_lml(theta, X, y, orders, **ratio_kws)
            (grad,) = torch.autograd.grad(lml, theta, allow_unused=True)
        if grad is None:            # no free hyperparameter reaches the lml
            grad = torch.zeros_like(theta)
        return lml.detach(), grad


class TruncationGP(TruncationProcess):
    R"""Truncation process with a ConjugateGaussianProcess over the
    coefficients."""

    def __init__(self, kernel=None, ratio=0.5, ref=1, excluded=None,
                 ratio_kws=None, **kwargs):
        super().__init__(kernel=kernel, ref=ref, ratio=ratio, excluded=excluded,
                         ratio_kws=ratio_kws, **kwargs)
        self.coeffs_process = ConjugateGaussianProcess(kernel=kernel, **kwargs)


class TruncationTP(TruncationProcess):
    R"""Truncation process with a ConjugateStudentProcess over the
    coefficients."""

    def __init__(self, kernel=None, ratio=0.5, ref=1, excluded=None,
                 ratio_kws=None, **kwargs):
        super().__init__(kernel=kernel, ratio=ratio, ref=ref, excluded=excluded,
                         ratio_kws=ratio_kws, **kwargs)
        self.coeffs_process = ConjugateStudentProcess(kernel=kernel, **kwargs)

    def predict(self, X, order, return_std=False, return_cov=False, Xc=None,
                y=None, pred_noise=False, kind='both', dorders=None):
        """Adds the marginalized-mean covariance, with conditional bases for
        the interpolant and for the (constrained) truncation error, each
        derivatized where derivative rows take part.  Before ``fit`` the
        prior is returned unchanged: the coefficient process's prior
        covariance already holds var·(B V₀ Bᵀ)."""
        parts = {}
        pred = super().predict(X=X, order=order, return_std=return_std,
                               return_cov=return_cov, Xc=Xc, y=y,
                               pred_noise=pred_noise, kind=kind,
                               dorders=dorders, _parts_out=parts)

        if not return_std and not return_cov:
            return pred
        if not self._fit:
            return pred

        X = self._points(X)
        d_new = self._normalize_predict_dorders(X, dorders)
        Xc = self.X_train_ if Xc is None else self._points(Xc)

        var = self.coeffs_process.cov_factor_
        disp = self.coeffs_process.disp_
        basis_lower = basis_trunc = torch.zeros(
            (X.shape[0], disp.shape[0]), dtype=disp.dtype, device=disp.device)

        if kind in ('both', 'interp'):
            if d_new is not None:
                K_no = parts['K_on_interp'].mT
                _, _, basis_i = self._trunc_scalar_fns(start=0, end=order)
                basis_lower_new = deriv_basis(basis_i, X, d_new)
            else:
                K_no = self.cov(X=X, Xp=Xc, start=0, end=order)
                basis_lower_new = self.basis(X=X, start=0, end=order)
            basis_lower_old = self.basis(X=Xc, start=0, end=order)
            basis_lower = basis_lower_new \
                - K_no @ robust_cho_solve(parts['Lok_oo'], basis_lower_old)

        if kind in ('both', 'trunc'):
            if d_new is not None:
                _, _, basis_t = self._trunc_scalar_fns(start=order + 1,
                                                       end=np.inf)
                basis_trunc = deriv_basis(basis_t, X, d_new)
            else:
                basis_trunc = self.basis(X=X, start=order + 1, end=np.inf)
            if self.dX_ is not None:
                if self.dderivs_ is not None or d_new is not None:
                    Xd, dd, _, _, _, basis_fn = \
                        self._deriv_constraint_ctx(X, order)
                    basis_trunc_old = deriv_basis(basis_fn, Xd, dd)
                else:
                    basis_trunc_old = self.basis(X=self.dX_, start=order + 1,
                                                 end=np.inf)
                basis_trunc = basis_trunc - parts['K_no_trunc'] @ \
                    robust_cho_solve(parts['Lok_trunc'], basis_trunc_old)

        basis = basis_lower + basis_trunc
        mean_cov = var * basis @ disp @ basis.mT

        mean, second = pred
        if return_std:
            return mean, second + torch.sqrt(torch.clamp(torch.diag(mean_cov),
                                                         min=0.0))
        return mean, second + mean_cov


class TruncationPointwise:
    R"""Pointwise (uncorrelated) truncation-error model of Furnstahl et al.
    (2015).

    iid Gaussian coefficients with a scaled-inverse-χ² conjugate prior on
    their common variance c̄²; the truncation error is Student-t at each
    point.

    Parameters
    ----------
    df : float >= 0 — prior degrees of freedom ν₀
    scale : float > 0, or one per point — prior scale τ₀
    excluded : int or array, optional — orders excluded everywhere
    device : where the model computes; the CUDA card by default (refused
        where no card is visible)
    """

    # fitted attributes (the trailing underscore marks the public fitted
    # surface; set by fit(), None before)
    _FITTED_ATTRS = ('y_', 'ratio_', 'ref_', 'orders_', 'orders_mask_',
                     '_orders_masked', 'coeffs_', 'coeffs_dist_', 'df_',
                     'scale_', 'y_masked_', 'dist_')

    def __init__(self, df=1, scale=1, excluded=None, device='cuda'):
        self.df0, self.scale0, self.excluded = df, scale, excluded
        self.device = resolve_device(device)
        self._fit = False
        for name in self._FITTED_ATTRS:
            setattr(self, name, None)

    def _tensor(self, a):
        a = as_input(a, device=self.device).to(self.device)
        return a.to(result_dtype(a.dtype))

    @staticmethod
    def _posterior_nu_tau(c, df0, scale0):
        """Conjugate scaled-inverse-χ² update of (ν, τ) from the masked
        coefficient table c (N, m): ν = ν₀ + m and ν τ² = ν₀ τ₀² + Σ_n c_n²
        (Melendez et al. 2019, Eq. 26)."""
        nu = df0 + c.shape[-1]
        prior = _on(df0 * np.asarray(scale0, dtype=float) ** 2, c)
        tau = torch.sqrt((prior + torch.sum(c * c, dim=-1)) / nu)
        return nu, tau

    def _compute_order_indices(self, orders):
        if orders is None:
            return slice(None)
        fitted = np.asarray(self._orders_masked)
        idx = np.squeeze([np.nonzero(fitted == k)
                          for k in np.atleast_1d(orders)])
        return int(idx) if idx.ndim == 0 else torch.as_tensor(idx)

    def fit(self, y, ratio, ref=1, orders=None):
        """Conjugate update of (ν, τ) and the pointwise Student-t truncation
        distribution."""
        from .stats import t as t_dist

        y = self._tensor(y)
        if y.ndim == 1:
            y = y[:, None]
        ratio = torch.atleast_1d(self._tensor(ratio))
        ref = torch.atleast_1d(self._tensor(ref))

        self.y_ = y
        self.ratio_ = ratio
        self.ref_ = ref

        if orders is None:
            orders = np.arange(y.shape[-1])
        orders = np.asarray(orders)
        if y.shape[-1] != orders.size:
            raise ValueError('The last dimension of `y` must have the same '
                             'size as `orders`')

        self.orders_ = orders
        self.orders_mask_ = orders_mask = ~np.isin(orders, self.excluded)
        self.coeffs_ = _columns(coefficients(y=y, ratio=ratio, ref=ref,
                                             orders=orders), orders_mask)
        self.df_, self.scale_ = self._posterior_nu_tau(
            self.coeffs_, self.df0, self.scale0)

        self.y_masked_ = _columns(y, orders_mask)
        self._orders_masked = orders_masked = orders[orders_mask]
        ratio_sums = torch.stack(
            [geometric_sum(ratio ** 2, int(k) + 1, np.inf,
                           excluded=self.excluded)
             for k in orders_masked]).mT
        trunc_scale = ref[:, None] * torch.sqrt(ratio_sums) \
            * self.scale_[:, None]
        self.coeffs_dist_ = t_dist(self.df_, loc=0, scale=self.scale_)
        self.dist_ = t_dist(self.df_, loc=self.y_masked_, scale=trunc_scale)
        self._fit = True
        return self

    def interval(self, alpha, orders=None):
        R"""Credible intervals of the truncation distribution, shape
        ``(2, [n_alpha,] n_points, n_orders)``."""
        alpha = self._tensor(alpha)
        if alpha.ndim == 1:
            alpha = alpha[:, None, None]
        interval = torch.stack(self.dist_.interval(alpha))
        return interval[..., self._compute_order_indices(orders)]

    def _points3(self, y):
        y = torch.atleast_1d(self._tensor(y))
        return y[:, None, None] if y.ndim == 1 else y

    def pdf(self, y, orders=None):
        idx = self._compute_order_indices(orders)
        return self.dist_.pdf(self._points3(y))[..., idx]

    def logpdf(self, y, orders=None):
        idx = self._compute_order_indices(orders)
        return self.dist_.logpdf(self._points3(y))[..., idx]

    def std(self):
        return self.dist_.std()

    def log_likelihood(self, ratio=None, ref=None):
        R"""Evidence for (ratio, ref) with the change-of-variables factor.

        The scale-invariant prior ν₀ = 0 drops its (infinite) normalization.
        The normalizers of the prior (ν₀, τ₀, host numbers) and of ν are
        host float64; the rest is on the model's device.
        """
        from scipy.special import gammaln

        if not self._fit:
            raise ValueError('Must call fit before calling log_likelihood')
        if ratio is None:
            ratio = self.ratio_
        if ref is None:
            ref = self.ref_
        ratio = torch.atleast_1d(self._tensor(ratio))
        ref = torch.atleast_1d(self._tensor(ref))

        y, orders, mask = self.y_, self.orders_, self.orders_mask_
        coeffs = _columns(coefficients(y=y, ratio=ratio, ref=ref,
                                       orders=orders), mask)
        df0, scale0 = self.df0, self.scale0
        nu, tau = self._posterior_nu_tau(coeffs, df0, scale0)

        n = coeffs.shape[-1]
        log_like = float(gammaln(nu / 2.)) - 0.5 * n * _LOG_2PI
        if df0 > 0:  # the scale-invariant prior df0 = 0 drops this
            # scale0 may be per point: its terms are summed
            log_like += 0.5 * float(np.sum(
                df0 * np.log(df0 * np.asarray(scale0) ** 2 / 2.))) \
                - float(gammaln(df0 / 2.))
        log_like = log_like - 0.5 * torch.sum(nu * torch.log(nu * tau ** 2
                                                              / 2.))
        return log_like - torch.sum(torch.log(torch.abs(ref))
                                    + np.sum(orders[mask]) * torch.log(ratio))

    def credible_diagnostic(self, data, dobs, band_intervals=None,
                            band_dobs=None, beta=True):
        """Empirical credible-interval coverage, with reference bands from
        the beta distribution (``beta=True``: HPD intervals of
        Beta(N s + 1, N - N s + 1) for each band dob s) or the binomial
        (intervals of Binomial(N, s) / N)."""
        from . import stats as gstats

        dist = self.dist_
        dobs = torch.atleast_1d(self._tensor(dobs))
        data = self._tensor(data)
        if data.ndim == 1:
            data = data[:, None]
        lower, upper = dist.interval(dobs[:, None, None])
        indicator = (lower < data) & (data < upper)
        D_CI = torch.mean(indicator.to(lower.dtype), dim=1)

        if band_intervals is not None:
            if band_dobs is None:
                band_dobs = dobs.cpu().numpy()
            band_dobs = np.atleast_1d(np.asarray(band_dobs))

            N = self.y_.shape[0]
            if beta:
                band_intervals = np.atleast_1d(band_intervals)
                bands = np.zeros((len(band_intervals), 2, len(band_dobs)))
                for i, p in enumerate(band_intervals):
                    bands[i] = np.array(
                        [hpd(gstats.beta, p, N * s + 1, N - N * s + 1,
                             device=self.device)
                         for s in band_dobs]).T
            else:
                band_dist = gstats.binom(n=N, p=band_dobs,
                                         device=self.device)
                band_intervals = np.atleast_2d(band_intervals)
                lo, hi = band_dist.interval(band_intervals.T)
                bands = torch.stack([lo, hi]).cpu().numpy() / N
                bands = np.transpose(bands, [1, 0, 2])
            return D_CI, bands
        return D_CI
