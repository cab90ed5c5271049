R"""Covariance kernels with the scikit-learn hyperparameter protocol, in
PyTorch (counterpart of ``gsum_tpu/kernels.py``).

Kernels are callable objects with a packed log-parameter vector ``theta``,
log ``bounds``, ``clone_with_theta``, ``fixed`` hyperparameters, composition
by ``+`` / ``*`` / ``**``, and ``eval_gradient`` returning dK/d(log θ).  The
protocol is plain Python on numpy and is copied from the JAX package.

Every kernel exposes ``value_fn(theta, X, Y)``, a function of a θ tensor
that autograd differentiates, so the models differentiate the whole
log-marginal likelihood instead of assembling hand-derived gradients.
``eval_gradient`` is ``torch.func.jacfwd`` over ``value_fn``.

Squared distances use explicit differences, not the dot-product expansion,
so values match scikit-learn's ``pdist`` form at float64.

dtypes follow JAX's promotion: X (and Y) are cast to the promoted dtype of
themselves and the resolved hyperparameters before any arithmetic, so an f32
``X`` with an f64 θ gives f64, as in ``gsum_tpu`` (torch alone would keep
f32 when the f64 operand is 0-d).  Devices: a tensor ``X`` keeps its device;
a numpy ``X`` goes to the CUDA card (``_config.default_device``).

The JAX module's per-structure jit caches have no counterpart (PyTorch runs
eagerly), nor has its ``exp64`` (an f64 ``exp`` for the TPU): ``_resolve``
uses ``torch.exp``.
"""
from __future__ import annotations

import copy
import inspect
import math
from collections import namedtuple

import numpy as np
import torch

from ._config import as_input, default_dtype, device_constant

__all__ = [
    'Hyperparameter', 'Kernel', 'ConstantKernel', 'WhiteKernel', 'RBF',
    'Matern', 'RationalQuadratic', 'ExpSineSquared', 'DotProduct',
    'KernelOperator', 'Sum', 'Product', 'Exponentiation',
]


class Hyperparameter(namedtuple('Hyperparameter',
                                ('name', 'value_type', 'bounds',
                                 'n_elements', 'fixed'))):
    """A kernel hyperparameter specification (sklearn-compatible)."""

    __slots__ = ()

    def __new__(cls, name, value_type, bounds, n_elements=1, fixed=None):
        if not isinstance(bounds, str) or bounds != 'fixed':
            bounds = np.atleast_2d(np.asarray(bounds, dtype=float))
            if n_elements > 1 and bounds.shape[0] == 1:
                bounds = np.repeat(bounds, n_elements, 0)
            if bounds.shape[0] != n_elements:
                raise ValueError(
                    'Bounds on %s should have either 1 or %d dimensions. Given are %d'
                    % (name, n_elements, bounds.shape[0]))
        if fixed is None:
            fixed = isinstance(bounds, str) and bounds == 'fixed'
        return super().__new__(cls, name, value_type, bounds, n_elements, fixed)

    def __eq__(self, other):
        return (self.name == other.name
                and self.value_type == other.value_type
                and (isinstance(self.bounds, str) and isinstance(other.bounds, str)
                     and self.bounds == other.bounds
                     or not isinstance(self.bounds, str)
                     and not isinstance(other.bounds, str)
                     and np.all(self.bounds == other.bounds))
                and self.n_elements == other.n_elements
                and self.fixed == other.fixed)


def _sqdist(X, Y=None):
    """Pairwise squared Euclidean distances via explicit differences."""
    if Y is None:
        Y = X
    diff = X[:, None, :] - Y[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _cast(vals, *arrays):
    """``arrays`` (None passes through) cast to the promoted dtype of
    themselves and the resolved hyperparameter values."""
    dt = arrays[0].dtype
    for a in list(arrays[1:]) + list(vals.values()):
        if a is not None:
            dt = torch.promote_types(dt, a.dtype)
    out = tuple(None if a is None else a.to(dt) for a in arrays)
    return out if len(out) > 1 else out[0]


class Kernel:
    """Base class for all kernels."""

    # ------------------------------------------------------------------
    # Parameter management (sklearn protocol)
    # ------------------------------------------------------------------
    def get_params(self, deep=True):
        params = {}
        cls = type(self)
        init_sig = inspect.signature(cls.__init__)
        for name, p in init_sig.parameters.items():
            if name == 'self' or p.kind == p.VAR_KEYWORD:
                continue
            params[name] = getattr(self, name)
        return params

    def set_params(self, **params):
        if not params:
            return self
        valid = self.get_params(deep=True)
        for key, value in params.items():
            split = key.split('__', 1)
            if len(split) > 1:
                name, sub_name = split
                if name not in valid:
                    raise ValueError('Invalid parameter %s for kernel %s' % (name, self))
                getattr(self, name).set_params(**{sub_name: value})
            else:
                if key not in valid:
                    raise ValueError('Invalid parameter %s for kernel %s' % (key, self))
                setattr(self, key, value)
        return self

    def clone(self):
        params = self.get_params(deep=False)
        cloned = {}
        for k, v in params.items():
            if isinstance(v, Kernel):
                cloned[k] = v.clone()
            else:
                cloned[k] = copy.deepcopy(v)
        return type(self)(**cloned)

    def clone_with_theta(self, theta):
        cloned = self.clone()
        cloned.theta = theta
        return cloned

    @property
    def n_dims(self):
        return self.theta.shape[0]

    @property
    def hyperparameters(self):
        r = []
        for attr in dir(type(self)):
            if attr.startswith('hyperparameter_'):
                r.append(getattr(self, attr))
        return r

    @property
    def theta(self):
        theta = []
        params = self.get_params()
        for hp in self.hyperparameters:
            if not hp.fixed:
                theta.append(np.atleast_1d(np.asarray(params[hp.name], dtype=float)))
        if theta:
            return np.log(np.hstack(theta))
        return np.array([])

    @theta.setter
    def theta(self, theta):
        theta = np.asarray(theta, dtype=float)
        params = self.get_params()
        i = 0
        for hp in self.hyperparameters:
            if hp.fixed:
                continue
            if hp.n_elements > 1:
                params[hp.name] = np.exp(theta[i:i + hp.n_elements])
                i += hp.n_elements
            else:
                params[hp.name] = np.exp(theta[i])
                i += 1
        if i != len(theta):
            raise ValueError('theta has not the correct number of entries. Should be %d; given are %d'
                             % (i, len(theta)))
        self.set_params(**params)

    @property
    def bounds(self):
        bounds = [hp.bounds for hp in self.hyperparameters if not hp.fixed]
        if bounds:
            return np.log(np.vstack(bounds))
        return np.array([])

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------
    def value_fn(self, theta, X, Y=None):
        """K(X, Y) as a differentiable function of the free log-params."""
        raise NotImplementedError

    def diag_fn(self, theta, X):
        return torch.diagonal(self.value_fn(theta, X, None))

    def structure_key(self):
        """Hashable description of the kernel's compute structure.

        Two kernels with the same key evaluate identical functions of
        (theta, X, Y): same class tree, same fixed/free split, and same
        baked-in fixed parameter values.
        """
        params = self.get_params(deep=False)
        free = {hp.name for hp in self.hyperparameters if not hp.fixed}
        items = []
        for name in sorted(params):
            v = params[name]
            if isinstance(v, Kernel):
                items.append((name, v.structure_key()))
            elif name in free:
                # free values are runtime inputs (theta); only arity matters
                items.append((name, 'free', np.atleast_1d(np.asarray(v)).shape[0]))
            elif name.endswith('_bounds'):
                items.append((name, 'fixed' if (isinstance(v, str) and v == 'fixed') else 'open'))
            else:
                arr = np.atleast_1d(np.asarray(v, dtype=object)).ravel()
                items.append((name, tuple(arr.tolist())))
        return (type(self).__name__, tuple(items))

    def _theta_on(self, X):
        return torch.as_tensor(self.theta, dtype=default_dtype(),
                               device=X.device)

    def __call__(self, X, Y=None, eval_gradient=False):
        """K(X) or K(X, Y) at the kernel's θ; with ``eval_gradient``,
        ``(K, dK/dθ)`` with dK of shape (N, N, n_θ).  A tensor X keeps its
        device, a numpy X goes to the CUDA card."""
        X = torch.atleast_2d(as_input(X))
        theta = self._theta_on(X)
        if eval_gradient:
            if Y is not None:
                raise ValueError('Gradient can only be evaluated when Y is None.')
            K = self.value_fn(theta, X, None)
            if theta.shape[0] == 0:
                return K, K.new_empty((K.shape[0], K.shape[0], 0))
            dK = torch.func.jacfwd(lambda t: self.value_fn(t, X, None))(theta)
            return K, dK
        if Y is None:
            return self.value_fn(theta, X, None)
        Y = torch.atleast_2d(as_input(Y, device=X.device))
        return self.value_fn(theta, X, Y)

    def diag(self, X):
        X = torch.atleast_2d(as_input(X))
        return self.diag_fn(self._theta_on(X), X)

    def is_stationary(self):
        return True

    # ------------------------------------------------------------------
    # Composition and comparison
    # ------------------------------------------------------------------
    def __add__(self, b):
        if not isinstance(b, Kernel):
            return Sum(self, ConstantKernel(b))
        return Sum(self, b)

    def __radd__(self, b):
        if not isinstance(b, Kernel):
            return Sum(ConstantKernel(b), self)
        return Sum(b, self)

    def __mul__(self, b):
        if not isinstance(b, Kernel):
            return Product(self, ConstantKernel(b))
        return Product(self, b)

    def __rmul__(self, b):
        if not isinstance(b, Kernel):
            return Product(ConstantKernel(b), self)
        return Product(b, self)

    def __pow__(self, b):
        return Exponentiation(self, b)

    def __eq__(self, b):
        if type(self) != type(b):
            return False
        params_a = self.get_params()
        params_b = b.get_params()
        for key in set(list(params_a.keys()) + list(params_b.keys())):
            if np.any(params_a.get(key, None) != params_b.get(key, None)):
                return False
        return True

    def __repr__(self):
        return '{0}({1})'.format(
            type(self).__name__,
            ', '.join(map('{0:.3g}'.format, np.exp(self.theta))))

    def _fixed(self, name, value, device):
        """The fixed hyperparameter ``name`` (``value``) as a tensor on
        ``device`` (``_config.device_constant``), built once for its value
        and kept on the kernel: a value of several entries is copied from
        the host, which waits for the device's queue, and a CUDA graph
        (``optimize._Lbfgs.run``) can hold no copy."""
        a = np.asarray(value, dtype=float)
        kept = self.__dict__.setdefault('_fixed_on_device', {})
        key = (name, device, default_dtype())
        if key not in kept or not np.array_equal(kept[key][0], a):
            kept[key] = a.copy(), device_constant(a, device)
        return kept[key][1]

    def _resolve(self, theta):
        """Hyperparameter values: fixed ones as f64 tensors, free ones the
        exp of their slice of ``theta``."""
        vals = {}
        i = 0
        params = self.get_params()
        for hp in self.hyperparameters:
            if hp.fixed:
                vals[hp.name] = self._fixed(hp.name, params[hp.name],
                                            theta.device)
            else:
                n = hp.n_elements
                if n > 1:
                    vals[hp.name] = torch.exp(theta[i:i + n])
                else:
                    vals[hp.name] = torch.exp(theta[i])
                i += n
        return vals


class ConstantKernel(Kernel):
    R"""Constant kernel: ``k(x, y) = constant_value``."""

    def __init__(self, constant_value=1.0, constant_value_bounds=(1e-5, 1e5)):
        self.constant_value = constant_value
        self.constant_value_bounds = constant_value_bounds

    @property
    def hyperparameter_constant_value(self):
        return Hyperparameter('constant_value', 'numeric', self.constant_value_bounds)

    def value_fn(self, theta, X, Y=None):
        vals = self._resolve(theta)
        X = _cast(vals, X)
        m = X.shape[0] if Y is None else Y.shape[0]
        # a product, not torch.full: jacfwd differentiates through it
        return vals['constant_value'] * X.new_ones((X.shape[0], m))

    def diag_fn(self, theta, X):
        vals = self._resolve(theta)
        X = _cast(vals, X)
        return vals['constant_value'] * X.new_ones((X.shape[0],))

    def __repr__(self):
        return '{0:.3g}**2'.format(np.sqrt(self.constant_value))


class WhiteKernel(Kernel):
    R"""White noise kernel: ``noise_level`` on the diagonal for Y is None,
    else 0.  ``kernel(X)`` and ``kernel(X, X)`` differ, as in scikit-learn:
    the models call the one-argument form for a self-covariance."""

    def __init__(self, noise_level=1.0, noise_level_bounds=(1e-5, 1e5)):
        self.noise_level = noise_level
        self.noise_level_bounds = noise_level_bounds

    @property
    def hyperparameter_noise_level(self):
        return Hyperparameter('noise_level', 'numeric', self.noise_level_bounds)

    def value_fn(self, theta, X, Y=None):
        vals = self._resolve(theta)
        X = _cast(vals, X)
        if Y is None:
            return vals['noise_level'] * torch.eye(
                X.shape[0], dtype=X.dtype, device=X.device)
        return X.new_zeros((X.shape[0], Y.shape[0]))

    def diag_fn(self, theta, X):
        vals = self._resolve(theta)
        X = _cast(vals, X)
        return vals['noise_level'] * X.new_ones((X.shape[0],))

    def __repr__(self):
        return 'WhiteKernel(noise_level={0:.3g})'.format(self.noise_level)


class RBF(Kernel):
    R"""Radial basis function (squared exponential) kernel.

    ``k(x, y) = exp(-0.5 * ||(x - y) / length_scale||^2)`` with scalar
    (isotropic) or vector (anisotropic ARD) length scale.
    """

    def __init__(self, length_scale=1.0, length_scale_bounds=(1e-5, 1e5)):
        self.length_scale = length_scale
        self.length_scale_bounds = length_scale_bounds

    @property
    def anisotropic(self):
        return np.iterable(self.length_scale) and len(np.atleast_1d(self.length_scale)) > 1

    @property
    def hyperparameter_length_scale(self):
        if self.anisotropic:
            return Hyperparameter('length_scale', 'numeric',
                                  self.length_scale_bounds,
                                  len(np.atleast_1d(self.length_scale)))
        return Hyperparameter('length_scale', 'numeric', self.length_scale_bounds)

    def _scaled_sqdist(self, theta, X, Y):
        vals = self._resolve(theta)
        X, Y = _cast(vals, X, Y)
        ls = torch.atleast_1d(vals['length_scale'])
        return _sqdist(X / ls, None if Y is None else Y / ls)

    def value_fn(self, theta, X, Y=None):
        return torch.exp(-0.5 * self._scaled_sqdist(theta, X, Y))

    def diag_fn(self, theta, X):
        return X.new_ones((X.shape[0],))

    def __repr__(self):
        if self.anisotropic:
            return 'RBF(length_scale=[{0}])'.format(
                ', '.join(map('{0:.3g}'.format, np.atleast_1d(self.length_scale))))
        return 'RBF(length_scale={0:.3g})'.format(np.squeeze(self.length_scale))


def _kv_real_order(nu, x, series_iters=34, cf_iters=72):
    R"""Modified Bessel function of the second kind :math:`K_\nu(x)` for a
    real order ``nu > 0`` (a Python number) and a tensor ``x > 0``.

    Temme's method, as ``gsum_tpu.kernels._kv_real_order`` (and scipy's
    ``kv``): write ``nu = mu + n`` with integer ``n`` and ``|mu| <= 1/2``,
    evaluate ``(K_mu, K_{mu+1})`` by Temme's power series for ``x < 2`` and
    by Steed's continued fraction CF2 for ``x >= 2``, then run the upward
    recurrence ``K_{s+1} = K_{s-1} + (2s/x) K_s`` ``n`` times.

    The order's constants are host numbers; the loops have fixed trip
    counts and both branches are evaluated and selected with ``where``
    (guarded so the unselected branch stays finite), so the function has no
    data-dependent control flow and autograd and ``jacfwd`` go through it.
    """
    from scipy.special import rgamma as _rgamma

    if nu <= 0:
        raise ValueError('_kv_real_order requires nu > 0')
    n_rec = int(nu + 0.5)
    mu = float(nu - n_rec)               # |mu| <= 1/2
    mu2 = mu * mu

    # ---- host constants ----
    inv_g1p = float(_rgamma(1.0 + mu))   # 1/Gamma(1+mu)
    inv_g1m = float(_rgamma(1.0 - mu))   # 1/Gamma(1-mu)
    if abs(mu) > 1e-6:
        gam1 = (inv_g1m - inv_g1p) / (2.0 * mu)
    else:
        # series limit: 1/Gamma(1+z) = 1 + gamma_E z + O(z^2)
        gam1 = -float(np.euler_gamma)
    gam2 = 0.5 * (inv_g1m + inv_g1p)
    # mu*pi/sin(mu*pi) == 1/sinc(mu) (numpy sinc is sin(pi t)/(pi t))
    fact = float(1.0 / np.sinc(mu))

    small = x < 2.0
    # ---------- Temme series branch (x < 2) ----------
    xs = torch.where(small, x, 1.0)                  # keep logs/powers finite
    half = 0.5 * xs
    dlog = -torch.log(half)                          # log(2/x)
    e = mu * dlog
    tiny = torch.abs(e) < 1e-5
    e_safe = torch.where(tiny, 1.0, e)
    sinhc = torch.where(tiny, 1.0 + e * e / 6.0, torch.sinh(e_safe) / e_safe)
    ff = fact * (gam1 * torch.cosh(e) + gam2 * sinhc * dlog)
    ee = torch.exp(e)
    p = 0.5 * ee / inv_g1p
    q = 0.5 / (ee * inv_g1m)
    d4 = half * half                                 # x^2/4
    c = torch.ones_like(xs)
    s0 = ff + 0.0
    s1 = p * c
    for i in range(1, series_iters + 1):
        ff = (i * ff + p + q) / (i * i - mu2)
        c = c * d4 / i
        p = p / (i - mu)
        q = q / (i + mu)
        s0 = s0 + c * ff
        s1 = s1 + c * (p - i * ff)
    kmu_ser = s0
    kmu1_ser = s1 * (2.0 / xs)

    # ---------- Steed CF2 branch (x >= 2) ----------
    xc = torch.where(small, 2.0, x)
    a1 = 0.25 - mu2
    b = 2.0 * (1.0 + xc)
    d = 1.0 / b
    h = d
    delh = d
    qc = torch.full_like(xc, a1)
    q1, q2 = torch.zeros_like(xc), torch.ones_like(xc)
    a = torch.full_like(xc, -a1)
    cc = torch.full_like(xc, a1)
    s = 1.0 + qc * delh
    done = torch.zeros(xc.shape, dtype=torch.bool, device=xc.device)
    cf_eps = 10.0 * float(torch.finfo(x.dtype).eps)
    for i in range(2, cf_iters + 2):
        a_n = a - 2.0 * (i - 1.0)
        c_n = -a_n * cc / i
        qnew = (q1 - b * q2) / a_n
        q1_n, q2_n = q2, qnew
        qc_n = qc + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        dels = qc_n * delh_n
        s_n = s + dels
        # joint rescale: the recurrences use (q1, q2) only through the
        # product c*qnew, which is invariant under (q1, q2)/r, c*r
        r = torch.clamp(torch.maximum(torch.abs(q1_n), torch.abs(q2_n)),
                        min=1e-30)
        q1_n, q2_n, c_n = q1_n / r, q2_n / r, c_n * r
        # freeze once converged: the CF tail diverges past convergence, so
        # the fixed-trip loop must stop updating, not just stop caring
        new_done = done | (torch.abs(dels) <= cf_eps * torch.abs(s_n))
        b, d, h, delh = (torch.where(done, o, n) for o, n in
                         ((b, b_n), (d, d_n), (h, h_n), (delh, delh_n)))
        q1, q2, a, cc, qc, s = (torch.where(done, o, n) for o, n in
                                ((q1, q1_n), (q2, q2_n), (a, a_n), (cc, c_n),
                                 (qc, qc_n), (s, s_n)))
        done = new_done
    h = a1 * h
    kmu_cf = torch.sqrt(np.pi / (2.0 * xc)) * torch.exp(-xc) / s
    kmu1_cf = kmu_cf * (mu + xc + 0.5 - h) / xc

    kmu = torch.where(small, kmu_ser, kmu_cf)
    kmu1 = torch.where(small, kmu1_ser, kmu1_cf)

    # ---------- upward recurrence to order nu ----------
    two_over_x = 2.0 / x
    for j in range(n_rec):
        kmu, kmu1 = kmu1, kmu + (mu + j + 1.0) * two_over_x * kmu1
    return kmu


class Matern(RBF):
    R"""Matern kernel for any ``nu > 0``: closed forms for ``nu`` in
    {0.5, 1.5, 2.5, inf}, Temme's :math:`K_\nu` otherwise."""

    _CLOSED_FORM_NU = (0.5, 1.5, 2.5, np.inf)

    def __init__(self, length_scale=1.0, length_scale_bounds=(1e-5, 1e5), nu=1.5):
        super().__init__(length_scale, length_scale_bounds)
        if not np.isinf(nu):
            nu = float(nu)
            if not nu > 0:
                raise ValueError('Matern needs nu > 0, got %r' % (nu,))
            if nu > 100:
                raise ValueError('Matern nu=%g: beyond nu~100 the kernel '
                                 'is numerically the RBF limit — use '
                                 'nu=inf' % nu)
        self.nu = nu

    def value_fn(self, theta, X, Y=None):
        sq = self._scaled_sqdist(theta, X, Y)
        if self.nu == np.inf:
            return torch.exp(-0.5 * sq)
        # Double where, so d(sqrt)/d(sq) stays finite at sq == 0.  The
        # sq == 0 branch is the kernel's Taylor polynomial in sq (not the
        # constant 1), so derivatives taken through the selected branch at
        # coincident points read the kernel's true limits.
        zero = sq == 0
        d = torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))
        if self.nu == 0.5:
            return torch.where(zero, 1.0, torch.exp(-d))
        elif self.nu == 1.5:
            # k(u) = (1+u)e^{-u}, u = sqrt(3 sq): 1 - (3/2)sq + O(sq^{3/2})
            K = d * math.sqrt(3)
            return torch.where(zero, 1.0 - 1.5 * sq, (1. + K) * torch.exp(-K))
        elif self.nu == 2.5:
            # k(u) = (1+u+u^2/3)e^{-u}, u = sqrt(5 sq):
            # 1 - (5/6)sq + (25/24)sq^2 + O(sq^{5/2})
            K = d * math.sqrt(5)
            return torch.where(zero,
                               1.0 - (5.0 / 6.0) * sq + (25.0 / 24.0) * sq * sq,
                               (1. + K + K ** 2 / 3.0) * torch.exp(-K))
        # general real nu: k(d) = 2^{1-nu}/Gamma(nu) * u^nu * K_nu(u),
        # u = sqrt(2 nu) d; coincident points take the exact limit 1
        from scipy.special import gammaln as _h_gammaln
        nu = float(self.nu)
        u = d * math.sqrt(2.0 * nu)
        u_safe = torch.where(zero, 1.0, u)
        # K_nu(u) ~ u^{-nu} overflows once u < range^(-1/nu); below this
        # floor the normalized kernel is 1 to better than the dtype's own
        # precision, so clamping loses nothing
        lim = -30.0 if sq.dtype == torch.float32 else -250.0
        u_safe = torch.clamp(u_safe, min=10.0 ** (lim / nu))
        log_norm = (1.0 - nu) * math.log(2.0) - float(_h_gammaln(nu))
        val = math.exp(log_norm) * u_safe ** nu * _kv_real_order(nu, u_safe)
        return torch.where(zero, 1.0, val)

    def __repr__(self):
        base = super().__repr__().replace('RBF', 'Matern')
        return base[:-1] + ', nu={0:.3g})'.format(self.nu)


class RationalQuadratic(Kernel):
    R"""Rational quadratic kernel (isotropic): ``(1 + d^2/(2 alpha l^2))^-alpha``."""

    def __init__(self, length_scale=1.0, alpha=1.0,
                 length_scale_bounds=(1e-5, 1e5), alpha_bounds=(1e-5, 1e5)):
        self.length_scale = length_scale
        self.alpha = alpha
        self.length_scale_bounds = length_scale_bounds
        self.alpha_bounds = alpha_bounds

    @property
    def hyperparameter_length_scale(self):
        return Hyperparameter('length_scale', 'numeric', self.length_scale_bounds)

    @property
    def hyperparameter_alpha(self):
        return Hyperparameter('alpha', 'numeric', self.alpha_bounds)

    def value_fn(self, theta, X, Y=None):
        vals = self._resolve(theta)
        sq = _sqdist(*_cast(vals, X, Y))
        base = 1 + sq / (2 * vals['alpha'] * vals['length_scale'] ** 2)
        return base ** (-vals['alpha'])

    def diag_fn(self, theta, X):
        return X.new_ones((X.shape[0],))


class ExpSineSquared(Kernel):
    R"""Periodic kernel: ``exp(-2 sin^2(pi d / p) / l^2)``."""

    def __init__(self, length_scale=1.0, periodicity=1.0,
                 length_scale_bounds=(1e-5, 1e5), periodicity_bounds=(1e-5, 1e5)):
        self.length_scale = length_scale
        self.periodicity = periodicity
        self.length_scale_bounds = length_scale_bounds
        self.periodicity_bounds = periodicity_bounds

    @property
    def hyperparameter_length_scale(self):
        return Hyperparameter('length_scale', 'numeric', self.length_scale_bounds)

    @property
    def hyperparameter_periodicity(self):
        return Hyperparameter('periodicity', 'numeric', self.periodicity_bounds)

    def value_fn(self, theta, X, Y=None):
        vals = self._resolve(theta)
        sq = _sqdist(*_cast(vals, X, Y))
        zero = sq == 0
        d = torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))
        arg = math.pi * d / vals['periodicity']
        # sin^2(w*sqrt(sq)) is analytic in sq; the sq == 0 branch carries
        # its Taylor polynomial (see Matern.value_fn)
        w = math.pi / vals['periodicity']
        ws = (w * w) * sq
        sin2 = torch.where(zero, ws * (1.0 - ws / 3.0 + 2.0 * ws * ws / 45.0),
                           torch.sin(arg) ** 2)
        return torch.exp(-2 * sin2 / vals['length_scale'] ** 2)

    def diag_fn(self, theta, X):
        return X.new_ones((X.shape[0],))


class DotProduct(Kernel):
    R"""Dot-product kernel: ``sigma_0^2 + x . y`` (non-stationary)."""

    def __init__(self, sigma_0=1.0, sigma_0_bounds=(1e-5, 1e5)):
        self.sigma_0 = sigma_0
        self.sigma_0_bounds = sigma_0_bounds

    @property
    def hyperparameter_sigma_0(self):
        return Hyperparameter('sigma_0', 'numeric', self.sigma_0_bounds)

    def value_fn(self, theta, X, Y=None):
        vals = self._resolve(theta)
        X, Y = _cast(vals, X, Y)
        if Y is None:
            Y = X
        return vals['sigma_0'] ** 2 + X @ Y.mT

    def diag_fn(self, theta, X):
        vals = self._resolve(theta)
        X = _cast(vals, X)
        return vals['sigma_0'] ** 2 + torch.sum(X * X, dim=-1)

    def is_stationary(self):
        return False


class KernelOperator(Kernel):
    """Base class for binary kernel compositions."""

    def __init__(self, k1, k2):
        self.k1 = k1
        self.k2 = k2

    def get_params(self, deep=True):
        params = dict(k1=self.k1, k2=self.k2)
        if deep:
            for prefix, k in (('k1', self.k1), ('k2', self.k2)):
                for key, value in k.get_params(deep=True).items():
                    params['%s__%s' % (prefix, key)] = value
        return params

    def clone(self):
        return type(self)(self.k1.clone(), self.k2.clone())

    @property
    def hyperparameters(self):
        r = [Hyperparameter('k1__' + hp.name, hp.value_type, hp.bounds, hp.n_elements)
             for hp in self.k1.hyperparameters]
        r += [Hyperparameter('k2__' + hp.name, hp.value_type, hp.bounds, hp.n_elements)
              for hp in self.k2.hyperparameters]
        return r

    @property
    def theta(self):
        return np.append(self.k1.theta, self.k2.theta)

    @theta.setter
    def theta(self, theta):
        n1 = self.k1.n_dims
        self.k1.theta = theta[:n1]
        self.k2.theta = theta[n1:]

    @property
    def bounds(self):
        if self.k1.bounds.size == 0:
            return self.k2.bounds
        if self.k2.bounds.size == 0:
            return self.k1.bounds
        return np.vstack((self.k1.bounds, self.k2.bounds))

    def __eq__(self, b):
        if type(self) != type(b):
            return False
        return (self.k1 == b.k1 and self.k2 == b.k2) \
            or (self.k1 == b.k2 and self.k2 == b.k1)

    def is_stationary(self):
        return self.k1.is_stationary() and self.k2.is_stationary()

    def _split(self, theta):
        n1 = self.k1.n_dims
        return theta[:n1], theta[n1:]


class Sum(KernelOperator):
    def value_fn(self, theta, X, Y=None):
        t1, t2 = self._split(theta)
        return self.k1.value_fn(t1, X, Y) + self.k2.value_fn(t2, X, Y)

    def diag_fn(self, theta, X):
        t1, t2 = self._split(theta)
        return self.k1.diag_fn(t1, X) + self.k2.diag_fn(t2, X)

    def __repr__(self):
        return '{0} + {1}'.format(self.k1, self.k2)


class Product(KernelOperator):
    def value_fn(self, theta, X, Y=None):
        t1, t2 = self._split(theta)
        return self.k1.value_fn(t1, X, Y) * self.k2.value_fn(t2, X, Y)

    def diag_fn(self, theta, X):
        t1, t2 = self._split(theta)
        return self.k1.diag_fn(t1, X) * self.k2.diag_fn(t2, X)

    def __repr__(self):
        return '{0} * {1}'.format(self.k1, self.k2)


class Exponentiation(Kernel):
    def __init__(self, kernel, exponent):
        self.kernel = kernel
        self.exponent = exponent

    def get_params(self, deep=True):
        params = dict(kernel=self.kernel, exponent=self.exponent)
        if deep:
            for key, value in self.kernel.get_params(deep=True).items():
                params['kernel__%s' % key] = value
        return params

    def clone(self):
        return Exponentiation(self.kernel.clone(), self.exponent)

    @property
    def hyperparameters(self):
        return [Hyperparameter('kernel__' + hp.name, hp.value_type, hp.bounds, hp.n_elements)
                for hp in self.kernel.hyperparameters]

    @property
    def theta(self):
        return self.kernel.theta

    @theta.setter
    def theta(self, theta):
        self.kernel.theta = theta

    @property
    def bounds(self):
        return self.kernel.bounds

    def value_fn(self, theta, X, Y=None):
        return self.kernel.value_fn(theta, X, Y) ** self.exponent

    def diag_fn(self, theta, X):
        return self.kernel.diag_fn(theta, X) ** self.exponent

    def __eq__(self, b):
        if type(self) != type(b):
            return False
        return self.kernel == b.kernel and self.exponent == b.exponent

    def is_stationary(self):
        return self.kernel.is_stationary()

    def __repr__(self):
        return '{0} ** {1}'.format(self.kernel, self.exponent)
