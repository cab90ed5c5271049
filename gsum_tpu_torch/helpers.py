R"""Series algebra of the truncation models (counterpart of the first part
of ``gsum_tpu/helpers.py``).

Partial sums ``y_k = y_ref Σ_{n≤k} c_n Qⁿ`` and their coefficients, the
geometric sums of the ratio Q that the truncation models' mean, covariance
and basis are built from, the two correlation functions of the toy data and
the toy-data generators.  Every function follows the device of its tensor
inputs (numpy inputs go to :func:`~gsum_tpu_torch._config.default_device`,
the CUDA card); scalar ``ratio`` / ``ref`` are filled on that device.
Orders arrive as numpy integers: powers ``Qⁿ`` are taken one Python-int
exponent at a time, so an exponent array never crosses to the device.

The statistics helpers: ``predictions`` (mean and intervals of a frozen
distribution), the highest-probability-density intervals ``hpd`` (a host
``scipy.optimize.fmin`` over a distribution's ``ppf``) and ``hpd_pdf`` (host
numpy over a tabulated pdf), ``median_pdf``, ``kl_gauss`` and
``general_sqrt_errors``; the decorators ``lazy_property``, ``lazy`` and
``default_attributes``; and ``VariogramFourthRoot``, whose binning is host
numpy and whose pair-of-pairs covariances run on the device of its
``gamma_tilde_grid``.
"""
from __future__ import annotations

import inspect
from functools import wraps
from math import gamma as _gamma_fn

import numpy as np
import torch

from ._config import (as_input, default_device, default_dtype,
                      device_constant, resolve_device)
from .linalg import (  # noqa: F401  (re-exported, as the JAX module does)
    cholesky, cholesky_errors, general_solve, mahalanobis, pivoted_cholesky,
    spd_logdet, stabilize)

__all__ = [
    'cartesian', 'toy_data', 'coefficients', 'partials', 'stabilize',
    'geometric_sum', 'predictions', 'gaussian', 'hpd', 'kl_gauss', 'rbf',
    'default_attributes', 'cholesky_errors', 'mahalanobis',
    'VariogramFourthRoot', 'median_pdf', 'hpd_pdf', 'pivoted_cholesky',
    'spd_logdet', 'generate_coefficients', 'lazy_property', 'lazy',
    'general_sqrt_errors',
]


def _float(x):
    """``x`` as a tensor (numpy to the card), integers cast to float64."""
    x = as_input(x)
    return x if x.is_floating_point() else x.to(default_dtype())


def _on(value, like):
    """``value`` (a number, numpy array or tensor) as a tensor on the device
    of ``like``; numbers and numpy arrays in the default dtype (float64),
    filled on the device where all their entries are equal."""
    if isinstance(value, torch.Tensor):
        return value.to(like.device)
    return device_constant(value, like.device)


def _scalar(n):
    """A numpy scalar as the Python number torch's ``**`` takes."""
    return n.item() if isinstance(n, np.generic) else n


def _pow_orders(x, orders):
    """``x ** orders`` with ``orders`` (numpy integers) along the last axis,
    where ``x``'s last axis has length 1 or ``len(orders)``, one exponent at a
    time."""
    wide = x.shape[-1] > 1
    return torch.stack([x[..., i if wide else 0] ** _scalar(n)
                        for i, n in enumerate(orders)], dim=-1)


def _generator(rng, device):
    """A ``torch.Generator`` on ``device``: ``rng`` itself when it is one, else
    one seeded with the int ``rng`` (None draws a fresh seed)."""
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=device)
    if rng is None:
        gen.seed()
    else:
        gen.manual_seed(int(rng))
    return gen


def cartesian(*arrays):
    """Cartesian product of 1-D arrays, shape ``(N_1 ··· N_p, p)``; earlier
    arrays loop more slowly than later ones."""
    N = len(arrays)
    first = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    device = None if first is None else first.device
    arrays = [as_input(a, device=device) for a in arrays]
    return torch.stack(torch.meshgrid(*arrays, indexing='ij'), -1).reshape(-1, N)


def coefficients(y, ratio, ref=1, orders=None):
    """Power-series coefficients from partial sums.

    ``c_n = (y_n - y_{n-1}) / (ref * ratio**n)``, the leading term kept.

    Parameters
    ----------
    y : tensor, shape = (n_samples, n_curves)
    ratio : scalar or (n_samples,) tensor
    ref : scalar or (n_samples,) tensor
    orders : 1-D array of ints, optional; defaults to ``0..n_curves-1``
    """
    y = as_input(y)
    if y.ndim != 2:
        raise ValueError('y must be 2d')
    orders = np.atleast_1d(np.arange(y.shape[-1]) if orders is None
                           else np.asarray(orders))
    if orders.shape[0] != y.shape[-1]:
        raise ValueError('partials and orders must have the same length')

    ref = torch.atleast_1d(_on(ref, y))[:, None]
    ratio = torch.atleast_1d(_on(ratio, y))[:, None]

    coeffs = torch.cat([y[..., :1], torch.diff(y, dim=-1)], dim=-1)
    return coeffs / (ref * _pow_orders(ratio, orders))


def partials(coeffs, ratio, ref=1, orders=None):
    R"""Partial sums :math:`y_k = y_{ref} \sum_{n=0}^k c_n Q^n` from
    coefficients; the inverse of :func:`coefficients`."""
    coeffs = as_input(coeffs)
    orders = np.atleast_1d(np.arange(coeffs.shape[-1]) if orders is None
                           else np.asarray(orders))

    ratio = torch.atleast_1d(_on(ratio, coeffs))
    if ratio.ndim == 1:
        ratio = ratio[:, None]
    ref = torch.atleast_1d(_on(ref, coeffs))
    if ref.ndim == 1:
        ref = ref[:, None]

    terms = ref * coeffs * _pow_orders(ratio, orders)
    return torch.cumsum(terms, dim=-1)


def geometric_sum(x, start, end, excluded=None):
    R"""Geometric sum :math:`S = \sum_{i=start}^{end} x^i`, less the
    ``excluded`` orders.

    ``start``, ``end`` and ``excluded`` are Python (or numpy) numbers;
    ``end`` may be ``np.inf``, which needs |x| < 1.
    """
    if end < start:
        raise ValueError('end must be greater than or equal to start')
    x = as_input(x)
    start = _scalar(start)
    if np.isinf(end):
        s = x ** start / (1 - x)
    else:
        s = (x ** start - x ** (_scalar(end) + 1)) / (1 - x)
    if excluded is not None:
        for n in np.atleast_1d(excluded):
            if (n >= start) and (n <= end):
                s = s - x ** _scalar(n)
    return s


def gaussian(X, Xp=None, ls=1):
    """Gaussian (squared-exponential) correlation ``exp(-|x - x'|² / 2ls²)``
    by the expansion of the squared distance."""
    X = _float(X) * (1.0 / ls)
    X2 = torch.sum(X ** 2, dim=1)
    if Xp is None:
        Xp = X
    else:
        Xp = _float(as_input(Xp, device=X.device)) * (1.0 / ls)
    Xp2 = torch.sum(Xp ** 2, dim=1)
    sqd = -2.0 * X @ Xp.mT + (X2[:, None] + Xp2[None, :])
    sqd = torch.clamp(sqd, min=0.0)
    return torch.exp(-0.5 * sqd)


def rbf(X, Xp=None, ls=1):
    """RBF correlation from pairwise Euclidean distances; ``ls = 0`` gives
    the indicator of equal points."""
    X = _float(X)
    Xp = X if Xp is None else _float(as_input(Xp, device=X.device))
    diff = X[:, None, ...] - Xp[None, ...]
    dist = torch.linalg.norm(diff, dim=-1)
    if ls == 0:
        return (dist == 0).to(default_dtype())
    return torch.exp(-0.5 * dist ** 2 / ls ** 2)


def toy_data(X, orders, basis=None, corr=None, beta=0, sd=1, ratio=0.5,
             ref=1, noise=1e-5, rng=None, **corr_kwargs):
    """Toy partial-sum curves ``(n_samples, len(orders))`` from a GP over
    coefficients (:func:`generate_coefficients`, one curve per order).

    The coefficients are transposed before :func:`partials`, so any number
    of orders works with any number of points (the original library's
    version needs ``len(orders) == len(X)``).  ``rng`` is an int seed
    (default 0) or a ``torch.Generator``; draws differ from the JAX
    package's at equal seeds (another generator), the distribution is the
    same.
    """
    coeffs = generate_coefficients(
        X, size=len(orders), basis=basis, corr=corr, beta=beta, sd=sd,
        noise=noise, rng=rng, **corr_kwargs)
    return partials(coeffs=coeffs.mT, ratio=ratio, ref=ref, orders=orders)


def generate_coefficients(X, size=1, basis=None, corr=None, beta=0, sd=1,
                          noise=1e-5, rng=None, **corr_kwargs):
    """``size`` GP coefficient curves at X, shape ``(size, n_samples)``:
    mean ``basis(X) @ beta``, covariance ``sd² corr(X) + noise² I``.

    ``rng`` is an int seed (default 0) or a ``torch.Generator`` on X's
    device; the standard-normal draws differ from the JAX package's at
    equal seeds (another generator), the distribution is the same.
    """
    X = _float(X)
    if corr is None:
        corr = gaussian
    K = sd ** 2 * corr(X, **corr_kwargs)
    K = K + noise ** 2 * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)

    if basis is None:
        basis_mat = torch.ones((X.shape[0], 1), dtype=K.dtype, device=K.device)
    else:
        basis_mat = basis(X)
    mean = basis_mat @ torch.atleast_1d(_on(beta, K).to(K.dtype))

    gen = _generator(0 if rng is None else rng, K.device)
    L = cholesky(K)
    z = torch.randn((size, K.shape[0]), generator=gen, dtype=K.dtype,
                    device=K.device)
    return mean + z @ L.mT


def _host(a):
    """``a`` as a numpy array (a tensor is copied to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def predictions(dist, dob=None):
    """Mean of a frozen distribution and, with ``dob``, its degree-of-belief
    intervals, shape ``(n_dob, 2, ...)`` squeezed."""
    mean = dist.mean()
    if dob is not None:
        dob = torch.atleast_2d(torch.as_tensor(
            _host(dob), dtype=default_dtype(), device=mean.device)).mT
        interval = torch.stack(dist.interval(dob)).permute(1, 0, 2)
        return mean, torch.squeeze(interval)
    return mean


def hpd(dist, alpha, *args, device=None):
    R"""Highest-probability-density interval of a distribution, from its
    ppf: the interval of probability ``alpha`` of least length, found by
    ``scipy.optimize.fmin`` (ftol 1e-8) over the cdf value at its start.

    ``dist`` is a frozen distribution, or a family called with ``args``
    (and ``device=``, where it is given).  Each evaluation reads two
    quantiles back to the host.  Returns a numpy array ``[lower, upper]``.
    """
    from scipy.optimize import fmin

    if args:
        dist = dist(*args) if device is None else dist(*args, device=device)

    def interval_length(start_):
        s = float(np.asarray(start_).ravel()[0])
        return float(dist.ppf(s + alpha) - dist.ppf(s))

    start = fmin(interval_length, 1 - alpha, ftol=1e-8, disp=False)[0]
    return _host(dist.ppf(np.array([start, alpha + start])))


def hpd_pdf(pdf, alpha, x):
    R"""HPD interval from a tabulated pdf, on the host (numpy): the level
    whose above-level region integrates (trapezoid rule) closest to
    ``alpha``, and the extreme points above it.  Returns a tensor on the
    device of ``pdf`` (the CPU for numpy)."""
    device = pdf.device if isinstance(pdf, torch.Tensor) else 'cpu'
    pdf = _host(pdf)
    x = _host(x)

    def err_fn(p):
        prob = np.trapezoid(pdf[pdf >= p], x=x[pdf >= p])
        return (prob - alpha) ** 2

    heights = np.unique(pdf)
    errs = np.array([err_fn(h) for h in heights])
    horizontal = heights[np.argmin(errs)]
    interval = x[pdf > horizontal]
    return torch.tensor([np.min(interval), np.max(interval)], device=device)


def median_pdf(pdf, x):
    R"""Median from a tabulated pdf: the first grid point where the
    cumulative trapezoid integral exceeds one half (the last point if it
    never does)."""
    pdf = as_input(pdf)
    x = as_input(x, device=pdf.device)
    dx = torch.diff(x)
    cum = torch.cat([torch.zeros((1,), dtype=pdf.dtype, device=pdf.device),
                     torch.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * dx, dim=0)])
    above = cum > 0.5
    idx = torch.argmax(above.to(torch.uint8))
    idx = torch.where(torch.any(above), idx, x.shape[0] - 1)
    return x[idx]


def kl_gauss(mu0, cov0, mu1, cov1=None, chol1=None):
    R"""KL divergence :math:`D_{KL}(N_0 \| N_1)` between two multivariate
    Gaussians; exactly one of ``cov1`` / ``chol1`` is given (``cov1`` is
    factored after :func:`stabilize`)."""
    mu0 = torch.atleast_1d(as_input(mu0))
    mu1 = torch.atleast_1d(as_input(mu1, device=mu0.device))
    cov0 = torch.atleast_2d(as_input(cov0, device=mu0.device))
    if chol1 is not None and cov1 is None:
        chol1 = torch.atleast_2d(as_input(chol1, device=mu0.device))
    elif cov1 is not None and chol1 is None:
        cov1 = torch.atleast_2d(as_input(cov1, device=mu0.device))
        chol1 = cholesky(stabilize(cov1))
    else:
        raise ValueError('Exactly one of cov1 or chol1 must be given.')

    k = cov0.shape[0]
    logdet0 = spd_logdet(cov0)
    logdet1 = 2 * torch.sum(torch.log(torch.diagonal(chol1)))
    right_quad = torch.linalg.solve_triangular(
        chol1, (mu1 - mu0)[:, None], upper=False)[:, 0]
    quad = right_quad @ right_quad
    tr_mat = torch.trace(torch.cholesky_solve(cov0, chol1))
    return 0.5 * (tr_mat + quad - k + logdet1 - logdet0)


def general_sqrt_errors(y, mean, sqrt_mat):
    """Whitened residuals ``S⁻¹(y - mean)`` for a general (not triangular)
    square root S, through ``linalg.general_solve`` (the original library's
    version passed ``lower=`` to ``np.linalg.solve`` and failed)."""
    from .linalg import _T

    y = as_input(y)
    return _T(general_solve(as_input(sqrt_mat, device=y.device),
                            _T(y - mean)))


_LAZY_UNSET = object()


def lazy_property(method):
    R"""Compute-once read-only property: the first access runs ``method``
    and keeps its result on the instance; later accesses return it."""
    slot = f'_lazy_{method.__name__}'

    @property
    @wraps(method)
    def getter(self):
        value = getattr(self, slot, _LAZY_UNSET)
        if value is _LAZY_UNSET:
            value = method(self)
            setattr(self, slot, value)
        return value

    return getter


def lazy(method):
    R"""Method memoizer keyed on the ``y`` / ``corr_chol`` arguments (the
    original library's older decorator, kept for its API).

    The result is cached on the instance.  ``y=`` and ``corr_chol=`` fall
    back to ``self.y`` / ``self._corr_chol`` when omitted; values that differ
    from those attributes bypass and refresh the cache.
    """
    slot = f'_lazy_call_{method.__name__}'

    @wraps(method)
    def cached(self, *args, **kwargs):
        refresh = False
        fills = {}
        for name, attr in (('y', 'y'), ('corr_chol', '_corr_chol')):
            given = kwargs.pop(name, None)
            default = getattr(self, attr)
            if given is not None and not np.allclose(_host(given),
                                                     _host(default)):
                refresh = True
                fills[name] = given
            else:
                fills[name] = default
        if refresh or not hasattr(self, slot):
            setattr(self, slot, method(self, *args, **fills, **kwargs))
        return getattr(self, slot)

    return cached


def default_attributes(**attr_map):
    R"""Substitute instance attributes for omitted method arguments.

    ``@default_attributes(x='x_', y='_y')`` wraps a method so that any mapped
    parameter left at its "empty" value (``None`` for ordinary and
    keyword-only parameters, ``()`` / ``{}`` for ``*args`` / ``**kwargs``)
    is replaced by ``getattr(self, <mapped attribute>)`` at call time.
    Array arguments (numpy or tensors) are never treated as empty.
    """
    def wrap(method):
        sig = inspect.signature(method)
        empties = {}
        for name, attr in attr_map.items():
            kind = sig.parameters[name].kind
            if kind is inspect.Parameter.VAR_POSITIONAL:
                empties[name] = (attr, ())
            elif kind is inspect.Parameter.VAR_KEYWORD:
                empties[name] = (attr, {})
            else:
                empties[name] = (attr, None)

        @wraps(method)
        def filled(self, *args, **kwargs):
            bound = sig.bind(self, *args, **kwargs)
            bound.apply_defaults()
            for name, (attr, empty) in empties.items():
                current = bound.arguments.get(name)
                if isinstance(current, (np.ndarray, torch.Tensor)):
                    continue
                is_empty = current is None if empty is None else current == empty
                if is_empty:
                    bound.arguments[name] = getattr(self, attr)
            return method(*bound.args, **bound.kwargs)

        return filled
    return wrap


def _fourth_root_corr(rho, corr_factor):
    R"""Correlation of fourth-root differences given the underlying rho:
    ``corr_factor * ((1 - rho²) ₂F₁(¾, ¾; ½; rho²) - 1)``, clamped at ±1,
    with ``_accmath.hyp2f1_variogram``."""
    from ._accmath import hyp2f1_variogram

    rho_sq = rho ** 2
    # hyp2f1 diverges for |rho| >= 1; clamp its argument, overwrite below
    safe = torch.clamp(rho_sq, 0.0, 1.0 - 1e-12)
    h = hyp2f1_variogram(safe)
    corr = ((1 - rho_sq) * h - 1) * corr_factor
    corr = torch.where(rho >= 1., 1., corr)
    return torch.where(rho <= -1., -1., corr)


def _bin_var_batched(gam_grid, pi, pj, msk, corr_factor, var_factor):
    R"""Per-bin variance of the binned fourth-root variogram in one pass.

    Parameters
    ----------
    gam_grid : (N, N, n_curves) gamma-tilde lookup grid
    pi, pj : (Nb, M) padded point indices of each bin's pairs
    msk : (Nb, M) validity mask
    Returns (Nb, n_curves) masked pair-of-pairs covariance means.
    """
    i, j = pi[:, :, None], pj[:, :, None]           # (Nb, M, 1)
    k, l = pi[:, None, :], pj[:, None, :]           # (Nb, 1, M)
    gam = gam_grid
    rho = (gam[j, k] + gam[i, l] - gam[i, k] - gam[j, l]) \
        / (2 * torch.sqrt(gam[i, j] * gam[k, l]))   # (Nb, M, M, C)
    corr = _fourth_root_corr(rho, corr_factor)
    same = ((i == k) & (j == l))[..., None]
    corr = torch.where(same, 1.0, corr)
    var_i = var_factor * torch.sqrt(gam[i, j])
    var_k = var_factor * torch.sqrt(gam[k, l])
    cov = corr * torch.sqrt(var_i * var_k)
    w = (msk[:, :, None] & msk[:, None, :])[..., None]
    cov = torch.where(w, cov, 0.0)
    counts = torch.sum(msk, dim=1).to(cov.dtype)     # (Nb,)
    denom = (counts * counts)[:, None]
    return torch.where(denom > 0, torch.sum(cov, dim=(1, 2)) / denom, 0.0)


class VariogramFourthRoot:
    R"""Empirical semivariogram with fourth-root-transform uncertainty
    bands (Bowman & Crujeiras 2013; Cressie & Hawkins 1980).

    The binning is host numpy (``bincount`` segment means over the pairs of
    points); the per-bin variances of the O(Σ_b n_b²) pair-of-pairs
    covariance run on the device of ``gamma_tilde_grid``: as one padded,
    masked (Nb, M, M, n_curves) pass where that grid holds at most 3e7
    elements, else bin by bin.

    Parameters
    ----------
    X : array, shape = (n_samples, n_features)
    z : array, shape = (n_samples, [n_curves])
    bin_bounds : array, shape = (n_bins-1,)
    device : where ``gamma_tilde_grid`` lives and the covariances run: the
        device of ``z`` when it is a tensor, else the card unless given
    """

    mean_factor = np.sqrt(2 / np.pi) * _gamma_fn(0.75)
    var_factor = 2. / np.pi * (np.sqrt(np.pi) - _gamma_fn(0.75) ** 2)
    corr_factor = _gamma_fn(0.75) ** 2 / (np.sqrt(np.pi) - _gamma_fn(0.75) ** 2)

    def __init__(self, X, z, bin_bounds, device=None):
        if isinstance(z, torch.Tensor):
            device = z.device
        self.device = resolve_device(default_device() if device is None
                                     else device)
        X = _host(X)
        z = np.atleast_2d(_host(z))
        bin_bounds = np.asarray(bin_bounds, dtype=float)
        self.N = N = len(X)
        self.Ncurves = z.shape[0]
        self.Nb = n_bins = bin_bounds.size + 1
        self.bin_labels = np.arange(n_bins)

        # one unordered pair per (i > j) lower-triangle entry
        hij = np.linalg.norm(X[:, None, :] - X[None, :, :], axis=-1)
        self.pair_i, self.pair_j = tri = np.tril_indices(N, -1)
        self.pair_h = hij[tri]                                # (n_pairs,)
        self.pair_d = np.sqrt(np.abs(z.T[tri[0]] - z.T[tri[1]]))

        self.bin_idx = np.digitize(self.pair_h, bin_bounds)
        self.bin_mask = self.bin_labels[:, None] == self.bin_idx
        self.bin_counts = counts = np.bincount(self.bin_idx,
                                               minlength=n_bins)
        occupied = counts > 0
        denom = np.maximum(counts, 1).astype(float)

        sums_d = np.zeros((n_bins, self.Ncurves))
        np.add.at(sums_d, self.bin_idx, self.pair_d)
        gamma_star_hat = np.where(occupied[:, None], sums_d / denom[:, None],
                                  np.nan)

        # bin abscissa: the mean pair distance where a bin is occupied, else
        # the boundary midpoint (the overflow bins' one half-width beyond
        # the outermost boundary)
        mids = np.empty(n_bins)
        mids[1:-1] = 0.5 * (bin_bounds[:-1] + bin_bounds[1:])
        mids[0] = 2.0 * bin_bounds[0] - mids[1]
        mids[-1] = 2.0 * bin_bounds[-1] - mids[-2]
        sums_h = np.bincount(self.bin_idx, weights=self.pair_h,
                             minlength=n_bins)
        self.bin_locations = np.where(occupied, sums_h / denom, mids)

        self.gamma_star_hat = gamma_star_hat
        self.gamma_star_mean = self.mean_factor * gamma_star_hat
        self.gamma_tilde = self.variogram_scale(gamma_star_hat)
        # [i, j]-indexable binned gamma tilde, on the device
        self.gamma_tilde_grid = torch.as_tensor(
            self.gamma_tilde[np.digitize(hij, bin_bounds)],
            dtype=default_dtype(), device=self.device)

    def _index(self, *idx):
        return [torch.as_tensor(np.asarray(_host(a)), device=self.device)
                for a in idx]

    def rho_ijkl(self, i, j, k, l):
        R"""Correlation between (Z_i - Z_j) and (Z_k - Z_l) via gamma
        tilde."""
        gam = self.gamma_tilde_grid
        i, j, k, l = self._index(i, j, k, l)
        return (gam[j, k] + gam[i, l] - gam[i, k] - gam[j, l]) \
            / (2 * torch.sqrt(gam[i, j] * gam[k, l]))

    def corr_ijkl(self, i, j, k, l):
        R"""Correlation of the fourth-root-transformed differences."""
        return _fourth_root_corr(self.rho_ijkl(i, j, k, l), self.corr_factor)

    def var_ij(self, i, j):
        R"""Variance of sqrt|Z_i - Z_j| estimated by gamma tilde."""
        i, j = self._index(i, j)
        return self.var_factor * torch.sqrt(self.gamma_tilde_grid[i, j])

    def cov_ijkl(self, i, j, k, l):
        R"""Covariance of fourth-root differences; correlation 1 where
        (i, j) == (k, l).  i, j, k, l are any broadcastable integer arrays
        (a trailing curve axis is appended)."""
        i, j, k, l = torch.broadcast_tensors(*self._index(i, j, k, l))
        corr = self.corr_ijkl(i, j, k, l)
        same = (i == k) & (j == l)
        if corr.ndim == same.ndim + 1:   # trailing curve axis
            same = same[..., None]
        corr = torch.where(same, 1.0, corr)
        return corr * torch.sqrt(self.var_ij(i, j) * self.var_ij(k, l))

    def _bin_pair_indices(self):
        """Padded (Nb, M) pair-index / mask arrays, M = max pairs per bin."""
        M = max(int(self.bin_counts.max()), 1)
        idx = np.zeros((self.Nb, M), dtype=int)
        msk = np.zeros((self.Nb, M), dtype=bool)
        for b in range(self.Nb):
            ii = np.nonzero(self.bin_mask[b])[0]
            idx[b, :len(ii)] = ii
            msk[b, :len(ii)] = True
        return idx, msk

    def cov(self, bin1, bin2=None):
        R"""Average pair-of-pairs covariance between two bins, one device
        pass over the bins' pair-of-pairs grid."""
        idx1 = np.nonzero(self.bin_mask[bin1])[0]
        nb1 = self.bin_counts[bin1]
        if bin2 is None or bin2 == bin1:
            nb2, idx2 = nb1, idx1
        else:
            nb2 = self.bin_counts[bin2]
            idx2 = np.nonzero(self.bin_mask[bin2])[0]
        if (nb1 * nb2) == 0:
            return 0.
        i = self.pair_i[idx1][:, None]
        j = self.pair_j[idx1][:, None]
        k = self.pair_i[idx2][None, :]
        l = self.pair_j[idx2][None, :]
        cov = torch.sum(self.cov_ijkl(i, j, k, l), dim=(0, 1))
        return _host(cov) / (nb1 * nb2)

    def variogram_scale(self, x):
        return (x / self.mean_factor) ** 4

    def fourth_root_scale(self, x):
        return self.mean_factor * x ** 0.25

    def compute(self, rt_scale=False):
        R"""Mean semivariogram and approximate 68% bands (host numpy).

        The per-bin variances are one device pass over a padded
        (Nb, M, M, n_curves) pair-of-pairs grid where that grid holds at most
        3e7 elements, else one pass per bin.
        """
        gam = self.gamma_star_mean if rt_scale else self.gamma_tilde
        idx, msk = self._bin_pair_indices()
        M = idx.shape[1]
        if self.Nb * M * M * self.Ncurves <= 3e7:
            pi, pj, mk = self._index(self.pair_i[idx], self.pair_j[idx], msk)
            var = _bin_var_batched(self.gamma_tilde_grid, pi, pj, mk,
                                   self.corr_factor, self.var_factor)
            sd = np.sqrt(_host(var))
        else:
            sd = np.zeros((self.Nb, self.Ncurves))
            for b in range(self.Nb):
                sd[b] = np.sqrt(self.cov(b))
        lower = self.gamma_star_mean - sd
        upper = self.gamma_star_mean + sd
        if not rt_scale:
            lower = self.variogram_scale(lower)
            upper = self.variogram_scale(upper)
        return gam, lower, upper
