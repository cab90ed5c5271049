R"""Frozen distributions with scipy's calling conventions (counterpart of
``gsum_tpu/stats/__init__.py``).

    >>> from gsum_tpu_torch import stats
    >>> d = stats.t(df=5, loc=0., scale=2., device='cpu')
    >>> d.interval(0.68)

Families: ``norm``, ``t``, ``chi2``, ``f``, ``beta``, ``binom``,
``multivariate_normal``, ``multivariate_t`` (``MVT``).  Every method takes
broadcastable tensor parameters, which is what lets the pointwise truncation
model hold an (n_points, n_orders) family of t distributions as one object.
Quantiles go through ``betaincinv`` / ``gammaincinv`` of
:mod:`gsum_tpu_torch.stats._special`, the beta-function ones through the
CUDA kernels of ``ops.incbeta`` on the card.

Devices and dtypes: parameters given as tensors keep their device; numbers
and numpy arrays go to ``device`` (``_config.default_device()``, the card,
when it is None).  The points a method is given follow the distribution's
device.  Everything is computed in the promoted type of the inputs and
float64 (``_config.result_dtype``), as the JAX package computes with x64 on.

Normalizers that depend on scalar parameters alone are host float64 numbers
(``_host_scalar`` / ``_log_c``), as in the JAX package; on the card this also
keeps a device round trip out of every ``logpdf``.

Random draws (``rvs``) come from a ``torch.Generator`` on the distribution's
device: ``random_state`` is an int seed, None (a fresh seed) or a
Generator.  Student-t draws are normal / sqrt(χ²/df), χ² is twice a gamma
draw (``torch._standard_gamma``), beta a ratio of gamma draws and binomial
``torch.binomial``.  They follow the same distributions as the JAX package's
but differ from its draws at equal seeds (another generator).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import betaln as _betaln_host
from scipy.special import gammaln as _gammaln_host

from .._config import default_device, default_dtype, resolve_device, result_dtype
from ..helpers import _generator
from ._special import betainc, betaincinv, betaln, gammaincinv

_LOG_2PI = math.log(2 * math.pi)
_SQRT_2PI = math.sqrt(2 * math.pi)

__all__ = [
    'norm', 't', 'chi2', 'f', 'beta', 'binom',
    'multivariate_normal', 'multivariate_t', 'MVT',
    'betaincinv', 'gammaincinv',
]


def _device(params, device):
    """The device of the first tensor among ``params``, else ``device`` (the
    card when None)."""
    for p in params:
        if isinstance(p, torch.Tensor):
            return p.device
    return resolve_device(default_device() if device is None else device)


def _param(v, device):
    """A parameter as a floating tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        v = v.to(device)
        return v.to(result_dtype(v.dtype))
    return torch.as_tensor(np.asarray(v, dtype=float), dtype=default_dtype(),
                           device=device)


def _host_scalar(v):
    """The Python float of a scalar parameter (a number, a 0-d numpy array
    or a 0-d tensor), else None (array-valued).  Normalizers of scalar
    parameters are evaluated on the host in float64."""
    if isinstance(v, (int, float, np.floating, np.integer)):
        return float(v)
    if isinstance(v, torch.Tensor):
        return float(v.item()) if v.ndim == 0 else None
    if np.ndim(v) == 0:
        return float(np.asarray(v))
    return None


def _log_c(t, host):
    """``log`` of a parameter: the host number where it is a scalar
    (``host``, from :func:`_host_scalar`), a tensor operation otherwise."""
    return math.log(host) if host is not None else torch.log(t)


def _shape(size):
    return (size,) if np.isscalar(size) else tuple(size)


def _gamma(alpha, shape, gen):
    """Standard gamma draws of the given shape, ``alpha`` broadcast to it."""
    return torch._standard_gamma(alpha.expand(shape).contiguous(),
                                 generator=gen)


class _Frozen:
    """Base frozen distribution: interval, median and the rest in terms of
    ppf and cdf."""

    random_state = 0

    def __init__(self, device, **params):
        self.device = _device(params.values(), device)
        self._host = {}
        for name, v in params.items():
            self._host[name] = _host_scalar(v)
            setattr(self, name, _param(v, self.device))

    def _x(self, x):
        """Points as a tensor on the distribution's device, in the promoted
        float type."""
        return _param(x, self.device)

    def _rng(self, random_state):
        return _generator(self.random_state if random_state is None
                          else random_state, self.device)

    def _base(self, *params):
        return torch.broadcast_shapes(*(p.shape for p in params))

    def interval(self, confidence):
        confidence = self._x(confidence)
        q = (1.0 - confidence) / 2.0
        return self.ppf(q), self.ppf(1.0 - q)

    def median(self):
        return self.ppf(0.5)

    def support(self):
        return self.ppf(0.0), self.ppf(1.0)

    def logpdf(self, x):
        return torch.log(self.pdf(x))

    def sf(self, x):
        return 1.0 - self.cdf(x)

    def var(self):
        return self.std() ** 2


def _squeeze(out, size):
    return torch.squeeze(out) if size == 1 else out


# ----------------------------------------------------------------------
# Normal
# ----------------------------------------------------------------------
class _FrozenNorm(_Frozen):
    def __init__(self, loc=0.0, scale=1.0, device=None):
        super().__init__(device, loc=loc, scale=scale)

    def _z(self, x):
        return (self._x(x) - self.loc) / self.scale

    def pdf(self, x):
        z = self._z(x)
        return torch.exp(-0.5 * z * z) / (_SQRT_2PI * self.scale)

    def logpdf(self, x):
        z = self._z(x)
        return -0.5 * z * z - torch.log(_SQRT_2PI * self.scale)

    def cdf(self, x):
        return torch.special.ndtr(self._z(x))

    def ppf(self, q):
        return self.loc + self.scale * torch.special.ndtri(self._x(q))

    def mean(self):
        return self.loc.expand(self._base(self.loc, self.scale))

    def std(self):
        return self.scale.expand(self._base(self.loc, self.scale))

    def rvs(self, size=1, random_state=None):
        gen = self._rng(random_state)
        z = torch.randn(_shape(size) + self._base(self.loc, self.scale),
                        generator=gen, dtype=default_dtype(),
                        device=self.device)
        return _squeeze(self.loc + self.scale * z, size)


class _NormFamily:
    def __call__(self, loc=0.0, scale=1.0, device=None):
        return _FrozenNorm(loc, scale, device)

    def pdf(self, x, loc=0.0, scale=1.0, device=None):
        return _FrozenNorm(loc, scale, device).pdf(x)

    def logpdf(self, x, loc=0.0, scale=1.0, device=None):
        return _FrozenNorm(loc, scale, device).logpdf(x)

    def cdf(self, x, loc=0.0, scale=1.0, device=None):
        return _FrozenNorm(loc, scale, device).cdf(x)

    def ppf(self, q, loc=0.0, scale=1.0, device=None):
        return _FrozenNorm(loc, scale, device).ppf(q)


norm = _NormFamily()


# ----------------------------------------------------------------------
# Student-t
# ----------------------------------------------------------------------
class _FrozenT(_Frozen):
    def __init__(self, df, loc=0.0, scale=1.0, device=None):
        super().__init__(device, df=df, loc=loc, scale=scale)

    def _z(self, x):
        return (self._x(x) - self.loc) / self.scale

    def logpdf(self, x):
        z = self._z(x)
        df = self.df
        dfh = self._host['df']
        if dfh is not None:
            const = float(_gammaln_host((dfh + 1) / 2.)
                          - _gammaln_host(dfh / 2.)
                          - 0.5 * np.log(dfh * np.pi))
        else:
            const = torch.lgamma((df + 1) / 2) - torch.lgamma(df / 2) \
                - 0.5 * torch.log(df * math.pi)
        lognorm = const - _log_c(self.scale, self._host['scale'])
        return lognorm - (df + 1) / 2 * torch.log1p(z * z / df)

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def cdf(self, x):
        z = self._z(x)
        df = self.df
        w = df / (df + z * z)
        tail = 0.5 * betainc(df / 2.0, 0.5, w)
        return torch.where(z > 0, 1.0 - tail, tail)

    def ppf(self, q):
        q = self._x(q)
        df = self.df
        qq = torch.where(q < 0.5, q, 1.0 - q)
        w = betaincinv(df / 2.0, 0.5, 2.0 * qq)
        mag = torch.sqrt(df * (1.0 - w)
                         / torch.clamp(w, min=torch.finfo(w.dtype).tiny))
        z = torch.where(q < 0.5, -mag, mag)
        z = torch.where(q == 0.5, 0.0, z)
        return self.loc + self.scale * z

    def mean(self):
        return self.loc.expand(self._base(self.df, self.loc, self.scale))

    def std(self):
        df = self.df
        s = torch.sqrt(df / (df - 2.0))
        s = torch.where(df > 2, s, float('inf'))
        return (self.scale * s).expand(self._base(self.df, self.loc,
                                                  self.scale))

    def rvs(self, size=1, random_state=None):
        gen = self._rng(random_state)
        shape = _shape(size) + self._base(self.df, self.loc, self.scale)
        z = torch.randn(shape, generator=gen, dtype=default_dtype(),
                        device=self.device)
        g = 2.0 * _gamma(self.df / 2.0, shape, gen)      # χ²(df)
        out = self.loc + self.scale * z / torch.sqrt(g / self.df)
        return _squeeze(out, size)


class _TFamily:
    def __call__(self, df, loc=0.0, scale=1.0, device=None):
        return _FrozenT(df, loc, scale, device)

    def pdf(self, x, df, loc=0.0, scale=1.0, device=None):
        return _FrozenT(df, loc, scale, device).pdf(x)

    def logpdf(self, x, df, loc=0.0, scale=1.0, device=None):
        return _FrozenT(df, loc, scale, device).logpdf(x)

    def cdf(self, x, df, loc=0.0, scale=1.0, device=None):
        return _FrozenT(df, loc, scale, device).cdf(x)

    def ppf(self, q, df, loc=0.0, scale=1.0, device=None):
        return _FrozenT(df, loc, scale, device).ppf(q)


t = _TFamily()


# ----------------------------------------------------------------------
# Chi-squared
# ----------------------------------------------------------------------
class _FrozenChi2(_Frozen):
    def __init__(self, df, loc=0.0, scale=1.0, device=None):
        super().__init__(device, df=df, loc=loc, scale=scale)

    def _z(self, x):
        return (self._x(x) - self.loc) / self.scale

    def logpdf(self, x):
        z = self._z(x)
        k2 = self.df / 2.0
        dfh = self._host['df']
        if dfh is not None:
            k2h = dfh / 2.0
            const = float(_gammaln_host(k2h) + k2h * np.log(2.0))
        else:
            const = torch.lgamma(k2) + k2 * math.log(2.0)
        lp = (k2 - 1) * torch.log(z) - z / 2 - const
        lp = torch.where(z > 0, lp, -float('inf'))
        return lp - _log_c(self.scale, self._host['scale'])

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def cdf(self, x):
        z = self._z(x)
        return torch.where(z > 0, torch.special.gammainc(self.df / 2.0,
                                                         z / 2.0), 0.0)

    def ppf(self, q):
        return self.loc + self.scale * 2.0 * gammaincinv(self.df / 2.0,
                                                         self._x(q))

    def mean(self):
        return self.loc + self.scale * self.df

    def std(self):
        return self.scale * torch.sqrt(2.0 * self.df)

    def rvs(self, size=1, random_state=None):
        gen = self._rng(random_state)
        shape = _shape(size) + self._base(self.df, self.loc, self.scale)
        z = 2.0 * _gamma(self.df / 2.0, shape, gen)
        return _squeeze(self.loc + self.scale * z, size)


class _Chi2Family:
    def __call__(self, df, loc=0.0, scale=1.0, device=None):
        return _FrozenChi2(df, loc, scale, device)

    def pdf(self, x, df, loc=0.0, scale=1.0, device=None):
        return _FrozenChi2(df, loc, scale, device).pdf(x)

    def cdf(self, x, df, loc=0.0, scale=1.0, device=None):
        return _FrozenChi2(df, loc, scale, device).cdf(x)

    def ppf(self, q, df, loc=0.0, scale=1.0, device=None):
        return _FrozenChi2(df, loc, scale, device).ppf(q)


chi2 = _Chi2Family()


# ----------------------------------------------------------------------
# F distribution
# ----------------------------------------------------------------------
class _FrozenF(_Frozen):
    def __init__(self, dfn, dfd, loc=0.0, scale=1.0, device=None):
        super().__init__(device, dfn=dfn, dfd=dfd, loc=loc, scale=scale)

    def _z(self, x):
        return (self._x(x) - self.loc) / self.scale

    def logpdf(self, x):
        z = self._z(x)
        d1, d2 = self.dfn, self.dfd
        d1h, d2h = self._host['dfn'], self._host['dfd']
        if d1h is not None and d2h is not None:
            const = float((d1h / 2) * np.log(d1h) + (d2h / 2) * np.log(d2h)
                          - _betaln_host(d1h / 2, d2h / 2))
        else:
            const = (d1 / 2) * torch.log(d1) + (d2 / 2) * torch.log(d2) \
                - betaln(d1 / 2, d2 / 2)
        lp = const + (d1 / 2 - 1) * torch.log(z) \
            - ((d1 + d2) / 2) * torch.log(d2 + d1 * z)
        lp = torch.where(z > 0, lp, -float('inf'))
        return lp - _log_c(self.scale, self._host['scale'])

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def cdf(self, x):
        z = self._z(x)
        d1, d2 = self.dfn, self.dfd
        w = d1 * z / (d1 * z + d2)
        return torch.where(z > 0, betainc(d1 / 2, d2 / 2, w), 0.0)

    def ppf(self, q):
        d1, d2 = self.dfn, self.dfd
        w = betaincinv(d1 / 2, d2 / 2, self._x(q))
        z = d2 * w / (d1 * torch.clamp(1.0 - w,
                                       min=torch.finfo(w.dtype).tiny))
        return self.loc + self.scale * z

    def mean(self):
        d2 = self.dfd
        m = torch.where(d2 > 2, d2 / (d2 - 2.0), float('inf'))
        return self.loc + self.scale * m

    def std(self):
        d1, d2 = self.dfn, self.dfd
        num = 2.0 * d2 ** 2 * (d1 + d2 - 2.0)
        den = d1 * (d2 - 2.0) ** 2 * (d2 - 4.0)
        v = torch.where(d2 > 4, num / den, float('inf'))
        return self.scale * torch.sqrt(v)

    def rvs(self, size=1, random_state=None):
        gen = self._rng(random_state)
        shape = _shape(size) + self._base(self.dfn, self.dfd, self.loc,
                                          self.scale)
        u1 = 2.0 * _gamma(self.dfn / 2.0, shape, gen)
        u2 = 2.0 * _gamma(self.dfd / 2.0, shape, gen)
        z = (u1 / self.dfn) / (u2 / self.dfd)
        return _squeeze(self.loc + self.scale * z, size)


class _FFamily:
    def __call__(self, dfn, dfd, loc=0.0, scale=1.0, device=None):
        return _FrozenF(dfn, dfd, loc, scale, device)


f = _FFamily()


# ----------------------------------------------------------------------
# Beta
# ----------------------------------------------------------------------
class _FrozenBeta(_Frozen):
    def __init__(self, a, b, device=None):
        super().__init__(device, a=a, b=b)

    def logpdf(self, x):
        x = self._x(x)
        ah, bh = self._host['a'], self._host['b']
        if ah is not None and bh is not None:
            bln = float(_betaln_host(ah, bh))
        else:
            bln = betaln(self.a, self.b)
        lp = (self.a - 1) * torch.log(x) + (self.b - 1) * torch.log1p(-x) \
            - bln
        return torch.where((x >= 0) & (x <= 1), lp, -float('inf'))

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def cdf(self, x):
        return betainc(self.a, self.b, torch.clamp(self._x(x), 0.0, 1.0))

    def ppf(self, q):
        return betaincinv(self.a, self.b, self._x(q))

    def mean(self):
        return self.a / (self.a + self.b)

    def std(self):
        ab = self.a + self.b
        return torch.sqrt(self.a * self.b / (ab * ab * (ab + 1.0)))

    def rvs(self, size=1, random_state=None):
        gen = self._rng(random_state)
        shape = _shape(size) + self._base(self.a, self.b)
        ga = _gamma(self.a, shape, gen)
        gb = _gamma(self.b, shape, gen)
        return _squeeze(ga / (ga + gb), size)


class _BetaFamily:
    def __call__(self, a, b, device=None):
        return _FrozenBeta(a, b, device)

    def pdf(self, x, a, b, device=None):
        return _FrozenBeta(a, b, device).pdf(x)

    def cdf(self, x, a, b, device=None):
        return _FrozenBeta(a, b, device).cdf(x)

    def ppf(self, q, a, b, device=None):
        return _FrozenBeta(a, b, device).ppf(q)


beta = _BetaFamily()


# ----------------------------------------------------------------------
# Binomial
# ----------------------------------------------------------------------
class _FrozenBinom(_Frozen):
    """Binomial(n, p).  ``n`` is a Python integer, so the quantile's table
    has a fixed number of rows."""

    def __init__(self, n, p, device=None):
        super().__init__(device, p=p)
        self.n = int(n)

    def logpmf(self, k):
        k = self._x(k)
        n = self.n
        ph = self._host['p']
        logp = math.log(ph) if ph is not None else torch.log(self.p)
        log1mp = math.log1p(-ph) if ph is not None else torch.log1p(-self.p)
        return (float(_gammaln_host(n + 1.0)) - torch.lgamma(k + 1.0)
                - torch.lgamma(n - k + 1.0) + k * logp + (n - k) * log1mp)

    def pmf(self, k):
        return torch.exp(self.logpmf(k))

    def cdf(self, k):
        k = torch.floor(self._x(k))
        # I_{1-p}(n-k, k+1), the regularized-beta identity
        kk = torch.clamp(k, 0, self.n)
        val = betainc(self.n - kk, kk + 1.0, 1.0 - self.p)
        val = torch.where(kk >= self.n, 1.0, val)
        return torch.where(k < 0, 0.0, val)

    def ppf(self, q):
        """Smallest k with cdf(k) >= q (scipy's convention; ppf(0) = -1),
        from an (n + 1)-row table of the cdf."""
        q = self._x(q)
        p = self.p
        ks = torch.arange(self.n + 1, dtype=p.dtype, device=self.device)
        ks_col = ks.reshape((-1,) + (1,) * p.ndim)
        cdf = betainc(self.n - ks_col, ks_col + 1.0, 1.0 - p)
        cdf[-1] = 1.0
        out_shape = torch.broadcast_shapes(q.shape, p.shape)
        qb = q.expand(out_shape)
        cdf = cdf.reshape((self.n + 1,) + (1,) * (len(out_shape) - p.ndim)
                          + p.shape)
        # round-off at the jumps, as scipy allows it
        meets = cdf >= qb - 1e-12
        idx = torch.argmax(meets.to(torch.uint8), dim=0).to(p.dtype)
        return torch.where(qb <= 0, -1.0, idx)

    def interval(self, confidence):
        confidence = self._x(confidence)
        qlo = (1.0 - confidence) / 2.0
        qhi = 1.0 - qlo
        return self.ppf(qlo), self.ppf(qhi)

    def mean(self):
        return self.n * self.p

    def std(self):
        return torch.sqrt(self.n * self.p * (1.0 - self.p))

    def rvs(self, size=1, random_state=None):
        gen = self._rng(random_state)
        shape = _shape(size) + self.p.shape
        count = torch.full(shape, float(self.n), dtype=self.p.dtype,
                           device=self.device)
        out = torch.binomial(count, self.p.expand(shape).contiguous(),
                             generator=gen)
        return _squeeze(out, size)


class _BinomFamily:
    def __call__(self, n, p, device=None):
        return _FrozenBinom(n, p, device)


binom = _BinomFamily()


# ----------------------------------------------------------------------
# Multivariate normal
# ----------------------------------------------------------------------
def _chol_logdet_maha(chol, diff):
    """Mahalanobis distances of the rows of ``diff`` and log|Σ| from the
    lower Cholesky factor of Σ."""
    w = torch.linalg.solve_triangular(
        chol, torch.atleast_2d(diff).mT, upper=False).mT
    maha = torch.sum(w * w, dim=-1)
    if diff.ndim == 1:
        maha = maha[0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return maha, logdet


class _FrozenMVN:
    def __init__(self, mean, cov, allow_singular=False, jitter=0.0,
                 device=None):
        from ..linalg import cholesky

        dev = _device((mean, cov), device)
        self.device = dev
        self.mean = torch.atleast_1d(_param(mean, dev))
        self.cov = torch.atleast_2d(_param(cov, dev))
        self.dim = self.mean.shape[0]
        self._jitter = jitter
        self._chol = cholesky(self.cov + jitter * torch.eye(
            self.dim, dtype=self.cov.dtype, device=dev))
        self.random_state = 0

    def logpdf(self, x):
        diff = _param(x, self.device) - self.mean
        maha, logdet = _chol_logdet_maha(self._chol, diff)
        return -0.5 * (self.dim * _LOG_2PI + logdet + maha)

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def rvs(self, size=1, random_state=None):
        gen = _generator(self.random_state if random_state is None
                         else random_state, self.device)
        z = torch.randn(_shape(size) + (self.dim,), generator=gen,
                        dtype=self._chol.dtype, device=self.device)
        return _squeeze(self.mean + z @ self._chol.mT, size)


class _MVNFamily:
    def __call__(self, mean, cov, allow_singular=False, device=None):
        jitter = 1e-12 if allow_singular else 0.0
        return _FrozenMVN(mean, cov, allow_singular, jitter=jitter,
                          device=device)

    def logpdf(self, x, mean, cov, device=None):
        return _FrozenMVN(mean, cov, device=device).logpdf(x)

    def rvs(self, mean, cov, size=1, random_state=None, device=None):
        return _FrozenMVN(mean, cov, device=device).rvs(size, random_state)


multivariate_normal = _MVNFamily()


# ----------------------------------------------------------------------
# Multivariate t
# ----------------------------------------------------------------------
class _FrozenMVT:
    R"""Multivariate Student-t with scale matrix ``sigma`` and ``df``.

    The covariance is ``sigma * df / (df - 2)``, statsmodels' convention.
    """

    def __init__(self, mean, sigma, df, device=None):
        from ..linalg import cholesky

        dev = _device((mean, sigma), device)
        self.device = dev
        self.mean = torch.atleast_1d(_param(mean, dev))
        self.sigma = torch.atleast_2d(_param(sigma, dev))
        self.df = df
        self._dfh = _host_scalar(df)
        self.dim = self.mean.shape[0]
        self._chol = cholesky(self.sigma)
        self.random_state = 0

    def logpdf(self, x):
        d, df = self.dim, self.df
        maha, logdet = _chol_logdet_maha(self._chol,
                                         _param(x, self.device) - self.mean)
        dfh = self._dfh
        if dfh is not None:
            const = float(_gammaln_host((dfh + d) / 2.0)
                          - _gammaln_host(dfh / 2.0)
                          - 0.5 * d * np.log(dfh * np.pi))
        else:
            df = _param(df, self.device)
            const = (torch.lgamma((df + d) / 2.0) - torch.lgamma(df / 2.0)
                     - 0.5 * d * torch.log(df * math.pi))
        return (const - 0.5 * logdet
                - (df + d) / 2.0 * torch.log1p(maha / df))

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def cov(self):
        return self.sigma * self.df / (self.df - 2.0)

    def rvs(self, size=1, random_state=None):
        gen = _generator(self.random_state if random_state is None
                         else random_state, self.device)
        shape = _shape(size)
        dt = self._chol.dtype
        z = torch.randn(shape + (self.dim,), generator=gen, dtype=dt,
                        device=self.device)
        df = _param(self.df, self.device)
        g = 2.0 * _gamma(df / 2.0, shape, gen)            # χ²(df)
        scale = torch.sqrt(df / g)[..., None]
        out = self.mean + scale * (z @ self._chol.mT)
        return _squeeze(out, size)


class _MVTFamily:
    def __call__(self, mean, sigma, df, device=None):
        return _FrozenMVT(mean, sigma, df, device)


multivariate_t = _MVTFamily()
MVT = _FrozenMVT
