R"""Regularized incomplete beta function, its inverse, and the inverse of the
regularized lower incomplete gamma function (counterpart of
``gsum_tpu/stats/_special.py``, with ``betainc`` itself, which the JAX
package takes from ``jax.scipy.special``).

``torch.special`` has ``gammainc`` but no ``betainc``, so :func:`betainc_plain`
writes out the algorithm of XLA's ``betainc``
(``jax._src.lax.special.regularized_incomplete_beta_impl``):

- the symmetry swap ``I_x(a, b) = 1 - I_{1-x}(b, a)`` where
  ``x >= (a + 1) / (a + b + 2)``, so that the continued fraction converges
  fast (DLMF 8.17.E23, 8.17.E4);
- the continued fraction with the partial numerators of DLMF 8.17.22,
  evaluated by the Lentz-Thompson-Barnett algorithm with ``tiny`` and the
  convergence threshold both ``eps / 2`` and at most 200 (float32) or 600
  (float64) terms;
- the prefactor ``exp(a log x + b log1p(-x) - log B(a, b)) / a``, with
  ``a Γ(a) = Γ(a + 1)`` where ``a`` is below twice the smallest normal;
- XLA's values at the edges: ``a = 0`` or ``b = ∞`` gives 1 (0 at
  ``x = 0``), ``b = 0`` or ``a = ∞`` gives 0 (1 at ``x = 1``), and NaN for
  a NaN argument, a negative ``a`` or ``b``, ``x`` outside [0, 1], or both
  ``a`` and ``b`` "zero".

One departure: XLA stops the continued fraction at the first term where
every element of the array has converged, so an element's value depends on
the others beside it (later terms still move a converged element by
rounding, up to 2e-13 relative on the t quantile's arguments).  Here each
element keeps its value from its own first converged term, which is what
the CUDA kernel's threads do, so the two agree and a value does not depend
on its batch.  The plain version checks on the host every
``CF_CHECK_EVERY`` (8) terms whether all elements have converged.

:func:`betaincinv` and :func:`gammaincinv` keep the JAX package's initial
guesses and its bracketed Newton iteration with a bisection fallback, 50
and 60 steps.  The Newton iteration's state ``(x, lo, hi)`` is a function of
itself alone, so the plain version stops as soon as a step leaves all of it
unchanged: every later step would too, and the result is the 50th step's.

On the card :func:`betainc` and :func:`betaincinv` launch the CUDA kernels
of ``ops.incbeta`` (one thread per element runs the whole loop in
registers); on the CPU they run the plain versions here.  ``gammaincinv``
stays plain PyTorch on both devices, on ``torch.special.gammainc``.  No
caller in the library differentiates through these functions.

Argument types follow JAX's promotion: tensors promote among themselves,
Python and numpy scalars are weak and take the tensors' type; with no
floating tensor among the arguments the result is float64.  Tensors keep
their device; with no tensor among the arguments the result is on
:func:`~gsum_tpu_torch._config.default_device`.
"""
from __future__ import annotations

import functools

import torch

from .._config import default_device, default_dtype, resolve_device

__all__ = ['betainc', 'betaincinv', 'gammaincinv', 'betaln', 'betainc_plain',
           'betaincinv_plain', 'CF_CHECK_EVERY']

CF_CHECK_EVERY = 8     # terms of the continued fraction between host checks


def _broadcast(*args, device=None):
    """The arguments as tensors of one shape, dtype and device (see the
    module's docstring for the promotion rule)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
    else:
        dev = resolve_device(default_device() if device is None else device)
    floats = [t.dtype for t in tensors if t.is_floating_point()]
    dtype = (functools.reduce(torch.promote_types, floats) if floats
             else default_dtype())
    out = [a.to(device=dev, dtype=dtype) if isinstance(a, torch.Tensor)
           else torch.as_tensor(a, dtype=dtype, device=dev) for a in args]
    return [t.contiguous() for t in torch.broadcast_tensors(*out)]


def betaln(a, b):
    """``log B(a, b) = lgamma(a) + lgamma(b) - lgamma(a + b)``."""
    a, b = _broadcast(a, b)
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _numerator(n, a, b, x, ab):
    """The n-th partial numerator (n >= 1) of the continued fraction, as
    XLA writes it; ``ab = a + b``."""
    if n == 1:
        return torch.ones_like(x)
    m = float((n - 1) // 2)
    if n % 2 == 0:
        if m == 0:
            return -ab * x / (a + 1)
        return -(a + m) * (ab + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
    return m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))


def _continued_fraction(a, b, x):
    """Lentz-Thompson-Barnett evaluation of the continued fraction of
    ``I_x(a, b)`` (without its prefactor) over same-shape tensors."""
    dtype = x.dtype
    eps = torch.finfo(dtype).eps
    small = thresh = eps / 2
    n_terms = 200 if dtype == torch.float32 else 600
    ab = a + b
    h = torch.full_like(x, small)        # the 0-th partial denominator is 0
    c = h
    d = torch.zeros_like(x)
    done = torch.zeros_like(x, dtype=torch.bool)
    n = 1
    while n < n_terms:
        stop = min(n + CF_CHECK_EVERY, n_terms)
        for n in range(n, stop):
            num = _numerator(n, a, b, x, ab)
            c = 1 + num / c
            c = torch.where(torch.abs(c) < small, small, c)
            d = 1 + num * d
            d = torch.where(torch.abs(d) < small, small, d)
            d = torch.reciprocal(d)
            delta = c * d
            h = torch.where(done, h, h * delta)
            # NaN counts as converged, as in XLA
            done = done | ~(torch.abs(delta - 1) >= thresh)
        n = stop
        if bool(torch.all(done)):
            break
    return h


def betainc_plain(a, b, x):
    R"""Plain PyTorch version of :func:`betainc` over same-shape, same-dtype
    tensors: XLA's algorithm, step by step (see the module's docstring)."""
    inf = float('inf')
    a_is_zero = (a == 0) | (b == inf)
    b_is_zero = (b == 0) | (a == inf)
    x_is_zero = x == 0
    x_is_one = x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = (a < 0) | (b < 0) | (x < 0) | (x > 1) \
        | (a_is_zero & b_is_zero) | is_nan

    converges = x < (a + 1) / (a + b + 2)
    a, b = torch.where(converges, a, b), torch.where(converges, b, a)
    x = torch.where(converges, x, 1 - x)

    cf = _continued_fraction(a, b, x)
    very_small = torch.finfo(x.dtype).tiny * 2
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    factor = torch.where(
        a < very_small, torch.exp(torch.log1p(-x) * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a)
    result = cf * factor
    result = torch.where(converges, result, 1 - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, float('nan'), result)


def betainc(a, b, x):
    R"""Regularized incomplete beta function :math:`I_x(a, b)`.

    The CUDA kernel ``ops.incbeta.betainc`` on the card, :func:`betainc_plain`
    on the CPU; both follow XLA's algorithm.
    """
    from ..ops.incbeta import betainc as kernel

    return kernel(*_broadcast(a, b, x))


def _ndtri_approx(p):
    """Rational approximation to the normal quantile used as an initial
    guess (Abramowitz & Stegun 26.2.23); only ~3 digits are needed."""
    pp = torch.where(p < 0.5, p, 1.0 - p)
    pp = torch.clamp(pp, 1e-300, 0.5)
    t = torch.sqrt(-2.0 * torch.log(pp))
    x = (2.30753 + t * 0.27061) / (1.0 + t * (0.99229 + t * 0.04481)) - t
    return torch.where(p < 0.5, -x, x)


def _betaincinv_start(a, b, p):
    """The JAX package's initial guess of :func:`betaincinv`: the normal
    approximation of A&S 26.5.22 where a, b >= 1, the tail expansion
    elsewhere."""
    y_p = -_ndtri_approx(p)
    al = (y_p ** 2 - 3.0) / 6.0
    h = 2.0 / (1.0 / (2.0 * a - 1.0) + 1.0 / (2.0 * b - 1.0))
    w = (y_p * torch.sqrt(al + h) / h
         - (1.0 / (2.0 * b - 1.0) - 1.0 / (2.0 * a - 1.0))
         * (al + 5.0 / 6.0 - 2.0 / (3.0 * h)))
    x_big = a / (a + b * torch.exp(2.0 * w))

    lna = torch.log(a / (a + b))
    lnb = torch.log(b / (a + b))
    t_ = torch.exp(a * lna) / a
    u_ = torch.exp(b * lnb) / b
    w_ = t_ + u_
    x_small = torch.where(p < t_ / w_, (a * w_ * p) ** (1.0 / a),
                          1.0 - (b * w_ * (1.0 - p)) ** (1.0 / b))
    x0 = torch.where((a >= 1.0) & (b >= 1.0), x_big, x_small)
    return torch.clamp(x0, torch.finfo(p.dtype).tiny, 1.0 - 1e-15)


def _domain(x, p, at_one):
    """The edge values of an inverse: 0 at p = 0, ``at_one`` at p = 1, NaN
    for p outside [0, 1] (scipy's convention)."""
    x = torch.where(p == 0.0, 0.0, x)
    x = torch.where(p == 1.0, at_one, x)
    return torch.where((p < 0.0) | (p > 1.0), float('nan'), x)


def _unchanged(old, new):
    return all(torch.equal(torch.nan_to_num(u, 0.5), torch.nan_to_num(v, 0.5))
               and torch.equal(torch.isnan(u), torch.isnan(v))
               for u, v in zip(old, new))


def betaincinv_plain(a, b, p):
    R"""Plain PyTorch version of :func:`betaincinv` over same-shape,
    same-dtype tensors."""
    a1 = a - 1.0
    b1 = b - 1.0
    x = _betaincinv_start(a, b, p)
    afac = -torch.lgamma(a) - torch.lgamma(b) + torch.lgamma(a + b)
    lo = torch.zeros_like(x)
    hi = torch.ones_like(x)
    # bracketed Newton: betainc is increasing in x, so err < 0 raises the
    # lower bracket and err > 0 lowers the upper; a step that leaves the
    # bracket bisects it instead
    for _ in range(50):
        err = betainc_plain(a, b, x) - p
        lo_n = torch.where(err < 0.0, torch.maximum(lo, x), lo)
        hi_n = torch.where(err > 0.0, torch.minimum(hi, x), hi)
        t = torch.exp(a1 * torch.log(x) + b1 * torch.log1p(-x) + afac)
        newton = x - torch.where(t > 0, err / t, 0.0)
        good = torch.isfinite(newton) & (newton > lo_n) & (newton < hi_n)
        x_n = torch.where(good, newton, 0.5 * (lo_n + hi_n))
        if _unchanged((x, lo, hi), (x_n, lo_n, hi_n)):
            break
        x, lo, hi = x_n, lo_n, hi_n
    return _domain(x, p, 1.0)


def betaincinv(a, b, p):
    R"""Inverse of the regularized incomplete beta function: the x in
    [0, 1] with ``betainc(a, b, x) = p``.

    The CUDA kernel ``ops.incbeta.betaincinv`` on the card,
    :func:`betaincinv_plain` on the CPU.
    """
    from ..ops.incbeta import betaincinv as kernel

    return kernel(*_broadcast(a, b, p))


def gammaincinv(a, p):
    R"""Inverse of the regularized lower incomplete gamma function: the
    x >= 0 with ``gammainc(a, x) = p``.  Plain PyTorch on both devices (on
    ``torch.special.gammainc``)."""
    a, p = _broadcast(a, p)
    a1 = a - 1.0
    gln = torch.lgamma(a)

    # a > 1: Wilson-Hilferty with the upper-tail deviate y_p = -ndtri(p)
    y_p = -_ndtri_approx(p)
    x_big = torch.clamp(
        a * (1.0 - 1.0 / (9.0 * a) - y_p / (3.0 * torch.sqrt(a))) ** 3,
        min=1e-3)
    # a <= 1: series-based guess
    t_ = 1.0 - a * (0.253 + a * 0.12)
    x_small = torch.where(
        p < t_, (p / torch.clamp(t_, min=1e-30)) ** (1.0 / a),
        1.0 - torch.log1p(-(p - t_) / torch.clamp(1.0 - t_, min=1e-30)))
    x = torch.where(a > 1.0, x_big, x_small)
    x = torch.clamp(x, min=torch.finfo(x.dtype).tiny)

    # bracketed Newton on the increasing gammainc(a, .); until an x with
    # err > 0 is seen the upper bracket is open, and a step out of the
    # bracket grows x geometrically instead of bisecting
    lo = torch.zeros_like(x)
    hi = torch.full_like(x, float('inf'))
    for _ in range(60):
        err = torch.special.gammainc(a, x) - p
        lo = torch.where(err < 0.0, torch.maximum(lo, x), lo)
        hi = torch.where(err > 0.0, torch.minimum(hi, x), hi)
        t = torch.exp(-x + a1 * torch.log(x) - gln)   # Gamma(a, 1) pdf
        newton = x - torch.where(t > 0, err / t, 0.0)
        good = torch.isfinite(newton) & (newton > lo) & (newton < hi)
        fallback = torch.where(torch.isfinite(hi), 0.5 * (lo + hi),
                               2.0 * x + 1.0)
        x = torch.where(good, newton, fallback)
    return _domain(x, p, float('inf'))
