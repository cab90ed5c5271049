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

Not ported yet (ROADMAP.md queue A, the statistics slice): ``predictions``,
``hpd``, ``hpd_pdf``, ``median_pdf``, ``kl_gauss``, ``general_sqrt_errors``,
the decorators and ``VariogramFourthRoot``.
"""
from __future__ import annotations

import numpy as np
import torch

from ._config import as_input, default_dtype, device_constant
from .linalg import (  # noqa: F401  (re-exported, as the JAX module does)
    cholesky, cholesky_errors, mahalanobis, pivoted_cholesky, spd_logdet,
    stabilize)

__all__ = [
    'cartesian', 'toy_data', 'coefficients', 'partials', 'stabilize',
    'geometric_sum', 'gaussian', 'rbf', 'cholesky_errors', 'mahalanobis',
    'pivoted_cholesky', 'spd_logdet', 'generate_coefficients',
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
