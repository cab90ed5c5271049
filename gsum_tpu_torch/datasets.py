R"""Synthetic partial-sum datasets in the scikit-learn ``make_*`` idiom
(counterpart of ``gsum_tpu/datasets.py``).

Draws come from ``torch.Generator``s: ``random_state`` is an int seed, a
generator, or None (a fresh seed).  They differ from the JAX package's at
equal seeds (another generator); the distributions are the same.  Data are
made on the device of X, or for the uniform and grid generators on
``device`` (the generator's device when one is given, else the CUDA card).
"""
from __future__ import annotations

import numpy as np
import torch

from ._config import default_device, default_dtype, resolve_device
from .helpers import _float, _generator, cartesian, partials
from .kernels import RBF
from .linalg import cholesky

__all__ = [
    'make_gaussian_partial_sums',
    'make_gaussian_partial_sums_uniform',
    'make_gaussian_partial_sums_on_grid',
]


def _device(random_state, device):
    if device is not None:
        return resolve_device(device)
    if isinstance(random_state, torch.Generator):
        return random_state.device
    return resolve_device(default_device())


def _two_generators(random_state, device):
    """Generators for X and for y: two seeds spawned from an int (or a fresh)
    seed, or the given generator for both, one draw after the other."""
    if isinstance(random_state, torch.Generator):
        return random_state, random_state
    seeds = np.random.SeedSequence(random_state).spawn(2)
    return tuple(_generator(int(s.generate_state(1, np.uint64)[0] >> np.uint64(1)),
                           device) for s in seeds)


def make_gaussian_partial_sums(X, orders=5, kernel=None, mean=None, ratio=0.3,
                               ref=1., nugget=0, random_state=0,
                               allow_singular=True):
    R"""Gaussian partial sums sampled at input points X.

    Parameters
    ----------
    X : (n_samples, n_features) tensor or array
    orders : int or array — the orders included in the partial sum
    kernel : callable, optional — defaults to ``RBF(0.5)``
    mean : callable, optional — mean function of the coefficients
    ratio, ref : float or callable
    nugget : float — diagonal jitter on the coefficient covariance
    random_state : int, ``torch.Generator`` on X's device, or None
    allow_singular : bool — adds a tiny jitter so singular covariances sample

    Returns
    -------
    y : (n_samples, n_orders) tensor of partial sums
    """
    X = torch.atleast_2d(_float(X))
    if kernel is None:
        kernel = RBF(0.5)
    if mean is None:
        def mean(a):
            return torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)

    if isinstance(orders, (int, np.integer)):
        orders = np.arange(orders)
    orders = np.asarray(orders)
    if callable(ratio):
        ratio = ratio(X)
    if callable(ref):
        ref = ref(X)

    m = mean(X)
    K = kernel(X)
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    K = K + nugget * eye
    if allow_singular:
        K = K + 1e-10 * eye

    gen = _generator(random_state, K.device)
    L = cholesky(K)
    z = torch.randn((len(orders), K.shape[0]), generator=gen, dtype=K.dtype,
                    device=K.device)
    coeffs = (m + z @ L.mT).mT
    return partials(coeffs=coeffs, ratio=ratio, ref=ref, orders=orders)


def make_gaussian_partial_sums_uniform(n_samples=100, n_features=1, orders=5,
                                       kernel=None, mean=None, ratio=0.3,
                                       ref=1., nugget=0, random_state=0,
                                       allow_singular=True, device=None):
    R"""Partial sums at uniform-random inputs in [0, 1]^d; X and y come from
    two generators spawned from ``random_state``.  Returns ``(X, y)``."""
    device = _device(random_state, device)
    gx, gy = _two_generators(random_state, device)
    X = torch.rand((n_samples, n_features), generator=gx, dtype=default_dtype(),
                   device=device)
    y = make_gaussian_partial_sums(
        X=X, orders=orders, kernel=kernel, mean=mean, ratio=ratio, ref=ref,
        nugget=nugget, random_state=gy, allow_singular=allow_singular)
    return X, y


def make_gaussian_partial_sums_on_grid(n_samples=100, n_features=1, orders=5,
                                       kernel=None, mean=None, ratio=0.3,
                                       ref=1., nugget=0, random_state=0,
                                       allow_singular=True, device=None):
    R"""Partial sums on the full tensor grid of ``n_features`` copies of
    ``linspace(0, 1, n_samples)`` (the original library's ``n_features > 1``
    grid iterates ``range(n_features)`` instead; the JAX package's corrected
    grid is kept).  Returns ``(X, y)``."""
    device = _device(random_state, device)
    x = torch.linspace(0, 1, n_samples, dtype=default_dtype(), device=device)
    if n_features > 1:
        X = cartesian(*[x for _ in range(n_features)])
    else:
        X = x[:, None]
    y = make_gaussian_partial_sums(
        X=X, orders=orders, kernel=kernel, mean=mean, ratio=ratio,
        ref=ref, nugget=nugget, random_state=random_state,
        allow_singular=allow_singular)
    return X, y
