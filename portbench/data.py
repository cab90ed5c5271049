R"""The one generator of the benchmark's inputs, driven by a configuration's
and a traffic mix's parameters and by the run's seed.

Inputs are a lattice of points (``config['inputs']``), and observables are
coefficient curves drawn on it from the configuration's Gaussian process,
at the length scale, ratio and reference scale of one row of the mix's
``truth`` design, then turned into partial sums y_k = ref Σ_{n ≤ k} cₙ Qⁿ
over the configuration's orders.  The rows of the design are dealt to the
observables in blocks, each block every row once in a seeded order, so
every seed draws the same set of problems, and any run of whole blocks
does too.  Draws are made on the device by a seeded ``torch.Generator``,
in float64, in one call per distinct length scale.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference import correlation, sqdist

DTYPES = {'float64': torch.float64, 'float32': torch.float32}


def stream_seed(seed, stream):
    """A 63-bit seed for one named stream of a run's seed."""
    words = [ord(ch) for ch in stream]
    state = np.random.SeedSequence([int(seed) % 2 ** 64, *words])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed, stream, device):
    """A ``torch.Generator`` on ``device`` for one stream of the seed."""
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def host_rng(seed, stream):
    """A numpy generator (indices and samples only, never data)."""
    return np.random.default_rng(stream_seed(seed, stream))


def lattice(spec, midpoints=False):
    R"""(N, d) float64 points: the cartesian product of ``(i + 1) / n`` for
    i < n along each axis of ``spec['shape']`` (``(i + ½) / n`` for the
    midpoints)."""
    shift = 0.5 if midpoints else 1.0
    axes = [(np.arange(n) + shift) / n for n in spec['shape']]
    grids = np.meshgrid(*axes, indexing='ij')
    return np.stack([g.reshape(-1) for g in grids], 1)


@dataclass
class Observables:
    """``count`` observables on one lattice (float64, on the device)."""
    coeffs: torch.Tensor       # (count, N, n_orders)
    partials: torch.Tensor     # (count, N, n_orders)
    ratio: np.ndarray          # (count,)
    ref: np.ndarray            # (count,)


def _draw_factor(R, jitter, eye):
    """A Cholesky factor of R + jitter·I, the jitter raised tenfold until
    the factorization succeeds (the draws' own noise, at least the
    configuration's nugget)."""
    while True:
        L, info = torch.linalg.cholesky_ex(R + jitter * eye)
        if int(info) == 0:
            return L
        jitter *= 10


def observables(config, traffic, X, count, seed, stream='pool'):
    """``count`` observables at the points ``X`` (float64 tensor on the
    device)."""
    truth = traffic['truth']
    design = np.asarray(truth['design'], dtype=float)       # (D, 3)
    rng = host_rng(seed, stream + '.order')
    D = len(design)
    blocks = -(-count // D)
    order = np.concatenate([rng.permutation(D) for _ in range(blocks)])
    rows = design[order[:count]]
    ls, ratio, ref = rows.T
    orders = np.asarray(config['orders'])
    N, m = X.shape[0], len(orders)
    gen = generator(seed, stream, X.device)
    d2 = sqdist(X, X)
    eye = torch.eye(N, dtype=torch.float64, device=X.device)
    jitter = max(float(config['nugget']), float(truth['draw_jitter']))
    coeffs = torch.empty((count, N, m), dtype=torch.float64,
                         device=X.device)
    for value in np.unique(ls):
        idx = np.flatnonzero(ls == value)
        L = _draw_factor(correlation(d2, value)[0], jitter, eye)
        z = torch.randn((N, len(idx) * m), generator=gen,
                        dtype=torch.float64, device=X.device)
        draws = (L @ z).reshape(N, len(idx), m).permute(1, 0, 2)
        coeffs[torch.as_tensor(idx, device=X.device)] = \
            float(truth['amplitude']) * draws
    q = torch.as_tensor(ratio, dtype=torch.float64, device=X.device)
    r = torch.as_tensor(ref, dtype=torch.float64, device=X.device)
    powers = q[:, None] ** torch.as_tensor(orders, dtype=torch.float64,
                                           device=X.device)[None]
    partials = r[:, None, None] * torch.cumsum(coeffs * powers[:, None, :],
                                               -1)
    return Observables(coeffs, partials, ratio, ref)
