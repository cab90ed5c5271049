R"""Tracing, timing and FLOP accounting (counterpart of
``gsum_tpu/profiling.py``).

- :func:`trace` — a ``torch.profiler`` window over device execution, written
  as a Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``.
- :func:`flops_fit` / :func:`flops_lml` — analytic FLOP counts of the hot
  paths, for achieved FLOP/s from a time (copied from the JAX package).
- :func:`time_fn` — best-of time per call: CUDA events for work on the card,
  host clocks only for CPU tensors.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ['trace', 'flops_lml', 'flops_fit', 'time_fn']


@contextlib.contextmanager
def trace(log_dir, activities=None, **kwargs):
    """Profiles the enclosed work with ``torch.profiler`` (CPU, and CUDA
    where a card is visible) and writes ``<log_dir>/trace.json``.  Yields
    the profiler, whose ``key_averages()`` gives device time per kernel;
    ``kwargs`` go to ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, **kwargs) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def flops_lml(n, n_curves=1, n_params=1):
    """FLOPs of one log-marginal-likelihood evaluation: kernel build +
    Cholesky + triangular solves + logdet."""
    cov = 2.0 * n * n * n_params + 6.0 * n * n
    chol = n ** 3 / 3.0
    solves = 2.0 * n * n * (n_curves + 2)
    return cov + chol + solves


def flops_fit(n, n_curves=1, n_params=1, lml_evals=30):
    """FLOPs of a MAP fit: optimizer iterations × (lml + gradient ≈ 3×
    lml)."""
    return lml_evals * 4.0 * flops_lml(n, n_curves, n_params)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return []


def _on_card(args, out):
    devices = {t.device.type for t in _leaves(args) + _leaves(out)}
    if 'cuda' in devices:
        return True
    if not devices or devices == {'cpu'}:
        return False
    raise ValueError('time_fn times CUDA or CPU tensors, got %s' % devices)


def time_fn(fn, *args, reps=3, chain=3):
    """Best-of time in seconds of one call of ``fn(*args)``.

    Each of ``reps`` samples times ``chain`` calls back to back.  Where
    ``fn``'s arguments or result lie on the card the samples are CUDA
    events around the calls (device time, the host's launch time
    included where the card waits for it); for CPU tensors, which the
    caller asks for by passing them, host clocks.
    """
    out = fn(*args)
    if _on_card(args, out):
        torch.cuda.synchronize()
        best = float('inf')
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(chain):
                out = fn(*args)
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3 / chain)
        return best
    best = float('inf')
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chain):
            out = fn(*args)
        best = min(best, (time.perf_counter() - t0) / chain)
    return best
