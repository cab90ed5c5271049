R"""Tracing, counting, timing and FLOP accounting (counterpart of
``gsum_tpu/profiling.py``), and the port's one registry of spans and
counters.

- :func:`span` — a named span of the program (``gsum.<layer>.<phase>``).
  It enters ``torch.profiler.record_function`` only while a torch profiler
  is running, so that it lands in the same trace as the CUDA runtime calls
  and kernels, on the same clock; otherwise it costs one flag test.
- :func:`count`, :func:`counters`, :func:`reset_counters` — host counters
  of quantities the host already knows (shapes, batch sizes, loop trips,
  kernel launches).  Always on; they never read a device value.
- :func:`trace` — a ``torch.profiler`` window over device execution,
  written as a Chrome trace (``chrome://tracing``, Perfetto) into
  ``log_dir``; it carries the program's ``gsum.*`` spans.
- :func:`flops_lml` — the analytic FLOP count of one log-marginal
  likelihood, for achieved FLOP/s from a time (copied from the JAX
  package).
- :func:`time_fn` — best-of time per call: CUDA events for work on the card,
  host clocks only for CPU tensors.

Spans: ``gsum.fit`` (``parallel.batched_fit``), ``gsum.lbfgs.step``,
``gsum.lbfgs.line_search`` and ``gsum.lbfgs.gradient``
(``optimize._Lbfgs``), ``gsum.grid`` (``parallel.truncation_lml_grid``).
Counters: ``chol.matrices`` (covariances factored on the fit and grid
paths), ``fit.rows``, ``grid.thetas``, ``lbfgs.steps`` (the bounded
L-BFGS's iterations, eager or replayed) and ``lbfgs.steps_replayed`` (those
replayed from a CUDA graph, ``optimize._Lbfgs``), and the kernels' launches
``k1.launches``, ``k2.launches``, ``k3.launches``, ``p1.betainc.launches``,
``p1.betaincinv.launches``, with ``k1.matrices.<nb>`` (the blocks of width
nb that K1 factored).  A replayed graph counts at every replay what
its capture counted (:func:`_recorded`).
"""
from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

__all__ = ['span', 'count', 'counters', 'reset_counters', 'trace',
           'flops_lml', 'time_fn']

_OFF = contextlib.nullcontext()
_COUNTS = collections.Counter()


def span(name):
    """A context manager that marks the enclosed host work as the span
    ``name`` in a running torch profiler's trace; a shared no-op when no
    profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name, n=1):
    """Adds ``n`` (a host int) to the counter ``name``."""
    _COUNTS[name] += n


def counters():
    """A copy of every counter (a ``collections.Counter``: a name never
    counted reads 0)."""
    return collections.Counter(_COUNTS)


def reset_counters():
    """Sets every counter to 0."""
    _COUNTS.clear()


@contextlib.contextmanager
def _recorded():
    """Sends the counts made inside to the ``collections.Counter`` it
    yields, not to the registry: what a CUDA graph's capture counts, added
    again at each replay, as nothing runs at the capture."""
    global _COUNTS
    kept, _COUNTS = _COUNTS, collections.Counter()
    try:
        yield _COUNTS
    finally:
        _COUNTS = kept


@contextlib.contextmanager
def trace(log_dir, activities=None, **kwargs):
    """Profiles the enclosed work with ``torch.profiler`` (CPU, and CUDA
    where a card is visible) and writes ``<log_dir>/trace.json``, the
    program's ``gsum.*`` spans included.  Yields the profiler, whose
    ``key_averages()`` gives device time per kernel; ``kwargs`` go to
    ``torch.profiler.profile``."""
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
