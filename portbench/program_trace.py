R"""The program's own spans and counters in the traced window, for the
per-layer metrics that read them.

The program (``gsum_tpu_torch.profiling``) marks its layers with spans
named ``gsum.<layer>.<phase>``, which land in the profiler's host events,
and keeps host counters of the work it does.  :func:`probe`, entered around
the traced calls, keeps the window's raw events (by wrapping
``portbench.trace.reduce``, which receives them) and the change of the
program's counters over those calls.  A program without spans or counters
gives ``None`` from every reader, so that nothing is reported for it.

Device annotations of the program's spans (the profiler may draw a span
on the device too) are no device work: the wrapper drops them before the
reduction, so that busy time and the breakdown are what they would be
without the spans.
"""
from __future__ import annotations

import contextlib

from portbench import trace as tracing

PREFIX = 'gsum.'
KEY = 'program'


@contextlib.contextmanager
def probe(run):
    """Keeps the window's events and the counters' change in
    ``run.probes['program']``; entered again for the same run, it does
    nothing."""
    if KEY in run.probes:
        yield
        return
    seen = run.probes[KEY] = {'events': None, 'counters': None}
    try:
        from gsum_tpu_torch.profiling import counters
    except ImportError:
        counters = None
    before = counters() if counters else None
    inner = tracing.reduce

    def keep(win, cpu, dev, calls):
        dev = [e for e in dev if not e[2].startswith(PREFIX)]
        seen['events'] = (win, cpu, dev)
        return inner(win, cpu, dev, calls)

    tracing.reduce = keep
    try:
        yield
    finally:
        tracing.reduce = inner
        if counters:
            after = counters()
            seen['counters'] = {k: after[k] - before.get(k, 0)
                                for k in after}


def _union(spans):
    """Sorted disjoint intervals covering ``spans`` ((start, end) pairs)."""
    merged = []
    for s, e in sorted(spans):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _minus(a, b):
    """The parts of the disjoint sorted intervals ``a`` outside those of
    ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def idle_share(win, cpu, dev, spans, minus=()):
    """Percent of the window ``win`` in which the host was inside a span
    named in ``spans`` and outside every span named in ``minus``, while
    nothing ran on the device; ``None`` where no span of ``spans`` was
    seen.  ``cpu`` and ``dev`` are (start_ns, end_ns, name) events."""
    w0, w1 = win

    def within(names):
        return _union((max(s, w0), min(e, w1)) for s, e, n in cpu
                      if n in names)

    if not any(n in spans for _, _, n in cpu) or w1 <= w0:
        return None
    busy = _union((max(s, w0), min(e, w1)) for s, e, _ in dev)
    idle = _minus(_minus(within(spans), within(minus)), busy)
    return 100.0 * sum(e - s for s, e in idle) / (w1 - w0)


def idle_in(run, spans, minus=()):
    """:func:`idle_share` over the run's traced window, or ``None``."""
    seen = run.probes.get(KEY)
    if run.trace is None or not seen or seen['events'] is None:
        return None
    return idle_share(*seen['events'], spans, minus)


def ratio(run, counted, per):
    """The change of the counter ``counted`` over that of ``per`` in the
    traced calls, or ``None`` where the program counted no ``per``."""
    seen = run.probes.get(KEY)
    if run.trace is None or not seen or not seen['counters']:
        return None
    base = seen['counters'].get(per, 0)
    if base <= 0:
        return None
    return seen['counters'].get(counted, 0) / base
