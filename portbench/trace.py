R"""A ``torch.profiler`` window over some calls, reduced in memory to what
the per-layer metrics read: device time by operation, busy time (the union
of the device's activity), the window's length, and the longest idle gaps
labelled with what the host was doing.  No trace file is written.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

WINDOW = 'portbench.window'
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: dict = field(default_factory=dict)   # name -> seconds
    device_counts: dict = field(default_factory=dict)
    idle_gaps: list = field(default_factory=list)    # [(label, seconds)]
    calls: int = 0

    def op_seconds(self, needle):
        """Device seconds and launches of every operation whose name holds
        ``needle``."""
        names = [n for n in self.device_ops if needle in n]
        return (sum(self.device_ops[n] for n in names),
                sum(self.device_counts[n] for n in names))

    def breakdown(self):
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        return {'device_ops': [[n, s] for n, s in ops],
                'idle_gaps': [[n, s] for n, s in self.idle_gaps[:TOP]]}


def _ns(event, which):
    f = getattr(event, f'{which}_ns', None)
    if f is not None:
        return int(f())
    return int(getattr(event, f'{which}_us')() * 1000)


def _end_ns(event):
    if hasattr(event, 'end_ns'):
        return int(event.end_ns())
    return _ns(event, 'start') + int(event.duration_us() * 1000)


def profile(run_calls, synchronize):
    """Profiles ``run_calls()`` (which returns how many calls it made) and
    returns its :class:`Trace`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as _profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _profile(activities=activities) as prof:
        synchronize()
        with record_function(WINDOW):
            calls = run_calls()
            synchronize()
    events = prof.profiler.kineto_results.events()
    win, cpu, dev = None, [], []
    for e in events:
        on_host = e.device_type() == DeviceType.CPU
        if not on_host and (e.name() == WINDOW or getattr(
                e, 'is_user_annotation', lambda: False)()):
            continue               # the window's own span, drawn on the GPU
        if on_host:
            if e.name() == WINDOW:
                win = (_ns(e, 'start'), _end_ns(e))
            else:
                cpu.append((_ns(e, 'start'), _end_ns(e), e.name()))
        else:
            dev.append((_ns(e, 'start'), _end_ns(e), e.name()))
    if win is None:
        raise RuntimeError('the profiler recorded no window span')
    return reduce(win, cpu, dev, calls)


def reduce(win, cpu, dev, calls):
    """Reduces (start_ns, end_ns, name) events of the host (``cpu``) and the
    device (``dev``) within ``win``."""
    w0, w1 = win
    ops, counts, spans = {}, {}, []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-9
        counts[name] = counts.get(name, 0) + 1
        spans.append((s, e))
    spans.sort()
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_ns = sum(e - s for s, e in merged)
    edges = [w0] + [x for se in merged for x in se] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:TOP]
    labelled = []
    if cpu:
        cs = np.array([c[0] for c in cpu], dtype=np.int64)
        ce = np.array([c[1] for c in cpu], dtype=np.int64)
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            inside = np.flatnonzero((cs <= mid) & (ce >= mid))
            label = ('host outside any profiled op' if not len(inside)
                     else cpu[int(inside[np.argmax(cs[inside])])][2])
            labelled.append((label, (g1 - g0) * 1e-9))
    else:
        labelled = [('host', (g1 - g0) * 1e-9) for g0, g1 in gaps]
    window_s = (w1 - w0) * 1e-9
    return Trace(window_s=window_s, busy_s=min(busy_ns * 1e-9, window_s),
                 device_ops=ops, device_counts=counts, idle_gaps=labelled,
                 calls=calls)
