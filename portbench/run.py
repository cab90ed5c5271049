R"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's inputs on the card from the seed, loads the
program (building its kernels on a checkout's first run) and makes one
call of the cell's own shapes.  The window then makes calls one after
another, each ended by a synchronize, until ``--seconds`` have passed.
With ``--trace 1`` a profiler window over a few more calls follows, and
the per-layer metrics are reported instead of the end-to-end ones.  Once
the window has closed, a seeded sample of the window's answers is compared
with the plain reference (``reference/``), each number beside its limit
(``limits/<cell>.json``).  The last line on standard output is one JSON
object; the numbers compared are the last lines on standard error.
"""
from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'gsum_tpu')
THREAD_VARS = ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS')


def _process_age():
    """Seconds between the process's start and now, from /proc."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return 0.0


def since_start():
    """Seconds since this module was imported (a test's set-up clock)."""
    return time.perf_counter() - _STARTED


def _cache_dirs(root):
    """Every build and kernel cache at a fixed place inside the checkout."""
    base = os.path.join(root, '.portbench_cache')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(base, 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(base, 'torch_extensions')


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _metric(spec, entry, run):
    value = spec.metric_module(entry['name']).read(run)
    if value is None:
        return None
    return {'value': float(value), 'unit': entry['unit']}


def execute(spec, seed, seconds, trace, device, started=since_start):
    """One run of the cell ``spec`` on ``device``: ``(result, lines)``, the
    result line's object and the lines of the numbers compared."""
    import torch

    from . import trace as tracing
    from .context import Context

    ctx = Context(spec, seed, device)
    mod = spec.call_module()
    spans = {}
    work = mod.Workload(ctx)
    work.warm_up(spans)
    ctx.synchronize()
    spans.clear()
    setup_s = started()

    kept, latencies = [], []
    t_start = time.perf_counter()
    while True:
        t = time.perf_counter()
        out = work(len(kept), spans)
        ctx.synchronize()
        latencies.append(time.perf_counter() - t)
        kept.append((len(kept), out))
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    on_card = ctx.device.type == 'cuda'
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0

    run = SimpleNamespace(
        unit=mod.UNIT, setup_s=setup_s, spans=spans, work=work,
        trace=None, probes={},
        window=SimpleNamespace(calls=len(kept), seconds=window_s,
                               units=len(kept) * work.units_per_call,
                               latencies=latencies))
    if trace:
        n = int(ctx.traffic['traced_calls'])
        start = len(kept)

        def calls():
            scratch = {}
            for i in range(start, start + n):
                work(i, scratch)
                ctx.synchronize()
            return n

        with contextlib.ExitStack() as stack:
            for entry in spec.per_layer:
                probe = getattr(spec.metric_module(entry['name']), 'probe',
                                None)
                if probe is not None:
                    stack.enter_context(probe(run))
            run.trace = tracing.profile(calls, ctx.synchronize)

    failed = sum(work.failed(out) for _, out in kept)
    entries = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for entry in entries:
        m = _metric(spec, entry, run)
        if m is not None:
            metrics[entry['name']] = m
    work.release()
    if on_card:
        torch.cuda.empty_cache()

    numbers = work.check(kept)
    checks, lines, correct = {}, [], bool(kept)
    for name, value in numbers.items():
        limit = spec.limits.get(name)
        ok = (limit is not None and not math.isnan(value)
              and value <= float(limit))
        correct = correct and ok
        checks[name] = {'value': value, 'limit': limit}
        lines.append(f'check {name} {value!r} limit {limit!r}'
                     f"{'' if ok else '  FAILED'}")

    dev = {'platform': 'gpu' if on_card else ctx.device.type,
           'kind': (torch.cuda.get_device_name(ctx.device) if on_card
                    else ctx.device.type),
           'count': spec.chips, 'memory_peak_bytes': int(peak)}
    result = {'correct': correct, 'attempted': run.window.units,
              'failed': failed, 'metrics': metrics, 'device': dev}
    if run.trace is not None:
        dev['busy_s'] = run.trace.busy_s
        dev['window_s'] = run.trace.window_s
        result['breakdown'] = run.trace.breakdown()
    result['checks'] = checks
    return result, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the process's age at this module's import, so that set-up counts
    # from the process's start
    age = _process_age() - (time.perf_counter() - _STARTED)

    def started():
        return age + time.perf_counter() - _STARTED

    # one host thread for every library: the card does the arithmetic, and
    # a one-card machine shares its host's cores with its neighbours
    for var in THREAD_VARS:
        os.environ[var] = '1'
    from .spec import ROOT, load
    _cache_dirs(str(ROOT))
    _, spec = load(ROOT, args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f'portbench: {args.workload} needs {spec.chips} CUDA '
              f'device(s); torch sees '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    result, lines = execute(spec, args.seed, args.seconds, args.trace,
                            'cuda:0', started)
    found = forbidden_modules()
    if found:
        print(f'portbench: the run loaded {", ".join(found)}; it may load '
              f'none of {", ".join(FORBIDDEN)}', file=sys.stderr)
        return 3
    sys.stderr.write('\n'.join(lines) + '\n')
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
