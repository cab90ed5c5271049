R"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 -m portbench.control --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9] [--device cuda]

For each seed of ``--seeds``, the program makes ``control_calls`` calls of
the cell at its own size and the comparison of a run reads them (sound
readings: the largest of them is a limit's lower reading).  For each seed
of ``--control-seeds``, the reference one precision below the
configuration's own (float32 for float64; TF32 products for float32) takes
the program's place (the control: it must fail).  For each seed of
``--fault-seeds``, each fault of ``portbench.faults`` is planted under the
program.  One JSON line per reading, then a summary line.  A benchmark run
never runs this.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

BELOW = {'float64': 'f32', 'float32': 'tf32'}


def _workload(spec, seed, device):
    from .context import Context
    ctx = Context(spec, seed, device)
    return ctx, spec.call_module().Workload(ctx)


def _program(work, ctx):
    n = int(ctx.traffic['control_calls'])
    kept = []
    for i in range(n):
        kept.append((i, work(i, {})))
        ctx.synchronize()
    return kept


def sound(spec, seed, device):
    ctx, work = _workload(spec, seed, device)
    return work.check(_program(work, ctx))


def control(spec, seed, device):
    ctx, work = _workload(spec, seed, device)
    precision = BELOW[spec.config['dtype']]
    kept = work.control(precision, int(ctx.traffic['control_calls']))
    return work.check(kept)


def fault(spec, seed, device, name):
    """The readings with ``name`` planted; None where the call cannot have
    that fault."""
    from .faults import planted
    cm = planted(name, spec.traffic['call'])
    if cm is None:
        return None
    with cm:
        ctx, work = _workload(spec, seed, device)
        return work.check(_program(work, ctx))


def fails(spec, numbers):
    """Whether ``numbers`` fail the cell's limits (a missing limit or a
    number that is not finite fails)."""
    return any(spec.limits.get(k) is None or math.isnan(v)
               or v > float(spec.limits[k]) for k, v in numbers.items())


def readings(spec, seeds, control_seeds, fault_seeds, device, emit=print):
    """Every reading, and per number the largest sound reading, the least
    control reading and the least reading of each fault."""
    from .faults import FAULTS
    rows = []

    def record(kind, seed, fn):
        t = time.perf_counter()
        try:
            numbers = fn()
        except Exception as e:       # a control or fault that crashes fails
            numbers = {'crashed': math.inf}
            emit(json.dumps({'kind': kind, 'seed': seed,
                             'error': repr(e)[:300]}))
        if numbers is None:
            return
        row = {'kind': kind, 'seed': seed, 'numbers': numbers,
               'seconds': time.perf_counter() - t}
        rows.append(row)
        emit(json.dumps(row))

    for s in seeds:
        record('sound', s, lambda: sound(spec, s, device))
    for s in control_seeds:
        record('control', s, lambda: control(spec, s, device))
    for name in FAULTS:
        for s in fault_seeds:
            record(name, s, lambda: fault(spec, s, device, name))
    summary = {}
    for row in rows:
        agg = max if row['kind'] == 'sound' else min
        slot = summary.setdefault(row['kind'], {})
        for k, v in row['numbers'].items():
            slot[k] = v if k not in slot else agg(slot[k], v)
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--fault-seeds', default='')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(',') if x]

    from .spec import ROOT, load
    _, spec = load(ROOT, args.workload)
    import torch
    if args.device.startswith('cuda'):
        if not torch.cuda.is_available():
            print('portbench.control: no CUDA device', file=sys.stderr)
            return 2
        print(json.dumps({'device': torch.cuda.get_device_name(0)}))
    _, summary = readings(spec, ints(args.seeds), ints(args.control_seeds),
                          ints(args.fault_seeds), args.device)
    print(json.dumps({'workload': args.workload, 'summary': summary}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
