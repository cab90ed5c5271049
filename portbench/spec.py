R"""What ``BENCHMARK.json`` names, and the files that each name finds.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a file of its own (``configs/<file>``, ``traffic/<mix>.json``).
A traffic mix names the kind of call it makes (``calls/<call>.py``), and
every metric, end-to-end or per-layer, is read by ``metrics/<name>.py``.
The correctness limits of a cell are in ``limits/<cell>.json``.  Adding a
configuration, mix, call, metric or cell adds files and entries; no file of
the harness names any of them.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path, name):
    """The Python file at ``path`` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class CellSpec:
    """One workload of ``BENCHMARK.json`` with the files it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    home: Path = HERE

    def call_module(self):
        return load_module(self.home / 'calls' / f"{self.traffic['call']}.py",
                           f"portbench_call_{self.traffic['call']}")

    def metric_module(self, name):
        return load_module(self.home / 'metrics' / f'{name}.py',
                           f'portbench_metric_{name}')


def _applies(metric, cell, moved_reported=None):
    """Whether ``metric`` (an entry of ``end_to_end`` or ``per_layer``) is
    reported in ``cell``."""
    if 'workloads' in metric:
        return cell in metric['workloads']
    if moved_reported is not None:
        return metric.get('moves') in moved_reported
    return True


def load(root=ROOT, workload=None):
    """``BENCHMARK.json`` under ``root`` and, with ``workload``, that cell's
    :class:`CellSpec` (``(bench, cell)``)."""
    root = Path(root)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    if workload is None:
        return bench, None
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json '
                       f'(have {sorted(cells)})')
    w = cells[workload]
    configs = {c['name']: c for c in bench['configs']}
    home = root / bench['paths'][0]
    config = json.loads((root / configs[w['config']]['file']).read_text())
    traffic = json.loads(
        (home / 'traffic' / f"{w['traffic']}.json").read_text())
    limits = json.loads((home / 'limits' / f'{workload}.json').read_text())
    e2e = [m for m in bench['end_to_end'] if _applies(m, workload)]
    reported = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if _applies(m, workload, reported)]
    return bench, CellSpec(workload, int(w['chips']), config, traffic,
                           limits, e2e, per_layer, home)
