"""The harness on the CPU: it finds what BENCHMARK.json names by file, its
result line has the contract's keys, its counts match hand counts, it
refuses JAX and a missing card, and its trace reduction adds up."""
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import counts, run, spec, trace
from portbench.spec import ROOT, load

KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def _digest(folder):
    return {p.relative_to(folder).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(folder.rglob('*')) if p.is_file()
        and '__pycache__' not in p.parts}


def test_new_config_traffic_and_metric_are_found_by_file(tmp_path):
    root = tmp_path / 'checkout'
    shutil.copytree(ROOT / 'portbench', root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(ROOT / 'BENCHMARK.json', root / 'BENCHMARK.json')
    before = _digest(root / 'portbench')
    home = root / 'portbench'

    config = json.loads((home / 'configs' / 'nn350_f64.json').read_text())
    config.update(name='tiny_f64', inputs={'kind': 'lattice', 'shape': [24]},
                  n_points=24)
    (home / 'configs' / 'tiny_f64.json').write_text(json.dumps(config))
    traffic = json.loads((home / 'traffic' / 'sweep179.json').read_text())
    traffic.update(observables_per_call=3, pool_calls=1,
                   check_sample=2)
    (home / 'traffic' / 'tiny_sweep.json').write_text(json.dumps(traffic))
    (home / 'metrics' / 'calls_per_s.py').write_text(
        'def read(run):\n'
        '    return run.window.calls / run.window.seconds\n')
    (home / 'limits' / 'tiny.fits.json').write_text(json.dumps(
        {'lml_gap': 1.0, 'lml_shortfall': 1.0, 'scale_gap': 1.0,
         'state_mismatch': 0}))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'tiny_f64', 'source': 'a test',
                             'file': 'portbench/configs/tiny_f64.json',
                             'reduced': ['n_points'], 'why': 'a test'})
    bench['workloads'].append({'name': 'tiny.fits', 'config': 'tiny_f64',
                               'traffic': 'tiny_sweep', 'chips': 1,
                               'why': 'a test'})
    bench['end_to_end'].append({'name': 'calls_per_s', 'unit': 'calls/s',
                                'better': 'higher', 'bound': 0.05,
                                'source': 'host_clock',
                                'workloads': ['tiny.fits']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    _, cell = load(root, 'tiny.fits')
    result, _ = run.execute(cell, 3, 0.01, 0, 'cpu')
    assert result['correct']
    assert result['metrics']['calls_per_s']['value'] > 0
    assert set(result['metrics']) == {'calls_per_s', 'setup_s'}
    after = _digest(home)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize('traced', [0, 1])
def test_result_line_has_the_contract_keys(small, traced):
    result, lines = run.execute(small('nn350.grid'), 2 ** 31 + 7, 0.01,
                                traced, 'cpu')
    keys = list(result)
    assert keys[:5] == KEYS and keys[-1] == 'checks'
    assert ('breakdown' in keys) == bool(traced)
    assert set(keys) <= set(KEYS) | {'breakdown', 'checks'}
    assert result['correct'] and result['attempted'] > 0
    assert set(result['metrics']) == (
        {'grid_mfu', 'device_idle.grid'} if traced
        else {'lml_evals_per_s', 'setup_s'})
    for m in result['metrics'].values():
        assert set(m) == {'value', 'unit'} and math.isfinite(m['value'])
    assert set(result['device']) >= {'platform', 'kind', 'count',
                                     'memory_peak_bytes'}
    if traced:
        assert set(result['device']) >= {'busy_s', 'window_s'}
    assert [ln.split()[1] for ln in lines] == list(result['checks'])
    json.dumps(result)


def test_counts_match_hand_counts():
    # n=2, one curve, one parameter: cov 2*4 + 6*4, chol 8/3, solves 2*4*3
    assert counts.flops_lml(2, 1, 1) == pytest.approx(8 + 24 + 8 / 3 + 24)
    # gradient: 2*8/3 + 2*4
    assert counts.flops_lml_gradient(2, 1) == pytest.approx(16 / 3 + 8)
    # maxiter 1, ls_steps 2: 1 + 1*3 forwards, 2 gradients
    assert counts.flops_fixed_trip_fit(2, 1, 1, 1, 2) == pytest.approx(
        4 * (58 + 2 / 3) + 2 * (16 / 3 + 8))
    # 3 theta x 4 ratios at n=2, m=5: per theta 8 + 24 + 8/3 + 8; per pair
    # 2*4*5
    assert counts.flops_truncation_grid(2, 5, 1, 3, 4) == pytest.approx(
        3 * (40 + 8 / 3) + 12 * 40)
    seconds, which = counts.bound_chol_inv(16, 128)
    nbytes = 4 * 16 * (128 * 129 // 2 + 2 * 128 * 128)
    assert which == 'bytes'
    assert seconds == pytest.approx(nbytes / 3.35e12)


def test_module_guard_takes_whole_top_level_names(monkeypatch):
    for name in ('jax', 'jaxlib.xla_client', 'gsum_tpu.models', 'flax'):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, 'gsum_tpu_torch', object())
    assert run.forbidden_modules() == ['flax', 'gsum_tpu', 'jax', 'jaxlib']


def test_guard_passes_the_port_alone():
    code = ('import sys, gsum_tpu_torch, portbench.run as r; '
            'sys.exit(1 if r.forbidden_modules() else 0)')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True)


def _bench(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', **(env_extra or {}))
    return subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload', 'nn350.grid',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = _bench(ROOT)
    assert out.returncode != 0 and out.stdout == ''


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    out = _bench(tmp_path, {'PYTHONPATH': ''})
    assert out.returncode != 0 and out.stdout == ''


def test_bench_names_only_its_own_files():
    bench, _ = load(ROOT)
    paths = bench['paths']
    assert bench['command'][:3] == ['python3', '-m', 'portbench.run']
    names = {c['name'] for c in bench['configs']}
    for c in bench['configs']:
        assert any(c['file'].startswith(p + '/') for p in paths)
        assert (ROOT / c['file']).is_file()
    for w in bench['workloads']:
        assert w['config'] in names
        assert (ROOT / paths[0] / 'traffic' / f"{w['traffic']}.json").is_file()
        assert (ROOT / paths[0] / 'limits' / f"{w['name']}.json").is_file()
    for m in bench['end_to_end'] + bench['per_layer']:
        assert (ROOT / paths[0] / 'metrics' / f"{m['name']}.py").is_file()
    for w in bench['workloads']:
        _, cell = load(ROOT, w['name'])
        assert any(m['name'] == 'setup_s' for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_trace_reduction_adds_up():
    ms = 1_000_000
    dev = [(1 * ms, 3 * ms, 'k1'), (2 * ms, 4 * ms, 'k2'),
           (6 * ms, 7 * ms, 'k1'), (9 * ms, 12 * ms, 'k3')]
    cpu = [(0, 10 * ms, 'outer'), (4 * ms, 6 * ms, 'scipy_step')]
    t = trace.reduce((0, 10 * ms), cpu, dev, calls=2)
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.003 + 0.001 + 0.001)
    assert t.device_ops['k1'] == pytest.approx(0.003)
    assert t.device_ops['k3'] == pytest.approx(0.001)
    assert t.op_seconds('k') == (pytest.approx(0.006), 4)
    gaps = t.breakdown()['idle_gaps']
    assert gaps[0] == ['scipy_step', pytest.approx(0.002)]
    assert sorted(round(s * 1e3) for _, s in gaps) == [1, 2, 2]


@pytest.mark.card
def test_each_cell_runs_correct_on_the_card(card):
    bench, _ = load(ROOT)
    for w in bench['workloads']:
        out = subprocess.run(
            [sys.executable, '-m', 'portbench.run', '--workload', w['name'],
             '--seed', '123456789012', '--seconds', '2', '--trace', '0'],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])['correct']


def test_spec_module_loader_takes_dotted_names(tmp_path):
    path = tmp_path / 'a.b.py'
    path.write_text('VALUE = 3\n')
    assert spec.load_module(path, 'x_a.b').VALUE == 3
    assert torch.get_num_threads() >= 1
    assert Path(spec.__file__).parent == ROOT / 'portbench'
