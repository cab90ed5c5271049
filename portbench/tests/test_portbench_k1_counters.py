"""chol_inv_block_roofline reads K1's blocks from the program's counters
(which a replayed CUDA graph adds again) and its time from the trace: the
share on hand-made readings, nothing where the launches disagree or no
block was counted, and its entry in BENCHMARK.json."""
from types import SimpleNamespace

import pytest

from portbench import program_trace as pt
from portbench.counts import bound_chol_inv
from portbench.spec import HERE, ROOT, load, load_module

NAME = 'chol_inv_block_roofline'


def metric_module(name):
    return load_module(HERE / 'metrics' / f'{name}.py',
                       f'portbench_metric_{name}')


def _run(counted, seconds, launches):
    trace = SimpleNamespace(op_seconds=lambda needle: (
        (seconds, launches) if needle == 'chol_inv_block' else (0.0, 0)))
    return SimpleNamespace(trace=trace,
                           probes={pt.KEY: {'events': None,
                                            'counters': counted}})


def test_share_of_the_counted_blocks():
    read = metric_module(NAME).read
    counted = {'k1.launches': 3, 'k1.matrices.128': 48, 'k1.matrices.64': 8,
               'chol.matrices': 10}
    want = 100.0 * (bound_chol_inv(48, 128)[0]
                    + bound_chol_inv(8, 64)[0]) / 2e-4
    assert read(_run(counted, 2e-4, 3)) == pytest.approx(want)


@pytest.mark.parametrize('counted,launches', [
    ({'k1.launches': 3, 'k1.matrices.128': 48}, 5),   # the trace saw more
    ({'k1.launches': 3}, 3),                          # no width counters
    ({'k1.launches': 0, 'k1.matrices.128': 0}, 0),    # K1 did not run
    ({}, 0),                                          # no counters at all
])
def test_nothing_where_the_counts_cannot_be_read(counted, launches):
    read = metric_module(NAME).read
    assert read(_run(counted, 1e-4, launches)) is None
    assert read(SimpleNamespace(trace=None, probes={})) is None


def test_its_entry_lists_the_k1_cell():
    bench, _ = load(ROOT)
    entry = next(m for m in bench['per_layer'] if m['name'] == NAME)
    k1 = next(m for m in bench['per_layer'] if m['name'] == 'k1_roofline')
    assert entry['workloads'] == k1['workloads'] == ['e2d4096.fits']
    assert (entry['unit'], entry['layer'], entry['moves']) == \
        (k1['unit'], k1['layer'], k1['moves'])
    assert metric_module(NAME).probe is pt.probe
