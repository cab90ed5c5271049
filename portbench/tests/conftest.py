"""Shared fixtures of the benchmark's own tests.

Run them from the repository's root:

    python -m pytest portbench/tests -q -p no:cacheprovider

Tests that need an NVIDIA card carry the ``card`` marker and skip inside
the ``card`` fixture where torch sees none.
"""
import copy
import json

import pytest
import torch

from portbench.spec import HERE, ROOT, CellSpec, load

# each cell shrunk to what a CPU test holds: the same code, fewer points,
# observables and grid points
SMALL = {
    'nn350.fits': {'config.inputs.shape': [48],
                   'traffic.observables_per_call': 6,
                   'traffic.pool_calls': 2, 'traffic.check_sample': 4},
    'e2d4096.fits': {'config.inputs.shape': [16, 16],
                     'traffic.observables_per_call': 3,
                     'traffic.check_sample': 3},
    'nn350.analysis': {'config.inputs.shape': [48], 'traffic.pool': 4,
                       'traffic.check_sample': 2, 'traffic.control_calls': 2},
    'nn350.grid': {'config.inputs.shape': [48], 'traffic.pool': 3,
                   'traffic.length_scales.count': 6,
                   'traffic.ratios.count': 5, 'traffic.check_sample': 2,
                   'traffic.control_calls': 2},
}


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs an NVIDIA card (skips where torch sees none)')


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card; torch sees none')


@pytest.fixture(autouse=True, scope='session')
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


def shrink(spec, changes):
    """A deep copy of a CellSpec with ``changes`` ('config.a.b' or
    'traffic.a.b' → value) applied."""
    spec = copy.deepcopy(spec)
    for key, value in changes.items():
        part, *path, last = key.split('.')
        target = spec.config if part == 'config' else spec.traffic
        for p in path:
            target = target[p]
        target[last] = value
    return spec


# proven on the card but held out of BENCHMARK.json (PERF.md §7): its
# files stand ready, and the tests keep them working
HELD_OUT = {'nn350.analysis': ('nn350_f64', 'analysis')}


def held_out(name):
    config, mix = HELD_OUT[name]

    def read(*parts):
        return json.loads(HERE.joinpath(*parts).read_text())
    return CellSpec(name, 1, read('configs', f'{config}.json'),
                    read('traffic', f'{mix}.json'),
                    read('limits', f'{name}.json'))


@pytest.fixture
def small():
    """``small(cell)``: the cell's CellSpec at its CPU test size."""
    def make(name):
        spec = held_out(name) if name in HELD_OUT else load(ROOT, name)[1]
        return shrink(spec, SMALL[name])
    return make
