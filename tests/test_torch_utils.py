"""``gsum_tpu_torch.profiling`` and ``gsum_tpu_torch.pdfmeta`` against
``gsum_tpu``'s on the CPU.

``pdfmeta`` is the port's own copy of a pure-Python module: stamping the
same PDF bytes with the same metadata gives the same bytes, and reading
gives the same dict.  ``profiling``: the lml FLOP counts are equal;
``time_fn`` times CPU tensors with host clocks (a positive time, no card
touched), and ``trace`` writes a Chrome trace of a torch.profiler window.
"""
import json
import os

import matplotlib
from _port import one_intra_op_thread  # noqa: F401 (autouse)

matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gsum_tpu import pdfmeta as jp  # noqa: E402
from gsum_tpu import profiling as jprof  # noqa: E402
from gsum_tpu_torch import pdfmeta as tp  # noqa: E402
from gsum_tpu_torch import profiling as tprof  # noqa: E402

META = {'orders': '0 2 3 4 5', 'Lambda_b': '600', 'note': 'Λ_b (paren) \\',
        'Title': 'a figure'}


def _pdf(path):
    fig, ax = plt.subplots(figsize=(2, 2))
    ax.plot([0, 1], [0, 1])
    fig.savefig(path, metadata={'CreationDate': None})
    plt.close(fig)
    with open(path, 'rb') as fh:
        return fh.read()


def test_pdfmeta_matches_jax_on_the_same_bytes(tmp_path):
    base = _pdf(str(tmp_path / 'base.pdf'))
    paths = {}
    for name, mod in (('jax', jp), ('torch', tp)):
        paths[name] = str(tmp_path / f'{name}.pdf')
        with open(paths[name], 'wb') as fh:
            fh.write(base)
        mod.add_pdf_metadata(paths[name], META)
        mod.add_pdf_metadata(paths[name], {'Lambda_b': '650', 'extra': '1'})
    with open(paths['jax'], 'rb') as a, open(paths['torch'], 'rb') as b:
        assert a.read() == b.read()
    for exclude in (True, False):
        assert tp.get_pdf_metadata(paths['torch'], exclude=exclude) == \
            jp.get_pdf_metadata(paths['jax'], exclude=exclude)
    for bad in ('a b', 'a/b', 'a%b', 'a#b', 'Λ'):
        with pytest.raises(ValueError) as want:
            jp.add_pdf_metadata(paths['jax'], {bad: '1'})
        with pytest.raises(ValueError, match=str(want.value)[:25]):
            tp.add_pdf_metadata(paths['torch'], {bad: '1'})
    fig, ax = plt.subplots(figsize=(2, 2))
    tp.save_figure_with_metadata(fig, str(tmp_path / 'saved.pdf'), META)
    plt.close(fig)
    got = tp.get_pdf_metadata(str(tmp_path / 'saved.pdf'))
    assert got['orders'] == META['orders'] and got['note'] == META['note']


def test_profiling_matches_jax_and_times_the_cpu():
    for args in ((100,), (256, 3, 2), (4096, 5, 3)):
        assert tprof.flops_lml(*args) == jprof.flops_lml(*args)
    A = torch.randn(64, 64, dtype=torch.float64)
    t = tprof.time_fn(lambda a: a @ a, A, reps=2, chain=2)
    assert 0 < t < 10
    with pytest.raises(ValueError, match='CUDA or CPU'):
        tprof._on_card((torch.zeros(1, device='meta'),), None)


def test_trace_writes_a_chrome_trace(tmp_path):
    A = torch.randn(32, 32)
    with tprof.trace(str(tmp_path / 'tr')) as prof:
        (A @ A).sum()
    assert any('mm' in e.key for e in prof.key_averages())
    with open(os.path.join(str(tmp_path / 'tr'), 'trace.json')) as fh:
        assert 'traceEvents' in json.load(fh)
