"""The metrics that read the program's spans and counters: the idle share
within spans on hand-made events (self time, clipping to the window, no
span seen), the files and lists of their entries, and a traced run of each
cell on the CPU, which reports them in exactly the cells they list, with
the factorization counts derived from the code."""
import pytest

from portbench import program_trace as pt
from portbench import run
from portbench.spec import ROOT, load

MS = 1_000_000
NEW = {'fits.idle_in_program', 'fits.idle_optimizer', 'fits.idle_objective',
       'fits.factorizations_per_fit', 'grid.idle_in_program',
       'grid.factorizations_per_theta'}


def test_idle_within_a_span():
    # the host in gsum.fit over 0-8 ms; the device busy 2-5 ms
    cpu = [(0, 8 * MS, 'gsum.fit'), (1 * MS, 2 * MS, 'aten::add')]
    dev = [(2 * MS, 5 * MS, 'kernel')]
    assert pt.idle_share((0, 10 * MS), cpu, dev, {'gsum.fit'}) \
        == pytest.approx(50.0)


def test_self_time_subtracts_the_children():
    # step 0-10 ms, its line search 1-4 and gradient 6-9; the device busy
    # 3-7 ms: the step's own idle is 0-1 and 9-10, the children's 1-3, 7-9
    cpu = [(0, 10 * MS, 'gsum.lbfgs.step'),
           (1 * MS, 4 * MS, 'gsum.lbfgs.line_search'),
           (6 * MS, 9 * MS, 'gsum.lbfgs.gradient')]
    dev = [(3 * MS, 5 * MS, 'a'), (4 * MS, 7 * MS, 'b')]
    win = (0, 20 * MS)
    children = {'gsum.lbfgs.line_search', 'gsum.lbfgs.gradient'}
    own = pt.idle_share(win, cpu, dev, {'gsum.lbfgs.step'}, children)
    inside = pt.idle_share(win, cpu, dev, children)
    whole = pt.idle_share(win, cpu, dev, {'gsum.lbfgs.step'})
    assert own == pytest.approx(10.0)
    assert inside == pytest.approx(20.0)
    assert own + inside == pytest.approx(whole)


def test_overlap_is_clipped_to_the_window():
    # spans and device work reach past both ends of the 10-20 ms window
    cpu = [(0, 30 * MS, 'gsum.grid'), (5 * MS, 12 * MS, 'gsum.grid')]
    dev = [(0, 12 * MS, 'k'), (18 * MS, 40 * MS, 'k')]
    assert pt.idle_share((10 * MS, 20 * MS), cpu, dev, {'gsum.grid'}) \
        == pytest.approx(60.0)


def test_no_span_reads_none():
    cpu = [(0, 8 * MS, 'aten::mm'), (0, 9 * MS, 'other.fit')]
    assert pt.idle_share((0, 10 * MS), cpu, [], {'gsum.fit'}) is None
    assert pt.idle_share((0, 10 * MS), [], [], {'gsum.grid'}) is None


def test_reduce_is_wrapped_for_the_probe_alone():
    from types import SimpleNamespace

    from portbench import trace

    inner = trace.reduce
    r = SimpleNamespace(probes={}, trace=None)
    with pt.probe(r), pt.probe(r):
        win = (0, 10 * MS)
        cpu = [(0, 8 * MS, 'gsum.grid')]
        dev = [(1 * MS, 2 * MS, 'k'), (0, 8 * MS, 'gsum.grid')]
        r.trace = trace.reduce(win, cpu, dev, 1)
        assert trace.reduce is not inner
    assert trace.reduce is inner
    # the span drawn on the device is no device work
    assert r.trace.busy_s == pytest.approx(0.001)
    assert 'gsum.grid' not in r.trace.device_ops
    assert pt.idle_in(r, {'gsum.grid'}) == pytest.approx(70.0)
    assert pt.ratio(r, 'chol.matrices', 'grid.thetas') is None


def test_every_new_entry_has_its_file_and_cells():
    bench, _ = load(ROOT)
    cells = {w['name'] for w in bench['workloads']}
    entries = {m['name']: m for m in bench['per_layer'] if m['name'] in NEW}
    assert set(entries) == NEW
    for name, m in entries.items():
        assert (ROOT / 'portbench' / 'metrics' / f'{name}.py').is_file()
        assert m['workloads'] and set(m['workloads']) <= cells
        assert m['source'] in ('program_span', 'program_counter')


@pytest.mark.parametrize('cell', ['nn350.fits', 'e2d4096.fits',
                                  'nn350.grid'])
def test_a_traced_run_reports_them_in_their_cells(small, cell):
    spec = small(cell)
    result, _ = run.execute(spec, 2 ** 33 + 5, 0.01, 1, 'cpu')
    got = result['metrics']
    listed = {m['name'] for m in spec.per_layer}
    # k1_roofline reads K1's launches, which the CPU does not make
    assert listed - set(got) <= {'k1_roofline'}
    assert set(got) <= listed and set(got) & NEW == listed & NEW
    value = {k: v['value'] for k, v in got.items()}
    if cell.endswith('.fits'):
        tr = spec.traffic
        # on the CPU both fits cells take a twice-factoring engine
        rows = 1 + tr['maxiter'] * (tr['ls_steps'] + 1)
        assert value['fits.factorizations_per_fit'] == 2 * rows + 1
        assert value['fits.idle_optimizer'] + value['fits.idle_objective'] \
            <= value['fits.idle_in_program'] + 1e-9
        assert value['fits.idle_in_program'] <= \
            value['device_idle.fits'] + 1e-9
        assert value['fits.idle_objective'] > 0
    else:
        assert value['grid.factorizations_per_theta'] == 2.0
        assert 0 < value['grid.idle_in_program'] <= \
            value['device_idle.grid'] + 1e-9
