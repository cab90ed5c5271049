"""``gsum_tpu_torch.profiling``'s spans and counters on the CPU.

A span enters ``torch.profiler.record_function`` only while a profiler
runs; under one, a small ``batched_fit`` and ``truncation_lml_grid`` give
their ``gsum.*`` spans, nested as the calls are.  The counters of
factorizations, fitted rows and grid rows equal the closed forms derived
from the code: per fit row, ``(1 + maxiter·(ls_steps + 1))`` objective rows,
each factored twice by the scan engine (``ops.gridlml._safe_factor``) or
once by the blocked one, plus one posterior Cholesky; per θ row of a
truncation surface, two.  The kernels' launches are registry counters, not
function attributes.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gsum_tpu_torch as gt
from gsum_tpu_torch import ops, profiling
from gsum_tpu_torch.parallel import batched_fit, truncation_lml_grid

from _port import one_intra_op_thread  # noqa: F401 (autouse)

N, B, MAXITER, LS_STEPS = 40, 3, 2, 3


def _data(B=B, m=2, seed=0):
    rng = np.random.RandomState(seed)
    X = torch.linspace(0.05, 1, N, dtype=torch.float64)[:, None]
    y = torch.tensor(rng.randn(B, N, m), dtype=torch.float64)
    return X, y


def _fit(engine='scan', precision='f64'):
    X, y = _data()
    return batched_fit(gt.RBF(0.3, (1e-2, 10)), X, y, df=3, maxiter=MAXITER,
                       ls_steps=LS_STEPS, engine=engine, precision=precision)


def _spans(prof):
    """(name, start_ns, end_ns) of every ``gsum.`` span, in start order."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith('gsum.')), key=lambda s: s[1])


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _delta(fn):
    before = profiling.counters()
    fn()
    after = profiling.counters()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) entered')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert not torch.autograd._profiler_enabled()
    with profiling.span('gsum.fit'):
        with profiling.span('gsum.lbfgs.step'):
            pass
    assert profiling.span('a') is profiling.span('b')   # one shared no-op
    _fit()                                # every span of the fit, untraced


def test_span_lands_in_a_running_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span('gsum.outer'):
            with profiling.span('gsum.inner'):
                torch.ones(4).sum()
    (outer, inner) = sorted(_spans(prof))[::-1]
    assert (outer[0], inner[0]) == ('gsum.outer', 'gsum.inner')
    assert _within(inner, outer)


def test_counters_add_host_ints_and_return_a_copy(monkeypatch):
    monkeypatch.setattr(profiling, '_COUNTS', type(profiling._COUNTS)())
    profiling.count('a.rows')
    profiling.count('a.rows', 4)
    seen = profiling.counters()
    seen['a.rows'] = 100
    assert profiling.counters() == {'a.rows': 5}
    assert profiling.counters()['never.counted'] == 0
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_batched_fit_spans_nest_as_the_optimizer_runs():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit()
    spans = _spans(prof)
    fits = [s for s in spans if s[0] == 'gsum.fit']
    steps = [s for s in spans if s[0] == 'gsum.lbfgs.step']
    searches = [s for s in spans if s[0] == 'gsum.lbfgs.line_search']
    grads = [s for s in spans if s[0] == 'gsum.lbfgs.gradient']
    assert len(fits) == 1 and len(steps) == MAXITER
    assert len(searches) == MAXITER and len(grads) == MAXITER + 1
    assert all(_within(s, fits[0]) for s in spans)
    # the first gradient is the optimizer's start, before any step
    assert grads[0][2] <= steps[0][1]
    for step in steps:
        (search,) = [s for s in searches if _within(s, step)]
        (grad,) = [s for s in grads if _within(s, step)]
        assert search[2] <= grad[1]       # the line search, then the move
    assert {s[0] for s in spans} == {'gsum.fit', 'gsum.lbfgs.step',
                                     'gsum.lbfgs.line_search',
                                     'gsum.lbfgs.gradient'}


@pytest.mark.parametrize('engine,factored', [('scan', 2), ('blocked', 1)])
def test_fit_counts_match_the_closed_form(engine, factored):
    got = _delta(lambda: _fit(engine))
    rows = 1 + MAXITER * (LS_STEPS + 1)
    assert got == {'chol.matrices': B * (rows * factored + 1),
                   'fit.rows': B}


def test_mixed_precision_fit_is_one_span_over_both_sweeps():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _delta(lambda: _fit('scan', 'mixed'))
    fits = [s for s in _spans(prof) if s[0] == 'gsum.fit']
    outer = max(fits, key=lambda s: s[2] - s[1])
    assert all(_within(s, outer) for s in _spans(prof))
    assert got['fit.rows'] == 2 * B       # the f32 sweep, then the polish


@pytest.mark.parametrize('process', ['gp', 'tp'])
def test_truncation_grid_counts_two_factorizations_a_theta(process):
    X, _ = _data()
    y = torch.cumsum(torch.tensor(np.random.RandomState(1).randn(N, 4)), 1)
    thetas = torch.log(torch.linspace(0.1, 1, 5, dtype=torch.float64))[:, None]
    ratios = torch.linspace(0.3, 0.7, 6, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _delta(lambda: truncation_lml_grid(
            gt.RBF(0.3), X, y, np.arange(4), ratios, thetas, ref=2.0, df=3,
            process=process))
    assert got == {'chol.matrices': 2 * 5, 'grid.thetas': 5}
    assert [s[0] for s in _spans(prof)] == ['gsum.grid']


def test_one_registry_no_launches_attribute_and_no_flops_fit():
    kernels = (ops.chol_inv_block, ops.rbf_covariance_pallas,
               ops.fused_blocked_cholesky, ops.incbeta.betainc,
               ops.incbeta.betaincinv)
    assert not any(hasattr(k, 'launches') for k in kernels)
    assert not any(hasattr(getattr(ops, name), 'launches')
                   for name in dir(ops))
    assert not hasattr(profiling, 'flops_fit')
    # on the CPU the kernels' plain versions run and no launch is counted
    A = torch.eye(32, dtype=torch.float32)[None] * 2
    assert _delta(lambda: ops.chol_inv_block(A)) == {}
