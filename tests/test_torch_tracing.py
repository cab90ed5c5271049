"""``gsum_tpu_torch.profiling``'s spans and counters on the CPU.

A span enters ``torch.profiler.record_function`` only while a profiler
runs; under one, a small ``batched_fit`` and ``truncation_lml_grid`` give
their ``gsum.*`` spans, nested as the calls are.  The counters of
factorizations, fitted rows and grid rows equal the closed forms derived
from the code: per fit row, ``(1 + maxiter·(ls_steps + 1))`` objective rows,
each factored twice by the scan engine (``ops.gridlml._safe_factor``) or
once by the blocked one, plus one posterior Cholesky; per θ row of a
truncation surface, two.  ``lbfgs.steps`` counts ``maxiter`` a chunk, and
on the CPU no step is replayed from a CUDA graph (the rule
``parallel.batched._graphed``).  The kernels' launches are registry
counters, not function attributes.
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
                   'fit.rows': B, 'lbfgs.steps': MAXITER}


def test_lbfgs_steps_count_every_chunk_and_none_replay_on_the_cpu():
    X, y = _data()
    got = _delta(lambda: batched_fit(
        gt.RBF(0.3, (1e-2, 10)), X, y, df=3, maxiter=3, ls_steps=LS_STEPS,
        chunk=2, engine='blocked'))
    assert got['lbfgs.steps'] == 3 * 2            # maxiter × chunks
    assert 'lbfgs.steps_replayed' not in got      # counted 0


_CUDA = torch.device('cuda')   # a device name: no card is asked for


@pytest.mark.parametrize('device,engine,maxiter,graphed', [
    (torch.device('cpu'), 'blocked', 20, False),
    (_CUDA, None, 20, False),                     # scalar engine
    (_CUDA, 'scan', 4, False),                    # below threshold
    (_CUDA, 'blocked', 5, True),
    (_CUDA, 'unrolled', 20, True),
    (_CUDA, 'scan', 20, True),
])
def test_graph_rule_reads_device_engine_trip_and_kernel(device, engine,
                                                        maxiter, graphed):
    from gsum_tpu_torch.parallel.batched import _GRAPH_MIN_ITER, _graphed

    assert _GRAPH_MIN_ITER == 5
    assert _graphed(device, engine, maxiter) is graphed


def test_releasing_graph_memory_with_none_kept_does_nothing():
    from gsum_tpu_torch import optimize

    assert optimize._LAST_GRAPH == {}
    optimize.release_graph_memory()
    assert 'release_graph_memory' in optimize.__all__


@pytest.mark.parametrize('kernel,name', [
    (gt.RBF([0.3, 0.5], 'fixed'), 'length_scale'),
    (gt.ConstantKernel(2.0, 'fixed'), 'constant_value'),
])
def test_a_fixed_hyperparameter_is_built_once_for_its_value(kernel, name):
    """A kernel's fixed hyperparameter is built on the device once and kept
    (a value of several entries is a copy from the host, which no CUDA
    graph can hold), and built again when the value changes."""
    theta = torch.zeros(0, dtype=torch.float64)
    first = kernel._resolve(theta)[name]
    assert kernel._resolve(theta)[name] is first
    setattr(kernel, name, 2 * np.asarray(getattr(kernel, name)))
    again = kernel._resolve(theta)[name]
    assert again is not first and torch.equal(again, 2 * first)
    assert torch.equal(kernel.clone()._resolve(theta)[name], again)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('center,disp,df', [(0.0, 0.0, 3.0),
                                            (0.4, 2.0, 3.0),
                                            (-0.2, 0.5, np.inf)])
def test_fit_prior_built_once_gives_todays_values(dtype, center, disp, df):
    """The fit objective's priors, built once as float64 tensors and cast
    on the device, are the host conversions ``cgp_lml_grid`` made at every
    call, and give its lml bit for bit."""
    from gsum_tpu_torch.ops.gridlml import _cgp_lml_grid, _prior

    X, y = _data(B=1)
    R = torch.exp(-0.5 * (X - X.T)[None] ** 2
                  / torch.tensor([0.05, 0.1])[:, None, None] ** 2) \
        + 1e-2 * torch.eye(N, dtype=torch.float64)
    R, y, basis = R.to(dtype), y[0].to(dtype), torch.ones(N, 1, dtype=dtype)
    prior = _prior(center, disp, df, R.device)
    assert torch.equal(prior.center0.to(dtype), torch.as_tensor(
        np.atleast_1d(np.asarray(center, dtype=float)), dtype=dtype))
    if disp:
        assert torch.equal(prior.disp0_inv.to(dtype), torch.as_tensor(
            np.linalg.inv(np.atleast_2d(disp)), dtype=dtype))
    else:
        assert prior.disp0_inv is None
    for engine in ('unrolled', 'scan', 'blocked'):
        want = ops.cgp_lml_grid(R, y, basis, center, disp, df, 1.3,
                                engine=engine, block=32)
        got = _cgp_lml_grid(R, y, basis, prior, df, 1.3, engine=engine,
                            block=32)
        assert torch.isfinite(want).all() and torch.equal(got, want)


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
