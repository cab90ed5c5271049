"""grid_mfu: the least operations of the traced surfaces (portbench.counts:
per θ a build, a Cholesky and the basis solves; per (θ, ratio) the
coefficient curves' solves), over the traced window's length times the
card's 67 TFLOP/s, in percent."""
from portbench.counts import PEAK_FLOP_PER_S


def read(run):
    if run.unit != 'evals' or run.trace is None or not run.trace.calls:
        return None
    flops = run.work.flops_per_call() * run.trace.calls
    return 100.0 * flops / (run.trace.window_s * PEAK_FLOP_PER_S)
