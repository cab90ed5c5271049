"""fits_mfu: the least operations the traced fits need (portbench.counts:
the fixed trip's forwards and gradients), over the traced window's length
times the card's 67 TFLOP/s, in percent."""
from portbench.counts import PEAK_FLOP_PER_S


def read(run):
    if run.unit != 'fits' or run.trace is None or not run.trace.calls:
        return None
    flops = run.work.flops_per_call() * run.trace.calls
    return 100.0 * flops / (run.trace.window_s * PEAK_FLOP_PER_S)
