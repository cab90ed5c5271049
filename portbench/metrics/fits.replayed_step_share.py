"""fits.replayed_step_share: the share of the traced calls' L-BFGS
iterations that replayed a captured CUDA graph (the program's counter
``lbfgs.steps_replayed``) among all of them (``lbfgs.steps``), in percent.
A program that counts no iteration reports nothing."""
from portbench.program_trace import probe, ratio  # noqa: F401


def read(run):
    share = ratio(run, 'lbfgs.steps_replayed', 'lbfgs.steps')
    return None if share is None else 100.0 * share
