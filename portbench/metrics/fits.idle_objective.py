"""fits.idle_objective: the share of the traced window in which the host
was inside ``gsum.lbfgs.line_search`` or ``gsum.lbfgs.gradient`` (the
objective's forwards and its autograd gradient) and nothing ran on the
device, in percent."""
from portbench.program_trace import idle_in, probe  # noqa: F401


def read(run):
    return idle_in(run, {'gsum.lbfgs.line_search', 'gsum.lbfgs.gradient'})
