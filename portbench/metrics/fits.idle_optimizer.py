"""fits.idle_optimizer: the share of the traced window in which the host
was inside ``gsum.lbfgs.step`` (one L-BFGS iteration) but outside its
``gsum.lbfgs.line_search`` and ``gsum.lbfgs.gradient`` (the optimizer's own
ops: two-loop, trust cap, history push) and nothing ran on the device, in
percent."""
from portbench.program_trace import idle_in, probe  # noqa: F401


def read(run):
    return idle_in(run, {'gsum.lbfgs.step'},
                   {'gsum.lbfgs.line_search', 'gsum.lbfgs.gradient'})
