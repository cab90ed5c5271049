"""grid.idle_in_program: the share of the traced window in which the host
was inside the program's ``gsum.grid`` span
(``parallel.truncation_lml_grid``, the whole call) and nothing ran on the
device, in percent."""
from portbench.program_trace import idle_in, probe  # noqa: F401


def read(run):
    return idle_in(run, {'gsum.grid'})
