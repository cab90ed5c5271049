"""grid.factorizations_per_theta: covariance matrices factored over the
traced calls (the program's counter ``chol.matrices``) per θ row of the
surfaces (``grid.thetas``): a count, the same on every run of a
program."""
from portbench.program_trace import probe, ratio  # noqa: F401


def read(run):
    return ratio(run, 'chol.matrices', 'grid.thetas')
