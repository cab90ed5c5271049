"""fits.factorizations_per_fit: covariance matrices factored over the
traced calls (the program's counter ``chol.matrices``) per fitted row
(``fit.rows``): a count, the same on every run of a program."""
from portbench.program_trace import probe, ratio  # noqa: F401


def read(run):
    return ratio(run, 'chol.matrices', 'fit.rows')
