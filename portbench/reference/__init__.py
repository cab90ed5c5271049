R"""Plain PyTorch reference of what the benchmark's cells compute.

Written from the mathematics of the conjugate Gaussian process and the
truncation model (Melendez et al., arXiv:1904.10581, appendix A), with
``torch.linalg`` and elementwise operations only.  It imports nothing of
the program under test, nor ``jax``, and takes none of the program's
tables: it is given the inputs that the harness made and, to judge them,
the program's answers.
"""
from .gp import (PRECISIONS, Prior, coefficients, correlation, lml_and_scale,
                 log_change_of_variables, maximize_lml, sqdist,
                 truncation_lml_surface, truncation_predict)

__all__ = ['PRECISIONS', 'Prior', 'coefficients', 'correlation',
           'lml_and_scale', 'log_change_of_variables', 'maximize_lml',
           'sqdist', 'truncation_lml_surface', 'truncation_predict']
