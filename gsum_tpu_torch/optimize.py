R"""Kernel-hyperparameter MAP optimization (counterpart of the host engine
of ``gsum_tpu/optimize.py``).

:func:`scipy_lbfgsb` runs scipy's L-BFGS-B on the host against an objective
that returns numpy ``(f, grad)``; the objective evaluates the
log-marginal likelihood and its autograd gradient on the model's device and
copies the two back in one transfer, the only synchronisation of a fit.

Not ported yet: the fixed-trip batched engines ``fixed_lbfgs_bounded``,
``fixed_lbfgs_bounded_batched`` and ``jit_lbfgs_bounded`` (ROADMAP.md
queue A, batched throughput).
"""
from __future__ import annotations

import warnings

__all__ = ['scipy_lbfgsb', 'ConvergenceWarning']


try:  # sklearn's warning class if present, else a local stand-in
    from sklearn.exceptions import ConvergenceWarning
except Exception:  # pragma: no cover
    class ConvergenceWarning(UserWarning):
        pass


def scipy_lbfgsb(obj_func, initial_theta, bounds):
    """L-BFGS-B via scipy on the host; ``obj_func(theta)`` returns numpy
    ``(f, grad)``.  Warns with :class:`ConvergenceWarning` when scipy
    reports an abnormal termination.  Returns ``(theta_opt, f_min)``."""
    from scipy.optimize import fmin_l_bfgs_b

    theta_opt, func_min, convergence_dict = fmin_l_bfgs_b(
        obj_func, initial_theta, bounds=bounds)
    if convergence_dict["warnflag"] != 0:
        warnings.warn("fmin_l_bfgs_b terminated abnormally with the "
                      " state: %s" % convergence_dict,
                      ConvergenceWarning)
    return theta_opt, func_min
