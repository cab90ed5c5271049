R"""Operation and byte counts of the work the cells ask for, and the peaks
of the card they are held against.

Copied, not imported: ``flops_lml`` is ``gsum_tpu_torch.profiling.flops_lml``;
``bound`` and ``bound_chol_inv`` are ``chip_smoke.py``'s.  The counts are
the least work the answers need, from their shapes, not what an algorithm
happens to do.
"""
from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense): 67 TFLOP/s float32 outside the
# tensor cores and float64 on them, 3.35 TB/s of HBM3
PEAK_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def flops_lml(n, n_curves=1, n_params=1):
    """One log-marginal likelihood: kernel build, Cholesky, triangular
    solves, log-determinant."""
    cov = 2.0 * n * n * n_params + 6.0 * n * n
    chol = n ** 3 / 3.0
    solves = 2.0 * n * n * (n_curves + 2)
    return cov + chol + solves


def flops_lml_gradient(n, n_params=1):
    """The gradient of one lml beyond its forward: L⁻¹ and R⁻¹ from the
    factor (2n³/3) and the trace products with ∂R/∂θ (2n²P)."""
    return 2.0 * n ** 3 / 3.0 + 2.0 * n * n * n_params


def flops_fixed_trip_fit(n, n_curves, n_params, maxiter, ls_steps):
    """One fit of the lockstep L-BFGS: a value and gradient at the start,
    then per iteration ``ls_steps`` line-search forwards and a value and
    gradient at the step taken."""
    forwards = 1 + maxiter * (ls_steps + 1)
    gradients = 1 + maxiter
    return (forwards * flops_lml(n, n_curves, n_params)
            + gradients * flops_lml_gradient(n, n_params))


def flops_truncation_grid(n, n_curves, n_params, n_theta, n_ratio,
                          n_basis=1):
    """The (θ, ratio) surface: per θ one covariance build, one Cholesky and
    the basis solves; per (θ, ratio) the two triangular solves of that
    ratio's coefficient curves."""
    per_theta = (2.0 * n * n * n_params + 6.0 * n * n + n ** 3 / 3.0
                 + 2.0 * n * n * n_basis)
    return n_theta * per_theta + n_theta * n_ratio * 2.0 * n * n * n_curves


def bound(nbytes, flops, flop_rate=PEAK_FLOP_PER_S):
    """Least seconds on the card for this many bytes and operations, and
    which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def bound_chol_inv(b, nb):
    """K1 on b blocks of nb × nb float32: reads A's lower triangle, writes L
    and L⁻¹; nb³/3 flops for L and nb³/3 for L⁻¹."""
    return bound(4 * b * (nb * (nb + 1) // 2 + 2 * nb * nb),
                 b * 2.0 * nb ** 3 / 3)
