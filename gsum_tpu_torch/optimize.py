R"""Kernel-hyperparameter MAP optimization (counterpart of
``gsum_tpu/optimize.py``).

Two kinds of engine:

- :func:`scipy_lbfgsb` runs scipy's L-BFGS-B on the host against an
  objective that returns numpy ``(f, grad)``; the models' objective
  evaluates the log-marginal likelihood and its autograd gradient on the
  model's device and copies the two back in one transfer, the only
  synchronisation of a fit.
- The bounded L-BFGS engines (:func:`fixed_lbfgs_bounded`,
  :func:`fixed_lbfgs_bounded_batched`, :func:`jit_lbfgs_bounded`) remove the
  box constraints with a sigmoid / softplus reparameterization
  (:func:`_to_bounded`) and run on the device.  The two fixed-trip engines
  take exactly ``maxiter`` iterations with no host synchronisation: every
  ``jnp.where`` of the JAX package is a ``torch.where``, so the device's
  queue never waits for the host.  Their state is float64 whatever the
  objective's dtype (JAX's ``result_type(float)`` under x64).

Gradients come from ``torch.autograd.grad``.  The batched engine's
value-and-gradient is one backward of ``F.sum()``: the fits are
independent, so this is JAX's vjp with a vector of ones.  The vectorized
line search runs under ``torch.no_grad()``, so that the ``ls_steps × B``
trial evaluations keep no autograd graph alive.
"""
from __future__ import annotations

import warnings

import torch

from ._config import as_input
from .profiling import span

__all__ = ['scipy_lbfgsb', 'jit_lbfgs_bounded', 'fixed_lbfgs_bounded',
           'fixed_lbfgs_bounded_batched', 'ConvergenceWarning']


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


# Per-iteration trust cap in z (logit) units for the bounded engines.  The
# usable range of the sigmoid reparameterization is about ±15 logit units
# (beyond that the box coordinate is within 1e-7 of its bound and the
# z-gradient is exponentially small), so 2 units per iteration is plenty of
# progress while the saturated tail stays out of reach of one jump.
_ZSTEP = 2.0


def _sides(lo, hi):
    lo_f, hi_f = torch.isfinite(lo), torch.isfinite(hi)
    both = lo_f & hi_f
    lo_s = torch.where(lo_f, lo, 0.0)
    hi_s = torch.where(hi_f, hi, 0.0)
    span = torch.where(both, hi - lo, 1.0)
    return lo_f, hi_f, both, lo_s, hi_s, span


def _to_unbounded(theta, lo, hi):
    """Maps box-constrained theta to an unconstrained z.

    Two-sided boxes use the logit, one-sided bounds the softplus inverse,
    and an infinite box the identity.  Every branch is evaluated with
    sanitized operands, so the discarded branches of the ``where`` hold no
    0·inf that would poison gradients.
    """
    lo_f, hi_f, both, lo_s, hi_s, span = _sides(lo, hi)
    # clip strictly inside the box so that the logit stays finite
    t = torch.clamp((theta - lo_s) / span, 1e-10, 1 - 1e-10)
    z_box = torch.log(t) - torch.log1p(-t)
    # softplus inverse, stable at both ends:
    # log(expm1(d)) = d + log(-expm1(-d))
    d_lo = torch.clamp(theta - lo_s, min=1e-10)
    z_lo = d_lo + torch.log(-torch.expm1(-d_lo))
    d_hi = torch.clamp(hi_s - theta, min=1e-10)
    z_hi = d_hi + torch.log(-torch.expm1(-d_hi))
    return torch.where(both, z_box,
                       torch.where(lo_f, z_lo, torch.where(hi_f, z_hi, theta)))


def _softplus(z):
    # jax.nn.softplus is logaddexp(z, 0); torch's softplus switches to the
    # identity above a threshold, which differs by up to exp(-20)
    return torch.logaddexp(z, torch.zeros_like(z))


def _to_bounded(z, lo, hi):
    """Inverse of :func:`_to_unbounded` (sigmoid / softplus / identity)."""
    lo_f, hi_f, both, lo_s, hi_s, span = _sides(lo, hi)
    x_box = lo_s + span * torch.sigmoid(z)
    x_lo = lo_s + _softplus(z)
    x_hi = hi_s - _softplus(z)
    return torch.where(both, x_box,
                       torch.where(lo_f, x_lo, torch.where(hi_f, x_hi, z)))


def _bounds(lower, upper, P, device):
    dtype = torch.float64
    lo = torch.as_tensor(lower, dtype=dtype, device=device)
    hi = torch.as_tensor(upper, dtype=dtype, device=device)
    return lo.broadcast_to((P,)), hi.broadcast_to((P,))


class _Lbfgs:
    """Lockstep bounded L-BFGS over a batch of independent problems.

    ``zfun_b`` maps (B, P) unconstrained points to (B,) float64 values.
    One :meth:`step` is one iteration of the JAX package's fixed-trip
    engine: two-loop direction over a rolled history (index 0 newest),
    steepest descent where that is no descent direction, the ``_ZSTEP``
    trust cap, one wide Armijo line search over ``ls_steps`` geometric
    trial steps, and a move only where it improves.

    Spans (``profiling.span``): ``gsum.lbfgs.step`` around each iteration,
    ``gsum.lbfgs.line_search`` around its wide trial evaluation and
    ``gsum.lbfgs.gradient`` around every value and gradient.
    """

    def __init__(self, zfun_b, Z0, history, ls_steps):
        self.zfun_b, self.h, self.ls_steps = zfun_b, history, ls_steps
        B, P = Z0.shape
        dtype, dev = Z0.dtype, Z0.device
        self.ts = 0.5 ** torch.arange(ls_steps, dtype=dtype, device=dev)
        self.Z = Z0
        self.F, self.G = self.value_and_grad(Z0)
        self.S = torch.zeros((history, B, P), dtype=dtype, device=dev)
        self.Y = torch.zeros((history, B, P), dtype=dtype, device=dev)
        self.rho = torch.zeros((history, B), dtype=dtype, device=dev)
        self.m = torch.zeros(B, dtype=torch.int64, device=dev)

    def value_and_grad(self, Z):
        Z = Z.detach().requires_grad_(True)
        with span('gsum.lbfgs.gradient'), torch.enable_grad():
            F = self.zfun_b(Z)
            if F.requires_grad:
                (G,) = torch.autograd.grad(F.sum(), Z, allow_unused=True)
            else:
                G = None
        if G is None:                     # the objective ignores Z
            G = torch.zeros_like(Z)
        return F.detach(), G.detach()

    def _two_loop(self, G):
        S, Y, rho, m = self.S, self.Y, self.rho, self.m
        q = G
        alphas = []
        for i in range(self.h):
            a = torch.where(i < m, rho[i] * torch.sum(S[i] * q, -1), 0.0)
            q = q - a[:, None] * Y[i]
            alphas.append(a)
        ysy = torch.sum(Y[0] * Y[0], -1)
        gamma = torch.where((m > 0) & (ysy > 0),
                            torch.sum(S[0] * Y[0], -1)
                            / torch.clamp(ysy, min=1e-30), 1.0)
        r = gamma[:, None] * q
        for i in reversed(range(self.h)):
            valid = i < m
            b = torch.where(valid, rho[i] * torch.sum(Y[i] * r, -1), 0.0)
            r = r + torch.where(valid, alphas[i] - b, 0.0)[:, None] * S[i]
        return r

    def step(self):
        with span('gsum.lbfgs.step'):
            self._step()

    def _step(self):
        Z, F, G = self.Z, self.F, self.G
        B, P = Z.shape
        D = -self._two_loop(G)
        gd = torch.sum(G * D, -1)
        descent = gd < 0
        D = torch.where(descent[:, None], D, -G)
        gd = torch.where(descent, gd, -torch.sum(G * G, -1))

        # trust cap per problem: an uncapped step saturates the sigmoid and
        # strands the iterate at a box bound
        tcap = torch.clamp(_ZSTEP / torch.clamp(
            torch.amax(torch.abs(D), -1), min=1e-30), max=1.0)
        ts_eff = self.ts[:, None] * tcap[None]               # (L, B)

        # one wide line search: every trial of every problem, no graph kept
        Zt = Z[None] + ts_eff[:, :, None] * D[None]          # (L, B, P)
        with span('gsum.lbfgs.line_search'), torch.no_grad():
            Ft = self.zfun_b(Zt.reshape(-1, P)).reshape(self.ls_steps, B)
        ok = (Ft <= F[None] + 1e-4 * ts_eff * gd[None]) & torch.isfinite(Ft)
        any_ok = ok.any(0)
        idx = torch.argmax(ok.to(torch.uint8), 0)            # first accepted
        t = torch.where(any_ok, ts_eff.gather(0, idx[None])[0], 0.0)

        Z_new = Z + t[:, None] * D
        F_new, G_new = self.value_and_grad(Z_new)
        improved = any_ok & (F_new <= F)
        Z_new = torch.where(improved[:, None], Z_new, Z)
        F_new = torch.where(improved, F_new, F)
        G_new = torch.where(improved[:, None], G_new, G)

        s = Z_new - Z
        yv = G_new - G
        curv = torch.sum(s * yv, -1)
        store = improved & (curv > 1e-12)

        def push(buf, new):
            rolled = torch.roll(buf, 1, 0)
            rolled = torch.cat([new[None], rolled[1:]], 0)
            shape = (1, B) + (1,) * (buf.ndim - 2)
            return torch.where(store.reshape(shape), rolled, buf)

        self.S = push(self.S, s)
        self.Y = push(self.Y, yv)
        self.rho = push(self.rho, 1.0 / torch.clamp(curv, min=1e-30))
        self.m = torch.where(store, torch.clamp(self.m + 1, max=self.h),
                             self.m)
        self.Z, self.F, self.G = Z_new, F_new, G_new


def fixed_lbfgs_bounded_batched(fun_b, X0, lower, upper, maxiter=50,
                                history=8, ls_steps=10):
    R"""Lockstep batched bounded L-BFGS with a fixed trip count.

    ``fun_b`` evaluates the objective for a whole batch at once,
    ``(B, P) -> (B,)``.  Every step and every line-search trial is one wide
    call: the line search evaluates all ``ls_steps × B`` candidates as one
    ``(ls_steps·B, P)`` batch (trial l of fit b at row ``l·B + b``), under
    ``torch.no_grad()``.  The gradient is one backward of ``fun_b(Z).sum()``.

    Exactly ``maxiter`` iterations, with no host synchronisation.

    Returns ``(X_opt (B, P), f_opt (B,))``, both float64.
    """
    X0 = as_input(X0)
    B, P = X0.shape
    lo, hi = _bounds(lower, upper, P, X0.device)

    def zfun_b(Z):
        return fun_b(_to_bounded(Z, lo, hi)).to(torch.float64)

    Z0 = _to_unbounded(X0.to(torch.float64), lo, hi)
    opt = _Lbfgs(zfun_b, Z0, history, ls_steps)
    for _ in range(maxiter):
        opt.step()
    return _to_bounded(opt.Z, lo, hi), opt.F


def _rows(fun):
    """A scalar objective of a 1-D tensor as a batched one, row by row (the
    objective need not vmap)."""
    def fun_b(X):
        return torch.stack([torch.as_tensor(fun(x)).reshape(())
                            .to(torch.float64) for x in X])
    return fun_b


def fixed_lbfgs_bounded(fun, x0, lower, upper, maxiter=50, history=8,
                        ls_steps=10):
    R"""Bounded L-BFGS of one scalar objective with fixed-trip control flow.

    The single-problem form of :func:`fixed_lbfgs_bounded_batched` (the JAX
    package's two engines share one iteration): exactly ``maxiter``
    iterations, a two-loop recursion over a rolled history buffer, and a
    vectorized backtracking line search (the ``ls_steps`` trial points are
    evaluated in one pass under ``torch.no_grad()`` and the first
    Armijo-acceptable step is taken).  ``fun`` maps a 1-D tensor to a
    scalar; it is called once per trial point, so it need not vmap.

    Returns ``(x_opt, f_opt)``, float64.
    """
    x0 = as_input(x0)
    X, F = fixed_lbfgs_bounded_batched(_rows(fun), x0[None], lower, upper,
                                       maxiter=maxiter, history=history,
                                       ls_steps=ls_steps)
    return X[0], F[0]


# line-search trial steps of jit_lbfgs_bounded: 1 … 2^-29, so that it can
# still step where the minimiser is close
_JIT_LS_STEPS = 30


def jit_lbfgs_bounded(fun, x0, lower, upper, maxiter=200, tol=1e-10):
    R"""Minimizes ``fun`` subject to ``lower <= x <= upper``.

    The JAX package builds this on ``optax.lbfgs`` (zoom line search inside
    a ``while_loop``).  optax has no PyTorch counterpart, so the port runs
    the fixed-trip engine's iteration (:func:`fixed_lbfgs_bounded`: the
    same reparameterization, two-loop direction, trust cap and vectorized
    Armijo backtracking, here over 30 trial steps 1 … 2^-29) in a
    host loop that stops early once the gradient norm in z is at most
    ``tol`` or an iteration no longer moves.  Each iteration reads the
    gradient norm on the host, one synchronisation per iteration.  The
    iterates differ from optax's; the minimiser is the same.
    Non-finite objective values (a failed Cholesky's ``-inf`` lml) are
    rejected by the line search.

    Parameters
    ----------
    fun : scalar objective of a 1-D tensor
    x0, lower, upper : arrays of identical shape
    maxiter : int — at most this many iterations
    tol : float — gradient-norm stopping tolerance (in z-space)

    Returns
    -------
    x_opt (in ``x0``'s dtype), f_opt (float64)
    """
    x0 = as_input(x0)
    P = x0.shape[0]
    lo, hi = _bounds(lower, upper, P, x0.device)
    fun_b = _rows(fun)

    def zfun_b(Z):
        return fun_b(_to_bounded(Z, lo, hi))

    opt = _Lbfgs(zfun_b, _to_unbounded(x0.to(torch.float64), lo, hi)[None],
                 8, _JIT_LS_STEPS)
    for _ in range(maxiter):
        if float(torch.linalg.vector_norm(opt.G)) <= tol:
            break
        Z_before = opt.Z
        opt.step()
        if torch.equal(opt.Z, Z_before):
            break
    return _to_bounded(opt.Z[0], lo, hi).to(x0.dtype), opt.F[0]
