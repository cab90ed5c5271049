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

import functools
import warnings

import torch

from ._config import as_input
from .profiling import _recorded, count, span

__all__ = ['scipy_lbfgsb', 'jit_lbfgs_bounded', 'fixed_lbfgs_bounded',
           'fixed_lbfgs_bounded_batched', 'release_graph_memory',
           'ConvergenceWarning']


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


@functools.cache
def _side_stream(device):
    """The side stream of every capture on the CUDA ``device``, one for the
    process: the caching allocator keeps its blocks per stream, so a new
    stream at every capture would keep a step's memory of its own."""
    return torch.cuda.Stream(device)


# device -> the graph captured last there.  Every capture on a device
# shares one memory pool, which this graph keeps alive between calls, so
# that the next call's captures allocate nothing.  The allocator frees a
# pool whose graphs are gone only when an allocation outside a capture
# fails, so a pool per capture piled up until an allocation inside one
# failed.  The pool is as large as the largest step captured there.
_LAST_GRAPH = {}


def release_graph_memory():
    """Returns to the card the memory that the fits' captured steps keep.

    On the card, ``parallel.batched_fit`` replays each chunk's L-BFGS
    iteration as a CUDA graph.  Every capture on a device shares one
    memory pool, as large as the largest step captured there (6.8 GB at
    179 fits of N = 350 in float64), and the pool stays reserved between
    calls, so that the next call's captures allocate nothing;
    ``torch.cuda.empty_cache`` cannot return it.  This waits for the
    card, drops the kept graphs and empties the cache.  The next fit
    builds a new pool.
    """
    for dev in list(_LAST_GRAPH):
        torch.cuda.synchronize(dev)
    _LAST_GRAPH.clear()
    torch.cuda.empty_cache()


class _Lbfgs:
    """Lockstep bounded L-BFGS over a batch of independent problems.

    ``zfun_b`` maps (B, P) unconstrained points to (B,) float64 values.
    One :meth:`step` is one iteration of the JAX package's fixed-trip
    engine: two-loop direction over a rolled history (index 0 newest),
    steepest descent where that is no descent direction, the ``_ZSTEP``
    trust cap, one wide Armijo line search over ``ls_steps`` geometric
    trial steps, and a move only where it improves.

    The state (Z, F, G and the history S, Y, rho, m) lives in buffers
    allocated once, and every iteration writes its new state into them
    with ``copy_``; so one iteration's body can be captured as a CUDA
    graph and replayed (:meth:`run`), the same body as the eager step.

    Spans (``profiling.span``): ``gsum.lbfgs.step`` around each iteration
    (a replay included), ``gsum.lbfgs.line_search`` around its wide trial
    evaluation and ``gsum.lbfgs.gradient`` around every value and
    gradient.  Counters: ``lbfgs.steps`` and ``lbfgs.steps_replayed``.
    """

    def __init__(self, zfun_b, Z0, history, ls_steps):
        self.zfun_b, self.h, self.ls_steps = zfun_b, history, ls_steps
        B, P = Z0.shape
        dtype, dev = Z0.dtype, Z0.device
        self.ts = 0.5 ** torch.arange(ls_steps, dtype=dtype, device=dev)
        self.Z = Z0.clone()
        self.F = torch.empty(B, dtype=torch.float64, device=dev)
        self.G = torch.empty_like(Z0)
        self.S = torch.zeros((history, B, P), dtype=dtype, device=dev)
        self.Y = torch.zeros((history, B, P), dtype=dtype, device=dev)
        self.rho = torch.zeros((history, B), dtype=dtype, device=dev)
        self.m = torch.zeros(B, dtype=torch.int64, device=dev)

    def start(self):
        """The value and gradient at the start point."""
        F, G = self.value_and_grad(self.Z)
        self.F.copy_(F)
        self.G.copy_(G)

    def run(self, maxiter, graphed=False):
        """:meth:`start`, then ``maxiter`` iterations.

        ``graphed`` (CUDA tensors, ``maxiter`` >= 1): the start and the
        first iteration run eagerly on a side stream, which warms up what
        a capture may not (the allocator's blocks, library handles); one
        :meth:`step` is captured there as a CUDA graph, into the device's
        one pool (``_LAST_GRAPH``), and the current stream replays it for
        the other ``maxiter - 1``.  Every iteration goes through
        :meth:`step`, and the graph runs its kernels on the same buffers,
        so the iterates are the eager run's; at each replay the counters
        take what the capture counted.  The objective must copy nothing
        from the host and read no device value.
        """
        if not graphed:
            self.start()
            for _ in range(maxiter):
                self.step()
            return
        dev = self.Z.device
        main, side = torch.cuda.current_stream(dev), _side_stream(dev)
        last = _LAST_GRAPH.get(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.start()
            self.step()
            graph = torch.cuda.CUDAGraph()
            with _recorded() as counted:
                graph.capture_begin(pool=torch.cuda.graph_pool_handle()
                                    if last is None else last.pool())
                try:
                    self.step()
                finally:
                    graph.capture_end()
        _LAST_GRAPH[dev] = graph
        main.wait_stream(side)
        for _ in range(maxiter - 1):
            with span('gsum.lbfgs.step'):
                graph.replay()
                for name, n in counted.items():
                    count(name, n)
                count('lbfgs.steps_replayed')
        # the next capture, on whichever stream, reuses this graph's memory
        # only after its replays
        side.wait_stream(main)

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
            count('lbfgs.steps')

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
            buf.copy_(torch.where(store.reshape(shape), rolled, buf))

        push(self.S, s)
        push(self.Y, yv)
        push(self.rho, 1.0 / torch.clamp(curv, min=1e-30))
        self.m.copy_(torch.where(store, torch.clamp(self.m + 1, max=self.h),
                                 self.m))
        Z.copy_(Z_new)
        F.copy_(F_new)
        G.copy_(G_new)


def _fixed_lbfgs(fun_b, X0, lower, upper, maxiter=50, history=8,
                 ls_steps=10, graphed=False):
    """:func:`fixed_lbfgs_bounded_batched`, with :meth:`_Lbfgs.run`'s
    ``graphed``."""
    X0 = as_input(X0)
    B, P = X0.shape
    lo, hi = _bounds(lower, upper, P, X0.device)

    def zfun_b(Z):
        return fun_b(_to_bounded(Z, lo, hi)).to(torch.float64)

    opt = _Lbfgs(zfun_b, _to_unbounded(X0.to(torch.float64), lo, hi),
                 history, ls_steps)
    opt.run(maxiter, graphed)
    return _to_bounded(opt.Z, lo, hi), opt.F


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
    return _fixed_lbfgs(fun_b, X0, lower, upper, maxiter, history, ls_steps)


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
    opt.start()
    for _ in range(maxiter):
        if float(torch.linalg.vector_norm(opt.G)) <= tol:
            break
        Z_before = opt.Z.clone()
        opt.step()
        if torch.equal(opt.Z, Z_before):
            break
    return _to_bounded(opt.Z[0], lo, hi).to(x0.dtype), opt.F[0]
