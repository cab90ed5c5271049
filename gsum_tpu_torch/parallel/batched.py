R"""Batched MAP fits, hyperparameter-grid sweeps and the batched posterior
(counterpart of ``gsum_tpu/parallel/batched.py``).

The reference's large-scale patterns are Python loops: a (Q, ℓ) grid of
8000 log-marginal-likelihood evaluations (reference: the publication
notebook, cell 53), per-observable refits in the KL diagnostic, a Λ_b
posterior from 1500 pointwise evaluations.  Here each is one batched
computation: the covariance build is ``torch.func.vmap`` of the kernel's
``value_fn`` over θ, and factorizations, solves and conjugate updates take
the batch as a leading dimension (``ops.gridlml``).  A fit is the lockstep
batched L-BFGS (``optimize.fixed_lbfgs_bounded_batched``) over that wide
objective.

Inputs given as numpy go to the card (``_config.default_device``), tensors
stay where they are.  ``mesh=`` (a ``parallel.mesh.Mesh``) splits the batch
over the mesh's ``'batch'`` axis: each shard's slice runs on its own device,
through the same engine as unsharded (``batched_fit``: JAX's per-fit route,
:func:`_fit_one`), and the results are concatenated on the first device.
The JAX package's cache of compiled grid functions has no counterpart
(PyTorch compiles nothing), nor has the chunk cap it places on the blocked
engine for the TPU's vector memory.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.func import vmap

from .. import conjugate as _conj
from .._config import as_input, result_dtype
from ..linalg import cholesky
from ..models import ConjugateGaussianProcess
from ..ops.gridlml import cgp_lml_grid, cgp_lml_grid2, csp_lml_grid2
from ..optimize import fixed_lbfgs_bounded_batched
from .mesh import _axis_devices, shard_batch

__all__ = ['batched_fit', 'batched_predict', 'batched_posterior_at',
           'batched_lml_grid', 'truncation_lml_grid',
           'pointwise_evidence_grid', 'make_lml_fn', 'BatchedPosterior']

_LOG_2PI = math.log(2 * math.pi)

# the share of the card's memory the scalar fit engine budgets for its
# line search: JAX's 12 GB of the TPU v5e's 16 GB
_SCALAR_MEMORY_SHARE = 0.75

_ENGINES = {'grid': 'unrolled', 'scan': 'scan', 'blocked': 'blocked',
            'scalar': None}


def _check_mesh_batch(B, mesh, where):
    """The batch must divide over the mesh's 'batch' axis (JAX's shardings
    refuse ragged shards): fail with the fix."""
    n = mesh.shape['batch']
    if B % n:
        raise ValueError(
            f'{where}: batch size {B} is not divisible by the mesh '
            f"'batch' axis size {n}; pad the batch (e.g. repeat the last "
            f'row) or drop mesh= to run unsharded')


def _first_device(mesh):
    """Where numpy inputs go: the mesh's first 'batch' device, or (no
    mesh) ``_config.default_device``."""
    return None if mesh is None else _axis_devices(mesh, 'batch')[0]


def _cat(parts, device):
    """Per-shard results (tensors, tuples of them or BatchedPosteriors)
    concatenated along the batch on ``device``."""
    first = parts[0]
    if isinstance(first, BatchedPosterior):
        return _map_fields(lambda *xs: _cat(xs, device), *parts)
    if isinstance(first, tuple):
        return tuple(_cat(xs, device) for xs in zip(*parts))
    return torch.cat([p.to(device) for p in parts], 0)


def _over_batch(mesh, where, fn, *batched):
    """``fn(device, *slices)`` for each shard of the leading axis of the
    ``batched`` tensors over the mesh's 'batch' axis, each on its shard's
    device; the results concatenated on the first shard's device."""
    _check_mesh_batch(batched[0].shape[0], mesh, where)
    devices = _axis_devices(mesh, 'batch')
    shards = shard_batch(mesh, *batched)
    if len(batched) == 1:
        shards = (shards,)
    return _cat([fn(dev, *slices) for dev, *slices in zip(devices, *shards)],
                devices[0])


def _engine(engine):
    if engine not in ('auto',) + tuple(_ENGINES):
        raise ValueError(
            "engine must be 'auto', 'grid', 'scan', 'blocked', or 'scalar'")
    return _ENGINES.get(engine)


def make_lml_fn(kernel, center=0, disp=0, df=1, scale=1, nugget=1e-10,
                decomposition='cholesky', chol_fn=None):
    """Plain lml function ``(theta, X, y2d, basis) -> 0-d tensor`` for a
    kernel structure and concrete priors: ``ConjugateGaussianProcess._lml``
    on a frozen clone of ``kernel``.  It vmaps over θ (``torch.func``).

    ``chol_fn`` is the Cholesky factorization, as in JAX: None for
    ``torch.linalg`` (JAX's default, the models' 'xla'), a callable
    ``R -> L`` used as it is, or one of the models' ``chol_engine``
    names ('xla', 'auto', 'blocked').  The model object only carries the
    priors; the lml computes on its inputs' device.
    """
    frozen = kernel.clone()
    gp = ConjugateGaussianProcess(
        kernel=frozen, center=center, disp=disp, df=df, scale=scale,
        nugget=nugget, decomposition=decomposition,
        chol_engine='xla' if chol_fn is None else chol_fn, device='cpu')

    def lml_fn(theta, X, y, basis):
        return gp._lml(frozen, theta, X, y, basis)
    return lml_fn


@dataclass(frozen=True)
class BatchedPosterior:
    """Posterior state for a batch of conjugate-GP fits, each field a tensor
    with the batch leading (frozen: build it once with its final values)."""
    theta: Any
    lml: Any
    center: Any
    disp: Any
    df: Any
    scale_sq: Any
    cov_factor: Any
    chol: Any


def _map_fields(fn, *posts):
    return BatchedPosterior(**{
        f.name: fn(*(getattr(p, f.name) for p in posts))
        for f in dataclasses.fields(BatchedPosterior)})


def _resolve_basis(basis, X):
    """Basis matrix at X: ``None`` → constant ones (the reference default);
    a callable is evaluated at X; an array is used as it is."""
    if basis is None:
        return torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
    if callable(basis):
        return torch.as_tensor(basis(X), dtype=X.dtype, device=X.device)
    b = as_input(basis, device=X.device).to(X.dtype)
    if b.shape[0] != X.shape[0]:
        raise ValueError('basis matrix has %d rows, expected %d'
                         % (b.shape[0], X.shape[0]))
    return b


def _covariances(kernel, thetas, X, nugget):
    """(G, N, N) correlation matrices, one per θ row, nugget added."""
    Rs = vmap(lambda th: kernel.value_fn(th, X, None))(thetas)
    return Rs + nugget * torch.eye(X.shape[0], dtype=Rs.dtype,
                                   device=Rs.device)


def _grid_lml(frozen, thetas, X, y2, basis, center, disp, df, scale, nugget,
              grid_engine, mxu_precision=None):
    """The lml at each θ row: ``cgp_lml_grid`` with ``grid_engine``
    ('unrolled' | 'scan' | 'blocked'), or the vmapped scalar lml (None)."""
    if grid_engine is None:
        lml = make_lml_fn(frozen, center, disp, df, scale, nugget)
        return vmap(lambda th: lml(th, X, y2, basis))(thetas)
    return cgp_lml_grid(_covariances(frozen, thetas, X, nugget), y2, basis,
                        np.atleast_1d(center), np.atleast_2d(disp), df,
                        scale, engine=grid_engine,
                        mxu_precision=mxu_precision)


def batched_lml_grid(kernel, X, y, thetas, center=0, disp=0, df=1, scale=1,
                     nugget=1e-10, mesh=None, basis=None, engine='auto',
                     precision='f64', top_k=64, mxu_precision=None):
    R"""Log-marginal likelihood over a grid of kernel hyperparameters.

    ``engine``: 'grid' (``ops.gridlml.cgp_lml_grid`` on ``smallchol``),
    'scan' (the same on ``scanchol``), 'blocked' (the same on the blocked
    factorization: the CUDA diagonal kernel for f32 on the card), 'scalar'
    (the port's single-model lml vmapped over θ, ``torch.linalg``), or
    'auto': 'grid' for N <= 256, 'scan' for N <= 1024, above that
    'blocked' for f32 on the card, else 'scalar' (the JAX package's
    thresholds, measured on a TPU).

    Parameters
    ----------
    kernel : Kernel — fixes the structure; ``thetas`` supplies the values
    X : (N, d) inputs; y : (N,) or (N, m) data
    thetas : (G, n_params) grid of log-parameter vectors
    mesh : ``parallel.mesh.Mesh``, optional — split the grid over the
        'batch' axis (G must divide)
    basis : None | callable | (N, q) array — mean basis (None = constant
        ones); ``center`` / ``disp`` must be shaped for q columns
    precision : 'f64' | 'f32' | 'mixed' — 'mixed' sweeps the grid at f32
        and evaluates the f32 top-``top_k`` points again at f64: those
        entries are exactly the f64 values, the rest carry about
        eps32·κ(R_θ) relative error
    top_k : int — points evaluated again at f64 in 'mixed'
    mxu_precision : None (= 'highest') | 'high' — the blocked engine's GEMM
        arithmetic ('high' is 3xTF32, ``ops.blockchol``)

    Returns
    -------
    (G,) tensor of log-marginal likelihoods
    """
    if precision not in ('f64', 'f32', 'mixed'):
        raise ValueError("precision must be 'f64', 'f32', or 'mixed'")
    X = as_input(X, device=_first_device(mesh))
    if precision == 'mixed':
        vals32 = batched_lml_grid(kernel, X, y, thetas, center, disp, df,
                                  scale, nugget, mesh, basis, engine,
                                  precision='f32',
                                  mxu_precision=mxu_precision)
        thetas = as_input(thetas, device=X.device)
        k = min(int(top_k), thetas.shape[0])
        idx = torch.argsort(vals32)[-k:]
        vals64 = batched_lml_grid(kernel, X, y, thetas[idx.to(X.device)],
                                  center, disp, df, scale, nugget, mesh,
                                  basis, engine, precision='f64')
        out = vals32.to(torch.float64)
        out[idx] = vals64.to(out.device, torch.float64)
        return out
    y = as_input(y, device=X.device)
    thetas = as_input(thetas, device=X.device)
    if precision == 'f32':
        X, y, thetas = (t.to(torch.float32) for t in (X, y, thetas))

    X = torch.atleast_2d(X)
    y2 = y[:, None] if y.ndim == 1 else y
    basis = _resolve_basis(basis, X)
    N = X.shape[0]
    frozen = kernel.clone()

    def sweep(device, ths):
        if engine == 'auto':
            # above the scan engine's range, f32 on the card goes to the
            # blocked engine; f64 stays on the vmapped scalar lml
            blocked_ok = (torch.promote_types(X.dtype, y.dtype)
                          == torch.float32 and device.type == 'cuda')
            grid_engine = ('unrolled' if N <= 256
                           else 'scan' if N <= 1024
                           else 'blocked' if blocked_ok else None)
        else:
            grid_engine = _engine(engine)
        return _grid_lml(frozen, ths, X.to(device), y2.to(device),
                         basis.to(device), center, disp, df, scale, nugget,
                         grid_engine, mxu_precision)

    if mesh is not None:
        return _over_batch(mesh, 'batched_lml_grid', sweep, thetas)
    return sweep(X.device, thetas)


def _restart_starts(theta0, lower, upper, n_restarts, seed):
    """θ₀ followed by ``n_restarts`` points drawn uniformly in the box from
    a CPU ``torch.Generator`` seeded with ``seed`` (the same draws on every
    device), as an (n_restarts + 1, P) tensor on θ₀'s device."""
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.rand((n_restarts, theta0.shape[0]), generator=gen,
                   dtype=torch.float64).to(theta0.device, theta0.dtype)
    extra = lower + (upper - lower) * u
    return torch.cat([theta0[None], extra], 0)


def batched_fit(kernel, X, y_batch, center=0, disp=0, df=1, scale=1,
                nugget=1e-10, maxiter=100, theta0=None, mesh=None,
                n_restarts=0, seed=0, chunk=128, basis=None, engine='auto',
                ls_steps=10, precision='f64', polish_iters=4,
                mxu_precision=None):
    R"""MAP-fits a ConjugateGaussianProcess independently to each batch
    element.

    Replaces Python loops of ``gp.fit`` (e.g. the KL diagnostic's refits,
    reference diagnostics.py:527-555) with the lockstep batched L-BFGS over
    one wide objective: every line-search trial of every fit is one call of
    the batched grid lml.

    Parameters
    ----------
    kernel : Kernel — structure, initial θ and bounds
    X : (N, d) shared inputs
    y_batch : (B, N) or (B, N, m) — independent data sets
    mesh : optional Mesh — split B over the 'batch' axis (B must divide);
        each shard runs JAX's per-fit route (:func:`_fit_one`), which
        ``engine``, ``chunk`` and ``ls_steps`` do not reach
    n_restarts : int — additional restart points per fit, drawn uniformly
        in the log-bounds from a ``torch.Generator`` seeded with ``seed``;
        the restarts run as more fits and the best optimum per fit is kept
    chunk : int or None — at most this many fits (restarts included) per
        optimizer run; chunking bounds memory and changes no fit
    engine : 'auto' | 'grid' | 'scan' | 'blocked' | 'scalar' — the
        objective's lml engine (see :func:`_auto_fit_engine` for 'auto');
        'blocked' sends every forward's diagonal blocks to the CUDA
        diagonal kernel for f32 on the card, and its backward to the
        blocked solve's hand-written one
    ls_steps : int — line-search trial points per iteration; the
        line search holds ``ls_steps × chunk`` covariance matrices at once
    basis : None | callable | (N, q) array — mean basis shared by every fit
    precision : 'f64' | 'f32' | 'mixed' — 'mixed' runs the sweep
        (restarts included) at f32, then ``polish_iters`` f64 iterations
        per fit from its f32 optimum, and computes the state at f64
    polish_iters : int — f64 polish iterations per fit in 'mixed'
    mxu_precision : None (= 'highest') | 'high' — the blocked engine's
        GEMM arithmetic ('high' is 3xTF32, ``ops.blockchol``); ignored
        by the other engines

    Returns
    -------
    BatchedPosterior with leading batch dimension B
    """
    if precision not in ('f64', 'f32', 'mixed'):
        raise ValueError("precision must be 'f64', 'f32', or 'mixed'")
    X = as_input(X, device=_first_device(mesh))
    y_batch = as_input(y_batch, device=X.device)
    bounds = np.asarray(kernel.bounds, dtype=float)
    f64 = dict(dtype=torch.float64, device=X.device)
    lower = torch.as_tensor(bounds[:, 0], **f64)
    upper = torch.as_tensor(bounds[:, 1], **f64)
    c0, V0 = np.atleast_1d(center), np.atleast_2d(disp)
    if precision == 'mixed':
        if mesh is not None:
            raise ValueError("precision='mixed' is single-device only "
                             "(shard the f32 sweep and polish separately)")
        post32 = batched_fit(kernel, X.to(torch.float32),
                             y_batch.to(torch.float32), center, disp, df,
                             scale, nugget, maxiter, theta0, None,
                             n_restarts, seed, chunk, basis, engine,
                             ls_steps, precision='f32',
                             mxu_precision=mxu_precision)
        X64 = torch.atleast_2d(X.to(torch.float64))
        y64 = y_batch.to(torch.float64)
        if y64.ndim == 2:
            y64 = y64[:, :, None]
        t0 = post32.theta.to(torch.float64)
        return _batched_fit_wide(
            kernel.clone(), X64, y64, _resolve_basis(basis, X64), t0[:1],
            lower, upper, c0, V0, df, scale, nugget, polish_iters, chunk,
            engine, ls_steps, t0_per_fit=t0)
    if precision == 'f32':
        X, y_batch = X.to(torch.float32), y_batch.to(torch.float32)

    X = torch.atleast_2d(X)
    if y_batch.ndim == 2:
        y_batch = y_batch[:, :, None]
    basis = _resolve_basis(basis, X)

    theta0 = torch.as_tensor(
        np.asarray(kernel.theta if theta0 is None else theta0), **f64)
    if n_restarts > 0:
        if not np.all(np.isfinite(bounds)):
            raise ValueError('n_restarts > 0 requires finite bounds')
        starts = _restart_starts(theta0, lower, upper, n_restarts, seed)
    else:
        starts = theta0[None]
    if mesh is not None:
        frozen = kernel.clone()
        return _over_batch(
            mesh, 'batched_fit', lambda dev, ys: _fit_one(
                frozen, X.to(dev), ys, basis.to(dev), starts.to(dev),
                lower.to(dev), upper.to(dev), c0, V0, df, scale, nugget,
                maxiter), y_batch)
    return _batched_fit_wide(kernel.clone(), X, y_batch, basis, starts,
                             lower, upper, c0, V0, df, scale, nugget, maxiter,
                             chunk, engine, ls_steps,
                             mxu_precision=mxu_precision)


def _fit_one(frozen, X, Ys, basis, starts, lower, upper, c0, V0, df0,
             scale0, nugget, maxiter):
    """JAX's sharded fit route (``_fit_one`` vmapped over every (curve,
    start) pair): the per-fit fixed-trip L-BFGS on the scalar lml, 10
    line-search steps, the best start kept by lml, then the Cholesky and
    the conjugate updates at the optimum.  The lockstep batched L-BFGS
    iterates each pair as a single run would (every operation is per
    row), so it runs the pairs together: the scalar engine of
    :func:`_batched_fit_wide`, unchunked.  ``engine``, ``chunk`` and
    ``ls_steps`` do not reach this route, as in JAX."""
    return _batched_fit_wide(frozen, X, Ys, basis, starts, lower, upper,
                             c0, V0, df0, scale0, nugget, maxiter, None,
                             engine='scalar', ls_steps=10)


def _auto_fit_engine(dtype, N, backend):
    """Engine of the lockstep fit objective for ``engine='auto'``: the
    internal grid-engine name, or None for the vmapped scalar lml.

    The JAX package's thresholds, measured on a TPU v5e
    (benchmarks/fit_engines_tpu.py), with ``backend == 'cuda'`` (the
    tensors lie on the card) in place of its ``'tpu'``:

    - N <= 192: 'unrolled';
    - N <= 640: 'scan';
    - N <= 1024: the scalar lml;
    - 1024 < N <= 8192, f32 on the card: 'blocked';
    - otherwise (and all f64): the scalar lml.
    """
    if N <= 192:
        return 'unrolled'
    if N <= 640:
        return 'scan'
    if N <= 1024:
        return None
    if N <= 8192 and dtype == torch.float32 and backend == 'cuda':
        return 'blocked'
    return None


def _scalar_chunk_cap(N, ls_steps, dtype, total_memory):
    """Memory-aware chunk bound for the vmapped scalar fit objective.

    The lockstep line search keeps ``ls_steps × chunk`` covariance builds
    and factorizations live at once, about 24 (N, N) temporaries each (the
    JAX package's measurement); the budget is ``_SCALAR_MEMORY_SHARE`` of
    the device's ``total_memory`` (bytes).  Callers only shrink a chunk.
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    live_bytes = 24 * N * N * itemsize * max(ls_steps, 1)
    return max(1, int(_SCALAR_MEMORY_SHARE * total_memory // live_bytes))


def _posterior(frozen, thetas, X, Ys, basis, c0, V0, df0, scale0, nugget):
    """The conjugate posterior state at each θ row for its own data:
    ``torch.linalg`` Cholesky in the data's dtype (NaN where it fails) and
    the closed-form updates of ``conjugate``, vmapped.  The updates run in
    float64 for f32 data too (JAX promotes them where they meet its f64
    priors; torch multiplies no f32 by f64)."""
    N = X.shape[0]
    eye = torch.eye(N, dtype=X.dtype, device=X.device)
    wide = result_dtype(X.dtype)
    basis = basis.to(wide)

    def one(theta, y2):
        L = cholesky(frozen.value_fn(theta, X, None) + nugget * eye)
        Lw, y2 = L.to(wide), y2.to(wide)
        scale_sq = _conj.compute_scale_sq(y2, Lw, basis, c0, V0, df0, scale0)
        dfp = _conj.compute_df(y2, df0)
        return (theta, _conj.compute_center(y2, Lw, basis, c0, V0),
                _conj.compute_disp(y2, Lw, basis, V0),
                torch.full((), float(dfp), dtype=L.dtype, device=L.device),
                scale_sq, _conj.compute_cov_factor(scale_sq, dfp), L)

    names = ('theta', 'center', 'disp', 'df', 'scale_sq', 'cov_factor',
             'chol')
    return dict(zip(names, vmap(one)(thetas, Ys)))


def _batched_fit_wide(frozen, X, y_batch, basis, starts, lower, upper,
                      c0, V0, df0, scale0, nugget, maxiter, chunk,
                      engine='auto', ls_steps=10, t0_per_fit=None,
                      mxu_precision=None):
    """Lockstep fits of every (data set, start) pair, chunk by chunk; the
    best start per data set is kept."""
    B, N, m = y_batch.shape
    dtype = X.dtype
    if engine == 'auto':
        grid_engine = _auto_fit_engine(dtype, N, X.device.type)
    else:
        grid_engine = _engine(engine)
    if grid_engine is None:
        scalar_lml = make_lml_fn(frozen, c0, V0, df0, scale0, nugget)
        if X.device.type == 'cuda' and chunk is not None:
            chunk = min(chunk, _scalar_chunk_cap(
                N, ls_steps, dtype,
                torch.cuda.get_device_properties(X.device).total_memory))

    def run_chunk(Ys, T0):
        def fun_b(Thetas):
            # the line search widens the batch to ls_steps × B: trial l of
            # fit b sits at row l·B + b, so the data tile to match
            reps = Thetas.shape[0] // Ys.shape[0]
            Ys_full = Ys.repeat(reps, 1, 1) if reps > 1 else Ys
            Th = Thetas.to(dtype)
            if grid_engine is None:
                return -vmap(lambda th, y2: scalar_lml(th, X, y2, basis))(
                    Th, Ys_full)
            return -cgp_lml_grid(_covariances(frozen, Th, X, nugget),
                                 Ys_full, basis, c0, V0, df0, scale0,
                                 engine=grid_engine,
                                 mxu_precision=mxu_precision)

        topt, fmin = fixed_lbfgs_bounded_batched(fun_b, T0, lower, upper,
                                                 maxiter=maxiter,
                                                 ls_steps=ls_steps)
        with torch.no_grad():
            parts = _posterior(frozen, topt.to(dtype), X, Ys, basis, c0, V0,
                               df0, scale0, nugget)
        return BatchedPosterior(lml=-fmin, **parts)

    # fold the restarts into the batch; t0_per_fit (the mixed-precision
    # polish) gives every fit its own start instead
    Rstarts = starts.shape[0]
    if t0_per_fit is not None:
        Rstarts = 1
        Ys_all, T0_all = y_batch, t0_per_fit
    elif Rstarts > 1:
        Ys_all = y_batch.repeat_interleave(Rstarts, 0)
        T0_all = starts.repeat(B, 1)
    else:
        Ys_all, T0_all = y_batch, starts[0].expand(B, -1)
    T0_all = T0_all.to(torch.float64)

    total = Ys_all.shape[0]
    step = total if chunk is None else chunk
    outs = [run_chunk(Ys_all[i:i + step], T0_all[i:i + step])
            for i in range(0, total, step)]
    posts = outs[0] if len(outs) == 1 else _map_fields(
        lambda *xs: torch.cat(xs, 0), *outs)

    if Rstarts > 1:
        best = torch.argmax(posts.lml.reshape(B, Rstarts), 1)
        rows = torch.arange(B, device=best.device) * Rstarts + best
        posts = _map_fields(lambda a: a[rows], posts)
    return posts


def _coefficients(y, orders, mask, ratios, refv):
    """The coefficients c_n = Δy_n / (ref·Qⁿ) of every ratio row, for the
    orders in ``mask``: (R, N, n_in)."""
    diffs = torch.cat([y[:, :1], torch.diff(y, dim=-1)], -1)
    orders_t = torch.as_tensor(orders, dtype=y.dtype, device=y.device)
    denom = refv[None, :, None] * ratios[:, :, None] ** orders_t[None, None]
    return (diffs[None] / denom)[:, :, torch.as_tensor(
        np.flatnonzero(mask), device=y.device)]


def _ratio_rows(ratios, y, N):
    ratios = as_input(ratios, device=y.device).to(y.dtype)
    if ratios.ndim == 1:
        ratios = ratios[:, None].expand(ratios.shape[0], N)
    return ratios


def truncation_lml_grid(kernel, X, y, orders, ratios, thetas, ref=1,
                        center=0, disp=0, df=1, scale=1, nugget=1e-10,
                        excluded=None, process='gp'):
    R"""Joint (ratio, kernel-hyperparameter) log-likelihood surface.

    The reference computes it with a nested Python loop of full
    ``TruncationProcess.log_marginal_likelihood`` evaluations (8000 for the
    publication's (Q, ℓ) posterior; reference models.py:1485-1507).  Here
    the coefficients are extracted for every ratio at once, each
    correlation matrix is factored once, and every (θ, ratio) pair is
    evaluated with batched products, the change-of-variables determinant
    included.

    Parameters
    ----------
    kernel : Kernel — structure for θ
    X : (N, d); y : (N, n_orders) partial sums
    orders : (n_orders,) int array
    ratios : (R,) scalars or (R, N) per-point expansion parameters
    thetas : (T, n_params) log-parameter grid
    ref : scalar or (N,) reference scale
    excluded : orders excluded from the coefficient process
    process : 'gp' | 'tp'

    The coefficient process has the constant-ones mean basis (the only one
    the reference's truncation models use).

    Returns
    -------
    (T, R) tensor: log p(y | θ_t, ratio_r)
    """
    if process not in ('gp', 'tp'):
        raise ValueError("process must be 'gp' or 'tp'")
    grid2 = cgp_lml_grid2 if process == 'gp' else csp_lml_grid2

    X = torch.atleast_2d(as_input(X))
    y = as_input(y, device=X.device)
    N = X.shape[0]
    orders = np.asarray(orders)
    mask = ~np.isin(orders, excluded)
    orders_in = orders[mask]
    n_in = len(orders_in)

    ratios = _ratio_rows(ratios, y, N)
    refv = as_input(ref, device=y.device).to(y.dtype).broadcast_to((N,))
    thetas = as_input(thetas, device=X.device)

    coeffs = _coefficients(y, orders, mask, ratios, refv)          # (R, N, m)
    Rs = _covariances(kernel.clone(), thetas, X, nugget)
    basis = torch.ones((N, 1), dtype=X.dtype, device=X.device)
    lml = grid2(Rs, coeffs, basis, np.atleast_1d(center),
                np.atleast_2d(disp), df, scale)                     # (T, R)

    # change-of-variables determinant (reference models.py:1505-1506)
    det = (n_in * torch.sum(torch.log(torch.abs(refv)))
           + float(np.sum(orders_in))
           * torch.sum(torch.log(torch.abs(ratios)), -1))           # (R,)
    return lml - det[None, :]


def pointwise_evidence_grid(y, orders, ratios, ref=1, df=1, scale=1,
                            excluded=None, mesh=None):
    R"""TruncationPointwise evidence over a batch of expansion parameters.

    The reference's Λ_b posterior is a Python loop of
    ``TruncationPointwise.log_likelihood`` calls, one per Λ_b value (1500
    per observable in its truncation recap notebook; reference
    models.py:1755-1797).  Here the sweep is one batched computation:
    coefficient extraction, the conjugate (ν, τ²) update and the
    change-of-variables determinant, the ratio batch leading.

    Parameters
    ----------
    y : (N, n_orders) partial sums
    orders : (n_orders,) int array
    ratios : (R, N) or (R,) expansion parameters, one row per sweep point
    ref : scalar or (N,) reference scale
    df, scale : scaled-inverse-χ² prior (ν₀, τ₀); ``df=0`` is the
        scale-invariant prior, whose infinite normalization is dropped as
        the reference does
    excluded : orders excluded from the coefficient model
    mesh : optional Mesh — split the R axis over 'batch' (R must divide)

    Returns
    -------
    (R,) tensor: log p(y | ratio_r), as
    ``TruncationPointwise(df, scale, excluded).fit(y, ...).log_likelihood``
    """
    y = as_input(y, device=_first_device(mesh))
    if y.ndim == 1:
        y = y[:, None]
    N = y.shape[0]
    orders = np.asarray(orders)
    mask = ~np.isin(orders, excluded)
    orders_in = orders[mask]
    m = int(mask.sum())

    ratios = _ratio_rows(ratios, y, N)
    refv = as_input(ref, device=y.device).to(y.dtype).broadcast_to((N,))
    df0, scale0 = float(df), float(scale)

    def sweep(device, ratios):
        yd, refd = y.to(device), refv.to(device)
        coeffs = _coefficients(yd, orders, mask, ratios, refd)   # (R, N, m)
        # conjugate scaled-inverse-χ² update (reference models.py:1623-1631)
        df_post = df0 + m
        scale_sq = (df0 * scale0 ** 2
                    + torch.sum(coeffs * coeffs, -1)) / df_post     # (R, N)
        # df_post is a concrete number: its log-gamma is taken on the host
        ll = math.lgamma(df_post / 2.) - 0.5 * m * _LOG_2PI
        if df0 > 0:  # the scale-invariant prior df0 = 0 drops its
            # normalization
            ll += 0.5 * df0 * math.log(df0 * scale0 ** 2 / 2.) \
                - math.lgamma(df0 / 2.)
        ll = ll - 0.5 * torch.sum(
            df_post * torch.log(df_post * scale_sq / 2.), -1)       # (R,)

        # change-of-variables determinant y → c (reference
        # models.py:1780-1784)
        det = (torch.sum(torch.log(torch.abs(refd)))
               + float(np.sum(orders_in)) * torch.sum(torch.log(ratios), -1))
        return ll - det

    if mesh is not None:
        return _over_batch(mesh, 'pointwise_evidence_grid', sweep, ratios)
    return sweep(y.device, ratios)


def batched_predict(kernel, post, X, y_batch, Xnew, mesh=None, basis=None,
                    student=False, student_mode='class'):
    R"""Predictive means and stds at ``Xnew`` for every fit of a
    :class:`BatchedPosterior`.

    The batched form of ``ConjugateGaussianProcess.predict`` (reference
    models.py:751-845), given the state from :func:`batched_fit` or
    :func:`batched_posterior_at`.

    ``student=True`` adds the Student process's mean-uncertainty term: the
    conditional basis ``B_c = B_new − R_no R_oo⁻¹ B_old`` contributes
    ``mu_var = cov_factor · diag(B_c V B_cᵀ)`` with ``V = post.disp``,
    entered per ``student_mode``:

    - ``'class'`` (default): ``std = σ + sqrt(mu_var)``, the std-addition
      convention of ``ConjugateStudentProcess.predict(return_std=True)``;
    - ``'variance'``: ``std = sqrt(σ² + mu_var)``, the per-draw predictive
      std (variances add, as in the class's return_cov path).

    ``basis``: None (constant ones) or a callable evaluated at X and Xnew;
    it must match the basis of the fits.  ``mesh``: optional Mesh — split
    the fits over the 'batch' axis (B must divide); X and Xnew go to every
    shard.

    Returns
    -------
    (means, stds): ((B, N_new, m), (B, N_new)) tensors
    """
    if basis is not None and not callable(basis):
        raise TypeError('batched_predict needs basis=None or a callable '
                        '(it must be evaluated at both X and Xnew)')
    if student_mode not in ('class', 'variance'):
        raise ValueError("student_mode must be 'class' or 'variance'")
    frozen = kernel.clone()
    dev = post.theta.device
    X = torch.atleast_2d(as_input(X, device=dev))
    Xnew = torch.atleast_2d(as_input(Xnew, device=dev))
    y_batch = as_input(y_batch, device=dev)
    if y_batch.ndim == 2:
        y_batch = y_batch[:, :, None]

    def predict(device, theta, L, center, cov_factor, disp, y_batch):
        Xd, Xn = X.to(device), Xnew.to(device)
        basis_old = _resolve_basis(basis, Xd)
        basis_new = _resolve_basis(basis, Xn)
        B = L.shape[0]
        m_old = torch.einsum('nq,bq->bn', basis_old, center)
        m_new = torch.einsum('nq,bq->bn', basis_new, center)
        R_on = vmap(lambda th: frozen.value_fn(th, Xd, Xn))(theta)
        alpha = torch.cholesky_solve(y_batch - m_old[..., None], L)
        m_pred = m_new[..., None] + R_on.mT @ alpha
        R_nn = vmap(lambda th: frozen.value_fn(th, Xn, None))(theta)
        var = torch.diagonal(R_nn, dim1=-2, dim2=-1) \
            - torch.sum(R_on * torch.cholesky_solve(R_on, L), -2)
        std = torch.sqrt(torch.clamp(cov_factor[:, None] * var, min=0.0))
        if student:
            # the mean uncertainty of the marginalized-mean process
            # (reference models.py:1171-1181), entered per student_mode
            b_cond = basis_new - R_on.mT @ torch.cholesky_solve(
                basis_old.expand((B,) + basis_old.shape), L)
            mu_var = cov_factor[:, None] * torch.einsum(
                'bnq,bqr,bnr->bn', b_cond, disp, b_cond)
            if student_mode == 'variance':
                std = torch.sqrt(std ** 2 + torch.clamp(mu_var, min=0.0))
            else:
                std = std + torch.sqrt(torch.clamp(mu_var, min=0.0))
        return m_pred, std

    args = (post.theta, post.chol, post.center, post.cov_factor, post.disp,
            y_batch)
    if mesh is not None:
        return _over_batch(mesh, 'batched_predict', predict, *args)
    return predict(dev, *args)


def batched_posterior_at(kernel, X, y, thetas, center=0, disp=0, df=1,
                         scale=1, nugget=1e-10, basis=None, chunk=128,
                         mesh=None):
    R"""Conjugate posterior states at given hyperparameters, with no
    optimization.

    The state half of :func:`batched_fit` at externally supplied ``thetas``
    (log space, one row per draw): for each θ the covariance is built and
    factored once and the closed-form conjugate updates give
    ``center / disp / df / scale_sq / cov_factor`` as ``fit`` would, with
    the lml at θ.  Fed to :func:`batched_predict`, it gives per-draw
    predictive moments.

    Parameters
    ----------
    kernel : Kernel — structure (its own θ is ignored)
    X : (N, d) inputs and y : (N,) or (N, m) data, shared by every draw
    thetas : (B, n_dims) log-hyperparameter rows
    center, disp, df, scale, nugget, basis : as in :func:`batched_fit`
    chunk : at most this many draws per batched evaluation (bounds memory)
    mesh : optional Mesh — split B over the 'batch' axis (B must divide);
        each shard is one evaluation, ``chunk`` is bypassed (as in JAX)

    Returns
    -------
    BatchedPosterior with leading dimension B
    """
    frozen = kernel.clone()
    lml = make_lml_fn(kernel, center, disp, df, scale, nugget)
    X = torch.atleast_2d(as_input(X, device=_first_device(mesh)))
    y2 = as_input(y, device=X.device)
    if y2.ndim == 1:
        y2 = y2[:, None]
    basis_c = _resolve_basis(basis, X)
    c0, V0 = np.atleast_1d(center), np.atleast_2d(disp)
    thetas = torch.atleast_2d(as_input(thetas, device=X.device).to(X.dtype))

    def fn(device, ths):
        Xd, yd, bd = X.to(device), y2.to(device), basis_c.to(device)
        with torch.no_grad():
            Ys = yd.expand((ths.shape[0],) + yd.shape)
            parts = _posterior(frozen, ths, Xd, Ys, bd, c0, V0, df, scale,
                               nugget)
            vals = vmap(lambda th: lml(th, Xd, yd, bd))(ths)
        return BatchedPosterior(lml=vals, **parts)

    if mesh is not None:        # one evaluation per shard: chunk bypassed
        return _over_batch(mesh, 'batched_posterior_at', fn, thetas)
    B = thetas.shape[0]
    if chunk is None or B <= chunk:
        return fn(X.device, thetas)
    parts = [fn(X.device, thetas[i:i + chunk]) for i in range(0, B, chunk)]
    return _map_fields(lambda *xs: torch.cat(xs, 0), *parts)
