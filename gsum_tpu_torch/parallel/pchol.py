R"""Model-parallel blocked Cholesky and MVN lml over a row-sharded matrix
(counterpart of ``gsum_tpu/parallel/pchol.py``).

For N large enough that one device's memory is the limit, the (N, N)
covariance is sharded by row blocks over a mesh axis (D shards of Nl = N/D
rows, shard i on the axis's i-th device) and factored with a right-looking
panel algorithm.  For each column block k:

- the k-th diagonal tile goes to every distinct device of the shards at or
  below it (the gather), and is factored *once per distinct device*: the
  inputs are identical, so every shard on that device gets the same
  factor, and a mesh that repeats a device does not pay D times for it;
- every shard i > k turns its rows of column block k into its panel with
  one triangular solve against the tile's factor (JAX multiplies by the
  tile's inverse, a product that loses accuracy with the tile's
  conditioning: against the dense lml at N = 2048, cond 1.4e11, 8.9e-9
  relative with the inverse and 1.6e-9 with the solve, on the CPU);
- the panels are gathered, and each shard i > k applies the trailing
  update to its column blocks k+1 … i with one product.

Only the lower triangle is carried: shard i holds columns 0 … i of its
rows, so its upper part is neither built nor updated (JAX builds and
updates it and masks it out of the factor).  The covariance is built
*on shard*: :func:`sharded_kernel_lml`, :func:`sharded_gram_logdet` and
:func:`sharded_cgp_lml` evaluate ``value_fn(θ, X_i, X[:(i+1)·Nl])`` on
shard i's device, the nugget on its own rows of the diagonal, and no
(N, N) tensor is ever made.  A shard's peak is about 3·Nl·N numbers: its
rows of K, its rows of L, and the gathered panels.

The forward substitution runs over the shards in order (a triangular
solve against each shard's diagonal block), and the
log-determinant, Mahalanobis and Gram terms are summed over the shards on
the first device, where the result is returned.

Differentiation: :func:`sharded_cgp_lml` is a ``torch.autograd.Function``
whose gradient is p forward-mode tangents of the value (one
``torch.func.jvp`` per log-hyperparameter), as JAX's custom VJP; autograd
and ``torch.func`` (``vmap`` over HMC chains) both take it.  A reverse sweep would keep every
step's shard rows, N² numbers per shard, and undo the sharding's memory
bound.  Every kernel of ``gsum_tpu_torch.kernels`` evaluates with
operations that have forward-mode formulas; a ``value_fn`` with one that
does not raises, naming the kernel.

``torch.linalg.cholesky`` raises on a tile that is not positive definite,
where JAX returns NaN: the tiles are factored with ``cholesky_ex`` and
filled with NaN where it fails, which the success flag reads.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._config import as_input
from ..ops.chol_inv import _cholesky_nan
from .mesh import _all_gather, _axis_devices, _distinct, _psum

__all__ = ['sharded_cholesky', 'sharded_mvn_lml', 'sharded_kernel_lml',
           'sharded_gram_logdet', 'sharded_cgp_lml', 'sharded_fit']

_LOG_2PI = math.log(2 * math.pi)


def _check_divides(N, D):
    if N % D:
        raise ValueError('N=%d must divide over %d shards' % (N, D))


def _factor_body(K_rows, devices):
    """Right-looking factorization of the row-sharded lower triangle.

    ``K_rows[i]``: shard i's (Nl, (i+1)·Nl) rows of K, columns 0 … i, on
    ``devices[i]``.  Returns shard i's rows of the factor L in the same
    layout; its last Nl columns are its own diagonal block of L.
    """
    D = len(K_rows)
    Nl = K_rows[0].shape[0]
    A = list(K_rows)              # shard i: its columns k … i at step k
    L = [[] for _ in range(D)]    # shard i: its column blocks of L
    for k in range(D):
        # the diagonal tile, factored once per distinct device
        tile = A[k][:, :Nl]
        Lkk = {dev: _cholesky_nan(tile.to(dev))
               for dev in _distinct(devices[k:])}
        panels = [Lkk[devices[k]]]
        for i in range(k + 1, D):
            # shard i's rows of column block k: A_ik L_kkᵀ⁻¹
            panels.append(torch.linalg.solve_triangular(
                Lkk[devices[i]].mT, A[i][:, :Nl], upper=True, left=False))
        for i in range(k, D):
            L[i].append(panels[i - k])
        if k + 1 == D:
            break
        gathered = {dev: _all_gather(panels[1:], dev).reshape(-1, Nl)
                    for dev in _distinct(devices[k + 1:])}
        for i in range(k + 1, D):
            P = gathered[devices[i]][:(i - k) * Nl]    # panels k+1 … i
            A[i] = A[i][:, Nl:] - panels[i - k] @ P.mT
    return [torch.cat(blocks, 1) for blocks in L]


def _diag_block(L_rows, i):
    """Shard i's own (Nl, Nl) diagonal block of L."""
    return L_rows[i][:, i * L_rows[i].shape[0]:]


def _fwd_substitute(L_rows, Z_blocks, devices):
    """Sharded blocked forward substitution ``L w = Z``.

    ``Z_blocks[k]``: shard k's (Nl, q) rows of Z.  In shard order, w_k =
    L_kk⁻¹ (Z_k − L_k,<k w_<k), with the solved blocks gathered onto shard
    k's device.  Returns w as one (Nl, q) block per shard.
    """
    w = []
    for k, dev in enumerate(devices):
        rhs = Z_blocks[k]
        if k:
            Nl = L_rows[k].shape[0]
            rhs = rhs - L_rows[k][:, :k * Nl] @ _all_gather(w, dev).reshape(
                k * Nl, -1)
        w.append(torch.linalg.solve_triangular(_diag_block(L_rows, k), rhs,
                                               upper=False))
    return w


def _bwd_substitute(L_rows, w_blocks, devices):
    """Sharded blocked backward substitution ``Lᵀ a = w``.

    In descending shard order, a_k = L_kkᵀ⁻¹ (w_k − Σ_{c>k} L_{c,k}ᵀ a_c):
    each term is formed on shard c, which owns its rows of L and its block
    of a, and the terms are summed on shard k's device.  Returns a as one
    (Nl, q) block per shard.
    """
    D = len(devices)
    Nl = L_rows[0].shape[0]
    a = [None] * D
    for k in reversed(range(D)):
        rhs = w_blocks[k]
        if k + 1 < D:
            rhs = rhs - sum(
                (L_rows[c][:, k * Nl:(k + 1) * Nl].mT @ a[c]).to(devices[k])
                for c in range(k + 1, D))
        a[k] = torch.linalg.solve_triangular(_diag_block(L_rows, k).mT, rhs,
                                             upper=True)
    return a


def _lml_body(K_rows, y_blocks, devices):
    """Factor, forward substitution and the summed terms: the (m,)
    log-densities on the first device."""
    L_rows = _factor_body(K_rows, devices)
    w = _fwd_substitute(L_rows, y_blocks, devices)
    N = sum(b.shape[0] for b in y_blocks)
    logdet = _psum([2.0 * torch.sum(torch.log(torch.diagonal(
        _diag_block(L_rows, i)))) for i in range(len(devices))], devices[0])
    maha = _psum([torch.sum(wi ** 2, 0) for wi in w], devices[0])
    return -0.5 * (maha + logdet + N * _LOG_2PI)


def _gram_logdet_body(K_rows, Z_blocks, devices):
    """Factor and forward substitution; returns (ZᵀK⁻¹Z, log|K|, ok) on the
    first device.  The Gram matrix is the sum of the shards' WᵢᵀWᵢ (W =
    L⁻¹Z); ok says that every shard's diagonal of L is finite and
    positive."""
    L_rows = _factor_body(K_rows, devices)
    diags = [torch.diagonal(_diag_block(L_rows, i))
             for i in range(len(devices))]
    ok = _psum([(~(torch.isfinite(d) & (d > 0)).all()).to(torch.int32)
                for d in diags], devices[0]) == 0
    logdet = _psum([2.0 * torch.sum(torch.log(d)) for d in diags],
                   devices[0])
    w = _fwd_substitute(L_rows, Z_blocks, devices)
    gram = _psum([wi.mT @ wi for wi in w], devices[0])
    return gram, logdet, ok


def _rows_per_shard(N, devices):
    _check_divides(N, len(devices))
    return N // len(devices)


def _row_blocks(Z, devices, Nl):
    """Shard i's (Nl, q) rows of Z, on its device."""
    return [Z[i * Nl:(i + 1) * Nl].to(dev) for i, dev in enumerate(devices)]


def _kernel_rows(value_fn, theta, X, devices, Nl, nugget):
    """Shard i's rows of K(X; θ) + nugget·I, columns 0 … (i+1)·Nl, built
    on its device: ``value_fn(θ, X_i, X[:(i+1)·Nl])``."""
    rows, on = [], {}
    for i, dev in enumerate(devices):
        if dev not in on:
            on[dev] = (theta.to(dev), X.to(dev))
        th, Xd = on[dev]
        K = value_fn(th, Xd[i * Nl:(i + 1) * Nl], Xd[:(i + 1) * Nl])
        if nugget:
            eye = torch.eye(Nl, dtype=K.dtype, device=dev)
            K = K + nugget * torch.cat(
                [K.new_zeros((Nl, i * Nl)), eye], 1)
        rows.append(K)
    return rows


def _inputs(X, theta, devices):
    X = torch.atleast_2d(as_input(X, device=devices[0]))
    theta = as_input(theta, device=devices[0]).to(X.dtype)
    return X, theta


def _columns(y, device):
    y = as_input(y, device=device)
    return y[:, None] if y.ndim == 1 else y


def sharded_gram_logdet(value_fn, theta, X, Z, mesh, axis='model',
                        nugget=0.0):
    R"""``(ZᵀK⁻¹Z, log|K|, ok)`` with K(X; θ) built and factored on shard.

    The sufficient statistic of every conjugate lml in the library: with
    Z = [y, basis], the quadratic forms and the log-determinant of the CGP
    evidence (reference gsum/models.py:169-457) are small algebra on the
    (q, q) Gram matrix, so the sharded path returns O(q²) values.

    Parameters
    ----------
    value_fn : (theta, Xa, Xb) -> kernel matrix (the ``Kernel.value_fn``
        protocol); theta : (p,) log-hyperparameters
    X : (N, d) inputs; Z : (N, q) right-hand sides
    mesh, axis : the model-parallel mesh axis; nugget : on-shard jitter

    Returns
    -------
    gram : (q, q); logdet : 0-d; ok : 0-d bool — on the axis's first device
    """
    devices = _axis_devices(mesh, axis)
    X, theta = _inputs(X, theta, devices)
    Nl = _rows_per_shard(X.shape[0], devices)
    Z = as_input(Z, device=devices[0])
    return _gram_logdet_body(
        _kernel_rows(value_fn, theta, X, devices, Nl, nugget),
        _row_blocks(Z, devices, Nl), devices)


def _cgp_lml_from_gram(gram, logdet, N, m, center0, disp0_np, df0, scale0):
    """CGP log-marginal likelihood from (Gram = [y, B]ᵀR⁻¹[y, B], log|R|):
    algebra on (m+p, m+p) values, the conjugate updates of
    ``ops.gridlml.cgp_lml_grid`` (reference gsum/models.py:169-457)."""
    like = dict(dtype=gram.dtype, device=gram.device)
    disp0_np = np.atleast_2d(np.asarray(disp0_np, dtype=float))
    disp0_zero = bool(np.all(disp0_np == 0))
    df0_inf = bool(np.isinf(df0))
    p = gram.shape[0] - m
    center0 = torch.as_tensor(np.atleast_1d(np.asarray(center0, dtype=float)),
                              **like).broadcast_to((p,))

    Gyy = gram[:m, :m]
    GBy = gram[m:, :m]                                      # (p, m)
    GBB = gram[m:, m:]
    row_y = GBy.sum(1)                                      # Σ_c BᵀR⁻¹y_c
    sum_yy = Gyy.sum()
    tr_yy = torch.trace(Gyy)

    df = df0 + N * m
    if disp0_zero:
        center = center0
    else:
        disp0_inv = torch.as_tensor(np.linalg.inv(disp0_np), **like)
        Lm = _cholesky_nan(disp0_inv + m * GBB)
        factor = disp0_inv @ center0 + row_y                # m·BᵀR⁻¹ȳ
        center = torch.cholesky_solve(factor[:, None], Lm)[:, 0]

    if df0_inf:
        scale_sq = torch.as_tensor(float(scale0) ** 2, **like)
    else:
        quad = tr_yy - sum_yy / m                           # centered Σ yᵀR⁻¹y
        s0 = sum_yy / m ** 2 - (2.0 / m) * (center0 @ row_y) \
            + center0 @ (GBB @ center0)
        if disp0_zero:
            quad2 = m * s0
        else:
            u = row_y / m - GBB @ center0                   # BᵀR⁻¹ avg_yc
            w = torch.cholesky_solve(u[:, None], Lm)[:, 0]  # V u
            quad2 = m * (s0 - m * (u @ w))
        scale_sq = (df0 * float(scale0) ** 2 + quad + quad2) / df

    var = scale_sq if df0_inf else df * scale_sq / (df - 2)
    quad_t = (tr_yy - 2.0 * (center @ row_y)
              + m * (center @ (GBB @ center))) / var
    logdet_K = N * torch.log(var) + logdet
    return -0.5 * (quad_t + m * (logdet_K + N * _LOG_2PI))


class _ForwardModeLml(torch.autograd.Function):
    """A scalar function of θ whose gradient is its p forward-mode tangents:
    ``apply(theta, X, Z, impl, name)`` returns ``impl(theta, X, Z)``; the
    backward runs one ``torch.func.jvp`` in θ per component.  Non-finite
    tangents (a failed factorization, where the value is −inf) become 0.
    ``torch.func`` transforms it (``vmap`` of ``grad`` batches the chains
    of HMC): the data enter as inputs, not captured by ``impl``, so that
    tensors made inside a transform reach the backward unwrapped."""

    generate_vmap_rule = True

    @staticmethod
    def forward(theta, X, Z, impl, name):
        return impl(theta, X, Z)

    @staticmethod
    def setup_context(ctx, inputs, output):
        theta, X, Z, ctx.impl, ctx.name = inputs
        ctx.save_for_backward(theta, X, Z)

    @staticmethod
    def backward(ctx, g):
        theta, X, Z = ctx.saved_tensors
        eye = torch.eye(theta.shape[-1], dtype=theta.dtype,
                        device=theta.device)
        try:
            tangents = [torch.func.jvp(lambda th: ctx.impl(th, X, Z),
                                       (theta,), (e,))[1] for e in eye]
        except RuntimeError as err:
            if 'forward' not in str(err) and 'jvp' not in str(err):
                raise
            raise RuntimeError(
                'sharded_cgp_lml: the gradient is taken in forward mode, and '
                f'the kernel {ctx.name} uses an operation without a '
                f'forward-mode formula ({err})') from err
        grad = torch.stack(tangents, -1) if tangents else theta.new_zeros(
            theta.shape)
        grad = torch.where(torch.isfinite(grad), grad, 0.0)
        return g * grad, None, None, None, None


def sharded_cgp_lml(value_fn, theta, X, y, basis, center0, disp0, df0,
                    scale0, mesh, axis='model', nugget=0.0):
    R"""Differentiable CGP log-marginal likelihood at θ, model-parallel in N.

    The large-N leg of the MAP and HMC paths (reference
    gsum/models.py:812-900 runs the same objective through one LAPACK
    potrf): the correlation matrix is built and factored row-sharded over
    ``mesh[axis]``, reduced to the (m+p, m+p) Gram statistic, and finished
    with the conjugate algebra.

    Autograd works: the gradient is p forward-mode passes of the value (p,
    the kernel's hyperparameter count, is 1–4 in practice), never a
    reverse sweep through the factorization, whose saved steps would be
    O(N²) per shard.  A kernel whose ``value_fn`` uses an operation
    without a forward-mode formula raises ``RuntimeError`` when the
    gradient is taken.

    Parameters mirror :func:`gsum_tpu_torch.ops.gridlml.cgp_lml_grid`:
    y : (N,) or (N, m) curves; basis : (N, p_basis); priors (center0,
    disp0, df0, scale0) as in ConjugateGaussianProcess.

    Returns the 0-d lml (−inf where a tile failed to factor), on θ's
    device when θ is a tensor, else on the axis's first device.
    """
    devices = _axis_devices(mesh, axis)
    out_device = theta.device if isinstance(theta, torch.Tensor) \
        else devices[0]
    X, theta = _inputs(X, theta, devices)
    Nl = _rows_per_shard(X.shape[0], devices)
    y2 = _columns(y, devices[0])
    N, m = y2.shape
    Z = torch.cat([y2, as_input(basis, device=devices[0]).to(y2.dtype)], 1)

    def impl(th, X, Z):
        gram, logdet, ok = _gram_logdet_body(
            _kernel_rows(value_fn, th, X, devices, Nl, nugget),
            _row_blocks(Z, devices, Nl), devices)
        lml = _cgp_lml_from_gram(gram, logdet, N, m, center0, disp0, df0,
                                 scale0)
        return torch.where(ok, lml, -math.inf)

    name = repr(getattr(value_fn, '__self__', value_fn))   # the kernel
    return _ForwardModeLml.apply(theta, X, Z, impl, name).to(out_device)


def sharded_fit(kernel, X, y, basis, center0, disp0, df0, scale0, mesh,
                axis='model', nugget=1e-10, maxiter=50, ls_steps=10,
                theta0=None):
    R"""MAP fit of the kernel's hyperparameters with N sharded over a mesh.

    The fixed-trip bounded L-BFGS (``optimize.fixed_lbfgs_bounded``) on
    ``-sharded_cgp_lml``, with its forward-mode gradient.  Replaces, at N
    beyond one device's memory, the reference's ``fmin_l_bfgs_b`` fit
    (gsum/models.py:884-900).

    Parameters
    ----------
    kernel : a ``gsum_tpu_torch.kernels`` kernel — its ``value_fn``, the
        log-θ start and the log-bounds
    X, y, basis, priors, mesh, axis, nugget : as in :func:`sharded_cgp_lml`
    theta0 : optional (p,) log-θ start in place of ``kernel.theta``

    Returns
    -------
    (theta_opt, lml_opt) : the optimal log-hyperparameters and the lml
    there, float64 on the axis's first device
    """
    from ..optimize import fixed_lbfgs_bounded

    device = _axis_devices(mesh, axis)[0]
    th0 = torch.as_tensor(np.asarray(kernel.theta if theta0 is None
                                     else theta0, dtype=float),
                          device=device)
    bounds = np.asarray(kernel.bounds, dtype=float).reshape(-1, 2)

    def neg(th):
        return -sharded_cgp_lml(kernel.value_fn, th, X, y, basis, center0,
                                disp0, df0, scale0, mesh, axis=axis,
                                nugget=nugget)

    theta_opt, f_opt = fixed_lbfgs_bounded(
        neg, th0, bounds[:, 0], bounds[:, 1], maxiter=maxiter,
        ls_steps=ls_steps)
    return theta_opt, -f_opt


def _matrix_rows(K, devices, Nl):
    """Shard i's (Nl, (i+1)·Nl) rows of a replicated K, on its device."""
    return [K[i * Nl:(i + 1) * Nl, :(i + 1) * Nl].to(dev)
            for i, dev in enumerate(devices)]


def sharded_cholesky(K, mesh, axis='model'):
    R"""Cholesky factor of an (N, N) SPD matrix, computed with its rows
    sharded over ``mesh`` axis ``axis``.

    Returns the (N, N) lower factor, gathered on the axis's first device:
    ``torch.linalg.cholesky(K)`` up to round-off (NaN in the rows of a
    shard whose factorization failed, as JAX's).
    """
    devices = _axis_devices(mesh, axis)
    K = as_input(K, device=devices[0])
    Nl = _rows_per_shard(K.shape[0], devices)
    L_rows = _factor_body(_matrix_rows(K, devices, Nl), devices)
    N = K.shape[0]
    return torch.cat([torch.cat([r.to(devices[0]), r.new_zeros(
        (Nl, N - r.shape[1]), device=devices[0])], 1) for r in L_rows], 0)


def sharded_mvn_lml(K, y, mesh, axis='model'):
    R"""log N(y | 0, K) with K's rows sharded over ``axis``.

    Sharded blocked factorization, blocked forward substitution over the
    shards, and the log-determinant and Mahalanobis terms summed over them.
    For covariances that come from a kernel, :func:`sharded_kernel_lml`
    never makes the (N, N) matrix at all.

    Parameters
    ----------
    K : (N, N) SPD; y : (N,) or (N, m)

    Returns
    -------
    (m,) log-densities on the axis's first device
    """
    devices = _axis_devices(mesh, axis)
    K = as_input(K, device=devices[0])
    Nl = _rows_per_shard(K.shape[0], devices)
    y2 = _columns(y, devices[0])
    return _lml_body(_matrix_rows(K, devices, Nl),
                     _row_blocks(y2, devices, Nl), devices)


def sharded_kernel_lml(value_fn, theta, X, y, mesh, axis='model',
                       nugget=0.0):
    R"""log N(y | 0, K(X; θ) + nugget·I) with the covariance built on shard.

    Each shard evaluates only its own rows of ``value_fn(theta, X_i, X)``
    (their lower triangle) on its device, so the largest N that can be
    factored scales with D·(memory / row block), not with one device's N².

    Parameters
    ----------
    value_fn : (theta, Xa, Xb) -> (len(Xa), len(Xb)) kernel matrix — the
        ``Kernel.value_fn`` protocol of ``gsum_tpu_torch.kernels``
    theta : (p,) log-hyperparameters
    X : (N, d) inputs; y : (N,) or (N, m) residuals
    mesh, axis : the model-parallel mesh axis
    nugget : diagonal jitter added on shard

    Returns
    -------
    (m,) log-densities on the axis's first device
    """
    devices = _axis_devices(mesh, axis)
    X, theta = _inputs(X, theta, devices)
    Nl = _rows_per_shard(X.shape[0], devices)
    y2 = _columns(y, devices[0])
    return _lml_body(_kernel_rows(value_fn, theta, X, devices, Nl, nugget),
                     _row_blocks(y2, devices, Nl), devices)
