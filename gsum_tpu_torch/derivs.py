R"""Derivative observations and constraints, by automatic differentiation
(counterpart of ``gsum_tpu/derivs.py``).

The cross-covariance between derivative observations of a process,

.. math::

    \mathrm{cov}\!\left[\partial^{a} f(x),\, \partial^{b} f(x')\right]
        = \partial^{a}_{x} \partial^{b}_{x'} k(x, x'),

is taken by nested ``torch.func.grad`` of the kernel's ``value_fn`` on one
pair of points, under ``torch.func.vmap`` over the rows of each order group;
a mean or a vector-valued basis is differentiated by ``torch.func.jacfwd``.
So every kernel of :mod:`gsum_tpu_torch.kernels` (and the models' summed
truncation covariance, with the x-dependence of ``ratio`` / ``ref``) gets its
derivative cross-covariances with no per-kernel algebra.  The result is an
ordinary tensor function of θ, so autograd differentiates a
derivative-constrained log-marginal likelihood through it.

Orders are concrete numpy arrays: rows are grouped by their multi-order on
the host and each block is written into the output tensor by index.

Used by the models' ``fit(dorders=)`` / ``predict(dorders=)`` and by
``TruncationProcess.fit(dderivs=)``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from ._config import as_input, result_dtype

__all__ = ['normalize_orders', 'deriv_cov', 'deriv_mean', 'deriv_basis',
           'kernel_deriv_cov', 'max_kernel_deriv_order',
           'wrap_value_fn_with_orders']


def _as_float(X):
    """``X`` as an at-least-2-D floating tensor: integer points (the
    constraint idiom ``dX=[[0]]``) take the default float dtype, since
    ``grad`` / ``jacfwd`` need real inputs.  A tensor keeps its device, a
    numpy array goes to the card."""
    X = torch.atleast_2d(as_input(X))
    if not X.is_floating_point():
        X = X.to(result_dtype(X.dtype))
    return X


def normalize_orders(d, n_points, n_features):
    """Validates and broadcasts derivative orders to an (N, n_features)
    integer array.

    ``d`` may be None (all zeros: plain value observations), a scalar, an
    (N,) vector (n_features must be 1), or an (N, n_features) array of
    non-negative per-dimension derivative orders.
    """
    if d is None:
        return np.zeros((n_points, n_features), dtype=int)
    d = np.asarray(d)
    if not np.issubdtype(d.dtype, np.integer):
        if not np.all(d == np.round(d)):
            raise ValueError('derivative orders must be integers')
        d = d.astype(int)
    if np.any(d < 0):
        raise ValueError('derivative orders must be >= 0')
    if d.ndim == 0:
        d = np.full((n_points, n_features), int(d))
    elif d.ndim == 1:
        if n_features != 1:
            raise ValueError(
                'a 1d derivative-order array is ambiguous for %d features; '
                'pass shape (n_points, n_features)' % n_features)
        d = d[:, None]
    if d.shape != (n_points, n_features):
        raise ValueError('derivative orders have shape %s, expected %s'
                         % (d.shape, (n_points, n_features)))
    return d


def _group_by_order(d):
    """``(multi_order_tuple, index_array)`` for each distinct row of ``d``,
    in order of first appearance, with host indices."""
    groups = {}
    for i, row in enumerate(np.asarray(d)):
        groups.setdefault(tuple(int(v) for v in row), []).append(i)
    return [(order, np.asarray(idx)) for order, idx in groups.items()]


def _derivatize_pair(f, multi_order, argnum):
    """``multi_order[dim]`` nested d/dx_dim of a scalar pair function
    ``f(x, xp)`` in its ``argnum``-th argument."""
    for dim, times in enumerate(multi_order):
        for _ in range(int(times)):
            # loop variables bound as defaults: late binding would make
            # every level differentiate the last function
            def f(x, xp, _f=f, _dim=dim):
                return grad(_f, argnums=argnum)(x, xp)[_dim]
    return f


def _derivatize_single(f, multi_order):
    """The same for a one-argument function ``f(x)``, scalar or vector
    valued (forward mode, so a basis of any width works)."""
    for dim, times in enumerate(multi_order):
        for _ in range(int(times)):
            def f(x, _f=f, _dim=dim):
                return jacfwd(_f)(x)[..., _dim]
    return f


def _index(rows, device):
    return torch.as_tensor(rows, dtype=torch.long, device=device)


def deriv_cov(cov_fn, X1, d1, X2=None, d2=None, value_block_fn=None):
    R"""Cross-covariance matrix between derivative observations.

    Parameters
    ----------
    cov_fn : callable ``(x, xp) -> 0-d tensor`` — the covariance of one
        pair of points (each of shape ``(n_features,)``), written in torch
        operations that ``torch.func`` transforms
    X1 : (N1, n_features) observation points
    d1 : derivative orders for X1 (see :func:`normalize_orders`)
    X2, d2 : optional second set; defaults to ``(X1, d1)``
    value_block_fn : callable ``(Xa, Xb) -> (len(Xa), len(Xb))``, optional —
        a matrix evaluator for the zero-order × zero-order block (e.g. the
        kernel's ``value_fn``); it must agree with ``cov_fn``

    Returns
    -------
    (N1, N2) tensor with entry ``[i, j]`` equal to
    :math:`\partial^{d1_i}_{x} \partial^{d2_j}_{x'}\, k(x, x')` at
    ``(X1[i], X2[j])``.
    """
    X1 = _as_float(X1)
    if X2 is None:
        X2 = X1
        if d2 is None:
            d2 = d1
    else:
        X2 = _as_float(X2).to(X1.device)
    n1, nf = X1.shape
    n2 = X2.shape[0]
    d1 = normalize_orders(d1, n1, nf)
    d2 = normalize_orders(d2, n2, nf)

    zero_order = (0,) * nf
    blocks = []
    for o1, i1 in _group_by_order(d1):
        f1 = _derivatize_pair(cov_fn, o1, argnum=0)
        A = X1[_index(i1, X1.device)]
        for o2, i2 in _group_by_order(d2):
            Bp = X2[_index(i2, X2.device)]
            if (value_block_fn is not None and o1 == zero_order
                    and o2 == zero_order):
                block = value_block_fn(A, Bp)
            else:
                f12 = _derivatize_pair(f1, o2, argnum=1)
                block = vmap(lambda x, f12=f12, Bp=Bp: vmap(
                    lambda xp: f12(x, xp))(Bp))(A)
            blocks.append((i1, i2, block))
    dtype = torch.promote_types(result_dtype(X1.dtype), X2.dtype)
    for _, _, b in blocks:
        dtype = torch.promote_types(dtype, b.dtype)
    out = X1.new_zeros((n1, n2), dtype=dtype)
    for i1, i2, block in blocks:
        rows = _index(i1, X1.device)[:, None]
        cols = _index(i2, X1.device)[None, :]
        # index_put keeps autograd's graph through the blocks
        out = out.index_put((rows, cols), block.to(dtype))
    return out


def _rows_of(fn, X, d, shape_tail):
    """Per-point derivatives of a one-point function ``fn`` at the rows of
    ``X`` with orders ``d``: an (N,) + shape_tail tensor."""
    n, nf = X.shape
    d = normalize_orders(d, n, nf)
    parts = []
    for o, idx in _group_by_order(d):
        f = _derivatize_single(fn, o)
        parts.append((idx, vmap(f)(X[_index(idx, X.device)])))
    dtype = result_dtype(X.dtype)
    for _, v in parts:
        dtype = torch.promote_types(dtype, v.dtype)
    out = X.new_zeros((n,) + shape_tail, dtype=dtype)
    for idx, vals in parts:
        out = out.index_put((_index(idx, X.device),), vals.to(dtype))
    return out


def deriv_mean(mean_fn, X, d):
    """Vector of derivative observations of a scalar mean function.

    ``mean_fn(x) -> 0-d tensor`` on a single ``(n_features,)`` point;
    returns the (N,) vector of per-point derivatives of the given orders.
    """
    return _rows_of(mean_fn, _as_float(X), d, ())


def deriv_basis(basis_fn, X, d):
    """Matrix of derivative observations of a vector-valued basis.

    ``basis_fn(x) -> (p,)`` on a single point; returns (N, p) with row i
    the ``d[i]``-derivative of the basis at ``X[i]``, as the Student-t
    mean-uncertainty term needs it beside derivative covariances.
    """
    X = _as_float(X)
    p = basis_fn(X[0]).shape[0]
    return _rows_of(basis_fn, X, d, (p,))


def wrap_value_fn_with_orders(value_fn, d_train):
    R"""Wraps a kernel ``value_fn`` so that the rows of its FIRST argument
    carry the given (concrete) per-point derivative orders.

    The result has the kernel signature ``value_fn(theta, X, Y)``:

    - ``Y is None`` → the derivative self-covariance of the training set
      (``d_train`` × ``d_train``), the correlation matrix of the conjugate
      updates and the lml;
    - ``Y`` given → the (train × new) cross-covariance, the new points
      being value observations (order 0).

    Differentiation is linear and a GP's derivative observations are
    jointly Gaussian with these cross-covariances, so the conjugate
    updates apply to derivative training data unchanged.
    """
    d_train = np.asarray(d_train)

    def wrapped(theta, X, Y=None):
        def cov_fn(x, xp):
            return value_fn(theta, x[None, :], xp[None, :])[0, 0]

        def value_block(Xa, Xb):
            return value_fn(theta, Xa, Xb)

        if Y is None:
            return deriv_cov(cov_fn, X, d_train, value_block_fn=value_block)
        zeros = np.zeros((Y.shape[0], d_train.shape[1]), dtype=int)
        return deriv_cov(cov_fn, X, d_train, Y, zeros,
                         value_block_fn=value_block)

    return wrapped


def max_kernel_deriv_order(kernel):
    R"""Largest per-observation derivative order the kernel supports.

    Observations of :math:`f^{(a)}` need the mixed derivative
    :math:`\partial^a_x \partial^a_{x'} k` at coincident points (the
    diagonal of every constraint covariance).  Per kernel:

    - RBF / RationalQuadratic / DotProduct / Constant: no limit (``inf``);
    - WhiteKernel: no limit in cross-covariance use — its two-argument form
      is identically zero, so a ``+ WhiteKernel`` nugget does not reach
      derivative observations;
    - Matern: ``nu=0.5`` → 0, ``nu=1.5`` → 1, ``nu=2.5`` → 2, ``nu=inf`` →
      no limit; any other ``nu`` → 0 (the general-``nu`` branch's
      coincident-point guard carries only the constant term);
    - ExpSineSquared: 3 (its coincident-point Taylor guard carries terms to
      sq³, exact through total order 6);
    - Sum / Product / Exponentiation: the least over the operands.

    Beyond these orders the guard branches return a wrong (often zero)
    coincident limit without any error, so callers validate (see
    :func:`kernel_deriv_cov` and ``TruncationProcess.fit(dderivs=)``).
    """
    from . import kernels as _k

    if isinstance(kernel, _k.Matern):
        return {0.5: 0, 1.5: 1, 2.5: 2, np.inf: np.inf}.get(kernel.nu, 0)
    if isinstance(kernel, _k.ExpSineSquared):
        return 3
    if isinstance(kernel, _k.Exponentiation):
        return max_kernel_deriv_order(kernel.kernel)
    if isinstance(kernel, (_k.Sum, _k.Product)):
        return min(max_kernel_deriv_order(kernel.k1),
                   max_kernel_deriv_order(kernel.k2))
    return np.inf


def _check_kernel_orders(kernel, *order_arrays):
    """Raises if an observation's TOTAL order (summed over features)
    exceeds the kernel's differentiability: d²f/dx₀dx₁ needs the same
    fourth coincident derivative as d²f/dx₀²."""
    limit = max_kernel_deriv_order(kernel)
    worst = 0
    for d in order_arrays:
        d = np.asarray(d)
        if d.size:
            totals = d.sum(axis=-1) if d.ndim > 1 else d
            worst = max(worst, int(np.max(totals)))
    if worst > limit:
        raise ValueError(
            'derivative observations of total order %d requested but '
            'kernel %r only supports order %s observations (beyond it, '
            'coincident-point limits do not exist or are not carried by '
            'the Taylor guards — see derivs.max_kernel_deriv_order)'
            % (worst, kernel, limit))


def kernel_deriv_cov(kernel, X1, d1, X2=None, d2=None, theta=None):
    R"""Derivative cross-covariances of a :mod:`gsum_tpu_torch.kernels`
    kernel: ``kernel.value_fn`` on single point pairs, through
    :func:`deriv_cov`.  ``theta`` defaults to the kernel's log-parameters.

    Requested orders are validated against the kernel's differentiability
    (:func:`max_kernel_deriv_order`): ``Matern(nu=0.5)`` rejects any
    derivative observation rather than return a zero coincident variance.
    """
    X1a = _as_float(X1)
    n1, nf = X1a.shape
    d1n = normalize_orders(d1, n1, nf)
    d2n = d1n if (X2 is None and d2 is None) else normalize_orders(
        d2, _as_float(X2 if X2 is not None else X1a).shape[0], nf)
    _check_kernel_orders(kernel, d1n, d2n)

    frozen = kernel.clone()
    th = torch.as_tensor(frozen.theta if theta is None else theta,
                         dtype=result_dtype(X1a.dtype), device=X1a.device)

    def cov_fn(x, xp):
        return frozen.value_fn(th, x[None, :], xp[None, :])[0, 0]

    return deriv_cov(cov_fn, X1a, d1n, X2, d2n)
