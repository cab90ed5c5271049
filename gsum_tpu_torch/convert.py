R"""Conversion of the JAX package's inputs and state into the port's tensors.

``gsum_tpu`` takes numpy arrays and Python scalars; its results come back as
arrays that ``numpy.asarray`` reads.  :func:`to_torch` turns such values, or
dicts, tuples and lists of them, into tensors on an explicit device.
:func:`to_torch_kernel` rebuilds a ``gsum_tpu`` kernel as the port's kernel
of the same class and parameters (its θ, bounds and fixed flags come along),
:func:`to_torch_model` a ``gsum_tpu`` model as the port's, and
:func:`to_torch_posterior` a ``gsum_tpu.parallel.BatchedPosterior``.  None
of them imports the JAX package: kernels, models and states are read by
duck typing.  A mesh carries no state, so none is converted: build the
port's own with ``parallel.make_mesh`` or ``parallel.Mesh``.
"""
from __future__ import annotations

import dataclasses
import numbers

import numpy as np
import torch

from ._config import resolve_device

__all__ = ['to_torch', 'to_torch_kernel', 'to_torch_model',
           'to_torch_posterior']


def to_torch(tree, device, dtype=None):
    """Converts arrays and scalars in ``tree`` to tensors on ``device``.

    Parameters
    ----------
    tree : an array (anything ``numpy.asarray`` reads), a Python or numpy
        scalar, ``None``, or a dict / tuple / list of these
    device : the target device, given explicitly
    dtype : optional floating dtype for floating leaves; integer and boolean
        leaves keep theirs.  ``None`` keeps every leaf's dtype (a Python
        float is float64, as numpy reads it).

    Returns
    -------
    The same structure with tensors in place of the leaves.
    """
    device = resolve_device(device)

    def leaf(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(leaf(v) for v in x)
        if not isinstance(x, (numbers.Number, np.ndarray, np.generic)) \
                and not hasattr(x, '__array__'):
            raise TypeError(f'cannot convert {type(x).__name__} to a tensor')
        t = torch.from_numpy(np.array(x, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return leaf(tree)


def to_torch_kernel(k):
    """The port's kernel equal to ``k``, a ``gsum_tpu`` kernel (or any
    object with the scikit-learn kernel protocol).

    The class is found by name in :mod:`gsum_tpu_torch.kernels` and built
    from ``k.get_params(deep=False)``; sub-kernels (``k1`` / ``k2`` of a sum
    or product, ``kernel`` of an exponentiation) are converted the same
    way.  Parameter values (numbers, numpy arrays, bounds, ``'fixed'``)
    cross as they are.
    """
    from . import kernels

    name = type(k).__name__
    cls = getattr(kernels, name, None)
    if not (isinstance(cls, type) and issubclass(cls, kernels.Kernel)):
        raise TypeError(f'no kernel {name!r} in gsum_tpu_torch.kernels')
    params = {key: to_torch_kernel(v) if key in ('k1', 'k2', 'kernel') else v
              for key, v in k.get_params(deep=False).items()}
    return cls(**params)


_CONJUGATE = ('ConjugateGaussianProcess', 'ConjugateStudentProcess')
_TRUNCATION = ('TruncationGP', 'TruncationTP')


def _scalar_lambda(fn, name):
    """The number a ``gsum_tpu`` truncation model closed into its
    ``lambda X, <name>=value: value * ones`` for a scalar ``ratio`` / ``ref``,
    or None for a user's callable."""
    code = getattr(fn, '__code__', None)
    if (getattr(fn, '__name__', None) == '<lambda>' and code is not None
            and code.co_varnames[:2] == ('X', name) and fn.__defaults__):
        return fn.__defaults__[0]
    return None


def _conjugate_settings(m, needs):
    """Constructor settings of a ``gsum_tpu`` conjugate process, with its
    fitted kernel and no optimizer when it is fitted; a user basis is added
    to ``needs``."""
    fitted = getattr(m, '_fit', False)
    kw = dict(center=m._center_0, disp=m._disp_0, nugget=m.nugget,
              optimizer=None if fitted else m.optimizer,
              n_restarts_optimizer=m.n_restarts_optimizer,
              copy_X_train=m.copy_X_train, random_state=m.random_state,
              decomposition=m.decomposition, chol_engine=m.chol_engine)
    if np.isinf(m._df_0):
        kw['sd'] = m._scale_0
    else:
        kw.update(df=m._df_0, scale=m._scale_0)
    kernel = m.kernel_ if fitted else m.kernel
    kw['kernel'] = None if kernel is None else to_torch_kernel(kernel)
    if getattr(m.basis, '__name__', None) != '_default_basis':
        needs.append('basis')
    return kw


def to_torch_model(m, device, **overrides):
    """The port's twin of ``m``, a ``gsum_tpu`` ``ConjugateGaussianProcess``,
    ``ConjugateStudentProcess``, ``TruncationGP``, ``TruncationTP`` or
    ``TruncationPointwise``.

    A ``TruncationPointwise`` has no weights: it is rebuilt from its prior
    (``df0``, ``scale0``, ``excluded``) and, when ``m`` is fitted, refitted
    on ``m``'s ``y_``, ``ratio_``, ``ref_`` and ``orders_``, so the result is
    fitted where ``m`` is.

    Any other model carries ``m``'s constructor settings (priors, nugget, optimizer and
    restarts, decomposition, Cholesky engine, and for a truncation model
    ``ratio``, ``ref``, ``excluded`` and ``ratio_kws``) and its kernel
    through :func:`to_torch_kernel`: the fitted ``kernel_`` with
    ``optimizer=None`` when ``m`` is fitted, so that a fit on the same data
    reproduces ``m``'s fitted state.  The result is not fitted, but
    carries ``m``'s derivative data: ``dorders_`` of a conjugate process
    (and of a truncation model's coefficient process), and ``dX_``,
    ``dy_`` and ``dderivs_`` of a truncation model, so that
    ``tm.fit(X, y, dorders=tm.dorders_)`` or ``tm.fit(X, y, orders,
    dX=tm.dX_, dy=tm.dy_, dderivs=tm.dderivs_)`` reproduces ``m``'s fit.

    A user's callable (``basis``, a callable ``ratio`` or ``ref``) is written
    in ``jax.numpy`` and cannot cross: pass its torch twin in
    ``overrides``, which replace any constructor setting.
    """
    from . import models

    name = type(m).__name__
    if name == 'TruncationPointwise':
        return _pointwise(m, resolve_device(device), overrides)
    needs = []
    if name in _CONJUGATE:
        kw = _conjugate_settings(m, needs)
    elif name in _TRUNCATION:
        kw = _conjugate_settings(m.coeffs_process, needs)
        kw.update(excluded=m.excluded, ratio_kws=dict(m.ratio_kws))
        for key in ('ratio', 'ref'):
            kw[key] = _scalar_lambda(getattr(m, key), key)
            if kw[key] is None:
                needs.append(key)
    else:
        raise TypeError(f'no model {name!r} in gsum_tpu_torch.models')
    missing = [k for k in needs if k not in overrides]
    if missing:
        raise ValueError(f'{name} has a user callable for {missing}: pass its '
                         'torch twin as a keyword')
    kw.update(overrides)
    device = resolve_device(device)
    tm = getattr(models, name)(device=device, **kw)
    _carry_derivative_data(m, tm, device)
    return tm


def _carry_derivative_data(m, tm, device):
    """Copies the derivative data of ``m`` onto its twin ``tm``: orders as
    numpy integer arrays, constraint points and values as tensors."""
    def orders(d):
        return None if d is None else np.asarray(d, dtype=int)

    cp, tcp = getattr(m, 'coeffs_process', m), \
        getattr(tm, 'coeffs_process', tm)
    tcp.dorders_ = orders(getattr(cp, 'dorders_', None))
    if tcp is not tm:
        tm.dderivs_ = orders(getattr(m, 'dderivs_', None))
        for f in ('dX_', 'dy_'):
            v = getattr(m, f, None)
            setattr(tm, f, None if v is None else to_torch(np.asarray(v),
                                                           device))


def _pointwise(m, device, overrides):
    """The port's ``TruncationPointwise`` equal to ``m`` (see
    :func:`to_torch_model`)."""
    from .models import TruncationPointwise

    kw = dict(df=m.df0, scale=m.scale0, excluded=m.excluded)
    kw.update(overrides)
    tp = TruncationPointwise(device=device, **kw)
    if getattr(m, '_fit', False):
        y, ratio, ref = to_torch((m.y_, m.ratio_, m.ref_), device)
        tp.fit(y, ratio, ref, orders=np.asarray(m.orders_))
    return tp


def to_torch_posterior(post, device):
    """The port's ``parallel.BatchedPosterior`` holding the arrays of
    ``post``, a ``gsum_tpu`` ``BatchedPosterior`` (or any object with its
    fields), as tensors on ``device`` with their dtypes."""
    from .parallel import BatchedPosterior

    return BatchedPosterior(**{
        f.name: to_torch(np.asarray(getattr(post, f.name)), device)
        for f in dataclasses.fields(BatchedPosterior)})
