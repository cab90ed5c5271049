R"""Conversion of the JAX package's inputs and state into the port's tensors.

``gsum_tpu`` takes numpy arrays and Python scalars; its results come back as
arrays that ``numpy.asarray`` reads.  :func:`to_torch` turns such values, or
dicts, tuples and lists of them, into tensors on an explicit device.
:func:`to_torch_kernel` rebuilds a ``gsum_tpu`` kernel as the port's kernel
of the same class and parameters (its θ, bounds and fixed flags come along).
Neither imports the JAX package: kernels are read by duck typing.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ._config import resolve_device

__all__ = ['to_torch', 'to_torch_kernel']


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
