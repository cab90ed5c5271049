R"""Tiled RBF covariance build (counterpart of ``gsum_tpu/ops/pallas_cov.py``).

:func:`rbf_covariance_pallas` keeps the JAX name so that users find it.  It
writes ``K = amplitude · exp(−½‖xᵢ − xⱼ‖²/ls²) + noise·I`` from direct
differences of the scaled points, in one launch of a CUDA kernel written for
Hopper (``gsum_tpu_torch/csrc/rbf_cov.cu``, which says how it is built and
what bounds it).  Its persistent blocks walk the tiles of every matrix, so
any batch size runs, and it masks the ragged edge, so any N runs: the TPU
kernel's tile condition and its fallback have no counterpart, and ``tile``
is accepted and has no effect.

On a CPU tensor the wrapper computes the same function with
:func:`rbf_covariance_pallas_plain`; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..profiling import count

__all__ = ['rbf_covariance_pallas', 'rbf_covariance_pallas_plain']

_ENTRIES = {torch.float32: 'gsum_rbf_cov_f32', torch.float64: 'gsum_rbf_cov_f64'}


def _scalar(v, name):
    if isinstance(v, torch.Tensor) and v.numel() != 1:
        raise ValueError(f'{name} must be a scalar, got shape '
                         f'{tuple(v.shape)}')
    return float(v)


def _params(length_scale, amplitude, noise):
    """(1/ls, amplitude, noise) as Python floats; ``noise=None`` is 0."""
    return (1.0 / _scalar(length_scale, 'length_scale'),
            _scalar(amplitude, 'amplitude'),
            0.0 if noise is None else _scalar(noise, 'noise'))


def _check(X):
    if X.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'X must lie on the CPU or a CUDA device, not '
                         f'{X.device}')
    if X.dtype not in _ENTRIES:
        raise ValueError(f'X must be float32 or float64, got {X.dtype}')
    if X.ndim not in (2, 3):
        raise ValueError(f'X must be (N, d) or (B, N, d), got shape '
                         f'{tuple(X.shape)}')
    if not X.is_contiguous():
        raise ValueError('X must be contiguous')


def rbf_covariance_pallas_plain(X, length_scale, amplitude=1.0, noise=0.0):
    """Plain PyTorch version of :func:`rbf_covariance_pallas`: the same
    direct-difference form, summed over the dimensions in order, from
    ``X · (1/ls)``."""
    inv_ls, amplitude, noise = _params(length_scale, amplitude, noise)
    Xs = X * inv_ls
    K = None
    for k in range(X.shape[-1]):
        diff = Xs[..., :, None, k] - Xs[..., None, :, k]
        K = diff.square_() if K is None else K.add_(diff.square_())
    if K is None:
        K = X.new_zeros(X.shape[:-1] + X.shape[-2:-1])
    K.mul_(-0.5).exp_().mul_(amplitude)
    K.diagonal(dim1=-2, dim2=-1).add_(noise)
    return K


@functools.cache
def _entry(dtype):
    fn = getattr(_build.load(), _ENTRIES[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_double,
                   ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rbf_covariance_pallas(X, length_scale, amplitude=1.0, noise=0.0, tile=256):
    R"""RBF covariance from the tiled kernel, for one point set or a batch.

    Parameters
    ----------
    X : (N, d) or (B, N, d), float32 or float64, contiguous, on the CPU or a
        CUDA device
    length_scale, amplitude, noise : scalars (numbers or one-element
        tensors); ``noise=None`` adds no nugget
    tile : accepted for the JAX signature; no effect

    Returns
    -------
    (..., N, N) in X's dtype.

    The counter ``k2.launches`` (``profiling.counters()``) counts the
    kernel's launches.
    """
    del tile
    _check(X)
    if X.device.type == 'cpu':
        return rbf_covariance_pallas_plain(X, length_scale, amplitude, noise)
    inv_ls, amplitude, noise = _params(length_scale, amplitude, noise)
    N, d = X.shape[-2:]
    Xb = X.reshape(-1, N, d)
    K = X.new_empty(Xb.shape[:1] + (N, N))
    if K.numel():
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream(X.device).cuda_stream
            err = _entry(X.dtype)(Xb.data_ptr(), K.data_ptr(), Xb.shape[0], N,
                                  d, inv_ls, amplitude, noise, stream)
        _build.check(err)
        count('k2.launches')
    return K.reshape(X.shape[:-1] + (N,))
