R"""Single-kernel blocked Cholesky (counterpart of
``gsum_tpu/ops/fusedchol.py``).

:func:`fused_blocked_cholesky` runs the whole left-looking blocked
factorization of a batch of f32 matrices — the history products, the
diagonal factor and inverse, and the panels — in ONE launch of a persistent
cooperative CUDA kernel written for Hopper
(``gsum_tpu_torch/csrc/fused_chol.cu``, which says how it is built and what
bounds it).  ``ops.blockchol`` runs the same algorithm as a sequence of
``torch.matmul`` calls and diagonal-kernel launches.

The JAX function's ``panel``, ``db`` and ``interpret`` arguments schedule the
TPU kernel and have no counterpart.  ``chunk`` is kept and has no effect: the
JAX package pads the batch to a multiple of it for the TPU compiler, which
the port does not need.

On a CPU tensor the wrapper computes the same function with
:func:`fused_blocked_cholesky_plain`; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..profiling import count
from .blockchol import _blocked_factor, _blocked_lower_solve, _logdet_from_chol

__all__ = ['fused_blocked_cholesky', 'fused_blocked_cholesky_plain',
           'fused_chol_solve_logdet']


def _check(K, block):
    if K.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'K must lie on the CPU or a CUDA device, not '
                         f'{K.device}')
    if K.dtype != torch.float32:
        raise ValueError(f'fused_blocked_cholesky is float32-only, got '
                         f'{K.dtype}')
    if K.ndim != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f'K must be a (B, N, N) batch of square matrices, '
                         f'got shape {tuple(K.shape)}')
    N = K.shape[-1]
    if block not in (32, 64, 128, 256):
        raise ValueError(f'block={block} must be a power of two from 32 to '
                         f'256')
    if N % block:
        raise ValueError('N=%d must be a multiple of block=%d' % (N, block))
    if not K.is_contiguous():
        raise ValueError('K must be contiguous')


def fused_blocked_cholesky_plain(K, block=256):
    """Plain PyTorch version of :func:`fused_blocked_cholesky`: the blocked
    factorization of ``ops.blockchol`` with ``torch.linalg`` diagonal blocks,
    its inverses stacked to (B, N/block, block, block)."""
    L, minvs = _blocked_factor(K, block, 'recursive')
    return L, torch.stack(minvs, dim=1)


@functools.cache
def _entry():
    fn = _build.load().gsum_fused_chol_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_blocked_cholesky(K, block=256, chunk=None, tril=False):
    R"""Cholesky of (B, N, N) SPD float32 matrices in one kernel launch.

    Parameters
    ----------
    K : (B, N, N) SPD, float32, on the CPU or a CUDA device
    block : column-block width, a power of two from 32 to 256 dividing N
    chunk : accepted for the JAX signature; no effect
    tril : zero the strict upper triangle of L

    Returns
    -------
    (L, minvs): the factor and the (B, N/block, block, block) inverses of its
    diagonal blocks (consumed by :func:`fused_chol_solve_logdet`).  With
    ``tril=False`` the strict upper triangle of L outside the diagonal blocks
    is unwritten memory, as in JAX: the solve and logdet never read it.  A
    matrix that is not positive definite gives a non-finite or non-positive
    diagonal in its own factor.

    The counter ``k3.launches`` (``profiling.counters()``) counts the
    kernel's launches.
    """
    del chunk
    _check(K, block)
    if K.device.type == 'cpu':
        L, minvs = fused_blocked_cholesky_plain(K, block)
        return (torch.tril(L) if tril else L), minvs
    B, N, _ = K.shape
    L = torch.empty_like(K)
    minvs = K.new_empty((B, N // block, block, block))
    if B and N:
        with torch.cuda.device(K.device):
            stream = torch.cuda.current_stream(K.device).cuda_stream
            err = _entry()(K.data_ptr(), L.data_ptr(), minvs.data_ptr(), B, N,
                           block, stream)
        _build.check(err)
        count('k3.launches')
    if tril:
        L.tril_()
    return L, minvs


def fused_chol_solve_logdet(K, Y, block=256, chunk=None):
    R"""Factors K with :func:`fused_blocked_cholesky`, solves ``L w = Y`` and
    returns ``(w, logdet K)``: the pipeline's factor-and-solve stage.

    The blocked forward substitution reuses the kernel's diagonal-block
    inverses (``torch.matmul``, N/block sequential steps) and reads only the
    lower triangle of L.
    """
    L, minvs = fused_blocked_cholesky(K, block=block, chunk=chunk)
    w = _blocked_lower_solve(L, minvs.unbind(1), Y)
    return w, _logdet_from_chol(L)
