R"""Diagonal-block factorizer: Cholesky factor and triangular inverse.

Counterpart of ``gsum_tpu/ops/pallas_chol.py``.  The blocked factorization
(``ops.blockchol``) needs, for each diagonal block, its Cholesky factor and
the factor's inverse: its panel solves are products with that inverse.
:func:`chol_inv_block` produces both in one launch of a CUDA kernel written
for Hopper (``gsum_tpu_torch/csrc/chol_inv_block.cu``, which says how it is
built and what bounds it).

The JAX function's ``chunk``, ``panel``, ``interpret``, ``unroll`` and
``fuse_panel`` arguments schedule the kernel on a TPU and have no
counterpart, nor has its padding of a single block to a batch of two.

On a CPU tensor the wrapper computes the same function with
:func:`chol_inv_block_plain`; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..profiling import count

__all__ = ['chol_inv_block', 'chol_inv_block_plain', 'MAX_NB']

MAX_NB = 512  # the largest block the kernel takes


def _cholesky_nan(A):
    """Lower Cholesky factor of (..., n, n) SPD A; a matrix whose
    factorization fails comes back NaN in its lower triangle and 0 above
    (as JAX's Cholesky returns it), so that a finite-and-positive diagonal
    test flags it."""
    L, info = torch.linalg.cholesky_ex(A)
    lower = torch.ones(A.shape[-2:], dtype=torch.bool,
                       device=A.device).tril()
    return L.masked_fill((info != 0)[..., None, None] & lower, float('nan'))


def _tri_inv(L):
    """Inverses of (..., n, n) lower-triangular matrices."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def chol_inv_block_plain(A):
    """Plain PyTorch version of :func:`chol_inv_block`: ``(L, L⁻¹)`` of
    (..., n, n) SPD matrices, any floating dtype.  The blocked
    factorization's ``'recursive'`` engine uses it too."""
    L = _cholesky_nan(A)
    return L, _tri_inv(L)


def _check(A):
    if A.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'A must lie on the CPU or a CUDA device, not '
                         f'{A.device}')
    if A.dtype != torch.float32:
        raise ValueError(f'A must be float32, got {A.dtype}')
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f'A must be a (B, nb, nb) batch of square blocks, '
                         f'got shape {tuple(A.shape)}')
    nb = A.shape[-1]
    if nb == 0 or nb % 32:
        raise ValueError(f'block size nb={nb} must be a positive multiple '
                         f'of 32')
    if nb > MAX_NB:
        raise ValueError(f'block size nb={nb} exceeds {MAX_NB}')
    if not A.is_contiguous():
        raise ValueError('A must be contiguous')


@functools.cache
def _entry():
    fn = _build.load().gsum_chol_inv_block_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chol_inv_block(A):
    R"""Cholesky factor and its inverse for a batch of SPD blocks.

    Parameters
    ----------
    A : (B, nb, nb) SPD matrices, float32, contiguous, on the CPU or a CUDA
        device; nb a multiple of 32, at most 512

    Returns
    -------
    (L, Minv): both (B, nb, nb), lower triangular with zeros above the
    diagonal; ``L @ Minv = I`` per batch element.  A block that is not
    positive definite gives a non-finite or non-positive diagonal in L.

    Counters (``profiling.counters()``): ``k1.launches`` counts the
    kernel's launches, ``k1.matrices.<nb>`` the blocks of width nb they
    factored.
    """
    _check(A)
    if A.device.type == 'cpu':
        return chol_inv_block_plain(A)
    B, nb, _ = A.shape
    L = torch.empty_like(A)
    M = torch.empty_like(A)
    if B:
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = _entry()(A.data_ptr(), L.data_ptr(), M.data_ptr(), B, nb,
                           stream)
        _build.check(err)
        count('k1.launches')
        count(f'k1.matrices.{nb}', B)
    return L, M
