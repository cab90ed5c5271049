R"""The regularized incomplete beta function and its inverse on the card.

No TPU kernel stands behind these: the JAX package takes ``betainc`` from
``jax.scipy.special`` (XLA's continued fraction, one compiled loop) and
writes ``betaincinv`` (``gsum_tpu/stats/_special.py:33``) as a 50-step
``fori_loop`` of Newton steps that each call it.  In eager PyTorch every
term of the continued fraction would be some twenty launches, and one
quantile 10⁴–10⁵ of them.  So each of the two functions is one CUDA kernel
(``gsum_tpu_torch/csrc/incbeta.cu``, which says what bounds it) that runs
the whole loop in registers, in one of two forms with the same arithmetic
(:func:`form`): a warp per element for launches of at most ``WARP_MAX``
elements (``helpers.hpd``'s one-element quantiles among them), a thread per
element above.  Both run the plain version's Lentz loop and Newton
iteration operation for operation, so an element's value does not depend
on the form or on the size of the launch it is in.

The wrappers take same-shape, contiguous float32 or float64 tensors (the
broadcasting is ``stats._special``'s).  On a CPU tensor they compute the same
function with the plain versions in ``stats._special``; on a CUDA tensor
they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..profiling import count

__all__ = ['betainc', 'betaincinv', 'cf_terms', 'form', 'WARP_MAX']

# elements up to which a warp takes each one.  On an H100 80GB HBM3 at
# 700 W (``python -m gsum_tpu_torch.time_incbeta``'s sweep) the warp form's
# betaincinv took 0.49-0.87 of the thread form's time from 1 to 2048
# elements on the t quantile's and the beta bands' arguments, f64 and
# f32, and 1.04-1.54 of it at 8192, where the thread form has filled the
# card with fewer lanes
WARP_MAX = 2048


def form(x):
    """The kernel's form for a launch over ``x``: 1, a warp per element (at
    most ``WARP_MAX`` elements), else 0, a thread per element."""
    return int(x.numel() <= WARP_MAX)


def _check(*args):
    dev, dtype, shape = args[0].device, args[0].dtype, args[0].shape
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'arguments must lie on the CPU or a CUDA device, '
                         f'not {dev}')
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f'arguments must be float32 or float64, got {dtype}')
    for t in args:
        if t.device != dev or t.dtype != dtype or t.shape != shape:
            raise ValueError('arguments must share one device, dtype and '
                             'shape')
        if not t.is_contiguous():
            raise ValueError('arguments must be contiguous')


@functools.cache
def _entry(name, dtype):
    suffix = 'f32' if dtype == torch.float32 else 'f64'
    fn = getattr(_build.load(), f'gsum_{name}_{suffix}')
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, a, b, x, terms=None, chunks=None):
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _entry(name, x.dtype)(
                a.data_ptr(), b.data_ptr(), x.data_ptr(), out.data_ptr(),
                *(None if t is None else t.data_ptr()
                  for t in (terms, chunks)),
                x.numel(), form(x), stream)
        _build.check(err)
        count(f'p1.{name}.launches')
    return out


def betainc(a, b, x):
    R"""``I_x(a, b)`` elementwise, by XLA's algorithm.

    The counter ``p1.betainc.launches`` (``profiling.counters()``) counts
    the kernel's launches.
    """
    _check(a, b, x)
    if x.device.type == 'cpu':
        from ..stats._special import betainc_plain

        return betainc_plain(a, b, x)
    return _launch('betainc', a, b, x)


def betaincinv(a, b, p):
    R"""The x with ``I_x(a, b) = p``, elementwise, by the JAX package's
    bracketed Newton iteration.

    The counter ``p1.betaincinv.launches`` (``profiling.counters()``)
    counts the kernel's launches.
    """
    _check(a, b, p)
    if p.device.type == 'cpu':
        from ..stats._special import betaincinv_plain

        return betaincinv_plain(a, b, p)
    return _launch('betaincinv', a, b, p)


def cf_terms(fn, a, b, x):
    R"""Each element's count of continued-fraction terms, up to its stop
    term, in one launch of ``fn`` (:func:`betainc` or :func:`betaincinv`,
    where the count is summed over the Newton steps) on CUDA tensors: the
    work that bounds the launch.  Returns ``(out, terms, chunks)``, the
    counts int32 of x's shape: ``chunks``, the chunks of 8 terms between two
    stop tests that each element's warp ran (0 where a thread takes the
    element)."""
    _check(a, b, x)
    terms = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    chunks = torch.zeros_like(terms)
    return _launch(fn.__name__, a, b, x, terms, chunks), terms, chunks
