R"""Dtype and device policy of the port (counterpart of ``gsum_tpu/_config.py``).

``gsum_tpu`` turns JAX's float64 mode on at import, because the library's
parity target (1e-8 against the reference) needs f64, and builds its f32
performance paths explicitly.  The port keeps that policy without changing
any global setting: f64 is the default floating type of what the library
creates, and the ``ops`` functions follow the dtype of their inputs.

Devices: what the library is given as a tensor stays on that tensor's
device; what it is given as numpy (a kernel called on a numpy ``X``, the
model classes' data) goes to :func:`default_device`, the CUDA card.  There is
no quiet CPU fallback: asking for ``cuda`` where no card is visible raises.

The JAX compile-cache patches of ``gsum_tpu/_config.py`` have no
counterpart: PyTorch runs eagerly and its kernels are built by ``_build``.
"""
from __future__ import annotations

import numpy as np
import torch


def default_dtype():
    """The library's default floating dtype (float64, as ``gsum_tpu``)."""
    return torch.float64


def default_device():
    """Where numpy inputs go: the CUDA card."""
    return torch.device('cuda')


def resolve_device(device):
    """``device`` as a ``torch.device``; it must be given explicitly.

    A CUDA device is refused where no card is visible, instead of quietly
    running on the CPU.
    """
    if device is None:
        raise ValueError('an explicit device is required (e.g. "cpu" or '
                         '"cuda:0")')
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but '
                           'torch.cuda.is_available() is False')
    return device


def result_dtype(dtype):
    """The dtype JAX's x64 promotion gives ``dtype`` together with the
    library's default (``jnp.result_type(x, float)``).

    Torch does not promote a tensor by a 0-d tensor of a wider float type
    (float32 ``X`` divided by a float64 0-d θ stays float32), so the port
    casts to this dtype before any arithmetic.
    """
    return torch.promote_types(default_dtype(), dtype)


def as_input(x, device=None):
    """``x`` as a tensor: a tensor keeps its device; anything else (numpy,
    lists, scalars) goes to ``device``, :func:`default_device` when None."""
    if isinstance(x, torch.Tensor):
        return x
    device = resolve_device(default_device() if device is None else device)
    return torch.as_tensor(np.asarray(x), device=device)


def device_constant(value, device):
    """``value`` (a number or numpy array) as a tensor of the default dtype
    on ``device``.  A value whose entries are all equal is filled on the
    device, not copied from the host: a copy from pageable host memory
    waits for the device's queue, and the models build such constants in
    the middle of every log-marginal likelihood."""
    a = np.asarray(value, dtype=float)
    if a.size and np.all(a == a.flat[0]):
        return torch.full(a.shape, float(a.flat[0]), dtype=default_dtype(),
                          device=device)
    return torch.as_tensor(a, dtype=default_dtype(), device=device)
