R"""Device meshes (counterpart of ``gsum_tpu/parallel/mesh.py``).

The canonical mesh of the library has a ``'batch'`` axis for independent
work (observables, curves, grid points, optimizer restarts) and a
``'model'`` axis over which one large covariance matrix is sharded by rows.

As JAX's, the mesh is *single-controller*: one Python process drives every
device of the mesh, a sharded function loops over the shards (each shard's
tensors on its own device, so work on distinct cards overlaps through
CUDA's asynchronous launches), and the caller gets the whole result back.
The collectives are the plain functions below: a gather is a stack of
``t.to(device)`` (a no-op on the same device, a peer copy between cards),
a sum runs on the device where the controller reads it, and a shard's axis
index is its position in the loop.

A device may repeat in a mesh (``devices=['cpu'] * 8``, ``['cuda:0'] *
4``), the counterpart of JAX's ``--xla_force_host_platform_device_count``:
the algorithm then runs its D shards on one device, which is how the tests
run D = 8 on the CPU and how one card runs a D = 4 mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from .._config import as_input, resolve_device

__all__ = ['Mesh', 'make_mesh', 'shard_batch']


class Mesh:
    """Devices on a grid with named axes (as ``jax.sharding.Mesh``).

    ``devices``: an array-like of devices (``torch.device`` or strings),
    whose shape is the mesh's; ``axis_names``: one name per dimension.
    ``mesh.shape[name]`` is the size of an axis.  A CUDA device must exist:
    a mesh that names a card the machine does not have raises.
    """

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.empty(arr.shape, dtype=object)
        for idx, dev in np.ndenumerate(arr):
            self.devices[idx] = _device(dev)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f'{len(self.axis_names)} axis names for a '
                             f'{self.devices.ndim}-d device array')
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
        return f'Mesh({self.shape}, devices={self.devices.tolist()})'


def _device(dev):
    dev = resolve_device(dev)
    if dev.type == 'cuda':
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f'device {dev} requested but only '
                               f'{torch.cuda.device_count()} CUDA card(s) '
                               'are visible')
        dev = torch.device('cuda', index)
    return dev


def make_mesh(n_batch=None, n_model=1, devices=None):
    """A ('batch', 'model') mesh.

    Parameters
    ----------
    n_batch : int, optional — size of the batch axis; defaults to
        ``len(devices) // n_model``
    n_model : int — size of the model axis
    devices : list, optional — defaults to every visible CUDA card
        (``torch.cuda.device_count()``); with none visible, pass them (a
        device may repeat)
    """
    if devices is None:
        count = torch.cuda.device_count()
        if not count:
            raise RuntimeError('make_mesh: no CUDA card is visible; pass '
                               "devices= (e.g. ['cpu'] * 8)")
        devices = [torch.device('cuda', i) for i in range(count)]
    devices = list(devices)
    if n_batch is None:
        n_batch = len(devices) // n_model
    use = n_batch * n_model
    if not 0 < use <= len(devices):
        raise ValueError(f'a ({n_batch}, {n_model}) mesh needs {use} '
                         f'devices, {len(devices)} given')
    grid = np.empty(use, dtype=object)
    grid[:] = devices[:use]
    return Mesh(grid.reshape(n_batch, n_model), ('batch', 'model'))


def _axis_devices(mesh, axis):
    """The devices along ``axis``, at index 0 of every other axis (JAX
    replicates a computation over the other axes; here it runs once)."""
    arr = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), -1)
    return list(arr.reshape(-1, arr.shape[-1])[0])


def shard_batch(mesh, *arrays):
    """Each array's leading axis split over the mesh's 'batch' axis: a list
    with one tensor per shard, on that shard's device (numpy inputs go to
    the first shard's device first).  The leading axis must divide."""
    devices = _axis_devices(mesh, 'batch')
    out = []
    for a in arrays:
        a = as_input(a, device=devices[0])
        if a.shape[0] % len(devices):
            raise ValueError(f'leading axis {a.shape[0]} is not divisible '
                             f"by the mesh's 'batch' axis size "
                             f'{len(devices)}')
        out.append([s.to(dev) for s, dev in zip(
            torch.tensor_split(a, len(devices)), devices)])
    return out[0] if len(out) == 1 else tuple(out)


def _distinct(devices):
    """The distinct devices of a list, in order."""
    return list(dict.fromkeys(devices))


def _all_gather(shards, device):
    """The shards' tensors stacked on ``device``."""
    return torch.stack([s.to(device) for s in shards])


def _psum(values, device):
    """The sum of one value per shard, formed on ``device``: the controller
    reads it there (JAX's psum leaves a copy on every shard)."""
    return sum(v.to(device) for v in values)
