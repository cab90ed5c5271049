"""Parity harness for the PyTorch port.

:func:`compare` runs a ``gsum_tpu`` callable and its ``gsum_tpu_torch`` twin
on the same numpy inputs, made by the caller from a seeded
``np.random.RandomState``, converts both outputs to numpy and asserts one
stated tolerance on every output.  It holds the port against the JAX
package only, never against the original library.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gsum_tpu_torch.convert import to_torch


@pytest.fixture(autouse=True, scope='module')
def one_intra_op_thread():
    """One intra-op torch thread for a test module that imports this
    fixture: in the suite's six workers, more threads cost more in
    contention (with each other and with the JAX tests' own threads) than
    they save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_numpy(tree):
    """numpy arrays in place of tensors / JAX arrays, in any nesting of
    tuples and lists."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(t) for t in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def spd(rng, B, N, dtype=np.float64):
    """(B, N, N) well-conditioned SPD matrices, ``A Aᵀ + N I`` as
    ``tests/test_ops.py`` builds them (condition number below 5)."""
    A = rng.randn(B, N, N)
    return (A @ np.swapaxes(A, -1, -2) + N * np.eye(N)).astype(dtype)


def compare(jax_fn, torch_fn, args, *, rtol=0.0, atol=0.0, device='cpu'):
    """Runs ``jax_fn(*args)`` and ``torch_fn(*to_torch(args, device))``.

    Asserts that every output of the port agrees with the JAX one within
    ``rtol`` and ``atol`` (numpy's ``assert_allclose``; the two outputs must
    have the same structure) and returns both outputs as numpy.
    """
    want = to_numpy(jax_fn(*args))
    got = to_numpy(torch_fn(*to_torch(tuple(args), device)))
    want_l, got_l = _leaves(want), _leaves(got)
    assert len(want_l) == len(got_l), (len(want_l), len(got_l))
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (g.shape, g.dtype, w.shape, w.dtype)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return want, got
