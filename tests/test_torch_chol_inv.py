"""The port's diagonal-block factorizer (``gsum_tpu_torch.ops.chol_inv``)
against the Pallas kernel it replaces, run in interpret mode.

On the CPU the wrapper computes its plain PyTorch version; the CUDA kernel
itself is held against that version on the card (``test_torch_gpu.py`` and
``chip_smoke.py``).
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsum_tpu.ops.pallas_chol import chol_inv_block as jax_chol_inv_block
from gsum_tpu_torch.ops import chol_inv_block

from _port import compare
from _port import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blocks(rng, B, nb):
    A = rng.randn(B, nb, nb)
    return (A @ np.swapaxes(A, -1, -2) / nb + np.eye(nb)).astype(np.float32)


def _jax(K):
    return jax_chol_inv_block(jnp.asarray(K), chunk=2, panel=32,
                              interpret=True)


@pytest.mark.parametrize('B,nb', [(2, 64), (1, 32)])
def test_chol_inv_block_matches_pallas_interpret(B, nb):
    """L and M agree with the Pallas kernel's within 1e-5·max|L| and
    L·M = I to 1e-5: the bounds of
    ``tests/test_ops.py::test_pallas_chol_inv_interpret`` (f32 round-off of
    a block whose condition number is below 5)."""
    K = _blocks(np.random.RandomState(0), B, nb)
    scale = np.abs(np.linalg.cholesky(K.astype(np.float64))).max()
    _, (L, M) = compare(lambda k: tuple(_jax(k)), chol_inv_block, (K,),
                        atol=1e-5 * scale)
    resid = np.einsum('bij,bjk->bik', L.astype(np.float64),
                      M.astype(np.float64)) - np.eye(nb)
    assert np.abs(resid).max() < 1e-5
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(M, 1) == 0)


def test_non_spd_block_is_flagged_by_both():
    """A block that is not positive definite leaves a non-finite or
    non-positive diagonal in both versions (the blocked callers' success
    flag reads it); its SPD neighbour in the batch is unaffected."""
    K = _blocks(np.random.RandomState(1), 2, 64)
    K[1, 5, 5] = -1.0
    L_jax, _ = _jax(K)
    L, _ = chol_inv_block(torch.from_numpy(K))
    for Lx in (np.asarray(L_jax), L.numpy()):
        d = np.diagonal(Lx, axis1=1, axis2=2)
        ok = np.all(np.isfinite(d) & (d > 0), axis=1)
        assert ok.tolist() == [True, False]


@pytest.mark.parametrize('A,why', [
    (torch.eye(64, dtype=torch.float64).expand(2, 64, 64).contiguous(),
     'float32'),
    (torch.eye(64), '(B, nb, nb)'),
    (torch.eye(48).expand(2, 48, 48).contiguous(), 'multiple of 32'),
    (torch.eye(544).expand(1, 544, 544).contiguous(), 'exceeds 512'),
    (torch.eye(64).expand(2, 64, 64), 'contiguous'),
    (torch.empty(2, 64, 64, device='meta'), 'CPU or a CUDA device'),
])
def test_chol_inv_block_rejects_what_the_kernel_does_not_take(A, why):
    with pytest.raises(ValueError, match=why):
        chol_inv_block(A)


def test_import_leaves_jax_out():
    """The port imports no JAX (it must run where JAX is not installed)."""
    code = ('import sys, gsum_tpu_torch, gsum_tpu_torch.ops, '
            'gsum_tpu_torch.convert, gsum_tpu_torch._build; '
            'assert "jax" not in sys.modules, sorted(sys.modules)')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)
