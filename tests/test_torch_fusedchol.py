"""The port's single-kernel blocked Cholesky (``gsum_tpu_torch.ops.fusedchol``)
against the Pallas kernel it replaces, run in interpret mode as
``tests/test_ops.py::test_fused_chol_interpret`` runs it, and the pipeline's
``method='fused'`` route as a whole.

On the CPU the wrapper computes its plain PyTorch version; the CUDA kernel
itself is held against that version on the card (``test_torch_gpu.py`` and
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsum_tpu.ops import batched as jax_batched
from gsum_tpu.ops.fusedchol import fused_blocked_cholesky as jax_fused
from gsum_tpu.ops.fusedchol import fused_chol_solve_logdet as jax_solve
from gsum_tpu_torch.ops import (batched_chol_logpdf, fused_blocked_cholesky,
                                fused_chol_solve_logdet)
from gsum_tpu_torch.profiling import counters

from _port import spd, to_numpy
from test_torch_batched import inputs
from _port import one_intra_op_thread  # noqa: F401 (autouse)

B, N, BLOCK = 2, 128, 64
PALLAS = dict(block=BLOCK, chunk=2, panel=32, interpret=True)


@pytest.fixture(scope='module')
def case():
    rng = np.random.RandomState(0)
    K = spd(rng, B, N, np.float32)
    Y = rng.randn(B, N, 3).astype(np.float32)
    return K, Y


@pytest.fixture(scope='module')
def jax_factor(case):
    L, minvs = jax_fused(jnp.asarray(case[0]), **PALLAS)
    return np.tril(np.asarray(L)), np.asarray(minvs)


@pytest.mark.parametrize('batch', [B, 1])
def test_fused_blocked_cholesky_matches_pallas_interpret(case, jax_factor,
                                                         batch):
    """tril(L) within 1e-5·max|L| and minvs within 1e-5·max|minvs| of the
    Pallas kernel's (f32 round-off of matrices whose condition number is
    below 5, the bounds of ``test_ops.py::test_fused_chol_interpret``).  The
    B=1 case factors the batch's first matrix alone: each matrix's factor
    depends on it only."""
    L_jax, M_jax = jax_factor
    before = counters()['k3.launches']
    L, minvs = to_numpy(fused_blocked_cholesky(
        torch.from_numpy(case[0][:batch]), block=BLOCK, chunk=2))
    assert counters()['k3.launches'] == before   # no kernel on the CPU
    assert L.shape == (batch, N, N) and L.dtype == np.float32
    assert minvs.shape == (batch, N // BLOCK, BLOCK, BLOCK)
    np.testing.assert_allclose(np.tril(L), L_jax[:batch],
                               atol=1e-5 * np.abs(L_jax).max())
    np.testing.assert_allclose(minvs, M_jax[:batch],
                               atol=1e-5 * np.abs(M_jax).max())


def test_fused_tril_zeroes_the_upper_triangle(case):
    L, _ = fused_blocked_cholesky(torch.from_numpy(case[0]), block=BLOCK,
                                  tril=True)
    assert torch.equal(L, torch.tril(L))


def test_fused_chol_solve_logdet_matches_pallas_interpret(case):
    """w within 1e-5 abs and logdet (about 1e3) within 1e-3 abs."""
    K, Y = case
    w_jax, ld_jax = jax_solve(jnp.asarray(K), jnp.asarray(Y), **PALLAS)
    w, ld = to_numpy(fused_chol_solve_logdet(
        torch.from_numpy(K), torch.from_numpy(Y), block=BLOCK))
    np.testing.assert_allclose(w, np.asarray(w_jax), atol=1e-5)
    np.testing.assert_allclose(ld, np.asarray(ld_jax), atol=1e-3)


def test_fused_pipeline_matches_jax_blocked():
    """The slice as a whole: the port's ``method='fused'`` against JAX's
    ``method='blocked'`` (JAX's own fused route needs a TPU or interpret
    mode) at block 64, rtol 1e-4 (f32 round-off of two orders of summation
    over a covariance whose condition number is about 1e3)."""
    X, y = inputs(5, 2, 128, 2, 3, np.float32)
    want = np.asarray(jax_batched.batched_chol_logpdf(
        jnp.asarray(X), jnp.asarray(y), 0.25, 1.0, 1e-2, method='blocked',
        block=64))
    got = batched_chol_logpdf(torch.from_numpy(X), torch.from_numpy(y), 0.25,
                              1.0, 1e-2, method='fused', block=64)
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize('K,block,why', [
    (torch.eye(128, dtype=torch.float64).expand(2, 128, 128).contiguous(), 64,
     'float32-only'),
    (torch.eye(96).expand(2, 96, 96).contiguous(), 64, 'multiple of block'),
    (torch.eye(96).expand(2, 96, 96).contiguous(), 48, 'power of two'),
    (torch.eye(128), 64, r'\(B, N, N\)'),
    (torch.eye(128).expand(2, 128, 128), 64, 'contiguous'),
])
def test_fused_rejects_what_the_kernel_does_not_take(K, block, why):
    """JAX's errors (dtype, N % block) and the kernel's own limits."""
    with pytest.raises(ValueError, match=why):
        fused_blocked_cholesky(K, block=block)
