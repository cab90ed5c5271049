"""The port's blocked Cholesky (``gsum_tpu_torch.ops.blockchol``) against
``gsum_tpu.ops.blockchol`` on the same inputs.

JAX runs with ``leaf=8``: the leaf size of its recursive diagonal
factorization changes the result only by round-off, and the small leaf
keeps JAX's eager compile on the CPU short.
"""
import numpy as np
import pytest
import torch

from gsum_tpu.ops import blockchol as jax_blockchol
from gsum_tpu_torch.ops import blockchol

from _port import compare, spd
from _port import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize('B,N,m,block', [(2, 384, 5, 128), (2, 320, 5, 128)])
def test_blocked_chol_solve_logdet_f64_matches_jax(B, N, m, block):
    """w to atol 1e-8 and logdet to rtol 1e-10, the bounds of
    ``tests/test_ops.py::test_blocked_chol_solve_logdet``; N=320 exercises
    the identity padding."""
    rng = np.random.RandomState(0)
    K, Y = spd(rng, B, N), rng.randn(B, N, m)
    (w_jax, ld_jax), (w, ld) = compare(
        lambda k, y: jax_blockchol.blocked_chol_solve_logdet(
            k, y, block=block, leaf=8),
        lambda k, y: blockchol.blocked_chol_solve_logdet(k, y, block=block),
        (K, Y), atol=1e-8)
    np.testing.assert_allclose(ld, ld_jax, rtol=1e-10)


def test_blocked_chol_solve_logdet_f32_kernel_engine(monkeypatch):
    """f32 goes through the diagonal kernel's engine (its plain version on
    the CPU) and agrees with JAX's f32 result to rtol 2e-4, the f32 bound of
    ``tests/test_ops.py::test_batched_chol_logpdf_forwards_block``; w is
    held to 2e-4 of its largest entry, since its small entries carry the
    same absolute round-off."""
    engines = []
    factor_diag = blockchol._factor_diag

    def spy(Akk, engine):
        engines.append(engine)
        return factor_diag(Akk, engine)

    monkeypatch.setattr(blockchol, '_factor_diag', spy)
    rng = np.random.RandomState(1)
    K, Y = spd(rng, 2, 256, np.float32), rng.randn(2, 256, 3).astype(
        np.float32)
    w_jax, ld_jax = (np.asarray(a) for a in
                     jax_blockchol.blocked_chol_solve_logdet(K, Y, block=128,
                                                             leaf=8))
    w, ld = blockchol.blocked_chol_solve_logdet(torch.from_numpy(K),
                                                torch.from_numpy(Y),
                                                block=128)
    assert engines == ['kernel', 'kernel']
    assert w.dtype == torch.float32 and ld.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), w_jax,
                               atol=2e-4 * np.abs(w_jax).max())
    np.testing.assert_allclose(ld.numpy(), ld_jax, rtol=2e-4)


def test_blocked_factor_and_cho_solve_f64():
    """blocked_factor's L is the Cholesky factor and blocked_cho_solve
    solves K x = Y, both against torch.linalg at f64 round-off (condition
    number below 5), with identity padding (N=320, block=128)."""
    rng = np.random.RandomState(2)
    K = torch.from_numpy(spd(rng, 2, 320))
    Y = torch.from_numpy(rng.randn(2, 320, 4))
    L, minvs = blockchol.blocked_factor(K, block=128)
    assert len(minvs) == 3 and L.shape == K.shape
    Lref = torch.linalg.cholesky(K)
    assert (L - Lref).abs().max() < 1e-12 * Lref.abs().max()
    x = blockchol.blocked_cho_solve(L, minvs, Y)
    xref = torch.linalg.solve(K, Y)
    assert (x - xref).abs().max() < 1e-12 * xref.abs().max()
