"""The blocked factorization's ``diag='hier'`` engine (wide diagonal blocks
split recursively down to 128-wide bases, each through the default
diagonal engine) against ``gsum_tpu``'s at block 256 on the CPU.

N=300 pads to two 256-blocks; each diagonal block splits once into two
128-wide bases.  On ``A Aᵀ/N + I`` (condition number below 5) the factors
agree to 1e-12 relative to the largest entry, as the blocked engines'
(``tests/test_torch_blockchol.py``).  The port's forward launches the
diagonal kernel on the card in each base; here its plain version runs.
"""
import jax.numpy as jnp
import numpy as np
import torch

from gsum_tpu.ops import blockchol as jbc
from gsum_tpu_torch.ops import blockchol as tbc

N = 300


def _spd(seed, G=2):
    A = np.random.RandomState(seed).randn(G, N, N)
    return A @ np.swapaxes(A, -1, -2) / N + np.eye(N)


def test_hier_engine_matches_jax_at_block_256():
    K = _spd(0)
    want = np.asarray(jbc.batched_blocked_cholesky(
        jnp.asarray(K), block=256, diag='hier'))
    got = tbc.batched_blocked_cholesky(torch.tensor(K), block=256,
                                       diag='hier')
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    default = tbc.batched_blocked_cholesky(torch.tensor(K), block=256)
    np.testing.assert_allclose(got.numpy(), default.numpy(), rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_hier_diagonal_factor_and_inverse():
    """_factor_diag_hier of one 256-wide block: L Lᵀ = A and L M = I to
    1e-12, M lower triangular; f32 goes the same way to 1e-5."""
    A = torch.tensor(_spd(1)[:, :256, :256])
    L, M = tbc._factor_diag_hier(A)
    eye = torch.eye(256, dtype=torch.float64)
    assert (L @ L.mT - A).abs().max() < 1e-12 * A.abs().max()
    assert (L @ M - eye).abs().max() < 1e-12
    assert torch.equal(torch.triu(M, 1), torch.zeros_like(M))
    L32, M32 = tbc._factor_diag_hier(A.float())
    assert (L32.double() - L).abs().max() < 1e-5 * L.abs().max()
    assert (L32.double() @ M32.double() - eye).abs().max() < 1e-4


def test_hier_blocked_solve_logdet():
    """The hier engine under the differentiable lml core: the solve and
    log-determinant equal the default engine's (1e-12)."""
    K = torch.tensor(_spd(2))
    Y = torch.tensor(np.random.RandomState(3).randn(2, N, 2))
    x, ld, ok = tbc.blocked_spd_solve_logdet(K, Y, block=256, diag='hier')
    x0, ld0, ok0 = tbc.blocked_spd_solve_logdet(K, Y, block=256)
    assert ok.all() and ok0.all()
    np.testing.assert_allclose(x.numpy(), x0.numpy(), rtol=0,
                               atol=1e-12 * x0.abs().max().item())
    np.testing.assert_allclose(ld.numpy(), ld0.numpy(), rtol=1e-12)
