"""``ops.scanchol`` and the blocked helpers ``blocked_tri_inv_diag`` /
``blocked_solve_lower`` of the port against ``gsum_tpu`` on the CPU.

The port factors left-looking by column blocks with each history product
over the rows at and below the diagonal (N³/3 FLOPs); JAX's scan body
multiplies full-height slabs whose columns past the diagonal are still
zero, so both sum the same nonzero products: the factor, the stacked
diagonal-block inverses (identity-padded at N=70, block 32) and the solve
agree to 1e-12 relative on ``A Aᵀ/N + I`` (condition number below 5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsum_tpu.ops import blockchol as jbc
from gsum_tpu.ops import scanchol as jscan
from gsum_tpu_torch.ops import blockchol as tbc
from gsum_tpu_torch.ops import scanchol as tscan
from _port import one_intra_op_thread  # noqa: F401 (autouse)

N, BLOCK = 70, 32
TOL = 1e-12


def _spd(seed, G=3, n=N):
    A = np.random.RandomState(seed).randn(G, n, n)
    return A @ np.swapaxes(A, -1, -2) / n + np.eye(n)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.fixture(scope='module')
def jax_scan():
    A = _spd(0)
    B = np.random.RandomState(1).randn(3, N, 2)
    L, minvs = jax.jit(jscan.scan_blocked_cholesky,
                       static_argnames=('block', 'leaf'))(
        jnp.asarray(A), block=BLOCK)
    x = jscan.scan_cho_solve(L, minvs, jnp.asarray(B))
    return A, B, np.asarray(L), np.asarray(minvs), np.asarray(x)


def test_scan_blocked_cholesky_matches_jax(jax_scan):
    A, B, L_j, minvs_j, x_j = jax_scan
    L, minvs = tscan.scan_blocked_cholesky(torch.tensor(A), block=BLOCK)
    assert minvs.shape == (-(-N // BLOCK), 3, BLOCK, BLOCK)
    _close(L, L_j)
    _close(minvs, minvs_j)
    # the padded tail of the last block inverts to the identity
    pad = minvs.shape[0] * BLOCK - N
    eye = torch.eye(pad, dtype=torch.float64).expand(3, pad, pad)
    assert torch.equal(minvs[-1][:, -pad:, -pad:], eye)
    _close(L, torch.linalg.cholesky(torch.tensor(A)).numpy())


def test_scan_cho_solve_matches_jax(jax_scan):
    A, B, L_j, minvs_j, x_j = jax_scan
    L, minvs = tscan.scan_blocked_cholesky(torch.tensor(A), block=BLOCK)
    x = tscan.scan_cho_solve(L, minvs, torch.tensor(B))
    _close(x, x_j)
    _close(x, np.linalg.solve(A, B))
    with pytest.raises(ValueError, match='does not match'):
        tscan.scan_cho_solve(L, minvs, torch.tensor(B), block=16)


def test_scan_gradient_matches_dense():
    """The scan factor and solve are built out of place, so autograd
    differentiates them.  The scan reads A's lower triangle and diagonal
    blocks only (as JAX's), the dense route symmetrises, so the two
    gradients agree in their symmetric parts (1e-10), which is what a
    symmetric A sees."""
    A = torch.tensor(_spd(2, G=2, n=40), requires_grad=True)
    B = torch.tensor(np.random.RandomState(3).randn(2, 40, 2))
    L, minvs = tscan.scan_blocked_cholesky(A, block=16)
    (g,) = torch.autograd.grad(tscan.scan_cho_solve(L, minvs, B).sum(), A)
    A2 = A.detach().clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(
        torch.cholesky_solve(B, torch.linalg.cholesky(A2)).sum(), A2)
    _close(g + g.mT, (g2 + g2.mT).numpy(), 1e-10)


def test_scan_non_pd_member_is_flagged():
    A = _spd(4)
    A[2] = -A[2]
    L, _ = tscan.scan_blocked_cholesky(torch.tensor(A), block=BLOCK)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    assert (torch.isfinite(d) & (d > 0)).all(-1).tolist() == \
        [True, True, False]


def test_blocked_tri_inv_diag_and_solve_lower_match_jax():
    """The diagonal-block inverses (trailing one identity-padded) and the
    lower solve, against JAX's on the same factor."""
    A = _spd(5)
    Y = np.random.RandomState(6).randn(3, N, 2)
    L = np.linalg.cholesky(A)
    want = jax.jit(lambda L: jbc.blocked_tri_inv_diag(L, block=BLOCK,
                                                      leaf=16))(
        jnp.asarray(L))
    got = tbc.blocked_tri_inv_diag(torch.tensor(L), block=BLOCK)
    assert len(got) == len(want) == -(-N // BLOCK)
    for g, w in zip(got, want):
        _close(g, w)
    w = jax.jit(lambda L, Y: jbc.blocked_solve_lower(L, Y, leaf=16))(
        jnp.asarray(L), jnp.asarray(Y))
    _close(tbc.blocked_solve_lower(torch.tensor(L), torch.tensor(Y)), w)
    # differentiable: the inverses' gradient is finite and lower
    Lt = torch.tensor(L, requires_grad=True)
    (g,) = torch.autograd.grad(
        sum(m.sum() for m in tbc.blocked_tri_inv_diag(Lt, block=BLOCK)), Lt)
    assert torch.isfinite(g).all()
    assert torch.equal(torch.triu(g, 1), torch.zeros_like(g))
