"""Gradients of the port's differentiable blocked functions against
``jax.vjp`` of their ``gsum_tpu.ops.blockchol`` twins on the same seeded
inputs and cotangents, in f64 on the CPU at rtol 1e-9:
``batched_blocked_cholesky`` (Murray adjoint) and
``blocked_spd_solve_logdet`` (four-GEMM backward), with N a block multiple,
N padded to one, N ≤ block, and a batch holding one non-SPD matrix, whose
gradients are zero.

JAX runs with ``leaf=8``, which changes its result only by round-off and
keeps its eager compile on the CPU short.
"""
import jax
import numpy as np
import pytest
import torch

from gsum_tpu.ops import blockchol as jax_blockchol
from gsum_tpu_torch.ops import batched_blocked_cholesky, blocked_spd_solve_logdet

from _port import spd

RTOL = 1e-9


def _close(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize('B,N,block', [(2, 128, 64), (2, 100, 64),
                                       (2, 40, 64)],
                         ids=['multiple', 'padded', 'one-block'])
def test_batched_blocked_cholesky_vjp_matches_jax(B, N, block):
    rng = np.random.RandomState(N)
    K = spd(rng, B, N)
    Lbar = np.tril(rng.randn(B, N, N))
    L_j, vjp = jax.vjp(
        lambda k: jax_blockchol.batched_blocked_cholesky(k, block, 8), K)
    (Kbar_j,) = vjp(Lbar)

    Kt = torch.from_numpy(K).requires_grad_(True)
    L = batched_blocked_cholesky(Kt, block=block)
    (Kbar,) = torch.autograd.grad(L, Kt, torch.from_numpy(Lbar))
    _close(L, L_j)
    _close(Kbar, Kbar_j)
    assert torch.equal(Kbar, Kbar.mT)


def _bssl_grads(K, Y, xbar, lbar, block):
    Kt = torch.from_numpy(K).requires_grad_(True)
    Yt = torch.from_numpy(Y).requires_grad_(True)
    x, logdet, ok = blocked_spd_solve_logdet(Kt, Yt, block=block)
    Kbar, Ybar = torch.autograd.grad(
        (x, logdet), (Kt, Yt), (torch.from_numpy(xbar),
                                torch.from_numpy(lbar)))
    return x, logdet, ok, Kbar, Ybar


def _jax_bssl(K, Y, xbar, lbar, block):
    def f(k, y):
        x, logdet, ok = jax_blockchol.blocked_spd_solve_logdet(k, y, block, 8)
        return (x, logdet), ok

    (x, logdet), vjp, ok = jax.vjp(f, K, Y, has_aux=True)
    return (x, logdet, ok) + vjp((xbar, lbar))


@pytest.mark.parametrize('B,N,m,block', [(2, 128, 3, 64), (2, 100, 3, 64),
                                         (2, 40, 2, 64)],
                         ids=['multiple', 'padded', 'one-block'])
def test_blocked_spd_solve_logdet_vjp_matches_jax(B, N, m, block):
    rng = np.random.RandomState(N + m)
    K, Y = spd(rng, B, N), rng.randn(B, N, m)
    xbar, lbar = rng.randn(B, N, m), rng.randn(B)
    want = _jax_bssl(K, Y, xbar, lbar, block)
    got = _bssl_grads(K, Y, xbar, lbar, block)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        _close(g, w)
    assert got[2].tolist() == np.asarray(want[2]).tolist() == [True] * B


def test_blocked_spd_solve_logdet_zeroes_a_failed_matrix():
    """A batch with one non-SPD matrix, block 32: ``ok`` flags it, its
    gradients are exactly zero (not NaN), and the others match JAX."""
    rng = np.random.RandomState(7)
    K, Y = spd(rng, 3, 96), rng.randn(3, 96, 2)
    K[1, 50, 50] = -1e3
    xbar, lbar = rng.randn(3, 96, 2), rng.randn(3)
    want = _jax_bssl(K, Y, xbar, lbar, 32)
    x, logdet, ok, Kbar, Ybar = _bssl_grads(K, Y, xbar, lbar, 32)
    assert ok.tolist() == np.asarray(want[2]).tolist() == [True, False, True]
    assert torch.all(Kbar[1] == 0) and torch.all(Ybar[1] == 0)
    for g, w in zip((x, logdet, Kbar, Ybar), want[:2] + want[3:]):
        _close(g[[0, 2]], np.asarray(w)[[0, 2]])
