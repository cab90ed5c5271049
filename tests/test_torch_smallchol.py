"""``ops.smallchol`` of the port (thin wrappers over batched
``torch.linalg``) against ``gsum_tpu.ops.smallchol`` (recursive blockings
with analytic custom VJPs) on the CPU: values and gradients of the
Cholesky, the triangular inverse and the triangular solve, f64 and f32, at
N in {5, 16, 40}; and a non-positive-definite member.

Tolerances: the test matrices are ``A Aᵀ + N I`` (condition number below
5), so the factors agree to a few ulps of the dtype times N: values 1e-12
(f64) and 2e-5 (f32) relative to the largest entry; gradients, three more
products deep, 1e-10 and 1e-4.  JAX's chain is jitted and its VJP taken
once per (N, dtype): eager, every op of the unrolled recursion compiles
on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsum_tpu.ops import smallchol as jsc
from gsum_tpu_torch.ops import smallchol as tsc
from _port import one_intra_op_thread  # noqa: F401 (autouse)

TOL = {np.float64: (1e-12, 1e-10), np.float32: (2e-5, 1e-4)}
NS = (5, 16, 40)


def _chain_j(A, B):
    L = jsc.batched_small_cholesky(A)
    return L, jsc.batched_small_tri_inv(L), \
        jsc.batched_small_solve_triangular(L, B)


def _chain_t(A, B):
    L = tsc.batched_small_cholesky(A)
    return L, tsc.batched_small_tri_inv(L), \
        tsc.batched_small_solve_triangular(L, B)


def _inputs(N, dtype, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(3, N, N)
    A = (A @ np.swapaxes(A, -1, -2) + N * np.eye(N)).astype(dtype)
    B = rng.randn(3, N, 2).astype(dtype)
    cts = tuple(rng.randn(*s).astype(dtype)
                for s in ((3, N, N), (3, N, N), (3, N, 2)))
    return A, B, cts


@pytest.fixture(scope='module')
def jax_chain():
    """JAX's values and VJPs of (cholesky, tri_inv, solve) for every (N,
    dtype), the VJP at random cotangents of all three outputs."""
    out = {}
    chain = jax.jit(_chain_j)
    for N in NS:
        for dtype in TOL:
            A, B, cts = _inputs(N, dtype, N)
            vals, vjp = jax.vjp(chain, jnp.asarray(A), jnp.asarray(B))
            grads = jax.jit(vjp)(tuple(jnp.asarray(c) for c in cts))
            out[N, dtype] = ([np.asarray(v) for v in vals],
                             [np.asarray(g) for g in grads])
    return out


def _close(got, want, tol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize('dtype', list(TOL), ids=['f64', 'f32'])
@pytest.mark.parametrize('N', NS)
def test_values_and_gradients_match_jax(jax_chain, N, dtype):
    """Torch's own Cholesky and triangular-solve backwards are JAX's
    analytic adjoints (symmetrised Murray; tril(−Mᵀ M̄ Mᵀ)); the VJP of the
    whole chain through A and B agrees with ``jax.vjp``."""
    A, B, cts = _inputs(N, dtype, N)
    At = torch.tensor(A, requires_grad=True)
    Bt = torch.tensor(B, requires_grad=True)
    vals = _chain_t(At, Bt)
    grads = torch.autograd.grad(vals, (At, Bt),
                                tuple(torch.tensor(c) for c in cts))
    want_vals, want_grads = jax_chain[N, dtype]
    vtol, gtol = TOL[dtype]
    for got, want in zip(vals, want_vals):
        assert got.detach().numpy().dtype == want.dtype
        _close(got.detach().numpy(), want, vtol)
    for got, want in zip(grads, want_grads):
        _close(got.numpy(), want, gtol)


def test_tri_inv_gradient_is_lower():
    """The inverse's adjoint keeps the lower triangle (JAX's ``tril``)."""
    A, _, cts = _inputs(6, np.float64, 1)
    L = torch.linalg.cholesky(torch.tensor(A)).requires_grad_(True)
    (g,) = torch.autograd.grad(tsc.batched_small_tri_inv(L), L,
                               torch.tensor(cts[0]))
    assert torch.equal(torch.triu(g, 1), torch.zeros_like(g))


def test_non_pd_member_gives_nan_and_minus_inf():
    """A non-positive-definite member: its factor is NaN in the lower
    triangle (flagged by the finite-and-positive diagonal test, as JAX's),
    and ``batched_grid_lml`` gives -inf there and JAX's values elsewhere
    (1e-12 relative)."""
    A, _, _ = _inputs(8, np.float64, 2)
    A[1] = -A[1]
    y = np.random.RandomState(3).randn(8, 2)
    L = tsc.batched_small_cholesky(torch.tensor(A))
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    rows, cols = np.tril_indices(8)
    assert torch.isnan(L[1][rows, cols]).all()
    assert (torch.isfinite(d) & (d > 0)).all(-1).tolist() == \
        [True, False, True]
    dj = np.diagonal(np.asarray(jax.jit(jsc.batched_small_cholesky)(
        jnp.asarray(A))), axis1=-2, axis2=-1)
    assert (np.isfinite(dj) & (dj > 0)).all(-1).tolist() == \
        [True, False, True]
    got = tsc.batched_grid_lml(torch.tensor(A), torch.tensor(y)).numpy()
    want = np.asarray(jsc.batched_grid_lml(jnp.asarray(A), jnp.asarray(y)))
    assert got[1] == want[1] == -np.inf
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=1e-12)
    # per-point y
    yg = np.random.RandomState(4).randn(3, 8, 2)
    got = tsc.batched_grid_lml(torch.tensor(A), torch.tensor(yg)).numpy()
    want = np.asarray(jsc.batched_grid_lml(jnp.asarray(A), jnp.asarray(yg)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
