"""The port's pipeline (``gsum_tpu_torch.ops.batched``) against
``gsum_tpu.ops.batched``: covariance build → Cholesky → MVN logpdf, the
slice as a whole, at f64 (the f32 cases are in ``test_torch_batched_f32.py``,
a file of their own because each dtype costs JAX a compile of some 20 s on
the CPU)."""
import jax
import numpy as np
import pytest
import torch

from gsum_tpu.ops import batched as jax_batched
from gsum_tpu_torch.convert import to_torch
from gsum_tpu_torch.ops import batched, blockchol

from _port import compare


def inputs(seed, B, N, d, m, dtype):
    rng = np.random.RandomState(seed)
    return rng.rand(B, N, d).astype(dtype), rng.randn(B, N, m).astype(dtype)


def test_rbf_covariance_matches_jax_f64():
    """Batched build with per-matrix hyperparameters vs JAX's vmapped
    single-matrix build, to f64 round-off (atol 1e-12)."""
    X, _ = inputs(0, 3, 50, 2, 1, np.float64)
    ls, amp, noise = np.array([0.25, 0.5, 1.0]), np.array([1.0, 2.0, 0.5]), \
        np.array([1e-2, 0.0, 1e-4])
    compare(jax.vmap(jax_batched.rbf_covariance), batched.rbf_covariance,
            (X, ls, amp, noise), atol=1e-12)
    compare(lambda x: jax_batched.rbf_covariance(x, 0.3, 1.5, None),
            lambda x: batched.rbf_covariance(x, 0.3, 1.5, None),
            (X[0],), atol=1e-12)


def pipeline(method, block=None):
    return (lambda X, y: jax_batched.batched_chol_logpdf(
                X, y, 0.25, 1.0, 1e-2, method=method, block=block),
            lambda X, y: batched.batched_chol_logpdf(
                X, y, 0.25, 1.0, 1e-2, method=method, block=block))


@pytest.mark.parametrize('method', ['blocked', 'xla'])
def test_batched_chol_logpdf_f64_matches_jax(method):
    """f64 at (B, N, d, m) = (2, 320, 2, 3), identity padding included:
    rtol 1e-9 (the covariance's condition number is ~1e4, so f64 round-off
    stays near 1e-12)."""
    compare(*pipeline(method), inputs(1, 2, 320, 2, 3, np.float64),
            rtol=1e-9)


def test_auto_takes_blocked_route_above_512(monkeypatch):
    """'auto' at N=576 goes through the blocked factorization's diagonal
    blocks (5 of them, padded to 640) and equals 'blocked' to 1e-12; at
    N=512 it takes the torch.linalg route and reaches no diagonal block."""
    calls = []
    factor_diag = blockchol._factor_diag

    def spy(Akk, engine):
        calls.append(engine)
        return factor_diag(Akk, engine)

    monkeypatch.setattr(blockchol, '_factor_diag', spy)
    X, y = to_torch(inputs(3, 2, 576, 2, 2, np.float64), 'cpu')
    auto = batched.batched_chol_logpdf(X, y, 0.25, 1.0, 1e-2)
    assert calls == ['recursive'] * 5
    blocked = batched.batched_chol_logpdf(X, y, 0.25, 1.0, 1e-2,
                                          method='blocked')
    np.testing.assert_allclose(auto.numpy(), blocked.numpy(), rtol=1e-12)

    calls.clear()
    batched.batched_chol_logpdf(X[:, :512], y[:, :512], 0.25, 1.0, 1e-2)
    assert calls == []


def test_to_torch_keeps_structure_and_dtypes():
    state = {'X': np.zeros((2, 3), np.float32), 'ls': 0.25,
             'orders': (np.arange(3), np.float32(2.0)), 'noise': None}
    out = to_torch(state, 'cpu')
    assert out['X'].dtype == torch.float32 and out['X'].shape == (2, 3)
    assert out['ls'].dtype == torch.float64 and out['ls'].item() == 0.25
    assert out['orders'][0].dtype == torch.int64
    assert out['orders'][1].dtype == torch.float32
    assert out['noise'] is None
    assert to_torch(state, 'cpu', torch.float64)['X'].dtype == torch.float64
    with pytest.raises(ValueError, match='explicit device'):
        to_torch(state, None)
