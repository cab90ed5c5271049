"""The port's tiled RBF covariance build (``gsum_tpu_torch.ops.rbf_cov``)
against ``gsum_tpu.ops.rbf_covariance_pallas``, which takes its XLA path on
the CPU (the ``x² + y² − 2xy`` expansion) where the port computes direct
differences.

On the CPU the wrapper computes its plain PyTorch version; the CUDA kernel
itself is held against that version on the card (``test_torch_gpu.py`` and
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsum_tpu.ops import rbf_covariance_pallas as jax_rbf
from gsum_tpu_torch.ops import (rbf_covariance_pallas,
                                rbf_covariance_pallas_plain)
from gsum_tpu_torch.profiling import counters

from _port import compare
from _port import one_intra_op_thread  # noqa: F401 (autouse)

LS, AMP, NOISE = 0.5, 2.0, 0.1


def _points(seed, shape, dtype):
    return np.random.RandomState(seed).rand(*shape).astype(dtype)


def _pair(ls=LS, amp=AMP, noise=NOISE):
    return (lambda X: jax_rbf(jnp.asarray(X), ls, amp, noise),
            lambda X: rbf_covariance_pallas(X, ls, amp, noise))


@pytest.mark.parametrize('d', [1, 2, 3, 9])
@pytest.mark.parametrize('N', [24, 64])
@pytest.mark.parametrize('batch', [None, 3])
def test_rbf_covariance_pallas_matches_jax_f64(batch, N, d):
    """f64, one point set and a batch, up to d = 9 (more dimensions than
    the kernel staged at a time before): atol 1e-12 (the two forms differ
    by round-off of order 1e-15 at these scales)."""
    shape = (N, d) if batch is None else (batch, N, d)
    before = counters()['k2.launches']
    compare(*_pair(), (_points(N + d, shape, np.float64),), atol=1e-12)
    assert counters()['k2.launches'] == before   # no kernel on the CPU


@pytest.mark.parametrize('shape', [(64, 2), (2, 100, 3)])
def test_rbf_covariance_pallas_matches_jax_f32(shape):
    """f32 at atol 2e-6: the expansion loses about eps·|x/ls|² of the squared
    distance to cancellation, which exp carries into K (|x/ls|² ≤ 4d for
    points in the unit cube at ls = 0.5)."""
    compare(*_pair(LS, 1.0, 1e-2), (_points(7, shape, np.float32),),
            atol=2e-6)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_rbf_covariance_pallas_plain_is_exactly_symmetric(dtype):
    """K equals its transpose bit for bit: (a − b)² rounds as (b − a)²
    does.  The kernel computes only the tiles on and above the diagonal and
    mirrors them, so this is the property it must reproduce."""
    X = torch.from_numpy(_points(5, (2, 70, 3), np.float64)).to(dtype)
    K = rbf_covariance_pallas_plain(X, LS, AMP, NOISE)
    assert torch.equal(K, K.mT)


def test_rbf_covariance_pallas_scalar_forms():
    """Scalars as one-element tensors, and ``noise=None`` (no nugget)."""
    X = torch.from_numpy(_points(3, (2, 40, 2), np.float64))
    want = rbf_covariance_pallas(X, LS, AMP, 0.0)
    got = rbf_covariance_pallas(X, torch.tensor(LS), torch.tensor([AMP]),
                                None)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize('X,why', [
    (torch.zeros(8, 2, dtype=torch.int64), 'float32 or float64'),
    (torch.zeros(2, 2, 8, 2), r'\(N, d\) or \(B, N, d\)'),
    (torch.zeros(2, 8).t(), 'contiguous'),
])
def test_rbf_covariance_pallas_rejects_what_the_kernel_does_not_take(X, why):
    with pytest.raises(ValueError, match=why):
        rbf_covariance_pallas(X, LS)


def test_rbf_covariance_pallas_takes_scalars_only():
    with pytest.raises(ValueError, match='scalar'):
        rbf_covariance_pallas(torch.zeros(2, 8, 2), torch.ones(2))
