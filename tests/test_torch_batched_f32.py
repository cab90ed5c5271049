"""The port's pipeline against ``gsum_tpu.ops.batched`` at f32, where the
blocked factorization's diagonal blocks take the CUDA kernel's engine (its
plain version on the CPU)."""
import numpy as np
import pytest

from _port import compare
from test_torch_batched import inputs, pipeline
from _port import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize('method', ['blocked', 'xla'])
def test_batched_chol_logpdf_f32_matches_jax(method):
    """f32 at (2, 256, 2, 3), block 128 (the diagonal kernel's engine):
    rtol 2e-4, the f32 bound of
    ``tests/test_ops.py::test_batched_chol_logpdf_forwards_block``."""
    compare(*pipeline(method, block=128),
            inputs(2, 2, 256, 2, 3, np.float32), rtol=2e-4)
