R"""PyTorch and CUDA port of ``gsum_tpu`` for NVIDIA Hopper (H100).

``gsum_tpu`` (JAX) stays the reference; this package mirrors its module names
and public signatures so that each function has an obvious counterpart.  It
imports ``torch`` and never ``jax``, and changes no global setting on import.

Ported so far: the batched f32 pipeline ``ops.batched_chol_logpdf``
(covariance build, blocked Cholesky, blocked solve and logdet, MVN logpdf)
with its three kernels written in CUDA for ``sm_90a``: the diagonal-block
factor and inverse (``csrc/chol_inv_block.cu``), the single-kernel blocked
Cholesky of ``method='fused'`` (``csrc/fused_chol.cu``) and the tiled RBF
covariance build ``ops.rbf_covariance_pallas`` (``csrc/rbf_cov.cu``).  ``convert.to_torch`` moves the JAX
package's inputs (numpy arrays and scalars) onto a device.
"""
from . import convert, ops
from ._config import default_dtype, resolve_device

__all__ = ['convert', 'ops', 'default_dtype', 'resolve_device']
