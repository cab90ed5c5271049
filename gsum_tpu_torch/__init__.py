R"""PyTorch and CUDA port of ``gsum_tpu`` for NVIDIA Hopper (H100).

``gsum_tpu`` (JAX) stays the reference; this package mirrors its module names
and public signatures so that each function has an obvious counterpart.  It
imports ``torch`` and never ``jax``, and changes no global setting on import.

Ported so far: the batched f32 pipeline ``ops.batched_chol_logpdf``
(covariance build, blocked Cholesky, blocked solve and logdet, MVN logpdf)
with its three kernels written in CUDA for ``sm_90a``: the diagonal-block
factor and inverse (``csrc/chol_inv_block.cu``), the single-kernel blocked
Cholesky of ``method='fused'`` (``csrc/fused_chol.cu``) and the tiled RBF
covariance build ``ops.rbf_covariance_pallas`` (``csrc/rbf_cov.cu``); the
differentiable blocked functions ``ops.batched_blocked_cholesky`` and
``ops.blocked_spd_solve_logdet``; and the single-model conjugate GP path:
``kernels``, ``linalg``, ``conjugate``, ``optimize.scipy_lbfgsb``,
``models.ConjugateGaussianProcess`` and ``entry.flagship_step``; the
Student-t process ``models.ConjugateStudentProcess`` and the truncation
models ``models.TruncationGP`` / ``TruncationTP``, with the series algebra
and toy-data generators of ``helpers`` and the partial-sum generators of
``datasets``.  ``convert.to_torch`` moves the JAX package's inputs (numpy
arrays and scalars) onto a device, ``convert.to_torch_kernel`` its kernels
and ``convert.to_torch_model`` its models.
"""
from . import (conjugate, convert, datasets, entry, helpers, kernels, linalg,
               models, ops, optimize)
from ._config import default_device, default_dtype, resolve_device
from .kernels import (
    RBF,
    ConstantKernel,
    DotProduct,
    Exponentiation,
    ExpSineSquared,
    Matern,
    Product,
    RationalQuadratic,
    Sum,
    WhiteKernel,
)
from .models import (
    BaseConjugateProcess,
    ConjugateGaussianProcess,
    ConjugateStudentProcess,
    TruncationGP,
    TruncationProcess,
    TruncationTP,
)

__all__ = ['conjugate', 'convert', 'datasets', 'entry', 'helpers', 'kernels',
           'linalg', 'models', 'ops', 'optimize', 'default_device',
           'default_dtype', 'resolve_device', 'ConstantKernel', 'WhiteKernel',
           'RBF', 'Matern', 'RationalQuadratic', 'ExpSineSquared',
           'DotProduct', 'Sum', 'Product', 'Exponentiation',
           'BaseConjugateProcess', 'ConjugateGaussianProcess',
           'ConjugateStudentProcess', 'TruncationProcess', 'TruncationGP',
           'TruncationTP']
