R"""Throughput path of the port: batched covariance build, blocked Cholesky
(with its two differentiable forms) and MVN logpdf (counterpart of
``gsum_tpu.ops``), with the diagonal-block kernel, the single-kernel blocked
Cholesky and the tiled RBF covariance build in CUDA for Hopper; and
``incbeta``, the regularized incomplete beta function and its inverse as
CUDA kernels (the port's own, behind ``stats._special``)."""
from .batched import (
    batched_chol_logpdf,
    batched_cholesky,
    batched_mvn_logpdf,
    rbf_covariance,
)
from .blockchol import (
    batched_blocked_cholesky,
    blocked_cho_solve,
    blocked_chol_solve_logdet,
    blocked_factor,
    blocked_spd_solve_logdet,
)
from . import incbeta
from .chol_inv import chol_inv_block, chol_inv_block_plain
from .fusedchol import (
    fused_blocked_cholesky,
    fused_blocked_cholesky_plain,
    fused_chol_solve_logdet,
)
from .rbf_cov import rbf_covariance_pallas, rbf_covariance_pallas_plain

__all__ = [
    'batched_cholesky', 'batched_mvn_logpdf', 'batched_chol_logpdf',
    'rbf_covariance', 'batched_blocked_cholesky', 'blocked_chol_solve_logdet',
    'blocked_factor', 'blocked_cho_solve', 'blocked_spd_solve_logdet',
    'chol_inv_block', 'chol_inv_block_plain',
    'fused_blocked_cholesky', 'fused_blocked_cholesky_plain',
    'fused_chol_solve_logdet', 'rbf_covariance_pallas',
    'rbf_covariance_pallas_plain', 'incbeta',
]
