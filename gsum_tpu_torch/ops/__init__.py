R"""Throughput path of the port: batched covariance build, blocked Cholesky
(with its two differentiable forms) and MVN logpdf (counterpart of
``gsum_tpu.ops``), with the diagonal-block kernel, the single-kernel blocked
Cholesky and the tiled RBF covariance build in CUDA for Hopper; the
batched small-N factorizations (``smallchol``, ``scanchol``) and the grid
log-marginal likelihoods (``gridlml``) on ``torch.linalg``; and
``incbeta``, the regularized incomplete beta function and its inverse as
CUDA kernels (the port's own, behind ``stats._special``)."""
from .batched import (
    batched_chol_logpdf,
    batched_cholesky,
    batched_mvn_logpdf,
    rbf_covariance,
)
from .smallchol import (
    batched_grid_lml,
    batched_small_cholesky,
    batched_small_solve_triangular,
    batched_small_tri_inv,
)
from .gridlml import (batched_cho_solve, cgp_lml_grid, cgp_lml_grid2,
                      csp_lml_grid, csp_lml_grid2)
from .blockchol import (
    batched_blocked_cholesky,
    blocked_cho_solve,
    blocked_chol_solve_logdet,
    blocked_factor,
    blocked_solve_lower,
    blocked_spd_solve_logdet,
    blocked_tri_inv_diag,
)
from .scanchol import scan_blocked_cholesky, scan_cho_solve
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
    'rbf_covariance', 'batched_small_cholesky',
    'batched_small_solve_triangular', 'batched_small_tri_inv',
    'batched_grid_lml', 'cgp_lml_grid', 'cgp_lml_grid2', 'csp_lml_grid',
    'csp_lml_grid2', 'batched_cho_solve', 'batched_blocked_cholesky',
    'blocked_chol_solve_logdet', 'blocked_factor', 'blocked_cho_solve',
    'blocked_spd_solve_logdet', 'blocked_tri_inv_diag', 'blocked_solve_lower',
    'scan_blocked_cholesky', 'scan_cho_solve',
    'chol_inv_block', 'chol_inv_block_plain',
    'fused_blocked_cholesky', 'fused_blocked_cholesky_plain',
    'fused_chol_solve_logdet', 'rbf_covariance_pallas',
    'rbf_covariance_pallas_plain', 'incbeta',
]
