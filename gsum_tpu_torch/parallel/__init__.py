R"""Several devices: meshes, batched fits and sweeps, and the sharded
large-N factorization (counterpart of ``gsum_tpu.parallel``).

The reference is single-process NumPy; its implicit parallel axes (curves,
observables, hyperparameter grids, and the linear algebra of one large N)
become a :class:`~gsum_tpu_torch.parallel.mesh.Mesh` of devices with a
``'batch'`` axis (independent fits and grid points, ``mesh=`` of the
batched functions) and a ``'model'`` axis (covariance rows, ``pchol``).
One process drives every device of a mesh, as in JAX.
"""
from .mesh import Mesh, make_mesh, shard_batch
from .batched import (BatchedPosterior, batched_fit, batched_lml_grid,
                      batched_posterior_at, batched_predict, make_lml_fn,
                      pointwise_evidence_grid, truncation_lml_grid)
from .pchol import (sharded_cgp_lml, sharded_cholesky, sharded_fit,
                    sharded_gram_logdet, sharded_kernel_lml,
                    sharded_mvn_lml)

__all__ = ['Mesh', 'make_mesh', 'shard_batch', 'batched_fit',
           'batched_predict', 'batched_posterior_at', 'batched_lml_grid',
           'truncation_lml_grid', 'pointwise_evidence_grid', 'make_lml_fn',
           'BatchedPosterior', 'sharded_cholesky', 'sharded_kernel_lml',
           'sharded_mvn_lml', 'sharded_gram_logdet', 'sharded_cgp_lml',
           'sharded_fit']
