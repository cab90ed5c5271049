R"""Batched fits and hyperparameter-grid sweeps on one card (counterpart of
``gsum_tpu.parallel``).

The JAX package's mesh construction and sharded large-N factorization
(``parallel.mesh``, ``parallel.pchol``) are not ported yet (ROADMAP.md
queue A, item 5); the ``mesh=`` argument of the batched functions raises
``NotImplementedError``.
"""
from .batched import (BatchedPosterior, batched_fit, batched_lml_grid,
                      batched_posterior_at, batched_predict, make_lml_fn,
                      pointwise_evidence_grid, truncation_lml_grid)

__all__ = ['batched_fit', 'batched_predict', 'batched_posterior_at',
           'batched_lml_grid', 'truncation_lml_grid',
           'pointwise_evidence_grid', 'make_lml_fn', 'BatchedPosterior']
