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
``datasets``; the statistics ``stats`` (norm, t, χ², F, beta, binomial,
multivariate normal and t) with the regularized incomplete beta function
and its inverse as CUDA kernels (``csrc/incbeta.cu``, ``ops.incbeta``), the
pointwise truncation model ``models.TruncationPointwise``, the numerical
``diagnostics.Diagnostic``, and the rest of ``helpers`` (``predictions``,
the HPD intervals, ``kl_gauss``, the decorators, ``VariogramFourthRoot``);
batched throughput on one card: the bounded L-BFGS engines of
``optimize``, ``ops.smallchol`` / ``ops.scanchol`` / ``ops.gridlml``, and
``parallel`` (batched fits, grid sweeps, the batched posterior), whose
``precision`` / ``mxu_precision`` of JAX's signatures compute in full f32
whatever their value; model checking,
derivative observations and sampling: ``derivs`` (derivative
cross-covariances by ``torch.func``, behind the models' ``dorders`` and
``dderivs``), ``diagnostics.GraphicalDiagnostic`` with its renderer
``viz``, the HMC of ``sample``, ``checkpoint`` (the JAX package's npz
format), ``profiling`` and ``pdfmeta``; large N across devices:
``parallel.mesh`` (single-controller meshes, a device may repeat),
``parallel.pchol`` (the row-sharded Cholesky, the on-shard lml with its
forward-mode gradient, ``sharded_fit``) and every ``mesh=`` argument.
``convert.to_torch`` moves the JAX package's inputs (numpy
arrays and scalars) onto a device, ``convert.to_torch_kernel`` its kernels
and ``convert.to_torch_model`` its models.
"""
from . import (checkpoint, conjugate, convert, datasets, derivs, diagnostics,
               entry, helpers, kernels, linalg, models, ops, optimize,
               parallel, pdfmeta, profiling, sample, stats, viz)
from ._config import default_device, default_dtype, resolve_device
from .datasets import (
    make_gaussian_partial_sums,
    make_gaussian_partial_sums_on_grid,
    make_gaussian_partial_sums_uniform,
)
from .derivs import deriv_cov, deriv_mean, kernel_deriv_cov
from .diagnostics import Diagnostic, GraphicalDiagnostic
from .helpers import (
    VariogramFourthRoot,
    cartesian,
    cholesky_errors,
    coefficients,
    default_attributes,
    gaussian,
    generate_coefficients,
    geometric_sum,
    hpd,
    hpd_pdf,
    kl_gauss,
    lazy,
    lazy_property,
    mahalanobis,
    median_pdf,
    partials,
    pivoted_cholesky,
    predictions,
    rbf,
    stabilize,
    toy_data,
)
from .kernels import (
    RBF,
    ConstantKernel,
    DotProduct,
    Exponentiation,
    ExpSineSquared,
    Hyperparameter,
    Kernel,
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
    TruncationPointwise,
    TruncationTP,
)
from .pdfmeta import add_pdf_metadata, get_pdf_metadata
from .sample import (
    hmc,
    posterior_predictive,
    sample_theta_posterior,
    sample_truncation_posterior,
    truncation_posterior_predictive,
)

__all__ = ['checkpoint', 'conjugate', 'convert', 'datasets', 'derivs',
           'diagnostics', 'entry', 'helpers', 'kernels', 'linalg', 'models',
           'ops', 'optimize', 'parallel', 'pdfmeta', 'profiling', 'sample',
           'stats', 'viz', 'default_device',
           'default_dtype', 'resolve_device', 'ConstantKernel', 'WhiteKernel',
           'RBF', 'Matern', 'RationalQuadratic', 'ExpSineSquared',
           'DotProduct', 'Sum', 'Product', 'Exponentiation',
           'BaseConjugateProcess', 'ConjugateGaussianProcess',
           'ConjugateStudentProcess', 'TruncationProcess', 'TruncationGP',
           'TruncationTP', 'TruncationPointwise', 'Diagnostic',
           'GraphicalDiagnostic',
           'cartesian', 'toy_data', 'generate_coefficients', 'coefficients',
           'partials', 'predictions', 'stabilize', 'gaussian', 'hpd',
           'hpd_pdf', 'median_pdf', 'kl_gauss', 'rbf', 'default_attributes',
           'cholesky_errors', 'mahalanobis', 'lazy_property', 'lazy',
           'VariogramFourthRoot', 'geometric_sum', 'pivoted_cholesky',
           'Kernel', 'Hyperparameter', 'make_gaussian_partial_sums',
           'make_gaussian_partial_sums_on_grid',
           'make_gaussian_partial_sums_uniform', 'add_pdf_metadata',
           'get_pdf_metadata', 'deriv_cov', 'deriv_mean', 'kernel_deriv_cov',
           'hmc', 'posterior_predictive', 'sample_theta_posterior',
           'sample_truncation_posterior', 'truncation_posterior_predictive']
