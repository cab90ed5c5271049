"""Shared data and helpers of the truncation-model parity tests
(``test_torch_truncation.py``, ``test_torch_truncation_predict.py``): the
seeded partial sums, the JAX model and its twin in the port, and the jitter
ladder's rung and condition number, from which the interpolant's tolerance
is derived.
"""
import functools

import jax.numpy as jnp
import numpy as np
import torch

import gsum_tpu as gm
from gsum_tpu_torch.convert import to_torch_model

RTOL = 1e-10
N = 12
X = np.linspace(0.1, 1.0, N)[:, None]
ORDERS = np.arange(5)
RATIO, REF = 0.45, 2.0
rng = np.random.RandomState(42)
COEFFS = np.sin(3 * X + np.arange(5)) + 0.05 * rng.randn(N, 5)
Y = np.asarray(gm.partials(COEFFS, RATIO, REF, ORDERS))
XNEW = np.linspace(0.15, 0.95, 7)[:, None]
DX, DY = np.array([[1.2], [1.5]]), np.zeros(2)
PRIORS = {'TruncationGP': dict(center=0, disp=0, df=3, scale=1),
          'TruncationTP': dict(center=0, disp=1, df=5, scale=1)}
JITTERS = (0.0, 1e-12, 1e-9, 1e-6)
EPS = np.finfo(float).eps
# at ℓ = 0.1 the interpolant's K_oo is well conditioned (rung 0); at
# ℓ = 3 it is singular to round-off (its smallest eigenvalues are negative
# on both sides), so both take rung 1 (jitter 1e-12)
LENGTH_SCALES = {'well conditioned': 0.1, 'ill conditioned': 3.0}
THETA = np.log([0.2, 1e-3])


def jax_kernel(ls=0.3):
    return gm.RBF(ls, (1e-2, 10)) + gm.WhiteKernel(1e-4, (1e-8, 1e-1))


def models(name, ls=0.3, **kw):
    """The JAX model and its twin in the port (on the CPU)."""
    jm = getattr(gm, name)(jax_kernel(ls), ratio=RATIO, ref=REF,
                           **{**PRIORS[name], **kw})
    return jm, to_torch_model(jm, 'cpu')


@functools.lru_cache(maxsize=None)
def _at_theta(name, ls):
    """A JAX model at one θ (``optimizer=None``), kept for the module: each
    new JAX model compiles its lml and fit state anew, a refit of the same
    one does not."""
    return models(name, ls, optimizer=None)[0]


def at_theta(name, ls):
    """The JAX model at one θ, and a new twin of it in the port."""
    jm = _at_theta(name, ls)
    return jm, to_torch_model(jm, 'cpu')


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def pairs(got, want):
    return zip(*((got, want) if isinstance(want, tuple)
                 else ((got,), (want,))))


def ladder(M):
    """The first rung of the jitter ladder that factors M, and the condition
    number of the jittered matrix there."""
    M = np.asarray(M)
    s = np.max(np.diag(M))
    for rung, j in enumerate(JITTERS):
        try:
            np.linalg.cholesky(M + j * s * np.eye(len(M)))
        except np.linalg.LinAlgError:
            continue
        ev = np.linalg.eigvalsh(M)
        return rung, (ev[-1] + j * s) / (max(ev[0], 0.0) + j * s)
    raise AssertionError('every rung of the ladder failed')


def interp_tol(jm, tm, order, Xc=X):
    """The same rung on both sides, and cond·ε of the jittered K_oo."""
    (rung_j, cond), (rung_t, _) = (
        ladder(jm.cov(Xc, Xc, start=0, end=order)),
        ladder(tm.cov(t(Xc), t(Xc), start=0, end=order).numpy()))
    assert rung_j == rung_t, (rung_j, rung_t)
    return max(RTOL, cond * EPS), rung_j


def ratio_jax(X, q=0.5):
    """A point-dependent ratio with a keyword, as a user of the JAX package
    writes it."""
    return q * (1 + 0.2 * jnp.sin(X[:, 0]))


def ratio_torch(X, q=0.5):
    """The same ratio for the port, which passes it tensors."""
    return q * (1 + 0.2 * torch.sin(X[:, 0]))
