"""The port's dense linear algebra and conjugate updates
(``gsum_tpu_torch.linalg`` and ``.conjugate``) against ``gsum_tpu`` on the
same seeded inputs, f64 on the CPU, at rtol 1e-10: every function of both
modules, both square-root decompositions, V₀ = 0 and V₀ ≠ 0 with a
two-column basis, ν₀ = ∞, the jitter ladder on singular and failing
matrices, and the pivoted Cholesky with its pivots and rank.
"""
import numpy as np
import pytest
import torch

from gsum_tpu import conjugate as jconj
from gsum_tpu import linalg as jla
from gsum_tpu_torch import conjugate as tconj
from gsum_tpu_torch import linalg as tla

from _port import compare
from _port import one_intra_op_thread  # noqa: F401 (autouse)

RTOL = 1e-10
rng = np.random.RandomState(0)
A6 = rng.randn(6, 6)
M = A6 @ A6.T + 6 * np.eye(6)                 # SPD, condition number < 10
w6, Q6 = np.linalg.eigh(M)
S = Q6 @ np.diag(np.sqrt(w6)) @ Q6.T          # a general square root of M
L = np.linalg.cholesky(M)
b1 = rng.randn(6)
b2 = rng.randn(6, 3)
yrows = rng.randn(4, 6)
mean6 = rng.randn(6)
# singular: the last pivot is exactly 0, so the ladder's j = 0 step fails
# and j = 1e-12 wins
SINGULAR = np.zeros((6, 6))
SINGULAR[:5, :5] = M[:5, :5]
NEGATIVE = -np.eye(6)                         # every ladder step fails
B = rng.randn(8, 3)
RANK3 = B @ B.T




def _rank3(G, piv, rank):
    return G, piv[:3], rank


LINALG_CASES = {
    'stabilize': (lambda m: jla.stabilize(m, 1e-3),
                  lambda m: tla.stabilize(m, 1e-3), (M,)),
    'cholesky': (jla.cholesky, tla.cholesky, (M,)),
    'cholesky of a non-SPD matrix is NaN': (jla.cholesky, tla.cholesky,
                                            (NEGATIVE,)),
    'safe_cholesky': (jla.safe_cholesky, tla.safe_cholesky, (M,)),
    'safe_cholesky flags': (jla.safe_cholesky, tla.safe_cholesky,
                            (NEGATIVE,)),
    'cho_solve matrix': (jla.cho_solve, tla.cho_solve, (L, b2)),
    'cho_solve vector': (jla.cho_solve, tla.cho_solve, (L, b1)),
    'spd_solve': (jla.spd_solve, tla.spd_solve, (M, b2)),
    'spd_inv': (jla.spd_inv, tla.spd_inv, (M,)),
    'spd_logdet': (jla.spd_logdet, tla.spd_logdet, (M,)),
    'robust_cholesky SPD': (jla.robust_cholesky, tla.robust_cholesky, (M,)),
    'robust_cholesky singular': (jla.robust_cholesky, tla.robust_cholesky,
                                 (SINGULAR,)),
    'robust_cholesky failing': (jla.robust_cholesky, tla.robust_cholesky,
                                (NEGATIVE,)),
    'robust_spd_solve singular': (jla.robust_spd_solve, tla.robust_spd_solve,
                                  (SINGULAR + np.eye(6) * 1e-3, b2)),
    'robust_spd_solve failing': (jla.robust_spd_solve, tla.robust_spd_solve,
                                 (NEGATIVE, b1)),
    'robust_cho_solve': (lambda m, b: jla.robust_cho_solve(
                             jla.robust_cholesky(m), b),
                         lambda m, b: tla.robust_cho_solve(
                             tla.robust_cholesky(m), b), (SINGULAR, b2)),
    'general_solve vector': (jla.general_solve, tla.general_solve, (S, b1)),
    'general_solve matrix': (jla.general_solve, tla.general_solve, (S, b2)),
    'solve_sqrt cholesky': (lambda l, b: jla.solve_sqrt(l, b, 'cholesky'),
                            lambda l, b: tla.solve_sqrt(l, b, 'cholesky'),
                            (L, b2)),
    'solve_sqrt eig tuple': (lambda e, q, b: jla.solve_sqrt((e, q), b, 'eig'),
                             lambda e, q, b: tla.solve_sqrt((e, q), b, 'eig'),
                             (w6, Q6, b2)),
    'solve_sqrt eig tuple vector': (
        lambda e, q, b: jla.solve_sqrt((e, q), b, 'eig'),
        lambda e, q, b: tla.solve_sqrt((e, q), b, 'eig'), (w6, Q6, b1)),
    'solve_sqrt eig matrix': (lambda s, b: jla.solve_sqrt(s, b, 'eig'),
                              lambda s, b: tla.solve_sqrt(s, b, 'eig'),
                              (S, b2)),
    'logdet_sqrt cholesky': (lambda l: jla.logdet_sqrt(l, 'cholesky'),
                             lambda l: tla.logdet_sqrt(l, 'cholesky'), (L,)),
    'logdet_sqrt eig': (lambda e, q: jla.logdet_sqrt((e, q), 'eig'),
                        lambda e, q: tla.logdet_sqrt((e, q), 'eig'),
                        (w6, Q6)),
    'pivoted_cholesky': (lambda m: jla.pivoted_cholesky(m, True),
                         lambda m: tla.pivoted_cholesky(m, True), (M,)),
    # past the rank the remaining pivots are chosen among round-off, so
    # only the first three are compared
    'pivoted_cholesky rank 3': (
        lambda m: _rank3(*jla.pivoted_cholesky(m, True)),
        lambda m: _rank3(*tla.pivoted_cholesky(m, True)), (RANK3,)),
    'cholesky_errors': (jla.cholesky_errors, tla.cholesky_errors,
                        (yrows, mean6, L)),
    'mahalanobis chol': (lambda y, m, l: jla.mahalanobis(y, m, chol=l),
                         lambda y, m, l: tla.mahalanobis(y, m, chol=l),
                         (yrows, mean6, L)),
    'mahalanobis inv': (lambda y, m, i: jla.mahalanobis(y, m, inv=i),
                        lambda y, m, i: tla.mahalanobis(y, m, inv=i),
                        (yrows, mean6, np.linalg.inv(M))),
    'mahalanobis sqrt_mat': (lambda y, m, s: jla.mahalanobis(y, m, sqrt_mat=s),
                             lambda y, m, s: tla.mahalanobis(y, m, sqrt_mat=s),
                             (yrows, mean6, S)),
    # a 1-D y: JAX's .T is a no-op there, so one whitened vector and a
    # scalar distance (the diagnostics pass mean vectors)
    'cholesky_errors 1-D': (jla.cholesky_errors, tla.cholesky_errors,
                            (yrows[0], mean6, L)),
    'mahalanobis chol 1-D': (lambda y, m, l: jla.mahalanobis(y, m, chol=l),
                             lambda y, m, l: tla.mahalanobis(y, m, chol=l),
                             (yrows[0], mean6, L)),
    'mahalanobis inv 1-D': (lambda y, m, i: jla.mahalanobis(y, m, inv=i),
                            lambda y, m, i: tla.mahalanobis(y, m, inv=i),
                            (yrows[0], mean6, np.linalg.inv(M))),
    'mahalanobis sqrt_mat 1-D': (
        lambda y, m, s: jla.mahalanobis(y, m, sqrt_mat=s),
        lambda y, m, s: tla.mahalanobis(y, m, sqrt_mat=s),
        (yrows[0], mean6, S)),
}


@pytest.mark.parametrize('case', list(LINALG_CASES))
def test_linalg_matches_jax(case):
    jax_fn, torch_fn, args = LINALG_CASES[case]
    compare(jax_fn, torch_fn, args, rtol=RTOL, atol=1e-13)


def test_pivoted_cholesky_pivots_and_rank():
    """The rank-deficient factor reproduces M with rank 3, its pivots are a
    permutation, and the full-rank factor matches LAPACK ``dpstrf``."""
    from scipy.linalg.lapack import dpstrf

    G, piv, rank = tla.pivoted_cholesky(torch.from_numpy(RANK3), True)
    assert int(rank) == 3
    assert sorted(piv.tolist()) == list(range(8))
    np.testing.assert_allclose((G @ G.T).numpy(), RANK3, atol=1e-10)
    G = tla.pivoted_cholesky(torch.from_numpy(M)).numpy()
    c, p, _, _ = dpstrf(M, lower=True)
    np.testing.assert_allclose(G, np.tril(c)[np.argsort(p - 1)], atol=1e-10)


def test_eigh_sqrt_matches_jax():
    """Eigenvalues at rtol 1e-10; eigenvectors up to their sign, through
    the reconstruction Q diag(eig) Qᵀ = M."""
    eig_j, Q_j = (np.asarray(a) for a in jla.eigh_sqrt(M))
    eig, Q = (a.numpy() for a in tla.eigh_sqrt(torch.from_numpy(M)))
    np.testing.assert_allclose(eig, eig_j, rtol=RTOL)
    np.testing.assert_allclose(np.abs(Q), np.abs(Q_j), atol=1e-10)
    np.testing.assert_allclose(Q @ np.diag(eig) @ Q.T, M, rtol=RTOL)


def test_f64_precision_is_a_no_op_context():
    with tla.f64_precision(torch.float64):
        pass


# ---------------------------------------------------------------------------
# conjugate updates
# ---------------------------------------------------------------------------
N = 12
Xc = np.sort(rng.rand(N))
R = np.exp(-0.5 * (Xc[:, None] - Xc[None, :]) ** 2 / 0.3 ** 2) \
    + 1e-3 * np.eye(N)
Yc = np.sin(3 * Xc)[:, None] + 0.3 * rng.randn(N, 3)
BASIS2 = np.stack([np.ones(N), Xc], axis=1)
eigR, QR = np.linalg.eigh(R)
SQRT = {'cholesky': (np.linalg.cholesky(R),), 'eig': (eigR, QR)}
PRIORS = {
    'V0=0': (np.array([0.1, -0.2]), np.zeros((2, 2)), 3.0, 1.5),
    'V0!=0': (np.array([0.1, -0.2]), np.diag([1.0, 2.0]), 3.0, 1.5),
    'df0=inf': (np.array([0.1, -0.2]), np.diag([1.0, 2.0]), np.inf, 1.5),
}


def _sqrt(decomposition, parts):
    return parts[0] if decomposition == 'cholesky' else tuple(parts)


@pytest.mark.parametrize('decomposition', ['cholesky', 'eig'])
@pytest.mark.parametrize('prior', list(PRIORS))
@pytest.mark.parametrize('fn', ['compute_center', 'compute_disp',
                                'compute_scale_sq', 'compute_scale_sq_v2'])
def test_conjugate_matches_jax(fn, prior, decomposition):
    c0, V0, df0, s0 = PRIORS[prior]
    kw = {'compute_center': dict(center0=c0, disp0=V0),
          'compute_disp': dict(disp0=V0),
          'compute_scale_sq': dict(center0=c0, disp0=V0, df0=df0, scale0=s0),
          'compute_scale_sq_v2': dict(center0=c0, disp0=V0, df0=df0,
                                      scale0=s0)}[fn]

    def call(mod):
        def f(y, basis, *parts):
            return getattr(mod, fn)(y, _sqrt(decomposition, parts), basis,
                                    decomposition=decomposition, **kw)
        return f

    compare(call(jconj), call(tconj), (Yc, BASIS2) + SQRT[decomposition],
            rtol=RTOL, atol=1e-13)


@pytest.mark.parametrize('y', [Yc, Yc[:, 0]], ids=['2-D', '1-D'])
def test_conjugate_small_functions(y):
    yt = torch.from_numpy(y)
    assert tconj.num_y(yt) == jconj.num_y(y)
    np.testing.assert_allclose(tconj.avg_y(yt).numpy(),
                               np.asarray(jconj.avg_y(y)), rtol=RTOL)
    assert tconj.compute_df(yt, 3.0) == jconj.compute_df(y, 3.0)
    scale_sq = torch.tensor(0.7, dtype=torch.float64)
    for df in (5.0, np.inf):
        np.testing.assert_allclose(
            float(tconj.compute_cov_factor(scale_sq, df)),
            float(jconj.compute_cov_factor(0.7, df)), rtol=RTOL)
    # a 1-D y with V0 != 0: compute_center solves against a vector
    c0, V0, _, _ = PRIORS['V0!=0']
    compare(lambda yy, b, l: jconj.compute_center(yy, l, b, c0, V0),
            lambda yy, b, l: tconj.compute_center(yy, l, b, c0, V0),
            (y, BASIS2, SQRT['cholesky'][0]), rtol=RTOL, atol=1e-13)
