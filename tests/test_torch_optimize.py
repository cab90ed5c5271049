"""The port's bounded L-BFGS engines (``gsum_tpu_torch.optimize``) against
``gsum_tpu.optimize`` on the CPU: the sigmoid / softplus maps, the two
fixed-trip engines' iterates on ``tests/test_optimize.py``'s five bound
cases and a boxed Rosenbrock, and ``jit_lbfgs_bounded``'s minimiser.

The fixed-trip engines do the same arithmetic in the same order as JAX's
(a handful of float64 operations per iteration on P <= 2), so their
iterates after a few iterations agree to 1e-8 on these smooth problems
(measured: 1e-14).  ``jit_lbfgs_bounded`` runs another iteration than
JAX's optax engine, so only its minimiser is held (1e-5, the tolerance of
``tests/test_optimize.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsum_tpu import optimize as jopt
from gsum_tpu_torch import optimize as topt

CASES = [
    # (lo, hi, x0, optimum), as tests/test_optimize.py
    (-np.inf, np.inf, 1.0, -5.0),      # unbounded
    (0.0, np.inf, 1.0, 0.0),           # one-sided lower, optimum at the bound
    (-np.inf, -7.0, -8.0, -7.0),       # one-sided upper, optimum at the bound
    (-10.0, 10.0, 1.0, -5.0),          # box, interior optimum
    (-4.0, -1.0, -2.0, -4.0),          # box, optimum at a bound
]
MAXITER, LS_STEPS = 5, 4
ITER_TOL = 1e-8
ROSEN_BOX = (np.array([-2.0, -2.0]), np.array([2.0, 3.0]))
ROSEN_X0 = np.array([-1.2, 1.0])


def t(a):
    return torch.tensor(np.asarray(a, dtype=float))


def quad_j(x):
    return jnp.sum((x + 5.0) ** 2)


def quad_t(x):
    return torch.sum((x + 5.0) ** 2)


def rosen(x):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


def rosen_b_j(X):
    return (1 - X[:, 0]) ** 2 + 100 * (X[:, 1] - X[:, 0] ** 2) ** 2


def rosen_b_t(X):
    return (1 - X[:, 0]) ** 2 + 100 * (X[:, 1] - X[:, 0] ** 2) ** 2


@pytest.mark.parametrize('lo,hi', [(-2.0, 3.0), (0.5, np.inf),
                                   (-np.inf, 4.0), (-np.inf, np.inf)])
def test_bounded_maps(lo, hi):
    """z = _to_unbounded(θ) and back agree with JAX's maps to 1e-12 and
    round-trip to 1e-10; the gradient of _to_bounded is finite with
    infinite bounds (no 0·inf in the discarded branches)."""
    theta = np.array([0.7, 1.9, 2.9]) if np.isfinite(hi) else \
        np.array([0.7, 3.0, 40.0])
    if not np.isfinite(lo) and np.isfinite(hi):
        theta = np.array([-30.0, 0.0, 3.9])
    lo_a, hi_a = np.full(3, lo), np.full(3, hi)
    z_j = np.asarray(jopt._to_unbounded(jnp.asarray(theta),
                                        jnp.asarray(lo_a), jnp.asarray(hi_a)))
    z_t = topt._to_unbounded(t(theta), t(lo_a), t(hi_a))
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-12, atol=1e-12)
    x_j = np.asarray(jopt._to_bounded(jnp.asarray(z_j), jnp.asarray(lo_a),
                                      jnp.asarray(hi_a)))
    z = z_t.clone().requires_grad_(True)
    x_t = topt._to_bounded(z, t(lo_a), t(hi_a))
    np.testing.assert_allclose(x_t.detach().numpy(), x_j, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(x_t.detach().numpy(), theta, rtol=1e-10,
                               atol=1e-10)
    (g,) = torch.autograd.grad(x_t.sum(), z)
    assert torch.isfinite(g).all()


@pytest.fixture(scope='module')
def jax_fixed():
    """JAX's fixed-trip results on the five cases (scalar engine) and on
    the cases as three-start batches (batched engine), and on the boxed
    Rosenbrock; built once."""
    out = {}
    for i, (lo, hi, x0, _) in enumerate(CASES):
        args = (jnp.array([lo]), jnp.array([hi]))
        out['scalar', i] = jopt.fixed_lbfgs_bounded(
            quad_j, jnp.array([x0]), *args, maxiter=MAXITER,
            ls_steps=LS_STEPS)
        X0 = jnp.array([[x0], [x0 - 0.5], [x0 - 1.5]])
        out['batched', i] = jopt.fixed_lbfgs_bounded_batched(
            lambda X: jnp.sum((X + 5.0) ** 2, -1), X0, *args,
            maxiter=MAXITER, ls_steps=LS_STEPS)
    lo, hi = (jnp.asarray(b) for b in ROSEN_BOX)
    out['rosen'] = jopt.fixed_lbfgs_bounded(rosen, jnp.asarray(ROSEN_X0), lo,
                                            hi, maxiter=MAXITER,
                                            ls_steps=LS_STEPS)
    out['rosen batched'] = jopt.fixed_lbfgs_bounded_batched(
        rosen_b_j, jnp.asarray([ROSEN_X0, [0.5, -0.5]]), lo, hi,
        maxiter=MAXITER, ls_steps=LS_STEPS)
    return {k: tuple(np.asarray(a) for a in v) for k, v in out.items()}


@pytest.mark.parametrize('i', range(len(CASES)))
def test_fixed_lbfgs_bounded_iterates(jax_fixed, i):
    lo, hi, x0, _ = CASES[i]
    x, f = topt.fixed_lbfgs_bounded(quad_t, t([x0]), t([lo]), t([hi]),
                                    maxiter=MAXITER, ls_steps=LS_STEPS)
    x_j, f_j = jax_fixed['scalar', i]
    assert x.dtype == f.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), x_j, rtol=ITER_TOL, atol=ITER_TOL)
    np.testing.assert_allclose(f.item(), f_j, rtol=ITER_TOL, atol=ITER_TOL)


@pytest.mark.parametrize('i', range(len(CASES)))
def test_fixed_lbfgs_bounded_batched_iterates(jax_fixed, i):
    lo, hi, x0, _ = CASES[i]
    X0 = t([[x0], [x0 - 0.5], [x0 - 1.5]])
    X, F = topt.fixed_lbfgs_bounded_batched(
        lambda X: torch.sum((X + 5.0) ** 2, -1), X0, t([lo]), t([hi]),
        maxiter=MAXITER, ls_steps=LS_STEPS)
    X_j, F_j = jax_fixed['batched', i]
    np.testing.assert_allclose(X.numpy(), X_j, rtol=ITER_TOL, atol=ITER_TOL)
    np.testing.assert_allclose(F.numpy(), F_j, rtol=ITER_TOL, atol=ITER_TOL)


def test_fixed_lbfgs_rosenbrock(jax_fixed):
    """A boxed Rosenbrock (curved valley, backtracking active): both
    engines' iterates after 5 steps equal JAX's."""
    lo, hi = (t(b) for b in ROSEN_BOX)
    x, f = topt.fixed_lbfgs_bounded(rosen, t(ROSEN_X0), lo, hi,
                                    maxiter=MAXITER, ls_steps=LS_STEPS)
    x_j, f_j = jax_fixed['rosen']
    np.testing.assert_allclose(x.numpy(), x_j, rtol=ITER_TOL, atol=ITER_TOL)
    np.testing.assert_allclose(f.item(), f_j, rtol=ITER_TOL, atol=ITER_TOL)
    X, F = topt.fixed_lbfgs_bounded_batched(
        rosen_b_t, t([ROSEN_X0, [0.5, -0.5]]), lo, hi, maxiter=MAXITER,
        ls_steps=LS_STEPS)
    X_j, F_j = jax_fixed['rosen batched']
    np.testing.assert_allclose(X.numpy(), X_j, rtol=ITER_TOL, atol=ITER_TOL)
    np.testing.assert_allclose(F.numpy(), F_j, rtol=ITER_TOL, atol=ITER_TOL)


def test_fixed_engines_agree_and_no_grad_line_search():
    """The single-problem engine is the batched one at B=1; the line search
    keeps no graph (the objective sees grad mode off on the trial batch,
    which is ls_steps wide)."""
    seen = []

    def fun_b(X):
        seen.append((X.shape[0], torch.is_grad_enabled()))
        return torch.sum((X - 0.3) ** 2, -1)

    X, F = topt.fixed_lbfgs_bounded_batched(fun_b, t([[1.0, -1.0]]),
                                            t([-2.0]), t([2.0]), maxiter=3,
                                            ls_steps=LS_STEPS)
    x, f = topt.fixed_lbfgs_bounded(lambda x: torch.sum((x - 0.3) ** 2),
                                    t([1.0, -1.0]), t([-2.0]), t([2.0]),
                                    maxiter=3, ls_steps=LS_STEPS)
    np.testing.assert_array_equal(X[0].numpy(), x.numpy())
    assert (LS_STEPS, False) in seen and (1, True) in seen
    assert all(grad for n, grad in seen if n == 1)


@pytest.mark.parametrize('i', range(len(CASES)))
def test_jit_lbfgs_bounded_optimum(i):
    """The minimiser equals the known optimum and JAX's optax engine's, to
    1e-5."""
    lo, hi, x0, want = CASES[i]
    x, f = topt.jit_lbfgs_bounded(quad_t, t([x0]), t([lo]), t([hi]),
                                  maxiter=100)
    np.testing.assert_allclose(x.numpy(), [want], atol=1e-5)
    assert f.dtype == torch.float64


def test_jit_lbfgs_bounded_matches_jax_rosenbrock():
    lo, hi = ROSEN_BOX
    x_j, _ = jopt.jit_lbfgs_bounded(rosen, jnp.asarray(ROSEN_X0),
                                    jnp.asarray(lo), jnp.asarray(hi),
                                    maxiter=200)
    x, f = topt.jit_lbfgs_bounded(rosen, t(ROSEN_X0), t(lo), t(hi),
                                  maxiter=200)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), atol=1e-5)
    np.testing.assert_allclose(x.numpy(), [1.0, 1.0], atol=1e-5)
    assert f.item() < 1e-10


def test_numpy_inputs_go_to_the_card():
    """A numpy x0 goes to the default device (the card), which is refused
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip('a card is visible: numpy would go to it')
    with pytest.raises(RuntimeError, match='cuda'):
        topt.fixed_lbfgs_bounded(quad_t, np.array([1.0]), t([-10.0]),
                                 t([10.0]), maxiter=1)

