"""``gsum_tpu_torch.derivs`` against ``gsum_tpu.derivs`` on the same seeded
inputs, f64 on the CPU.

Tolerances: derivative cross-covariances, means and bases to 1e-12 relative
to the largest entry of each result.  Both sides differentiate the same
closed-form kernel expressions by automatic differentiation (nested
``torch.func.grad`` against nested ``jax.grad``), so they differ only by the
rounding of a few dozen operations per entry, ~1e-15; the limit leaves
three orders of headroom.  The closed-form RBF oracle of
``tests/test_derivs.py`` holds the port to 1e-12 relative as well.

JAX's derivative covariances are jitted once per case: eagerly, JAX
compiles each nested-gradient operation separately (about 10 s a call).
"""
import math

import jax
import numpy as np
import pytest
import torch

import gsum_tpu as gm
from gsum_tpu import derivs as jd
from gsum_tpu_torch import derivs as td
from gsum_tpu_torch.convert import to_torch_kernel

RTOL = 1e-12
rng = np.random.RandomState(11)
X1 = rng.rand(5, 1)
X2 = rng.rand(4, 1)
X2D = rng.rand(4, 2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# (kernel, highest per-observation order exercised): each kernel's limit
# from max_kernel_deriv_order, the analytic kernels at 2.  ExpSineSquared's
# order 3 has its own test below (JAX takes 30 s to compile a sixth
# derivative).  RBF and Matern 2.5 alone are covered by the Sum/Product
# case, the cross block (Matern 2.5), the two-feature case and the closed
# form (RBF).
KERNELS = {
    'Matern 1.5': (lambda: gm.Matern(0.6, nu=1.5), 1),
    'RationalQuadratic': (lambda: gm.RationalQuadratic(0.5, 1.3), 2),
    'ExpSineSquared': (lambda: gm.ExpSineSquared(0.8, 1.7), 2),
    'Sum/Product': (lambda: gm.ConstantKernel(2.0) * gm.RBF(0.4)
                    + gm.Matern(0.9, nu=2.5), 2),
}


def _orders(top):
    return np.arange(5)[:, None] % (top + 1)


@pytest.fixture(scope='module')
def jax_self_blocks():
    """JAX's self blocks of every kernel in KERNELS, in one jitted call
    (one compile is a third quicker than one per kernel)."""
    kernels = {name: make() for name, (make, _) in KERNELS.items()}

    def blocks(A):
        return {name: jd.kernel_deriv_cov(kernels[name], A,
                                          _orders(KERNELS[name][1]))
                for name in KERNELS}
    return kernels, jax.jit(blocks)(X1)


@pytest.mark.parametrize('name', list(KERNELS))
def test_kernel_deriv_cov_matches_jax(name, jax_self_blocks):
    """The self block of X1 with orders 0..limit mixed: every pair of
    orders at distinct points, and the coincident limits on the
    diagonal."""
    kernels, want = jax_self_blocks
    jk = kernels[name]
    tk = to_torch_kernel(jk)
    assert td.max_kernel_deriv_order(tk) == jd.max_kernel_deriv_order(jk)
    d = _orders(KERNELS[name][1])
    _close(td.kernel_deriv_cov(tk, _t(X1), d), want[name])


def test_expsine_order_three():
    """ExpSineSquared at its limit, order 3: against JAX where one side is
    order 3 (X1 × X2, orders 0/1 × 3), and the coincident (3, 3) limit
    against the Taylor series of k(τ) = exp(−2 sin²(πτ/p)/ℓ²), whose τ⁶
    coefficient c₆ gives ∂³ₓ∂³ₓ' k = −6! c₆ (numpy polynomial algebra)."""
    ls, p = 0.8, 1.7
    jk = gm.ExpSineSquared(ls, p)
    tk = to_torch_kernel(jk)
    d1, d2 = np.array([0, 1, 0, 1, 0]), np.array([3, 3, 3, 3])
    want = jax.jit(lambda A, B: jd.kernel_deriv_cov(jk, A, d1, B, d2))(
        X1, X2)
    _close(td.kernel_deriv_cov(tk, _t(X1), d1, _t(X2), d2), want)

    P = np.polynomial.polynomial
    w = np.pi / p
    sin2 = [0, 0, w ** 2, 0, -w ** 4 / 3, 0, 2 * w ** 6 / 45]   # to τ⁶
    u = P.polymul([-2 / ls ** 2], sin2)[:7]
    k = np.zeros(7)
    term = np.array([1.0])
    for n in range(4):                    # exp(u) = Σ uⁿ/n!, u = O(τ²)
        t = term[:7]
        k[:len(t)] += t / math.factorial(n)
        term = P.polymul(term, u)
    got = td.kernel_deriv_cov(tk, _t(X1[:1]), [3])
    _close(got[0, 0], -720.0 * k[6])


def test_cross_block_matches_jax():
    """X1 × X2 with different orders on each side."""
    jk = gm.Matern(0.6, nu=2.5)
    d1, d2 = np.array([0, 1, 2, 1, 0]), np.array([2, 0, 1, 1])
    want = jax.jit(lambda A, B: jd.kernel_deriv_cov(jk, A, d1, B, d2))(
        X1, X2)
    _close(td.kernel_deriv_cov(to_torch_kernel(jk), _t(X1), d1, _t(X2), d2),
           want)


def test_two_features_mixed_partials_match_jax():
    """Anisotropic RBF in two features: orders (0,0), (1,0), (0,1), (1,1)
    and (2,0) (total order up to 2) in one matrix."""
    jk = gm.RBF([0.5, 0.7])
    tk = to_torch_kernel(jk)
    d = np.array([[0, 0], [1, 0], [0, 1], [1, 1]])
    want = jax.jit(lambda A: jd.kernel_deriv_cov(jk, A, d))(X2D)
    _close(td.kernel_deriv_cov(tk, _t(X2D), d), want)


def _rbf_oracle(x, xp, ls, a, b):
    """cov[f^(a)(x), f^(b)(xp)] of the unit RBF, closed form (the formulas
    of tests/test_derivs.py)."""
    tau = x[:, None] - xp[None, :]
    k = np.exp(-0.5 * tau ** 2 / ls ** 2)
    forms = {
        (0, 0): k,
        (0, 1): tau / ls ** 2 * k,
        (1, 1): (1.0 / ls ** 2 - tau ** 2 / ls ** 4) * k,
        (2, 0): (tau ** 2 / ls ** 4 - 1.0 / ls ** 2) * k,
        (2, 2): (3.0 / ls ** 4 - 6.0 * tau ** 2 / ls ** 6
                 + tau ** 4 / ls ** 8) * k,
    }
    return forms[(a, b)]


@pytest.mark.parametrize('a, b', [(0, 0), (0, 1), (1, 1), (2, 0), (2, 2)])
def test_rbf_matches_the_closed_form(a, b):
    ls = 0.7
    got = td.kernel_deriv_cov(to_torch_kernel(gm.RBF(ls)), _t(X1), a,
                              _t(X2), b)
    _close(got, _rbf_oracle(X1[:, 0], X2[:, 0], ls, a, b))


def test_deriv_mean_and_basis_match_jax():
    """A scalar mean and a 3-wide basis with an x-dependent factor, at
    orders 0, 1, 2 mixed."""
    d = np.array([0, 1, 2, 1, 0])

    def mean_j(x):
        return jax.numpy.sin(3 * x[0]) * jax.numpy.exp(x[0])

    def basis_j(x):
        return jax.numpy.stack([1.0 + 0 * x[0], x[0] ** 2,
                                jax.numpy.cos(2 * x[0])])

    def mean_t(x):
        return torch.sin(3 * x[0]) * torch.exp(x[0])

    def basis_t(x):
        return torch.stack([1.0 + 0 * x[0], x[0] ** 2, torch.cos(2 * x[0])])

    want_m, want_b = jax.jit(lambda A: (jd.deriv_mean(mean_j, A, d),
                                        jd.deriv_basis(basis_j, A, d)))(X1)
    _close(td.deriv_mean(mean_t, _t(X1), d), want_m)
    _close(td.deriv_basis(basis_t, _t(X1), d), want_b)


def test_value_block_fn_and_integer_points():
    """The zero-order block goes through ``value_block_fn`` (the same
    numbers as the per-pair path), and integer points are promoted to
    float64, as in JAX."""
    tk = to_torch_kernel(gm.RBF(0.4))
    th = torch.as_tensor(tk.theta)

    def cov_fn(x, xp):
        return tk.value_fn(th, x[None, :], xp[None, :])[0, 0]

    d = np.array([0, 1, 0, 0, 2])[:, None]
    plain = td.deriv_cov(cov_fn, _t(X1), d)
    fast = td.deriv_cov(cov_fn, _t(X1), d,
                        value_block_fn=lambda A, B: tk.value_fn(th, A, B))
    _close(fast, plain.numpy(), rtol=1e-15)
    Xi = torch.tensor([[0], [1], [2]])
    got = td.kernel_deriv_cov(tk, Xi, [0, 1, 1], Xi, [1, 1, 0])
    assert got.dtype == torch.float64
    assert torch.equal(got, td.kernel_deriv_cov(
        tk, Xi.double(), [0, 1, 1], Xi.double(), [1, 1, 0]))


def test_orders_and_limits_match_jax():
    """normalize_orders, max_kernel_deriv_order over the zoo, and the
    rejections (non-integer, negative, ambiguous 1-D, beyond the
    kernel's limit), with JAX's messages."""
    for d, n, f in ((None, 3, 2), (2, 3, 1), ([0, 1, 2], 3, 1),
                    ([[1, 0], [0, 2]], 2, 2)):
        np.testing.assert_array_equal(td.normalize_orders(d, n, f),
                                      jd.normalize_orders(d, n, f))
    for bad, n, f in (([0.5], 1, 1), ([-1], 1, 1), ([0, 1], 2, 2),
                      ([[0, 1]], 2, 2)):
        with pytest.raises(ValueError) as want:
            jd.normalize_orders(bad, n, f)
        with pytest.raises(ValueError, match=str(want.value)[:20]):
            td.normalize_orders(bad, n, f)
    zoo = [gm.RBF(1.0), gm.Matern(1.0, nu=0.5), gm.Matern(1.0, nu=1.5),
           gm.Matern(1.0, nu=2.5), gm.Matern(1.0, nu=np.inf),
           gm.Matern(1.0, nu=3.5), gm.RationalQuadratic(), gm.DotProduct(),
           gm.ExpSineSquared(), gm.WhiteKernel(), gm.ConstantKernel(),
           gm.RBF(1.0) * gm.Matern(1.0, nu=1.5) + gm.WhiteKernel(),
           gm.ExpSineSquared() ** 2]
    for jk in zoo:
        assert td.max_kernel_deriv_order(to_torch_kernel(jk)) == \
            jd.max_kernel_deriv_order(jk), jk
    for jk, d in ((gm.Matern(1.0, nu=0.5), [1]),
                  (gm.Matern(1.0, nu=1.5), [2]),
                  (gm.ExpSineSquared(), [4]),
                  (gm.RBF(1.0) + gm.Matern(1.0, nu=2.5), [3])):
        tk = to_torch_kernel(jk)
        with pytest.raises(ValueError, match='only supports order'):
            td.kernel_deriv_cov(tk, _t(X1[:1]), d)
    with pytest.raises(ValueError, match='only supports order'):
        td.kernel_deriv_cov(to_torch_kernel(gm.Matern(1.0, nu=2.5)),
                            _t(X2D[:1]), [[1, 0]], _t(X2D[:1]), [[1, 2]])


def test_autograd_through_the_derivative_covariance():
    """Ordinary autograd in θ through ``wrap_value_fn_with_orders`` (nested
    ``torch.func.grad`` inside): against a central difference of the same
    function, to 1e-7 relative (step 1e-5: truncation error ~1e-10, round
    off ~1e-11 over the difference)."""
    tk = to_torch_kernel(gm.ConstantKernel(1.5) * gm.RBF(0.5))
    d = np.array([[0], [1], [0], [2], [1]])
    f = td.wrap_value_fn_with_orders(tk.value_fn, d)
    W = _t(rng.randn(5, 5))

    def loss(th):
        return torch.sum(W * f(th, _t(X1)))

    th = torch.tensor(tk.theta, requires_grad=True)
    (g,) = torch.autograd.grad(loss(th), th)
    h = 1e-5
    fd = [(loss(th.detach() + h * e) - loss(th.detach() - h * e)) / (2 * h)
          for e in torch.eye(2, dtype=torch.float64)]
    _close(g, torch.stack(fd).numpy(), rtol=1e-7)
