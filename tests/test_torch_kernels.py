"""The port's kernels (``gsum_tpu_torch.kernels``) against ``gsum_tpu.kernels``
on the same seeded inputs, in f64 on the CPU: values K(X) and K(X, Y) at
rtol 1e-12, ``eval_gradient`` at 1e-10, general-ν Matern also against
``scipy.special.kv``, the θ / bounds / clone / ``fixed`` protocol, and
``convert.to_torch_kernel``.
"""
import math

import numpy as np
import pytest
import torch

import gsum_tpu.kernels as gk
import gsum_tpu_torch.kernels as tk
from gsum_tpu_torch.convert import to_torch_kernel
from _port import one_intra_op_thread  # noqa: F401 (autouse)

X = np.random.RandomState(0).rand(9, 2)
Y = np.random.RandomState(1).rand(5, 2)


def jax_kernels():
    return [
        gk.RBF(0.4),
        gk.RBF([0.4, 0.7]),
        gk.ConstantKernel(2.0) * gk.RBF(0.5) + gk.WhiteKernel(0.1),
        gk.ConstantKernel(1.0, 'fixed') * gk.RBF(0.6, 'fixed'),
        gk.Matern(0.7, nu=0.5),
        gk.Matern(0.7, nu=1.5),
        gk.Matern([0.7, 0.4], nu=2.5),
        gk.Matern(0.7, nu=np.inf),
        gk.Matern(0.7, nu=0.7),
        gk.Matern(0.7, nu=3.2),
        gk.RationalQuadratic(0.9, 1.4),
        gk.ExpSineSquared(0.9, 1.4),
        gk.DotProduct(0.5),
        gk.RBF(0.5) ** 2,
        gk.WhiteKernel(0.3) + gk.DotProduct(0.2) * gk.RBF(0.8),
    ]


IDS = [repr(k) for k in jax_kernels()]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize('i', range(len(IDS)), ids=IDS)
def test_values_match_jax(i):
    jk = jax_kernels()[i]
    k = to_torch_kernel(jk)
    np.testing.assert_allclose(k(_t(X)).numpy(), np.asarray(jk(X)),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(k(_t(X), _t(Y)).numpy(),
                               np.asarray(jk(X, Y)), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(k.diag(_t(X)).numpy(), np.asarray(jk.diag(X)),
                               rtol=1e-12, atol=1e-15)
    theta = jk.theta + 0.1
    np.testing.assert_allclose(
        k.value_fn(_t(theta), _t(X), None).numpy(),
        np.asarray(jk.value_fn(theta, X, None)), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize('i', range(len(IDS)), ids=IDS)
def test_eval_gradient_matches_jax(i):
    """dK/dθ through ``torch.func.jacfwd`` against ``jax.jacfwd``."""
    jk = jax_kernels()[i]
    k = to_torch_kernel(jk)
    K, dK = k(_t(X), eval_gradient=True)
    K_j, dK_j = (np.asarray(a) for a in jk(X, eval_gradient=True))
    assert dK.shape == dK_j.shape == (9, 9, jk.n_dims)
    np.testing.assert_allclose(K.numpy(), K_j, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(dK.numpy(), dK_j, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize('nu', [0.5, 1.5, 2.5, np.inf, 0.7, 3.2])
def test_matern_against_scipy_kv(nu):
    """Every ν against the closed formula 2^{1-ν}/Γ(ν)·u^ν·K_ν(u),
    u = √(2ν)·d/ℓ, with scipy's K_ν (the RBF limit for ν = ∞); the diagonal
    is exactly 1."""
    from scipy.special import gamma, kv

    ls = 0.6
    d = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)) / ls
    if np.isinf(nu):
        want = np.exp(-0.5 * d * d)
    else:
        u = np.sqrt(2 * nu) * np.where(d == 0, 1.0, d)
        want = np.where(d == 0, 1.0,
                        2 ** (1 - nu) / gamma(nu) * u ** nu * kv(nu, u))
    got = tk.Matern(ls, nu=nu)(_t(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-15)
    assert np.all(np.diag(got) == 1.0)


def test_kv_real_order_against_scipy():
    from scipy.special import kv

    from gsum_tpu_torch.kernels import _kv_real_order

    x = np.concatenate([np.geomspace(1e-6, 1.999, 25),
                        np.linspace(2.0, 30.0, 25)])
    for nu in [0.05, 0.49, 0.75, 1.3, 3.7, 20.0]:
        np.testing.assert_allclose(_kv_real_order(nu, _t(x)).numpy(),
                                   kv(nu, x), rtol=5e-12)


def test_theta_bounds_clone_and_fixed_protocol():
    jk = gk.ConstantKernel(2.0, (1e-2, 1e2)) * gk.RBF([0.5, 0.9]) \
        + gk.WhiteKernel(0.1, 'fixed')
    k = tk.ConstantKernel(2.0, (1e-2, 1e2)) * tk.RBF([0.5, 0.9]) \
        + tk.WhiteKernel(0.1, 'fixed')
    assert k.n_dims == jk.n_dims == 3
    np.testing.assert_array_equal(k.theta, jk.theta)
    np.testing.assert_array_equal(k.bounds, jk.bounds)
    assert [hp.name for hp in k.hyperparameters] == \
        [hp.name for hp in jk.hyperparameters]
    assert [hp.fixed for hp in k.hyperparameters] == [False, False, True]
    assert k.structure_key() == jk.structure_key()

    k2 = k.clone_with_theta(k.theta + 0.25)
    np.testing.assert_allclose(k2.theta, jk.theta + 0.25, rtol=1e-15)
    np.testing.assert_array_equal(k.theta, jk.theta)   # original untouched
    np.testing.assert_allclose(
        k2(_t(X)).numpy(),
        np.asarray(jk.clone_with_theta(jk.theta + 0.25)(X)), rtol=1e-12)

    k.theta = k.theta - 0.5
    np.testing.assert_allclose(k.k1.k2.length_scale,
                               np.array([0.5, 0.9]) * math.exp(-0.5))
    k.set_params(k2__noise_level=0.2)
    assert k.k2.noise_level == 0.2 and k.n_dims == 3
    with pytest.raises(ValueError, match='Invalid parameter'):
        k.set_params(nope=1)
    with pytest.raises(ValueError, match='correct number'):
        k.theta = np.zeros(2)

    assert tk.RBF(1.0) == tk.RBF(1.0)
    assert tk.RBF(1.0) != tk.RBF(1.0, 'fixed')
    assert tk.RBF(1.0) * tk.WhiteKernel(1.0) == \
        tk.WhiteKernel(1.0) * tk.RBF(1.0)
    assert repr(k) == repr(jk.clone_with_theta(k.theta).set_params(
        k2__noise_level=0.2))


def test_scalar_operators_and_white_cross():
    k = 2.0 * tk.RBF(1.0) + 0.5
    jk = 2.0 * gk.RBF(1.0) + 0.5
    np.testing.assert_allclose(k(_t(X)).numpy(), np.asarray(jk(X)),
                               rtol=1e-12)
    w = tk.WhiteKernel(0.7)
    assert torch.equal(w(_t(X), _t(X)), torch.zeros(9, 9, dtype=torch.float64))
    assert torch.equal(w(_t(X)), 0.7 * torch.eye(9, dtype=torch.float64))


def test_f32_input_promotes_to_f64():
    """JAX's x64 promotion: f32 X with the f64 θ gives f64, as does a fixed
    hyperparameter; a kernel with no hyperparameter-dependent arithmetic
    (RBF's diagonal) keeps X's dtype, as in JAX."""
    X32 = _t(X.astype(np.float32))
    for k in (tk.RBF(0.5), tk.RBF(0.5, 'fixed') + tk.WhiteKernel(0.1),
              tk.Matern(0.5, nu=0.7)):
        assert k(X32).dtype == torch.float64
        assert k(X32, X32[:3]).dtype == torch.float64
    assert tk.RBF(0.5).diag(X32).dtype == torch.float32
    th32 = torch.zeros(1, dtype=torch.float32)
    assert tk.RBF(0.5).value_fn(th32, X32).dtype == torch.float32


def test_numpy_input_goes_to_the_card():
    """A numpy X goes to the CUDA device, which is refused where no card is
    visible; a tensor keeps its device."""
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    with pytest.raises(RuntimeError, match='is_available'):
        tk.RBF(0.5)(X)
    assert tk.RBF(0.5)(_t(X)).device.type == 'cpu'


def test_to_torch_kernel_round_trip():
    for jk in jax_kernels():
        k = to_torch_kernel(jk)
        assert type(k).__name__ == type(jk).__name__
        assert isinstance(k, tk.Kernel)
        np.testing.assert_array_equal(k.theta, jk.theta)
        np.testing.assert_array_equal(k.bounds, jk.bounds)
        assert k.structure_key() == jk.structure_key()
        assert repr(k) == repr(jk)
    with pytest.raises(TypeError, match='no kernel'):
        to_torch_kernel(object())
