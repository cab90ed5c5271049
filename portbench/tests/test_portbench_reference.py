"""The plain reference held to the port on the CPU at small sizes (the
tests import both; the reference imports neither the port nor JAX)."""
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

import gsum_tpu_torch as port
from portbench.reference import (Prior, coefficients, lml_and_scale,
                                 log_change_of_variables, maximize_lml,
                                 sqdist, truncation_lml_surface,
                                 truncation_predict)
from portbench.reference.gp import _tf32
from portbench.spec import ROOT

PRIOR = Prior(center=0.0, df=3.0, scale=1.0)
ORDERS = [0, 2, 3, 4, 5]


def _data(n=40, d=1, m=5, ls=0.3, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand((n, d), generator=g, dtype=torch.float64)
    K = torch.exp(-0.5 * sqdist(X, X) / ls ** 2) + 1e-8 * torch.eye(n)
    Y = torch.linalg.cholesky(K) @ torch.randn((n, m), generator=g,
                                               dtype=torch.float64)
    return X, Y


def _cgp(ls, nugget):
    return port.ConjugateGaussianProcess(
        kernel=port.RBF(ls, 'fixed'), center=0, disp=0, df=3, scale=1,
        nugget=nugget, optimizer=None, device='cpu')


@pytest.mark.parametrize('d', [1, 2])
@pytest.mark.parametrize('ls', [0.1, 0.4])
def test_lml_and_scale_match_the_port(d, ls):
    X, Y = _data(d=d, seed=d)
    gp = _cgp(ls, 1e-6).fit(X, Y)
    lml, scale_sq = lml_and_scale(sqdist(X, X), Y[None], [ls], 1e-6, PRIOR)
    np.testing.assert_allclose(float(lml[0]),
                               float(gp.log_marginal_likelihood_value_),
                               rtol=1e-9)
    np.testing.assert_allclose(float(scale_sq[0]), float(gp.scale_) ** 2,
                               rtol=1e-9)


def test_lml_batches_fits_and_fails_to_minus_inf():
    X, Y = _data()
    Ys = torch.stack([Y, 2 * Y, Y.flip(0)])
    lml, _ = lml_and_scale(sqdist(X, X), Ys, [0.2, 0.3, 0.4], 1e-6, PRIOR)
    for b, ls in enumerate([0.2, 0.3, 0.4]):
        one, _ = lml_and_scale(sqdist(X, X), Ys[b:b + 1], [ls], 1e-6, PRIOR)
        assert float(one[0]) == pytest.approx(float(lml[b]), rel=1e-12)
    bad, scale = lml_and_scale(sqdist(X, X), Ys[:1], [50.0], -1.0, PRIOR)
    assert float(bad[0]) == -math.inf and math.isnan(float(scale[0]))


def test_maximize_finds_the_grid_maximum():
    X, Y = _data(ls=0.25)
    d2 = sqdist(X, X)
    theta, best = maximize_lml(d2, Y[None], (math.log(0.01), math.log(100)),
                               1e-6, PRIOR)
    dense = torch.linspace(math.log(0.05), math.log(2.0), 2001,
                           dtype=torch.float64)
    vals, _ = lml_and_scale(d2, Y[None].expand(len(dense), -1, -1),
                            torch.exp(dense), 1e-6, PRIOR)
    assert float(best[0]) >= float(vals.max()) - 1e-6
    assert abs(float(theta[0]) - float(dense[vals.argmax()])) < 2e-3


def test_coefficients_and_change_of_variables_match_the_port():
    X, C = _data(seed=3)
    q, ref = 0.45, 2.0
    powers = q ** torch.tensor(ORDERS, dtype=torch.float64)
    y = ref * torch.cumsum(C * powers, -1)
    np.testing.assert_allclose(
        coefficients(y, ORDERS, q, ref),
        port.coefficients(y, ratio=q, ref=ref, orders=np.array(ORDERS)),
        rtol=1e-12)
    np.testing.assert_allclose(coefficients(y, ORDERS, q, ref), C,
                               rtol=1e-9, atol=1e-12)
    tgp = port.TruncationGP(kernel=port.RBF(0.3, 'fixed'), ratio=q, ref=ref,
                            excluded=[1], center=0, disp=0, df=3, scale=1,
                            nugget=1e-4, optimizer=None, device='cpu')
    tgp.fit(X, y, orders=np.array(ORDERS))
    lml, _ = lml_and_scale(sqdist(X, X),
                           coefficients(y, ORDERS, q, ref)[None], [0.3],
                           1e-4, PRIOR)
    joint = float(lml[0]) - float(log_change_of_variables(ORDERS, len(X),
                                                          q, ref))
    port_joint = float(tgp.log_marginal_likelihood(
        np.log([0.3])))
    assert joint == pytest.approx(port_joint, rel=1e-9)


def test_surface_matches_the_port():
    X, C = _data(n=30, seed=4)
    y = 1.5 * torch.cumsum(
        C * 0.5 ** torch.tensor(ORDERS, dtype=torch.float64), -1)
    ls = torch.tensor([0.1, 0.2, 0.5], dtype=torch.float64)
    ratios = torch.tensor([0.3, 0.5, 0.7], dtype=torch.float64)
    ref = truncation_lml_surface(sqdist(X, X), y, ORDERS, ratios, 1.5, ls,
                                 1e-4, PRIOR)
    got = port.parallel.truncation_lml_grid(
        port.RBF(0.3), X, y, np.array(ORDERS), ratios, torch.log(ls)[:, None],
        ref=1.5, center=0, disp=0, df=3, scale=1, nugget=1e-4, excluded=[1])
    np.testing.assert_allclose(ref, got, rtol=1e-9)


@pytest.mark.parametrize('order', [3, 5])
def test_truncation_predict_matches_the_port(order):
    X, C = _data(n=30, seed=5)
    q, r = 0.4, 1.3
    y = r * torch.cumsum(C * q ** torch.tensor(ORDERS, dtype=torch.float64),
                         -1)
    Xs = torch.sort(X[:, 0]).values
    Xnew = (0.5 * (Xs[1:] + Xs[:-1]))[:, None]       # between the points
    tgp = port.TruncationGP(kernel=port.RBF(0.3, 'fixed'), ratio=q, ref=r,
                            excluded=[1], center=0, disp=0, df=3, scale=1,
                            nugget=1e-6, optimizer=None, device='cpu')
    tgp.fit(X, y, orders=np.array(ORDERS))
    mean, std = tgp.predict(Xnew, order=order, kind='both', return_std=True)
    cov_factor = float(tgp.coeffs_process.cov_factor_)
    col = ORDERS.index(order)
    ref_mean, ref_std = truncation_predict(X, Xnew, y[:, col], [0.3],
                                           cov_factor, q, r, order, [1])
    # the interpolant's Gram matrix has no nugget, so its round-off (about
    # 1e-7 here, both sides taking the same jitter rung) is held in units
    # of the predictive std, which Q^(order+1) makes small
    assert float(((ref_mean - mean).abs() / ref_std).max()) < 1e-3
    np.testing.assert_allclose(ref_std, std, rtol=1e-7)


def test_lower_precisions_compute_in_their_dtype():
    X, Y = _data()
    for p in ('f32', 'tf32'):
        lml, scale = lml_and_scale(sqdist(X, X, p), Y[None], [0.3], 1e-2,
                                   PRIOR, p)
        assert lml.dtype == scale.dtype == torch.float32
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, 3.14159],
                     dtype=torch.float32)
    r = _tf32(x)
    assert r[0] == 1.0 + 2 ** -10 and r[1] == 1.0
    assert abs(float(r[2]) - 3.14159) < 3.14159 * 2 ** -11


def test_the_reference_imports_nothing_of_the_program():
    code = ('import sys, portbench.reference, portbench.data; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"gsum_tpu_torch", "gsum_tpu", "jax", "jaxlib"}))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == '[]'
