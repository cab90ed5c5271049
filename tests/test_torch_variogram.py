"""The port's ``VariogramFourthRoot`` (``gsum_tpu_torch.helpers``), its
hypergeometric function ``_accmath.hyp2f1_variogram`` and
``Diagnostic.variogram`` against ``gsum_tpu`` on the same seeded inputs, f64
on the CPU.

Tolerances: ``hyp2f1_variogram`` 1e-15 relative against the JAX package (the
same tables, evaluated alike) and 2e-15 against scipy's ``hyp2f1``; the
variogram's binning exactly, its bands and covariances at relative 1e-12
in both branches of ``compute`` (the batched pass and the per-bin loop).
"""
import numpy as np
import pytest
import scipy.special as sp
import torch

import gsum_tpu as gm
from gsum_tpu import _accmath as jacc
from gsum_tpu import helpers as jh
from gsum_tpu_torch import _accmath as tacc
from gsum_tpu_torch import helpers as th
from gsum_tpu_torch.diagnostics import Diagnostic

CPU = 'cpu'
rng = np.random.RandomState(5)
N = 24
X = np.sort(rng.rand(N))[:, None]
Z = np.sin(4 * X[:, 0])[None] + 0.2 * rng.randn(3, N)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_variogram_wrapper_and_hyp2f1():
    x = np.concatenate([np.linspace(0, 1 - 1e-12, 2001), [0.5, 0.5 + 1e-16]])
    got = tacc.hyp2f1_variogram(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jacc.hyp2f1_variogram(x)),
                               rtol=1e-15, atol=0)
    np.testing.assert_allclose(got, sp.hyp2f1(0.75, 0.75, 0.5, x),
                               rtol=2e-15, atol=0)
    z = Z
    bounds = np.linspace(0.1, 0.7, 4)
    want = gm.Diagnostic.variogram(X, z, bounds)
    got = Diagnostic.variogram(X, z, bounds, device=CPU)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-12)


@pytest.mark.parametrize('branch', ['batched', 'per-bin'])
def test_variogram_fourth_root(branch):
    """Both branches of ``compute``: at 24 points and 5 bins the padded grid
    is small (the batched pass); with 120 bounds of which all but two bins
    stay empty, Nb·M²·C passes 3e7 and ``compute`` goes bin by bin."""
    if branch == 'batched':
        Xv, z, bounds = X, Z, np.linspace(0.1, 0.7, 4)
    else:
        Xv = np.sort(rng.rand(40))[:, None]
        z = np.sin(5 * Xv[:, 0])[None] + 0.1 * rng.randn(3, 40)
        bounds = np.concatenate([[0.5], np.linspace(2, 3, 119)])
    jv = jh.VariogramFourthRoot(Xv, z, bounds)
    tv = th.VariogramFourthRoot(Xv, z, bounds, device=CPU)
    idx, _ = tv._bin_pair_indices()
    big = tv.Nb * idx.shape[1] ** 2 * tv.Ncurves > 3e7
    assert big == (branch == 'per-bin')
    for name in ('bin_counts', 'bin_idx', 'pair_i', 'pair_j'):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name))
    for name in ('bin_locations', 'gamma_star_hat', 'gamma_tilde'):
        np.testing.assert_allclose(getattr(tv, name), getattr(jv, name),
                                   rtol=1e-12)
    _close(tv.gamma_tilde_grid, jv.gamma_tilde_grid, 1e-12)
    for rt in (False, True):
        for g, w in zip(tv.compute(rt_scale=rt), jv.compute(rt_scale=rt)):
            np.testing.assert_allclose(g, w, rtol=1e-12)
    i, j, k, l = np.array([3, 5]), np.array([1, 2]), np.array([4, 7]), \
        np.array([0, 2])
    _close(tv.cov_ijkl(i, j, k, l), jv.cov_ijkl(i, j, k, l), 1e-12)
    _close(tv.corr_ijkl(i, j, k, l), jv.corr_ijkl(i, j, k, l), 1e-12)
    np.testing.assert_allclose(tv.cov(0, 1), jv.cov(0, 1), rtol=1e-12)
