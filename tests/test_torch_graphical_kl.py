"""``GraphicalDiagnostic.kl_data`` of the port against ``gsum_tpu``'s on the
CPU, with JAX's reference draws put into the port's object: the
fixed-kernel engine (one shared factorization, the conjugate updates
vmapped), the per-draw loop, and the batched engine (one lockstep batched
fit).

Tolerances: the fixed-kernel KL goes through one Cholesky of a matrix of
condition number about 10³, so 1e-12 relative; the batched engine's
lockstep fit is held to JAX's 'grid' fit, whose θ agrees to 1e-8
(``tests/test_torch_parallel_fit.py``), and the KL moves by at most
|∂KL/∂θ|·1e-8, below 1e-6 relative here.
"""
import numpy as np
import pytest
import torch

import gsum_tpu as gm
import gsum_tpu_torch as gt
from gsum_tpu_torch.convert import to_torch_kernel

COLORS = ['C0', 'C1', 'C2']


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _kl_setup():
    """A Gaussian reference on 16 points with 2 curves and 12 draws, and
    the kernel the GP refits to each: its fixed WhiteKernel keeps the KL's
    cov_factor·R (which has no nugget) well conditioned, cond ≈ 10³, and
    the GP's nugget 1e-2 keeps predict's R − R(R + nugget)⁻¹R so."""
    n = 16
    Xs = np.linspace(0, 1, n)[:, None]
    k = gm.ConstantKernel(1.0, (1e-2, 1e2)) * gm.RBF(0.3, (1e-2, 10)) \
        + gm.WhiteKernel(1e-2, 'fixed')
    Kt = np.asarray(k(Xs))
    m = np.zeros(n)
    ys = np.linalg.cholesky(Kt) @ np.random.RandomState(2).randn(n, 2)
    jg = gm.GraphicalDiagnostic(ys, m, Kt, nref=12, colors=COLORS)
    tg = gt.GraphicalDiagnostic(torch.from_numpy(ys), torch.from_numpy(m),
                                torch.from_numpy(Kt), nref=12, colors=COLORS)
    tg.samples = torch.from_numpy(np.array(jg.samples))
    return Xs, k, jg, tg


@pytest.mark.parametrize('predict', [False, True])
def test_kl_data_fixed_kernel_matches_jax(predict):
    Xs, k, jg, tg = _kl_setup()
    kw = dict(nugget=1e-2, optimizer=None)
    jgp = gm.ConjugateGaussianProcess(k, **kw)
    tgp = gt.ConjugateGaussianProcess(to_torch_kernel(k), device='cpu', **kw)
    got = tg.kl_data(torch.from_numpy(Xs), tgp, predict=predict)
    want = jg.kl_data(Xs, jgp, predict=predict)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)
    # the per-draw loop gives the same numbers without predict (with it,
    # the class's predict conditions with kernel_(X, X), where the
    # WhiteKernel is 0, unlike the batched engine: so in JAX too)
    if not predict:
        loop = tg.kl_data(torch.from_numpy(Xs), tgp, engine='loop')
        for g, w in zip(loop, got):
            _close(g, w, 1e-12)


def test_kl_data_batched_fit_matches_jax_grid_fit():
    Xs, k, jg, tg = _kl_setup()
    fit = dict(engine='grid', maxiter=5, ls_steps=4)
    jgp = gm.ConjugateGaussianProcess(k, nugget=1e-2)
    tgp = gt.ConjugateGaussianProcess(to_torch_kernel(k), nugget=1e-2,
                                      device='cpu')
    got = tg.kl_data(torch.from_numpy(Xs), tgp, fit_kws=fit)
    want = jg.kl_data(Xs, jgp, fit_kws=fit)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    with pytest.raises(ValueError, match='engine="batched" needs'):
        tg.kl_data(Xs, gt.ConjugateStudentProcess(device='cpu'),
                   engine='batched')
