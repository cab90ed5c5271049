"""``sample.sample_theta_posterior(mesh=)`` of the port on the CPU: the lml
of the sharded path (``parallel.pchol.sharded_cgp_lml`` over 8 CPU shards,
its gradient in forward mode, batched over the chains by ``torch.func``)
against the unsharded port's, and a few HMC steps of both from one seed.
JAX's sampler is not run here (its compile takes minutes); its refusals
are mirrored.

Data: 32 points (4 rows a shard), three curves, RBF ℓ in (0.05, 2), nugget
1e-6, no WhiteKernel (the sharded build evaluates the kernel's
two-argument form, where a WhiteKernel is 0, as in JAX).  The two lmls
and their gradients agree to 1e-10 relative (measured: 1.2e-12 at ℓ =
1.2, condition number 3e7), so the two samplers follow one trajectory:
draws at 1e-8.
"""
import numpy as np
import pytest
import torch

import gsum_tpu_torch as gt
from gsum_tpu_torch import sample as ts
from gsum_tpu_torch.parallel import Mesh
from _port import one_intra_op_thread  # noqa: F401 (autouse)

N = 32
X = np.linspace(0, 1, N)[:, None]
Y = np.column_stack([np.sin(3 * X[:, 0]), np.cos(2 * X[:, 0]) - 1,
                     np.sin(5 * X[:, 0])])


def _t(a):
    return torch.from_numpy(np.array(a))


def _gp():
    return gt.ConjugateGaussianProcess(
        kernel=gt.RBF(0.3, (0.05, 2.0)), center=0, disp=0, df=3, scale=1,
        nugget=1e-6, optimizer=None, device='cpu').fit(_t(X), _t(Y))


@pytest.fixture(scope='module')
def mesh():
    return Mesh(['cpu'] * 8, ('model',))


def test_sharded_logdensity_matches_the_model(mesh):
    from gsum_tpu_torch.parallel import sharded_cgp_lml

    gp = _gp()
    for ell in (0.1, 0.3, 1.2):
        th = _t([np.log(ell)]).requires_grad_(True)
        got = sharded_cgp_lml(gp.kernel_.value_fn, th, gp.X_train_,
                              gp.y_train_, gp.basis_train_,
                              np.atleast_1d(gp.center0),
                              np.atleast_2d(gp.disp0), gp.df0, gp.scale0,
                              mesh, nugget=gp.nugget)
        (g,) = torch.autograd.grad(got, th)
        want, g_want = gp.log_marginal_likelihood(th.detach(),
                                                  eval_gradient=True)
        np.testing.assert_allclose(got.item(), want.item(), rtol=1e-10)
        np.testing.assert_allclose(g.numpy(), g_want.numpy(), rtol=1e-10)


def test_hmc_on_the_mesh_follows_the_unsharded_run(mesh):
    gp = _gp()
    kw = dict(n_chains=2, n_warmup=3, n_samples=4, n_leapfrog=3,
              random_state=2)
    s_mesh, info_mesh = ts.sample_theta_posterior(gp, mesh=mesh, **kw)
    s_plain, info_plain = ts.sample_theta_posterior(gp, **kw)
    assert s_mesh.shape == (2, 4, 1)
    np.testing.assert_allclose(s_mesh.numpy(), s_plain.numpy(), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(info_mesh['step_size'],
                               info_plain['step_size'], rtol=1e-8)


def test_mesh_refuses_derivative_training_data(mesh):
    gp = gt.ConjugateGaussianProcess(
        kernel=gt.RBF(0.3, (0.05, 2.0)), center=0, disp=0, df=3, scale=1,
        nugget=1e-6, optimizer=None, device='cpu')
    dord = np.zeros((N, 1), int)
    dord[::4] = 1
    gp.fit(_t(X), _t(Y[:, 0]), dorders=dord)
    with pytest.raises(ValueError, match='derivative training data'):
        ts.sample_theta_posterior(gp, mesh=mesh)
