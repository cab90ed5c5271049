"""``gsum_tpu_torch.sample`` against ``gsum_tpu.sample`` on the CPU, piece
by piece (JAX's HMC program and batched fits are not run here), and a short
HMC run of the port against quadrature of its own lml.

Data: the conjugate GP of ``tests/test_sample.py`` (12 points, 3 curves,
RBF with ℓ in (0.05, 2)), f64.  Tolerances:

- ``_log_jac_bounded``, ``split_rhat``, ``effective_sample_size``: 1e-13
  relative (the same formulas, a few roundings apart);
- a leapfrog trajectory (8 steps, 2 chains) against one built from
  ``jax.value_and_grad`` of JAX's lml: the port reuses each step's final
  gradient where JAX recomputes it at the same point, so the paths agree as
  the lml gradients do, to ``10·cond(R)·EPS`` relative with the largest
  cond(R) met on the trajectories (about 1e9 at ℓ near 2: 2.5e-6);
- one proposal and one dual-averaging update, fed the draws JAX's
  program takes from its key, on a Gaussian log density: 1e-13;
- ``posterior_predictive`` / ``truncation_posterior_predictive`` at the
  same θ draws: each draw solves with its R, so ``10·cond(R)·EPS`` with
  the largest cond(R) of the draws;
- the HMC posterior mean of log ℓ within 4 Monte-Carlo standard errors
  (posterior sd / √ESS) of the quadrature's, split-R̂ < 1.05.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsum_tpu as gm
import gsum_tpu_torch as gt
from gsum_tpu import optimize as jopt
from gsum_tpu import sample as js
from gsum_tpu_torch import optimize as topt
from gsum_tpu_torch import sample as ts
from gsum_tpu_torch.convert import to_torch_model

X = np.linspace(0, 1, 12)[:, None]
Y = np.column_stack([np.sin(3 * X[:, 0]), np.cos(2 * X[:, 0]) - 1,
                     np.sin(5 * X[:, 0])])
BOUNDS = np.array([[np.log(0.05), np.log(2.0)]])


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _limit(ells):
    """10·cond(R)·EPS for the largest condition number of the data's
    correlation matrices (nugget 1e-8) at the length scales ``ells``."""
    conds = [np.linalg.cond(np.exp(-0.5 * (X - X.T) ** 2 / ell ** 2)
                            + 1e-8 * np.eye(len(X))) for ell in ells]
    return 10 * max(conds) * np.finfo(float).eps


def _gp(mod, **kw):
    return mod.ConjugateGaussianProcess(
        kernel=mod.RBF(0.3, (0.05, 2.0)), center=0, disp=0, df=3, scale=1,
        nugget=1e-8, optimizer=None, **kw)


def test_diagnostics_and_jacobian_match_jax():
    rng = np.random.RandomState(0)
    chains = np.cumsum(rng.randn(3, 200, 2), axis=1) * 0.1 \
        + rng.randn(3, 200, 2)
    _close(ts.split_rhat(_t(chains)), js.split_rhat(chains), 1e-13)
    _close(ts.effective_sample_size(_t(chains)),
           js.effective_sample_size(chains), 1e-13)
    z = rng.randn(5) * 4
    lo = np.array([-1.0, -np.inf, 0.5, -np.inf, 2.0])
    hi = np.array([3.0, 1.0, np.inf, np.inf, 2.5])
    _close(ts._log_jac_bounded(_t(z), _t(lo), _t(hi)),
           js._log_jac_bounded(jnp.asarray(z), jnp.asarray(lo),
                               jnp.asarray(hi)), 1e-13)


def _logdensity_pair():
    """The bounded-box log density of the sampler over θ = log ℓ, built
    from JAX's lml and from the port's."""
    jm = _gp(gm).fit(X, Y)
    tm = to_torch_model(jm, 'cpu').fit(_t(X), _t(Y))
    lo, hi = BOUNDS[:, 0], BOUNDS[:, 1]
    value, _ = jm._lml_closure(jm.kernel_)
    y2, basis = jnp.asarray(Y), jm.basis(jnp.asarray(X))

    def ld_jax(z):
        th = jopt._to_bounded(z, lo, hi)
        return value(th, jnp.asarray(X), y2, basis) \
            + jnp.sum(js._log_jac_bounded(z, lo, hi))

    lo_t, hi_t = _t(lo), _t(hi)
    kernel = tm.kernel_.clone()

    def ld_torch(z):
        th = topt._to_bounded(z, lo_t, hi_t)
        return tm._lml(kernel, th, tm.X_train_, tm.y_train_,
                       tm.basis_train_) \
            + torch.sum(ts._log_jac_bounded(z, lo_t, hi_t))

    return ld_jax, ld_torch


def test_leapfrog_trajectory_matches_jax():
    """8 steps from two starts: JAX's recomputed gradients against the
    port's reused ones (the JAX algorithm, run step by step on the host
    with a jitted ``value_and_grad``)."""
    ld_jax, ld_torch = _logdensity_pair()
    vg = jax.jit(jax.value_and_grad(ld_jax))
    z0 = np.array([[np.log(0.3)], [np.log(0.6)]])
    p0 = np.array([[0.7], [-1.1]])
    eps = np.array([0.05, 0.08])
    want = []
    for z, p, e in zip(z0, p0, eps):
        z, p = jnp.asarray(z), jnp.asarray(p)
        for _ in range(8):
            _, g = vg(z)
            p_half = p + 0.5 * e * g
            z = z + e * p_half
            lp, g_new = vg(z)
            p = p_half + 0.5 * e * g_new
        want.append((z, p, g_new, lp))
    grad_val = torch.func.vmap(torch.func.grad_and_value(ld_torch))
    g0, _ = grad_val(_t(z0))
    z, p, g, lp = ts._leapfrog(grad_val, _t(z0), _t(p0), _t(eps), g0, 8)
    ells = torch.exp(topt._to_bounded(z, _t(BOUNDS[:, 0]), _t(BOUNDS[:, 1])))
    lim = _limit(list(ells.numpy().ravel()) + [0.3, 0.6])
    for got, k in ((z, 0), (p, 1), (g, 2), (lp, 3)):
        _close(got, np.stack([np.asarray(w[k]) for w in want]), lim)


def test_proposal_and_dual_averaging_match_jax():
    """One sampling step and one warmup step of JAX's programs on a
    Gaussian density, and the port's ``_proposal`` / ``_dual_average`` fed
    the draws JAX takes from its key (key → (key, momentum, accept,
    jitter) keys)."""
    P = np.array([[2.0, 0.6], [0.6, 1.0]])

    def ld_j(z):
        return -0.5 * z @ (jnp.asarray(P) @ z)

    def ld_t(z):
        return -0.5 * z @ (_t(P) @ z)

    L, eps0, target = 4, 0.3, 0.8
    warm, samp = js._make_hmc_programs(ld_j, 2, L, eps0, target)
    z0, key = jnp.array([0.4, -0.9]), jax.random.PRNGKey(7)
    lp0 = ld_j(z0)
    _, kp, ku, kj = jax.random.split(key, 4)
    jitter = float(jax.random.uniform(kj, dtype=z0.dtype))
    p = np.asarray(jax.random.normal(kp, (2,), dtype=z0.dtype))
    u = float(jax.random.uniform(ku, dtype=z0.dtype))

    grad_val = torch.func.vmap(torch.func.grad_and_value(ld_t))
    zt = _t(np.asarray(z0))[None]
    g, lpt = grad_val(zt)
    z_new, lp_new, _, accept_p = ts._proposal(
        grad_val, zt, lpt, g, _t([eps0]), _t([jitter]), _t(p[None]),
        _t([u]), L)
    (zj, lpj, _, _), zs, aps = jax.jit(lambda c: samp(c, 1))(
        (z0, lp0, jnp.asarray(eps0), key))
    _close(z_new[0], zj, 1e-13)
    _close(lp_new[0], lpj, 1e-13)
    _close(accept_p[0], aps[0], 1e-13)

    log_eps0 = np.log(eps0)
    carry = (z0, lp0, key, jnp.asarray(log_eps0), jnp.asarray(log_eps0),
             jnp.asarray(0.0))
    _, _, _, le, le_bar, h = jax.jit(lambda c: warm(c, 0.0, 1))(carry)
    got = ts._dual_average(_t([log_eps0]), _t([0.0]), accept_p, 1.0,
                           np.log(10 * eps0), target)
    for g_, w in zip(got, (le, le_bar, h)):
        _close(g_[0], w, 1e-13)


def test_posterior_predictives_match_jax():
    jm = _gp(gm).fit(X, Y)
    tm = to_torch_model(jm, 'cpu').fit(_t(X), _t(Y))
    Xn = np.linspace(-0.1, 1.1, 7)[:, None]
    thetas = np.log([[0.2], [0.3], [0.45]])
    want = js.posterior_predictive(jm, Xn, thetas, return_draws=True)
    got = ts.posterior_predictive(tm, _t(Xn), _t(thetas), return_draws=True)
    for g, w in zip(got, want):
        _close(g, w, _limit(np.exp(thetas[:, 0])))

    orders = np.arange(4)
    yn = np.asarray(gm.partials(np.column_stack(
        [np.sin(3 * X[:, 0]), np.cos(5 * X[:, 0]), np.sin(7 * X[:, 0] + 1),
         np.cos(2 * X[:, 0] + 2)]), ratio=0.5))
    jt = gm.TruncationGP(kernel=gm.RBF(0.4, (0.1, 2.0)), ratio=0.5, ref=1,
                         disp=0, df=3, scale=1, nugget=1e-8, optimizer=None)
    jt.fit(X, yn, orders=orders)
    tt = to_torch_model(jt, 'cpu').fit(_t(X), _t(yn), orders=orders)
    draws = np.array([[np.log(0.3), 0.45], [np.log(0.5), 0.55],
                      [np.log(0.4), 0.5]])
    want = js.truncation_posterior_predictive(jt, Xn, 2, draws, 'ratio',
                                              return_draws=True)
    got = ts.truncation_posterior_predictive(tt, _t(Xn), 2, _t(draws),
                                             'ratio', return_draws=True)
    for g, w in zip(got, want):
        _close(g, w, _limit(np.exp(draws[:, 0])))


def test_theta_posterior_matches_quadrature_of_the_lml():
    """A short run: 4 chains, 60 warmup and 200 sampling steps of 4
    leapfrog steps, against trapezoid quadrature of exp(lml) over the box
    (the port's own lml on 201 points)."""
    gp = _gp(gt, device='cpu').fit(_t(X), _t(Y))
    # one intra-op thread: the run is ~1000 gradient evaluations of 12 × 12
    # matrices, whose thread-pool hand-offs cost more than their arithmetic
    # (with the suite's six workers on the CPU, 20× more)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        thetas, info = ts.sample_theta_posterior(
            gp, n_chains=4, n_samples=200, n_warmup=60, n_leapfrog=4,
            random_state=1)
    finally:
        torch.set_num_threads(threads)
    assert thetas.shape == (4, 200, 1)
    th = thetas.numpy().reshape(-1)
    gg = np.linspace(BOUNDS[0, 0], BOUNDS[0, 1], 201)
    lml = np.array([float(gp.log_marginal_likelihood(np.array([g])))
                    for g in gg])
    w = np.exp(lml - lml.max())
    w /= np.trapezoid(w, gg)
    mean_q = np.trapezoid(w * gg, gg)
    sd_q = np.sqrt(np.trapezoid(w * (gg - mean_q) ** 2, gg))
    assert abs(th.mean() - mean_q) < 4 * sd_q / np.sqrt(info['ess'][0]), \
        (th.mean(), mean_q, sd_q, info['ess'])
    assert np.all(info['rhat'] < 1.05)
    assert BOUNDS[0, 0] <= th.min() and th.max() <= BOUNDS[0, 1]


def test_validation():
    gp = _gp(gt, device='cpu')
    with pytest.raises(ValueError, match='pass X/y'):
        ts.sample_theta_posterior(gp)
    csp = gt.ConjugateStudentProcess(
        kernel=gt.RBF(0.3, (0.05, 2.0)), center=0, disp=1, df=3, scale=1,
        nugget=1e-8, optimizer=None, device='cpu').fit(_t(X), _t(Y))
    with pytest.raises(TypeError, match='ConjugateGaussianProcess lml'):
        ts.sample_theta_posterior(
            csp, mesh=gt.parallel.Mesh(['cpu'] * 2, ('model',)))
    gp.fit(_t(X), _t(Y))
    with pytest.raises(ValueError, match='free dimensions'):
        ts.posterior_predictive(gp, _t(X), np.zeros((2, 3)))
