R"""Hyperparameter-posterior sampling (counterpart of ``gsum_tpu/sample.py``).

Hamiltonian Monte Carlo over a kernel's log-hyperparameters (and, for a
truncation process, its expansion parameter), with the models' conjugate
log-marginal likelihood as the target:

- chains run as one batch: the gradient of every chain is one call of
  ``torch.func.vmap(torch.func.grad_and_value(logdensity))``;
- the Python loop over steps only issues work: acceptance is a
  ``torch.where``, the step size adapts on the device, and nothing is read
  back to the host until the run ends;
- each leapfrog step reuses the gradient its previous step ended with, and
  each proposal the gradient of the state it starts from, so a trajectory
  of L steps takes L gradient evaluations; the JAX package recomputes the
  gradient at the start of every step (2L + 1 evaluations) and follows the
  same trajectory;
- box bounds are removed with the sigmoid / softplus map of the bounded
  L-BFGS (``optimize._to_bounded``) and its exact log-Jacobian is added to
  the density;
- the step size is tuned by dual averaging during warmup, with a uniform
  jitter on [0.5, 1.5]·ε per proposal.

Random draws come from one ``torch.Generator`` on the chains' device,
seeded with ``random_state``; they differ from the JAX package's at equal
seeds.  ``steps_per_call`` (which segments the JAX program for the TPU) is
accepted and changes nothing.  With ``mesh=``, ``sample_theta_posterior``
evaluates the lml model-parallel (``parallel.pchol.sharded_cgp_lml``, whose
forward-mode gradient ``torch.func`` batches over the chains as well).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ._config import as_input
from .helpers import _generator
from .optimize import _softplus, _to_bounded, _to_unbounded

__all__ = ['hmc', 'sample_theta_posterior', 'sample_truncation_posterior',
           'posterior_predictive', 'truncation_posterior_predictive',
           'split_rhat', 'effective_sample_size']

# dual averaging (Hoffman & Gelman 2014, Algorithm 5)
_DA_GAMMA, _DA_T0, _DA_KAPPA = 0.05, 10.0, 0.75


def _log_jac_bounded(z, lo, hi):
    """log |dθ/dz| of :func:`optimize._to_bounded`, elementwise.

    two-sided: θ = lo + span·sigmoid(z)  -> log span − sp(z) − sp(−z)
    one-sided: θ = lo + softplus(z)      -> log sigmoid(z) = −sp(−z)
    unbounded: identity                  -> 0
    """
    lo_f, hi_f = torch.isfinite(lo), torch.isfinite(hi)
    both = lo_f & hi_f
    span = torch.where(both, hi - lo, 1.0)
    lj_box = torch.log(span) - _softplus(z) - _softplus(-z)
    lj_one = -_softplus(-z)
    return torch.where(both, lj_box,
                       torch.where(lo_f | hi_f, lj_one, 0.0))


def _leapfrog(grad_val, z, p, eps, g, n_leapfrog):
    """``n_leapfrog`` leapfrog steps of every chain from (z, p) with step
    ``eps`` (a (C,) tensor), starting from the gradient ``g`` at z.
    Returns (z, p, g, lp) at the end of the trajectory."""
    e = eps[:, None]
    lp = None
    for _ in range(n_leapfrog):
        p_half = p + 0.5 * e * g
        z = z + e * p_half
        g, lp = grad_val(z)
        p = p_half + 0.5 * e * g
    return z, p, g, lp


def _proposal(grad_val, z, lp, g, eps, jitter, p, u, n_leapfrog):
    """One HMC proposal of every chain, given its draws: the step jitter
    ``jitter`` and accept uniform ``u`` (C,) on [0, 1), the momentum ``p``
    (C, d).  Failed factorizations (−inf lml) and NaNs reject.  Returns
    (z, lp, g, accept_p)."""
    eps = eps * (0.5 + jitter)
    z_new, p_new, g_new, lp_new = _leapfrog(grad_val, z, p, eps, g,
                                            n_leapfrog)
    log_alpha = (lp_new - lp - 0.5 * torch.sum(p_new ** 2, -1)
                 + 0.5 * torch.sum(p ** 2, -1))
    log_alpha = torch.where(torch.isfinite(log_alpha), log_alpha, -math.inf)
    accept_p = torch.clamp(torch.exp(log_alpha), max=1.0)
    accept = torch.log(u) < log_alpha
    z = torch.where(accept[:, None], z_new, z)
    g = torch.where(accept[:, None], g_new, g)
    lp = torch.where(accept, lp_new, lp)
    return z, lp, g, accept_p


def _dual_average(log_eps_bar, h_bar, accept_p, t, mu, target_accept):
    """One dual-averaging update at step ``t`` (1-based): the new
    (log ε, log ε̄, h̄) of every chain."""
    h_bar = (1 - 1 / (t + _DA_T0)) * h_bar \
        + (target_accept - accept_p) / (t + _DA_T0)
    log_eps = mu - math.sqrt(t) / _DA_GAMMA * h_bar
    w = t ** (-_DA_KAPPA)
    log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
    return log_eps, log_eps_bar, h_bar


def hmc(logdensity, z0, generator=0, n_samples=1000, n_warmup=500,
        n_leapfrog=16, init_step_size=0.1, target_accept=0.8):
    """HMC of ``logdensity`` with a fixed number of leapfrog steps per
    proposal; warmup adapts the step size by dual averaging toward
    ``target_accept``, sampling runs at the averaged step size.

    ``logdensity(z) -> 0-d tensor`` of one chain's unconstrained vector
    ``z`` (d,), in torch operations that ``torch.func`` transforms.
    ``z0`` is (d,) for one chain or (C, d) for C chains, which run as one
    batch.  ``generator``: a ``torch.Generator`` on z0's device, or an int
    seed for one.

    Returns ``(samples, info)``: samples (n_samples, d), or
    (C, n_samples, d) for a batch; info has ``accept_rate`` (mean over the
    sampling phase), the adapted ``step_size`` and the final
    ``final_logdensity``, per chain for a batch.
    """
    z0 = as_input(z0)
    single = z0.ndim == 1
    z = torch.atleast_2d(z0).to(torch.float64)
    C, d = z.shape
    gen = _generator(generator, z.device)
    grad_val = vmap(grad_and_value(logdensity))
    dt = dict(dtype=z.dtype, device=z.device)

    def draws():
        jitter = torch.rand((C,), generator=gen, **dt)
        p = torch.randn((C, d), generator=gen, **dt)
        u = torch.rand((C,), generator=gen, **dt)
        return jitter, p, u

    g, lp = grad_val(z)
    mu = math.log(10.0 * init_step_size)
    log_eps = torch.full((C,), math.log(init_step_size), **dt)
    log_eps_bar = log_eps.clone()
    h_bar = torch.zeros((C,), **dt)
    for i in range(n_warmup):
        z, lp, g, accept_p = _proposal(grad_val, z, lp, g, torch.exp(log_eps),
                                       *draws(), n_leapfrog)
        log_eps, log_eps_bar, h_bar = _dual_average(
            log_eps_bar, h_bar, accept_p, i + 1.0, mu, target_accept)

    eps = torch.exp(log_eps_bar)
    samples = torch.empty((C, n_samples, d), **dt)
    accept_sum = torch.zeros((C,), **dt)
    for i in range(n_samples):
        z, lp, g, accept_p = _proposal(grad_val, z, lp, g, eps, *draws(),
                                       n_leapfrog)
        samples[:, i] = z
        accept_sum += accept_p
    info = {'accept_rate': accept_sum / max(n_samples, 1), 'step_size': eps,
            'final_logdensity': lp}
    if single:
        return samples[0], {k: v[0] for k, v in info.items()}
    return samples, info


def split_rhat(chains):
    """Split-R̂ convergence diagnostic (Gelman et al., BDA3 eq. 11.4).

    ``chains``: (n_chains, n_samples, d).  Each chain is split in half;
    values near 1 indicate between/within-chain agreement.  Returns (d,).
    """
    c = _host(chains)
    n_chains, n, d = c.shape
    half = n // 2
    c = np.concatenate([c[:, :half], c[:, half:2 * half]], axis=0)
    m, n = c.shape[0], c.shape[1]
    chain_means = c.mean(axis=1)                      # (m, d)
    chain_vars = c.var(axis=1, ddof=1)                # (m, d)
    B = n * chain_means.var(axis=0, ddof=1)           # (d,)
    W = chain_vars.mean(axis=0)                       # (d,)
    var_plus = (n - 1) / n * W + B / n
    return np.sqrt(var_plus / np.where(W > 0, W, 1.0))


def effective_sample_size(chains):
    R"""Multi-chain effective sample size (BDA3 §11.5, Stan's estimator).

    ``chains``: (n_chains, n_samples, d).  Per-lag autocovariances averaged
    over chains and combined with the between-chain variance; the sum over
    lags uses Geyer's initial monotone positive pairs.  Returns (d,)
    counts of independent draws; host numpy, like the other sampling
    diagnostics.
    """
    c = _host(chains)
    m, n, d = c.shape
    cc = c - c.mean(axis=1, keepdims=True)
    # FFT autocovariance per (chain, dim), biased normalization (1/n)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(cc, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :n].real / n
    chain_vars = c.var(axis=1, ddof=1)                       # (m, d)
    W = chain_vars.mean(axis=0)                              # (d,)
    B_over_n = c.mean(axis=1).var(axis=0, ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * W + B_over_n                    # (d,)

    rho = 1.0 - (W - acov.mean(axis=0)) / np.where(var_plus > 0, var_plus,
                                                   1.0)      # (n, d)
    ess = np.empty(d)
    for j in range(d):
        # Geyer: sum consecutive-lag pairs while positive and decreasing
        pair = rho[:-1 if n % 2 else None, j].reshape(-1, 2).sum(axis=1)
        run = np.minimum.accumulate(pair)
        keep = run > 0
        tau = -1.0 + 2.0 * np.cumsum(np.where(keep, run, 0.0))[-1] \
            if keep.any() else 1.0
        ess[j] = m * n / max(tau, 1.0 / (m * n))
    return ess


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(float)
    return np.asarray(a, dtype=float)


def _run_bounded_hmc(loglike, bounds, x0_center, n_chains, n_samples,
                     n_warmup, n_leapfrog, init_step_size, target_accept,
                     random_state, device, extra_log_prior=None):
    """HMC of a box-bounded vector, all chains in one batch.

    ``loglike(x) -> 0-d tensor`` on the BOUNDED vector of one chain; the
    box is removed by the sigmoid / softplus map with its log-Jacobian
    added, so the target in x is ``exp(loglike(x) + extra_log_prior(x))``
    times a flat prior in the bounds.  Chains start at ``x0_center`` plus
    0.1 times a standard normal (numpy ``RandomState(random_state)``, as
    the JAX package), clipped into the box.  Returns (samples in x
    (n_chains, n_samples, d), info dict with ``rhat`` and ``ess``)."""
    bounds = np.asarray(bounds, dtype=float)
    d = bounds.shape[0]
    f64 = dict(dtype=torch.float64, device=device)
    lo = torch.as_tensor(bounds[:, 0], **f64)
    hi = torch.as_tensor(bounds[:, 1], **f64)

    def logdensity(z):
        x = _to_bounded(z, lo, hi)
        lp = loglike(x) + torch.sum(_log_jac_bounded(z, lo, hi))
        if extra_log_prior is not None:
            lp = lp + extra_log_prior(x)
        return torch.squeeze(lp)

    seed = random_state if isinstance(random_state, (int, np.integer)) \
        else None
    rng = np.random.RandomState(seed)
    inits = np.asarray(x0_center, dtype=float)[None, :] \
        + 0.1 * rng.randn(n_chains, d)
    fin = np.isfinite(bounds)
    lo_np = np.where(fin[:, 0], bounds[:, 0], -np.inf)
    hi_np = np.where(fin[:, 1], bounds[:, 1], np.inf)
    span = np.where(fin.all(axis=1), hi_np - lo_np, 1.0)
    inits = np.clip(inits, lo_np + 1e-3 * span, hi_np - 1e-3 * span)
    z0 = _to_unbounded(torch.as_tensor(inits, **f64), lo, hi)

    gen = _generator(0 if seed is None else int(seed), device)
    zs, info = hmc(logdensity, z0, gen, n_samples=n_samples,
                   n_warmup=n_warmup, n_leapfrog=n_leapfrog,
                   init_step_size=init_step_size, target_accept=target_accept)
    xs = _to_bounded(zs, lo, hi)
    xs_np = _host(xs)
    info = {k: v.cpu().numpy() for k, v in info.items()}
    info['rhat'] = split_rhat(xs_np)
    info['ess'] = effective_sample_size(xs_np)
    return xs, info


def sample_theta_posterior(gp, X=None, y=None, n_chains=4, n_samples=1000,
                           n_warmup=500, n_leapfrog=16, init_step_size=0.1,
                           target_accept=0.8, random_state=0,
                           extra_log_prior=None, steps_per_call=None,
                           mesh=None, mesh_axis='model'):
    R"""HMC posterior over a conjugate process's kernel log-hyperparameters.

    The target is :math:`p(\theta\mid y) \propto \exp(\mathrm{lml}(\theta))`
    times a flat prior within the kernel's bounds (uniform in
    :math:`\log\theta`, as the MAP fit and the grid posteriors), times
    ``exp(extra_log_prior(theta))`` if given (a torch function of log θ).

    ``gp``: a conjugate process (CGP or CSP).  Fitted, its training data
    (derivative observations included) and kernel are used; otherwise pass
    ``X`` / ``y``.  The chains run as one batch on the model's device.

    Returns ``(thetas, info)``: ``thetas`` (n_chains, n_samples, n_dims)
    in log space, and ``info`` with per-chain ``accept_rate`` and adapted
    ``step_size``, ``rhat`` (d,) and ``ess`` (d,).

    ``steps_per_call`` is accepted and changes nothing (the steps are
    issued from a host loop already).

    ``mesh`` / ``mesh_axis``: the model-parallel large-N path.  With a
    ``parallel.mesh.Mesh``, every lml and its gradient evaluate through
    ``parallel.pchol.sharded_cgp_lml``: the correlation matrix is built and
    factored row-sharded over ``mesh[mesh_axis]`` and never made on one
    device (ConjugateGaussianProcess only, without derivative training
    data; the kernel's two-argument ``value_fn`` builds it, where a
    WhiteKernel is 0, as in JAX).
    """
    del steps_per_call
    kernel = gp._kernel_for_lml()
    if kernel.n_dims == 0:
        raise ValueError('kernel has no free hyperparameters to sample')
    if X is None and gp.X_train_ is None:
        raise ValueError('pass X/y or fit the model first')

    X_arr = gp._points(gp.X_train_ if X is None else X)
    y_arr = gp._tensor(gp.y_train_ if y is None else y)
    y2 = y_arr[:, None] if y_arr.ndim == 1 else y_arr
    if X is None and gp.dorders_ is not None:
        basis = gp.basis_train_
    else:
        basis = gp._basis(X_arr)
    frozen = kernel.clone()

    if mesh is not None:
        from .models import ConjugateGaussianProcess
        from .parallel.pchol import sharded_cgp_lml

        if not isinstance(gp, ConjugateGaussianProcess):
            raise TypeError('mesh-sharded sampling targets the '
                            'ConjugateGaussianProcess lml')
        if X is None and gp.dorders_ is not None:
            raise ValueError('derivative training data is not supported '
                             'in the sharded lml path')
        c0, V0 = np.atleast_1d(gp.center0), np.atleast_2d(gp.disp0)

        def loglike(theta):
            return sharded_cgp_lml(frozen.value_fn, theta, X_arr, y2, basis,
                                   c0, V0, gp.df0, gp.scale0, mesh,
                                   axis=mesh_axis, nugget=gp.nugget)
    else:
        def loglike(theta):
            return gp._lml(frozen, theta, X_arr, y2, basis)

    return _run_bounded_hmc(
        loglike, np.asarray(kernel.bounds, dtype=float),
        np.asarray(kernel.theta, dtype=float), n_chains, n_samples,
        n_warmup, n_leapfrog, init_step_size, target_accept, random_state,
        X_arr.device, extra_log_prior=extra_log_prior)


def posterior_predictive(gp, Xnew, thetas, X=None, y=None, thin=1,
                         chunk=128, return_draws=False):
    R"""Full-Bayes predictive at ``Xnew``: the mixture over hyperparameter
    posterior draws.

    Each draw's conjugate posterior state and predictive moments come from
    :func:`gsum_tpu_torch.parallel.batched_posterior_at` and
    :func:`~gsum_tpu_torch.parallel.batched_predict` in batches of
    ``chunk``, and are mixed by the law of total variance:

    .. math::
        m(x) = E_\theta[m_\theta(x)], \qquad
        s^2(x) = E_\theta[s_\theta^2(x) + m_\theta(x)^2] - m(x)^2.

    Parameters
    ----------
    gp : fitted ConjugateGaussianProcess or ConjugateStudentProcess
        (``decomposition='cholesky'``); for the Student process each draw's
        std includes the mean-uncertainty term variance-additively
        (``sqrt(σ² + mu_var)``), so that the mixture is exact
    Xnew : (N_new, d) prediction points
    thetas : (B, n_dims) or (n_chains, n_samples, n_dims) log-space draws
    X, y : optional training-data override (default: the fitted data)
    thin : keep every ``thin``-th draw
    chunk : draws per batched call
    return_draws : also return the per-draw ``(means, stds)``

    Returns
    -------
    (mean, std) tensors of shape (N_new, m) and (N_new,) — or
    (mean, std, means_draws, stds_draws) with ``return_draws=True``.
    """
    from .models import (ConjugateGaussianProcess as _CGP,
                         ConjugateStudentProcess as _CSP)
    from .parallel import batched_posterior_at, batched_predict

    if not isinstance(gp, (_CGP, _CSP)):
        raise TypeError('posterior_predictive supports the conjugate '
                        'Gaussian and Student processes')
    student = isinstance(gp, _CSP)
    if gp.decomposition != 'cholesky':
        raise ValueError("posterior_predictive needs decomposition="
                         "'cholesky'")
    if X is None and gp.X_train_ is None:
        raise ValueError('pass X/y or fit the model first')
    if X is not None and y is None and gp.y_train_ is None:
        raise ValueError('X was overridden on an unfitted model — pass y '
                         'as well')
    if X is None and gp.dorders_ is not None:
        raise ValueError('derivative training data is not supported in '
                         'the batched predictive path')

    thetas = _host(thetas)
    if thetas.ndim == 3:
        thetas = thetas.reshape(-1, thetas.shape[-1])
    thetas = thetas[::max(int(thin), 1)]
    kernel = gp._kernel_for_lml()
    if thetas.shape[-1] != kernel.n_dims:
        raise ValueError('thetas have %d columns but the kernel has %d '
                         'free dimensions'
                         % (thetas.shape[-1], kernel.n_dims))

    X_arr = gp._points(gp.X_train_ if X is None else X)
    y_arr = gp._tensor(gp.y_train_ if y is None else y)
    y2 = y_arr[:, None] if y_arr.ndim == 1 else y_arr
    Xn = gp._points(Xnew)
    thetas = torch.as_tensor(thetas, dtype=X_arr.dtype, device=X_arr.device)
    B = thetas.shape[0]
    step = int(chunk) if chunk else B
    means_parts, stds_parts = [], []
    for i in range(0, B, step):
        t_i = thetas[i:i + step]
        post = batched_posterior_at(
            kernel, X_arr, y2, t_i, center=gp.center0, disp=gp.disp0,
            df=gp.df0, scale=gp.scale0, nugget=gp.nugget, basis=gp.basis,
            chunk=None)
        y_b = y2.expand((t_i.shape[0],) + y2.shape)
        # student_mode='variance': the mixture needs each draw's true
        # predictive std (σ² + mu_var), not the class's σ + sqrt(mu_var)
        m_i, s_i = batched_predict(kernel, post, X_arr, y_b, Xn,
                                   basis=gp.basis, student=student,
                                   student_mode='variance')
        means_parts.append(m_i)
        stds_parts.append(s_i)
    means = torch.cat(means_parts, 0)
    stds = torch.cat(stds_parts, 0)

    mean_mix = torch.mean(means, 0)                     # (N_new, m)
    var_mix = torch.mean(stds[:, :, None] ** 2 + means ** 2, 0) \
        - mean_mix ** 2
    std_mix = torch.sqrt(torch.clamp(var_mix, min=0.0))
    if return_draws:
        return mean_mix, std_mix, means, stds
    return mean_mix, std_mix


def truncation_posterior_predictive(tgp, Xnew, order, draws, ratio_param,
                                    thin=1, chunk=128, return_draws=False):
    R"""Full-Bayes truncation-error band at ``Xnew``: the mixture of the
    per-draw bands over joint (θ, q) posterior draws.

    For each draw the coefficients are re-extracted at the draw's
    expansion parameter, the conjugate posterior recomputed at its θ, and
    the truncation band ``ref·Σ_{n>k} ratioⁿ`` scales it (the
    ``kind='trunc'`` branch of ``TruncationProcess.predict``); the draws
    run as one ``torch.func.vmap`` per chunk and are mixed by the law of
    total variance.

    Scope: ``TruncationGP`` without ``dX`` / ``dy`` constraints.

    Parameters
    ----------
    tgp : fitted TruncationGP whose ``ratio`` callable takes the keyword
        ``ratio_param`` (torch-traceable in it)
    Xnew : (N_new, d) prediction points
    order : highest order of the partial sum; the band is for
        ``y_inf - y_order``
    draws : (B, n_theta + 1) or (n_chains, n_samples, n_theta + 1), q in
        the last column (as :func:`sample_truncation_posterior` returns)
    ratio_param : keyword of ``tgp.ratio`` the q column feeds
    thin, chunk, return_draws : as in :func:`posterior_predictive`

    Returns
    -------
    (mean, std) tensors of shape (N_new,) — or
    (mean, std, means_draws, stds_draws) with ``return_draws=True``.
    """
    from . import conjugate as _conj
    from .helpers import coefficients, geometric_sum
    from .linalg import cholesky
    from .models import ConjugateGaussianProcess as _CGP
    from .models import ConjugateStudentProcess as _CSP
    from .models import _columns

    if not getattr(tgp, '_fit', False):
        raise ValueError('fit the truncation process first')
    cp = tgp.coeffs_process
    if isinstance(cp, _CSP) or not isinstance(cp, _CGP):
        raise TypeError('truncation_posterior_predictive supports '
                        'TruncationGP (Gaussian coefficient process)')
    if tgp.dX_ is not None:
        raise ValueError('constrained truncation (dX/dy) is not supported '
                         'in the batched predictive path — mix per-draw '
                         'class predict calls instead')

    draws = _host(draws)
    if draws.ndim == 3:
        draws = draws.reshape(-1, draws.shape[-1])
    draws = draws[::max(int(thin), 1)]
    n_t = draws.shape[1] - 1

    kernel = cp._kernel_for_lml()
    if kernel.n_dims != n_t:
        raise ValueError('draws have %d theta columns, kernel has %d '
                         'free dimensions' % (n_t, kernel.n_dims))
    frozen = kernel.clone()
    X_tr = tgp.X_train_
    Xn = tgp._points(Xnew)
    y_tr = tgp.y_train_
    orders = np.asarray(tgp.orders_)
    mask = ~np.isin(orders, tgp.excluded)
    basis_tr = cp._basis(X_tr)
    basis_n = cp._basis(Xn)
    c0 = np.atleast_1d(cp.center0)
    V0 = np.atleast_2d(cp.disp0)
    df0, scale0, nugget = cp.df0, cp.scale0, cp.nugget
    N = X_tr.shape[0]
    eye = torch.eye(N, dtype=X_tr.dtype, device=X_tr.device)
    ref_tr = tgp._ref(X_tr)
    ref_n = tgp._ref(Xn)
    start = int(order) + 1
    excluded = tgp.excluded

    def one(theta, q):
        kws = {ratio_param: q}
        ratio_tr = tgp._ratio(X_tr, **kws)
        coeffs = _columns(coefficients(y=y_tr, ratio=ratio_tr, ref=ref_tr,
                                       orders=orders), mask)
        R = frozen.value_fn(theta, X_tr, None)
        L = cholesky(R + nugget * eye)
        center = _conj.compute_center(coeffs, L, basis_tr, c0, V0)
        df_ = _conj.compute_df(coeffs, df0)
        scale_sq = _conj.compute_scale_sq(coeffs, L, basis_tr, c0, V0, df0,
                                          scale0)
        cov_factor = _conj.compute_cov_factor(scale_sq, df_)

        ratio_n = tgp._ratio(Xn, **kws)
        gs_mean = geometric_sum(x=ratio_n, start=start, end=np.inf,
                                excluded=excluded)
        m = ref_n * gs_mean * (basis_n @ center)
        gs_var = geometric_sum(x=ratio_n * ratio_n, start=start, end=np.inf,
                               excluded=excluded)
        # per-point (x, x) kernel values, as the class's trunc band takes
        # kernel_(X, X) (which differs from kernel_(X) for a WhiteKernel)
        R_nn_diag = vmap(lambda x: frozen.value_fn(
            theta, x[None, :], x[None, :])[0, 0])(Xn)
        var = ref_n ** 2 * gs_var * cov_factor * R_nn_diag
        return m, torch.sqrt(torch.clamp(var, min=0.0))

    fn = vmap(one)
    draws = torch.as_tensor(draws, dtype=X_tr.dtype, device=X_tr.device)
    B = draws.shape[0]
    step = int(chunk) if chunk else B
    means_parts, stds_parts = [], []
    with torch.no_grad():
        for i in range(0, B, step):
            d_i = draws[i:i + step]
            m_i, s_i = fn(d_i[:, :n_t], d_i[:, n_t])
            means_parts.append(m_i)
            stds_parts.append(s_i)
    means = torch.cat(means_parts, 0)       # (B, N_new)
    stds = torch.cat(stds_parts, 0)

    mean_mix = torch.mean(means, 0)
    var_mix = torch.mean(stds ** 2 + means ** 2, 0) - mean_mix ** 2
    std_mix = torch.sqrt(torch.clamp(var_mix, min=0.0))
    if return_draws:
        return mean_mix, std_mix, means, stds
    return mean_mix, std_mix


def sample_truncation_posterior(tgp, ratio_param, q_bounds, q0=None,
                                n_chains=4, n_samples=1000, n_warmup=500,
                                n_leapfrog=16, init_step_size=0.1,
                                target_accept=0.8, random_state=0,
                                extra_log_prior=None, steps_per_call=None):
    R"""Joint HMC posterior over (kernel θ, expansion parameter q) of a
    fitted truncation process.

    The density is the model's own joint log-likelihood with the
    change-of-variables determinant, ``log_marginal_likelihood(theta,
    **{ratio_param: q})``, differentiated end to end through the
    coefficient extraction.

    Parameters
    ----------
    tgp : fitted TruncationGP / TruncationTP whose ``ratio`` callable takes
        the keyword ``ratio_param`` (torch-traceable in it), e.g. the
        scalar ratio's own ``ratio``
    q_bounds : (lo, hi) box for q (natural scale)
    q0 : starting value (default: the box's midpoint)
    extra_log_prior : callable ``x -> 0-d tensor`` on the sampled vector
        ``x = [theta..., q]``

    Returns (samples, info): samples (n_chains, n_samples, n_theta + 1)
    with q in the last column; info as in :func:`sample_theta_posterior`.
    """
    del steps_per_call
    if not getattr(tgp, '_fit', False):
        raise ValueError('fit the truncation process first (any ratio '
                         'value works; it is resampled here)')
    kernel = tgp.coeffs_process._kernel_for_lml()
    n_t = kernel.n_dims
    if n_t == 0:
        raise ValueError('kernel has no free hyperparameters to sample')
    lo_q, hi_q = float(q_bounds[0]), float(q_bounds[1])
    if q0 is None:
        q0 = 0.5 * (lo_q + hi_q)
    X, y, orders = tgp.X_train_, tgp.y_train_, np.asarray(tgp.orders_)

    def loglike(x):
        return tgp._joint_lml(x[:n_t], X, y, orders, **{ratio_param: x[n_t]})

    bounds = np.vstack([np.asarray(kernel.bounds, dtype=float),
                        [[lo_q, hi_q]]])
    x0 = np.concatenate([np.asarray(kernel.theta, dtype=float), [q0]])
    return _run_bounded_hmc(
        loglike, bounds, x0, n_chains, n_samples, n_warmup, n_leapfrog,
        init_step_size, target_accept, random_state, X.device,
        extra_log_prior=extra_log_prior)
