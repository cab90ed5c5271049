R"""Batched conjugate-GP and Student-t log-marginal likelihoods over grids of
correlation matrices (counterpart of ``gsum_tpu/ops/gridlml.py``).

A hyperparameter-grid sweep (the reference's publication notebook runs 8000
lml evaluations in a Python loop) becomes explicitly batched tensor work:
one batched factorization, batched solves, and einsums for the conjugate
updates (reference models.py:912-1057), with the grid axis leading every
operation.  The general model is supported: several curves, a small mean
basis, V₀ = 0 or SPD, ν₀ finite or ∞.

As in the JAX package, each function factors once to find the matrices
whose factorization fails, factors again a batch in which those are
replaced by the identity, and returns ``-inf`` there, so that gradients
stay finite.  The first factorization only sets the flag and runs under
``torch.no_grad()``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._config import promoted
from .smallchol import _flag, batched_small_cholesky, batched_small_tri_inv

__all__ = ['cgp_lml_grid', 'cgp_lml_grid2', 'csp_lml_grid',
           'csp_lml_grid2', 'batched_cho_solve']

_LOG_2PI = math.log(2 * math.pi)


def batched_cho_solve(L, B, leaf=16):
    """Solves ``(L Lᵀ) X = B`` batched (``torch.cholesky_solve``), L and B
    promoted to one dtype.  The JAX package solves through the triangular
    inverse and two products, a TPU workaround; ``leaf`` is accepted for
    its signature and ignored."""
    L, B = promoted(L, B)
    return torch.cholesky_solve(B, L)


def _resolve_mxu_precision(p):
    """'highest' | 'high' | None (→ 'highest'): the blocked engine's GEMM
    arithmetic (``ops.blockchol``'s ``precision``)."""
    if p is None:
        return 'highest'
    if isinstance(p, str) and p.lower() in ('highest', 'high'):
        return p.lower()
    raise ValueError("mxu_precision must be 'highest' or 'high', got %r"
                     % (p,))


def _priors(center0, disp0, df0, like):
    center0 = torch.atleast_1d(torch.as_tensor(
        np.asarray(center0, dtype=float), dtype=like.dtype,
        device=like.device))
    disp0_np = np.atleast_2d(np.asarray(disp0, dtype=float))
    return (center0, disp0_np, bool(np.all(disp0_np == 0)),
            bool(np.isinf(df0)))


def _safe_factor(Rs, factor=batched_small_cholesky):
    """(ok, factor(Rs_safe)): the flag from a first factorization (no
    graph), then the factorization of Rs with failed members replaced by
    the identity.  ``factor`` returns L, or a tuple whose first entry is
    L."""
    with torch.no_grad():
        L0 = factor(Rs)
    ok = _flag(L0[0] if isinstance(L0, tuple) else L0)
    eye = torch.eye(Rs.shape[-1], dtype=Rs.dtype, device=Rs.device)
    return ok, factor(torch.where(ok[:, None, None], Rs, eye))


def _logdet(L):
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)


def cgp_lml_grid(Rs, y, basis, center0, disp0, df0, scale0, leaf=16,
                 engine='unrolled', block=None, mxu_precision=None):
    R"""ConjugateGaussianProcess lml for a batch of correlation matrices.

    Parameters
    ----------
    Rs : (G, N, N) — nugget-included correlation matrices (one per grid
        point); a factorization failure gives ``-inf``
    y : (N, m) shared training curves, or (G, N, m) per-grid-point data
    basis : (N, p) — mean basis (shared)
    center0, disp0, df0, scale0 : concrete prior hyperparameters
    leaf : accepted for the JAX signature and ignored
    engine : 'unrolled' | 'scan' | 'blocked' — factorization and solve.
        'unrolled' is ``ops.smallchol`` (batched ``torch.linalg``) with
        solves through the triangular inverse; 'scan' is
        ``ops.scanchol``; 'blocked' is ``ops.blocked_spd_solve_logdet``,
        whose diagonal blocks go to the CUDA diagonal kernel for f32 on
        the card and whose hand-written backward serves optimizer
        objectives (one factorization gives value, flag and gradient).
    block : int, optional — column-block width of the 'blocked' engine
        (default 128)
    mxu_precision : 'highest' (default) | 'high' — the 'blocked' engine's
        GEMM arithmetic ('high' is 3xTF32; ignored by the other engines,
        as in JAX)

    Returns
    -------
    (G,) log-marginal likelihoods
    """
    if y.ndim == 1:
        y = y[:, None]
    if engine == 'scan' and not Rs.dtype == y.dtype == basis.dtype:
        # JAX's scan engine raises here too (a TypeError of
        # lax.dynamic_update_slice)
        raise TypeError(f"the 'scan' engine takes one dtype, got "
                        f"covariances {Rs.dtype}, data {y.dtype} and basis "
                        f"{basis.dtype}")
    Rs, y, basis = promoted(Rs, y, basis)
    G, N, _ = Rs.shape
    m = y.shape[-1]
    p = basis.shape[1]
    dtype, dev = Rs.dtype, Rs.device
    per_point_y = y.ndim == 3
    center0, disp0_np, disp0_zero, df0_inf = _priors(center0, disp0, df0, Rs)

    # right-hand sides of the solves: R⁻¹ y and R⁻¹ B for every grid point
    if per_point_y:
        yB = torch.cat([y, basis.expand((G,) + basis.shape)], -1)
    else:
        yB = torch.cat([y, basis], 1).expand(G, N, m + p)

    logdet_R = None
    if engine == 'blocked':
        from .blockchol import blocked_spd_solve_logdet

        invR_yB, logdet_R, ok = blocked_spd_solve_logdet(
            Rs, yB, block=128 if block is None else int(block),
            precision=_resolve_mxu_precision(mxu_precision))
    elif engine == 'scan':
        from .scanchol import scan_blocked_cholesky, scan_cho_solve

        ok, (L, minvs) = _safe_factor(Rs, scan_blocked_cholesky)
        invR_yB = scan_cho_solve(L, minvs, yB)
    elif engine == 'unrolled':
        ok, L = _safe_factor(Rs)
        invR_yB = batched_cho_solve(L, yB, leaf)
    else:
        raise ValueError("engine must be 'unrolled', 'scan' or 'blocked', "
                         "got %r" % (engine,))
    invR_y = invR_yB[..., :m]                                       # (G, N, m)
    invR_B = invR_yB[..., m:]                                       # (G, N, p)

    yb = y if per_point_y else y[None]                            # (G|1, N, m)
    ybar = yb.mean(-1)                                              # (G|1, N)
    invR_ybar = invR_y.mean(-1)                                     # (G, N)

    # conjugate updates (reference models.py:169-457), batched over G
    df = df0 + N * m
    if disp0_zero:
        center = center0.expand(G, p)
    else:
        quad_B = torch.einsum('np,gnq->gpq', basis, invR_B)         # Bᵀ R⁻¹ B
        # the concrete prior's inverse, exact on the host (p is tiny)
        disp0_inv = torch.as_tensor(np.linalg.inv(disp0_np), dtype=dtype,
                                    device=dev)
        Mp = disp0_inv[None] + m * quad_B                           # (G, p, p)
        Lm = batched_small_cholesky(Mp, leaf)
        eye_p = torch.eye(p, dtype=dtype, device=dev).expand(G, p, p)
        disp = batched_cho_solve(Lm, eye_p, leaf)                   # (G, p, p)
        factor = (disp0_inv @ center0)[None] \
            + m * torch.einsum('np,gn->gp', basis, invR_ybar)
        center = torch.einsum('gpq,gq->gp', disp, factor)

    if df0_inf:
        scale_sq = torch.full((G,), float(scale0) ** 2, dtype=dtype,
                              device=dev)
    else:
        y_c = yb - ybar[..., None]                                # (G|1, N, m)
        invR_yc = invR_y - invR_ybar[..., None]
        quad = torch.einsum('gnm,gnm->g', y_c.expand_as(invR_yc), invR_yc)
        avg_yc = ybar - (basis @ center0)[None]                     # (G|1, N)
        invR_avg_yc = invR_ybar - torch.einsum('gnp,p->gn', invR_B, center0)
        avg_b = avg_yc.expand_as(invR_avg_yc)                       # (G, N)
        if disp0_zero:
            quad2 = m * torch.einsum('gn,gn->g', avg_b, invR_avg_yc)
        else:
            # Woodbury form (models.py:440-445):
            # quad2 = ny avg_ycᵀ (I − ny R⁻¹ B V Bᵀ) R⁻¹ avg_yc
            u = torch.einsum('np,gn->gp', basis, invR_avg_yc)
            w = torch.einsum('gpq,gq->gp', disp, u)
            corr = m * torch.einsum('gnp,gp->gn', invR_B, w)
            quad2 = m * torch.einsum('gn,gn->g', avg_b, invR_avg_yc - corr)
        scale_sq = (df0 * float(scale0) ** 2 + quad + quad2) / df

    var = scale_sq if df0_inf else df * scale_sq / (df - 2)

    mean = torch.einsum('np,gp->gn', basis, center)                 # (G, N)
    y_t = yb - mean[..., None]                                      # (G, N, m)
    # alpha = R⁻¹ y_t / var from the solves already made
    invR_mean = torch.einsum('gnp,gp->gn', invR_B, center)
    alpha = (invR_y - invR_mean[..., None]) / var[..., None, None]
    quad_t = torch.einsum('gnm,gnm->g', y_t.expand_as(alpha), alpha)

    if logdet_R is None:
        logdet_R = _logdet(L)
    logdet_K = N * torch.log(var) + logdet_R
    lml = -0.5 * (quad_t + m * (logdet_K + N * _LOG_2PI))
    return torch.where(ok, lml, -torch.inf)


def _grid2_solves(Rs, Ys, basis, leaf):
    """Flag, factor and the solves R_t⁻¹ y_r (all pairs) and R_t⁻¹ B."""
    ok, L = _safe_factor(Rs)
    Minv = batched_small_tri_inv(L, leaf)                           # (T, N, N)
    MY = torch.einsum('tij,rjm->trim', Minv, Ys)                    # (T,R,N,m)
    invR_Y = torch.einsum('tji,trjm->trim', Minv, MY)
    invR_B = Minv.mT @ (Minv @ basis)                               # (T, N, p)
    return ok, L, invR_Y, invR_B


def _grid2_scale_sq(Ys, basis, center0, invR_Y, invR_B, df0, scale0, df):
    m = Ys.shape[-1]
    ybar = Ys.mean(-1)                                              # (R, N)
    invR_ybar = invR_Y.mean(-1)                                     # (T, R, N)
    y_c = Ys - ybar[..., None]
    invR_yc = invR_Y - invR_ybar[..., None]
    quad = torch.einsum('rnm,trnm->tr', y_c, invR_yc)
    avg_yc = ybar - (basis @ center0)[None]                         # (R, N)
    invR_avg_yc = invR_ybar \
        - torch.einsum('tnp,p->tn', invR_B, center0)[:, None]
    quad2 = m * torch.einsum('rn,trn->tr', avg_yc, invR_avg_yc)
    return (df0 * float(scale0) ** 2 + quad + quad2) / df


def cgp_lml_grid2(Rs, Ys, basis, center0, disp0, df0, scale0, leaf=16):
    R"""CGP lml on the outer product of covariance and data grids.

    Each correlation matrix is factored once and applied to every data set
    with batched products (the reference loops over both axes in Python).

    Parameters
    ----------
    Rs : (T, N, N) — correlation matrices, nugget included
    Ys : (R, N, m) — data sets (one per ratio grid point)
    basis : (N, p); priors as in :func:`cgp_lml_grid`, with disp0 = 0 (the
        truncation models' delta-mean prior; anything else raises
        ``NotImplementedError``, as in JAX)

    Returns
    -------
    (T, R) log-marginal likelihoods
    """
    Rs, Ys, basis = promoted(Rs, Ys, basis)
    T, N, _ = Rs.shape
    R, _, m = Ys.shape
    dtype, dev = Rs.dtype, Rs.device
    center0, _, disp0_zero, df0_inf = _priors(center0, disp0, df0, Rs)
    if not disp0_zero:
        raise NotImplementedError(
            'cgp_lml_grid2 currently supports the delta-mean prior '
            '(disp0 = 0), which is what the truncation models use')

    ok, L, invR_Y, invR_B = _grid2_solves(Rs, Ys, basis, leaf)
    df = df0 + N * m
    if df0_inf:
        scale_sq = torch.full((T, R), float(scale0) ** 2, dtype=dtype,
                              device=dev)
    else:
        scale_sq = _grid2_scale_sq(Ys, basis, center0, invR_Y, invR_B, df0,
                                   scale0, df)
    var = scale_sq if df0_inf else df * scale_sq / (df - 2)

    mean = basis @ center0                                          # (N,)
    invR_mean = torch.einsum('tnp,p->tn', invR_B, center0)          # (T, N)
    # quad_t = Σ_m (y − mean)ᵀ R⁻¹ (y − mean) / var
    ym = Ys - mean[None, :, None]
    invR_ym = invR_Y - invR_mean[:, None, :, None]
    quad_t = torch.einsum('rnm,trnm->tr', ym, invR_ym) / var

    logdet_K = N * torch.log(var) + _logdet(L)[:, None]
    lml = -0.5 * (quad_t + m * (logdet_K + N * _LOG_2PI))
    return torch.where(ok[:, None], lml, -torch.inf)


def _log_norm_prior(df0, scale0):
    """The prior's normal-scaled-inverse-χ² log normalizer, on the host."""
    return math.lgamma(df0 / 2.) \
        - df0 / 2. * float(np.log(df0 * float(scale0) ** 2 / 2.))


def csp_lml_grid(Rs, y, basis, center0, disp0, df0, scale0, leaf=16):
    R"""ConjugateStudentProcess evidence for a batch of correlation matrices.

    The marginalized (mean, variance) evidence of reference
    models.py:1184-1273, the ratio of normal-scaled-inverse-χ²
    normalizers, over a hyperparameter grid.  Parameters and return as
    :func:`cgp_lml_grid` (shared ``y`` only, one engine).
    """
    if y.ndim == 1:
        y = y[:, None]
    Rs, y, basis = promoted(Rs, y, basis)
    G, N, _ = Rs.shape
    m = y.shape[1]
    p = basis.shape[1]
    dtype, dev = Rs.dtype, Rs.device
    center0, disp0_np, disp0_zero, df0_inf = _priors(center0, disp0, df0, Rs)

    ok, L = _safe_factor(Rs)
    yB = torch.cat([y, basis], 1)
    invR_yB = batched_cho_solve(L, yB.expand((G,) + yB.shape), leaf)
    invR_y = invR_yB[..., :m]
    invR_B = invR_yB[..., m:]
    ybar = y.mean(1)
    invR_ybar = invR_y.mean(-1)

    df = df0 + N * m

    # posterior dispersion V (reference models.py:233-278)
    if not disp0_zero:
        quad_B = torch.einsum('np,gnq->gpq', basis, invR_B)
        disp0_inv = torch.as_tensor(np.linalg.inv(disp0_np), dtype=dtype,
                                    device=dev)
        Lm = batched_small_cholesky(disp0_inv[None] + m * quad_B, leaf)
        eye_p = torch.eye(p, dtype=dtype, device=dev).expand(G, p, p)
        disp = batched_cho_solve(Lm, eye_p, leaf)
        # log|V| = −log|V₀⁻¹ + ny Bᵀ R⁻¹ B|
        logdet_disp = -_logdet(Lm)

    # posterior scale (Woodbury form, reference models.py:386-457)
    if df0_inf:
        scale_sq = torch.full((G,), float(scale0) ** 2, dtype=dtype,
                              device=dev)
    else:
        y_c = y - ybar[:, None]
        invR_yc = invR_y - invR_ybar[..., None]
        quad = torch.einsum('nm,gnm->g', y_c, invR_yc)
        avg_yc = ybar - basis @ center0
        invR_avg_yc = invR_ybar - torch.einsum('gnp,p->gn', invR_B, center0)
        if disp0_zero:
            quad2 = m * torch.einsum('n,gn->g', avg_yc, invR_avg_yc)
        else:
            u = torch.einsum('np,gn->gp', basis, invR_avg_yc)
            w = torch.einsum('gpq,gq->gp', disp, u)
            corr = m * torch.einsum('gnp,gp->gn', invR_B, w)
            quad2 = m * torch.einsum('n,gn->g', avg_yc, invR_avg_yc - corr)
        scale_sq = (df0 * float(scale0) ** 2 + quad + quad2) / df

    # normalizer ratio (reference models.py:1241-1258); df is a concrete
    # number, so its log-gamma is taken on the host
    log_norm_post = math.lgamma(df / 2.) \
        - df / 2. * torch.log(df * scale_sq / 2.)
    log_norm_prior = _log_norm_prior(df0, scale0)
    if not disp0_zero:
        log_norm_post = log_norm_post + 0.5 * (p * _LOG_2PI + logdet_disp)
        log_norm_prior += 0.5 * float(
            np.linalg.slogdet(2 * np.pi * disp0_np)[1])

    lml = log_norm_post - log_norm_prior \
        - m / 2. * (N * _LOG_2PI + _logdet(L))
    return torch.where(ok, lml, -torch.inf)


def csp_lml_grid2(Rs, Ys, basis, center0, disp0, df0, scale0, leaf=16):
    R"""Student-t evidence on the outer product of covariance and data grids.

    The TP counterpart of :func:`cgp_lml_grid2`: delta-mean prior (V₀ = 0)
    and finite ν₀ only, as in JAX (anything else raises
    ``NotImplementedError``).
    """
    Rs, Ys, basis = promoted(Rs, Ys, basis)
    T, N, _ = Rs.shape
    R, _, m = Ys.shape
    center0, _, disp0_zero, df0_inf = _priors(center0, disp0, df0, Rs)
    if not disp0_zero:
        raise NotImplementedError(
            'csp_lml_grid2 supports the delta-mean prior')
    if df0_inf:
        raise NotImplementedError('df0 must be finite for the TP evidence')

    ok, L, invR_Y, invR_B = _grid2_solves(Rs, Ys, basis, leaf)
    df = df0 + N * m
    scale_sq = _grid2_scale_sq(Ys, basis, center0, invR_Y, invR_B, df0,
                               scale0, df)
    log_norm_post = math.lgamma(df / 2.) \
        - df / 2. * torch.log(df * scale_sq / 2.)
    lml = log_norm_post - _log_norm_prior(df0, scale0) \
        - m / 2. * (N * _LOG_2PI + _logdet(L))[:, None]
    return torch.where(ok[:, None], lml, -torch.inf)
