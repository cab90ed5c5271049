R"""The conjugate GP's log-marginal likelihood and posterior scale, the
truncation model's coefficients, change of variables, likelihood surface and
'both' prediction, in plain PyTorch.

The coefficient process: m curves y_k ~ N(B η₀, σ² R_θ), iid, with the
constant basis B = 1, a delta prior on the mean (V₀ = 0) and a scaled
inverse-χ² prior (ν₀, τ₀) on σ².  Conjugacy gives ν = ν₀ + N m and
τ² = (ν₀ τ₀² + Σ_k r_kᵀ R⁻¹ r_k) / ν with r_k = y_k − B η₀, the predictive
scale σ̄² = ν τ² / (ν − 2), and the log-marginal likelihood

    −½ Σ_k r_kᵀ R⁻¹ r_k / σ̄² − ½ m (N log σ̄² + log|R|) − ½ m N log 2π.

``precision`` selects how the arithmetic is done: ``'f64'`` is the
reference; ``'f32'`` and ``'tf32'`` are the controls, the reference one
step below a configuration's own precision (float64 and float32 with
TF32 off).  ``'tf32'`` makes every matrix product with its operands
rounded to TF32's 10-bit mantissa, as the tensor cores round them, and
float32 accumulation: the squared distances by the Gram expansion and the
Cholesky factor's trailing updates (a right-looking blocked factor).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ['PRECISIONS', 'Prior', 'sqdist', 'correlation', 'lml_and_scale',
           'maximize_lml', 'coefficients', 'log_change_of_variables',
           'truncation_lml_surface', 'truncation_predict']

PRECISIONS = {'f64': torch.float64, 'f32': torch.float32,
              'tf32': torch.float32}
JITTERS = (0.0, 1e-12, 1e-9, 1e-6)
_LOG_2PI = math.log(2 * math.pi)
_GOLD = (math.sqrt(5) - 1) / 2


@dataclass(frozen=True)
class Prior:
    """Normal-scaled-inverse-χ² prior with a known mean (V₀ = 0)."""
    center: float = 0.0
    df: float = 1.0
    scale: float = 1.0


def _tf32(x):
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa bits),
    ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def sqdist(XA, XB, precision='f64'):
    """(N, M) squared distances between the rows of XA and XB."""
    dtype = PRECISIONS[precision]
    XA, XB = XA.to(dtype), XB.to(dtype)
    if precision == 'tf32':
        a, b = _tf32(XA), _tf32(XB)
        d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2 * a @ b.T
        return torch.clamp(d2, min=0.0)
    return ((XA[:, None, :] - XB[None, :, :]) ** 2).sum(-1)


def _cholesky_tf32(A, block=128):
    """``(L, info)`` of a batch of float32 SPD matrices by a right-looking
    blocked Cholesky whose trailing updates are TF32 products; ``info`` is
    nonzero where a diagonal block fails."""
    A = A.clone()
    B, N, _ = A.shape
    info = torch.zeros(B, dtype=torch.int32, device=A.device)
    for k in range(0, N, block):
        e = min(k + block, N)
        Lkk, bad = torch.linalg.cholesky_ex(A[:, k:e, k:e])
        info = torch.where(info == 0, bad, info)
        A[:, k:e, k:e] = Lkk
        if e < N:
            panel = torch.linalg.solve_triangular(
                Lkk, A[:, e:, k:e].mT, upper=False).mT
            A[:, e:, k:e] = panel
            p = _tf32(panel)
            A[:, e:, e:] -= p @ p.mT
    return torch.tril(A), info


def correlation(d2, ls):
    """RBF correlations exp(−d²/2ℓ²), one matrix per length scale."""
    ls = torch.as_tensor(ls, dtype=d2.dtype, device=d2.device).reshape(-1)
    return torch.exp(-0.5 * d2[None] / (ls[:, None, None] ** 2))


def _chunk(N, budget=2 ** 31):
    """How many (N, N) float64 matrices, with their factors, fit the
    reference's working budget at once."""
    return max(1, budget // (3 * 8 * N * N))


def lml_and_scale(d2, Y, ls, nugget, prior, precision='f64'):
    R"""Log-marginal likelihood and posterior τ² of B fits.

    d2 : (N, N) squared distances; Y : (B, N, m) curves, one set per fit;
    ls : (B,) length scales.  Returns ``(lml, scale_sq)``, each (B,), in
    the precision's dtype; a factorization that fails gives ``-inf`` and
    NaN.
    """
    dtype = PRECISIONS[precision]
    d2 = d2.to(dtype)
    Y = Y.to(dtype)
    ls = torch.as_tensor(ls, dtype=dtype, device=d2.device).reshape(-1)
    B, N, m = Y.shape
    eye = torch.eye(N, dtype=dtype, device=d2.device)
    df = prior.df + N * m
    lmls, scales = [], []
    step = _chunk(N)
    for i in range(0, B, step):
        R = correlation(d2, ls[i:i + step]) + nugget * eye
        L, info = (_cholesky_tf32(R) if precision == 'tf32'
                   else torch.linalg.cholesky_ex(R))
        ok = info == 0
        L = torch.where(ok[:, None, None], L, eye)
        r = Y[i:i + step] - prior.center
        Z = torch.linalg.solve_triangular(L, r, upper=False)
        quad = (Z * Z).sum((-2, -1))
        scale_sq = (prior.df * prior.scale ** 2 + quad) / df
        var = df * scale_sq / (df - 2)
        logdet = 2 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        lml = (-0.5 * quad / var - 0.5 * m * (N * torch.log(var) + logdet)
               - 0.5 * m * N * _LOG_2PI)
        lmls.append(torch.where(ok, lml, -torch.inf))
        scales.append(torch.where(ok, scale_sq, torch.nan))
    return torch.cat(lmls), torch.cat(scales)


def maximize_lml(d2, Y, log_bounds, nugget, prior, precision='f64',
                 grid=16, iters=40):
    R"""The maximum over θ = log ℓ within ``log_bounds`` of each fit's
    log-marginal likelihood: a scan of ``grid`` log-spaced points, then
    golden-section search in the bracket around the best of them.
    Returns ``(theta, lml)``, each (B,), in float64."""
    lo, hi = (float(v) for v in log_bounds)
    B = Y.shape[0]
    dev = d2.device

    def f(theta):
        lml, _ = lml_and_scale(d2, Y, torch.exp(theta), nugget, prior,
                               precision)
        return torch.nan_to_num(lml.to(torch.float64), nan=-torch.inf)

    ts = torch.linspace(lo, hi, grid, dtype=torch.float64, device=dev)
    vals = torch.stack([f(t.expand(B)) for t in ts], 1)           # (B, G)
    best = torch.argmax(vals, 1)
    best_t = ts[best]
    best_v = vals.gather(1, best[:, None])[:, 0]
    h = (hi - lo) / (grid - 1)
    a = torch.clamp(best_t - h, min=lo)
    b = torch.clamp(best_t + h, max=hi)
    c = b - _GOLD * (b - a)
    d = a + _GOLD * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        left = fc >= fd                  # the maximum lies in [a, d]
        b = torch.where(left, d, b)
        a = torch.where(left, a, c)
        new_c = b - _GOLD * (b - a)
        new_d = a + _GOLD * (b - a)
        c_next = torch.where(left, new_c, d)
        d_next = torch.where(left, c, new_d)
        f_new = f(torch.where(left, new_c, new_d))
        fc, fd = torch.where(left, f_new, fd), torch.where(left, fc, f_new)
        c, d = c_next, d_next
    for t, v in ((c, fc), (d, fd)):
        take = v > best_v
        best_t = torch.where(take, t, best_t)
        best_v = torch.where(take, v, best_v)
    return best_t, best_v


def coefficients(y, orders, ratio, ref):
    R"""Coefficients c_n = (y_n − y_{n−1}) / (ref Qⁿ) of partial sums y
    (..., N, n_orders), the first partial sum divided as it is; ``ratio``
    and ``ref`` are scalars or (..., 1, 1)-broadcastable tensors."""
    orders = torch.as_tensor(orders, dtype=y.dtype, device=y.device)
    diffs = torch.cat([y[..., :1], y[..., 1:] - y[..., :-1]], -1)
    return diffs / (ref * ratio ** orders)


def log_change_of_variables(orders, N, ratio, ref):
    R"""log |∂c/∂y|⁻¹ for scalar Q and ref over N points: the Jacobian of
    y → c is diagonal with entries 1 / (ref Qⁿ)."""
    return N * (len(orders) * math.log(abs(float(ref)))
                + float(sum(orders)) * math.log(abs(float(ratio))))


def truncation_lml_surface(d2, Y, orders, ratios, ref, ls, nugget, prior,
                           precision='f64'):
    R"""log p(y | ℓ_t, Q_r) of one observable's partial sums Y (N, n_orders)
    over every length scale ``ls`` (T,) and ratio ``ratios`` (R,), the
    change of variables included: (T, R)."""
    dtype = PRECISIONS[precision]
    d2, Y = d2.to(dtype), Y.to(dtype)
    ratios = ratios.to(dtype)
    N = Y.shape[0]
    C = coefficients(Y[None], orders, ratios[:, None, None], ref)  # (R,N,m)
    Rn, _, m = C.shape
    rows = []
    for t in range(len(ls)):
        R = correlation(d2, ls[t:t + 1])[0] + nugget * torch.eye(
            N, dtype=dtype, device=d2.device)
        L, info = torch.linalg.cholesky_ex(R)
        r = (C - prior.center).permute(1, 0, 2).reshape(N, Rn * m)
        Z = torch.linalg.solve_triangular(L, r, upper=False)
        quad = (Z * Z).reshape(N, Rn, m).sum((0, 2))                 # (R,)
        df = prior.df + N * m
        scale_sq = (prior.df * prior.scale ** 2 + quad) / df
        var = df * scale_sq / (df - 2)
        logdet = 2 * torch.log(torch.diagonal(L)).sum()
        lml = (-0.5 * quad / var - 0.5 * m * (N * torch.log(var) + logdet)
               - 0.5 * m * N * _LOG_2PI)
        rows.append(lml if int(info) == 0 else torch.full_like(lml,
                                                              -torch.inf))
    det = torch.tensor([log_change_of_variables(orders, N, q, ref)
                        for q in ratios.tolist()], dtype=torch.float64,
                       device=d2.device)
    return torch.stack(rows).to(torch.float64) - det[None]


def _geometric(q, start, stop, excluded):
    """Σ qⁿ over start <= n <= stop (stop may be inf, needing |q| < 1),
    less the excluded orders."""
    s = q ** start / (1 - q) if math.isinf(stop) else \
        sum(q ** n for n in range(int(start), int(stop) + 1))
    for n in excluded:
        if start <= n <= stop:
            s = s - q ** n
    return s


def truncation_predict(X, Xnew, y_k, ls, cov_factor, ratio, ref, order,
                       excluded, center=0.0, precision='f64'):
    R"""Mean and std of y_order plus its truncation error at ``Xnew``
    ('both'): the noise-free interpolant of the partial sum y_k at X, whose
    Gram matrix is factored with the first jitter of ``JITTERS`` (times its
    largest diagonal entry) that succeeds, plus the independent truncation
    error Σ_{n > order} cₙ ref Qⁿ.  ``cov_factor`` is the coefficient
    process's σ̄² at ``ls``."""
    dtype = PRECISIONS[precision]
    X, Xnew, y_k = X.to(dtype), Xnew.to(dtype), y_k.to(dtype)
    q, r = float(ratio), float(ref)
    amp = float(cov_factor) * r * r
    s_int = _geometric(q * q, 0, order, excluded)
    s_tr = _geometric(q * q, order + 1, math.inf, excluded)
    m_int = r * _geometric(q, 0, order, excluded) * center
    m_tr = r * _geometric(q, order + 1, math.inf, excluded) * center
    K_oo = amp * s_int * correlation(sqdist(X, X, precision), ls)[0]
    K_on = amp * s_int * correlation(sqdist(X, Xnew, precision), ls)[0]
    eye = torch.eye(X.shape[0], dtype=dtype, device=X.device)
    top = torch.max(torch.diagonal(K_oo))
    for j in JITTERS:
        L, info = torch.linalg.cholesky_ex(K_oo + j * top * eye)
        if int(info) == 0:
            break
    else:
        nan = torch.full((Xnew.shape[0],), torch.nan, dtype=dtype,
                         device=X.device)
        return nan, nan
    alpha = torch.cholesky_solve((y_k - m_int)[:, None], L)[:, 0]
    mean = m_int + m_tr + K_on.T @ alpha
    V = torch.linalg.solve_triangular(L, K_on, upper=False)
    var = amp * s_int - (V * V).sum(0) + amp * s_tr
    return mean, torch.sqrt(torch.clamp(var, min=0.0))
