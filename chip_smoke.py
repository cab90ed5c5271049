"""Smoke test of the PyTorch port (``gsum_tpu_torch``) on one CUDA card.

Run from the root of the repository: ``python3 chip_smoke.py``.  It

1. prints the card (``nvidia-smi``), the torch and CUDA versions, and turns
   TF32 off for matmuls and cuDNN (the port's GEMMs run in full f32);
2. builds the CUDA kernels from ``gsum_tpu_torch/csrc`` with nvcc (one
   process per source, all at once) and prints their register counts;
3. holds each kernel against its plain PyTorch version:
   - ``chol_inv_block`` (K1) and an f64 factor at nb in {32, 128, 256, 512},
     B in {1, 16}, and checks that a non-SPD block is flagged;
   - ``rbf_covariance_pallas`` (K2) at (16, 4096, 2) and (3, 1000, 3)
     (unaligned N) f32 and (2, 512, 1) and (2, 4097, 2) f64, one launch a
     call, K exactly symmetric;
   - ``fused_blocked_cholesky`` (K3) and an f64 factor at (2, 1024) and
     (16, 4096), block 256, and checks that a non-SPD matrix is flagged;
   - the incomplete-beta kernels ``ops.incbeta.betainc`` and ``betaincinv``
     at (4096, 5), f64 and f32, on the t quantile's arguments (a = df/2,
     b = 1/2) and the beta bands' (a, b up to about 4000), at
     ``helpers.hpd``'s one-element quantile (a = b = 2049) at both ends, at
     57 elements of it, on a QQ panel's 1024 t quantiles at large ν, on
     XLA's edge values (the last three also repeated past
     ``incbeta.WARP_MAX``), on the t quantile's arguments at ``WARP_MAX``
     elements and one more (launches turn there from a warp per element to
     a thread), and on the first 8192 of the beta bands' arguments in one
     launch and, as the QQ quantiles, in launches of 32 (the warp form):
     some of their Newton iterations do not converge;
4. drives the eleven paths once each, with every kernel's launch count
   set to 0 just before and read just after (paths 8, 9 and 10: around
   each of their legs):
   - ``ops.batched_chol_logpdf`` (blocked route, ``method='auto'``) at the
     headline size of ``bench.py`` (B=16, N=4096, d=2, m=8, f32), against an
     f64 reference pipeline and the same route with the plain diagonal
     engine;
   - the same pipeline with ``method='fused'``, against the f64 reference
     and the blocked route;
   - ``ops.rbf_covariance_pallas`` at B=16, N=4096, d=2, against its plain
     version and an f64 build, and exactly symmetric;
   - the single-model conjugate GP in f64 (``models.ConjugateGaussianProcess``
     at N=4096, d=2, 5 curves: fit, predict at 512 points with std and with
     cov), against the same calls of the port on the CPU, and with
     ``chol_engine='blocked'``; then ``entry.flagship_step`` at N=4096
     against its CPU run.  f64 reaches no kernel, as in JAX;
   - the blocked autograd path in f32 at (16, 4096): forward and backward of
     ``ops.blocked_spd_solve_logdet`` (block 128) and of
     ``ops.batched_blocked_cholesky`` (block 256), the diagonal kernel in
     their forwards only, their gradients against an f64 ``torch.linalg``
     autograd reference beside the f32 ``torch.linalg`` route's;
   - the truncation models in f64 at the single model's width
     (``models.TruncationGP`` and ``TruncationTP`` on the partial sums
     ``helpers.partials`` makes of its 5 curves, ratio 0.5, ref 10): fit,
     ``predict`` of each kind with std and with cov at order 3, the lml +
     gradient at the start θ and at ``ratio=0.45``, and the band constrained
     to 0 on the edge x₀ = 1; held against the single model (coefficients,
     θ, lml less the change of variables) and against the same calls on the
     CPU, with the jitter ladder's rung on each device and the
     interpolant's limit derived from its condition number;
   - the model-checking slice on path 5's data and models (path 6):
     ``TruncationPointwise`` at N=4096, orders 0–4, two priors (fit,
     intervals, the next order's logpdf, the log likelihood at 1500 ratios
     with the posterior's median and HPD, ``credible_diagnostic`` with beta
     and binomial bands at 20 dobs); ``Diagnostic`` at 1024 validation
     points for both truncation models' coefficient processes (samples,
     every error kind, md², coverage, KL); ``VariogramFourthRoot`` at 192
     points (the per-bin branch) and 64 (the batched one); against the same
     calls on the CPU (a subset where the CPU would take minutes: two of
     the 20 dobs, one beta band, the three smallest variogram bins);
   - batched throughput (path 7), at the widths of
     ``benchmarks/scale_tpu.py``'s legs 1-3 and ``bench.py``'s grid lml:
     A, ``parallel.batched_fit`` of 10,240 curves at N=128 f64 (and
     ``precision='mixed'`` on the first chunk); B, 8 fits at N=4096 f32
     through the blocked engine (K1 in every forward; its launches against
     the count derived from the code), the scalar engine and the blocked
     engine with 3xTF32 GEMMs (``mxu_precision='high'``), each fit's lml
     against the f64 single model at its θ; C, ``batched_lml_grid`` over 10,240 θ
     at N=512, d=2 (the scan engine); D, the grid lml at N=256, G=512, f32
     and f64; E, ``truncation_lml_grid`` (100 θ × 80 ratios, gp and tp) on
     path 5's partial sums at N=256, against the truncation models' lml;
     F, ``pointwise_evidence_grid`` at 1500 ratios on path 6's data,
     against path 6's loop; G, ``batched_posterior_at`` and
     ``batched_predict``; each leg's time (CUDA events) and peak memory,
     and a subset of each leg against the CPU, with limits from the
     condition numbers;
   - model checking and derivative observations (path 8): A, path 5's
     TruncationGP with value and slope constraints (``dderivs``) at the 16
     edge points, its constrained slope 0 from ``predict(dorders=)`` and a
     central difference, against the CPU; B, ``derivs.kernel_deriv_cov``
     (RBF, 4096 × 16 points, orders 0–2) against the closed form, and a
     CGP with 64 first-derivative rows (lml gradient against a central
     difference); C, ``GraphicalDiagnostic`` on path 6's setup (1024
     points, nref 1000, both coefficient processes; the Student-t one
     launches the incbeta kernels) and the variogram's data at 192 points,
     the TP against the CPU (its QQ quantiles also in one launch past
     ``incbeta.WARP_MAX``, the thread form); D, ``kl_data`` on leg B's recipe (K1 under
     the blocked fits, its launches against the derived count), 'auto'
     against 'loop' on a few draws;
   - sampling and the utilities (path 9): A, ``sample_truncation_posterior``
     over (ℓ, ratio) on leg E's data against leg E's grid posterior; B,
     ``sample_theta_posterior`` of path 3's CGP at N=512 and
     ``posterior_predictive`` at 32 points; C, ``checkpoint`` save → load,
     predictions bit for bit; D, ``profiling.time_fn`` of one lml;
   - large N across devices (path 10), on meshes of 4 shards that repeat
     the card: A, the 'batch' axis (``batched_lml_grid`` at N=4096 f32
     with K1 in every shard's forward, its launches against the derived
     count; ``batched_fit`` through JAX's per-fit route;
     ``pointwise_evidence_grid``; ``batched_posterior_at`` and
     ``batched_predict``), each against the unsharded call; B, the
     'model' axis at N=16384 f64 (``sharded_kernel_lml``,
     ``sharded_cgp_lml`` and its forward-mode gradient against the dense
     route on the card and a central difference; the dense route's peak
     memory beside the four shards' and beside one shard's alone on the
     card, the others on the CPU) and ``sharded_cholesky`` /
     ``sharded_mvn_lml`` at N=8192; C, ``sharded_fit`` at the JAX
     package's validated configuration against the dense fixed-trip fit;
     D, HMC on the mesh against the unsharded sampler; E,
     ``entry.dryrun_multichip(4)``;
5. times the pipelines, and each kernel against its plain version and the
   library call that computes the same function, with CUDA events (medians
   of 6 samples taken in alternating order, each sample one call, or ten
   back to back for K1 and K2, whose calls are short); beside
   ``chol_inv_block`` also
   the two-call pair ``cholesky_ex`` + ``solve_triangular(L, I)``, which
   computes both of its outputs (context, not its ``library_ms``); beside
   K2 also ``fill_`` of the same memory, the practical rate of writing it,
   and K2 in f64 (context too);
6. profiles each headline pipeline once with ``torch.profiler`` (the
   blocked route also with ``precision='high'``): device time by kernel
   and the device's idle share;
7. times the single model's fit, lml + gradient and predict, and the
   blocked autograd routes' forward + backward, and profiles one lml +
   gradient and one forward + backward of ``blocked_spd_solve_logdet``;
8. times the truncation models' second fit, lml + gradient and each
   ``predict`` kind, profiles one 'both' prediction of each;
9. times the incomplete-beta kernels against their plain versions, with
   their bounds from the continued-fraction terms they took and their lane
   use, at (4096, 5), at ``helpers.hpd``'s one-element quantile and at
   an interval's two-element one, and path 6's calls, profiles one
   pointwise interval;
10. times the blocked route with 3xTF32 GEMMs (``precision='high'``)
    beside it and reports its logpdf error against the f64 reference at
    the headline's nugget and two larger ones; profiles one line search
    of path 7's leg B; prints the script's wall time.

Any failed check raises, so the exit code is not 0.  The line before the
last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card it fails at once.
JAX is not imported.
"""
import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

B, N, D, M = 16, 4096, 2, 8          # bench.py's headline configuration
LS, AMP, NOISE = 0.25, 1.0, 1e-2
NB_CHECK = (32, 128, 256, 512)
REL_TOL = 1e-3                       # f32 pipeline vs f64, and vs plain diag
GP_N, GP_D, GP_CURVES, GP_NEW = 4096, 2, 5, 512   # the single-model path
GP_TOL, GP_GRAD_TOL = 1e-9, 1e-7     # card vs CPU, f64
FLAGSHIP_THETA = (0.01, 0.1)         # its constant and length scale
TRUNC_RATIO, TRUNC_REF, TRUNC_ORDER = 0.5, 10, 3   # the truncation path
TRUNC_EDGE = 16                      # constraint points on the edge x₀ = 1
TRUNC_RATIO_KW = 0.45                # the lml's ratio keyword
JITTERS = (0.0, 1e-12, 1e-9, 1e-6)   # linalg.robust_cholesky's ladder
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12               # f32 outside the tensor cores
KERNELS = {
    'chol_inv_block': ('gsum_tpu_torch/csrc/chol_inv_block.cu',
                       'gsum_tpu/ops/pallas_chol.py:42'),
    'fused_blocked_cholesky': ('gsum_tpu_torch/csrc/fused_chol.cu',
                               'gsum_tpu/ops/fusedchol.py:147'),
    'rbf_covariance_pallas': ('gsum_tpu_torch/csrc/rbf_cov.cu',
                              'gsum_tpu/ops/pallas_cov.py:27'),
    # the port's own: no Pallas kernel stands behind these
    'incbeta.betainc': (
        'gsum_tpu_torch/csrc/incbeta.cu',
        "not a Pallas kernel: XLA's betainc (jax._src.lax.special."
        'regularized_incomplete_beta_impl), taken by gsum_tpu/stats/'
        '__init__.py:24'),
    'incbeta.betaincinv': (
        'gsum_tpu_torch/csrc/incbeta.cu',
        "not a Pallas kernel: gsum_tpu/stats/_special.py:33 with XLA's "
        'betainc inside'),
}


def flops_chol_logpdf(B, N, d, m):
    """FLOP count for covariance build + Cholesky + triangular solve + logdet
    (the formula of ``bench.flops_chol_logpdf``)."""
    cov = B * (2.0 * N * N * d + 6.0 * N * N)
    chol = B * (N ** 3) / 3.0
    solve = B * (2.0 * N * N * m)
    return cov + chol + solve


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """Least time in ms on the card for this many bytes moved and
    operations done (f32 ones unless ``flop_rate`` says otherwise), and
    which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def bound_chol_inv(b, nb):
    """K1: reads A's lower triangle, writes L and L⁻¹ (upper triangles
    zeroed); nb³/3 flops for L, nb³/3 for L⁻¹."""
    return bound(4 * b * (nb * (nb + 1) // 2 + 2 * nb * nb),
                 b * 2.0 * nb ** 3 / 3)


def bound_rbf(b, n, d, itemsize=4):
    """K2: reads X, writes K; 3d flops of differences and squares and 3 for
    the scale, exp and amplitude per element (counted at the f32 rate)."""
    return bound(itemsize * (b * n * d + b * n * n),
                 b * n * n * (3.0 * d + 3))


def flops_fused(b, n, blk):
    """K3's work as the function needs it, not as the kernel's algorithm
    does it: a Cholesky factor (n³/3) and the inverses of its n/blk
    triangular diagonal blocks (blk³/3 each), for each of b matrices."""
    return b * (n ** 3 / 3.0 + (n // blk) * blk ** 3 / 3.0)


def bound_fused(b, n, blk):
    """K3: reads K's lower triangle, writes L's lower triangle and the
    diagonal-block inverses."""
    tri = n * (n + 1) // 2
    return bound(4 * b * (2 * tri + n * blk), flops_fused(b, n, blk))


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fns, reps=1, rounds=6):
    """CUDA-event time per call of each function in ``fns`` (a dict), in ms:
    the median of ``rounds`` samples of ``reps`` calls each, taken in
    alternating order (a b c, c b a, ...) after one warm-up call each, so
    that clock and cache drift falls on all of them alike."""
    names = list(fns)
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    samples = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[name]()
            stop.record()
            stop.synchronize()
            samples[name].append(start.elapsed_time(stop) / reps)
    return {name: statistics.median(v) for name, v in samples.items()}


def spd_blocks(rng, b, nb, device):
    A = rng.randn(b, nb, nb)
    K = A @ np.swapaxes(A, -1, -2) / nb + np.eye(nb)
    return torch.tensor(K, dtype=torch.float32, device=device)


def spd_device(b, n, device, seed):
    """(b, n, n) f32 ``A Aᵀ/n + I`` from a seeded generator on the card
    (condition number below 5); only the lower triangle is read."""
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn(b, n, n, device=device, generator=gen)
    K = torch.matmul(A, A.transpose(-1, -2)).div_(n)
    K.diagonal(dim1=-2, dim2=-1).add_(1.0)
    return K


def flagged(L):
    """Per matrix: True where the factor's diagonal is finite and positive."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return (torch.isfinite(d) & (d > 0)).all(-1).tolist()


def check_kernel(rng, device):
    from gsum_tpu_torch.ops import chol_inv_block, chol_inv_block_plain

    for nb in NB_CHECK:
        for b in (16, 1):
            K = spd_blocks(rng, b, nb, device)
            L, Minv = chol_inv_block(K)
            Lp, Mp = chol_inv_block_plain(K)
            torch.cuda.synchronize()
            Lref = torch.linalg.cholesky(K.double())
            scale = Lref.abs().max().item()
            err_ref = (L.double() - Lref).abs().max().item() / scale
            err_plain = (L - Lp).abs().max().item() / scale
            err_m = (Minv - Mp).abs().max().item() / Mp.abs().max().item()
            eye = torch.eye(nb, dtype=torch.float64, device=device)
            resid = (L.double() @ Minv.double() - eye).abs().max().item()
            print(f'kernel nb={nb} B={b}: |L-L64|/max|L|={err_ref:.3e} '
                  f'|L-Lplain|/max|L|={err_plain:.3e} '
                  f'|M-Mplain|/max|M|={err_m:.3e} |LM-I|={resid:.3e}')
            if not (err_ref < 1e-5 and err_plain < 2e-5 and err_m < 1e-4
                    and resid < 1e-4):
                raise AssertionError(f'kernel disagrees at nb={nb} B={b}')
            if torch.triu(L, 1).any() or torch.triu(Minv, 1).any():
                raise AssertionError(f'nonzero upper triangle at nb={nb}')

            K[-1, 5, 5] = -1.0
            L, _ = chol_inv_block(K)
            ok = flagged(L)
            torch.cuda.synchronize()
            if ok != [True] * (b - 1) + [False]:
                raise AssertionError(f'non-SPD block not flagged at nb={nb} '
                                     f'B={b}: {ok}')


def check_rbf(device):
    """K2 against its plain version: the same direct-difference form, so
    they differ by the rounding of exp and of a fused multiply-add; values
    are at most amp + noise = 1.01."""
    from gsum_tpu_torch.ops import (rbf_covariance_pallas,
                                    rbf_covariance_pallas_plain)

    rng = np.random.RandomState(1)
    for shape, dtype, atol in (((B, N, D), torch.float32, 1e-6),
                               ((3, 1000, 3), torch.float32, 1e-6),
                               ((2, 512, 1), torch.float64, 1e-14),
                               ((2, 4097, 2), torch.float64, 1e-14)):
        X = torch.tensor(rng.rand(*shape), dtype=dtype, device=device)
        before = rbf_covariance_pallas.launches
        K = rbf_covariance_pallas(X, LS, AMP, NOISE)
        torch.cuda.synchronize()
        launched = rbf_covariance_pallas.launches - before
        err = (K - rbf_covariance_pallas_plain(X, LS, AMP, NOISE)
               ).abs().max().item()
        symmetric = torch.equal(K, K.mT)
        print(f'rbf_covariance_pallas {shape} {dtype}: max |K-Kplain| '
              f'{err:.3e} (limit {atol:g}), K == K.mT {symmetric}, '
              f'launches {launched}')
        if launched != 1 or not err <= atol or not symmetric:
            raise AssertionError(f'rbf_covariance_pallas disagrees at {shape}')
        del K


def check_fused(device):
    """K3 against its plain version and an f64 factor, on well-conditioned
    matrices: tril(L) within 1e-5·max|L| of the f64 factor and 2e-5·max|L|
    of the plain version, L_kk·minvs[k] = I to 1e-4, one launch per call."""
    from gsum_tpu_torch.ops import (fused_blocked_cholesky,
                                    fused_blocked_cholesky_plain)

    for b, n in ((2, 1024), (B, N)):
        K = spd_device(b, n, device, seed=n)
        before = fused_blocked_cholesky.launches
        L, minvs = fused_blocked_cholesky(K)
        torch.cuda.synchronize()
        launched = fused_blocked_cholesky.launches - before
        L.tril_()
        Lp, _ = fused_blocked_cholesky_plain(K)
        err_plain = (L - Lp).abs().max().item()
        del Lp
        Lref = torch.linalg.cholesky(K.double())
        scale = Lref.abs().max().item()
        err_ref = (L.double() - Lref).abs().max().item() / scale
        del Lref
        blk = minvs.shape[-1]
        eye = torch.eye(blk, dtype=torch.float64, device=device)
        resid = max((L[:, k * blk:(k + 1) * blk, k * blk:(k + 1) * blk]
                     .double() @ minvs[:, k].double() - eye).abs().max().item()
                    for k in range(n // blk))
        print(f'fused_blocked_cholesky B={b} N={n} block={blk}: '
              f'|L-L64|/max|L|={err_ref:.3e} |L-Lplain|/max|L|='
              f'{err_plain / scale:.3e} max|Lkk Mk - I|={resid:.3e} '
              f'launches {launched}')
        if not (launched == 1 and err_ref < 1e-5
                and err_plain < 2e-5 * scale and resid < 1e-4):
            raise AssertionError(f'fused kernel disagrees at B={b} N={n}')
        del L, minvs

    K = spd_device(2, 1024, device, seed=1)
    K[-1, 5, 5] = -1.0
    L, _ = fused_blocked_cholesky(K, tril=True)
    ok = flagged(L)
    if ok != [True, False] or not torch.isfinite(L[0]).all():
        raise AssertionError(f'non-SPD matrix not flagged by the fused '
                             f'kernel: {ok}')


INCBETA_TOL = {torch.float64: {'betainc': 1e-13, 'betaincinv': 1e-11},
               torch.float32: {'betainc': 1e-5, 'betaincinv': 1e-5}}
def check_incbeta(device):
    """The incomplete-beta kernels against their plain versions on the card,
    f64 and f32, on ``time_incbeta.check_cases``: one launch a slice, the
    plain version once over each case's elements.  Returns the largest
    absolute differences in f64 by kernel."""
    from gsum_tpu_torch.ops import incbeta
    from gsum_tpu_torch.stats._special import betainc_plain, betaincinv_plain
    from gsum_tpu_torch.time_incbeta import check_cases
    from gsum_tpu_torch.time_incbeta import rel_err as incbeta_err

    plain = {'betainc': betainc_plain, 'betaincinv': betaincinv_plain}
    worst = {}
    for dtype in (torch.float64, torch.float32):
        for which, slices in check_cases(dtype, device).items():
            a, b, u = (torch.cat(v) for v in zip(*slices))
            forms = sorted({incbeta.form(s[2]) for s in slices})
            for name, fn in plain.items():
                kernel = getattr(incbeta, name)
                before = kernel.launches
                got = torch.cat([kernel(*s) for s in slices])
                torch.cuda.synchronize()
                launched = kernel.launches - before
                rel, ab = incbeta_err(got, fn(a, b, u))
                tol = INCBETA_TOL[dtype][name]
                print(f'incbeta.{name} {which} {tuple(a.shape)} {dtype} '
                      f'(form {"/".join(("thread", "warp")[f] for f in forms)}'
                      f'): max rel diff vs plain {rel:.3e} (limit {tol:g}), '
                      f'max abs diff {ab:.3e}, launches {launched}, '
                      f'finite {torch.isfinite(got).all().item()}')
                if launched != len(slices) or not rel <= tol:
                    raise AssertionError(f'incbeta.{name} disagrees with its '
                                         f'plain version ({which}, {dtype})')
                if dtype == torch.float64:
                    worst[name] = max(worst.get(name, 0.0), ab)
    return worst


def reference_logpdf(X, y, noise=NOISE):
    """Plain f64 pipeline, independent of the port: covariance from direct
    distances, torch.linalg.cholesky, triangular solve."""
    X, y = X.double(), y.double()
    d2 = torch.cdist(X / LS, X / LS).square_()
    K = AMP * torch.exp(-0.5 * d2)
    del d2
    K.diagonal(dim1=-2, dim2=-1).add_(noise)
    L = torch.linalg.cholesky(K)
    del K
    w = torch.linalg.solve_triangular(L, y, upper=False)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * ((w * w).sum(-2) + logdet[:, None]
                   + X.shape[-2] * math.log(2 * math.pi))


def max_rel(a, ref):
    """The largest element-wise |a − ref| / |ref|, on the host in f64 (NaN
    where either is NaN)."""
    a, ref = (torch.as_tensor(t).double().cpu().reshape(-1)
              for t in (a, ref))
    return ((a - ref).abs() / ref.abs().clamp_min(1e-300)).max().item()


def rel_err(a, ref, band=0.0):
    """max |a − ref| / max |ref|: the error against the result's own scale
    (element-wise ratios blow up where a curve crosses zero); a predicted
    mean against its band's scale too (``band``, the largest std), since a
    mean near 0 is the remainder of a cancellation."""
    a, ref = (torch.as_tensor(v).detach().double().cpu() for v in (a, ref))
    scale = max(ref.abs().max().item(), float(band))
    # an all-zero result (the unconstrained truncation mean at center 0)
    # is held absolutely
    return ((a - ref).abs().max() / (scale if scale > 0 else 1)).item()


def gp_data():
    """The single-model path's data: N points in the unit square and, per
    curve k (an EFT order), sin(3x₀ + k)·cos(2x₁) + 0.01·ε; 512 new points."""
    rng = np.random.RandomState(0)
    X = rng.rand(GP_N, GP_D)
    y = np.stack([np.sin(3 * X[:, 0] + k) * np.cos(2 * X[:, 1])
                  for k in range(GP_CURVES)], axis=1) \
        + 0.01 * rng.randn(GP_N, GP_CURVES)
    return X, y, rng.rand(GP_NEW, GP_D)


def counted_lbfgsb(evaluations):
    """The models' optimizer, scipy_lbfgsb, with its evaluations appended to
    ``evaluations``; an abnormal end (warnflag ≠ 0, a ConvergenceWarning)
    raises."""
    from gsum_tpu_torch.optimize import ConvergenceWarning, scipy_lbfgsb

    def optimizer(obj_func, theta0, bounds):
        def counted(theta):
            evaluations.append(theta)
            return obj_func(theta)
        with warnings.catch_warnings():
            warnings.simplefilter('error', ConvergenceWarning)
            return scipy_lbfgsb(counted, theta0, bounds)
    return optimizer


def gp_model(device, **kw):
    from gsum_tpu_torch import RBF, ConjugateGaussianProcess, WhiteKernel

    kernel = kw.pop('kernel', None) or \
        RBF(0.3, (1e-2, 10)) + WhiteKernel(1e-4, (1e-8, 1e-1))
    return ConjugateGaussianProcess(kernel, center=0, disp=0, df=3, scale=1,
                                    device=device, **kw)


def single_model_path(card):
    """Path 3: ConjugateGaussianProcess fit and predict at N=4096 in f64 on
    the card, checked against the same calls of the port on the CPU (at the
    fitted θ) and against ``chol_engine='blocked'``; then the flagship step
    at N=4096 against its CPU run.  Returns the launch counts."""
    from gsum_tpu_torch.entry import flagship_step

    X, y, Xnew = gp_data()
    evaluations = []
    gp = gp_model('cuda', optimizer=counted_lbfgsb(evaluations))
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def run():
        start.record()
        gp.fit(X, y)
        stop.record()
        return gp.predict(Xnew, return_std=True), gp.predict(Xnew,
                                                            return_cov=True)
    ((m, sd), (_, cov)), counts = drive(run)
    fit_ms = start.elapsed_time(stop)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    theta = gp.kernel_.theta
    lo, hi = gp.kernel_.bounds.T
    print(f'main path (single model): ConjugateGaussianProcess N={GP_N} '
          f'd={GP_D} curves={GP_CURVES} f64: fit {fit_ms:.1f} ms over '
          f'{len(evaluations)} evaluations, θ = {theta.tolist()} (bounds '
          f'{gp.kernel_.bounds.tolist()}), lml '
          f'{gp.log_marginal_likelihood_value_:.10g}, peak memory '
          f'{peak_gib:.2f} GiB, launches {counts}')
    if any(counts.values()):
        raise AssertionError(f'the f64 model launched a kernel: {counts}')
    if not np.all((lo <= theta) & (theta <= hi)):
        raise AssertionError('fitted θ outside its bounds')
    if not (m.shape == (GP_NEW, GP_CURVES) and sd.shape == (GP_NEW,)
            and cov.shape == (GP_NEW, GP_NEW) and torch.isfinite(m).all()
            and torch.isfinite(sd).all() and torch.isfinite(cov).all()):
        raise AssertionError('bad predictions from the single model')

    cpu = gp_model('cpu', kernel=gp.kernel_.clone(), optimizer=None).fit(X, y)
    lml, grad = gp.log_marginal_likelihood(theta, True)
    lml_c, grad_c = cpu.log_marginal_likelihood(theta, True)
    # the fit drives the gradient to zero, so its error is measured against
    # the gradient's scale where the fit starts, and there as is
    theta0 = gp.kernel.theta
    grad0 = gp.log_marginal_likelihood(theta0, True)[1]
    grad0_c = cpu.log_marginal_likelihood(theta0, True)[1]
    m_c, sd_c = cpu.predict(Xnew, return_std=True)
    blocked = gp_model('cuda', chol_engine='blocked').log_marginal_likelihood(
        theta, X=X, y=y)
    errs = {'lml': rel_err(lml, lml_c),
            'gradient at the start': rel_err(grad0, grad0_c),
            'gradient at the fitted θ (by the start gradient)':
            ((grad.cpu() - grad_c).abs().max() / grad0_c.abs().max()).item(),
            'mean': rel_err(m, m_c), 'std': rel_err(sd, sd_c),
            "chol_engine='blocked' lml": rel_err(blocked, lml)}
    print(f'main path (single model): gradient at the start θ '
          f'{theta0.tolist()}: {grad0_c.tolist()}, at the fitted θ: card '
          f'{grad.tolist()}, CPU {grad_c.tolist()}')
    print('main path (single model): card vs CPU: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (limits: gradients {GP_GRAD_TOL:g}, others {GP_TOL:g})')
    if not all(v <= (GP_GRAD_TOL if k.startswith('gradient') else GP_TOL)
               for k, v in errs.items()):
        raise AssertionError('the single model on the card disagrees with '
                             'the CPU')

    # the flagship step at full width, at a fixed θ
    theta_f = np.log(FLAGSHIP_THETA)
    ys = y                                   # 5 curves
    outs = []
    for dev in ('cuda', 'cpu'):
        step = flagship_step(dev)[0]
        th = torch.tensor(theta_f, device=dev, requires_grad=True)
        m_f, K_f, lml_f = step(th, X, ys, Xnew)
        (g_f,) = torch.autograd.grad(lml_f, th)
        # far from the data K_pred is the prior covariance: the scale of
        # the two terms whose difference K_pred is
        prior = step(theta_f, X, ys, Xnew + 1e3)[1].abs().max()
        outs.append((m_f, K_f, lml_f, g_f, prior))
    (m_g, K_g, l_g, g_g, _), (m_c, K_c, l_c, g_c, prior) = outs
    errs = {'m_pred': rel_err(m_g, m_c),
            'K_pred (by the prior scale)': ((K_g.cpu() - K_c).abs().max()
                                            / prior).item(),
            'lml': rel_err(l_g, l_c), 'gradient': rel_err(g_g, g_c)}
    print(f'main path (flagship): flagship_step N={GP_N} new={GP_NEW} '
          f'θ=log{FLAGSHIP_THETA}: lml {l_g.item():.10g}, card vs CPU: '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()))
    if not (errs['gradient'] <= GP_GRAD_TOL
            and all(v <= GP_TOL for k, v in errs.items() if k != 'gradient')):
        raise AssertionError('the flagship step on the card disagrees with '
                             'the CPU')
    del cpu, outs
    return gp, Xnew, counts


def time_single_model(gp, Xnew, card):
    X, y, _ = gp_data()
    theta = gp.kernel_.theta
    t = time_ms({'lml + gradient': lambda: gp.log_marginal_likelihood(
                     theta, True),
                 'lml': lambda: gp.log_marginal_likelihood(theta),
                 'predict std': lambda: gp.predict(Xnew, return_std=True),
                 'predict cov': lambda: gp.predict(Xnew, return_cov=True)})
    fit = gp_model('cuda')
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fit.fit(X, y)
    stop.record()
    stop.synchronize()
    print(f'timing [{card}] single model N={GP_N} f64: fit '
          f'{start.elapsed_time(stop):.1f} ms (host clock '
          f'{(time.perf_counter() - t0) * 1e3:.1f} ms; a second fit, '
          f'from the same start), '
          + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
    profile(f'single model lml + gradient N={GP_N} f64 [{card}]',
            lambda: gp.log_marginal_likelihood(theta, True))


def blocked_grads(route, K, Y, G, g):
    """(K̄ symmetrized, Ȳ) of ⟨x, G⟩ + ⟨logdet, g⟩, x = K⁻¹Y, through one
    route; and the launch counts of its forward and of its backward."""
    from gsum_tpu_torch.ops import (batched_blocked_cholesky,
                                    blocked_spd_solve_logdet)

    K = K.detach().requires_grad_(True)
    Y = Y.detach().requires_grad_(True)

    def forward():
        if route == 'blocked_spd_solve_logdet':
            x, logdet, ok = blocked_spd_solve_logdet(K, Y, block=128)
            if not ok.all():
                raise AssertionError('blocked_spd_solve_logdet failed')
        else:
            L = (batched_blocked_cholesky(K, block=256)
                 if route == 'batched_blocked_cholesky'
                 else torch.linalg.cholesky_ex(K).L)
            x = torch.cholesky_solve(Y, L)
            logdet = 2 * torch.log(torch.diagonal(L, dim1=-2,
                                                  dim2=-1)).sum(-1)
        return (x * G.to(x.dtype)).sum() + (logdet * g.to(x.dtype)).sum()

    loss, fwd = drive(forward)
    (Kbar, Ybar), bwd = drive(lambda: torch.autograd.grad(loss, (K, Y)))
    return (0.5 * (Kbar + Kbar.mT), Ybar), fwd, bwd


def rel_fro(a, ref):
    """The largest per-matrix relative Frobenius distance."""
    d = (a.double() - ref).flatten(1).norm(dim=1)
    return (d / ref.flatten(1).norm(dim=1)).max().item()


def blocked_autograd_path(X, y, card):
    """Path 4: the differentiable blocked functions in f32 at the headline
    size, their K1 launches, and their gradients against an f64
    ``torch.linalg`` autograd reference (the 10× rule) and in f64."""
    from gsum_tpu_torch.ops import rbf_covariance

    K = rbf_covariance(X, LS, AMP, NOISE)
    gen = torch.Generator(device=X.device).manual_seed(5)
    G = torch.randn(B, N, M, generator=gen, device=X.device)
    g = torch.randn(B, generator=gen, device=X.device)
    ref, _, _ = blocked_grads('torch.linalg', K.double(), y.double(), G, g)
    f32, _, _ = blocked_grads('torch.linalg', K, y, G, g)
    err32 = [rel_fro(a, r) for a, r in zip(f32, ref)]
    del f32
    print(f'main path (blocked autograd): f32 torch.linalg autograd route vs '
          f'f64 reference: K̄ {err32[0]:.3e}, Ȳ {err32[1]:.3e} (largest '
          f'per-matrix relative Frobenius distance)')
    launches = {}
    for route, want in (('blocked_spd_solve_logdet', N // 128),
                        ('batched_blocked_cholesky', N // 256)):
        got, fwd, bwd = blocked_grads(route, K, y, G, g)
        err = [rel_fro(a, r) for a, r in zip(got, ref)]
        del got
        got64, fwd64, bwd64 = blocked_grads(route, K.double(), y.double(), G,
                                            g)
        err64 = [rel_fro(a, r) for a, r in zip(got64, ref)]
        del got64
        launches[route] = fwd['chol_inv_block'], bwd['chol_inv_block']
        print(f'main path (blocked autograd): {route} f32 B={B} N={N}: '
              f'launches forward {fwd}, backward {bwd}; vs f64 reference '
              f'K̄ {err[0]:.3e}, Ȳ {err[1]:.3e} (limit 10× the f32 '
              f'torch.linalg route); f64 (diag=recursive): K̄ '
              f'{err64[0]:.3e}, Ȳ {err64[1]:.3e} (limit 1e-9), launches '
              f'{fwd64} / {bwd64}')
        if launches[route] != (want, 0) or any(fwd64.values()) \
                or any(bwd.values()) or any(bwd64.values()):
            raise AssertionError(f'{route}: expected {want} chol_inv_block '
                                 f'launches in the forward and none in the '
                                 f'backward, got {fwd} / {bwd}')
        if not (all(e <= 10 * e32 for e, e32 in zip(err, err32))
                and all(e <= 1e-9 for e in err64)):
            raise AssertionError(f'{route}: gradients disagree with the f64 '
                                 f'reference')
    del ref

    def fwd_bwd(route, K, Y):
        return lambda: blocked_grads(route, K, Y, G, g)
    t = time_ms({'blocked_spd_solve_logdet (K1, block 128)':
                 fwd_bwd('blocked_spd_solve_logdet', K, y),
                 'batched_blocked_cholesky (K1, block 256) + cholesky_solve':
                 fwd_bwd('batched_blocked_cholesky', K, y),
                 'torch.linalg cholesky_ex + cholesky_solve':
                 fwd_bwd('torch.linalg', K, y)}, rounds=4)
    print(f'timing [{card}] blocked autograd f32 B={B} N={N} m={M}, forward '
          f'+ backward: ' + ', '.join(f'{k} {v:.3f} ms'
                                      for k, v in t.items()))
    profile(f'blocked_spd_solve_logdet forward + backward [{card}]',
            fwd_bwd('blocked_spd_solve_logdet', K, y))
    return launches


TRUNC_PRIORS = {'TruncationGP': dict(center=0, disp=0, df=3, scale=1),
                'TruncationTP': dict(center=0, disp=1, df=5, scale=1)}
KINDS = ('both', 'interp', 'trunc')


def trunc_model(name, device, kernel=None, **kw):
    """Path 5's TruncationGP or TruncationTP on ``device``: path 3's kernel
    (or ``kernel``), ratio 0.5, ref 10."""
    import gsum_tpu_torch as gt

    if kernel is None:
        kernel = gt.RBF(0.3, (1e-2, 10)) + gt.WhiteKernel(1e-4, (1e-8, 1e-1))
    return getattr(gt, name)(kernel, ratio=TRUNC_RATIO, ref=TRUNC_REF,
                             device=device, **TRUNC_PRIORS[name], **kw)


def trunc_data(device):
    """Path 5's data: path 3's X, its curves as the coefficients c₀…c₄ and
    their partial sums y (``helpers.partials``, ratio 0.5, ref 10), the 512
    new points and 16 constraint points on the edge x₀ = 1."""
    from gsum_tpu_torch.helpers import partials

    X, c, Xnew = gp_data()
    c = torch.tensor(c, device=device)
    y = partials(c, ratio=TRUNC_RATIO, ref=TRUNC_REF)
    dX = np.stack([np.ones(TRUNC_EDGE), np.linspace(0, 1, TRUNC_EDGE)], 1)
    return X, c, y, Xnew, dX


def ladder(M):
    """robust_cholesky's choice for M, recomputed (the function returns only
    ``(L, ok)``): the index of the first rung of the jitter ladder that
    factors M, and the jitter added there (the rung's times max diag M)."""
    s = torch.diagonal(M).max().item()
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    rung = next((i for i, j in enumerate(JITTERS)
                 if torch.linalg.cholesky_ex(M + (j * s) * eye).info.item()
                 == 0), len(JITTERS))
    return rung, JITTERS[min(rung, len(JITTERS) - 1)] * s


def jittered_cond(M, jitter):
    """The condition number of M + jitter·I, (λmax + j) / (max(λmin, 0) + j)."""
    ev = torch.linalg.eigvalsh(M)
    return (ev[-1].item() + jitter) / (max(ev[0].item(), 0.0) + jitter)


def cond_tol(cond):
    """Card-vs-CPU limit of a result that goes through a solve with a matrix
    of condition number ``cond``: cond·ε, the first-order bound on the
    relative error of a backward-stable solve (at least GP_TOL)."""
    return max(GP_TOL, cond * torch.finfo(torch.float64).eps)


def truncation_path(gp, card, device='cuda'):
    """Path 5: TruncationGP and TruncationTP at path 3's width (N=4096, d=2,
    5 orders, f64) on the card: fit, the three predict kinds with std and
    with cov, the lml + gradient at the start θ and at another ratio, and
    the band constrained to 0 on the edge x₀ = 1; checked against path 3's
    model (``gp``) and against the same calls of the port on the CPU.
    Returns the fitted models."""
    t_path = time.perf_counter()
    X, c, y, Xnew, dX = trunc_data(device)
    orders = np.arange(GP_CURVES)
    Xcon = np.concatenate([Xnew, dX])       # the constraint points last
    evaluations = {}
    events = {}

    def run():
        out = {}
        for name in TRUNC_PRIORS:
            evaluations[name] = []
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            m = trunc_model(name, device,
                            optimizer=counted_lbfgsb(evaluations[name]))
            m.fit(X, y, orders=orders)
            stop.record()
            events[name] = (start, stop)
            out[name] = m
            for kind in KINDS:
                for ret in ('std', 'cov'):
                    out[name, kind, ret] = m.predict(
                        Xnew, order=TRUNC_ORDER, kind=kind,
                        **{'return_' + ret: True})
            theta0 = m.coeffs_process.kernel.theta
            out[name, 'lml0'] = m.log_marginal_likelihood(theta0, True)
            out[name, 'lml_kw'] = m.log_marginal_likelihood(
                theta0, True, ratio=TRUNC_RATIO_KW)
            mc = trunc_model(name, device,
                             kernel=m.coeffs_process.kernel_.clone(),
                             optimizer=None)
            mc.fit(X, y, orders=orders, dX=dX, dy=0)
            out[name, 'con'] = mc
            for kind in ('trunc', 'both'):
                out[name, kind, 'con'] = mc.predict(
                    Xcon, order=TRUNC_ORDER, kind=kind, return_std=True)
        return out

    torch.cuda.reset_peak_memory_stats()
    out, counts = drive(run)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in TRUNC_PRIORS:
        m = out[name]
        start, stop = events[name]
        print(f'main path (truncation): {name} N={GP_N} d={GP_D} orders='
              f'{GP_CURVES} f64: first fit {start.elapsed_time(stop):.1f} ms '
              f'over {len(evaluations[name])} evaluations, θ = '
              f'{m.coeffs_process.kernel_.theta.tolist()}, lml '
              f'{m.coeffs_process.log_marginal_likelihood_value_:.10g}')
    print(f'main path (truncation): launches {counts}, peak memory '
          f'{peak_gib:.2f} GiB')
    if any(counts.values()):
        raise AssertionError(f'the f64 truncation models launched a kernel: '
                             f'{counts}')

    # consistency of the port with itself, on the card
    tgp = out['TruncationGP']
    theta = tgp.coeffs_process.kernel_.theta
    change = GP_N * (GP_CURVES * math.log(TRUNC_REF)
                     + orders.sum() * math.log(TRUNC_RATIO))
    lml = tgp.log_marginal_likelihood(theta)
    lml3 = gp.log_marginal_likelihood(theta)
    lml_kw = tgp.log_marginal_likelihood(theta, ratio=TRUNC_RATIO_KW)
    own = {'coeffs_ vs c': rel_err(tgp.coeffs_, c),
           "θ vs path 3's (abs)": float(np.abs(theta - gp.kernel_.theta).max()),
           "lml vs path 3's lml − N(5 log ref + 10 log ratio)":
           abs(lml.item() - (lml3.item() - change)) / abs(lml.item())}
    print('main path (truncation): TruncationGP against path 3: '
          + ', '.join(f'{k} {v:.3e}' for k, v in own.items())
          + f' (limits 1e-12, 1e-5, {GP_TOL:g}); lml at ratio '
          f'{TRUNC_RATIO_KW} {lml_kw.item():.10g}, at {TRUNC_RATIO} '
          f'{lml.item():.10g}')
    if not (own['coeffs_ vs c'] <= 1e-12
            and own["θ vs path 3's (abs)"] <= 1e-5
            and own["lml vs path 3's lml − N(5 log ref + 10 log ratio)"]
            <= GP_TOL
            and math.isfinite(lml_kw.item()) and lml_kw.item() != lml.item()):
        raise AssertionError('the truncation GP disagrees with path 3')
    for key, val in out.items():
        if isinstance(key, tuple) and key[1] in KINDS:
            shapes = [tuple(v.shape) for v in val]
            n = len(Xcon) if key[2] == 'con' else GP_NEW
            want = [(n,), (n,) if key[2] != 'cov' else (n, n)]
            if shapes != want or not all(torch.isfinite(v).all()
                                         for v in val):
                raise AssertionError(f'bad prediction {key}: {shapes}')

    # card against CPU, at the card's fitted kernels
    errs, limits, rungs = {}, {}, {}
    for name in TRUNC_PRIORS:
        m = out[name]
        kernel = m.coeffs_process.kernel_.clone()
        cpu = trunc_model(name, 'cpu', kernel=kernel, optimizer=None)
        cpu.fit(X, y.cpu(), orders=orders)
        theta0 = m.coeffs_process.kernel.theta
        for key, kw in (('lml0', {}), ('lml_kw', {'ratio': TRUNC_RATIO_KW})):
            lml_c, grad_c = cpu.log_marginal_likelihood(theta0, True, **kw)
            lml_g, grad_g = out[name, key]
            where = 'start θ' + (f', ratio {TRUNC_RATIO_KW}' if kw else '')
            errs[name, f'lml ({where})'] = rel_err(lml_g, lml_c)
            limits[name, f'lml ({where})'] = GP_TOL
            errs[name, f'gradient ({where})'] = rel_err(grad_g, grad_c)
            limits[name, f'gradient ({where})'] = GP_GRAD_TOL
        K_g = m.cov(X, X, start=0, end=TRUNC_ORDER)
        rung_g, jitter = ladder(K_g)
        cond = jittered_cond(K_g, jitter)
        del K_g
        rung_c = ladder(cpu.cov(X, X, start=0, end=TRUNC_ORDER))[0]
        rungs[name] = (rung_g, rung_c, cond)
        for kind in KINDS:
            m_c, sd_c = cpu.predict(Xnew, order=TRUNC_ORDER, kind=kind,
                                    return_std=True)
            cov_c = cpu.predict(Xnew, order=TRUNC_ORDER, kind=kind,
                                return_cov=True)[1]
            (m_g, sd_g), (_, cov_g) = (out[name, kind, 'std'],
                                       out[name, kind, 'cov'])
            errs[name, f'{kind} mean'] = rel_err(m_g, m_c, sd_c.max())
            errs[name, f'{kind} std'] = rel_err(sd_g, sd_c)
            errs[name, f'{kind} cov'] = rel_err(cov_g, cov_c)
            for label in ('mean', 'std', 'cov'):
                limits[name, f'{kind} {label}'] = (
                    GP_TOL if kind == 'trunc' else cond_tol(cond))
            if kind == 'interp' and name == 'TruncationGP':
                # context: how far round-off alone moves the interpolant, on
                # one device, with the training points in another order
                perm = np.random.RandomState(1).permutation(GP_N)
                m_p, sd_p = trunc_model(
                    name, 'cpu', kernel=kernel.clone(), optimizer=None).fit(
                    X[perm], y.cpu()[perm], orders=orders).predict(
                    Xnew, order=TRUNC_ORDER, kind=kind, return_std=True)
                print(f'context: {name} interp on the CPU, points permuted '
                      f'against not: mean {rel_err(m_p, m_c, sd_c.max()):.3e}'
                      f', std {rel_err(sd_p, sd_c):.3e}')
        mc = out[name, 'con']
        cpu.fit(X, y.cpu(), orders=orders, dX=dX, dy=0)
        K_t = mc.cov(dX, dX, start=TRUNC_ORDER + 1)
        rung_t, j_t = ladder(K_t)
        cond_t = jittered_cond(K_t, j_t)
        rung_tc = ladder(cpu.cov(dX, dX, start=TRUNC_ORDER + 1))[0]
        rungs[name, 'constraint'] = (rung_t, rung_tc, cond_t)
        for kind in ('trunc', 'both'):
            want = cpu.predict(Xcon, order=TRUNC_ORDER, kind=kind,
                               return_std=True)
            tol = cond_tol(max(cond_t, cond) if kind == 'both' else cond_t)
            (m_g, sd_g), (m_c, sd_c) = out[name, kind, 'con'], want
            errs[name, f'constrained {kind} mean'] = rel_err(m_g, m_c,
                                                             sd_c.max())
            errs[name, f'constrained {kind} std'] = rel_err(sd_g, sd_c)
            for label in ('mean', 'std'):
                limits[name, f'constrained {kind} {label}'] = tol
        # at the constraint points the band's variance is pinned to the
        # jitter the ladder added: std ≤ √(j + cond_t·ε·max diag)
        std_at = out[name, 'trunc', 'con'][1][-TRUNC_EDGE:].max().item()
        s_t = torch.diagonal(K_t).max().item()
        pin = math.sqrt(j_t + cond_tol(cond_t) * s_t)
        print(f'main path (truncation): {name} constrained band: max std at '
              f'the {TRUNC_EDGE} constraint points {std_at:.3e} (limit '
              f'{pin:.3e}), max std elsewhere '
              f'{out[name, "trunc", "con"][1][:-TRUNC_EDGE].max().item():.3e}')
        if not std_at <= pin:
            raise AssertionError(f'{name}: the constrained band is not pinned')
        del cpu
    for name, (rg, rc, cond) in rungs.items():
        print(f'main path (truncation): {name} jitter ladder: card rung {rg} '
              f'(jitter {JITTERS[min(rg, 3)]:g}), CPU rung {rc}, condition '
              f'number there {cond:.3e}, limit cond·ε {cond_tol(cond):.3e}')
    for name in TRUNC_PRIORS:
        print(f'main path (truncation): {name} card vs CPU: ' + ', '.join(
            f'{k} {v:.3e} (limit {limits[n, k]:.3e})'
            for (n, k), v in errs.items() if n == name))
    bad = [key for key, v in errs.items() if not v <= limits[key]]
    if bad or any(rg != rc for rg, rc, _ in rungs.values()):
        raise AssertionError(f'the truncation models on the card disagree '
                             f'with the CPU: {bad}, rungs {rungs}')
    print(f'main path (truncation): wall time {time.perf_counter() - t_path:.1f}'
          f' s (card and CPU)')
    return out


def time_truncation(out, card, device='cuda'):
    """Path 5's times on the card: a second fit of each model from the same
    start, one lml + gradient, each predict kind with std and with cov."""
    X, _, y, Xnew, _ = trunc_data(device)
    orders = np.arange(GP_CURVES)
    for name in TRUNC_PRIORS:
        m = out[name]
        theta = m.coeffs_process.kernel_.theta
        fns = {'lml + gradient': lambda: m.log_marginal_likelihood(theta,
                                                                   True)}
        for kind in KINDS:
            for ret in ('std', 'cov'):
                fns[f'predict {kind} {ret}'] = (
                    lambda kind=kind, ret=ret: m.predict(
                        Xnew, order=TRUNC_ORDER, kind=kind,
                        **{'return_' + ret: True}))
        t = time_ms(fns, rounds=4)
        evaluations = []
        fit = trunc_model(name, device, optimizer=counted_lbfgsb(evaluations))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fit.fit(X, y, orders=orders)
        stop.record()
        stop.synchronize()
        print(f'timing [{card}] {name} N={GP_N} f64: fit '
              f'{start.elapsed_time(stop):.1f} ms over {len(evaluations)} '
              f'evaluations (a second fit, from the same start), '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
        profile(f'{name} predict both cov N={GP_N} new={GP_NEW} f64 [{card}]',
                fns['predict both cov'])


PW_PRIORS = {'df=1, scale=1': dict(df=1, scale=1),
             'df=0, excluded=[0]': dict(df=0, excluded=[0])}
PW_ALPHA = np.array([0.68, 0.95])
PW_RATIOS = np.linspace(0.3, 0.7, 1500)   # the Λ_b example's evaluations
PW_DOBS = np.linspace(0.05, 0.95, 20)
PW_BANDS = [0.68, 0.95]
PW_CPU_DOBS = [0, 10]                     # the dobs the CPU side repeats
PW_TOL = 1e-10
DIAG_STRIDE, DIAG_SAMPLES = 4, 4000
VARIO_BOUNDS = np.linspace(0.1, 0.9, 9)   # 10 bins of pair distance
VARIO_POINTS = (192, 64)                  # per-bin branch, batched branch
VARIO_CPU_BINS = 3                        # the smallest bins, on the CPU
INCBETA_TIMED = {'betainc': 'incbeta.betainc',
                 'betaincinv': 'incbeta.betaincinv'}


def pointwise_calls(device, y, y_next, dobs=None, band_dobs=None,
                    beta_band=True):
    """Path 6's calls of ``TruncationPointwise`` on ``device``: for each
    prior, fit on the partial sums y (ratio 0.5, ref 10), the intervals at
    PW_ALPHA, the logpdf of the next order's partial sums, the log
    likelihood at each of PW_RATIOS (the class's own loop) and the median
    and 68% HPD of that posterior; for the first prior
    ``credible_diagnostic`` of the order-4 partial sums at ``dobs`` with
    binomial and (``beta_band``) beta bands."""
    import gsum_tpu_torch as gt

    out = {}
    for name, prior in PW_PRIORS.items():
        m = gt.TruncationPointwise(device=device, **prior).fit(
            y, TRUNC_RATIO, TRUNC_REF)
        out[name] = m
        out[name, 'interval'] = m.interval(PW_ALPHA)
        out[name, 'logpdf'] = m.logpdf(y_next[:, None])
        ll = torch.stack([m.log_likelihood(ratio=r) for r in PW_RATIOS])
        post = torch.exp(ll - ll.max())
        post = post / torch.trapezoid(post, torch.tensor(PW_RATIOS,
                                                         device=device))
        out[name, 'loglike'] = ll
        out[name, 'hpd_pdf'] = gt.hpd_pdf(post, 0.68, PW_RATIOS)
        out[name, 'median_pdf'] = gt.median_pdf(post, PW_RATIOS)
    m = out['df=1, scale=1']
    data = y[:, -1]
    dobs = PW_DOBS if dobs is None else dobs
    band_dobs = dobs if band_dobs is None else band_dobs
    out['binom'] = m.credible_diagnostic(data, dobs, PW_BANDS, band_dobs,
                                         beta=False)
    if beta_band:
        out['beta'] = m.credible_diagnostic(data, dobs, PW_BANDS, band_dobs)
    return out


def diagnostic_calls(mean, cov, df, y, device):
    """Path 6's calls of ``Diagnostic`` on ``device``: construction (with the
    pivoted Cholesky and eigh), samples, every error kind, the squared
    Mahalanobis distance, the coverage at PW_DOBS, and the KL divergence
    from (mean, cov)."""
    from gsum_tpu_torch import Diagnostic

    d = Diagnostic(mean, cov, df=df, device=device)
    out = {'diag': d, 'samples': d.samples(DIAG_SAMPLES)}
    for name in ('individual_errors', 'cholesky_errors',
                 'pivoted_cholesky_errors', 'eigen_errors', 'md_squared'):
        out[name] = getattr(d, name)(y)
    out['coverage'] = d.credible_interval(y, PW_DOBS)
    return out


def vario_calls(X, c, device):
    """VariogramFourthRoot of the 5 coefficient curves at VARIO_POINTS
    points (10 bins): its bands, and which branch ``compute`` took."""
    from gsum_tpu_torch.helpers import VariogramFourthRoot

    out = {}
    for n in VARIO_POINTS:
        v = VariogramFourthRoot(X[:n], c[:n].mT, VARIO_BOUNDS, device=device)
        idx, _ = v._bin_pair_indices()
        out[n] = (v, v.compute(), v.Nb * idx.shape[1] ** 2 * v.Ncurves > 3e7)
    return out


def whitened_err(got, want, md2, eigvals=None):
    """Card against CPU for whitened errors that are a square root's choice:
    each curve's sum of squares is the squared Mahalanobis distance md2;
    with ``eigvals``, the rows (eigen errors) whose eigenvalue stands apart
    (gap >= 1e-3 of the largest) too, up to their sign, their error scaled
    by gap / largest eigenvalue (an eigenvector's condition)."""
    got, want = got.double().cpu(), want.double().cpu()
    errs = [rel_err(torch.sum(got ** 2, 0), md2)]
    if eigvals is not None:
        e = eigvals.double().cpu()
        gaps = torch.stack([torch.min(torch.abs(torch.cat([e[:i], e[i + 1:]])
                                                - e[i]))
                            for i in range(len(e))]) / e[0]
        apart = torch.nonzero(gaps >= 1e-3).flatten().tolist()
        signs = torch.sign(torch.sum(got * want, 1, keepdim=True))
        scale = want.abs().max().item()
        for i in apart:
            errs.append((signs[i] * got[i] - want[i]).abs().max().item()
                        / scale * gaps[i].item())
    return max(errs)


def model_checking_path(trunc, card, device='cuda'):
    """Path 6: the pointwise truncation model at N=4096, orders 0–4, two
    priors; Diagnostic at 1024 validation points (every fourth of path 5's
    X) for path 5's fitted TruncationGP and TruncationTP coefficient
    processes; VariogramFourthRoot of the 5 curves at 192 points (the
    per-bin branch) and 64 points (the batched branch).  Checked against the
    same calls on the CPU.  Returns the launch counts."""
    t_path = time.perf_counter()
    X, c, y, _, _ = trunc_data(device)
    x0, x1 = X[:, 0], X[:, 1]
    c_next = np.sin(3 * x0 + GP_CURVES) * np.cos(2 * x1)
    y_next = y[:, -1] + TRUNC_REF * TRUNC_RATIO ** GP_CURVES * torch.tensor(
        c_next, device=device)
    Xv = X[::DIAG_STRIDE]
    cv = c[::DIAG_STRIDE]
    moments = {}
    for name in TRUNC_PRIORS:
        cp = trunc[name].coeffs_process
        moments[name] = (cp.mean(Xv), cp.cov(Xv),
                         None if name == 'TruncationGP' else cp.df_)
    events = {k: (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
              for k in ('pointwise', 'diagnostic', 'variogram')}

    def run():
        out = {}
        a, b = events['pointwise']
        a.record()
        out['pointwise'] = pointwise_calls(device, y, y_next)
        b.record()
        a, b = events['diagnostic']
        a.record()
        for name, (mean, cov, df) in moments.items():
            out[name] = diagnostic_calls(mean, cov, df, cv, device)
        b.record()
        a, b = events['variogram']
        a.record()
        out['variogram'] = vario_calls(X, c, device)
        b.record()
        return out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, counts = drive(run)
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'main path (model checking): N={GP_N} orders={GP_CURVES}, '
          f'Diagnostic at {len(Xv)} points, variogram at {VARIO_POINTS} '
          f'points: launches {counts}, peak memory {peak_gib:.2f} GiB, wall '
          f'{wall:.2f} s (' + ', '.join(
              f'{k} {a.elapsed_time(b):.1f} ms' for k, (a, b) in
              events.items()) + ')')
    if not (counts['incbeta.betainc'] and counts['incbeta.betaincinv']):
        raise AssertionError(f'path 6 did not launch both incbeta kernels: '
                             f'{counts}')
    errs, limits = {}, {}

    # the pointwise model, card against CPU
    pw = out['pointwise']
    y_c, y_next_c = y.cpu(), y_next.cpu()
    cpu = pointwise_calls('cpu', y_c, y_next_c,
                          dobs=PW_DOBS[PW_CPU_DOBS],
                          band_dobs=PW_DOBS[PW_CPU_DOBS[:1]],
                          beta_band=False)
    step = PW_RATIOS[1] - PW_RATIOS[0]
    for name in PW_PRIORS:
        for key in ('interval', 'logpdf', 'loglike', 'median_pdf',
                    'hpd_pdf'):
            errs['pointwise', name, key] = rel_err(pw[name, key],
                                                     cpu[name, key])
            limits['pointwise', name, key] = PW_TOL
        # the median and HPD are grid points chosen from a posterior that
        # agrees to 1e-10: a choice may move by one grid step
        for key in ('median_pdf', 'hpd_pdf'):
            limits['pointwise', name, key] = step / PW_RATIOS.max() + PW_TOL
        errs['pointwise', name, 'scale_'] = rel_err(pw[name].scale_,
                                                      cpu[name].scale_)
        limits['pointwise', name, 'scale_'] = PW_TOL
    d_g, b_g = pw['binom']
    d_c, b_c = cpu['binom']
    errs['pointwise', 'coverage at dobs ' + str(PW_CPU_DOBS)] = rel_err(
        d_g[PW_CPU_DOBS], d_c)
    errs['pointwise', 'binomial band'] = rel_err(b_g[..., :1], b_c)
    limits['pointwise', 'coverage at dobs ' + str(PW_CPU_DOBS)] = 1e-15
    limits['pointwise', 'binomial band'] = 0.0
    d_b, b_b = pw['beta']
    # one beta band on the CPU: hpd of Beta(N s + 1, N - N s + 1) at the
    # first dob, held at what fmin's stopping rule allows (length 2e-8,
    # ends 1e-4 / pdf(end))
    from scipy import stats as sst

    from gsum_tpu_torch import helpers, stats
    s = PW_DOBS[0]
    t_hpd = time.perf_counter()
    band_c = helpers.hpd(stats.beta, 0.68, GP_N * s + 1, GP_N - GP_N * s + 1,
                         device='cpu')
    t_hpd = time.perf_counter() - t_hpd
    band_g = b_b[0, :, 0]
    pdf = sst.beta(GP_N * s + 1, GP_N - GP_N * s + 1).pdf(band_c)
    hpd_ends = float(np.max(np.abs(band_g - band_c) * pdf))
    hpd_len = abs((band_g[1] - band_g[0]) - (band_c[1] - band_c[0]))
    beta_vs_binom = float(np.max(np.abs(b_b - b_g))) * GP_N
    print(f'main path (model checking): beta band (0.68, dob {s:.2f}) card '
          f'{band_g.tolist()} CPU {band_c.tolist()}: length diff '
          f'{hpd_len:.3e} (limit 2e-8), ends diff × pdf {hpd_ends:.3e} (limit '
          f'1e-4); CPU hpd {t_hpd:.2f} s; beta vs binomial bands on the card: '
          f'max diff {beta_vs_binom:.3f} / N (limit 2 / N); coverage at the '
          f'20 dobs {d_b[:, -1].tolist()}')
    if not (hpd_len <= 2e-8 and hpd_ends <= 1e-4 and beta_vs_binom <= 2
            and torch.equal(d_b, d_g)
            and bool(((d_g >= 0) & (d_g <= 1)).all())):
        raise AssertionError('the beta bands disagree')
    for name in PW_PRIORS:
        iv = pw[name, 'interval']
        orders = GP_CURVES - len(PW_PRIORS[name].get('excluded', []))
        if iv.shape != (2, 2, GP_N, orders) or not torch.isfinite(iv).all():
            raise AssertionError(f'bad intervals {tuple(iv.shape)}')
        hp = pw[name, 'hpd_pdf']
        print(f'main path (model checking): pointwise {name}: ν = '
              f'{pw[name].df_}, posterior of the ratio over '
              f'{len(PW_RATIOS)} values: median '
              f'{pw[name, "median_pdf"].item():.4f}, 68% HPD '
              f'{hp.tolist()}')

    # Diagnostic, card against CPU
    for name in TRUNC_PRIORS:
        m = trunc[name]
        cpu_m = trunc_model(name, 'cpu',
                            kernel=m.coeffs_process.kernel_.clone(),
                            optimizer=None).fit(X, y_c, orders=np.arange(
                                GP_CURVES))
        mean_c = cpu_m.coeffs_process.mean(Xv)
        cov_c = cpu_m.coeffs_process.cov(Xv)
        mean_g, cov_g, df = moments[name]
        delta = rel_err(cov_g, cov_c)
        cond = torch.linalg.cond(cov_c).item()
        tol = cond * (delta + 10 * torch.finfo(torch.float64).eps)
        dg = out[name]
        dc = diagnostic_calls(mean_c, cov_c, df, cv.cpu(), 'cpu')
        kl_g = dg['diag'].kl(mean_c.to(device), cov_c.to(device))
        kl_c = dc['diag'].kl(mean_c, cov_c)
        md2 = dc['md_squared']
        for key in ('individual_errors', 'cholesky_errors', 'md_squared'):
            errs[name, key] = rel_err(dg[key], dc[key])
            limits[name, key] = tol
        same_piv = torch.equal(dg['diag']._piv.cpu(), dc['diag']._piv)
        if same_piv:
            errs[name, 'pivoted (same pivots)'] = rel_err(
                dg['pivoted_cholesky_errors'], dc['pivoted_cholesky_errors'])
            limits[name, 'pivoted (same pivots)'] = tol
        errs[name, 'pivoted: Σ squares vs md²'] = whitened_err(
            dg['pivoted_cholesky_errors'], dc['pivoted_cholesky_errors'], md2)
        errs[name, 'eigen (invariants, rows apart)'] = whitened_err(
            dg['eigen_errors'], dc['eigen_errors'], md2,
            dc['diag']._eig_vals)
        for key in ('pivoted: Σ squares vs md²',
                    'eigen (invariants, rows apart)'):
            limits[name, key] = tol
        # coverage: a point within tol·σ of an interval's end may count on
        # one device and not the other; allow exactly those
        lo, hi = dc['diag'].udist.interval(
            torch.atleast_2d(torch.tensor(PW_DOBS)).mT)
        sd = dc['diag'].sd
        yv = cv.cpu().double().mT[:, None, :]
        near = ((yv - lo).abs() <= tol * sd) | ((yv - hi).abs() <= tol * sd)
        allowed = near.sum(-1).max().item() / len(Xv)
        errs[name, 'coverage'] = (dg['coverage'].cpu() - dc['coverage']
                                  ).abs().max().item()
        limits[name, 'coverage'] = allowed + 1e-15
        errs[name, 'kl (abs, per dimension)'] = abs(kl_g.item()
                                                    - kl_c.item()) / len(Xv)
        limits[name, 'kl (abs, per dimension)'] = tol
        smp = dg['samples']
        sd_ref = torch.sqrt(torch.diag(cov_g) * (1 if df is None
                                                 else df / (df - 2)))
        z = ((smp.mean(1) - mean_g).abs() / (sd_ref / DIAG_SAMPLES ** 0.5))
        print(f'main path (model checking): Diagnostic {name} at {len(Xv)} '
              f'points: cond(cov) {cond:.3e}, card vs CPU cov {delta:.3e}, '
              f'limit cond·(δ + 10 eps) {tol:.3e}, pivots equal {same_piv}, '
              f'samples {tuple(smp.shape)} max |mean − m|/(σ/√n) '
              f'{z.max().item():.2f} (limit 5), kl card {kl_g.item():.3e} '
              f'CPU {kl_c.item():.3e}')
        if not (smp.shape == (len(Xv), DIAG_SAMPLES) and z.max().item() <= 5):
            raise AssertionError(f'{name}: bad reference samples')
        del cpu_m, dc

    # the variogram
    vg = out['variogram']
    for n in VARIO_POINTS:
        v, (gam, lower, upper), per_bin = vg[n]
        if per_bin != (n == VARIO_POINTS[0]):
            raise AssertionError(f'variogram at {n} points took the wrong '
                                 f'branch')
        if n == VARIO_POINTS[0]:
            # all bins by the batched formula on the card, and the smallest
            # bins by the CPU's per-bin pass
            from gsum_tpu_torch.helpers import _bin_var_batched
            idx, msk = v._bin_pair_indices()
            pi, pj, mk = v._index(v.pair_i[idx], v.pair_j[idx], msk)
            var = _bin_var_batched(v.gamma_tilde_grid, pi, pj, mk,
                                   v.corr_factor, v.var_factor)
            sd_b = torch.sqrt(var).cpu().numpy()
            sd_g = v.fourth_root_scale(upper) - v.gamma_star_mean
            errs['variogram', f'{n} per-bin vs batched sd'] = rel_err(
                sd_g, sd_b)
            del var, pi, pj, mk
            from gsum_tpu_torch.helpers import VariogramFourthRoot
            vc = VariogramFourthRoot(X[:n], c[:n].mT.cpu(), VARIO_BOUNDS,
                                     device='cpu')
            small = np.argsort(v.bin_counts)[:VARIO_CPU_BINS]
            sd_c = np.stack([np.sqrt(vc.cov(b)) for b in small])
            errs['variogram', f'{n} bins {small.tolist()} vs CPU'] = \
                rel_err(sd_g[small], sd_c)
            limits['variogram', f'{n} bins {small.tolist()} vs CPU'] = 1e-12
            limits['variogram', f'{n} per-bin vs batched sd'] = 1e-12
            print(f'main path (model checking): variogram {n} points: pairs '
                  f'per bin {v.bin_counts.tolist()}, per-bin branch (grid '
                  f'{v.Nb} x {idx.shape[1]}² x {v.Ncurves} > 3e7)')
        else:
            vc = VariogramFourthRoot(X[:n], c[:n].mT.cpu(), VARIO_BOUNDS,
                                     device='cpu')
            for key, g, w in zip(('gamma', 'lower', 'upper'),
                                 (gam, lower, upper), vc.compute()):
                errs['variogram', f'{n} {key}'] = rel_err(g, w)
                limits['variogram', f'{n} {key}'] = 1e-12
    bad = [k for k, v in errs.items() if not v <= limits[k]]
    print('main path (model checking): card vs CPU: ' + ', '.join(
        f'{"/".join(map(str, k))} {v:.3e} (limit {limits[k]:.3e})'
        for k, v in errs.items()))
    if bad:
        raise AssertionError(f'path 6 on the card disagrees with the CPU: '
                             f'{bad}')
    print(f'main path (model checking): wall time '
          f'{time.perf_counter() - t_path:.1f} s (card and CPU)')
    return out, counts


def time_model_checking(out, card, kernels, counts, device='cuda'):
    """Path 6's times on the card, and the incbeta kernels against their
    plain versions with their bounds and lane use: at (4096, 5) on the t
    quantile's arguments, f64 and f32 (the kernels' line of the JSON
    record), and, in f64, the one-element quantile of ``helpers.hpd`` and
    the two-element one of ``TruncationPointwise.interval``."""
    from gsum_tpu_torch.ops import incbeta
    from gsum_tpu_torch.stats._special import betainc_plain, betaincinv_plain
    from gsum_tpu_torch.time_incbeta import (CF_FLOPS, RATE, bound_ms,
                                             device_ms, inputs, lane_terms)
    from gsum_tpu_torch.time_incbeta import rel_err as incbeta_err

    plain = {'betainc': betainc_plain, 'betaincinv': betaincinv_plain}
    rows = [(dtype, 't', name) for dtype in (torch.float64, torch.float32)
            for name in plain]
    rows += [(torch.float64, which, 'betaincinv')
             for which in ('hpd 0.16', 'hpd 0.84', 'interval')]
    for dtype, which, name in rows:
        a, b, u = inputs(which, dtype, device)
        kernel, fn = getattr(incbeta, name), plain[name]
        got, terms, chunks = incbeta.cf_terms(kernel, a, b, u)
        err = incbeta_err(got, fn(a, b, u))[1]
        before = kernel.launches
        t = time_ms({'kernel': lambda: kernel(a, b, u),
                     'plain': lambda: fn(a, b, u)}, rounds=2)
        t_back = time_ms({'kernel': lambda: kernel(a, b, u)}, reps=10,
                         rounds=2)['kernel']
        ms = device_ms({'kernel': lambda: kernel(a, b, u)})['kernel']
        n_terms = terms.sum().item()
        bnd = bound_ms(n_terms, u.numel(), dtype)
        form = incbeta.form(u)
        lanes = lane_terms(terms, chunks, form)
        print(f'timing [{card}] incbeta.{name} {which} {tuple(a.shape)} '
              f'{dtype} ({("a thread", "a warp")[form]} per element): kernel '
              f'{ms:.4f} ms a launch (ten queued behind a spin kernel, the '
              f'median of five; CUDA events around one call '
              f'{t["kernel"]:.4f} ms, ten back to back {t_back:.4f} ms '
              f'each, the host launching), plain {t["plain"]:.3f} ms, '
              f'continued-fraction terms {n_terms} (mean '
              f'{n_terms / u.numel():.1f}, most {terms.max().item()} an '
              f'element; lane use {n_terms / max(lanes, 1):.4f}'
              + (f', chunk use {n_terms / (8 * chunks.sum().item()):.3f}'
                 if form else '') + f'), bound {bnd[0]:.3e} ms ({bnd[1]}, '
              f'{CF_FLOPS} flops a term at {RATE[dtype] / 1e12:g} '
              f'TFLOP/s), max abs diff {err:.3e}; launches in the timing '
              f'{kernel.launches - before}')
        if dtype == torch.float64 and which == 't':
            kernels.append({
                'name': INCBETA_TIMED[name], 'route': 'cuda',
                'source': KERNELS[INCBETA_TIMED[name]][0],
                'replaces': KERNELS[INCBETA_TIMED[name]][1],
                'launches': counts[INCBETA_TIMED[name]],
                'max_abs_err': err, 'ms': ms,
                'plain_ms': t['plain'], 'bound_ms': bnd[0],
                'bound_by': bnd[1], 'library_ms': None})
    # the path's own calls, on the card
    import gsum_tpu_torch as gt
    X, c, y, _, _ = trunc_data(device)
    m = out['pointwise']['df=1, scale=1']
    t = time_ms({
        'fit': lambda: gt.TruncationPointwise(device=device).fit(
            y, TRUNC_RATIO, TRUNC_REF),
        'interval (2 alphas)': lambda: m.interval(PW_ALPHA),
        'log_likelihood (one ratio)': lambda: m.log_likelihood(ratio=0.4),
        'credible_diagnostic (20 dobs, no band)': lambda:
            m.credible_diagnostic(y[:, -1], PW_DOBS),
        'hpd of Beta(N s + 1, N - N s + 1), s = 0.5': lambda: gt.hpd(
            gt.stats.beta, 0.68, GP_N * 0.5 + 1, GP_N * 0.5 + 1,
            device=device),
        'Diagnostic(mean, cov) at 1024': lambda: gt.Diagnostic(
            *[out['TruncationGP']['diag'].mean,
              out['TruncationGP']['diag'].cov]),
        'md_squared at 1024': lambda: out['TruncationGP']['diag'].md_squared(
            c[::DIAG_STRIDE]),
        'samples(4000) at 1024': lambda: out['TruncationGP']['diag'].samples(
            DIAG_SAMPLES),
        'variogram compute, 192 points (per bin)': lambda:
            out['variogram'][VARIO_POINTS[0]][0].compute(),
        'variogram compute, 64 points (batched)': lambda:
            out['variogram'][VARIO_POINTS[1]][0].compute()}, rounds=2)
    before = incbeta.betaincinv.launches
    gt.hpd(gt.stats.beta, 0.68, GP_N * 0.5 + 1, GP_N * 0.5 + 1,
           device=device)
    hpd_launches = incbeta.betaincinv.launches - before
    print(f'timing [{card}] path 6 calls: ' + ', '.join(
        f'{k} {v:.3f} ms' for k, v in t.items())
        + f'; one hpd launches betaincinv {hpd_launches} times')
    profile(f'pointwise interval N={GP_N} (2 alphas) [{card}]',
            lambda: m.interval(PW_ALPHA))


# path 7: batched throughput, at the widths of benchmarks/scale_tpu.py's
# legs 1-3 (A-C), bench.py's bench_grid_lml (D) and paths 5-6's data (E-G)
FIT_B, FIT_N, FIT_MAXITER, FIT_CHUNK = 10240, 128, 12, 2048        # leg A
WIDE_B, WIDE_N, WIDE_MAXITER, WIDE_NUGGET = 8, 4096, 6, 1e-2       # leg B
WIDE_RUNS = {'auto (blocked, K1)': dict(engine='auto', ls_steps=10, chunk=4),
             'scalar': dict(engine='scalar', ls_steps=5, chunk=1),
             'auto, mxu_precision=high (3xTF32)': dict(
                 engine='auto', ls_steps=10, chunk=4, mxu_precision='high')}
WIDE_TOL = 1e-3        # an f32 fit's lml vs the f64 single model at its θ
GRID_G, GRID_N, GRID_CHUNK = 10240, 512, 1024                       # leg C
BGRID_N, BGRID_G = 256, 512                                         # leg D
TGRID_STRIDE, TGRID_T, TGRID_R = 16, 100, 80                        # leg E
TGRID_PRIORS = {'gp': dict(center=0, disp=0, df=3, scale=1),
                'tp': dict(center=0, disp=0, df=5, scale=1)}
TGRID_POINTS = ((0, 0), (37, 11), (70, 50), (99, 79))
POST_B, POST_NEW = 128, 32                                          # leg G
ENGINE_NS, ENGINE_B, ENGINE_MAXITER = (192, 640, 1024, 2048), 8, 3  # leg H
CPU_A, CPU_C, CPU_E, CPU_G = 8, 16, 4, 4     # the CPU's subset of each leg
WELL_NUGGET = 1e-6     # leg A's θ again, card vs CPU, better conditioned


def fit_kernel():
    from gsum_tpu_torch import RBF

    return RBF(0.5, (1e-2, 1e2))


def scale_data():
    """benchmarks/scale_tpu.py's data, drawn in its order from one
    RandomState(0): leg 1, B curves sin(3x + 6.28u) + 0.1ε on N points of
    [0, 1]; leg 2, N points in the unit square with sin 4x₀ cos 3x₁ +
    0.05ε; leg 3, the leg-1 recipe at N=4096, B=8, in f32."""
    rng = np.random.RandomState(0)
    X1 = np.linspace(0.0, 1.0, FIT_N)[:, None]
    y1 = (np.sin(3.0 * X1.T + rng.rand(FIT_B, 1) * 6.28)
          + 0.1 * rng.randn(FIT_B, FIT_N))
    X2 = rng.rand(GRID_N, 2)
    y2 = np.sin(4 * X2[:, 0]) * np.cos(3 * X2[:, 1]) \
        + 0.05 * rng.randn(GRID_N)
    X3 = np.linspace(0.0, 1.0, WIDE_N)[:, None].astype(np.float32)
    y3 = (np.sin(3.0 * X3.T + rng.rand(WIDE_B, 1) * 6.28)
          + 0.1 * rng.randn(WIDE_B, WIDE_N)).astype(np.float32)
    return (X1, y1), (X2, y2), (X3, y3)


def k1_fit_launches(B, chunk, maxiter, N, block=128):
    """K1's launches in a blocked-engine fit, from the code: each chunk
    evaluates the objective forward once at its start and twice per
    iteration (the line search, then the value and gradient at the step
    taken); each forward factors its batch once, one launch per diagonal
    block; the backward and the posterior state launch none."""
    return -(-B // chunk) * (1 + 2 * maxiter) * -(-N // block)


def timed(fn):
    """(result, ms): ``fn()`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def cond_of(kernel, thetas, X, nugget):
    """Condition numbers of the nugget-included correlation matrices at each
    θ row (on X's device)."""
    out = []
    for th in thetas:
        R = kernel.value_fn(th, X, None)
        ev = torch.linalg.eigvalsh(
            R + nugget * torch.eye(R.shape[0], dtype=R.dtype,
                                   device=R.device))
        out.append((ev[-1] / ev[0].clamp_min(1e-300)).item())
    return out


def batched_legs(device, data, trunc_y, loglikes):
    """Path 7's calls on ``device``: legs A-G.  Returns their results, each
    leg's time (CUDA events) and peak memory, and K1's launches per leg."""
    import gsum_tpu_torch as gt
    from gsum_tpu_torch import ops
    from gsum_tpu_torch.parallel import (batched_fit, batched_lml_grid,
                                         batched_posterior_at,
                                         batched_predict,
                                         pointwise_evidence_grid,
                                         truncation_lml_grid)

    (X1, y1), (X2, y2), (X3, y3) = data
    t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    out, ms, peak, k1 = {}, {}, {}, {}

    def leg(name, fn):
        torch.cuda.reset_peak_memory_stats()
        before = ops.chol_inv_block.launches
        out[name], ms[name] = timed(fn)
        k1[name] = ops.chol_inv_block.launches - before
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30

    X1t, y1t = t(X1), t(y1)
    leg('A', lambda: batched_fit(fit_kernel(), X1t, y1t, df=3, scale=1,
                                 maxiter=FIT_MAXITER, chunk=FIT_CHUNK))
    leg('A mixed, first chunk', lambda: batched_fit(
        fit_kernel(), X1t, y1t[:FIT_CHUNK], df=3, scale=1,
        maxiter=FIT_MAXITER, chunk=FIT_CHUNK, precision='mixed'))

    X3t, y3t = t(X3), t(y3)
    for run, kw in WIDE_RUNS.items():
        leg('B ' + run, lambda kw=kw: batched_fit(
            fit_kernel(), X3t, y3t, df=3, scale=1, maxiter=WIDE_MAXITER,
            nugget=WIDE_NUGGET, **kw))

    X2t, y2t = t(X2), t(y2)
    thC = t(np.log(np.linspace(0.1, 2.0, GRID_G))[:, None])
    leg('C', lambda: torch.cat([
        batched_lml_grid(gt.RBF(0.5), X2t, y2t, thC[i:i + GRID_CHUNK], df=3,
                         scale=1, nugget=1e-8)
        for i in range(0, GRID_G, GRID_CHUNK)]))

    Xd = t(np.linspace(0, 1, BGRID_N)[:, None])
    yd = t(np.random.RandomState(2).randn(BGRID_N, 1))
    thD = t(np.linspace(-2, 0.5, BGRID_G)[:, None])
    for prec in ('f32', 'f64'):
        leg(f'D {prec}', lambda prec=prec: batched_lml_grid(
            gt.RBF(0.3, (1e-2, 1e2)), Xd, yd, thD, df=3.0, scale=1.0,
            nugget=1e-4, engine='grid', precision=prec))

    Xe = t(trunc_y[0][::TGRID_STRIDE])
    ye = trunc_y[1][::TGRID_STRIDE].to(device)
    thE = t(np.stack([np.log(np.linspace(0.05, 1.0, TGRID_T)),
                      np.full(TGRID_T, np.log(1e-4))], 1))
    ratE = t(np.linspace(0.3, 0.7, TGRID_R))
    for process, prior in TGRID_PRIORS.items():
        leg(f'E {process}', lambda process=process, prior=prior:
            truncation_lml_grid(trunc_kernel(), Xe, ye,
                                np.arange(GP_CURVES), ratE, thE,
                                ref=TRUNC_REF, process=process, **prior))

    yf = trunc_y[1].to(device)
    ratF = t(PW_RATIOS)
    for name, prior in PW_PRIORS.items():
        leg(f'F {name}', lambda prior=prior: pointwise_evidence_grid(
            yf, np.arange(GP_CURVES), ratF, ref=TRUNC_REF, **prior))

    thG = out['A'].theta[:POST_B]
    Xnew = t(np.linspace(0, 1, POST_NEW)[:, None])

    def leg_g():
        post = batched_posterior_at(fit_kernel(), X1t, y1t[0], thG, df=3,
                                    scale=1)
        yG = y1t[0].expand(POST_B, FIT_N)
        preds = {(st, mode): batched_predict(
            fit_kernel(), post, X1t, yG, Xnew, student=st, student_mode=mode)
            for st in (False, True) for mode in ('class', 'variance')}
        return post, preds
    leg('G', leg_g)
    return out, ms, peak, k1


def engine_table(card, device):
    """Leg H: the fit engines' times at the N where ``_auto_fit_engine``
    switches (the JAX package's thresholds, measured on a TPU): B=8 f32
    fits of the leg-3 recipe, maxiter 3, ls_steps 10, one chunk, each
    engine at each N (the blocked one above 512 only); the choice of
    'auto' beside them."""
    from gsum_tpu_torch.parallel import batched_fit
    from gsum_tpu_torch.parallel.batched import _auto_fit_engine

    rng = np.random.RandomState(1)
    for n in ENGINE_NS:
        X = torch.tensor(np.linspace(0, 1, n)[:, None], dtype=torch.float32,
                         device=device)
        Y = torch.tensor(np.sin(3.0 * np.linspace(0, 1, n)[None]
                                + rng.rand(ENGINE_B, 1) * 6.28)
                         + 0.1 * rng.randn(ENGINE_B, n), dtype=torch.float32,
                         device=device)
        row = {}
        for engine in ('grid', 'scan', 'scalar', 'blocked'):
            if engine == 'blocked' and n <= 512:
                continue
            post, t_ms = timed(lambda: batched_fit(
                fit_kernel(), X, Y, df=3, scale=1, nugget=WIDE_NUGGET,
                maxiter=ENGINE_MAXITER, chunk=ENGINE_B, engine=engine))
            if not torch.isfinite(post.lml).all():
                raise AssertionError(f'leg H: {engine} at N={n} gave a '
                                     f'non-finite lml')
            row[engine] = t_ms
        auto = {'unrolled': 'grid', 'scan': 'scan', 'blocked': 'blocked',
                None: 'scalar'}[_auto_fit_engine(torch.float32, n, 'cuda')]
        print(f'timing [{card}] path 7 leg H (fit engines, B={ENGINE_B} '
              f'f32, maxiter {ENGINE_MAXITER}) N={n}: ' + ', '.join(
                  f'{k} {v:.1f} ms' for k, v in row.items())
              + f"; 'auto' picks {auto}, fastest {min(row, key=row.get)}")


def trunc_kernel():
    import gsum_tpu_torch as gt

    return gt.RBF(0.3, (1e-2, 10)) + gt.WhiteKernel(1e-4, (1e-8, 1e-1))


def batched_path(card, loglikes, device='cuda'):
    """Path 7: batched throughput on the card (legs A-G), K1's launches
    under the blocked fit engine against the count derived from the code,
    each leg's time and peak memory, and the card against the port on the
    CPU of this machine on a subset of each leg."""
    import gsum_tpu_torch as gt
    from gsum_tpu_torch.parallel import (batched_fit, batched_lml_grid,
                                         batched_posterior_at,
                                         batched_predict,
                                         truncation_lml_grid)

    t_path = time.perf_counter()
    data = scale_data()
    X, _, y, _, _ = trunc_data(device)
    (out, ms, peak, k1), counts = drive(
        lambda: batched_legs(device, data, (X, y), loglikes))
    (X1, y1), (X2, y2), (X3, y3) = data
    problems = []

    def check(ok, what):
        if not ok:
            problems.append(what)

    for name in ms:
        print(f'timing [{card}] path 7 leg {name}: {ms[name]:.1f} ms, peak '
              f'memory {peak[name]:.2f} GiB, K1 launches {k1[name]}')
    print(f'main path (batched): launches {counts}')
    want = k1_fit_launches(WIDE_B, 4, WIDE_MAXITER, WIDE_N)
    for run, kw in WIDE_RUNS.items():
        expect = want if kw['engine'] == 'auto' else 0
        check(k1['B ' + run] == expect,
              f'leg B {run}: {k1["B " + run]} K1 launches, expected {expect}')
    check(counts['chol_inv_block'] == sum(k1.values()),
          f'K1 launches outside the legs: {counts}')

    # leg A: finite; fits per second; 'mixed' on the first chunk
    pa = out['A']
    check(bool(torch.isfinite(pa.lml).all()), 'leg A: non-finite lml')
    d = (out['A mixed, first chunk'].lml - pa.lml[:FIT_CHUNK]).abs()
    print(f'path 7 leg A: {FIT_B} fits at N={FIT_N} f64, maxiter '
          f'{FIT_MAXITER}, chunk {FIT_CHUNK}: {FIT_B / ms["A"] * 1e3:.1f} '
          f'fits/s; mixed vs f64 on the first chunk: lml max abs '
          f'{d.max().item():.3e}, max rel '
          f'{(d / pa.lml[:FIT_CHUNK].abs()).max().item():.3e}, '
          f'{FIT_CHUNK / ms["A mixed, first chunk"] * 1e3:.1f} fits/s')

    # leg B: each fit's lml against the f64 single model at its θ
    X64 = torch.tensor(X3, dtype=torch.float64, device=device)
    gp64 = gt.ConjugateGaussianProcess(fit_kernel(), df=3, scale=1,
                                       nugget=WIDE_NUGGET, device=device)
    for run in WIDE_RUNS:
        post = out['B ' + run]
        ref = torch.stack([gp64.log_marginal_likelihood(
            post.theta[b].double(), X=X64, y=torch.tensor(
                y3[b], dtype=torch.float64, device=device))
            for b in range(WIDE_B)])
        err = max_rel(post.lml, ref)
        moved = (post.theta[:, 0] != math.log(0.5)).sum().item()
        print(f'path 7 leg B {run}: θ (ℓ) {post.theta[:, 0].exp().tolist()}'
              f', lml {post.lml.tolist()}, vs f64 single model at its θ max '
              f'rel {err:.3e} (limit {WIDE_TOL:g}), fits that left the '
              f'start {moved} of {WIDE_B}, '
              f'{WIDE_B / ms["B " + run] * 1e3:.3f} fits/s')
        check(err <= WIDE_TOL, f'leg B {run}: lml {err:.3e} from f64')

    # legs C, D: finite, µs per evaluation
    check(bool(torch.isfinite(out['C']).all()), 'leg C: non-finite lml')
    print(f'path 7 leg C: G={GRID_G} N={GRID_N} d=2 f64 (scan engine), '
          f'{ms["C"] / GRID_G * 1e3:.2f} µs per evaluation')
    dd = max_rel(out['D f32'], out['D f64'])
    print(f'path 7 leg D (bench_grid_lml N={BGRID_N} G={BGRID_G}): f32 '
          f'{ms["D f32"] / BGRID_G * 1e3:.2f} µs, f64 '
          f'{ms["D f64"] / BGRID_G * 1e3:.2f} µs per evaluation (first '
          f'call, engine grid); f32 vs f64 max rel {dd:.3e}')
    for prec in ('f32', 'f64'):
        check(bool(torch.isfinite(out[f'D {prec}']).all()),
              f'leg D {prec}: non-finite lml')

    # leg E: four (θ, ratio) points against the truncation models
    Xe = X[::TGRID_STRIDE]
    ye = y[::TGRID_STRIDE]
    thE = np.stack([np.log(np.linspace(0.05, 1.0, TGRID_T)),
                    np.full(TGRID_T, np.log(1e-4))], 1)
    ratE = np.linspace(0.3, 0.7, TGRID_R)
    for process, prior in TGRID_PRIORS.items():
        grid = out[f'E {process}']
        cls = gt.TruncationGP if process == 'gp' else gt.TruncationTP
        model = cls(trunc_kernel(), ratio=TRUNC_RATIO, ref=TRUNC_REF,
                    device=device, **prior)
        conds = cond_of(trunc_kernel(), torch.tensor(
            thE[[i for i, _ in TGRID_POINTS]], device=device),
            torch.tensor(Xe, device=device), 1e-10)
        errs = []
        for (i, j), cond in zip(TGRID_POINTS, conds):
            ref = model.log_marginal_likelihood(
                thE[i], X=Xe, y=ye, orders=np.arange(GP_CURVES),
                ratio=float(ratE[j]))
            errs.append(max_rel(grid[i, j], ref))
            check(errs[-1] <= cond_tol(cond), f'leg E {process} ({i}, {j}): '
                  f'{errs[-1]:.3e} from the model, limit '
                  f'{cond_tol(cond):.3e}')
        print(f'path 7 leg E {process}: ({TGRID_T}, {TGRID_R}) grid at '
              f'N={len(Xe)} in {ms[f"E {process}"]:.1f} ms; at '
              f'{TGRID_POINTS} vs {cls.__name__}.log_marginal_likelihood: '
              f'rel {[f"{e:.3e}" for e in errs]}, condition numbers '
              f'{[f"{c:.3g}" for c in conds]}')

    # leg F: against path 6's loop of TruncationPointwise.log_likelihood.
    # With a scalar ratio r the class (as gsum's reference) counts the
    # change of variables once, log|ref| + S log r (S the sum of the orders
    # kept); the grid broadcasts r to every point and counts it N times, as
    # JAX's pointwise_evidence_grid does; the loop is shifted by the
    # difference, (N − 1)(log|ref| + S log r)
    logr = torch.log(torch.tensor(PW_RATIOS, device=device))
    for name, prior in PW_PRIORS.items():
        S = float(np.sum(np.setdiff1d(np.arange(GP_CURVES),
                                      prior.get('excluded', []))))
        shifted = loglikes[name].reshape(-1) - (GP_N - 1) * (
            math.log(TRUNC_REF) + S * logr)
        err = max_rel(out[f'F {name}'], shifted)
        print(f'path 7 leg F {name}: {len(PW_RATIOS)} ratios at N={GP_N} in '
              f'{ms[f"F {name}"]:.2f} ms; vs path 6 loop (shifted) max rel '
              f'{err:.3e} (limit {PW_TOL:g})')
        check(err <= PW_TOL, f'leg F {name}: {err:.3e} from the loop')

    # the card against the port on the CPU, a subset of each leg
    cpu = torch.device('cpu')
    t0 = time.perf_counter()
    X1c = torch.tensor(X1)
    post_cpu = batched_fit(fit_kernel(), X1c, torch.tensor(y1[:CPU_A]), df=3,
                           scale=1, maxiter=FIT_MAXITER, chunk=None)
    conds = cond_of(fit_kernel(), post_cpu.theta, X1c, 1e-10)
    dth = (pa.theta[:CPU_A].cpu() - post_cpu.theta).abs().max().item()
    err = max_rel(pa.lml[:CPU_A], post_cpu.lml)
    lim = cond_tol(max(conds))
    print(f'path 7 card vs CPU, leg A ({CPU_A} fits): θ max abs {dth:.3e}, '
          f'lml max rel {err:.3e} (limit {lim:.3e} from the largest '
          f'condition number {max(conds):.3g})')
    check(err <= lim, f'leg A: card vs CPU lml {err:.3e}')
    # the same inputs on both: the card's θ, at the fits' nugget (whose
    # cond·ε allows what two factorization orders differ by) and at a
    # larger one, where a fault of the card's engine would show
    thA = pa.theta[:CPU_A].cpu()
    for nugget in (1e-10, WELL_NUGGET):
        def at(dev):
            return torch.stack([batched_lml_grid(
                fit_kernel(), torch.tensor(X1, device=dev),
                torch.tensor(y1[b], device=dev), thA[b:b + 1].to(dev),
                df=3, scale=1, nugget=nugget)[0] for b in range(CPU_A)])
        card_lml = pa.lml[:CPU_A] if nugget == 1e-10 else at(device)
        err = max_rel(card_lml, at(cpu))
        cond = max(cond_of(fit_kernel(), thA, X1c, nugget))
        print(f'path 7 card vs CPU, leg A at the card\'s θ, nugget '
              f'{nugget:g}: lml max rel {err:.3e} (limit '
              f'{cond_tol(cond):.3e} from condition number {cond:.3g})')
        check(err <= cond_tol(cond), f'leg A at the card\'s θ, nugget '
              f'{nugget:g}: {err:.3e}')

    X2c = torch.tensor(X2)
    thC = np.log(np.linspace(0.1, 2.0, GRID_G))[:CPU_C, None]
    valC = batched_lml_grid(gt.RBF(0.5), X2c, torch.tensor(y2),
                            torch.tensor(thC), df=3, scale=1, nugget=1e-8)
    lim = cond_tol(max(cond_of(gt.RBF(0.5), torch.tensor(thC), X2c, 1e-8)))
    err = max_rel(out['C'][:CPU_C], valC)
    print(f'path 7 card vs CPU, leg C ({CPU_C} θ): max rel {err:.3e} '
          f'(limit {lim:.3e})')
    check(err <= lim, f'leg C: card vs CPU {err:.3e}')

    Xec = torch.tensor(Xe)
    for process, prior in TGRID_PRIORS.items():
        gc = truncation_lml_grid(trunc_kernel(), Xec, ye.cpu(),
                                 np.arange(GP_CURVES),
                                 torch.tensor(ratE[:CPU_E]),
                                 torch.tensor(thE[:CPU_E]), ref=TRUNC_REF,
                                 process=process, **prior)
        lim = cond_tol(max(cond_of(trunc_kernel(), torch.tensor(
            thE[:CPU_E]), Xec, 1e-10)))
        err = max_rel(out[f'E {process}'][:CPU_E, :CPU_E], gc)
        print(f'path 7 card vs CPU, leg E {process} ({CPU_E} × {CPU_E}): '
              f'max rel {err:.3e} (limit {lim:.3e})')
        check(err <= lim, f'leg E {process}: card vs CPU {err:.3e}')

    post_g, preds = out['G']
    thG = pa.theta[:CPU_G].cpu()
    pc = batched_posterior_at(fit_kernel(), X1c, torch.tensor(y1[0]), thG,
                              df=3, scale=1)
    lim = cond_tol(max(cond_of(fit_kernel(), thG, X1c, 1e-10)))
    err = max(max_rel(getattr(post_g, f)[:CPU_G], getattr(pc, f))
              for f in ('lml', 'scale_sq', 'cov_factor'))
    Xnew = torch.tensor(np.linspace(0, 1, POST_NEW)[:, None])
    yG = torch.tensor(y1[0]).expand(CPU_G, FIT_N)
    for (st, mode), (mean, std) in preds.items():
        mc, sc = batched_predict(fit_kernel(), pc, X1c, yG, Xnew,
                                 student=st, student_mode=mode)
        scale = mc.abs().max().item()
        err = max(err, (mean[:CPU_G].cpu() - mc).abs().max().item() / scale,
                  (std[:CPU_G].cpu() - sc).abs().max().item()
                  / sc.abs().max().item())
    print(f'path 7 card vs CPU, leg G ({CPU_G} draws: lml, scale², '
          f'cov factor, the four predictions): max rel {err:.3e} (limit '
          f'{lim:.3e})')
    check(err <= lim, f'leg G: card vs CPU {err:.3e}')
    print(f'path 7 CPU side: {time.perf_counter() - t0:.1f} s')

    engine_table(card, device)
    profile(f'leg A objective, one line search ({FIT_CHUNK * 10} θ, '
            f'N={FIT_N}, f64, grid engine) [{card}]',
            lambda: batched_lml_grid(fit_kernel(), torch.tensor(
                X1, device=device), torch.tensor(y1[0], device=device),
                torch.log(torch.linspace(0.05, 1.0, FIT_CHUNK * 10,
                                         device=device,
                                         dtype=torch.float64))[:, None],
                df=3, scale=1, engine='grid'))
    X32, y32 = (torch.tensor(a, device=device) for a in (X3, y3[0]))
    th40 = torch.log(torch.linspace(0.05, 1.0, 40, device=device))[:, None]
    profile(f'leg B objective, one line search (40 θ, N={WIDE_N}, f32, '
            f'blocked) [{card}]',
            lambda: batched_lml_grid(fit_kernel(), X32, y32, th40, df=3,
                                     scale=1, nugget=WIDE_NUGGET,
                                     engine='blocked'))
    print(f'path 7: wall {time.perf_counter() - t_path:.1f} s')
    if problems:
        raise AssertionError('path 7: ' + '; '.join(problems))


# path 8: model checking and derivative observations at full width
DERIV_H = 1e-3                 # central-difference step for the slope checks
DERIV_CPU = 16                 # new points the CPU repeats
DCGP_EVERY = 64                # every 64th row of 4096: a derivative row
GD_NREF = 1000                 # GraphicalDiagnostic's draws (JAX's default)
GD_INTERVALS = np.linspace(0.001, 0.999, 50)
GD_CPU_INTERVALS = [0, 12, 25, 37, 49]      # the intervals the CPU repeats
GD_COLORS = ['C0', 'C1', 'C2', 'C3', 'C4', 'C5', 'C6', 'C7']
GD_VARIO_POINTS = 192          # path 6's per-bin width
# leg D: draws (88 + 8 curves: about 20 s at ~5 fits/s, what the paths'
# 120 s allow beside HMC), fit chunk, draws of the 'loop' comparison
KL_NREF, KL_CHUNK, KL_LOOP = 88, 4, 3
KL_FIT = dict(engine='blocked', precision='f32', chunk=KL_CHUNK,
              maxiter=WIDE_MAXITER, ls_steps=10)


def deriv_oracle(x, xp, ls, a, b):
    """cov[f^(a)(x), f^(b)(xp)] of the unit RBF in one dimension, closed
    form (the formulas of tests/test_derivs.py), for orders a, b ≤ 2."""
    tau = x[:, None] - xp[None, :]
    k = np.exp(-0.5 * tau ** 2 / ls ** 2)
    s2, t2 = ls ** 2, tau ** 2
    forms = {(0, 0): k, (0, 1): tau / s2 * k, (1, 0): -tau / s2 * k,
             (1, 1): (1 / s2 - t2 / s2 ** 2) * k,
             (2, 0): (t2 / s2 ** 2 - 1 / s2) * k,
             (0, 2): (t2 / s2 ** 2 - 1 / s2) * k,
             (2, 1): -(3 * tau / s2 ** 2 - tau ** 3 / s2 ** 3) * k,
             (1, 2): (3 * tau / s2 ** 2 - tau ** 3 / s2 ** 3) * k,
             (2, 2): (3 / s2 ** 2 - 6 * t2 / s2 ** 3 + t2 ** 2 / s2 ** 4) * k}
    return forms[(a, b)]


def edge_ratio(X):
    """Path 8 A's expansion ratio, 0.5·(1 + 0.4·x₀) ∈ [0.5, 0.7]."""
    return TRUNC_RATIO * (1.0 + 0.4 * X[:, 0])


def slope_model(m5, device):
    """Path 8 A's TruncationGP: path 5's fitted TruncationGP with its
    WhiteKernel turned into the nugget (a WhiteKernel has no derivative
    observations; the model's nugget adds the same diagonal in the fit and
    nothing to the bands' cross-covariances, as the WhiteKernel's
    two-argument form), θ fixed, the coefficients' mean estimated
    (disp = 1) and the ratio rising across x₀ (0.5·(1 + 0.4·x₀), a torch
    function that ``torch.func`` differentiates): the truncation band,
    ref·Σₙ ratio(x)ⁿ·cₙ(x) over the orders above 3, then has a mean with a
    slope, and no symmetry zeroes the slope at the edge once the value
    constraints pin it to 0 there (a constant ratio, or a factor common to
    every order, would: the band would be one stationary process times a
    scale), so the slope constraints do."""
    from gsum_tpu_torch import RBF, TruncationGP

    k5 = m5.coeffs_process.kernel_
    return TruncationGP(RBF(float(k5.k1.length_scale), (1e-2, 10)),
                        ratio=edge_ratio, ref=TRUNC_REF, center=0, disp=1,
                        df=3, scale=1, nugget=float(k5.k2.noise_level),
                        optimizer=None, device=device)


def slope_calls(model, X, y, dX, Xs, device):
    """Path 8 A's calls: fit with value and slope constraints (dy = 0) at
    the 16 edge points, the 'trunc' band with std and its x₀-slope at the
    constraint points and at ``Xs``, and the band's mean at Xs ± h e₀."""
    orders = np.arange(GP_CURVES)
    n = len(dX)
    dXc = np.concatenate([dX, dX])
    dd = np.array([[0, 0]] * n + [[1, 0]] * n)
    # the contrast first: value constraints alone leave a slope at the edge
    model.fit(X, y, orders=orders, dX=dX, dy=np.zeros(n))
    values_only = model.predict(dX, TRUNC_ORDER, kind='trunc',
                                dorders=[[1, 0]] * n)
    model.fit(X, y, orders=orders, dX=dXc, dy=np.zeros(2 * n), dderivs=dd)
    slope = np.array([[1, 0]] * len(Xs))
    e0 = np.array([DERIV_H, 0.0])
    out = {'trunc': model.predict(Xs, TRUNC_ORDER, kind='trunc',
                                  return_std=True),
           'slope, value constraints only': values_only,
           'slope at constraints': model.predict(
               dX, TRUNC_ORDER, kind='trunc', dorders=[[1, 0]] * n,
               return_std=True),
           'slope': model.predict(Xs, TRUNC_ORDER, kind='trunc',
                                  dorders=slope, return_std=True)}
    for sign in (1, -1):
        out[sign] = model.predict(Xs + sign * e0, TRUNC_ORDER, kind='trunc')
        out[sign, 'con'] = model.predict(dX + sign * e0, TRUNC_ORDER,
                                         kind='trunc')
    return out


def constraint_conditioning(model):
    """The value-and-slope constraint covariance K of the truncation band
    at the edge points, as the constrained band factors it: the jitter
    ladder's rung and the jitter δ it adds, cond(K + δI), max diag K, and
    the constraints' misfit in the band's metric, √(vᵀ(K + δI)⁻¹v) with
    v = dy − m (what the posterior mean at a constraint may keep: at most
    √δ times it)."""
    from gsum_tpu_torch.derivs import deriv_cov, deriv_mean

    cov_fn, mean_fn, _ = model._trunc_scalar_fns(TRUNC_ORDER + 1, np.inf)
    Xd, dd = model.dX_, model.dderivs_
    K = deriv_cov(cov_fn, Xd, dd)
    rung, jitter = ladder(K)
    v = (model.dy_ - deriv_mean(mean_fn, Xd, dd))[:, None]
    Kj = K + jitter * torch.eye(len(K), dtype=K.dtype, device=K.device)
    md = torch.sqrt(v.mT @ torch.cholesky_solve(
        v, torch.linalg.cholesky(Kj))).item()
    return rung, jitter, jittered_cond(K, jitter), \
        torch.diagonal(K).max().item(), md


def graphical_calls(moments, cv, Xv, device, nref=GD_NREF):
    """Path 8 C's calls for each coefficient process: GraphicalDiagnostic
    with ``nref`` draws, the QQ data of the four maps, the coverage bands at
    50 intervals and the MD² reference grid."""
    from gsum_tpu_torch import GraphicalDiagnostic

    out = {}
    for name, (mean, cov, df) in moments.items():
        g = GraphicalDiagnostic(cv, mean, cov, df=df, nref=nref,
                                colors=GD_COLORS, device=device)
        out[name] = g
        for m in g._WHITENERS:
            out[name, m] = g.qq_band_data(m)
        out[name, 'coverage'] = g.coverage_band_data(GD_INTERVALS)
        out[name, 'md grid'] = g._dist_grid(g.md_ref_dist)
    return out


def kl_leg(device):
    """Path 8 D's data: path 7 leg B's recipe (N=4096 on [0, 1], its 8
    curves, RBF(0.5, (1e-2, 1e2)), df 3, nugget 1e-2, 'blocked' f32 fits)
    with the nugget carried by a WhiteKernel that starts at 1e-2 and is
    fitted too, so that the KL's cov_factor·R (R without the model's
    nugget) is positive definite (a fixed WhiteKernel's f64 constant would
    promote the f32 covariances to f64); the reference: mean 0 and the
    kernel's covariance at its start θ."""
    import gsum_tpu_torch as gt

    (_, _), (_, _), (X3, y3) = scale_data()
    kernel = gt.RBF(0.5, (1e-2, 1e2)) + gt.WhiteKernel(WIDE_NUGGET,
                                                       (1e-4, 1.0))
    X64 = torch.tensor(X3, dtype=torch.float64, device=device)
    cov = kernel(X64)
    mean = torch.zeros(WIDE_N, dtype=torch.float64, device=device)
    gp = gt.ConjugateGaussianProcess(kernel, df=3, scale=1, nugget=1e-6,
                                     device=device)
    return X3, torch.tensor(y3.T, dtype=torch.float64, device=device), \
        mean, cov, gp


def derivative_checking_path(trunc, card, device='cuda'):
    """Path 8: model checking and derivative observations at full width.
    A, path 5's TruncationGP with value and slope constraints at the 16
    edge points; B, ``kernel_deriv_cov`` at 4096 × 16 points against the
    closed form and a CGP with 64 derivative rows; C, GraphicalDiagnostic
    on path 6's setup (1024 points, nref 1000, both coefficient
    processes); D, ``kl_data`` on path 7 leg B's recipe with K1 under the
    blocked fits.  Each leg's launches are read around it; subsets are
    checked against the CPU.  Returns A's model and the launches."""
    import gsum_tpu_torch as gt
    from gsum_tpu_torch.derivs import kernel_deriv_cov

    t_path = time.perf_counter()
    eps = torch.finfo(torch.float64).eps
    X, c, y, Xnew, dX = trunc_data(device)
    Xs = Xnew[:DERIV_CPU]
    problems, launches, ms = [], {}, {}

    def check(ok, what):
        if not ok:
            problems.append(what)

    def leg(name, fn):
        (res, t), counts = drive(lambda: timed(fn))
        launches[name], ms[name] = counts, t
        print(f'main path (derivatives, {name}): {t:.1f} ms, launches '
              f'{counts}')
        return res

    # A: value and slope constraints of the truncation band
    model = slope_model(trunc['TruncationGP'], device)
    a = leg('A', lambda: slope_calls(model, X, y, dX, Xs, device))
    rung, jitter, cond_c, s_c, md = constraint_conditioning(model)
    tol_c = cond_tol(cond_c)
    # at a constraint the posterior keeps at most √δ·md of the misfit and
    # a variance of δ, plus the solve's cond·ε (as path 5's pinned band)
    lim_mean = math.sqrt(jitter) * md + tol_c * math.sqrt(s_c)
    lim_std = math.sqrt(jitter + tol_c * s_c)
    s_con, sd_con = a['slope at constraints']
    fd = (a[1] - a[-1]) / (2 * DERIV_H)
    fd_con = (a[1, 'con'] - a[-1, 'con']) / (2 * DERIV_H)
    ell = float(model.coeffs_process.kernel_.length_scale)
    # central difference: truncation error h²/6·|m'''| ≤ h²/ℓ²·max|m'|
    # (a GP mean's third derivative is about its first over ℓ²) and round
    # off 2·(cond·ε·max|m|)/(2h)
    m_max = a['trunc'][0].abs().max().item()
    lim_fd = (DERIV_H ** 2 / ell ** 2 * a['slope'][0].abs().max().item()
              + tol_c * m_max / DERIV_H)
    contrast = a['slope, value constraints only'].abs().max().item()
    errs = {'slope mean at the constraints (abs)':
            (s_con.abs().max().item(), lim_mean),
            'slope std at the constraints':
            (sd_con.max().item(), lim_std),
            'slope vs central difference of the mean (abs)':
            ((a['slope'][0] - fd).abs().max().item(), lim_fd),
            'central difference at the constraints (abs)':
            (fd_con.abs().max().item(), lim_fd + lim_mean)}
    # the CPU: the same model, the 'trunc' band and the slopes
    cpu = slope_model(trunc['TruncationGP'], 'cpu')
    ac = slope_calls(cpu, X, y.cpu(), dX, Xs, 'cpu')
    rung_cpu = constraint_conditioning(cpu)[0]
    check(rung == rung_cpu, f'A: jitter rungs card {rung}, CPU {rung_cpu}')
    for key in ('trunc', 'slope', 'slope at constraints'):
        for i, what in enumerate(('mean', 'std')):
            band = ac[key][1].max() if i == 0 else 0.0
            errs[f'{key} {what} card vs CPU'] = (
                rel_err(a[key][i], ac[key][i], band), max(tol_c, GP_TOL))
    del cpu, ac
    print(f'main path (derivatives, A): TruncationGP N={GP_N} with 16 value '
          f'and 16 slope constraints at x₀ = 1: the constraint covariance '
          f'at jitter rung {rung} (CPU {rung_cpu}; δ {jitter:.3e}), cond '
          f'{cond_c:.3e}, max diag {s_c:.3e}, misfit √(vᵀK⁻¹v) {md:.3e}; '
          f'slope std at {DERIV_CPU} new points up to '
          f'{a["slope"][1].max().item():.3e}, ℓ {ell:.4f}; the band\'s mean '
          f'{a["trunc"][0].mean().item():.4g} at those points; with the '
          f'value constraints alone the slope at x₀ = 1 reaches '
          f'{contrast:.3e}; ' + ', '.join(
              f'{k} {v:.3e} (limit {lim:.3e})' for k, (v, lim) in
              errs.items()))
    for k, (v, lim) in errs.items():
        check(v <= lim, f'A: {k} {v:.3e} > {lim:.3e}')
    check(contrast > lim_mean, f'A: the value constraints alone leave a '
          f'slope of {contrast:.3e}, inside the limit {lim_mean:.3e}')

    # B: the derivative covariance at 4096 × 16 points and a CGP with
    # derivative rows
    ls = 0.3
    x1 = np.linspace(0.0, 1.0, GP_N)
    x2 = np.linspace(0.05, 0.95, 16)
    d1, d2 = np.arange(GP_N) % 3, np.arange(16) % 3
    K = leg('B covariance', lambda: kernel_deriv_cov(
        gt.RBF(ls), torch.tensor(x1[:, None], device=device), d1,
        torch.tensor(x2[:, None], device=device), d2))
    want = np.empty((GP_N, 16))
    for a_ in range(3):
        for b_ in range(3):
            rows, cols = np.flatnonzero(d1 == a_), np.flatnonzero(d2 == b_)
            want[np.ix_(rows, cols)] = deriv_oracle(x1[rows], x2[cols], ls,
                                                    a_, b_)
    err_k = rel_err(K, torch.tensor(want))
    check(err_k <= 1e-12, f'B: kernel_deriv_cov {err_k:.3e} from the closed '
          f'form')
    Xg, yg, _ = gp_data()
    dord = np.zeros((GP_N, GP_D), int)
    dord[::DCGP_EVERY, 0] = 1
    yd = yg[:, 0].copy()
    rows = np.flatnonzero(dord[:, 0])
    yd[rows] = 3 * np.cos(3 * Xg[rows, 0]) * np.cos(2 * Xg[rows, 1])
    k5 = trunc['TruncationGP'].coeffs_process.kernel_
    theta = np.log([float(k5.k1.length_scale)])
    dgp = gt.ConjugateGaussianProcess(
        gt.RBF(float(k5.k1.length_scale), (1e-2, 10)), df=3, scale=1,
        nugget=float(k5.k2.noise_level), optimizer=None, device=device)

    def dcgp():
        dgp.fit(Xg, yd, dorders=dord)
        return dgp.log_marginal_likelihood(theta, eval_gradient=True), \
            dgp.predict(Xs, return_std=True)
    (lml, grad), (dm, dsd) = leg('B CGP', dcgp)

    # the gradient against a Richardson-extrapolated central difference;
    # the lml's round-off δ is measured as its change under a permutation
    # of the rows (another factorization order), so the difference's
    # round-off is at most 3δ/h, and its truncation error |R(h) − R(2h)|
    def f(t):
        return dgp.log_marginal_likelihood(t).item()

    def central(h):
        return (f(theta + h) - f(theta - h)) / (2 * h)

    h = 2e-3
    D = {k: central(k * h) for k in (0.5, 1, 2)}
    rich = (4 * D[0.5] - D[1]) / 3
    rich2 = (4 * D[1] - D[2]) / 3
    perm = np.random.RandomState(1).permutation(GP_N)
    pgp = gt.ConjugateGaussianProcess(
        gt.RBF(float(k5.k1.length_scale), (1e-2, 10)), df=3, scale=1,
        nugget=float(k5.k2.noise_level), optimizer=None, device=device)
    pgp.fit(Xg[perm], yd[perm], dorders=dord[perm])
    delta = abs(pgp.log_marginal_likelihood(theta).item() - lml.item())
    err_g = abs(grad.item() - rich)
    lim_g = 3 * delta / (0.5 * h) + abs(rich - rich2)
    print(f'main path (derivatives, B): kernel_deriv_cov RBF {GP_N} × 16, '
          f'orders 0/1/2, vs closed form {err_k:.3e} (limit 1e-12); CGP '
          f'N={GP_N} with {len(rows)} first-derivative rows: lml '
          f'{lml.item():.10g} (rows permuted: δ {delta:.3e}), dlml/dlog ℓ '
          f'{grad.item():.10g} vs Richardson central difference '
          f'{rich:.10g} (h {h:g}): abs {err_g:.3e} (limit 3δ/h + |R(h) − '
          f'R(2h)| = {lim_g:.3e}); prediction finite '
          f'{bool(torch.isfinite(dm).all() and torch.isfinite(dsd).all())}')
    check(err_g <= lim_g and torch.isfinite(dm).all()
          and torch.isfinite(dsd).all(), f'B: the CGP with derivative rows '
          f'({err_g:.3e})')
    del pgp
    del dgp, K

    # C: GraphicalDiagnostic on path 6's setup
    Xv, cv = X[::DIAG_STRIDE], c[::DIAG_STRIDE]
    moments = {}
    for name in TRUNC_PRIORS:
        cp = trunc[name].coeffs_process
        moments[name] = (cp.mean(Xv), cp.cov(Xv),
                         None if name == 'TruncationGP' else cp.df_)
    gd = {}
    for name in TRUNC_PRIORS:
        gd.update(leg(f'C {name}', lambda name=name: graphical_calls(
            {name: moments[name]}, cv, Xv, device)))
    n_v = GD_VARIO_POINTS
    mean_gp, cov_gp, _ = moments['TruncationGP']
    gv = gt.GraphicalDiagnostic(cv[:n_v], mean_gp[:n_v], cov_gp[:n_v, :n_v],
                                nref=2, colors=GD_COLORS, device=device)
    loc, gam, lo, hi = leg('C variogram', lambda: gv.variogram_data(
        Xv[:n_v]))
    # the band is the reference's (the data's semivariogram may leave it);
    # it is NaN where the estimator's variance of a bin comes out
    # negative, as in JAX (at these points one of the 30: the first bin of
    # the second curve, in both packages)
    band_ok = np.isfinite(lo) & np.isfinite(hi)
    inside = (lo <= gam) & (gam <= hi)
    print(f'main path (derivatives, C): variogram data at {n_v} points: '
          f'{int((~band_ok).sum())} of {band_ok.size} bands NaN (at '
          f'{np.argwhere(~band_ok).tolist()}); the data inside its band in '
          f'{int(inside.sum())} of {int(band_ok.sum())}')
    check(gam.shape == (GP_CURVES, 6) and np.isfinite(gam).all()
          and np.all(lo[band_ok] < hi[band_ok]) and band_ok.sum() >= 29,
          f'C: variogram data {gam.shape}, {int(band_ok.sum())} bands')
    p1 = launches['C TruncationTP']['incbeta.betaincinv'] \
        + launches['C TruncationTP']['incbeta.betainc']
    check(p1 > 0, f'C: the Student-t diagnostic launched no incbeta kernel: '
          f'{launches["C TruncationTP"]}')
    # the CPU: the TP object with the card's draws, a subset of its data
    name = 'TruncationTP'
    mean, cov, df = moments[name]
    g = gd[name]
    gc = gt.GraphicalDiagnostic(cv.cpu(), mean.cpu(), cov.cpu(), df=df,
                                nref=2, colors=GD_COLORS, device='cpu')
    gc.samples = g.samples.cpu()
    cond = torch.linalg.cond(cov).item()
    tol = cond * 10 * eps
    errs = {}
    for m in ('individual', 'cholesky'):
        tq, sd_, bands = gd[name, m]
        tq_c, sd_c, bands_c = gc.qq_band_data(m)
        errs[f'{m} theoretical quantiles'] = (rel_err(tq, tq_c), 1e-11)
        errs[f'{m} order statistics'] = (rel_err(sd_, sd_c), tol)
        errs[f'{m} bands'] = (max(rel_err(b, b2) for p, p2 in
                                  zip(bands, bands_c) for b, b2 in
                                  zip(p, p2)), tol)
    # the panel's launch of len(Xv) quantiles takes the warp form; the
    # same quantiles in one launch past WARP_MAX take the thread form (at
    # this large ν some of their 50 Newton steps do not converge, and
    # where they end follows every rounding)
    from gsum_tpu_torch.ops import incbeta

    ref = g.diagnostic.std_udist
    probs = (np.arange(1, len(Xv) + 1) - 0.5) / len(Xv)
    reps = incbeta.WARP_MAX // len(probs) + 1
    whole = np.asarray(ref.ppf(np.tile(probs, reps)).cpu())[:len(probs)]
    errs['theoretical quantiles in one launch past WARP_MAX'] = (
        rel_err(whole, tq_c), 1e-11)
    print(f'main path (derivatives, C): the TP reference\'s degrees of '
          f'freedom {float(np.asarray(torch.as_tensor(ref.df).cpu())):g}')
    # coverage at 5 of the 50 intervals (each interval's coverage and band
    # stand alone; the CPU's plain quantiles take seconds per interval)
    cov_d, bands_d = gd[name, 'coverage']
    cov_d = cov_d[:, GD_CPU_INTERVALS]
    cov_c, bands_cc = gc.coverage_band_data(GD_INTERVALS[GD_CPU_INTERVALS])
    errs['coverage bands'] = (max(float(np.abs(b[GD_CPU_INTERVALS] - b2).max())
                                  for p, p2 in zip(bands_d, bands_cc)
                                  for b, b2 in zip(p, p2)), 1e-15)
    # a point within tol·σ of an interval's end may count on one device
    # and not the other (as path 6)
    lo_c, hi_c = gc.diagnostic.udist.interval(torch.atleast_2d(
        torch.tensor(GD_INTERVALS[GD_CPU_INTERVALS])).mT)
    sdv = gc.diagnostic.sd
    yv = cv.cpu().double().mT[:, None, :]
    near = ((yv - lo_c).abs() <= tol * sdv) | ((yv - hi_c).abs() <= tol * sdv)
    errs['coverage'] = (float(np.abs(cov_d - cov_c).max()),
                        near.sum(-1).max().item() / len(Xv) + 1e-15)
    # the MD² grid: its ends are F quantiles x = (dfd/dfn)·w/(1 − w) of a
    # beta quantile w (betaincinv, kernel and plain version within
    # INCBETA_TOL of each other), so x moves by INCBETA_TOL/(w(1 − w));
    # the pdf is compared at the card's points
    xs_g, pdf_g = gd[name, 'md grid']
    xs_c, _ = gc._dist_grid(gc.md_ref_dist)
    dfn = cov.shape[0]
    x_std = xs_c[[0, -1]] / ((df - 2) * dfn / df)     # the F's scale
    w = dfn * x_std / (df + dfn * x_std)
    tol_w = INCBETA_TOL[torch.float64]['betaincinv']
    errs['md² grid points'] = (rel_err(xs_g, xs_c),
                               tol_w / float(np.min(w * (1 - w))))
    errs['md² grid pdf at the same points'] = (
        rel_err(pdf_g, gc.md_ref_dist.pdf(xs_g)), 1e-12)
    print(f'main path (derivatives, C): GraphicalDiagnostic at {len(Xv)} '
          f'points, nref {GD_NREF}, both coefficient processes; P1 launches '
          f'(TP) {launches["C TruncationTP"]}; the TP card vs CPU (cond(cov) '
          f'{cond:.3e}): ' + ', '.join(f'{k} {v:.3e} (limit {lim:.3e})'
                                       for k, (v, lim) in errs.items()))
    for k, (v, lim) in errs.items():
        check(v <= lim, f'C: {k} {v:.3e} > {lim:.3e}')
    for key, val in gd.items():
        if isinstance(key, tuple) and key[1] in gt.GraphicalDiagnostic.\
                _WHITENERS:
            check(np.isfinite(val[1]).all() and all(
                np.isfinite(b).all() for p in val[2] for b in p),
                f'C: {key} not finite')
    del gd, gc, gv

    # D: kl_data on leg B's recipe
    X3, y3, mean, cov, gp = kl_leg(device)
    gk = gt.GraphicalDiagnostic(y3, mean, cov, nref=KL_NREF,
                                colors=GD_COLORS, device=device)
    n_fit = KL_NREF + y3.shape[1]
    data_kl, ref_kl = leg('D', lambda: gk.kl_data(X3, gp, fit_kws=KL_FIT))
    want = k1_fit_launches(n_fit, KL_CHUNK, WIDE_MAXITER, WIDE_N)
    k1 = launches['D']['chol_inv_block']
    check(k1 == want, f'D: {k1} K1 launches, derived {want}')
    check(np.isfinite(data_kl).all() and np.isfinite(ref_kl).all(),
          'D: non-finite KL')
    # 'auto' against 'loop' on a few draws at a fixed θ (the batched
    # engine's shared factorization against one fit per draw), f64
    few = gt.GraphicalDiagnostic(y3[:, :1], mean, cov, nref=KL_LOOP,
                                 colors=GD_COLORS, device=device)
    gp_fixed = gt.ConjugateGaussianProcess(
        gp.kernel, df=3, scale=1, nugget=1e-6, optimizer=None, device=device)
    X64 = torch.tensor(X3, dtype=torch.float64, device=device)
    auto = few.kl_data(X64, gp_fixed, engine='auto')
    loop = few.kl_data(X64, gp_fixed, engine='loop')
    cond_k = torch.linalg.cond(cov).item()
    err_l = max(rel_err(a_, b_) for a_, b_ in zip(auto, loop))
    print(f'main path (derivatives, D): kl_data N={WIDE_N} f32 fits '
          f"('blocked'), {KL_NREF} draws + {y3.shape[1]} curves in "
          f'{ms["D"]:.1f} ms ({n_fit / ms["D"] * 1e3:.2f} fits/s), K1 '
          f'launches {k1} (derived {want}); data KL {data_kl.tolist()}, '
          f'reference KL median {np.median(ref_kl):.4g} range '
          f'[{ref_kl.min():.4g}, {ref_kl.max():.4g}]; auto vs loop on '
          f'{KL_LOOP} draws + 1 curve at a fixed θ: {err_l:.3e} (limit '
          f'{cond_tol(cond_k):.3e}, cond {cond_k:.3e})')
    check(err_l <= cond_tol(cond_k), f'D: auto vs loop {err_l:.3e}')
    print(f'timing [{card}] path 8: ' + ', '.join(
        f'{k} {v:.1f} ms' for k, v in ms.items())
        + f'; wall {time.perf_counter() - t_path:.1f} s (card and CPU)')
    if problems:
        raise AssertionError('path 8: ' + '; '.join(problems))
    return model, launches


# path 9: sampling and utilities
HMC_CHAINS = 4
# HMC steps: a gradient evaluation of 4 chains takes 25–40 ms on the card
# (host-bound: the device is 95% idle), so the runs are sized to about 35 s
# and 10 s.  A needs 10 leapfrog steps: the ratio's scale in z is several
# times ℓ's, and one step size serves both (4 steps gave it an ESS of 14)
HMC_TRUNC = dict(n_warmup=40, n_samples=50, n_leapfrog=10)
HMC_CGP = dict(n_warmup=30, n_samples=40, n_leapfrog=4)
HMC_CGP_N, PRED_N, PRED_DRAWS = 512, 32, 64
ELL_BOX, RATIO_BOX = (0.05, 1.0), (0.3, 0.7)    # leg E's grid ranges


def grid_posterior_means(surf, log_ell, ratios):
    """Posterior means of log ℓ and of the ratio from a (len(log_ell),
    len(ratios)) lml grid, trapezoid quadrature (flat in log ℓ and in the
    ratio, the sampler's prior); with the same on every other grid point,
    whose difference estimates the quadrature's error."""
    def means(s, le, r):
        w = np.exp(s - s.max())
        z = np.trapezoid(np.trapezoid(w, r, axis=1), le)
        m_l = np.trapezoid(np.trapezoid(w, r, axis=1) * le, le) / z
        m_r = np.trapezoid(np.trapezoid(w, le, axis=0) * r, r) / z
        return np.array([m_l, m_r])
    full = means(surf, log_ell, ratios)
    half = means(surf[::2, ::2], log_ell[::2], ratios[::2])
    return full, np.abs(full - half)


def sampling_path(trunc, model_a, card, device='cuda'):
    """Path 9: A, ``sample_truncation_posterior`` over (ℓ, ratio) on leg
    E's data against leg E's 100 × 80 grid posterior; B,
    ``sample_theta_posterior`` of path 3's CGP at N=512 and
    ``posterior_predictive`` at 32 points; C, ``checkpoint`` save → load of
    path 5's TruncationGP and path 8 A's model, predictions bit for bit; D,
    ``profiling.time_fn`` of one lml."""
    import tempfile

    import gsum_tpu_torch as gt
    from gsum_tpu_torch import checkpoint, profiling
    from gsum_tpu_torch.parallel import truncation_lml_grid
    from gsum_tpu_torch.sample import (posterior_predictive,
                                       sample_theta_posterior,
                                       sample_truncation_posterior)

    t_path = time.perf_counter()
    problems, launches, ms = [], {}, {}

    def check(ok, what):
        if not ok:
            problems.append(what)

    def leg(name, fn):
        (res, t), counts = drive(lambda: timed(fn))
        launches[name], ms[name] = counts, t
        print(f'main path (sampling, {name}): {t:.1f} ms, launches {counts}')
        return res

    # A: the joint (ℓ, ratio) posterior on leg E's data
    X, _, y, Xnew, _ = trunc_data(device)
    Xe, ye = X[::TGRID_STRIDE], y[::TGRID_STRIDE]
    kernel = gt.RBF(0.3, ELL_BOX) + gt.WhiteKernel(1e-4, 'fixed')
    tgp = gt.TruncationGP(kernel, ratio=TRUNC_RATIO, ref=TRUNC_REF,
                          optimizer=None, device=device,
                          **TGRID_PRIORS['gp'])
    tgp.fit(Xe, ye, orders=np.arange(GP_CURVES))
    draws, info = leg('A', lambda: sample_truncation_posterior(
        tgp, 'ratio', RATIO_BOX, n_chains=HMC_CHAINS, random_state=0,
        **HMC_TRUNC))
    log_ell = np.log(np.linspace(*ELL_BOX, TGRID_T))
    ratios = np.linspace(*RATIO_BOX, TGRID_R)
    thE = torch.tensor(np.stack([log_ell, np.full(TGRID_T, np.log(1e-4))], 1),
                       device=device)
    surf = truncation_lml_grid(trunc_kernel(), torch.tensor(Xe, device=device),
                               ye, np.arange(GP_CURVES),
                               torch.tensor(ratios, device=device), thE,
                               ref=TRUNC_REF, process='gp',
                               **TGRID_PRIORS['gp']).cpu().numpy()
    grid_m, quad_err = grid_posterior_means(surf, log_ell, ratios)
    s = draws.cpu().numpy().reshape(-1, 2)
    hmc_m = s.mean(0)
    mcse = s.std(0) / np.sqrt(info['ess'])
    lim = 4 * mcse + quad_err
    print(f'main path (sampling, A): TruncationGP N={len(Xe)} (ℓ, ratio), '
          f'{HMC_CHAINS} chains × {HMC_TRUNC}: means (log ℓ, ratio) '
          f'{hmc_m.tolist()} vs the {TGRID_T} × {TGRID_R} grid '
          f'{grid_m.tolist()}: |diff| {np.abs(hmc_m - grid_m).tolist()} '
          f'(limits 4 MCSE {(4 * mcse).tolist()} + the grid\'s quadrature '
          f'error {quad_err.tolist()}); ESS {info["ess"].tolist()}, split-R̂ '
          f'{info["rhat"].tolist()}, accept {info["accept_rate"].tolist()}, '
          f'step {info["step_size"].tolist()}')
    check(np.all(np.abs(hmc_m - grid_m) <= lim), 'A: HMC means vs grid')
    check(np.all(info['rhat'] < 1.05), f'A: split-R̂ {info["rhat"]}')
    # one gradient evaluation of the sampler's density, and the run's
    # share of idle device time over a short window
    from torch.func import grad_and_value, vmap

    z = torch.tensor([[math.log(0.3), TRUNC_RATIO]] * HMC_CHAINS,
                     device=device, dtype=torch.float64)
    X_, y_, o_ = tgp.X_train_, tgp.y_train_, np.arange(GP_CURVES)
    gv = vmap(grad_and_value(lambda x: tgp._joint_lml(
        x[:1], X_, y_, o_, ratio=x[1])))
    t_grad = time_ms({'gradient': lambda: gv(z)}, rounds=4)['gradient']
    n_grad = (HMC_TRUNC['n_warmup'] + HMC_TRUNC['n_samples']) \
        * HMC_TRUNC['n_leapfrog'] + 1
    print(f'timing [{card}] path 9 A: one gradient evaluation of {HMC_CHAINS} '
          f'chains {t_grad:.3f} ms; the run {ms["A"]:.1f} ms for {n_grad} '
          f'evaluations ({ms["A"] / n_grad:.3f} ms each)')
    # the profiler's window is one gradient evaluation: with a window of
    # 10 HMC steps, path 9's wall time on the H100 ran about 50 s above
    # the sum of its legs
    profile(f'HMC, one gradient evaluation of {HMC_CHAINS} chains '
            f'(N={len(Xe)}) [{card}]', lambda: gv(z))

    # B: path 3's CGP at N=512
    Xg, yg, _ = gp_data()
    gp = gp_model(device, optimizer=None)
    gp.fit(Xg[:HMC_CGP_N], yg[:HMC_CGP_N])
    thetas, info_b = leg('B', lambda: sample_theta_posterior(
        gp, n_chains=HMC_CHAINS, random_state=1, **HMC_CGP))
    flat = thetas.reshape(-1, thetas.shape[-1])
    picks = flat[torch.linspace(0, len(flat) - 1, PRED_DRAWS).long()]
    Xp = Xnew[:PRED_N]
    mean_p, std_p = leg('B predictive', lambda: posterior_predictive(
        gp, Xp, picks))
    gpc = gp_model('cpu', optimizer=None).fit(Xg[:HMC_CGP_N],
                                              yg[:HMC_CGP_N])
    mean_c, std_c = posterior_predictive(gpc, Xp, picks[:4].cpu())
    mean_g4, std_g4 = posterior_predictive(gp, Xp, picks[:4])
    conds = cond_of(gp.kernel_, picks[:4], gp.X_train_, gp.nugget)
    err_p = max(rel_err(mean_g4, mean_c, std_c.max()),
                rel_err(std_g4, std_c))
    lo_b, hi_b = gp.kernel_.bounds.T
    inside = bool(((flat.cpu().numpy() >= lo_b - 1e-9)
                   & (flat.cpu().numpy() <= hi_b + 1e-9)).all())
    print(f'main path (sampling, B): CGP N={HMC_CGP_N} θ = (log ℓ, log '
          f'noise), {HMC_CHAINS} chains × {HMC_CGP}: posterior means '
          f'{flat.mean(0).tolist()}, sd {flat.std(0).tolist()}, ESS '
          f'{info_b["ess"].tolist()}, split-R̂ {info_b["rhat"].tolist()}, '
          f'accept {info_b["accept_rate"].tolist()}, in the box {inside}; '
          f'posterior_predictive at {PRED_N} points over {PRED_DRAWS} draws '
          f'finite {bool(torch.isfinite(mean_p).all())}; 4 draws card vs '
          f'CPU {err_p:.3e} (limit {cond_tol(max(conds)):.3e})')
    # a short run (its R̂ and ESS are reported, not held: path 9 A holds
    # the sampler to a grid)
    check(inside and np.all(info_b['accept_rate'] > 0.5)
          and bool(torch.isfinite(mean_p).all() and torch.isfinite(
              std_p).all()) and mean_p.shape == (PRED_N, GP_CURVES),
          'B: the CGP posterior')
    check(err_p <= cond_tol(max(conds)), f'B: predictive card vs CPU '
          f'{err_p:.3e}')

    # C: checkpoints, predictions bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        def round_trip():
            same = {}
            m5 = trunc['TruncationGP']
            checkpoint.save(f'{tmp}/m5', m5)
            r5 = checkpoint.load(f'{tmp}/m5', trunc_model('TruncationGP',
                                                          device))
            checkpoint.save(f'{tmp}/ma', model_a)
            ra = checkpoint.load(f'{tmp}/ma', slope_model(m5, device))
            for label, (m, r, kw) in {
                    'path 5 both': (m5, r5, {}),
                    'A both': (model_a, ra, {}),
                    'A slope': (model_a, ra, dict(
                        kind='trunc', dorders=[[1, 0]] * 16))}.items():
                pts = Xnew if 'slope' not in label else Xnew[:16]
                got = r.predict(pts, TRUNC_ORDER, return_std=True, **kw)
                want = m.predict(pts, TRUNC_ORDER, return_std=True, **kw)
                same[label] = all(torch.equal(g, w)
                                  for g, w in zip(got, want))
            return same
        same = leg('C', round_trip)
    print(f'main path (sampling, C): checkpoint save → load, predictions '
          f'bit for bit on the card: {same}')
    check(all(same.values()), f'C: {same}')

    # D: profiling.time_fn of one lml
    th = torch.tensor(gp.kernel_.theta, device=device)
    t_lml = profiling.time_fn(lambda t: gp.log_marginal_likelihood(t), th)
    flops = profiling.flops_lml(HMC_CGP_N, GP_CURVES, 2)
    print(f'timing [{card}] path 9 D: profiling.time_fn of one lml at '
          f'N={HMC_CGP_N} (CUDA events) {t_lml * 1e3:.3f} ms, '
          f'{flops / t_lml / 1e9:.2f} GFLOP/s by flops_lml')
    check(0 < t_lml < 1, f'D: time_fn {t_lml}')
    print(f'timing [{card}] path 9: ' + ', '.join(
        f'{k} {v:.1f} ms' for k, v in ms.items())
        + f'; wall {time.perf_counter() - t_path:.1f} s (card and CPU)')
    if problems:
        raise AssertionError('path 9: ' + '; '.join(problems))
    return launches


# path 10: large N across devices, on one card: meshes that repeat cuda:0
MESH_D = 4                         # shards on the 'batch' and 'model' axes
MESH_GRID_G, MESH_FIT_B = 64, 256  # A: θ of the blocked sweep; leg A curves
BIG_N, BIG_NUGGET = 16384, 1e-4    # B: path 3's recipe, its White as nugget
CHOL_N = 8192                      # B: sharded_cholesky, sharded_mvn_lml
BIG_FD_H = 1e-3                    # B: central-difference step in log ℓ
SFIT_N, SFIT_MAXITER, SFIT_LS = 8192, 8, 5     # C: gsum_tpu/parallel/pchol.py:33-40
SFIT_NUGGET, SFIT_THETA_TOL, SFIT_LML_TOL = 1e-8, 1e-5, 1e-9
HMC_MESH = dict(n_warmup=10, n_samples=20, n_leapfrog=3)    # D
HMC_MESH_N, HMC_MESH_CHECK, HMC_MESH_TOL = 512, 8, 1e-9     # D


def square_data(n):
    """Path 3's recipe at n points: n points of the unit square from
    RandomState(0) and its 5 curves sin(3x₀ + k)·cos(2x₁) + 0.01·ε."""
    rng = np.random.RandomState(0)
    X = rng.rand(n, GP_D)
    y = np.stack([np.sin(3 * X[:, 0] + k) * np.cos(2 * X[:, 1])
                  for k in range(GP_CURVES)], axis=1) \
        + 0.01 * rng.randn(n, GP_CURVES)
    return X, y


def dense_kernel_lml(kernel, theta, X, y, nugget):
    """log N(y | 0, K + nugget·I) by ``torch.linalg.cholesky`` of the whole
    K, and Gershgorin's bound on K's condition number: its largest
    absolute row sum over the nugget (K's kernel part is PSD)."""
    K = kernel.value_fn(theta, X, None)
    K.diagonal().add_(nugget)
    cond = (K.abs().sum(1).max().item()) / nugget
    L = torch.linalg.cholesky(K)
    del K
    w = torch.linalg.solve_triangular(L, y, upper=False)
    return -0.5 * ((w ** 2).sum(0) + 2 * torch.log(L.diagonal()).sum()
                   + X.shape[0] * math.log(2 * math.pi)), cond


def mesh_path(card, device='cuda'):
    """Path 10: meshes of 4 shards on the one card.  A, the 'batch' axis:
    ``batched_lml_grid`` at N=4096 f32 (blocked, K1 in every shard's
    forward; its launches against the count derived from the code),
    ``batched_fit`` (JAX's per-fit route), ``pointwise_evidence_grid``,
    ``batched_posterior_at`` and ``batched_predict``, each against the
    unsharded call; B, the 'model' axis at N=16384 f64 (on-shard lml, the
    CGP lml and its forward-mode gradient against the dense route on the
    card and a central difference, each shard's memory beside the dense
    route's) and ``sharded_cholesky`` / ``sharded_mvn_lml`` at N=8192; C,
    ``sharded_fit`` at JAX's validated configuration against the dense
    fixed-trip fit; D, HMC on the mesh against the unsharded sampler; E,
    ``entry.dryrun_multichip(4)``."""
    import gsum_tpu_torch as gt
    from gsum_tpu_torch.entry import dryrun_multichip
    from gsum_tpu_torch.optimize import fixed_lbfgs_bounded
    from gsum_tpu_torch.parallel import (Mesh, batched_fit, batched_lml_grid,
                                         batched_posterior_at,
                                         batched_predict, make_mesh,
                                         pointwise_evidence_grid,
                                         sharded_cgp_lml, sharded_cholesky,
                                         sharded_fit, sharded_kernel_lml,
                                         sharded_mvn_lml)
    from gsum_tpu_torch.parallel.batched import _fit_one
    from gsum_tpu_torch.parallel.pchol import _cgp_lml_from_gram
    from gsum_tpu_torch.sample import sample_theta_posterior

    t_path = time.perf_counter()
    problems, launches, ms, peak = [], {}, {}, {}
    f64 = dict(dtype=torch.float64, device=device)
    t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731

    def check(ok, what):
        if not ok:
            problems.append(what)

    def leg(name, fn):
        torch.cuda.reset_peak_memory_stats()
        (res, t_ms), counts = drive(lambda: timed(fn))
        launches[name], ms[name] = counts, t_ms
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f'timing [{card}] path 10 {name}: {t_ms:.1f} ms, peak memory '
              f'{peak[name]:.3f} GiB, launches {counts}')
        return res

    batch_mesh = make_mesh(n_batch=MESH_D, n_model=1,
                           devices=[device] * MESH_D)
    model_mesh = Mesh([device] * MESH_D, ('model',))

    # A: the 'batch' axis, on path 7's data
    (X1, y1), _, (X3, y3) = scale_data()
    X3t, Y3t = t(X3), t(y3).T.contiguous()
    thA = t(np.log(np.linspace(0.1, 2.0, MESH_GRID_G))[:, None]
            .astype(np.float32))
    grid_kw = dict(df=3, scale=1, nugget=WIDE_NUGGET, precision='f32')
    # warm-up (the blocked engine's first calls at these shapes), outside
    # the driven legs
    batched_lml_grid(fit_kernel(), X3t, Y3t, thA, mesh=batch_mesh, **grid_kw)
    got = leg('A grid (mesh)', lambda: batched_lml_grid(
        fit_kernel(), X3t, Y3t, thA, mesh=batch_mesh, **grid_kw))
    want = leg('A grid (unsharded)', lambda: batched_lml_grid(
        fit_kernel(), X3t, Y3t, thA, **grid_kw))
    k1_want = MESH_D * -(-WIDE_N // 128)     # one per diagonal block a shard
    k1_got = launches['A grid (mesh)']['chol_inv_block']
    err = max_rel(got, want)
    print(f'path 10 A: batched_lml_grid over {MESH_GRID_G} θ at N={WIDE_N} '
          f'f32 (blocked engine) on {MESH_D} batch shards: vs unsharded max '
          f'rel {err:.3e} (limit 1e-6), bit for bit {torch.equal(got, want)}'
          f'; K1 launches {k1_got} (derived {k1_want}; unsharded '
          f"{launches['A grid (unsharded)']['chol_inv_block']})")
    check(err <= 1e-6 and bool(torch.isfinite(got).all()), f'A grid {err}')
    check(k1_got == k1_want, f'A grid: {k1_got} K1 launches, derived '
          f'{k1_want}')

    X1t, y1t = t(X1), t(y1[:MESH_FIT_B])
    fit_kw = dict(df=3, scale=1, maxiter=FIT_MAXITER)
    post = leg('A fit (mesh)', lambda: batched_fit(
        fit_kernel(), X1t, y1t, mesh=batch_mesh, **fit_kw))
    kf = fit_kernel()
    lo, hi = (t(b) for b in np.asarray(kf.bounds).T)
    ref = leg('A fit (unsharded _fit_one)', lambda: _fit_one(
        kf.clone(), X1t, y1t[:, :, None], torch.ones((FIT_N, 1), **f64),
        t(kf.theta)[None], lo, hi, np.zeros(1), np.zeros((1, 1)), 3, 1,
        1e-10, FIT_MAXITER))
    dth = (post.theta - ref.theta).abs().max().item()
    dlml = max_rel(post.lml, ref.lml)
    print(f'path 10 A: batched_fit of {MESH_FIT_B} leg A curves (N={FIT_N} '
          f'f64, maxiter {FIT_MAXITER}) on the mesh vs the same pairs '
          f'through _fit_one unsharded: θ max abs {dth:.3e} (limit '
          f'{SFIT_THETA_TOL:g}), lml max rel {dlml:.3e} (limit '
          f'{SFIT_LML_TOL:g}), bit for bit '
          f'{torch.equal(post.theta, ref.theta)}; '
          f'{MESH_FIT_B / ms["A fit (mesh)"] * 1e3:.1f} fits/s on the mesh, '
          f'{MESH_FIT_B / ms["A fit (unsharded _fit_one)"] * 1e3:.1f} '
          f'unsharded')
    check(dth <= SFIT_THETA_TOL and dlml <= SFIT_LML_TOL, f'A fit {dth} '
          f'{dlml}')

    _, _, yF, _, _ = trunc_data(device)
    ratF = t(PW_RATIOS)
    pw_kw = dict(ref=TRUNC_REF, **PW_PRIORS['df=1, scale=1'])
    got = leg('A pointwise (mesh)', lambda: pointwise_evidence_grid(
        yF, np.arange(GP_CURVES), ratF, mesh=batch_mesh, **pw_kw))
    want = pointwise_evidence_grid(yF, np.arange(GP_CURVES), ratF, **pw_kw)
    err = max_rel(got, want)
    print(f'path 10 A: pointwise_evidence_grid at {len(PW_RATIOS)} ratios on '
          f'the mesh vs unsharded max rel {err:.3e} (limit 1e-12)')
    check(err <= 1e-12, f'A pointwise {err}')

    thG = post.theta[:POST_B]
    Xnew = t(np.linspace(0, 1, POST_NEW)[:, None])
    yG = y1t[0].expand(POST_B, FIT_N)

    def posterior_and_predict(mesh):
        p = batched_posterior_at(fit_kernel(), X1t, y1t[0], thG, df=3,
                                 scale=1, mesh=mesh)
        return p, batched_predict(fit_kernel(), p, X1t, yG, Xnew,
                                  student=True, mesh=mesh)
    got = leg('A posterior + predict (mesh)',
              lambda: posterior_and_predict(batch_mesh))
    want = posterior_and_predict(None)
    err = max(max_rel(got[0].lml, want[0].lml),
              max_rel(got[0].scale_sq, want[0].scale_sq),
              rel_err(got[1][0], want[1][0]), rel_err(got[1][1], want[1][1]))
    print(f'path 10 A: batched_posterior_at + batched_predict at {POST_B} θ '
          f'on the mesh vs unsharded: max rel {err:.3e} (limit 1e-12)')
    check(err <= 1e-12, f'A posterior + predict {err}')

    # B: the 'model' axis at full width
    Xb, yb = square_data(BIG_N)
    Xbt, ybt = t(Xb), t(yb)
    kb = gt.RBF(0.3, (1e-2, 10))
    thb = t(kb.theta)
    got = leg('B sharded_kernel_lml', lambda: sharded_kernel_lml(
        kb.value_fn, thb, Xbt, ybt, model_mesh, nugget=BIG_NUGGET))
    want, cond = leg('B dense lml (torch.linalg)', lambda: dense_kernel_lml(
        kb, thb, Xbt, ybt, BIG_NUGGET))
    err = max_rel(got, want)
    print(f'path 10 B: sharded_kernel_lml N={BIG_N} d={GP_D} f64 RBF(0.3) '
          f'+ nugget {BIG_NUGGET:g}, {GP_CURVES} curves, {MESH_D} shards: '
          f'vs dense max rel {err:.3e} (limit cond·ε {cond_tol(cond):.3e}, '
          f'cond ≤ {cond:.3e})')
    check(err <= cond_tol(cond), f'B kernel lml {err}')

    basis = torch.ones((BIG_N, 1), **f64)
    prior = (np.zeros(1), np.zeros((1, 1)), 3.0, 1.0)

    def cgp_value(th):
        return sharded_cgp_lml(kb.value_fn, th, Xbt, ybt, basis, *prior,
                               model_mesh, nugget=BIG_NUGGET)

    def cgp_grad(value=cgp_value, th=thb):
        th = th.clone().requires_grad_(True)
        v = value(th)
        return v.detach(), torch.autograd.grad(v, th)[0]
    # warm-up: torch's first forward-mode pass in a process costs ~3 s
    cgp_grad(lambda th: sharded_cgp_lml(
        kb.value_fn, th, Xbt[:8], ybt[:8], basis[:8], *prior, model_mesh,
        nugget=BIG_NUGGET))
    v_s, g_s = leg('B sharded_cgp_lml + gradient', cgp_grad)
    gp = gt.ConjugateGaussianProcess(kb, center=0, disp=0, df=3, scale=1,
                                     nugget=BIG_NUGGET, optimizer=None,
                                     device=device)
    v_d, g_d = leg('B dense CGP lml + gradient (the model)', lambda:
                   gp.log_marginal_likelihood(thb, eval_gradient=True,
                                              X=Xbt, y=ybt))
    with torch.no_grad():
        fd = {h: (cgp_value(thb + h) - cgp_value(thb - h)).item() / (2 * h)
              for h in (BIG_FD_H, 2 * BIG_FD_H)}
    # the difference's truncation error is about |D(h) − D(2h)| / 3; its
    # round-off at most 2δ/(2h), δ = cond·ε·|lml|
    fd_lim = abs(fd[BIG_FD_H] - fd[2 * BIG_FD_H]) \
        + 3 * cond_tol(cond) * abs(v_s.item()) / BIG_FD_H
    e_v = max_rel(v_s, v_d)
    e_g = max_rel(g_s, g_d)
    e_fd = abs(g_s.item() - fd[BIG_FD_H])
    print(f'path 10 B: sharded_cgp_lml {v_s.item():.10e}, gradient '
          f'{g_s.item():.10e}; vs the dense model: lml rel {e_v:.3e}, '
          f'gradient rel {e_g:.3e} (limit {cond_tol(cond):.3e}); vs a '
          f'central difference (h {BIG_FD_H:g}) {fd[BIG_FD_H]:.10e}: |diff| '
          f'{e_fd:.3e} (limit {fd_lim:.3e})')
    check(e_v <= cond_tol(cond) and e_g <= cond_tol(cond) and e_fd <= fd_lim,
          f'B cgp lml {e_v} gradient {e_g} fd {e_fd}')

    # one shard's memory: shard 3 (the widest rows) alone on the card, the
    # other three on the CPU
    mixed = Mesh(['cpu'] * (MESH_D - 1) + [device], ('model',))
    got_m = leg('B sharded_kernel_lml, shard 3 alone on the card',
                lambda: sharded_kernel_lml(kb.value_fn, thb, Xbt, ybt, mixed,
                                           nugget=BIG_NUGGET))
    err_m = max_rel(got_m, want)
    nl = BIG_N // MESH_D
    print(f'path 10 B: memory at N={BIG_N} f64: dense route peak '
          f"{peak['B dense lml (torch.linalg)']:.3f} GiB (N²·8 B = "
          f'{BIG_N ** 2 * 8 / 2 ** 30:.3f} GiB); the {MESH_D} shards '
          f"together on the card {peak['B sharded_kernel_lml']:.3f} GiB; "
          f'shard 3 alone {peak["B sharded_kernel_lml, shard 3 alone on the card"]:.3f}'
          f' GiB (3·Nl·N·8 B = {3 * nl * BIG_N * 8 / 2 ** 30:.3f} GiB); '
          f'its lml vs dense max rel {err_m:.3e}')
    check(err_m <= cond_tol(cond) and peak[
        'B sharded_kernel_lml, shard 3 alone on the card']
        < peak['B dense lml (torch.linalg)'], f'B shard memory / {err_m}')

    K8 = kb.value_fn(thb, Xbt[:CHOL_N], None)
    K8.diagonal().add_(BIG_NUGGET)
    cond8 = K8.abs().sum(1).max().item() / BIG_NUGGET
    L_s = leg('B sharded_cholesky', lambda: sharded_cholesky(K8, model_mesh))
    L_d = torch.linalg.cholesky(K8)
    e_l = ((L_s - L_d).abs().max() / L_d.abs().max()).item()
    lml8 = leg('B sharded_mvn_lml', lambda: sharded_mvn_lml(
        K8, ybt[:CHOL_N], model_mesh))
    w8 = torch.linalg.solve_triangular(L_d, ybt[:CHOL_N], upper=False)
    want8 = -0.5 * ((w8 ** 2).sum(0) + 2 * torch.log(L_d.diagonal()).sum()
                    + CHOL_N * math.log(2 * math.pi))
    e_8 = max_rel(lml8, want8)
    del K8, L_s, L_d
    print(f'path 10 B: sharded_cholesky N={CHOL_N} vs torch.linalg: max abs '
          f'/ max|L| {e_l:.3e}; sharded_mvn_lml vs dense max rel {e_8:.3e} '
          f'(limit cond·ε {cond_tol(cond8):.3e})')
    check(e_l <= cond_tol(cond8) and e_8 <= cond_tol(cond8),
          f'B sharded_cholesky {e_l} mvn {e_8}')

    # C: sharded_fit at the JAX package's validated configuration
    Xc = t(np.linspace(0, 1, SFIT_N)[:, None])
    gen = gt.Matern(0.2, (1e-2, 1e2), nu=1.5)
    Kg = gen.value_fn(t(gen.theta), Xc, None)
    Kg.diagonal().add_(SFIT_NUGGET)
    yc = torch.linalg.cholesky(Kg) @ t(np.random.RandomState(13).randn(
        SFIT_N, 2))
    del Kg
    kc = gt.Matern(0.5, (1e-2, 1e2), nu=1.5)
    basis_c = torch.ones((SFIT_N, 1), **f64)
    c0, V0 = np.zeros(1), np.zeros((1, 1))
    th_s, lml_s = leg('C sharded_fit', lambda: sharded_fit(
        kc, Xc, yc, basis_c, c0, V0, 3.0, 1.0, model_mesh,
        nugget=SFIT_NUGGET, maxiter=SFIT_MAXITER, ls_steps=SFIT_LS))
    Zc = torch.cat([yc, basis_c], 1)

    def dense_obj(th):
        K = kc.value_fn(th, Xc, None)
        K = K + SFIT_NUGGET * torch.eye(SFIT_N, **f64)
        L = torch.linalg.cholesky(K)
        W = torch.linalg.solve_triangular(L, Zc, upper=False)
        return -_cgp_lml_from_gram(
            W.mT @ W, 2.0 * torch.log(L.diagonal()).sum(), SFIT_N, 2, c0, V0,
            3.0, 1.0)
    bc = np.asarray(kc.bounds, float).reshape(-1, 2)
    th_d, f_d = leg('C dense fixed-trip fit', lambda: fixed_lbfgs_bounded(
        dense_obj, t(kc.theta), bc[:, 0], bc[:, 1], maxiter=SFIT_MAXITER,
        ls_steps=SFIT_LS))
    # the dense objective in another elimination order (rows permuted):
    # the round-off floor of its value at the sharded θ, and of the fit
    perm = torch.randperm(SFIT_N, generator=torch.Generator().manual_seed(0))

    def dense_perm(th):
        K = kc.value_fn(th, Xc[perm], None)
        K = K + SFIT_NUGGET * torch.eye(SFIT_N, **f64)
        L = torch.linalg.cholesky(K)
        W = torch.linalg.solve_triangular(L, Zc[perm], upper=False)
        return -_cgp_lml_from_gram(
            W.mT @ W, 2.0 * torch.log(L.diagonal()).sum(), SFIT_N, 2, c0, V0,
            3.0, 1.0)
    th_dp, _ = fixed_lbfgs_bounded(dense_perm, t(kc.theta), bc[:, 0],
                                   bc[:, 1], maxiter=SFIT_MAXITER,
                                   ls_steps=SFIT_LS)
    with torch.no_grad():
        self_lml = -dense_obj(th_s)
        floor_lml = max_rel(-dense_perm(th_s), self_lml)
    floor_th = (th_dp - th_d).abs().max().item()
    print(f'path 10 C: the dense objective with its rows permuted: lml at '
          f'the sharded θ rel {floor_lml:.3e}, its fit |Δθ| {floor_th:.3e}')
    dth = (th_s - th_d).abs().max().item()
    e_self = max_rel(lml_s, self_lml)
    # JAX's contract, or twice the dense route's own round-off where that
    # is larger: at this conditioning a reordering of the dense objective
    # moves its fixed-trip fit by more than 1e-5
    lim_th = max(SFIT_THETA_TOL, 2 * floor_th)
    lim_lml = max(SFIT_LML_TOL, 2 * floor_lml)
    print(f'path 10 C: sharded_fit N={SFIT_N} Matern 1.5 from ℓ 0.5 (2 '
          f'curves drawn at ℓ 0.2), maxiter {SFIT_MAXITER}, ls_steps '
          f'{SFIT_LS}, {MESH_D} shards: ℓ {th_s.exp().tolist()} vs dense '
          f'{th_d.exp().tolist()}: |Δθ| {dth:.3e} (JAX\'s contract '
          f'{SFIT_THETA_TOL:g}, limit {lim_th:.3e}); lml '
          f'{lml_s.item():.10e} vs the dense objective at its θ rel '
          f'{e_self:.3e} (JAX\'s contract {SFIT_LML_TOL:g}, limit '
          f'{lim_lml:.3e}); the two optima\'s lml rel '
          f'{max_rel(lml_s, -f_d):.3e}')
    check(dth <= lim_th and e_self <= lim_lml,
          f'C sharded_fit {dth} {e_self}')

    # D: HMC on the mesh, path 9 B's CGP with its White as the nugget (the
    # sharded build's two-argument kernel has no WhiteKernel)
    Xg, yg, _ = gp_data()
    gpd = gp_model(device, optimizer=None, kernel=gt.RBF(0.3, (1e-2, 10)),
                   nugget=1e-4).fit(Xg[:HMC_MESH_N], yg[:HMC_MESH_N])
    s_m, info_m = leg('D HMC on the mesh', lambda: sample_theta_posterior(
        gpd, n_chains=HMC_CHAINS, random_state=1, mesh=model_mesh,
        **HMC_MESH))
    s_p, info_p = leg('D HMC unsharded', lambda: sample_theta_posterior(
        gpd, n_chains=HMC_CHAINS, random_state=1, **HMC_MESH))
    flat_p = s_p.reshape(-1, s_p.shape[-1])
    picks = flat_p[torch.linspace(0, len(flat_p) - 1, HMC_MESH_CHECK).long()]
    # the draws sit near the mode, where the gradient is a cancellation:
    # its error is measured against the gradient's scale at the start θ
    _, g_start = gpd.log_marginal_likelihood(t(gpd.kernel_.theta),
                                             eval_gradient=True)
    g_scale = g_start.abs().max().item()
    e_ld = e_gd = 0.0
    for th in picks:
        th = th.clone().requires_grad_(True)
        v = sharded_cgp_lml(gpd.kernel_.value_fn, th, gpd.X_train_,
                            gpd.y_train_, gpd.basis_train_, np.zeros(1),
                            np.zeros((1, 1)), 3.0, 1.0, model_mesh,
                            nugget=gpd.nugget)
        g = torch.autograd.grad(v, th)[0]
        v_d, g_d = gpd.log_marginal_likelihood(th.detach(),
                                               eval_gradient=True)
        e_ld = max(e_ld, max_rel(v, v_d))
        e_gd = max(e_gd, rel_err(g, g_d, g_scale))
    m_m, m_p = (s.reshape(-1, s.shape[-1]).mean(0).cpu().numpy()
                for s in (s_m, s_p))
    sd = flat_p.std(0).cpu().numpy()
    mcse = sd * np.sqrt(1 / info_m['ess'] + 1 / info_p['ess'])
    n_grad = (HMC_MESH['n_warmup'] + HMC_MESH['n_samples']) \
        * HMC_MESH['n_leapfrog'] + 1
    print(f'path 10 D: HMC of a CGP at N={HMC_MESH_N} on {MESH_D} model '
          f'shards, {HMC_CHAINS} chains × {HMC_MESH}: log ℓ mean {m_m} vs '
          f'unsharded {m_p} (|diff| {np.abs(m_m - m_p)}, limit 4 MCSE '
          f'{4 * mcse}); ESS {info_m["ess"]} / {info_p["ess"]}; logdensity '
          f'at {HMC_MESH_CHECK} unsharded draws rel {e_ld:.3e}, gradient '
          f'{e_gd:.3e} of its scale at the start {g_scale:.3e} (limit '
          f'{HMC_MESH_TOL:g}); '
          f'{ms["D HMC on the mesh"] / n_grad:.2f} ms a gradient evaluation '
          f'on the mesh, {ms["D HMC unsharded"] / n_grad:.2f} unsharded')
    check(np.all(np.abs(m_m - m_p) <= 4 * mcse) and e_ld <= HMC_MESH_TOL
          and e_gd <= HMC_MESH_TOL, f'D HMC {e_ld} {e_gd}')

    # E: the twin of __graft_entry__.dryrun_multichip on 4 shards of the card
    leg('E dryrun_multichip(4)', lambda: dryrun_multichip(MESH_D))

    for name, counts in launches.items():
        want = k1_want if name == 'A grid (mesh)' else \
            -(-WIDE_N // 128) if name == 'A grid (unsharded)' else 0
        check(counts['chol_inv_block'] == want and sum(counts.values())
              == counts['chol_inv_block'], f'{name}: launches {counts}')
    print(f'timing [{card}] path 10: wall {time.perf_counter() - t_path:.1f} '
          f's (card and CPU)')
    if problems:
        raise AssertionError('path 10: ' + '; '.join(problems))
    return launches


def drive(fn):
    """Runs ``fn`` once with every kernel's launch count set to 0 just
    before; returns its result and the counts read just after."""
    import operator

    from gsum_tpu_torch import ops

    counters = {name: operator.attrgetter(name)(ops) for name in KERNELS}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: f.launches for name, f in counters.items()}


def profile(label, fn):
    """One torch.profiler window over ``fn`` (after a warm-up call): device
    time by kernel, and the share of the window with no kernel running."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == 'CUDA']
    busy = sum(ms for _, ms, _ in rows)
    print(f'profile {label}: window {window:.3f} ms, device busy '
          f'{busy:.3f} ms, idle share {max(0.0, 1 - busy / window):.1%}')
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f'  {ms:9.3f} ms  x{count:4d}  {key[:90]}')


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this check needs a CUDA card')
    from gsum_tpu_torch import _build
    from gsum_tpu_torch.ops import (batched_chol_logpdf, chol_inv_block,
                                    chol_inv_block_plain,
                                    fused_blocked_cholesky,
                                    fused_blocked_cholesky_plain,
                                    rbf_covariance, rbf_covariance_pallas,
                                    rbf_covariance_pallas_plain)

    t_script = time.perf_counter()
    device = torch.device('cuda:0')
    card = card_line()
    print(card)
    print(f'python {sys.version.split()[0]} torch {torch.__version__} '
          f'cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'torch.backends.cuda.matmul.allow_tf32='
          f'{torch.backends.cuda.matmul.allow_tf32} '
          f'torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load()
    print(f'build: {time.perf_counter() - t0:.1f} s -> {path.name}')
    for line in log.splitlines():
        if ('Compiling entry' in line or 'registers' in line
                or 'spill' in line):
            print('  ' + line.strip())

    rng = np.random.RandomState(0)
    check_kernel(rng, device)
    check_rbf(device)
    check_fused(device)
    check_incbeta(device)
    print('kernel checks passed')

    rng = np.random.RandomState(0)   # bench.py's inputs
    X = torch.tensor(rng.rand(B, N, D), dtype=torch.float32, device=device)
    y = torch.tensor(rng.randn(B, N, M), dtype=torch.float32, device=device)

    def pipeline(**kw):
        return lambda: batched_chol_logpdf(X, y, LS, AMP, NOISE, **kw)

    # path 0: the blocked route
    torch.cuda.reset_peak_memory_stats()
    out, counts = drive(pipeline(method='auto'))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'main path (blocked): batched_chol_logpdf B={B} N={N} d={D} m={M} '
          f'f32: launches {counts}, peak memory {peak_gib:.2f} GiB')
    launches = {'chol_inv_block': counts['chol_inv_block']}
    if counts['chol_inv_block'] != N // 128:   # one per diagonal block
        raise AssertionError(f'expected {N // 128} chol_inv_block launches, '
                             f'got {counts}')
    if out.shape != (B, M) or not torch.isfinite(out).all():
        raise AssertionError(f'bad output: shape {tuple(out.shape)}, finite '
                             f'{torch.isfinite(out).all().item()}')
    ref = reference_logpdf(X, y)
    rel_ref = max_rel(out, ref)
    rel_plain = max_rel(out, pipeline(method='auto', diag='recursive')())
    print(f'main path (blocked): max rel diff vs f64 reference {rel_ref:.3e}, '
          f'vs plain diagonal engine {rel_plain:.3e} (limit {REL_TOL:g})')
    if not (rel_ref <= REL_TOL and rel_plain <= REL_TOL):
        raise AssertionError('blocked route disagrees with its references')
    print(f'context: f32 torch.linalg.cholesky pipeline vs f64 reference '
          f'{max_rel(pipeline(method="xla")(), ref):.3e}')
    # the 3xTF32 opt-in on the headline and at larger nuggets, measured
    # against the limit
    for noise in (NOISE, 1e-1, 1.0):
        got = batched_chol_logpdf(X, y, LS, AMP, noise, precision='high')
        rel_tf32 = max_rel(got, ref if noise == NOISE
                           else reference_logpdf(X, y, noise))
        print(f'3xTF32 opt-in (blocked route, precision=high) at nugget '
              f'{noise:g} vs f64 reference: max rel {rel_tf32:.3e}, '
              f'non-finite logpdfs {(~torch.isfinite(got)).sum().item()} of '
              f'{got.numel()}, limit {REL_TOL:g}: '
              f'{"within" if rel_tf32 <= REL_TOL else "OUTSIDE"} the limit')
    print(f'allow_tf32 after the calls '
          f'{torch.backends.cuda.matmul.allow_tf32}')
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('precision=high left TF32 on')

    # path 1: the fused route
    torch.cuda.reset_peak_memory_stats()
    fused_out, counts = drive(pipeline(method='fused'))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'main path (fused): batched_chol_logpdf method=fused: launches '
          f'{counts}, peak memory {peak_gib:.2f} GiB')
    launches['fused_blocked_cholesky'] = counts['fused_blocked_cholesky']
    if counts['fused_blocked_cholesky'] != 1 or counts['chol_inv_block']:
        raise AssertionError(f'expected one fused launch and no diagonal '
                             f'kernel launch, got {counts}')
    if fused_out.shape != (B, M) or not torch.isfinite(fused_out).all():
        raise AssertionError('bad output from the fused route')
    rel_ref = max_rel(fused_out, ref)
    rel_blocked = max_rel(fused_out, out)
    print(f'main path (fused): max rel diff vs f64 reference {rel_ref:.3e}, '
          f'vs blocked route {rel_blocked:.3e} (limit {REL_TOL:g})')
    if not (rel_ref <= REL_TOL and rel_blocked <= REL_TOL):
        raise AssertionError('fused route disagrees with its references')
    del ref

    # path 2: the tiled covariance build
    Kc, counts = drive(lambda: rbf_covariance_pallas(X, LS, AMP, NOISE))
    print(f'main path (covariance): rbf_covariance_pallas B={B} N={N} d={D}: '
          f'launches {counts}')
    launches['rbf_covariance_pallas'] = counts['rbf_covariance_pallas']
    if counts['rbf_covariance_pallas'] != 1:
        raise AssertionError(f'expected one rbf_covariance_pallas launch, '
                             f'got {counts}')
    if Kc.shape != (B, N, N) or not torch.isfinite(Kc).all():
        raise AssertionError('bad output from rbf_covariance_pallas')
    Xd = X.double() / LS
    K64 = AMP * torch.exp(-0.5 * torch.cdist(Xd, Xd).square_())
    K64.diagonal(dim1=-2, dim2=-1).add_(NOISE)
    err64 = (Kc.double() - K64).abs().max().item()
    del K64, Xd
    symmetric = torch.equal(Kc, Kc.mT)
    print(f'main path (covariance): max |K - K64| {err64:.3e} (limit 1e-5), '
          f'K == K.mT {symmetric}')
    if not (err64 <= 1e-5 and symmetric):
        raise AssertionError('rbf_covariance_pallas disagrees with f64')

    # timings
    flops = flops_chol_logpdf(B, N, D, M)
    times = time_ms({'blocked, kernel diag (auto)': pipeline(method='auto'),
                     'blocked, 3xTF32 GEMMs (precision=high)': pipeline(
                         method='auto', precision='high'),
                     'blocked, plain diag': pipeline(method='auto',
                                                     diag='recursive'),
                     'torch.linalg.cholesky (xla)': pipeline(method='xla'),
                     'fused, block 256': pipeline(method='fused'),
                     'fused, block 128': pipeline(method='fused',
                                                  block=128)})
    for label, ms in times.items():
        print(f'timing [{card}] pipeline {label}: {ms:.3f} ms '
              f'{flops / ms / 1e6:.1f} GFLOP/s')

    kernels = []

    def record(name, err, t, library_ms, bnd):
        source, replaces = KERNELS[name]
        kernels.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': launches[name],
                        'max_abs_err': err, 'ms': t['kernel'],
                        'plain_ms': t['plain'], 'bound_ms': bnd[0],
                        'bound_by': bnd[1], 'library_ms': library_ms})

    for nb in (128, 256):
        K = spd_blocks(rng, B, nb, device)
        L, Minv = chol_inv_block(K)
        Lp, Mp = chol_inv_block_plain(K)
        err = max((L - Lp).abs().max().item(), (Minv - Mp).abs().max().item())
        eye = torch.eye(nb, device=device).expand_as(K)
        t = time_ms({'kernel': lambda: chol_inv_block(K),
                     'plain': lambda: chol_inv_block_plain(K),
                     'library': lambda: torch.linalg.cholesky_ex(K),
                     'pair': lambda: torch.linalg.solve_triangular(
                         torch.linalg.cholesky_ex(K).L, eye, upper=False)},
                    reps=10)
        bnd = bound_chol_inv(B, nb)
        print(f'timing [{card}] chol_inv_block ({B}, {nb}, {nb}): kernel '
              f'{t["kernel"]:.4f} ms, plain {t["plain"]:.4f} ms, '
              f'torch.linalg.cholesky_ex (L only) {t["library"]:.4f} ms, '
              f'bound {bnd[0]:.5f} ms ({bnd[1]}), max abs diff {err:.3e}; '
              f'context: cholesky_ex + solve_triangular(L, I), the pair '
              f'that computes what the kernel does, {t["pair"]:.4f} ms')
        if nb == 128:      # the blocked route's shape
            record('chol_inv_block', err, t, t['library'], bnd)

    K = rbf_covariance(X, LS, AMP, NOISE)       # the pipeline's K
    L, _ = fused_blocked_cholesky(K, tril=True)
    Lp, _ = fused_blocked_cholesky_plain(K)
    err = (L - Lp).abs().max().item()
    del L, Lp
    t = time_ms({'kernel': lambda: fused_blocked_cholesky(K),
                 'plain': lambda: fused_blocked_cholesky_plain(K),
                 'library': lambda: torch.linalg.cholesky(K),
                 'kernel, block 128': lambda: fused_blocked_cholesky(
                     K, block=128)})
    bnd = bound_fused(B, N, 256)
    print(f'timing [{card}] fused_blocked_cholesky ({B}, {N}, {N}) block 256: '
          f'kernel {t["kernel"]:.3f} ms (block 128: '
          f'{t["kernel, block 128"]:.3f} ms), plain {t["plain"]:.3f} ms, '
          f'torch.linalg.cholesky (L only) {t["library"]:.3f} ms, bound '
          f'{bnd[0]:.3f} ms ({bnd[1]}, {flops_fused(B, N, 256) / 1e9:.1f} '
          f'GFLOP), max abs diff {err:.3e}')
    record('fused_blocked_cholesky', err, t, t['library'], bnd)
    del K

    err = (Kc - rbf_covariance_pallas_plain(X, LS, AMP, NOISE)
           ).abs().max().item()
    del Kc
    out = torch.empty(B, N, N, device=device)
    X64 = X.double()
    out64 = torch.empty(B, N, N, dtype=torch.float64, device=device)
    t = time_ms({'kernel': lambda: rbf_covariance_pallas(X, LS, AMP, NOISE),
                 'plain': lambda: rbf_covariance_pallas_plain(X, LS, AMP,
                                                              NOISE),
                 'expansion': lambda: rbf_covariance(X, LS, AMP, NOISE),
                 'fill': lambda: out.fill_(1.0),
                 'kernel f64': lambda: rbf_covariance_pallas(X64, LS, AMP,
                                                             NOISE),
                 'fill f64': lambda: out64.fill_(1.0)}, reps=10)
    del out, out64
    bnd = bound_rbf(B, N, D)
    bnd64 = bound_rbf(B, N, D, itemsize=8)
    print(f'timing [{card}] rbf_covariance_pallas ({B}, {N}, {D}) f32: '
          f'kernel {t["kernel"]:.4f} ms, plain {t["plain"]:.4f} ms, '
          f'ops.rbf_covariance (expansion form) {t["expansion"]:.4f} ms, '
          f'bound {bnd[0]:.4f} ms ({bnd[1]}), max abs diff {err:.3e}; no '
          f'single PyTorch call computes it; context: fill_(1.0) of the '
          f'same 1 GiB {t["fill"]:.4f} ms; f64: kernel '
          f'{t["kernel f64"]:.4f} ms, fill_ of its 2 GiB '
          f'{t["fill f64"]:.4f} ms, bound {bnd64[0]:.4f} ms ({bnd64[1]})')
    record('rbf_covariance_pallas', err, t, None, bnd)

    for label, kw in (('blocked', {'method': 'auto'}),
                      ('blocked 3xTF32', {'method': 'auto',
                                          'precision': 'high'}),
                      ('fused', {'method': 'fused'})):
        profile(f'pipeline {label} [{card}]', pipeline(**kw))

    # path 3: the single-model conjugate GP, f64; path 4: blocked autograd;
    # path 5: the truncation models at path 3's width
    gp, Xnew, _ = single_model_path(card)
    time_single_model(gp, Xnew, card)
    blocked_autograd_path(X, y, card)
    del X, y
    trunc = truncation_path(gp, card)
    del gp
    time_truncation(trunc, card)
    # path 6: the model-checking slice on path 5's models and data
    checked, counts = model_checking_path(trunc, card)
    time_model_checking(checked, card, kernels, counts)
    loglikes = {name: checked['pointwise'][name, 'loglike']
                for name in PW_PRIORS}
    del checked
    # path 7: batched throughput
    batched_path(card, loglikes)
    # paths 8 and 9: model checking with derivative observations, and
    # sampling and the utilities, on path 5's models
    t89 = time.perf_counter()
    model_a, launches8 = derivative_checking_path(trunc, card)
    t8 = time.perf_counter() - t89
    launches9 = sampling_path(trunc, model_a, card)
    t9 = time.perf_counter() - t89 - t8
    del trunc, model_a
    # path 10: large N across devices, on meshes that repeat the card
    t10 = time.perf_counter()
    launches10 = mesh_path(card)
    t10 = time.perf_counter() - t10
    for path, counts in (('8', launches8), ('9', launches9)):
        print(f'main path (paths 8-9): path {path} launches by leg: '
              + '; '.join(f'{leg} {c}' for leg, c in counts.items()))
    print('main path (path 10) launches by leg: ' + '; '.join(
        f'{leg} {c}' for leg, c in launches10.items()))
    print(f'timing [{card}] path 8 {t8:.1f} s, path 9 {t9:.1f} s, together '
          f'{t8 + t9:.1f} s; path 10 {t10:.1f} s')
    print(f'timing [{card}] wall time of the whole script '
          f'{time.perf_counter() - t_script:.1f} s')

    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
