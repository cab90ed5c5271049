"""The CUDA kernels on the card, each against its plain PyTorch version: the
diagonal-block factor and inverse, the single-kernel blocked Cholesky and
the tiled RBF covariance build; the differentiable blocked functions in f32
through the diagonal kernel, their gradients against an f64
``torch.linalg`` autograd reference; the conjugate GP's lml and gradient
on the card against the CPU; the incomplete-beta kernels against their plain
versions, and the t quantile, ``TruncationPointwise`` and ``Diagnostic`` on
the card against the CPU; the batched engines and sweeps; derivative
covariances, ``GraphicalDiagnostic``'s data, one HMC proposal and a
checkpoint round trip on the card; a 4-shard mesh on one card against the
dense route, and a mesh on a card that is not there.  Marked ``gpu``: every test skips where there is
no CUDA card.

The file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q``.
"""
import numpy as np
import pytest
import torch

import gsum_tpu_torch as gt
from gsum_tpu_torch.ops import (batched_blocked_cholesky, batched_chol_logpdf,
                                blocked_spd_solve_logdet, chol_inv_block,
                                chol_inv_block_plain, fused_blocked_cholesky,
                                fused_blocked_cholesky_plain, rbf_covariance,
                                rbf_covariance_pallas,
                                rbf_covariance_pallas_plain)
from gsum_tpu_torch.profiling import counters

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    # full-f32 products: the plain version must not round through TF32
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device('cuda:0')


def _blocks(B, nb, device, seed=0):
    A = np.random.RandomState(seed).randn(B, nb, nb)
    K = A @ np.swapaxes(A, -1, -2) / nb + np.eye(nb)
    return torch.tensor(K, dtype=torch.float32, device=device)


@pytest.mark.parametrize('B', [1, 16])
@pytest.mark.parametrize('nb', [32, 96, 128, 160, 256, 512])
def test_kernel_matches_plain(cuda, B, nb):
    """nb up to 160 runs from shared memory, 256 and 512 from global
    memory; 96 and 160 do not divide the kernel's thread count.
    L within 1e-5·max|L| of the f64 factor and 2e-5·max|L| of the plain
    version; L·M = I to 1e-4; zeros above both diagonals."""
    K = _blocks(B, nb, cuda)
    before = counters()['k1.launches']
    L, M = chol_inv_block(K)
    Lp, _ = chol_inv_block_plain(K)
    torch.cuda.synchronize()
    assert counters()['k1.launches'] == before + 1
    Lref = torch.linalg.cholesky(K.double())
    scale = Lref.abs().max().item()
    assert (L.double() - Lref).abs().max().item() < 1e-5 * scale
    assert (L - Lp).abs().max().item() < 2e-5 * scale
    eye = torch.eye(nb, dtype=torch.float64, device=cuda)
    assert (L.double() @ M.double() - eye).abs().max().item() < 1e-4
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.triu(M, 1), torch.zeros_like(M))


def test_kernel_more_matrices_than_sms(cuda):
    """B=200 blocks of 128: more thread blocks than the card has SMs, each
    matrix still its own block's; L within 1e-5·max|L| of the f64 factor
    and L·M = I to 1e-4."""
    K = _blocks(200, 128, cuda, seed=3)
    L, M = chol_inv_block(K)
    torch.cuda.synchronize()
    Lref = torch.linalg.cholesky(K.double())
    scale = Lref.abs().max().item()
    assert (L.double() - Lref).abs().max().item() < 1e-5 * scale
    eye = torch.eye(128, dtype=torch.float64, device=cuda)
    assert (L.double() @ M.double() - eye).abs().max().item() < 1e-4


def test_kernel_flags_non_spd_block(cuda):
    K = _blocks(4, 128, cuda)
    K[2, 7, 7] = -1.0
    L, _ = chol_inv_block(K)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = (torch.isfinite(d) & (d > 0)).all(-1)
    assert ok.tolist() == [True, True, False, True]


def test_pipeline_goes_through_the_kernel(cuda):
    """At N=1024 the blocked route factors 8 diagonal blocks of 128 with the
    kernel and agrees with the torch.linalg diagonal engine to 1e-4."""
    rng = np.random.RandomState(0)
    X = torch.tensor(rng.rand(2, 1024, 2), dtype=torch.float32, device=cuda)
    y = torch.tensor(rng.randn(2, 1024, 3), dtype=torch.float32, device=cuda)
    before = counters()['k1.launches']
    out = batched_chol_logpdf(X, y, 0.25, 1.0, 1e-2)
    torch.cuda.synchronize()
    assert counters()['k1.launches'] == before + 8
    plain = batched_chol_logpdf(X, y, 0.25, 1.0, 1e-2, diag='recursive')
    assert torch.isfinite(out).all()
    assert ((out - plain).abs() / plain.abs()).max().item() < 1e-4


@pytest.mark.parametrize('shape,dtype,atol', [
    ((3, 1000, 3), torch.float32, 1e-6),     # ragged edge: 1000 % 64 != 0
    ((2, 512, 1), torch.float64, 1e-14),
    ((256, 2), torch.float32, 1e-6),         # one point set, no batch
    ((3, 1, 2), torch.float32, 1e-6),        # smaller than a tile
    ((3, 5, 2), torch.float32, 1e-6),
    ((2, 1001, 2), torch.float32, 1e-6),     # rows not 16-byte aligned
    ((2, 4097, 2), torch.float32, 1e-6),
    ((2, 300, 9), torch.float32, 1e-6),      # wide points
    ((2, 300, 17), torch.float32, 1e-6),
    ((70000, 8, 2), torch.float32, 1e-6),    # more than a grid axis holds
    ((2, 1001, 3), torch.float64, 1e-14),
])
def test_rbf_cov_kernel_matches_plain(cuda, shape, dtype, atol):
    """Same direct-difference form in both: they differ by the rounding of
    exp and of a fused multiply-add (values are at most amp + noise = 1.01).
    One launch per call, and K is exactly symmetric: the kernel stores each
    tile's transpose from the same registers."""
    X = torch.tensor(np.random.RandomState(0).rand(*shape), dtype=dtype,
                     device=cuda)
    before = counters()['k2.launches']
    K = rbf_covariance_pallas(X, 0.25, 1.0, 1e-2)
    torch.cuda.synchronize()
    assert counters()['k2.launches'] == before + 1
    assert K.shape == shape[:-1] + (shape[-2],) and K.dtype == dtype
    plain = rbf_covariance_pallas_plain(X, 0.25, 1.0, 1e-2)
    assert (K - plain).abs().max().item() < atol
    assert torch.equal(K, K.mT)


@pytest.mark.parametrize('B,N,block', [(2, 1024, 256), (3, 512, 128),
                                       (2, 512, 64)])
def test_fused_kernel_matches_plain(cuda, B, N, block):
    """One launch; tril(L) within 1e-5·max|L| of the f64 factor and
    2e-5·max|L| of the plain version; each diagonal block times its inverse
    is I to 1e-4."""
    K = _blocks(B, N, cuda)
    before = counters()['k3.launches']
    L, minvs = fused_blocked_cholesky(K, block=block)
    torch.cuda.synchronize()
    assert counters()['k3.launches'] == before + 1
    L = torch.tril(L)
    Lp, _ = fused_blocked_cholesky_plain(K, block)
    Lref = torch.linalg.cholesky(K.double())
    scale = Lref.abs().max().item()
    assert (L.double() - Lref).abs().max().item() < 1e-5 * scale
    assert (L - Lp).abs().max().item() < 2e-5 * scale
    eye = torch.eye(block, dtype=torch.float64, device=cuda)
    for k in range(N // block):
        s = slice(k * block, (k + 1) * block)
        resid = L[:, s, s].double() @ minvs[:, k].double() - eye
        assert resid.abs().max().item() < 1e-4


@pytest.mark.parametrize('block', [32, 64, 128, 256])
def test_fused_kernel_zero_upper_in_diagonal_blocks(cuda, block):
    """Without tril, the strict upper triangle inside each diagonal block is
    exactly 0: the history that skips the warp tiles above the diagonal
    must leave no residue there."""
    N = 2 * max(block, 256)
    K = _blocks(2, N, cuda, seed=5)
    L, _ = fused_blocked_cholesky(K, block=block)
    torch.cuda.synchronize()
    for k in range(N // block):
        s = slice(k * block, (k + 1) * block)
        assert torch.equal(torch.triu(L[:, s, s], 1),
                           torch.zeros_like(L[:, s, s]))


@pytest.mark.parametrize('B,N,block', [(300, 64, 32), (1, 2048, 256)])
def test_fused_kernel_wrapped_and_underfilled(cuda, B, N, block):
    """B=300 matrices of 64 at block 32: more matrices than the cooperative
    grid has blocks, so the diagonal step's loop over matrices wraps.  B=1,
    N=2048 at block 256: every step has fewer strips than blocks.  tril(L)
    within 1e-5·max|L| of the f64 factor, each diagonal block times its
    inverse is I to 1e-4."""
    K = _blocks(B, N, cuda, seed=7)
    L, minvs = fused_blocked_cholesky(K, block=block, tril=True)
    torch.cuda.synchronize()
    Lref = torch.linalg.cholesky(K.double())
    scale = Lref.abs().max().item()
    assert (L.double() - Lref).abs().max().item() < 1e-5 * scale
    eye = torch.eye(block, dtype=torch.float64, device=cuda)
    for k in range(N // block):
        s = slice(k * block, (k + 1) * block)
        resid = L[:, s, s].double() @ minvs[:, k].double() - eye
        assert resid.abs().max().item() < 1e-4


def test_fused_kernel_flags_non_spd_matrix(cuda):
    K = _blocks(3, 512, cuda)
    K[1, 7, 7] = -1.0
    L, _ = fused_blocked_cholesky(K, block=128, tril=True)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = (torch.isfinite(d) & (d > 0)).all(-1)
    assert ok.tolist() == [True, False, True]
    assert torch.isfinite(L[[0, 2]]).all()


def test_fused_pipeline_goes_through_one_launch(cuda):
    """At N=1024 the fused route launches the fused kernel once and the
    diagonal kernel never, and agrees with the blocked route to 1e-4."""
    rng = np.random.RandomState(0)
    X = torch.tensor(rng.rand(2, 1024, 2), dtype=torch.float32, device=cuda)
    y = torch.tensor(rng.randn(2, 1024, 3), dtype=torch.float32, device=cuda)
    fused_before = counters()['k3.launches']
    diag_before = counters()['k1.launches']
    out = batched_chol_logpdf(X, y, 0.25, 1.0, 1e-2, method='fused')
    torch.cuda.synchronize()
    assert counters()['k3.launches'] == fused_before + 1
    assert counters()['k1.launches'] == diag_before
    blocked = batched_chol_logpdf(X, y, 0.25, 1.0, 1e-2, method='blocked')
    assert torch.isfinite(out).all()
    assert ((out - blocked).abs() / blocked.abs()).max().item() < 1e-4


@pytest.mark.parametrize('engine', ['auto', 'blocked'])
def test_model_lml_and_gradient_on_the_card_match_the_cpu(cuda, engine):
    """The conjugate GP at N=200, f64: lml and its autograd gradient on the
    card within 1e-10 (relative, the gradient by its largest entry) of the
    same call on the CPU; with ``chol_engine='blocked'`` too."""
    rng = np.random.RandomState(0)
    X = rng.rand(200, 2)
    y = np.sin(3 * X[:, :1] + np.arange(3)) + 0.01 * rng.randn(200, 3)
    theta = np.log([0.3, 1e-3])
    out = []
    for device in ('cpu', cuda):
        gp = gt.ConjugateGaussianProcess(
            gt.RBF(0.3, (1e-2, 10)) + gt.WhiteKernel(1e-4, (1e-8, 1e-1)),
            df=3, chol_engine=engine, device=device)
        lml, grad = gp.log_marginal_likelihood(theta, True, X=X, y=y)
        assert lml.device.type == torch.device(device).type
        out.append((lml.item(), grad.cpu()))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out
    assert abs(l_gpu - l_cpu) <= 1e-10 * abs(l_cpu)
    assert (g_gpu - g_cpu).abs().max() <= 1e-10 * g_cpu.abs().max()


def _route_grads(route, K, Y, G, g):
    """(K̄ symmetrized, Ȳ) of ⟨x, G⟩ + ⟨logdet, g⟩ with x = K⁻¹Y through one
    route, and the diagonal kernel's launches in the forward and the
    backward."""
    K = K.detach().requires_grad_(True)
    Y = Y.detach().requires_grad_(True)
    before = counters()['k1.launches']
    if route == 'blocked_spd_solve_logdet':
        x, logdet, ok = blocked_spd_solve_logdet(K, Y, block=128)
        assert ok.all()
    else:
        if route == 'batched_blocked_cholesky':
            L = batched_blocked_cholesky(K, block=256)
        else:
            L = torch.linalg.cholesky_ex(K).L
        x = torch.cholesky_solve(Y, L)
        logdet = 2 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    loss = (x * G.to(x.dtype)).sum() + (logdet * g.to(x.dtype)).sum()
    torch.cuda.synchronize()
    fwd = counters()['k1.launches'] - before
    Kbar, Ybar = torch.autograd.grad(loss, (K, Y))
    torch.cuda.synchronize()
    bwd = counters()['k1.launches'] - before - fwd
    return 0.5 * (Kbar + Kbar.mT), Ybar, fwd, bwd


def _rel_fro(a, ref):
    """The largest per-matrix relative Frobenius distance."""
    d = (a.double() - ref).flatten(1).norm(dim=1)
    return (d / ref.flatten(1).norm(dim=1)).max().item()


@pytest.mark.parametrize('route,launches', [
    ('blocked_spd_solve_logdet', 1024 // 128),
    ('batched_blocked_cholesky', 1024 // 256)])
def test_blocked_autograd_f32_through_the_kernel(cuda, route, launches):
    """f32 at (4, 1024): the forward launches the diagonal kernel once per
    diagonal block (block 128 and 256), the backward never; K̄ and Ȳ against
    the f64 ``torch.linalg`` autograd reference are at most 10 times as far
    from it as the f32 ``torch.linalg`` autograd route; the same function in
    f64 is within 1e-9 of the reference."""
    rng = np.random.RandomState(0)
    X = torch.tensor(rng.rand(4, 1024, 2), dtype=torch.float32, device=cuda)
    Y = torch.tensor(rng.randn(4, 1024, 3), dtype=torch.float32, device=cuda)
    G = torch.tensor(rng.randn(4, 1024, 3), device=cuda)
    g = torch.tensor(rng.randn(4), device=cuda)
    K = rbf_covariance(X, 0.25, 1.0, 1e-2)
    ref = _route_grads('torch.linalg', K.double(), Y.double(), G, g)
    f32 = _route_grads('torch.linalg', K, Y, G, g)
    got = _route_grads(route, K, Y, G, g)
    assert got[2:] == (launches, 0)
    for a, b, r in zip(got[:2], f32[:2], ref[:2]):
        assert _rel_fro(a, r) <= 10 * _rel_fro(b, r)
    got64 = _route_grads(route, K.double(), Y.double(), G, g)
    assert got64[2:] == (0, 0)
    for a, r in zip(got64[:2], ref[:2]):
        assert _rel_fro(a, r) <= 1e-9


def test_one_dimensional_whitening_and_distances_on_the_card(cuda):
    """``cholesky_errors`` and the three ``mahalanobis`` forms with a 1-D y
    on CUDA tensors: a whitened vector and 0-d distances, within 1e-12 of
    the same calls on the CPU."""
    rng = np.random.RandomState(0)
    A = rng.randn(5, 5)
    M = A @ A.T + 5 * np.eye(5)
    w, Q = np.linalg.eigh(M)
    args = {'y': rng.randn(5), 'mean': rng.randn(5),
            'chol': np.linalg.cholesky(M), 'inv': np.linalg.inv(M),
            'sqrt_mat': Q @ np.diag(np.sqrt(w)) @ Q.T}
    calls = {
        'cholesky_errors': lambda a: gt.linalg.cholesky_errors(
            a['y'], a['mean'], a['chol']),
        **{form: (lambda a, form=form: gt.linalg.mahalanobis(
            a['y'], a['mean'], **{form: a[form]}))
           for form in ('chol', 'inv', 'sqrt_mat')}}
    for name, call in calls.items():
        got, want = (call({k: torch.tensor(v, device=device)
                           for k, v in args.items()})
                     for device in (cuda, 'cpu'))
        assert got.device.type == 'cuda'
        assert got.shape == want.shape == ((5,) if name == 'cholesky_errors'
                                           else ()), name
        assert (got.cpu() - want).abs().max() <= 1e-12 * want.abs().max()


def _rung_and_cond(M):
    """The first rung of ``robust_cholesky``'s jitter ladder that factors M,
    and the condition number of the jittered matrix there."""
    s = torch.diagonal(M).max().item()
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    for rung, j in enumerate((0.0, 1e-12, 1e-9, 1e-6)):
        if torch.linalg.cholesky_ex(M + j * s * eye).info.item() == 0:
            ev = torch.linalg.eigvalsh(M)
            return rung, (ev[-1].item() + j * s) / (max(ev[0].item(), 0.0)
                                                    + j * s)
    raise AssertionError('every rung of the ladder failed')


@pytest.mark.parametrize('name,priors', [
    ('TruncationGP', dict(center=0, disp=0, df=3, scale=1)),
    ('TruncationTP', dict(center=0, disp=1, df=5, scale=1))])
def test_truncation_models_on_the_card_match_the_cpu(cuda, name, priors):
    """N=60 points in the unit square, 5 orders (ratio 0.5, ref 10): fit on
    the card, then the same model on the CPU at the card's fitted kernel.
    The lml and its gradient at the start θ and at ``ratio=0.45`` within
    1e-10 (the gradient by its largest entry); 'trunc' within 1e-10;
    'interp' and 'both', which solve with the noise-free K_oo, within cond·ε
    of its jittered condition number, at the same jitter rung on both
    devices.  Errors are relative to the largest entry of each output, and
    a mean's to the band's scale too (its largest std): TruncationTP's
    'trunc' mean is 2e-4 against a std of 1.1, the remainder of a
    cancellation in the posterior center."""
    rng = np.random.RandomState(0)
    X = rng.rand(60, 2)
    c = np.sin(3 * X[:, :1] + np.arange(5)) + 0.01 * rng.randn(60, 5)
    y = gt.helpers.partials(torch.tensor(c), ratio=0.5, ref=10)
    Xnew = rng.rand(9, 2)
    orders = np.arange(5)

    def model(device, **kw):
        kernel = kw.pop('kernel', None) or \
            gt.RBF(0.3, (1e-2, 10)) + gt.WhiteKernel(1e-4, (1e-8, 1e-1))
        return getattr(gt, name)(kernel, ratio=0.5, ref=10, device=device,
                                 **priors, **kw)

    card = model(cuda).fit(X, y.to(cuda), orders=orders)
    assert card.coeffs_.device.type == 'cuda'
    cpu = model('cpu', kernel=card.coeffs_process.kernel_.clone(),
                optimizer=None).fit(X, y, orders=orders)
    theta0 = card.coeffs_process.kernel.theta
    for kw in ({}, {'ratio': 0.45}):
        (l_g, g_g), (l_c, g_c) = (m.log_marginal_likelihood(theta0, True, **kw)
                                  for m in (card, cpu))
        assert abs(l_g.item() - l_c.item()) <= 1e-10 * abs(l_c.item())
        assert (g_g.cpu() - g_c).abs().max() <= 1e-10 * g_c.abs().max()
    rungs = [_rung_and_cond(m.cov(X, X, start=0, end=3)) for m in (card, cpu)]
    assert rungs[0][0] == rungs[1][0], rungs
    tol = max(1e-10, rungs[0][1] * np.finfo(float).eps)
    for kind in ('both', 'interp', 'trunc'):
        limit = 1e-10 if kind == 'trunc' else tol
        band = cpu.predict(Xnew, order=3, kind=kind, return_std=True)[1].max()
        for ret in ('std', 'cov'):
            got, want = (m.predict(Xnew, order=3, kind=kind,
                                   **{'return_' + ret: True})
                         for m in (card, cpu))
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.device.type == 'cuda'
                scale = max(w.abs().max(), band) if i == 0 else w.abs().max()
                assert (g.cpu() - w).abs().max() <= limit * scale, \
                    (kind, ret, i, limit)


# --- the incomplete-beta kernels and the model-checking slice --------------
INCBETA_TOL = {torch.float64: {'betainc': 1e-13, 'betaincinv': 1e-11},
               torch.float32: {'betainc': 1e-5, 'betaincinv': 1e-5}}


def _incbeta_args(name, dtype, device, n=2048, seed=0):
    """a, b from 0.5 to about 4000 (the t quantile's df/2 and 1/2, the beta
    bands' N s + 1) and u uniform in (0, 1), then the edge values: XLA's
    (a = 0, b = inf, b = 0, NaN, negative, x at 0 and 1) for betainc, p at
    0, 1, outside [0, 1] and NaN for betaincinv."""
    rng = np.random.RandomState(seed)
    a = np.concatenate([rng.choice([0.5, 1.5, 2.5, 15.0], n),
                        1 + 4096 * rng.rand(n)])
    b = np.concatenate([np.full(n, 0.5), 4097 - a[n:]])
    u = rng.rand(2 * n)
    if name == 'betainc':
        edges = ([0.0, 2.0, np.inf, 2.0, np.nan, -1.0, 2.0, 2.0],
                 [3.0, np.inf, 3.0, 0.0, 3.0, 3.0, 3.0, 3.0],
                 [0.5, 0.5, 0.5, 1.0, 0.5, 0.5, 0.0, 1.0])
    else:
        edges = ([2.0] * 5, [3.0] * 5, [0.0, 1.0, -0.1, 1.5, np.nan])
    a, b, u = (np.concatenate([v, e]) for v, e in zip((a, b, u), edges))
    return [torch.tensor(v, dtype=dtype, device=device) for v in (a, b, u)]


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('name', ['betainc', 'betaincinv'])
def test_incbeta_kernel_matches_plain(cuda, name, dtype):
    """One launch a call; relative difference from the plain version on the
    card at most 1e-13 (betainc) and 1e-11 (betaincinv) in f64, 1e-5 in f32
    (tiny as the floor of the denominator), NaN where it is NaN.  On the
    random arguments above, and on ``time_incbeta.check_cases``: the one-
    element quantile of ``helpers.hpd`` (a = b = 2049) at both of its ends,
    57 elements of it, a QQ panel's t quantiles at large ν, XLA's edge
    values, the last three also repeated past ``incbeta.WARP_MAX`` elements
    (the thread form), the t quantile's arguments at ``WARP_MAX`` elements
    and one more (the two sides of the size at which launches turn from a
    warp per element to a thread), and the QQ quantiles and the first 8192
    of the beta bands' arguments in launches of 32 (the warp form), some of
    whose 50 Newton steps do not converge."""
    from gsum_tpu_torch.ops import incbeta
    from gsum_tpu_torch.stats import _special
    from gsum_tpu_torch.time_incbeta import check_cases

    cases = {'random': [_incbeta_args(name, dtype, cuda)]}
    cases.update(check_cases(dtype, cuda))
    w = incbeta.WARP_MAX
    assert [incbeta.form(cases[f't[:{n}]'][0][2]) for n in (w, w + 1)] \
        == [1, 0]
    kernel = getattr(incbeta, name)
    for which, slices in cases.items():
        a, b, u = (torch.cat(v) for v in zip(*slices))
        before = counters()[f'p1.{name}.launches']
        got = torch.cat([kernel(*args) for args in slices])
        want = getattr(_special, name + '_plain')(a, b, u)
        torch.cuda.synchronize()
        assert counters()[f'p1.{name}.launches'] == before + len(slices), \
            which
        assert torch.equal(torch.isnan(got), torch.isnan(want)), which
        ok = ~torch.isnan(want)
        rel = ((got[ok] - want[ok]).abs()
               / want[ok].abs().clamp(min=torch.finfo(dtype).tiny)).max()
        assert rel.item() <= INCBETA_TOL[dtype][name], (which, rel.item())


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('name', ['betainc', 'betaincinv'])
def test_incbeta_value_does_not_depend_on_the_launch(cuda, name, dtype):
    """The warp form (launches of at most ``incbeta.WARP_MAX`` elements) and
    the thread form (larger ones) give each element the same value, bit
    for bit: the QQ quantiles and the first 8192 of the beta bands'
    arguments in launches of 32 against one launch past ``WARP_MAX``."""
    from gsum_tpu_torch.ops import incbeta
    from gsum_tpu_torch.time_incbeta import check_cases

    cases = check_cases(dtype, cuda)
    kernel = getattr(incbeta, name)
    w = incbeta.WARP_MAX
    for sliced, whole in (('qq', f'qq repeated past {w}'),
                          ('beta[:8192]', 'beta[:8192]')):
        slices = cases[f'{sliced} in launches of 32']
        assert {incbeta.form(args[2]) for args in slices} == {1}
        got = torch.cat([kernel(*args) for args in slices])
        args = cases[whole][0]
        assert incbeta.form(args[2]) == 0
        want = kernel(*args)[:got.numel()]
        assert torch.equal(got.nan_to_num(nan=2.0),
                           want.nan_to_num(nan=2.0)), sliced


def test_incbeta_refuses_what_it_does_not_take(cuda):
    from gsum_tpu_torch.ops import incbeta

    a, b, u = _incbeta_args('betainc', torch.float64, cuda, n=4)
    with pytest.raises(ValueError):
        incbeta.betainc(a, b[:-1], u[:-1])
    with pytest.raises(ValueError):
        incbeta.betainc(a.float(), b, u)
    with pytest.raises(ValueError):
        incbeta.betainc(a[::2], b[::2], u[::2])
    assert incbeta.betainc(a[:0], b[:0], u[:0]).shape == (0,)


def test_t_ppf_on_the_card(cuda):
    """stats.t quantiles on the card against the CPU, relative 1e-10 with a
    floor of 1e-10 of the scale (quantiles near loc)."""
    from gsum_tpu_torch import stats

    q = np.linspace(0.005, 0.995, 199)
    for df in (1.0, 3.0, 6.0, np.array([2.5, 30.0])[:, None]):
        got = stats.t(df, 0.5, 1.3, device=cuda).ppf(q)
        want = stats.t(df, 0.5, 1.3, device='cpu').ppf(q)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-10, atol=1.3e-10)


def test_pointwise_interval_on_the_card(cuda):
    """TruncationPointwise on the card against the CPU: the fitted scale,
    the intervals (two priors) and the log likelihood at relative 1e-10."""
    rng = np.random.RandomState(2)
    y = np.cumsum(rng.randn(300, 5), axis=1)
    for prior in ({'df': 1, 'scale': 1}, {'df': 0, 'excluded': [0]}):
        tg = gt.TruncationPointwise(device=cuda, **prior).fit(y, 0.5, 10)
        tc = gt.TruncationPointwise(device='cpu', **prior).fit(y, 0.5, 10)
        alpha = np.array([0.68, 0.95])
        np.testing.assert_allclose(tg.interval(alpha).cpu().numpy(),
                                   tc.interval(alpha).numpy(), rtol=1e-10)
        np.testing.assert_allclose(tg.log_likelihood(0.4).item(),
                                   tc.log_likelihood(0.4).item(), rtol=1e-10)


def test_diagnostic_md_squared_on_the_card(cuda):
    """Diagnostic.md_squared and the credible-interval coverage of a
    Student-t reference on the card against the CPU: cond(cov)·1e-14
    relative for the distances (two Cholesky solves), equal coverage."""
    rng = np.random.RandomState(4)
    n = 200
    Q = np.linalg.qr(rng.randn(n, n))[0]
    cov = (Q * np.geomspace(1.0, 1e-3, n)) @ Q.T
    mean = rng.randn(n)
    y = mean[:, None] + np.linalg.cholesky(cov) @ rng.randn(n, 4)
    for df in (None, 5.0):
        dg = gt.Diagnostic(mean, cov, df=df, device=cuda)
        dc = gt.Diagnostic(mean, cov, df=df, device='cpu')
        np.testing.assert_allclose(dg.md_squared(y).cpu().numpy(),
                                   dc.md_squared(y).numpy(),
                                   rtol=np.linalg.cond(cov) * 1e-14)
        dobs = np.linspace(0.1, 0.9, 5)
        np.testing.assert_allclose(
            dg.credible_interval(y, dobs).cpu().numpy(),
            dc.credible_interval(y, dobs).numpy(), rtol=1e-15)


# ----------------------------------------------------------------------
# batched throughput: smallchol / scanchol / gridlml / parallel.batched
# ----------------------------------------------------------------------

def _spd64(G, n, seed):
    A = np.random.RandomState(seed).randn(G, n, n)
    return A @ np.swapaxes(A, -1, -2) / n + np.eye(n)


def _on(device, *arrays):
    return tuple(torch.tensor(a, device=device) for a in arrays)


def test_smallchol_and_scanchol_on_the_card(cuda):
    """The batched small factorizations, the triangular inverse, the scan
    factor and its solve at N=70 (block 32) in f64 on the card against the
    CPU, 1e-12 relative to the largest entry (condition number below 5)."""
    from gsum_tpu_torch.ops import (batched_small_cholesky,
                                    batched_small_tri_inv,
                                    scan_blocked_cholesky, scan_cho_solve)

    A = _spd64(5, 70, 0)
    B = np.random.RandomState(1).randn(5, 70, 3)
    out = {}
    for dev in (cuda, 'cpu'):
        Ad, Bd = _on(dev, A, B)
        L = batched_small_cholesky(Ad)
        Ls, minvs = scan_blocked_cholesky(Ad, block=32)
        out[dev] = [L, batched_small_tri_inv(L), Ls, minvs,
                    scan_cho_solve(Ls, minvs, Bd)]
    for got, want in zip(out[cuda], out['cpu']):
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize('engine', ['unrolled', 'scan', 'blocked'])
def test_grid_lml_on_the_card(cuda, engine):
    """cgp_lml_grid f64 (the blocked engine's plain diagonal on the card,
    f64) against the CPU at 1e-10, and its gradient in Rs at 1e-8."""
    from gsum_tpu_torch.ops import cgp_lml_grid

    rng = np.random.RandomState(2)
    X = np.sort(rng.rand(160))
    Rs = np.stack([np.exp(-0.5 * (X[:, None] - X[None]) ** 2 / ls ** 2)
                   + 1e-3 * np.eye(160) for ls in (0.05, 0.1, 0.2)])
    y = rng.randn(160, 2)
    res = {}
    for dev in (cuda, 'cpu'):
        R, yd, basis = _on(dev, Rs, y, np.ones((160, 1)))
        R.requires_grad_(True)
        lml = cgp_lml_grid(R, yd, basis, 0.1, 0, 3.0, 1.0, engine=engine)
        (g,) = torch.autograd.grad(lml.sum(), R)
        res[dev] = (lml.detach().cpu().numpy(), g.cpu().numpy())
    np.testing.assert_allclose(res[cuda][0], res['cpu'][0], rtol=1e-10)
    np.testing.assert_allclose(res[cuda][1], res['cpu'][1], rtol=0,
                               atol=1e-8 * np.abs(res['cpu'][1]).max())


def test_blocked_grid_lml_launches_k1_in_forwards_only(cuda):
    """f32 at N=512, block 128: each forward of the blocked engine launches
    the diagonal kernel once per diagonal block (4), its backward none; a
    blocked fit launches chunks × (1 + 2·maxiter) × blocks, as derived from
    the code (one forward at the start of a chunk, a line search and a
    value-and-gradient per iteration)."""
    from gsum_tpu_torch.ops import cgp_lml_grid
    from gsum_tpu_torch.parallel import batched_fit

    rng = np.random.RandomState(3)
    X = np.linspace(0, 1, 512)[:, None]
    R = torch.tensor(np.exp(-0.5 * (X - X.T) ** 2 / 0.1 ** 2)
                     + 1e-2 * np.eye(512), dtype=torch.float32,
                     device=cuda).expand(3, 512, 512).clone()
    y = torch.tensor(rng.randn(512, 1), dtype=torch.float32, device=cuda)
    basis = torch.ones(512, 1, dtype=torch.float32, device=cuda)
    R.requires_grad_(True)
    before = counters()['k1.launches']
    lml = cgp_lml_grid(R, y, basis, 0.0, 0, 3.0, 1.0, engine='blocked')
    torch.cuda.synchronize()
    assert counters()['k1.launches'] == before + 4
    lml.sum().backward()
    torch.cuda.synchronize()
    assert counters()['k1.launches'] == before + 4
    assert torch.isfinite(R.grad).all()

    Y = np.sin(3 * X.T + rng.rand(3, 1) * 6.28) + 0.1 * rng.randn(3, 512)
    before = counters()['k1.launches']
    post = batched_fit(gt.RBF(0.5, (1e-2, 1e2)),
                       torch.tensor(X, dtype=torch.float32, device=cuda),
                       torch.tensor(Y, dtype=torch.float32, device=cuda),
                       df=3, scale=1, nugget=1e-2, maxiter=3, chunk=2,
                       ls_steps=4, engine='blocked')
    torch.cuda.synchronize()
    assert counters()['k1.launches'] - before == 2 * (1 + 2 * 3) * 4
    assert torch.isfinite(post.lml).all()


def _fit_auto_and_scan(Xd, Yd, nugget, maxiter=3, ls_steps=10):
    """batched_fit of every curve set with engine 'auto' and 'scan': {engine:
    (posterior, change of ``chol.matrices``)}."""
    from gsum_tpu_torch.parallel import batched_fit

    res = {}
    for engine in ('auto', 'scan'):
        before = counters()['chol.matrices']
        post = batched_fit(gt.RBF(0.5, (1e-2, 1e2)), Xd, Yd, df=3, scale=1,
                           nugget=nugget, maxiter=maxiter, ls_steps=ls_steps,
                           engine=engine)
        torch.cuda.synchronize()
        res[engine] = post, counters()['chol.matrices'] - before
    return res


def test_auto_fit_engine_on_the_card_matches_scan(cuda):
    """batched_fit at N=350 f64, B=8, maxiter 3 on the card: 'auto' (the
    card's row of ``_auto_fit_engine``) against ``engine='scan'``, θ and
    lml to 1e-8 relative (nugget 1e-4: condition numbers below 3.5e6;
    measured on the CPU, blocked against scan: θ 3.4e-10, lml 1.1e-11).
    ``chol.matrices`` counts the engine's factorizations: every objective
    row (the start, ls_steps trials and one gradient a step) once under
    the blocked engine, twice under scan and unrolled, and one posterior
    factorization a fit."""
    from gsum_tpu_torch.parallel.batched import _auto_fit_engine

    n, B, maxiter, ls_steps = 350, 8, 3, 10
    rng = np.random.RandomState(7)
    X = np.linspace(0, 1, n)[:, None]
    Y = np.sin(8 * X.T + rng.rand(B, 1) * 6.28) + 0.1 * rng.randn(B, n)
    res = _fit_auto_and_scan(*_on(cuda, X, Y), 1e-4, maxiter, ls_steps)
    rows = B * (1 + maxiter * (ls_steps + 1))
    per_row = {'blocked': 1, 'unrolled': 2, 'scan': 2}
    auto = _auto_fit_engine(torch.float64, n, 'cuda')
    assert auto != 'scan'
    assert res['auto'][1] == per_row[auto] * rows + B
    assert res['scan'][1] == per_row['scan'] * rows + B
    for field in ('theta', 'lml'):
        np.testing.assert_allclose(
            getattr(res['auto'][0], field).cpu().numpy(),
            getattr(res['scan'][0], field).cpu().numpy(), rtol=1e-8)


def test_auto_fit_engine_on_the_card_at_nugget_1e_10(cuda):
    """The same fits at ``nn350.fits``' nugget 1e-10, on smooth curves
    (draws of RBF processes, length scales 0.12–0.5), where log|R| carries
    round-off of order 0.1 nats: 'auto' and 'scan' each give a finite lml
    within 3e-3 a datum (the cell's ``lml_gap`` limit) of the unrolled
    engine's f64 lml on the CPU at the fit's own θ.  The two fits' θ part
    by round-off in the gradient, so they are each held to the reference
    and not to one another.  Read on the CPU: 1.6e-4 ('blocked') and
    8.5e-5 ('scan') a datum; on the H100 the benchmark's reference read
    the cell's fits up to 4.1e-4 (block 64) and 3.9e-4 (scan)."""
    from gsum_tpu_torch.ops import cgp_lml_grid

    n, B, m = 350, 8, 5
    X = torch.arange(1, n + 1, dtype=torch.float64)[:, None] / n
    eye = torch.eye(n, dtype=torch.float64)
    gen = torch.Generator().manual_seed(7)
    Y = torch.empty(B, n, m, dtype=torch.float64)
    for b, ls in enumerate((0.12, 0.16, 0.2, 0.25, 0.3, 0.35, 0.42, 0.5)):
        L = torch.linalg.cholesky(
            torch.exp(-0.5 * (X - X.T) ** 2 / ls ** 2) + 1e-9 * eye)
        Y[b] = L @ torch.randn(n, m, generator=gen, dtype=torch.float64)
    res = _fit_auto_and_scan(X.to(cuda), Y.to(cuda), 1e-10)
    basis = torch.ones(n, 1, dtype=torch.float64)
    for engine, (post, _) in res.items():
        ls = torch.exp(post.theta[:, 0].cpu())
        R = torch.exp(-0.5 * (X - X.T)[None] ** 2
                      / ls[:, None, None] ** 2) + 1e-10 * eye
        ref = cgp_lml_grid(R, Y, basis, 0.0, 0, 3.0, 1.0, engine='unrolled')
        lml = post.lml.cpu()
        assert torch.isfinite(lml).all() and torch.isfinite(ref).all()
        gap = ((lml - ref).abs() / (n * m)).max().item()
        assert gap < 3e-3, (engine, gap)


def test_tf32_scope_on_the_card_forward_and_backward(cuda, monkeypatch):
    """precision='high' computes in full f32 on the card: at block 128,
    N = 512, f32 through the diagonal kernel (4 launches a forward), the
    solution, the logdet and both gradients are bit for bit those of
    precision=None, and TF32 stays off at every product of the forward
    and the backward."""
    flags = torch.backends.cuda.matmul
    K = _blocks(1, 512, cuda, seed=5).expand(2, 512, 512).contiguous()
    Y = torch.randn(2, 512, 3, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    seen = []
    matmul = torch.matmul

    def spy(a, b):
        seen.append(flags.allow_tf32)
        return matmul(a, b)

    def run(prec):
        Kg = K.clone().requires_grad_(True)
        Yg = Y.clone().requires_grad_(True)
        before = counters()['k1.launches']
        x, ld, ok = blocked_spd_solve_logdet(Kg, Yg, block=128,
                                             precision=prec)
        assert counters()['k1.launches'] == before + 4
        (x.sum() + ld.sum()).backward()
        torch.cuda.synchronize()
        assert ok.all()
        return x.detach(), ld.detach(), Kg.grad, Yg.grad

    monkeypatch.setattr(torch, 'matmul', spy)
    want = run(None)
    got = run('high')
    assert seen and not any(seen)
    assert not flags.allow_tf32
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        assert torch.equal(g, w)


def test_batched_sweeps_and_posterior_on_the_card(cuda):
    """batched_lml_grid (grid, scan, scalar), a small grid-engine fit,
    truncation_lml_grid, pointwise_evidence_grid, batched_posterior_at and
    batched_predict in f64 on the card against the CPU (1e-9 relative;
    condition numbers below 1e5)."""
    from gsum_tpu_torch.parallel import (batched_fit, batched_lml_grid,
                                         batched_posterior_at,
                                         batched_predict,
                                         pointwise_evidence_grid,
                                         truncation_lml_grid)

    rng = np.random.RandomState(6)
    X = np.linspace(0, 1, 40)[:, None]
    Y = np.sin(3 * X.T + rng.rand(3, 1) * 6.28) + 0.1 * rng.randn(3, 40)
    th = np.log(np.stack([np.linspace(0.5, 2, 4), np.linspace(0.1, 0.5, 4)],
                         1))
    k = gt.ConstantKernel(1.0, (1e-2, 1e2)) * gt.RBF(0.3, (1e-2, 10))
    kw = dict(df=3, scale=1, nugget=1e-3)
    orders = np.arange(4)
    c = np.stack([np.sin(3 * X[:, 0] + j) for j in orders], 1)
    ys = gt.partials(torch.tensor(c), ratio=0.5, ref=2.0).numpy()
    res = {}
    for dev in (cuda, 'cpu'):
        Xd, Yd, thd, ysd = _on(dev, X, Y, th, ys)
        out = [batched_lml_grid(k, Xd, Yd[0], thd, engine=e, **kw)
               for e in ('grid', 'scan', 'scalar')]
        post = batched_fit(k, Xd, Yd, maxiter=3, ls_steps=4, **kw)
        out += [post.theta, post.lml]
        kt = gt.RBF(0.3, (1e-2, 10)) + gt.WhiteKernel(1e-3, (1e-8, 1e-1))
        tht = _on(dev, np.log([[0.2, 1e-3], [0.4, 1e-3]]))[0]
        out.append(truncation_lml_grid(kt, Xd, ysd, orders,
                                       _on(dev, np.array([0.4, 0.6]))[0],
                                       tht, ref=2.0))
        out.append(pointwise_evidence_grid(ysd, orders,
                                           _on(dev, np.array([0.4, 0.6]))[0],
                                           ref=2.0))
        pa = batched_posterior_at(k, Xd, Yd[0], thd, disp=1.0, **kw)
        out += [pa.lml, pa.scale_sq]
        out += list(batched_predict(k, pa, Xd, Yd[0].expand(4, 40),
                                    Xd[::7] + 0.01, student=True))
        res[dev] = [o.detach().cpu().numpy() for o in out]
    for got, want in zip(res[cuda], res['cpu']):
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_hier_engine_through_the_kernel(cuda):
    """diag='hier' at block 256, N=512 f32: each 256-wide diagonal block
    splits into two 128-wide bases, each a launch of the diagonal kernel
    (4 in all); the factor within 1e-5·max|L| of the f64 one."""
    from gsum_tpu_torch.ops import batched_blocked_cholesky

    A = np.random.RandomState(8).randn(2, 512, 512)
    K = torch.tensor(A @ np.swapaxes(A, -1, -2) / 512 + np.eye(512),
                     dtype=torch.float32, device=cuda)
    before = counters()['k1.launches']
    L = batched_blocked_cholesky(K, block=256, diag='hier')
    torch.cuda.synchronize()
    assert counters()['k1.launches'] - before == 4
    Lref = torch.linalg.cholesky(K.double())
    assert (L.double() - Lref).abs().max().item() < \
        1e-5 * Lref.abs().max().item()


# ----------------------------------------------------------------------
# model checking, derivative observations and sampling
# ----------------------------------------------------------------------

def test_derivative_covariance_on_the_card(cuda):
    """The per-pair vmap(grad(grad)) of ``kernel_deriv_cov`` (orders 0-2,
    RBF and Matern 2.5) and a derivative-constrained lml gradient on the
    card against the CPU: 1e-12 relative (the same operations; the
    gradient at cond(R)·1e-15)."""
    x = np.linspace(0.0, 1.0, 9)[:, None]
    d = np.arange(9) % 3
    for k in (gt.RBF(0.4), gt.Matern(0.6, nu=2.5)):
        got = gt.derivs.kernel_deriv_cov(k, torch.tensor(x, device=cuda), d)
        want = gt.derivs.kernel_deriv_cov(k, torch.tensor(x), d)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-12,
                                   atol=1e-12 * want.abs().max().item())
    y = np.sin(3 * x[:, 0])
    out = []
    for dev in (cuda, 'cpu'):
        gp = gt.ConjugateGaussianProcess(
            gt.ConstantKernel(1.0, (1e-2, 1e2)) * gt.RBF(0.3, (1e-2, 10)),
            nugget=1e-8, optimizer=None, device=dev)
        gp.fit(torch.tensor(x, device=dev), torch.tensor(y, device=dev),
               dorders=d % 2)
        lml, g = gp.log_marginal_likelihood(np.log([1.2, 0.25]),
                                            eval_gradient=True)
        out.append((lml.item(), g.cpu().numpy(),
                    np.linalg.cond(gp.corr_.cpu().numpy())))
    (l1, g1, c), (l2, g2, _) = out
    assert abs(l1 - l2) <= c * 1e-15 * abs(l2)
    np.testing.assert_allclose(g1, g2, rtol=c * 1e-15)


def test_graphical_diagnostic_data_on_the_card(cuda):
    """QQ envelopes, coverage bands and the MD² reference grid of a
    Student-t ``GraphicalDiagnostic`` on the card against the CPU, the
    card's draws put into the CPU object: cond(cov)·1e-14 relative for
    whitened errors, 1e-12 for the t / F quantiles."""
    rng = np.random.RandomState(5)
    n = 64
    Q = np.linalg.qr(rng.randn(n, n))[0]
    cov = (Q * np.geomspace(1.0, 1e-3, n)) @ Q.T
    mean = rng.randn(n)
    y = mean[:, None] + np.linalg.cholesky(cov) @ rng.randn(n, 3)
    colors = ['C0', 'C1', 'C2']
    g_card = gt.GraphicalDiagnostic(y, mean, cov, df=6.0, nref=200,
                                    colors=colors, device=cuda)
    g_cpu = gt.GraphicalDiagnostic(y, mean, cov, df=6.0, nref=2,
                                   colors=colors, device='cpu')
    g_cpu.samples = g_card.samples.cpu()
    tol = np.linalg.cond(cov) * 1e-14
    for name in ('individual', 'cholesky', 'pivoted_cholesky'):
        a, b = g_card.qq_band_data(name), g_cpu.qq_band_data(name)
        np.testing.assert_allclose(a[0], b[0], rtol=1e-12)
        np.testing.assert_allclose(a[1], b[1], rtol=tol, atol=tol)
        for (lo, hi), (lo2, hi2) in zip(a[2], b[2]):
            np.testing.assert_allclose(lo, lo2, rtol=tol, atol=tol)
            np.testing.assert_allclose(hi, hi2, rtol=tol, atol=tol)
    iv = np.linspace(0.1, 0.9, 9)
    (c1, b1), (c2, b2) = g_card.coverage_band_data(iv), \
        g_cpu.coverage_band_data(iv)
    np.testing.assert_allclose(c1, c2, rtol=1e-15)
    for (lo, hi), (lo2, hi2) in zip(b1, b2):
        np.testing.assert_allclose(lo, lo2, rtol=1e-15)
        np.testing.assert_allclose(hi, hi2, rtol=1e-15)
    for a, b in zip(g_card._dist_grid(g_card.md_ref_dist),
                    g_cpu._dist_grid(g_cpu.md_ref_dist)):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_one_hmc_step_on_the_card(cuda):
    """One proposal of 4 chains on the lml of a GP on the card against the
    same proposal on the CPU with the same draws: 10·cond(R)·ε relative,
    with the largest condition number of R + nugget·I at the chains'
    start and end (the lml gradient's agreement)."""
    from gsum_tpu_torch import sample as ts
    from gsum_tpu_torch.optimize import _to_bounded

    x = np.linspace(0, 1, 16)[:, None]
    y = np.sin(3 * x[:, 0])
    draws = np.random.RandomState(1)
    z0, jit, p, u = (draws.randn(4, 1) * 0.3 - 1.0, draws.rand(4),
                     draws.randn(4, 1), draws.rand(4))
    out = []
    for dev in (cuda, 'cpu'):
        gp = gt.ConjugateGaussianProcess(gt.RBF(0.3, (0.05, 2.0)),
                                         nugget=1e-8, optimizer=None,
                                         device=dev)
        gp.fit(torch.tensor(x, device=dev), torch.tensor(y, device=dev))
        lo = torch.tensor([np.log(0.05)], device=dev, dtype=torch.float64)
        hi = torch.tensor([np.log(2.0)], device=dev, dtype=torch.float64)
        k = gp.kernel_.clone()

        def ld(z, gp=gp, k=k, lo=lo, hi=hi):
            th = _to_bounded(z, lo, hi)
            return gp._lml(k, th, gp.X_train_, gp.y_train_[:, None],
                           gp.basis_train_) \
                + torch.sum(ts._log_jac_bounded(z, lo, hi))

        gv = torch.func.vmap(torch.func.grad_and_value(ld))
        t = [torch.tensor(a, device=dev) for a in (z0, jit, p, u)]
        g, lp = gv(t[0])
        eps = torch.full((4,), 0.1, dtype=torch.float64, device=dev)
        res = ts._proposal(gv, t[0], lp, g, eps, t[1], t[2], t[3], 6)
        out.append([r.cpu().numpy() for r in res])
    lo_b, hi_b = np.log(0.05), np.log(2.0)
    ells = np.exp(lo_b + (hi_b - lo_b) / (1 + np.exp(-np.concatenate(
        [z0[:, 0], out[1][0][:, 0]]))))
    cond = max(np.linalg.cond(np.exp(-0.5 * (x - x.T) ** 2 / ell ** 2)
                              + 1e-8 * np.eye(len(x))) for ell in ells)
    tol = 10 * cond * np.finfo(float).eps
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A TruncationGP with a slope constraint fitted on the card, saved
    and loaded into a new model on the card: predictions bit for bit."""
    x = np.linspace(0, 1, 12)[:, None]
    yn = gt.partials(torch.tensor(np.sin(3 * x + np.arange(3))), 0.5,
                     orders=np.arange(3)).numpy()

    def make():
        return gt.TruncationGP(gt.RBF(0.2, (1e-2, 10)), ratio=0.5,
                               nugget=1e-10, device=cuda)

    m = make().fit(x, yn, np.arange(3), dX=[[1.0], [1.0]], dy=[0.0, 0.0],
                   dderivs=[[0], [1]])
    gt.checkpoint.save(str(tmp_path / 'm'), m)
    m2 = gt.checkpoint.load(str(tmp_path / 'm'), make())
    xn = torch.tensor(np.linspace(0, 1.1, 7)[:, None], device=cuda)
    for a, b in zip(m.predict(xn, 1, return_std=True),
                    m2.predict(xn, 1, return_std=True)):
        assert a.device.type == 'cuda' and torch.equal(a, b)


def test_four_shard_mesh_on_one_card_matches_the_dense_lml(cuda):
    """A 4-shard mesh on ``cuda:0``: the on-shard lml, its gradient and the
    sharded factor against the dense ``torch.linalg`` route on the card
    (N=512, nugget 1e-4, condition number 2e6: 1e-10 relative), and a
    'batch' mesh of the grid sweep against the unsharded call (1e-9:
    cuSOLVER's batched factorization is not bit for bit across batch
    sizes, cond·ε = 4.4e-10)."""
    from gsum_tpu_torch.parallel import (Mesh, batched_lml_grid,
                                         sharded_cgp_lml, sharded_cholesky)

    n, nug = 512, 1e-4
    mesh = Mesh([cuda] * 4, ('model',))
    x = torch.tensor(np.linspace(0, 1, n)[:, None], device=cuda)
    y = torch.tensor(np.sin(3 * np.linspace(0, 1, n))[:, None]
                     + 0.1 * np.random.RandomState(0).randn(n, 2),
                     device=cuda)
    basis = torch.ones((n, 1), dtype=torch.float64, device=cuda)
    k = gt.Matern(0.2, (1e-2, 10), nu=1.5)
    prior = (np.zeros(1), np.zeros((1, 1)), 3.0, 1.0)
    th = torch.tensor(k.theta, device=cuda, requires_grad=True)
    got = sharded_cgp_lml(k.value_fn, th, x, y, basis, *prior, mesh,
                          nugget=nug)
    (g,) = torch.autograd.grad(got, th)
    gp = gt.ConjugateGaussianProcess(k, center=0, disp=0, df=3, scale=1,
                                     nugget=nug, optimizer=None,
                                     device=cuda).fit(x, y)
    want, g_want = gp.log_marginal_likelihood(th.detach(),
                                              eval_gradient=True)
    assert got.device == cuda
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-10)
    np.testing.assert_allclose(g.cpu().numpy(), g_want.cpu().numpy(),
                               rtol=1e-10)
    K = k.value_fn(th.detach(), x) + nug * torch.eye(
        n, dtype=torch.float64, device=cuda)
    L = torch.linalg.cholesky(K)
    np.testing.assert_allclose(sharded_cholesky(K, mesh).cpu().numpy(),
                               L.cpu().numpy(), rtol=0, atol=1e-10)
    thetas = torch.log(torch.linspace(0.1, 1.0, 8, dtype=torch.float64,
                                      device=cuda))[:, None]
    grid_mesh = Mesh([cuda] * 4, ('batch',))
    np.testing.assert_allclose(
        batched_lml_grid(k, x, y, thetas, nugget=nug,
                         mesh=grid_mesh).cpu().numpy(),
        batched_lml_grid(k, x, y, thetas, nugget=nug).cpu().numpy(),
        rtol=1e-9)


def test_a_mesh_on_a_missing_card_raises(cuda):
    from gsum_tpu_torch.parallel import Mesh, make_mesh

    count = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match='CUDA card'):
        Mesh([f'cuda:{count}'], ('model',))
    with pytest.raises(RuntimeError, match='CUDA card'):
        make_mesh(devices=['cuda:0', f'cuda:{count}'])


def _fit_curves(cuda, n, B, dtype, seed=5):
    """(n, 1) points on (0, 1] and (B, n, 3) curves: draws of RBF processes
    at length scales 0.15–0.5, as ``nn350.fits``' data."""
    gen = torch.Generator().manual_seed(seed)
    X = torch.arange(1, n + 1, dtype=torch.float64)[:, None] / n
    eye = torch.eye(n, dtype=torch.float64)
    Y = torch.empty(B, n, 3, dtype=torch.float64)
    for b in range(B):
        ls = 0.15 + 0.35 * b / max(B - 1, 1)
        L = torch.linalg.cholesky(
            torch.exp(-0.5 * (X - X.T) ** 2 / ls ** 2) + 1e-8 * eye)
        Y[b] = L @ torch.randn(n, 3, generator=gen, dtype=torch.float64)
    return X.to(cuda, dtype), Y.to(cuda, dtype)


def _fit_both_ways(cuda, monkeypatch, n, B, dtype, engine, chunk, nugget,
                   maxiter, ls_steps=6):
    """``batched_fit`` eager (the rule ``_graphed`` patched to False) and
    graphed: {route: (posterior, change of every counter)}."""
    from gsum_tpu_torch.parallel import batched, batched_fit

    X, Y = _fit_curves(cuda, n, B, dtype)
    rule = batched._graphed
    out = {}
    for route in ('eager', 'graphed'):
        monkeypatch.setattr(batched, '_graphed', rule if route == 'graphed'
                            else lambda *a: False)
        before = counters()
        post = batched_fit(gt.RBF(0.5, (1e-2, 1e2)), X, Y, df=3, scale=1,
                           nugget=nugget, maxiter=maxiter, ls_steps=ls_steps,
                           chunk=chunk, engine=engine,
                           precision={torch.float64: 'f64',
                                      torch.float32: 'f32'}[dtype])
        torch.cuda.synchronize()
        after = counters()
        out[route] = post, {k: after[k] - before[k] for k in after
                            if after[k] != before[k]}
    assert rule(X.device, batched._auto_fit_engine(dtype, n, 'cuda')
                if engine == 'auto' else batched._engine(engine), maxiter)
    return out


@pytest.mark.parametrize('n,B,dtype,engine,chunk,nugget', [
    (350, 10, torch.float64, 'auto', 6, 1e-10),    # blocked, block 64
    (512, 4, torch.float32, 'auto', 4, 1e-2),      # blocked, K1 diagonals
    (128, 6, torch.float64, 'grid', 4, 1e-8),      # unrolled
    (256, 6, torch.float64, 'scan', 4, 1e-8),
])
def test_graphed_fit_equals_the_eager_fit_bit_for_bit(cuda, monkeypatch, n,
                                                      B, dtype, engine,
                                                      chunk, nugget):
    """Each chunk's start and first iteration eager, the other iterations
    one captured step replayed: the same kernels on the same buffers, so θ,
    lml, τ², η and ν are the eager fit's bit for bit, and every counter
    but ``lbfgs.steps_replayed`` changes as much (the capture's counts are
    added at each replay; K1's launches included)."""
    maxiter = 5
    out = _fit_both_ways(cuda, monkeypatch, n, B, dtype, engine, chunk,
                         nugget, maxiter)
    (eager, c_eager), (graphed, c_graphed) = out['eager'], out['graphed']
    for field in ('theta', 'lml', 'scale_sq', 'center', 'df'):
        a, b = getattr(eager, field), getattr(graphed, field)
        assert torch.equal(a, b), field
    assert torch.isfinite(eager.lml).all()
    chunks = -(-B // chunk)
    assert c_graphed.pop('lbfgs.steps_replayed') == chunks * (maxiter - 1)
    assert 'lbfgs.steps_replayed' not in c_eager
    assert c_graphed == c_eager
    assert c_eager['lbfgs.steps'] == chunks * maxiter
    if dtype == torch.float32:
        assert c_eager['k1.launches'] > 0
        assert c_eager['k1.matrices.128'] >= c_eager['k1.launches']


@pytest.mark.parametrize('n,dtype,engine,maxiter,per_fit', [
    (350, torch.float64, 'auto', 20, 222),      # nn350.fits
    (512, torch.float32, 'blocked', 6, 68),     # e2d4096.fits' trip
])
def test_graphed_fit_counts_the_closed_form(cuda, n, dtype, engine, maxiter,
                                            per_fit):
    """Under replay ``chol.matrices`` still counts 1 + maxiter·(ls_steps +
    1) objective rows and one posterior factorization a fit (the blocked
    engine factors each row once): 222 at maxiter 20, 68 at maxiter 6."""
    from gsum_tpu_torch.parallel import batched_fit

    B = 3
    X, Y = _fit_curves(cuda, n, B, dtype)
    before = counters()
    batched_fit(gt.RBF(0.5, (1e-2, 1e2)), X, Y, df=3, scale=1,
                nugget=1e-10 if dtype == torch.float64 else 1e-2,
                maxiter=maxiter, ls_steps=10, engine=engine,
                precision={torch.float64: 'f64', torch.float32: 'f32'}[dtype])
    torch.cuda.synchronize()
    after = counters()
    assert after['chol.matrices'] - before['chol.matrices'] == B * per_fit
    assert after['lbfgs.steps_replayed'] - before['lbfgs.steps_replayed'] \
        == maxiter - 1


@pytest.mark.parametrize('n,dtype,engine', [
    (128, torch.float64, 'grid'), (256, torch.float64, 'scan'),
    (350, torch.float64, 'auto'), (512, torch.float32, 'auto')])
def test_one_eager_step_of_each_fit_engine_makes_no_sync(cuda, monkeypatch,
                                                         n, dtype, engine):
    """One eager L-BFGS iteration of each grid engine's fit objective
    (unrolled, scan, blocked f64 at block 64, blocked f32 with K1) runs
    under ``torch.cuda.set_sync_debug_mode('error')``: no copy from the
    host and no read of a device value, which a capture could not hold."""
    from gsum_tpu_torch import optimize
    from gsum_tpu_torch.parallel import batched, batched_fit

    step = optimize._Lbfgs.step

    def strict(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            step(self)
        finally:
            torch.cuda.set_sync_debug_mode('default')

    monkeypatch.setattr(optimize._Lbfgs, 'step', strict)
    monkeypatch.setattr(batched, '_graphed', lambda *a: False)
    X, Y = _fit_curves(cuda, n, 2, dtype)
    post = batched_fit(gt.RBF(0.5, (1e-2, 1e2)), X, Y, df=3, scale=1,
                       nugget=1e-8 if dtype == torch.float64 else 1e-2,
                       maxiter=1, ls_steps=4, engine=engine,
                       precision={torch.float64: 'f64',
                                  torch.float32: 'f32'}[dtype])
    assert torch.isfinite(post.lml).all()


def test_graphed_fit_with_a_fixed_vector_hyperparameter_equals_eager(
        cuda, monkeypatch):
    """A fixed hyperparameter of several values is copied to the card once,
    in the eager start, and kept on the kernel, so the capture holds no
    copy from the host: the graphed fit equals the eager one bit for
    bit."""
    from gsum_tpu_torch.parallel import batched, batched_fit

    X1, Y = _fit_curves(cuda, 128, 6, torch.float64)
    X = torch.cat([X1, X1 ** 2], 1)
    rule = batched._graphed
    assert rule(X.device, batched._engine('grid'), 6)
    out = {}
    for route in ('eager', 'graphed'):
        monkeypatch.setattr(batched, '_graphed', rule if route == 'graphed'
                            else lambda *a: False)
        kernel = gt.ConstantKernel(1.0, (1e-2, 1e2)) \
            * gt.RBF([0.3, 0.5], 'fixed')
        out[route] = batched_fit(kernel, X, Y, df=3, scale=1, nugget=1e-8,
                                 maxiter=6, ls_steps=6, chunk=4,
                                 engine='grid', precision='f64')
    for field in ('theta', 'lml', 'scale_sq', 'center', 'df'):
        assert torch.equal(getattr(out['eager'], field),
                           getattr(out['graphed'], field)), field
    assert torch.isfinite(out['eager'].lml).all()


def test_a_patched_step_reaches_every_replayed_iteration(cuda, monkeypatch):
    """Every iteration, the captured one included, goes through
    ``_Lbfgs.step``: with it patched to do nothing, a graphed fit keeps its
    start, as an eager one does."""
    from gsum_tpu_torch import optimize
    from gsum_tpu_torch.parallel import batched, batched_fit

    X, Y = _fit_curves(cuda, 128, 4, torch.float64)
    kernel = gt.RBF(0.5, (1e-2, 1e2))
    assert batched._graphed(X.device, batched._engine('grid'), 6)
    monkeypatch.setattr(optimize._Lbfgs, 'step', lambda self: None)
    post = batched_fit(kernel, X, Y, df=3, scale=1, nugget=1e-8, maxiter=6,
                       ls_steps=4, engine='grid', precision='f64')
    start = torch.as_tensor(kernel.theta, dtype=post.theta.dtype,
                            device=post.theta.device)
    # the start, up to the bounds' round trip; a fit moves it by far more
    torch.testing.assert_close(post.theta, start.expand_as(post.theta),
                               rtol=0, atol=1e-9)


def test_graphed_fits_keep_one_pool_until_released(cuda):
    """The captures of every call share one pool, as large as the largest
    step captured: the memory the card reserves does not grow from call to
    call, and ``release_graph_memory`` gives it back."""
    from gsum_tpu_torch.optimize import release_graph_memory
    from gsum_tpu_torch.parallel import batched_fit

    X, Y = _fit_curves(cuda, 350, 12, torch.float64)
    reserved = []
    for _ in range(3):
        post = batched_fit(gt.RBF(0.5, (1e-2, 1e2)), X, Y, df=3, scale=1,
                           nugget=1e-10, maxiter=6, ls_steps=10, chunk=8,
                           precision='f64')
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        assert torch.isfinite(post.lml).all()
    assert max(reserved) <= reserved[0] + 64 * 2 ** 20
    release_graph_memory()
    assert torch.cuda.memory_reserved() <= \
        torch.cuda.memory_allocated() + 256 * 2 ** 20 < reserved[-1]
