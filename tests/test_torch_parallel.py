"""``parallel.batched`` of the port against ``gsum_tpu.parallel.batched`` on
the CPU: ``batched_lml_grid`` (engines and precisions), the truncation
and pointwise sweeps, ``batched_posterior_at`` and ``batched_predict`` on a
posterior carried by ``convert.to_torch_posterior``; the engine table, the
scalar engine's chunk cap, the TF32 scope and the ``mesh=`` batch check.
(The fits are in ``tests/test_torch_parallel_fit.py``.)

Data: N=16 points, a ConstantKernel × RBF kernel and a 1e-3 nugget, so
the correlation matrices' condition numbers stay below 1e5 and f64 values
are held to 1e-10 relative (measured: 1e-13).  JAX's 'blocked' sweep pads
N to its 128-wide block and compiles the unrolled diagonal recursion (11 s
here), so the port's blocked sweep is held to JAX's 'grid' sweep, which
computes the same lml (``cgp_lml_grid``'s blocked engine is held to JAX's
own in ``tests/test_torch_gridlml.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsum_tpu as gj
import gsum_tpu_torch as gt
from gsum_tpu.parallel import batched as jb
from gsum_tpu_torch.convert import to_torch_kernel, to_torch_posterior
from gsum_tpu_torch.parallel import batched as tb
from _port import one_intra_op_thread  # noqa: F401 (autouse)

N, NUG = 16, 1e-3
TOL = 1e-10
PRIOR = dict(df=3, scale=1.5, nugget=NUG)


def _kernel_j():
    return gj.ConstantKernel(1.0, (1e-2, 1e2)) * gj.RBF(0.3, (1e-2, 1e1))


def _data():
    rng = np.random.RandomState(0)
    X = np.linspace(0, 1, N)[:, None]
    y = np.stack([np.sin(4 * X[:, 0] + k) for k in range(2)], 1) \
        + 0.1 * rng.randn(N, 2)
    thetas = np.log(np.stack([np.linspace(0.5, 2.0, 5),
                              np.linspace(0.1, 0.6, 5)], 1))
    return X, y, thetas


def t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)


@pytest.fixture(scope='module')
def jax_grid():
    X, y, th = _data()
    k = _kernel_j()
    out = {e: np.asarray(jb.batched_lml_grid(k, X, y, th, engine=e, **PRIOR))
           for e in ('grid', 'scan', 'scalar')}
    out['auto'] = np.asarray(jb.batched_lml_grid(k, X, y[:, 0], th, **PRIOR))
    for prec in ('f32', 'mixed'):
        out[prec] = np.asarray(jb.batched_lml_grid(
            k, X, y, th, engine='scalar', precision=prec, top_k=2, **PRIOR))
    return out


@pytest.mark.parametrize('engine', ['grid', 'scan', 'scalar', 'blocked'])
def test_batched_lml_grid_engines(jax_grid, engine):
    X, y, th = _data()
    got = tb.batched_lml_grid(to_torch_kernel(_kernel_j()), t(X), t(y),
                              t(th), engine=engine, **PRIOR)
    assert got.dtype == torch.float64
    _close(got, jax_grid['grid' if engine == 'blocked' else engine])


def test_batched_lml_grid_auto_and_1d_y(jax_grid):
    X, y, th = _data()
    got = tb.batched_lml_grid(to_torch_kernel(_kernel_j()), t(X),
                              t(y[:, 0]), t(th), **PRIOR)
    _close(got, jax_grid['auto'])


def test_batched_lml_grid_precisions(jax_grid):
    """'f32' sweeps in f32; 'mixed' is the f32 sweep with the top_k points
    evaluated again in f64, those JAX's f64 values (1e-10).  The f32
    values carry about κ·ε₃₂ ≈ 1e4 · 6e-8 relative error in their
    quadratic forms (JAX solves in f32, the scalar lml of the port in f64
    after an f32 factor), so they are held to 1e-3 of the largest |lml|."""
    X, y, th = _data()
    k = to_torch_kernel(_kernel_j())
    f32 = tb.batched_lml_grid(k, t(X), t(y), t(th), engine='scalar',
                              precision='f32', **PRIOR)
    assert f32.dtype == torch.float64   # the f32 lml is promoted, as JAX's
    f32_tol = 1e-3 * np.abs(jax_grid['f32']).max()
    np.testing.assert_allclose(f32.numpy(), jax_grid['f32'], rtol=0,
                               atol=f32_tol)
    mixed = tb.batched_lml_grid(k, t(X), t(y), t(th), engine='scalar',
                                precision='mixed', top_k=2, **PRIOR)
    top = np.argsort(jax_grid['f32'])[-2:]
    _close(mixed[top], jax_grid['scalar'][top])
    rest = np.setdiff1d(np.arange(len(th)), top)
    np.testing.assert_allclose(mixed[rest].numpy(), jax_grid['f32'][rest],
                               rtol=0, atol=f32_tol)
    with pytest.raises(ValueError, match='precision'):
        tb.batched_lml_grid(k, t(X), t(y), t(th), precision='f16')
    with pytest.raises(ValueError, match='engine'):
        tb.batched_lml_grid(k, t(X), t(y), t(th), engine='dense')


@pytest.mark.parametrize('process', ['gp', 'tp'])
def test_truncation_lml_grid(process):
    """The (θ, ratio) surface against JAX, and one point against the port's
    TruncationGP / TruncationTP lml at that θ and ratio."""
    rng = np.random.RandomState(1)
    X = np.linspace(0, 1, 12)[:, None]
    orders = np.arange(4)
    c = np.stack([np.sin(3 * X[:, 0] + k) for k in orders], 1) \
        + 0.05 * rng.randn(12, 4)
    y = np.asarray(gj.partials(c, ratio=0.5, ref=2.0, orders=orders))
    kj = gj.RBF(0.3, (1e-2, 10)) + gj.WhiteKernel(1e-3, (1e-8, 1e-1))
    thetas = np.log(np.stack([np.linspace(0.2, 0.6, 3),
                              np.full(3, 1e-3)], 1))
    ratios = np.array([0.4, 0.5, 0.6, 0.7])
    prior = dict(center=0, disp=0, df=3 if process == 'gp' else 5, scale=1)
    want = np.asarray(jb.truncation_lml_grid(
        kj, X, y, orders, ratios, thetas, ref=2.0, excluded=[0],
        process=process, **prior))
    kt = to_torch_kernel(kj)
    got = tb.truncation_lml_grid(kt, t(X), t(y), orders, t(ratios), t(thetas),
                                 ref=2.0, excluded=[0], process=process,
                                 **prior)
    _close(got, want)
    cls = gt.TruncationGP if process == 'gp' else gt.TruncationTP
    model = cls(kt, ratio=0.5, ref=2.0, excluded=[0], device='cpu', **prior)
    one = model.log_marginal_likelihood(t(thetas[1]), X=t(X), y=t(y),
                                        orders=orders, ratio=0.6)
    _close(got[1, 2], one.numpy())
    with pytest.raises(ValueError, match='process'):
        tb.truncation_lml_grid(kt, t(X), t(y), orders, t(ratios), t(thetas),
                               process='sp')


@pytest.mark.parametrize('prior', [dict(df=3, scale=1.0),
                                   dict(df=0, excluded=[0])],
                         ids=['df=3', 'df=0'])
def test_pointwise_evidence_grid(prior):
    """Against JAX (1e-12) and against the port's
    TruncationPointwise.log_likelihood looped over per-point ratio rows
    (the grid's own convention: a scalar ratio is broadcast to every point
    and its change of variables counted N times)."""
    rng = np.random.RandomState(3)
    orders = np.arange(5)
    Q = 0.3 + 0.1 * rng.rand(N)
    y = np.asarray(gj.partials(rng.randn(N, 5), ratio=Q, ref=2.0,
                               orders=orders))
    ratios = np.stack([Q / lam for lam in np.linspace(0.7, 1.4, 6)])
    want = np.asarray(jb.pointwise_evidence_grid(y, orders, ratios, ref=2.0,
                                                 **prior))
    got = tb.pointwise_evidence_grid(t(y), orders, t(ratios), ref=2.0,
                                     **prior)
    _close(got, want, 1e-12)
    m = gt.TruncationPointwise(device='cpu', **prior).fit(
        t(y), ratio=t(Q), ref=2.0, orders=orders)
    loop = torch.stack([m.log_likelihood(ratio=t(r)).reshape(())
                        for r in ratios])
    _close(got, loop.numpy(), 1e-12)
    # a scalar ratio row broadcasts to every point
    scalar = tb.pointwise_evidence_grid(t(y), orders, t([0.4, 0.5]),
                                        ref=2.0, **prior)
    rows = tb.pointwise_evidence_grid(t(y), orders,
                                      t(np.full((2, N), [[0.4], [0.5]])),
                                      ref=2.0, **prior)
    _close(scalar, rows.numpy(), 1e-14)


@pytest.fixture(scope='module')
def jax_posterior():
    X, y, th = _data()
    k = _kernel_j()
    post = jb.batched_posterior_at(k, X, y, th[:3], disp=1.0, center=0.2,
                                   chunk=2, **PRIOR)
    Xn = np.linspace(-0.1, 1.1, 7)[:, None]
    Yb = np.broadcast_to(y, (3,) + y.shape)
    preds = {(st, mode): tuple(np.asarray(a) for a in jb.batched_predict(
        k, post, X, Yb, Xn, student=st, student_mode=mode))
        for st, mode in ((False, 'class'), (True, 'class'),
                         (True, 'variance'))}
    return post, Xn, preds


def test_batched_posterior_at(jax_posterior):
    """Every field against JAX (1e-10), chunked in twos; f64 throughout."""
    post_j, _, _ = jax_posterior
    X, y, th = _data()
    post = tb.batched_posterior_at(to_torch_kernel(_kernel_j()), t(X), t(y),
                                   t(th[:3]), disp=1.0, center=0.2, chunk=2,
                                   **PRIOR)
    for f in ('theta', 'lml', 'center', 'disp', 'df', 'scale_sq',
              'cov_factor', 'chol'):
        got, want = getattr(post, f), np.asarray(getattr(post_j, f))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max())


@pytest.mark.parametrize('student,mode', [(False, 'class'), (True, 'class'),
                                          (True, 'variance')])
def test_batched_predict_on_carried_posterior(jax_posterior, student, mode):
    """``batched_predict`` on JAX's own state carried by
    ``to_torch_posterior``: means and stds equal JAX's (1e-10)."""
    post_j, Xn, preds = jax_posterior
    X, y, _ = _data()
    post = to_torch_posterior(post_j, 'cpu')
    assert isinstance(post, tb.BatchedPosterior)
    Yb = t(np.broadcast_to(y, (3,) + y.shape).copy())
    mean, std = tb.batched_predict(to_torch_kernel(_kernel_j()), post, t(X),
                                   Yb, t(Xn), student=student,
                                   student_mode=mode)
    for got, want in zip((mean, std), preds[student, mode]):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max())
    with pytest.raises(ValueError, match='student_mode'):
        tb.batched_predict(to_torch_kernel(_kernel_j()), post, t(X), Yb,
                           t(Xn), student_mode='mixture')
    with pytest.raises(TypeError, match='basis'):
        tb.batched_predict(to_torch_kernel(_kernel_j()), post, t(X), Yb,
                           t(Xn), basis=np.ones((N, 1)))


def test_auto_fit_engine_table():
    """JAX's table, with the card ('cuda') where JAX reads a TPU."""
    cases = [(n, dt) for n in (128, 192, 193, 520, 640, 641, 768, 1024,
                               1025, 4096, 8192, 8193)
             for dt in ('float32', 'float64')]
    for n, dt in cases:
        for jb_backend, tb_backend in (('tpu', 'cuda'), ('cpu', 'cpu')):
            want = jb._auto_fit_engine(getattr(jnp, dt), n, jb_backend)
            got = tb._auto_fit_engine(getattr(torch, dt), n, tb_backend)
            assert got == want, (n, dt, tb_backend)
    assert tb._auto_fit_engine(torch.float32, 4096, 'cuda') == 'blocked'


def test_scalar_chunk_cap():
    """JAX's 24 N² temporaries per live element against a stated share of
    the card's memory: at the v5e's 16 GB the cap is JAX's (12 GB); at the
    H100's 80 GB five times more fits."""
    for n, ls, dt in ((4096, 10, 'float32'), (2048, 10, 'float64'),
                      (1024, 10, 'float32'), (16384, 10, 'float64'),
                      (1500, 5, 'float64')):
        want = jb._scalar_chunk_cap(n, ls, getattr(jnp, dt))
        got = tb._scalar_chunk_cap(n, ls, getattr(torch, dt), 16e9)
        assert got == want
    assert tb._scalar_chunk_cap(1024, 10, torch.float32, 80e9) == \
        int(0.75 * 80e9 // (24 * 1024 ** 2 * 4 * 10))
    assert tb._scalar_chunk_cap(16384, 10, torch.float64, 80e9) == 1


def test_tf32_scope_leaves_global_settings_unchanged(monkeypatch):
    """``mxu_precision='high'`` and ``precision='high'`` carry the precision
    in the products (3xTF32, ``blockchol._mm``), also into the backward,
    which runs after the call has returned: TF32 is on only while the
    three GEMMs of a split product are issued, and the global flags are as
    before after every call, also after an error inside a product.  On the
    CPU ``'high'`` splits nothing, so ``_split_gemms`` is forced here to
    drive the split path through the forward and the backward."""
    from gsum_tpu_torch.ops import batched_blocked_cholesky, blockchol

    flags = torch.backends.cuda.matmul
    before = (flags.allow_tf32, torch.get_float32_matmul_precision())
    X, y, th = _data()
    k = to_torch_kernel(_kernel_j())
    tb.batched_lml_grid(k, t(X), t(y), t(th), engine='blocked',
                        mxu_precision='high', **PRIOR)
    assert (flags.allow_tf32, torch.get_float32_matmul_precision()) == before
    with pytest.raises(ValueError, match='precision'):
        batched_blocked_cholesky(torch.eye(3), precision='medium')

    seen = []
    matmul = torch.matmul

    def spy(a, b):
        seen.append(flags.allow_tf32)
        return matmul(a, b)
    monkeypatch.setattr(torch, 'matmul', spy)
    monkeypatch.setattr(blockchol, '_split_gemms',
                        lambda precision, x: precision == 'high')
    grads = {}
    for prec in (None, 'high'):
        A = torch.eye(40, dtype=torch.float32).expand(2, 40, 40) * 2.0
        A = (A + 0.1).requires_grad_(True)
        L = batched_blocked_cholesky(A, block=16, precision=prec)
        assert all(s is before[0] for s in seen) == (prec is None)
        n_forward = len(seen)
        L.sum().backward()
        assert all(s is before[0] for s in seen[n_forward:]) == (
            prec is None)
        assert torch.isfinite(A.grad).all()
        grads[prec] = A.grad
        seen.clear()
        assert flags.allow_tf32 == before[0]
    # on the CPU the three f32 products drop lo·lo and lo's rounding:
    # about 2⁻²¹ of |a||b|
    torch.testing.assert_close(grads['high'], grads[None], rtol=1e-5,
                               atol=1e-6)
    outs = {}
    Y = torch.linspace(-1, 1, 80).reshape(2, 40, 1)
    for prec in (None, 'high'):
        A = (torch.eye(40).expand(2, 40, 40) * 2.0 + 0.1).requires_grad_(True)
        x, ld, ok = blockchol.blocked_spd_solve_logdet(A, Y, block=16,
                                                       precision=prec)
        assert all(s is before[0] for s in seen) == (prec is None)
        seen.clear()
        (x.sum() + ld.sum()).backward()
        assert all(s is before[0] for s in seen) == (prec is None)
        seen.clear()
        outs[prec] = (x.detach(), ld.detach(), A.grad)
    for got, want in zip(outs['high'], outs[None]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert (flags.allow_tf32, torch.get_float32_matmul_precision()) == before

    def fails(a, b):
        assert flags.allow_tf32
        raise RuntimeError('inside')
    monkeypatch.setattr(torch, 'matmul', fails)
    with pytest.raises(RuntimeError, match='inside'):
        blockchol._mm(torch.ones(2, 2), torch.ones(2, 2), split=True)
    assert (flags.allow_tf32, torch.get_float32_matmul_precision()) == before


def test_3xtf32_products_against_one_tf32_product(monkeypatch):
    """The split of ``blockchol._mm``: hi and lo are TF32 values (their
    low 13 bits are zero), so a TF32 GEMM takes them exactly whatever its
    own input rounding, and hi + lo is within 2⁻²³ of x.  With TF32's
    input rounding emulated (the operands cut to 10 mantissa bits, the
    products in f64), one product keeps only 2⁻¹¹ per operand and the
    3xTF32 product is within 2⁻²⁰·(|a||b|) elementwise (the dropped lo·lo
    term is 2⁻²², lo's rounding 2⁻²³ in each cross term, the f32 output
    2⁻²⁴)."""
    from gsum_tpu_torch.ops import blockchol

    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 64, 96, generator=g)
    b = torch.randn(3, 96, 48, generator=g)
    low = (1 << 13) - 1
    hi, lo = blockchol._tf32_parts(a)
    assert not (hi.view(torch.int32) & low).any()
    assert not (lo.view(torch.int32) & low).any()
    assert ((a - hi).abs() <= a.abs() * 2.0 ** -11).all()
    assert ((a - hi - lo).abs() <= a.abs() * 2.0 ** -23).all()

    def cut(x):
        return (x.contiguous().view(torch.int32)
                & blockchol._TF32_MASK).view(torch.float32).double()

    monkeypatch.setattr(torch, 'matmul',
                        lambda x, y: (cut(x) @ cut(y)).float())
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err3 = ((blockchol._mm(a, b, split=True).double() - exact).abs()
            / scale).max().item()
    err1 = ((torch.matmul(a, b).double() - exact).abs() / scale).max().item()
    assert err3 <= 2.0 ** -20
    assert err1 > 2.0 ** -14 > 64 * err3




@pytest.mark.parametrize('call', ['lml_grid', 'fit', 'pointwise',
                                  'posterior_at', 'predict'])
def test_mesh_raises(call):
    """A batch that does not divide over the mesh's 'batch' axis raises
    JAX's ``_check_mesh_batch`` error (5 θ rows, 2 curves, 1 ratio, 3
    fits over 4 shards)."""
    X, y, th = _data()
    k = to_torch_kernel(_kernel_j())
    mesh = gt.parallel.make_mesh(n_batch=4, devices=['cpu'] * 4)
    post = tb.batched_posterior_at(k, t(X), t(y), t(th[:3]), **PRIOR)
    fns = {
        'lml_grid': lambda: tb.batched_lml_grid(k, t(X), t(y), t(th),
                                                mesh=mesh),
        'fit': lambda: tb.batched_fit(k, t(X), t(y.T), mesh=mesh),
        'pointwise': lambda: tb.pointwise_evidence_grid(
            t(y), np.arange(2), t([0.5]), mesh=mesh),
        'posterior_at': lambda: tb.batched_posterior_at(
            k, t(X), t(y), t(th), mesh=mesh),
        'predict': lambda: tb.batched_predict(k, post, t(X),
                                              t(np.stack([y] * 3)), t(X),
                                              mesh=mesh),
    }
    with pytest.raises(ValueError, match="not divisible by the mesh 'batch' "
                                         'axis size 4'):
        fns[call]()


ZOO = {
    'RBF': lambda: gt.RBF(0.4, (1e-2, 10)),
    'RBF anisotropic': lambda: gt.RBF([0.4, 0.7], (1e-2, 10)),
    'Matern 0.5': lambda: gt.Matern(0.4, (1e-2, 10), nu=0.5),
    'Matern 1.5': lambda: gt.Matern(0.4, (1e-2, 10), nu=1.5),
    'Matern 2.5': lambda: gt.Matern(0.4, (1e-2, 10), nu=2.5),
    'Matern inf': lambda: gt.Matern(0.4, (1e-2, 10), nu=np.inf),
    'Matern 0.7 (Temme)': lambda: gt.Matern(0.4, (1e-2, 10), nu=0.7),
    'RationalQuadratic': lambda: gt.RationalQuadratic(0.4, 1.5),
    'ExpSineSquared': lambda: gt.ExpSineSquared(0.4, 1.2),
    'DotProduct': lambda: gt.DotProduct(0.5),
    'Constant × RBF + White': lambda: gt.ConstantKernel(2.0) * gt.RBF(0.4)
    + gt.WhiteKernel(1e-2),
    'RBF ** 2': lambda: gt.Exponentiation(gt.RBF(0.4), 2),
}


@pytest.mark.parametrize('name', list(ZOO))
def test_vmapped_covariances_every_kernel(name):
    """The batched covariance build is ``torch.func.vmap`` of ``value_fn``
    over θ rows: for every kernel of the zoo it equals the loop over θ
    (1e-14), and its gradient in θ the loop's."""
    k = ZOO[name]()
    X = t(np.random.RandomState(7).rand(9, 2))
    th = torch.tensor(k.theta)[None] + t(
        np.random.RandomState(8).randn(3, k.n_dims) * 0.2)
    th.requires_grad_(True)
    got = tb._covariances(k, th, X, NUG)
    want = torch.stack([k.value_fn(row, X, None) for row in th]) \
        + NUG * torch.eye(9, dtype=torch.float64)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-14, atol=1e-14)
    (g,) = torch.autograd.grad(got.sum(), th)
    (g2,) = torch.autograd.grad(want.sum(), th)
    np.testing.assert_allclose(g.numpy(), g2.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_numpy_inputs_go_to_the_card():
    """Numpy data go to the default device (the card), refused where there
    is none; CPU tensors stay on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is visible: numpy would go to it')
    X, y, th = _data()
    k = to_torch_kernel(_kernel_j())
    with pytest.raises(RuntimeError, match='cuda'):
        tb.batched_lml_grid(k, X, y, th, **PRIOR)
    out = tb.batched_lml_grid(k, t(X), y, th, **PRIOR)
    assert out.device.type == 'cpu'


def test_batched_chol_logpdf_precision_on_the_cpu():
    """``precision='high'`` changes nothing on the CPU (TF32 is a CUDA
    GEMM mode) and leaves the global flag as it was; an unknown precision
    is refused."""
    from gsum_tpu_torch.ops import batched_chol_logpdf

    rng = np.random.RandomState(9)
    X = torch.tensor(rng.rand(2, 300, 2), dtype=torch.float32)
    y = torch.tensor(rng.randn(2, 300, 3), dtype=torch.float32)
    before = torch.backends.cuda.matmul.allow_tf32
    lo = batched_chol_logpdf(X, y, 0.3, 1.0, 1e-2, method='blocked',
                             block=128)
    hi = batched_chol_logpdf(X, y, 0.3, 1.0, 1e-2, method='blocked',
                             block=128, precision='high')
    assert torch.equal(lo, hi)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    with pytest.raises(ValueError, match='precision'):
        batched_chol_logpdf(X, y, 0.3, 1.0, 1e-2, method='blocked',
                            block=128, precision='low')
