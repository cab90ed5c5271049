"""``parallel.batched`` of the port against ``gsum_tpu.parallel.batched`` on
the CPU: ``batched_lml_grid`` (engines and precisions), the truncation
and pointwise sweeps, ``batched_posterior_at`` and ``batched_predict`` on a
posterior carried by ``convert.to_torch_posterior``; the engine table, the
scalar engine's chunk cap, the precision arguments of JAX's signatures
and the ``mesh=`` batch check.
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
    """On the CPU, JAX's table (the parity tests run there).  On the card
    ('cuda', where JAX reads a TPU), JAX's table outside 192 < N <= 640,
    and inside it the H100's own row: the blocked engine in f64 and f32,
    the fastest of the four engines at N = 256, 350, 512 and 640 at the
    fit's widths (``chip_smoke.engine_table``; the readings are in
    PERF.md), where JAX's TPU table has the scan engine.  In f64 that
    route factors in column blocks of 64, the scan engine's own width."""
    cases = [(n, dt) for n in (128, 192, 193, 256, 350, 512, 520, 640, 641,
                               768, 1024, 1025, 4096, 8192, 8193)
             for dt in ('float32', 'float64')]
    for n, dt in cases:
        cpu = jb._auto_fit_engine(getattr(jnp, dt), n, 'cpu')
        assert tb._auto_fit_engine(getattr(torch, dt), n, 'cpu') == cpu
        card = ('blocked' if 192 < n <= 640
                else jb._auto_fit_engine(getattr(jnp, dt), n, 'tpu'))
        assert tb._auto_fit_engine(getattr(torch, dt), n, 'cuda') == card, \
            (n, dt)
    assert tb._auto_fit_engine(torch.float64, 350, 'cpu') == 'scan'
    assert tb._auto_fit_engine(torch.float32, 4096, 'cuda') == 'blocked'
    assert tb._F64_FIT_BLOCK == 64


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


def _wide_data(n=150, g=3):
    """f32 CPU data at N = ``n``, above the blocked engine's 128-wide block,
    so that its column-block loop runs: inputs, two curves and ``g`` θ
    rows."""
    rng = np.random.RandomState(9)
    X = torch.linspace(0, 1, n)[:, None]
    y = torch.tensor(rng.randn(n, 2), dtype=torch.float32)
    th = torch.log(torch.tensor([[1.0, 0.2], [1.5, 0.3], [0.7, 0.5]][:g]))
    return X, y, th


def _spd(n=40, seed=0):
    """(2, n, n) f32 SPD matrices, well conditioned."""
    A = torch.randn(2, n, n, generator=torch.Generator().manual_seed(seed))
    return A @ A.mT / n + torch.eye(n)


def _grads(out, *leaves):
    """``out`` (a tuple of tensors) followed by the gradients of its sum
    with respect to ``leaves``."""
    gs = torch.autograd.grad(sum(o.sum() for o in out), leaves)
    return tuple(o.detach() for o in out) + gs


def _chol_logpdf(prec):
    from gsum_tpu_torch.ops import batched_chol_logpdf
    rng = np.random.RandomState(9)
    X = torch.tensor(rng.rand(2, 300, 2), dtype=torch.float32)
    y = torch.tensor(rng.randn(2, 300, 3), dtype=torch.float32)
    return (batched_chol_logpdf(X, y, 0.3, 1.0, 1e-2, method='blocked',
                                block=128, precision=prec),)


def _chol_solve_logdet(prec):
    from gsum_tpu_torch.ops import blocked_chol_solve_logdet
    return blocked_chol_solve_logdet(_spd(), torch.ones(2, 40, 3), block=16,
                                     precision=prec)


def _factor_cho_solve(prec):
    from gsum_tpu_torch.ops import blocked_cho_solve, blocked_factor
    L, minvs = blocked_factor(_spd(), block=16, precision=prec)
    return L, blocked_cho_solve(L, minvs, torch.ones(2, 40, 3),
                                precision=prec)


def _blocked_cholesky(prec):
    from gsum_tpu_torch.ops import batched_blocked_cholesky
    A = _spd().requires_grad_(True)
    L = batched_blocked_cholesky(A, block=16, precision=prec)
    return _grads((L * torch.linspace(0, 1, 40),), A)


def _spd_solve_logdet(prec):
    from gsum_tpu_torch.ops import blocked_spd_solve_logdet
    A = _spd().requires_grad_(True)
    Y = torch.linspace(-1, 1, 240).reshape(2, 40, 3).requires_grad_(True)
    x, ld, ok = blocked_spd_solve_logdet(A, Y, block=16, precision=prec)
    assert ok.all()
    return _grads((x, ld), A, Y)


def _cgp_lml_grid(prec):
    from gsum_tpu_torch.ops import gridlml as tg
    Rs = _spd().requires_grad_(True)
    lml = tg.cgp_lml_grid(Rs, torch.ones(40, 2), torch.ones(40, 1), 0.3, 0,
                          3.0, 1.5, engine='blocked', block=16,
                          mxu_precision=prec)
    return _grads((lml,), Rs)


def _lml_grid(prec):
    X, y, th = _wide_data()
    th.requires_grad_(True)
    lml = tb.batched_lml_grid(to_torch_kernel(_kernel_j()), X, y, th,
                              engine='blocked', precision='f32', df=3,
                              scale=1.5, nugget=1e-2, mxu_precision=prec)
    return _grads((lml,), th)


def _fit(prec):
    X, y, _ = _wide_data()
    post = tb.batched_fit(to_torch_kernel(_kernel_j()), X, y.T, df=3,
                          scale=1.5, nugget=1e-2, maxiter=2,
                          engine='blocked', precision='f32',
                          mxu_precision=prec)
    return post.lml, post.theta


@pytest.mark.parametrize('call, name', [
    (_chol_logpdf, 'precision'), (_chol_solve_logdet, 'precision'),
    (_factor_cho_solve, 'precision'), (_blocked_cholesky, 'precision'),
    (_spd_solve_logdet, 'precision'), (_cgp_lml_grid, 'mxu_precision'),
    (_lml_grid, 'mxu_precision'), (_fit, 'mxu_precision')],
    ids=lambda v: getattr(v, '__name__', v).strip('_'))
def test_batched_chol_logpdf_precision_on_the_cpu(call, name):
    """Every public entry that takes ``precision`` / ``mxu_precision``
    computes in full f32 whatever its value: ``'high'`` gives None's
    results and gradients bit for bit (f32, N above the block, so that
    the blocked loop runs), the global matmul settings are as before, and
    an unknown value is refused with the argument's name."""
    flags = torch.backends.cuda.matmul
    before = (flags.allow_tf32, torch.get_float32_matmul_precision())
    want = call(None)
    got = call('high')
    assert (flags.allow_tf32, torch.get_float32_matmul_precision()) == before
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        assert torch.equal(g, w)
    torch.testing.assert_close(call('HIGHEST'), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match=name):
        call('medium')
