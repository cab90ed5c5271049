"""``gsum_tpu_torch.checkpoint`` against ``gsum_tpu.checkpoint`` on the CPU:
a file written by either package loads into the other, derivative state
included, and the restore-compat rejections match.

Limits: a restored model holds the saved arrays exactly (checked bit for
bit), so its predictions differ from the other package's only by the two
packages' prediction arithmetic on the same arrays: ``10·cond(R)·EPS``
relative (at least 1e-12), with R the model's correlation matrix
(cond ≈ 10³–10⁵ here).  A model saved and loaded within the port predicts
bit for bit the same.
"""
import jax
import numpy as np
import pytest
import torch

import gsum_tpu as gm
import gsum_tpu_torch as gt
from gsum_tpu import checkpoint as jc
from gsum_tpu_torch import checkpoint as tc
from gsum_tpu_torch.convert import to_torch_kernel

EPS = np.finfo(float).eps
X = np.linspace(0, 1, 10)[:, None]
Y = np.sin(3 * X[:, 0]) + 0.3 * X[:, 0]
DORD = np.array([0, 1, 0, 0, 1, 0, 2, 0, 0, 1])[:, None]
XNEW = np.linspace(0.05, 0.95, 5)[:, None]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _limit(R):
    R = R.numpy() if isinstance(R, torch.Tensor) else np.asarray(R)
    return max(1e-12, 10 * np.linalg.cond(R) * EPS)


def _cgp(mod, **kw):
    k = mod.ConstantKernel(1.3, (1e-2, 1e2)) * mod.RBF(0.25, (1e-2, 10))
    return mod.ConjugateGaussianProcess(k, df=3, scale=1, nugget=1e-8,
                                        optimizer=None, **kw)


ZOO = [gm.ConstantKernel(2.5), gm.WhiteKernel(1e-3), gm.RBF(0.3),
       gm.RBF([0.3, 1.7]), gm.Matern(0.4, nu=0.5), gm.Matern(0.4, nu=1.5),
       gm.Matern([0.4, 2.0], nu=2.5), gm.Matern(0.4, nu=np.inf),
       gm.Matern(0.4, nu=3.5), gm.RationalQuadratic(0.5, 1.3),
       gm.ExpSineSquared(0.8, 1.7), gm.DotProduct(0.7),
       gm.ConstantKernel(2.0) * gm.RBF(0.4) + gm.WhiteKernel(1e-4),
       gm.RBF(0.2) ** 2, gm.ConstantKernel(1.0, 'fixed') * gm.RBF(0.4, 'fixed')]


def test_every_kernel_prints_as_in_jax():
    """The restore check compares kernel reprs, so each kernel of the zoo
    prints exactly as JAX's."""
    for k in ZOO:
        assert repr(to_torch_kernel(k)) == repr(k)


def test_jax_file_loads_into_the_port_and_back(tmp_path):
    """A CGP with derivative observations: JAX → port → JAX."""
    jm = _cgp(gm).fit(X, Y, dorders=DORD)
    jc.save(str(tmp_path / 'jax'), jm)
    tm = tc.load(str(tmp_path / 'jax'), _cgp(gt, device='cpu'))
    np.testing.assert_array_equal(tm.dorders_, DORD)
    arrays, meta = jc.state_dict(jm)
    arrays_t, meta_t = tc.state_dict(tm)
    assert meta_t == meta
    for k, v in arrays.items():
        np.testing.assert_array_equal(arrays_t[k], v)
    lim = _limit(tm.corr_)
    for g, w in zip(tm.predict(_t(XNEW), return_cov=True),
                    jm.predict(XNEW, return_cov=True)):
        _close(g, w, lim)
    # the port's file, back into JAX: the same state, bit for bit
    tc.save(str(tmp_path / 'port'), tm)
    jm2 = jc.load(str(tmp_path / 'port.npz'), _cgp(gm))
    np.testing.assert_array_equal(jm2.dorders_, DORD)
    arrays2, meta2 = jc.state_dict(jm2)
    assert meta2 == meta
    for k, v in arrays.items():
        np.testing.assert_array_equal(arrays2[k], v)


def test_truncation_with_slope_constraints_both_ways(tmp_path):
    """A TruncationTP with value and slope constraints: the port's file
    into JAX and JAX's into the port, each predicting as the other
    package's model."""
    orders = np.arange(4)
    yn = np.asarray(gm.partials(np.sin(3 * X + np.arange(4)), 0.45, 2.0,
                                orders))
    dX, dy, dd = np.array([[1.0], [1.0]]), np.zeros(2), np.array([[0], [1]])

    def make(mod, **kw):
        return mod.TruncationTP(mod.RBF(0.1, (1e-2, 10)), ratio=0.45,
                                ref=2.0, disp=1, df=5, scale=1, nugget=1e-10,
                                optimizer=None, **kw)

    tm = make(gt, device='cpu').fit(_t(X), _t(yn), orders, dX=_t(dX),
                                    dy=_t(dy), dderivs=dd)
    tc.save(str(tmp_path / 'tp'), tm)
    jm = jc.load(str(tmp_path / 'tp'), make(gm))
    np.testing.assert_array_equal(np.asarray(jm.dderivs_), dd)
    want = jax.jit(lambda Xn: jm.predict(Xn, 2, return_std=True))(XNEW)
    got = tm.predict(_t(XNEW), 2, return_std=True)
    lim = _limit(tm.cov(X=_t(X), Xp=_t(X), start=0, end=2))
    for g, w in zip(got, want):
        _close(g, w, lim)
    # JAX's file into the port, then the port's own round trip
    jc.save(str(tmp_path / 'tp_jax'), jm)
    tm2 = tc.load(str(tmp_path / 'tp_jax'), make(gt, device='cpu'))
    np.testing.assert_array_equal(tm2.dderivs_, dd)
    for g, w in zip(tm2.predict(_t(XNEW), 2, return_std=True), got):
        assert torch.equal(g, w)


def test_restore_rejections_match_jax(tmp_path):
    """Unfitted models, other priors, nugget, decomposition or class, a
    kernel of another structure (θ sizes equal), another θ size, other
    excluded orders: rejected by both packages alike."""
    jm = _cgp(gm).fit(X, Y)
    arrays, meta = jc.state_dict(jm)
    with pytest.raises(ValueError, match='fitted before'):
        tc.state_dict(_cgp(gt, device='cpu'))
    cases = [
        dict(df=4), dict(scale=2), dict(nugget=1e-6),
        dict(decomposition='eig'), dict(center=1),
    ]
    for kw in cases:
        args = {**dict(df=3, scale=1, nugget=1e-8), **kw}
        for mod, dev in ((gm, {}), (gt, {'device': 'cpu'})):
            k = mod.ConstantKernel(1.3, (1e-2, 1e2)) * mod.RBF(0.25,
                                                               (1e-2, 10))
            gp = mod.ConjugateGaussianProcess(k, optimizer=None, **args,
                                              **dev)
            with pytest.raises(ValueError, match='incompatible'):
                (jc if mod is gm else tc).restore_state(gp, arrays, meta)
    csp = gt.ConjugateStudentProcess(
        to_torch_kernel(jm.kernel), df=3, scale=1, nugget=1e-8,
        device='cpu')
    with pytest.raises(ValueError, match='class'):
        tc.restore_state(csp, arrays, meta)
    for bad in (gm.ConstantKernel(1.0, (1e-2, 1e2))
                * gm.Matern(0.25, (1e-2, 10), nu=1.5),
                gm.RBF(0.25, (1e-2, 10))):
        gp = gt.ConjugateGaussianProcess(to_torch_kernel(bad), df=3, scale=1,
                                         nugget=1e-8, device='cpu')
        with pytest.raises(ValueError, match='kernel'):
            tc.restore_state(gp, arrays, meta)
    orders = np.arange(3)
    yn = np.column_stack([Y, Y + 0.1 * X[:, 0], Y + 0.05 * X[:, 0] ** 2])
    jt = gm.TruncationGP(gm.RBF(0.3, 'fixed'), ratio=0.5, nugget=1e-8,
                         optimizer=None).fit(X, yn, orders)
    jc.save(str(tmp_path / 'tgp'), jt)
    bad = gt.TruncationGP(gt.RBF(0.3, 'fixed'), ratio=0.5, nugget=1e-8,
                          optimizer=None, excluded=[0], device='cpu')
    with pytest.raises(ValueError, match='excluded'):
        tc.load(str(tmp_path / 'tgp'), bad)
    with pytest.raises(ValueError, match='checkpoint is a'):
        tc.load(str(tmp_path / 'tgp'), gt.TruncationTP(
            gt.RBF(0.3, 'fixed'), ratio=0.5, device='cpu'))
    with pytest.raises(ValueError, match='TruncationPointwise'):
        tc.state_dict(gt.TruncationPointwise(device='cpu').fit(
            _t(yn), 0.5, orders=orders))
