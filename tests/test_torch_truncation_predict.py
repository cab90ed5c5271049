"""The port's truncation models (``gsum_tpu_torch.models.TruncationGP`` /
``TruncationTP``) against their ``gsum_tpu`` twins on the same seeded
inputs, f64 on the CPU: ``predict`` of every kind, with and without the
constraint, the ``Xc`` / ``y`` overrides and a callable ratio.  The port's
models are built from the JAX ones by ``convert.to_torch_model``; data and
helpers are in ``_truncation.py``.

Tolerances:
- the coefficients at 1e-12; the lml at 1e-10 and its autograd gradient
  against ``jax.grad`` at 1e-10; the truncation band ('trunc') and
  everything else that solves with a well-conditioned matrix at 1e-10
  (relative, with an absolute floor at the tolerance times the largest
  entry);
- the interpolant ('interp', and 'both', which adds it) solves with K_oo,
  the noise-free Gram matrix of the orders up to k (a ``WhiteKernel``
  returns zeros when Xp is given), through ``robust_cholesky``'s jitter
  ladder.  Both sides must take the same rung, and they agree to cond·ε,
  the first-order bound on the relative error of a backward-stable solve,
  with cond the condition number of the jittered K_oo (at least 1e-10);
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsum_tpu as gm
from gsum_tpu_torch.convert import to_torch_model

from _truncation import (DX, DY, LENGTH_SCALES, ORDERS, PRIORS, RTOL, THETA,
                         X, XNEW, Y, at_theta, close, interp_tol, jax_kernel,
                         pairs, ratio_jax, ratio_torch, t)
from _port import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize('conditioning,constrained', [
    ('well conditioned', False), ('well conditioned', True),
    ('ill conditioned', False)],
    ids=['well conditioned, free band', 'well conditioned, band constrained '
         'at dX', 'ill conditioned, free band'])
@pytest.mark.parametrize('name', list(PRIORS))
def test_predict_matches_jax(name, conditioning, constrained):
    """At one θ (``optimizer=None``): every ``kind`` with std and with cov,
    and the mean alone of 'both', at order 3; with the truncation error constrained
    to 0 at two points beyond the data, and without.  'trunc' at 1e-10,
    'interp' and 'both' at :func:`interp_tol`; at the constraint points the
    band's std is 0 on both sides."""
    jm, tm = at_theta(name, LENGTH_SCALES[conditioning])
    fit = dict(dX=DX, dy=DY) if constrained else {}
    jm.fit(X, Y, orders=ORDERS, **fit)
    tm.fit(t(X), t(Y), orders=ORDERS,
           **{k: t(v) for k, v in fit.items()})
    tol, rung = interp_tol(jm, tm, 3)
    assert rung == (0 if conditioning == 'well conditioned' else 1)
    for kind in ('both', 'interp', 'trunc'):
        for kw in (dict(return_std=True), dict(return_cov=True)):
            want = jm.predict(XNEW, order=3, kind=kind, **kw)
            got = tm.predict(t(XNEW), order=3, kind=kind, **kw)
            for g, w in pairs(got, want):
                close(g, w, RTOL if kind == 'trunc' else tol)
    close(tm.predict(t(XNEW), order=3), jm.predict(XNEW, order=3), tol)
    if constrained:
        for model, x in ((jm, DX), (tm, t(DX))):
            _, std = model.predict(x, order=3, kind='trunc', return_std=True)
            assert np.all(np.asarray(std) <= 1e-7)


@pytest.mark.parametrize('name', list(PRIORS))
def test_predict_with_xc_and_y_matches_jax(name):
    """The ``Xc`` / ``y`` overrides of the conditioning set, at one θ."""
    jm, tm = at_theta(name, 0.1)
    jm.fit(X, Y, orders=ORDERS)
    tm.fit(t(X), t(Y), orders=ORDERS)
    Xc, yc = X[5:], Y[5:, 2]   # 7 points: the shapes of XNEW, compiled once
    tol, _ = interp_tol(jm, tm, 2, Xc)
    for kw in (dict(return_std=True), dict(return_cov=True)):
        want = jm.predict(XNEW, order=2, Xc=Xc, y=yc, **kw)
        got = tm.predict(t(XNEW), order=2, Xc=t(Xc), y=t(yc), **kw)
        for g, w in pairs(got, want):
            close(g, w, tol)


def test_callable_ratio_and_ref_match_jax():
    """A point-dependent ratio with a keyword (written once in ``jnp`` and
    once in torch), ``ratio_kws``, and a callable ref: mean / cov / basis,
    predictions and the lml at another keyword value."""
    for name in PRIORS:
        jm = getattr(gm, name)(jax_kernel(0.1), ratio=ratio_jax,
                               ref=lambda X: 1 + jnp.abs(X[:, 0]),
                               ratio_kws={'q': 0.45}, optimizer=None,
                               **PRIORS[name])
        tm = to_torch_model(jm, 'cpu', ratio=ratio_torch,
                            ref=lambda X: 1 + torch.abs(X[:, 0]))
        jm.fit(X, Y, orders=ORDERS)
        tm.fit(t(X), t(Y), orders=ORDERS)
        close(tm.coeffs_, jm.coeffs_, 1e-12)
        for attr in ('mean', 'cov', 'basis'):
            close(getattr(tm, attr)(t(XNEW), start=4),
                   getattr(jm, attr)(XNEW, start=4))
        tol, _ = interp_tol(jm, tm, 3)
        for g, w in pairs(tm.predict(t(XNEW), order=3, return_cov=True),
                           jm.predict(XNEW, order=3, return_cov=True)):
            close(g, w, tol)
        theta = THETA
        for g, w in zip(tm.log_marginal_likelihood(theta, True, q=0.4),
                        jm.log_marginal_likelihood(theta, True, q=0.4)):
            close(g, w)
