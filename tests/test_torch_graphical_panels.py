"""The panels and dashboards of the port's ``GraphicalDiagnostic`` against
``gsum_tpu``'s, drawn with matplotlib's Agg backend: each Axes' line data
(index plots, QQ points and diagonals, the MD² reference curve and the
data's lines, coverage curves, variogram curves, box and violin markers)
against JAX's figure, with JAX's reference draws put into the port's
object.

A Gaussian reference (the Student-t data methods are in
``tests/test_torch_graphical.py``), N=24 points, 3 curves, nref=48.  Lines
are held to 1e-11 relative: whitened errors to ``10·cond·EPS`` (2e-12) as
there, and the MD² reference's χ² quantiles, on which the pdf grid rests,
to about 1e-12 (``torch.special.gammainc`` against JAX's,
``tests/test_torch_special.py``).
"""
import matplotlib
from _port import one_intra_op_thread  # noqa: F401 (autouse)

matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import gsum_tpu as gm  # noqa: E402
import gsum_tpu_torch as gt  # noqa: E402

rng = np.random.RandomState(3)
N, NREF = 24, 48
X = np.sort(rng.rand(N))[:, None]
MEAN = np.sin(4 * X[:, 0])
_Q = np.linalg.qr(rng.randn(N, N))[0]
COV = (_Q * np.geomspace(1.0, 1e-3, N)) @ _Q.T
Y = MEAN[:, None] + np.linalg.cholesky(COV) @ rng.randn(N, 3)
COLORS = ['C0', 'C1', 'C2']


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _pair():
    jg = gm.GraphicalDiagnostic(Y, MEAN, COV, nref=NREF, colors=COLORS)
    tg = gt.GraphicalDiagnostic(torch.from_numpy(Y), torch.from_numpy(MEAN),
                                torch.from_numpy(COV), nref=NREF,
                                colors=COLORS)
    tg.samples = torch.from_numpy(np.array(jg.samples))
    tg._ref_err_cache = {}
    # align each eigenvector's sign to JAX's (a sign is LAPACK's choice)
    d = tg.diagnostic
    signs = np.sign(np.sum(np.asarray(jg.diagnostic._eig_vecs)
                           * d._eig_vecs.numpy(), axis=0))
    d._eig_vecs = d._eig_vecs * torch.from_numpy(signs)
    return jg, tg


def _lines(fig):
    return [[np.column_stack(line.get_data()).astype(float)
             for line in ax.get_lines()] for ax in fig.axes]


def _same_figures(fig, fig_j, rtol):
    got, want = _lines(fig), _lines(fig_j)
    assert [len(a) for a in got] == [len(a) for a in want]
    for ax, ax_j in zip(got, want):
        for line, line_j in zip(ax, ax_j):
            _close(line, line_j, rtol)


def test_panels_and_dashboards_match_jax():
    """Every panel of ``plotzilla`` (without KL) and ``essentials``, and
    ``md_squared`` as box and violin: each Axes' line data against JAX's
    figure."""
    jg, tg = _pair()
    try:
        for dash in ('plotzilla', 'essentials'):
            args = (X,) if dash == 'plotzilla' else ()
            fig, _ = getattr(tg, dash)(*args)
            fig_j, _ = getattr(jg, dash)(*args)
            _same_figures(fig, fig_j, 1e-11)
            plt.close('all')
        for kind in ('box', 'violin'):
            fig, ax = plt.subplots(1, 2)
            tg.md_squared(ax=ax[0], type=kind)
            jg.md_squared(ax=ax[1], type=kind)
            got, want = _lines(fig)
            for line, line_j in zip(got, want):
                _close(line, line_j, 1e-11)
            plt.close('all')
    finally:
        plt.close('all')
