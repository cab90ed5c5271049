R"""Rendering engine for the graphical model-checking diagnostics
(counterpart of ``gsum_tpu/viz.py``).

- Every band, envelope and order statistic is one batched computation on
  the device of the reference draws: ``torch.sort`` along the sample axis,
  and each band's quantiles read from the sorted tensor by index with
  linear interpolation (numpy's and JAX's ``'linear'`` rule).
  ``torch.quantile`` is not used: it refuses inputs above 2²⁴ elements.
- The rendering primitives are small matplotlib functions on plain arrays
  (box and violin summaries drawn from quantiles with ``Axes.bxp`` /
  ``fill_between``), with no pandas or seaborn.

matplotlib is imported only inside the functions that draw, and by
:class:`PlotStyle` only when it is given no ``colors``: the data methods of
``diagnostics.GraphicalDiagnostic`` need no matplotlib, so a machine without
it computes the arrays and another draws them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ._config import as_input

__all__ = [
    'PlotStyle', 'band_probs_to_quantiles', 'sorted_sample_envelope',
    'coverage_envelope', 'draw_index_errors', 'draw_qq', 'draw_pdf_reference', 'draw_dist_box',
    'draw_dist_violin', 'draw_coverage', 'grid_figure',
]


# ----------------------------------------------------------------------
# Style configuration
# ----------------------------------------------------------------------
@dataclass
class PlotStyle:
    """Per-curve marker/color configuration shared by every panel."""
    colors: Sequence[Any] = None
    markers: Sequence[str] = None
    markeredgecolors: Sequence[Any] = None
    markerfillstyles: Sequence[str] = None
    labels: Sequence[str] = None
    gray: str = 'lightgray'
    black: str = '#262626'

    def __post_init__(self):
        if self.colors is None:
            import matplotlib as mpl
            self.colors = [p['color'] for p in mpl.rcParams['axes.prop_cycle']]
        n = len(self.colors)
        if self.markers is None:
            self.markers = ['o'] * n
        if self.markeredgecolors is None:
            self.markeredgecolors = [None] * n
        if self.markerfillstyles is None:
            self.markerfillstyles = ['full'] * n

    def curve(self, i):
        """Marker kwargs for curve i (cycling past the palette length)."""
        n = len(self.colors)
        return dict(
            color=self.colors[i % n],
            marker=self.markers[i % len(self.markers)],
            markeredgecolor=self.markeredgecolors[i % len(self.markeredgecolors)],
            fillstyle=self.markerfillstyles[i % len(self.markerfillstyles)],
        )


# ----------------------------------------------------------------------
# Device-side envelope computations
# ----------------------------------------------------------------------
def band_probs_to_quantiles(band_perc):
    """[0.68, 0.95] -> [(0.16, 0.84), (0.025, 0.975)] central quantile pairs."""
    out = []
    for p in np.atleast_1d(np.asarray(band_perc, dtype=float)):
        out.append(((1.0 - p) / 2.0, (1.0 + p) / 2.0))
    return out


def _np(a):
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _sorted_quantile(s, q, dim):
    """The ``q`` quantile along ``dim`` of ``s``, already sorted along it:
    numpy's 'linear' rule, position q·(n − 1) between its two neighbours."""
    n = s.shape[dim]
    pos = q * (n - 1)
    lo = min(int(np.floor(pos)), n - 1)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    a, b = s.select(dim, lo), s.select(dim, hi)
    return a + (b - a) * frac


def sorted_sample_envelope(ref_errors, band_perc):
    """Order-statistic envelope of whitened reference draws.

    Parameters
    ----------
    ref_errors : (N, nref) whitened reference samples (a tensor stays on
        its device)
    band_perc : central band probabilities, e.g. [0.68, 0.95]

    Returns
    -------
    list of (lo, hi) pairs of (N,) numpy arrays: for each band, the
    quantiles of the i-th order statistic across the draws.
    """
    s = torch.sort(as_input(ref_errors), dim=0).values   # within each draw
    s = torch.sort(s, dim=1).values                       # across the draws
    bands = []
    for qlo, qhi in band_probs_to_quantiles(band_perc):
        bands.append((_np(_sorted_quantile(s, qlo, 1)),
                      _np(_sorted_quantile(s, qhi, 1))))
    return bands


def coverage_envelope(ref_coverage, band_perc):
    """Envelope of empirical interval coverage across reference draws.

    ref_coverage : (nref, n_intervals) coverages
    Returns list of (lo, hi) pairs of (n_intervals,) numpy arrays.
    """
    c = torch.sort(as_input(ref_coverage), dim=0).values
    return [(_np(_sorted_quantile(c, qlo, 0)), _np(_sorted_quantile(c, qhi, 0)))
            for qlo, qhi in band_probs_to_quantiles(band_perc)]


# ----------------------------------------------------------------------
# Rendering primitives (host matplotlib, plain-array inputs)
# ----------------------------------------------------------------------
def _get_ax(ax):
    if ax is None:
        import matplotlib.pyplot as plt
        ax = plt.gca()
    return ax


def draw_index_errors(errors, sigma, style, title=None, xlabel='Index',
                      ylabel=None, ax=None, markersize=8):
    """Whitened errors against sample index, with 0 and ±2σ guide lines."""
    from matplotlib.ticker import MaxNLocator

    ax = _get_ax(ax)
    errors = np.atleast_2d(_np(errors).T).T   # (N, n_curves)
    idx = np.arange(1, errors.shape[0] + 1)
    ax.axhline(0.0, color=style.black, lw=1, zorder=0)
    for guide in (-2.0 * sigma, 2.0 * sigma):
        ax.axhline(guide, color=style.gray, lw=1, zorder=0)
    for i in range(errors.shape[1]):
        ax.plot(idx, errors[:, i], ls='', markersize=markersize,
                markeredgewidth=0.5, **style.curve(i))
    ax.xaxis.set_major_locator(MaxNLocator(integer=True))
    ax.margins(x=0.05)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    return ax


def draw_qq(theo_q, sorted_data, bands, style, title=None, ax=None,
            band_alpha_start=0.35):
    """QQ plot: order statistics of whitened data vs theoretical quantiles,
    with simulated order-statistic envelopes behind and the y=x line."""
    ax = _get_ax(ax)
    theo_q = _np(theo_q)
    sorted_data = np.atleast_2d(_np(sorted_data).T).T

    # widest band first so narrower bands draw on top
    order = np.argsort([hi[-1] - lo[-1] for lo, hi in bands])[::-1]
    for rank, b in enumerate(order):
        lo, hi = bands[b]
        alpha = band_alpha_start + 0.2 * rank
        ax.fill_between(theo_q, lo, hi, facecolor=style.gray,
                        alpha=min(alpha, 0.9), lw=0, zorder=0)
    lim = (float(theo_q[0]), float(theo_q[-1]))
    ax.plot(lim, lim, color=style.black, lw=1, zorder=1)
    for i in range(sorted_data.shape[1]):
        ax.plot(theo_q, sorted_data[:, i], ls='', markersize=6,
                markeredgewidth=0.5, zorder=2, **style.curve(i))
    ax.set_xlim(lim)
    if title:
        ax.set_title(title)
    return ax


def draw_pdf_reference(xs, pdf, data_values, style, labels=None, title=None,
                       xlabel=None, two_sigma=None, vlines=True, ax=None):
    """Reference pdf curve with the observed statistics as vertical lines
    (or a step histogram when vlines=False), plus optional 2σ guides."""
    ax = _get_ax(ax)
    ax.plot(_np(xs), _np(pdf), color=style.black, label='ref')
    if two_sigma is not None:
        for v in two_sigma:
            ax.axvline(float(v), color='gray', ls='--', lw=1)
    data_values = np.atleast_1d(_np(data_values))
    if vlines:
        for i, v in enumerate(data_values):
            lbl = labels[i] if labels is not None else None
            ax.axvline(float(v), color=style.colors[i % len(style.colors)],
                       zorder=10, label=lbl)
    else:
        ax.hist(data_values, density=True, histtype='step', label='data')
    ax.legend(fontsize='small')
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    return ax


def draw_dist_box(ppf, data_values, style, title=None, ax=None,
                  whis=(0.025, 0.975), box=(0.25, 0.75)):
    """Horizontal box summary of a *distribution* (from its quantile
    function) with the observed statistics overplotted as markers."""
    ax = _get_ax(ax)
    stats = {
        'med': float(_np(ppf(0.5))),
        'q1': float(_np(ppf(box[0]))),
        'q3': float(_np(ppf(box[1]))),
        'whislo': float(_np(ppf(whis[0]))),
        'whishi': float(_np(ppf(whis[1]))),
        'fliers': [],
    }
    ax.bxp([stats], positions=[0], vert=False, showfliers=False,
           boxprops=dict(color=style.black),
           whiskerprops=dict(color=style.black),
           medianprops=dict(color=style.black))
    data_values = np.atleast_1d(_np(data_values))
    for i, v in enumerate(data_values):
        ax.plot(float(v), 0.0, ls='', markersize=9, zorder=10,
                **style.curve(i))
    ax.set_yticks([])
    ax.margins(y=0.4)
    if title:
        ax.set_title(title)
    return ax


def draw_dist_violin(xs, pdf, data_values, style, title=None, ax=None,
                     width=0.45):
    """Horizontal violin silhouette of a distribution's pdf with observed
    statistics overplotted — drawn directly with fill_between."""
    ax = _get_ax(ax)
    xs = _np(xs)
    pdf = _np(pdf)
    h = width * pdf / pdf.max()
    ax.fill_between(xs, -h, h, facecolor=style.gray, edgecolor=style.black,
                    lw=0.8)
    data_values = np.atleast_1d(_np(data_values))
    for i, v in enumerate(data_values):
        ax.plot(float(v), 0.0, ls='', markersize=9, zorder=10,
                **style.curve(i))
    ax.set_yticks([])
    ax.margins(y=0.3)
    if title:
        ax.set_title(title)
    return ax


def draw_coverage(intervals, data_coverage, bands, style, title=None,
                  ax=None, xlabel='Credible interval',
                  ylabel='Empirical coverage', linestyles=None):
    """Empirical vs nominal credible-interval coverage with simulated
    envelopes and the ideal diagonal."""
    ax = _get_ax(ax)
    intervals = _np(intervals)
    data_coverage = np.atleast_2d(_np(data_coverage))
    order = np.argsort([np.mean(hi - lo) for lo, hi in bands])[::-1]
    for rank, b in enumerate(order):
        lo, hi = bands[b]
        ax.fill_between(intervals, lo, hi, facecolor=style.gray,
                        alpha=min(0.35 + 0.2 * rank, 0.9), lw=0, zorder=0)
    ax.plot([0, 1], [0, 1], color=style.black, lw=1, zorder=1)
    for i in range(data_coverage.shape[0]):
        c = style.curve(i)
        ls = None if linestyles is None else linestyles[i]
        ax.plot(intervals, data_coverage[i], color=c['color'], ls=ls,
                zorder=2)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    return ax


def grid_figure(n_panels, ncols, panel_size=(3.2, 3.0)):
    """A figure with ceil(n/ncols) x ncols axes; extras are hidden."""
    import matplotlib.pyplot as plt

    nrows = -(-n_panels // ncols)
    fig, axes = plt.subplots(
        nrows, ncols,
        figsize=(panel_size[0] * ncols, panel_size[1] * nrows),
        constrained_layout=True, squeeze=False)
    for k in range(n_panels, nrows * ncols):
        axes.flat[k].set_visible(False)
    return fig, axes
