R"""Numerical model-checking diagnostics of Bastos & O'Hagan (counterpart of
``Diagnostic`` in ``gsum_tpu/diagnostics.py``).

Whitened errors (pointwise, Cholesky, pivoted Cholesky, eigen), the
Mahalanobis distance, the KL divergence, credible-interval coverage and the
variogram, for a reference Gaussian or Student-t (``gsum_tpu_torch.stats``)
of given mean and covariance.  Everything runs on the device of the mean and
covariance (the card for numpy inputs, unless ``device=`` says otherwise).

``GraphicalDiagnostic`` draws them (``gsum_tpu_torch.viz``, host
matplotlib) from arrays computed on the device: simulated envelopes of the
whitened errors, coverage bands, the MD² reference, and the KL of refits
through ``parallel.batched_fit``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from . import stats as gstats
from ._config import as_input, result_dtype
from .helpers import VariogramFourthRoot
from .linalg import (_T, cho_solve, cholesky, cholesky_errors, mahalanobis,
                     pivoted_cholesky, spd_logdet)
from .viz import _np

__all__ = ['Diagnostic', 'GraphicalDiagnostic']


class Diagnostic:
    R"""Numerical model-checking diagnostics for a given (mean, cov[, df]).

    Parameters
    ----------
    mean : (n_samples,) array
    cov : (n_samples, n_samples) array
    df : number, optional — a Student-t reference if given, else Gaussian
    random_state : int, optional — seeds ``samples`` (a ``torch.Generator``
        on the device; draws differ from the JAX package's at equal seeds)
    device : where numpy inputs go; tensors keep theirs (the card when None)
    """

    def __init__(self, mean, cov, df=None, random_state=1, device=None):
        dist_dev = gstats._device((mean, cov), device)
        self.mean = mean = gstats._param(mean, dist_dev)
        self.cov = cov = gstats._param(cov, dist_dev)
        self.sd = sd = torch.sqrt(torch.diag(cov))
        if df is None:
            self.dist = gstats.multivariate_normal(mean=mean, cov=cov)
            self.udist = gstats.norm(loc=mean, scale=sd)
            self.std_udist = gstats.norm(loc=0., scale=1., device=dist_dev)
        else:
            sigma = cov * (df - 2) / df
            self.dist = gstats.multivariate_t(mean=mean, sigma=sigma, df=df)
            self.udist = gstats.t(loc=mean, scale=sd, df=df)
            self.std_udist = gstats.t(loc=0., scale=1., df=df,
                                      device=dist_dev)
        self.dist.random_state = random_state
        self.udist.random_state = random_state
        self.std_udist.random_state = random_state

        self._chol = cholesky(cov)
        self._pchol, self._piv, _ = pivoted_cholesky(cov, return_pivots=True)

        e, v = torch.linalg.eigh(cov)
        # Bastos & O'Hagan order the eigenvalues from largest to smallest
        e, v = torch.flip(e, (0,)), torch.flip(v, (1,))
        self._eig_vals, self._eig_vecs = e, v
        self._eig = v @ torch.diag(torch.sqrt(e))

    def _y(self, y):
        return gstats._param(y, self.mean.device)

    def samples(self, n):
        R"""n reference draws, shape (n_samples, n)."""
        return _T(self.dist.rvs(n))

    def individual_errors(self, y):
        R"""(y - m) / σ pointwise."""
        y = self._y(y)
        return _T((_T(y) - self.mean) / torch.sqrt(torch.diag(self.cov)))

    def cholesky_errors(self, y):
        y = self._y(y)
        return _T(cholesky_errors(_T(y), self.mean, self._chol))

    def pivoted_cholesky_errors(self, y):
        # G = P L (row-permuted lower triangular), so G x = b is a
        # triangular solve of the pivot-gathered right-hand side
        y = self._y(y)
        b = _T(_T(y) - self.mean)
        L = self._pchol[self._piv]
        rhs = b[self._piv]
        if rhs.ndim == 1:
            return torch.linalg.solve_triangular(L, rhs[:, None],
                                                 upper=False)[:, 0]
        return torch.linalg.solve_triangular(L, rhs, upper=False)

    def eigen_errors(self, y):
        # E = V sqrt(e) with orthonormal V, so E⁻¹ = diag(1/sqrt(e)) Vᵀ.  A
        # 1-D y broadcasts to (n, n) against the column of scales, as in the
        # JAX package (mirrored, not repaired)
        y = self._y(y)
        b = _T(_T(y) - self.mean)
        return (self._eig_vecs.mT @ b) / torch.sqrt(self._eig_vals)[:, None]

    def chi2(self, y):
        return torch.sum(self.individual_errors(y), dim=0)

    def md_squared(self, y):
        R"""Squared Mahalanobis distance."""
        y = self._y(y)
        return mahalanobis(_T(y), self.mean, self._chol) ** 2

    def kl(self, mean, cov):
        R"""KL divergence D_KL(N(mean, cov) || N(self.mean, self.cov))."""
        c1, chol1 = self.cov, self._chol
        m0, c0 = self._y(mean), self._y(cov)
        tr = torch.trace(cho_solve(chol1, c0))
        dist = self.md_squared(m0)
        k = c1.shape[-1]
        logs = 2 * torch.sum(torch.log(torch.diag(chol1))) - spd_logdet(c0)
        return 0.5 * (tr + dist - k + logs)

    def credible_interval(self, y, intervals):
        R"""Empirical coverage of pointwise credible intervals, shape
        (n_curves, n_intervals), squeezed for a 1-D ``y``."""
        y = self._y(y)
        intervals = torch.atleast_2d(self._y(intervals)).mT
        lower, upper = self.udist.interval(intervals)

        y2 = torch.atleast_2d(_T(y))  # (n_curves, n_samples)
        # indicator: (n_curves, n_intervals, n_samples)
        ind = (lower[None, :, :] < y2[:, None, :]) \
            & (y2[:, None, :] < upper[None, :, :])
        dci = torch.mean(ind.to(lower.dtype), dim=-1)
        if y.ndim == 1:
            dci = torch.squeeze(dci)
        return dci

    @staticmethod
    def variogram(X, y, bin_bounds, device=None):
        R"""The variogram of ``y`` (``helpers.VariogramFourthRoot``): the
        object, the bins' locations, and the semivariogram with its lower
        and upper band."""
        v = VariogramFourthRoot(X, y, bin_bounds, device=device)
        gamma, lower, upper = v.compute(rt_scale=False)
        return v, v.bin_locations, gamma, lower, upper


_KL_CHUNK = 16     # draws per batched (mean, cov, KL) evaluation


class GraphicalDiagnostic:
    R"""Graphical model-checking dashboard over :class:`Diagnostic`.

    Whitened-error index plots, QQ plots with simulated envelopes, MD²
    summaries, credible-interval coverage, KL and variogram panels, and the
    ``plotzilla`` / ``essentials`` dashboards.  Every envelope is one
    batched computation over all reference draws on their device
    (``gsum_tpu_torch.viz``); drawing is a set of matplotlib primitives on
    host arrays.  The data methods (``qq_band_data``,
    ``coverage_band_data``, ``_dist_grid``, ``kl_data``,
    ``variogram_data``) need no matplotlib.

    Parameters
    ----------
    data : (n_samples,) or (n_samples, n_curves) observed curves
    mean, cov : reference-process moments at the same points
    df : number, optional — a Student-t reference process if given
    random_state : int — seeds the ``nref`` reference draws (the
        :class:`Diagnostic`'s generator; they differ from the JAX
        package's at equal seeds)
    nref : int — number of simulated reference draws for the envelopes
    colors, markers, labels, gray, black, markeredgecolors,
    markerfillstyles : style overrides (matplotlib's cycle when ``colors``
        is None, which imports matplotlib)
    device : where numpy inputs go (the card when None)
    """

    #: whitening maps: name -> Diagnostic method name
    _WHITENERS = {
        'individual': 'individual_errors',
        'cholesky': 'cholesky_errors',
        'pivoted_cholesky': 'pivoted_cholesky_errors',
        'eigen': 'eigen_errors',
    }

    def __init__(self, data, mean, cov, df=None, random_state=1, nref=1000,
                 colors=None, markers=None, labels=None, gray='lightgray',
                 black='#262626', markeredgecolors=None, markerfillstyles=None,
                 device=None):
        from . import viz

        self.diagnostic = Diagnostic(mean=mean, cov=cov, df=df,
                                     random_state=random_state, device=device)
        data = self.diagnostic._y(data)
        if data.ndim == 1:
            data = data[:, None]
        self.data = data
        self.nref = int(nref)
        self.samples = self.diagnostic.samples(self.nref)   # (N, nref)

        if labels is None:
            labels = [r'$c_{{{}}}$'.format(i) for i in range(data.shape[1])]
        self.labels = labels
        self.style = viz.PlotStyle(
            colors=colors, markers=markers, labels=labels, gray=gray,
            black=black, markeredgecolors=markeredgecolors,
            markerfillstyles=markerfillstyles)
        # style attributes kept as aliases, as in the JAX package
        self.colors = self.style.colors
        self.markers = self.style.markers
        self.gray = gray
        self.black = black

        n = int(self.diagnostic.cov.shape[-1])
        dev = self.diagnostic.mean.device
        if df is None:
            self.md_ref_dist = gstats.chi2(df=n, device=dev)
        else:
            self.md_ref_dist = gstats.f(dfn=n, dfd=df,
                                        scale=(df - 2) * n / df, device=dev)
        self._ref_err_cache = {}

    # ------------------------------------------------------------------
    # Envelope data on the device (what the panels draw)
    # ------------------------------------------------------------------
    def _whiten(self, name):
        return getattr(self.diagnostic, self._WHITENERS[name])

    def _ref_errors(self, name):
        """Whitened reference draws (N, nref), computed once per map."""
        if name not in self._ref_err_cache:
            self._ref_err_cache[name] = self._whiten(name)(self.samples)
        return self._ref_err_cache[name]

    def _qq_pipeline(self, data, whiten, ref_errors, band_perc):
        """Theoretical quantiles of the standardized reference
        distribution, per-curve order statistics of the whitened data, and
        simulated order-statistic envelopes."""
        from . import viz

        N = data.shape[0]
        probs = (np.arange(1, N + 1) - 0.5) / N
        theo_q = _np(self.diagnostic.std_udist.ppf(probs))
        sorted_data = _np(torch.sort(whiten(data), dim=0).values)
        bands = viz.sorted_sample_envelope(ref_errors, band_perc)
        return theo_q, sorted_data, bands

    def qq_band_data(self, name, band_perc=(0.68, 0.95)):
        """The arrays behind a QQ panel: theoretical quantiles of the
        standardized reference distribution, per-curve order statistics of
        the whitened data, and simulated order-statistic envelopes.

        Returns (theo_q, sorted_data, bands); bands is a list of (lo, hi)
        (N,) arrays, one pair per entry of band_perc.
        """
        return self._qq_pipeline(self.data, self._whiten(name),
                                 self._ref_errors(name), band_perc)

    def coverage_band_data(self, intervals, band_perc=(0.68, 0.95)):
        """The arrays behind the credible-interval panel: per-curve data
        coverage and simulated coverage envelopes across the draws."""
        from . import viz

        data_cov = np.atleast_2d(_np(
            self.diagnostic.credible_interval(self.data, intervals)))
        ref_cov = self.diagnostic.credible_interval(self.samples, intervals)
        bands = viz.coverage_envelope(ref_cov, band_perc)
        return data_cov, bands

    def variogram_data(self, X, n_bins=6):
        """The arrays behind the variogram panel: the bins' locations and,
        per curve, the semivariogram with its lower and upper band, each
        (n_curves, n_bins).  The estimator takes the ``n_bins - 1``
        interior boundaries of an even split of the largest lag."""
        X = _np(X)
        d = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
        bounds = np.linspace(0.0, d.max(), n_bins + 1)[1:-1]
        _, loc, gamma, lower, upper = self.diagnostic.variogram(
            X, self.data.mT, bounds, device=self.data.device)
        return (_np(loc), np.atleast_2d(_np(gamma).T),
                np.atleast_2d(_np(lower).T), np.atleast_2d(_np(upper).T))

    # ------------------------------------------------------------------
    # Error index plots and QQ plots
    # ------------------------------------------------------------------
    def error_plot(self, err, title=None, xlabel='Index', ylabel=None,
                   ax=None):
        from . import viz

        sigma = float(_np(self.diagnostic.std_udist.std()))
        return viz.draw_index_errors(err, sigma, self.style, title=title,
                                     xlabel=xlabel, ylabel=ylabel, ax=ax)

    def _errors_panel(self, name, title, ax):
        return self.error_plot(self._whiten(name)(self.data), title=title,
                               ax=ax)

    def _qq_panel(self, name, band_perc, title, ax):
        from . import viz

        theo_q, sorted_data, bands = self.qq_band_data(name, band_perc)
        return viz.draw_qq(theo_q, sorted_data, bands, self.style,
                           title=title, ax=ax)

    def individual_errors(self, title='Individual Errors', ax=None):
        return self._errors_panel('individual', title, ax)

    def cholesky_errors(self, title='Cholesky Errors', ax=None):
        return self._errors_panel('cholesky', title, ax)

    def pivoted_cholesky_errors(self, title='Pivoted Cholesky Errors',
                                ax=None):
        return self._errors_panel('pivoted_cholesky', title, ax)

    def eigen_errors(self, title='Eigen Errors', ax=None):
        return self._errors_panel('eigen', title, ax)

    def individual_errors_qq(self, title='Individual QQ Plot', ax=None):
        return self._qq_panel('individual', (0.68, 0.95), title, ax)

    def cholesky_errors_qq(self, title='Cholesky QQ Plot', ax=None):
        return self._qq_panel('cholesky', (0.68, 0.95), title, ax)

    def pivoted_cholesky_errors_qq(self, title='Pivoted Cholesky QQ Plot',
                                   ax=None):
        return self._qq_panel('pivoted_cholesky', (0.68, 0.95), title, ax)

    def eigen_errors_qq(self, title='Eigen QQ Plot', ax=None):
        return self._qq_panel('eigen', (0.68, 0.95), title, ax)

    def qq(self, data, ref, band_perc, func, title=None, ax=None):
        """QQ panel for a custom whitening map ``func`` (the named
        ``*_qq`` methods cover the standard maps)."""
        from . import viz

        data = self.diagnostic._y(data)
        theo_q, sorted_data, bands = self._qq_pipeline(
            data, func, func(self.diagnostic._y(ref)), band_perc)
        return viz.draw_qq(theo_q, sorted_data, bands, self.style,
                           title=title, ax=ax)

    # ------------------------------------------------------------------
    # Distribution summaries (hist / box / violin)
    # ------------------------------------------------------------------
    def _dist_grid(self, dist, n=200, tail=2e-3):
        lo = float(_np(dist.ppf(tail)))
        hi = float(_np(dist.ppf(1.0 - tail)))
        xs = np.linspace(lo, hi, n)
        return xs, _np(dist.pdf(xs))

    def hist(self, data, ref, title=None, xlabel=None, ylabel=None,
             vlines=True, ax=None):
        """Observed statistics against a reference distribution (an object
        with ppf / pdf) or a set of reference samples (an array)."""
        from . import viz

        if hasattr(ref, 'ppf'):
            xs, pdf = self._dist_grid(ref)
            two_sigma = (float(_np(ref.ppf(0.025))),
                         float(_np(ref.ppf(0.975))))
            ax = viz.draw_pdf_reference(
                xs, pdf, data, self.style, labels=self.labels, title=title,
                xlabel=xlabel, two_sigma=two_sigma, vlines=vlines, ax=ax)
        else:
            import matplotlib.pyplot as plt

            if ax is None:
                ax = plt.gca()
            ref = _np(ref).ravel()
            m, sd = float(ref.mean()), float(ref.std(ddof=1))
            ax.hist(ref, density=True, histtype='step', color=self.black,
                    label='ref')
            for v in (m - 2 * sd, m + 2 * sd):
                ax.axvline(v, color='gray', ls='--', lw=1)
            if vlines:
                for i, v in enumerate(np.atleast_1d(_np(data))):
                    ax.axvline(float(v), zorder=10,
                               color=self.colors[i % len(self.colors)])
            else:
                ax.hist(_np(data), density=True, histtype='step',
                        label='data')
            ax.legend(fontsize='small')
            if title:
                ax.set_title(title)
            if xlabel:
                ax.set_xlabel(xlabel)
        if ylabel:
            ax.set_ylabel(ylabel)
        return ax

    def box(self, data, ref, title=None, xlabel=None, ylabel=None,
            trim=True, size=8, legend=False, ax=None):
        # ``size`` / ``legend`` are accepted for API parity; the box
        # renderer has no marker sizing or legend content
        del size, legend
        from . import viz

        if hasattr(ref, 'ppf'):
            ppf = ref.ppf
        else:
            arr = _np(ref).ravel()
            ppf = lambda q: np.quantile(arr, q)   # noqa: E731
        ax = viz.draw_dist_box(ppf, data, self.style, title=title, ax=ax)
        if xlabel:
            ax.set_xlabel(xlabel)
        if ylabel:
            ax.set_ylabel(ylabel)
        return ax

    def violin(self, data, ref, title=None, xlabel=None, ylabel=None,
               ax=None):
        from . import viz

        if hasattr(ref, 'pdf'):
            xs, pdf = self._dist_grid(ref)
        else:
            arr = _np(ref).ravel()
            xs = np.linspace(arr.min(), arr.max(), 100)
            h = max(arr.std(ddof=1) * arr.size ** (-0.2), 1e-12)
            pdf = np.exp(-0.5 * ((xs[:, None] - arr[None]) / h) ** 2
                         ).sum(axis=1) / (arr.size * h * np.sqrt(2 * np.pi))
        ax = viz.draw_dist_violin(xs, pdf, data, self.style, title=title,
                                  ax=ax)
        if xlabel:
            ax.set_xlabel(xlabel)
        if ylabel:
            ax.set_ylabel(ylabel)
        return ax

    # ------------------------------------------------------------------
    # Named diagnostics
    # ------------------------------------------------------------------
    def md_squared(self, ax=None, type='hist',
                   title='Mahalanobis Distance', **kwargs):
        """Squared Mahalanobis distance of each curve against its reference
        distribution (χ²(n), or a scaled F for the Student-t process)."""
        md = np.atleast_1d(_np(self.diagnostic.md_squared(self.data)))
        renderer = {'hist': self.hist, 'box': self.box,
                    'violin': self.violin}[type]
        return renderer(md, self.md_ref_dist, title=title, ax=ax, **kwargs)

    def kl(self, X, gp, predict=False, vlines=True, title='KL Divergence',
           ax=None, engine='auto', fit_kws=None):
        """Where the data's KL falls among the reference draws': the GP is
        refit to every reference draw and to each data curve, and each
        fit's (mean, cov) at X is compared to the diagnostic's by KL.

        ``engine``:

        - 'batched' — all refits as one lockstep batched fit on the device
          (``parallel.batched_fit``) and all KLs in batched calls; needs a
          plain ``ConjugateGaussianProcess`` with the default constant
          basis and the Cholesky decomposition;
        - 'loop' — one ``gp.fit`` per draw (any process type);
        - 'auto' — 'batched' whenever the gp qualifies.

        ``fit_kws`` go to ``parallel.batched_fit`` (``chunk=``,
        ``maxiter=``, ``engine=`` for the lml engine, ``precision=``).
        """
        data_kls, ref_kls = self.kl_data(X, gp, predict=predict,
                                         engine=engine, fit_kws=fit_kws)
        return self.hist(data_kls, ref_kls, title=title, vlines=vlines,
                         ax=ax)

    def kl_data(self, X, gp, predict=False, engine='auto', fit_kws=None):
        """The numbers behind :meth:`kl`: ``(data_kls, ref_kls)`` numpy
        arrays.  See :meth:`kl` for ``engine``."""
        n_ref = self.samples.shape[1]
        n_data = self.data.shape[1]

        if engine not in ('auto', 'batched', 'loop'):
            raise ValueError("engine must be 'auto', 'batched', or 'loop'")
        use_batched = engine == 'batched' or (
            engine == 'auto' and self._kl_batchable(gp))
        if engine == 'batched' and not self._kl_batchable(gp):
            raise ValueError('engine="batched" needs a plain '
                             'ConjugateGaussianProcess with the default '
                             'constant basis and cholesky decomposition')

        if use_batched:
            Y_all = torch.cat([self.samples, self.data], dim=1).mT
            kls = _np(self._kl_batched(X, gp, Y_all, predict, fit_kws or {}))
            ref_kls, data_kls = kls[:n_ref], kls[n_ref:]
        else:
            X = as_input(X, device=self.data.device)

            def fit_kl(y):
                g = gp.fit(X, y)
                if predict:
                    m, c = g.predict(X, return_cov=True)
                else:
                    m, c = g.mean(X), g.cov(X)
                return float(self.diagnostic.kl(m, c))

            ref_kls = np.asarray([fit_kl(self.samples[:, i])
                                  for i in range(n_ref)])
            data_kls = np.asarray([fit_kl(self.data[:, i])
                                   for i in range(n_data)])
        return data_kls, ref_kls

    @staticmethod
    def _kl_batchable(gp):
        from .models import ConjugateGaussianProcess, _default_basis

        return (type(gp) is ConjugateGaussianProcess
                and gp.basis is _default_basis
                and gp.decomposition == 'cholesky')

    def _kl_batched(self, X, gp, Y_all, predict, fit_kws):
        """KL on the device: one lockstep batched MAP fit of every curve
        (or, when no θ is optimized, one shared factorization and the
        conjugate updates vmapped over the curves), then the (mean, cov,
        KL) evaluations batched over the draws, ``_KL_CHUNK`` at a time."""
        from . import conjugate as _conj
        from .parallel.batched import batched_fit

        kernel = gp.kernel if gp.kernel is not None else gp._default_kernel
        frozen = kernel.clone()
        diag = self.diagnostic
        # numpy X keeps its dtype (an f32 X makes f32 fits, as in JAX)
        Xj = torch.atleast_2d(as_input(X, device=Y_all.device))
        B = Y_all.shape[0]

        if gp.optimizer is not None and int(np.asarray(kernel.theta).size):
            seed = gp.random_state if isinstance(gp.random_state,
                                                 (int, np.integer)) else 0
            kws = dict(center=gp.center0, disp=gp.disp0, df=gp.df0,
                       scale=gp.scale0, nugget=gp.nugget,
                       n_restarts=gp.n_restarts_optimizer, seed=int(seed))
            kws.update(fit_kws)
            post = batched_fit(kernel, Xj, Y_all, **kws)
            thetas, centers = post.theta, post.center
            cov_factors, chols = post.cov_factor, post.chol
            Xj = Xj.to(chols.dtype)
        else:
            # nothing is optimized (a fixed kernel, or optimizer=None): the
            # correlation matrix is shared, so factor once and vmap the
            # closed-form conjugate update over the curves
            Y_all = Y_all.to(result_dtype(Xj.dtype))
            theta0 = torch.as_tensor(kernel.theta, dtype=Xj.dtype,
                                     device=Xj.device)
            R0 = frozen.value_fn(theta0, Xj, None)
            L0 = cholesky(R0 + gp.nugget * torch.eye(
                Xj.shape[0], dtype=R0.dtype, device=R0.device))
            basis1 = torch.ones((Xj.shape[0], 1), dtype=R0.dtype,
                                device=R0.device)
            c0, V0, df0, scale0 = gp.center0, gp.disp0, gp.df0, gp.scale0

            def upd(y2):
                c = _conj.compute_center(y2, L0, basis1, c0, V0)
                s2 = _conj.compute_scale_sq(y2, L0, basis1, c0, V0, df0,
                                            scale0)
                df = _conj.compute_df(y2, df0)
                return c, _conj.compute_cov_factor(s2, df)

            centers, cov_factors = vmap(upd)(Y_all[:, :, None])
            # every draw shares the unoptimized θ, which need not be empty
            thetas = theta0.expand((B,) + theta0.shape)
            chols = L0.expand((B,) + L0.shape)

        def one(theta, center, cov_factor, chol, y):
            R = frozen.value_fn(theta, Xj, None)
            # the constant basis (_kl_batchable): mean = 1 · center
            mean = torch.ones((Xj.shape[0],), dtype=R.dtype,
                              device=R.device) * torch.squeeze(center)
            if predict:
                # conditioned at the training points themselves
                alpha = cho_solve(chol, y[:, None].to(R.dtype)
                                  - mean[:, None])
                m_pred = mean + torch.squeeze(R @ alpha, -1)
                R_pred = R - R @ cho_solve(chol, R)
                return diag.kl(m_pred, cov_factor * R_pred)
            return diag.kl(mean, cov_factor * R)

        fn = vmap(one)
        return torch.cat([
            fn(thetas[i:i + _KL_CHUNK], centers[i:i + _KL_CHUNK],
               cov_factors[i:i + _KL_CHUNK], chols[i:i + _KL_CHUNK],
               Y_all[i:i + _KL_CHUNK])
            for i in range(0, B, _KL_CHUNK)])

    def credible_interval(self, intervals, band_perc, ax=None,
                          title='Credible Interval Diagnostic',
                          xlabel='Credible Interval',
                          ylabel='Empirical Coverage', linestyles=None):
        from . import viz

        intervals = np.atleast_1d(np.asarray(intervals, dtype=float))
        data_cov, bands = self.coverage_band_data(intervals, band_perc)
        return viz.draw_coverage(intervals, data_cov, bands, self.style,
                                 title=title, ax=ax, xlabel=xlabel,
                                 ylabel=ylabel, linestyles=linestyles)

    def variogram(self, X, title='Variogram', xlabel='Lag', ax=None,
                  n_bins=6):
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        loc, gamma, lower, upper = self.variogram_data(X, n_bins)
        for i in range(gamma.shape[0]):
            c = self.style.curve(i)
            ax.plot(loc, gamma[i], color=c['color'], marker=c['marker'],
                    ls='-')
            ax.fill_between(loc, lower[i], upper[i], facecolor=c['color'],
                            alpha=0.2, lw=0)
        ax.set_xlabel(xlabel)
        if title:
            ax.set_title(title)
        return ax

    # ------------------------------------------------------------------
    # Dashboards
    # ------------------------------------------------------------------
    def plotzilla(self, X, gp=None, predict=False, vlines=True):
        """Everything at once: the four error maps and their QQ panels,
        MD², credible-interval coverage, variogram, and (given a gp) KL."""
        from . import viz

        panels = [
            lambda ax: self.individual_errors(ax=ax),
            lambda ax: self.cholesky_errors(ax=ax),
            lambda ax: self.pivoted_cholesky_errors(ax=ax),
            lambda ax: self.eigen_errors(ax=ax),
            lambda ax: self.individual_errors_qq(ax=ax),
            lambda ax: self.cholesky_errors_qq(ax=ax),
            lambda ax: self.pivoted_cholesky_errors_qq(ax=ax),
            lambda ax: self.eigen_errors_qq(ax=ax),
            lambda ax: self.md_squared(ax=ax, vlines=vlines),
            lambda ax: self.credible_interval(
                np.linspace(0.001, 0.999, 50), (0.68, 0.95), ax=ax),
            lambda ax: self.variogram(X, ax=ax),
        ]
        if gp is not None:
            panels.append(lambda ax: self.kl(X, gp, predict=predict,
                                             vlines=vlines, ax=ax))
        fig, axes = viz.grid_figure(len(panels), ncols=4)
        for panel, ax in zip(panels, axes.flat):
            panel(ax)
        return fig, axes

    def essentials(self, vlines=True, bare=False):
        """The short dashboard: Cholesky error index plot, MD², and
        credible-interval coverage."""
        from . import viz

        fig, axes = viz.grid_figure(3, ncols=3)
        self.cholesky_errors(ax=axes.flat[0],
                             title=None if bare else 'Cholesky Errors')
        self.md_squared(ax=axes.flat[1], vlines=vlines,
                        title=None if bare else 'Mahalanobis Distance')
        self.credible_interval(
            np.linspace(0.001, 0.999, 50), (0.68, 0.95), ax=axes.flat[2],
            title=None if bare else 'Credible Interval Diagnostic')
        if bare:
            for ax in axes.flat:
                leg = ax.get_legend()
                if leg is not None:
                    leg.remove()
        return fig, axes
