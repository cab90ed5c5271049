R"""Numerical model-checking diagnostics of Bastos & O'Hagan (counterpart of
``Diagnostic`` in ``gsum_tpu/diagnostics.py``).

Whitened errors (pointwise, Cholesky, pivoted Cholesky, eigen), the
Mahalanobis distance, the KL divergence, credible-interval coverage and the
variogram, for a reference Gaussian or Student-t (``gsum_tpu_torch.stats``)
of given mean and covariance.  Everything runs on the device of the mean and
covariance (the card for numpy inputs, unless ``device=`` says otherwise).

Not ported yet: ``GraphicalDiagnostic``, the plotting half, whose KL refits
through ``parallel.batched_fit`` (ROADMAP.md queue A).
"""
from __future__ import annotations

import torch

from . import stats as gstats
from .helpers import VariogramFourthRoot
from .linalg import (_T, cho_solve, cholesky, cholesky_errors, mahalanobis,
                     pivoted_cholesky, spd_logdet)

__all__ = ['Diagnostic']


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
