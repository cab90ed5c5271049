R"""One observable's truncation analysis, as the notebooks run it: build
``TruncationGP``, ``fit`` its partial sums (the coefficient process's MAP
length scale by L-BFGS-B on the host), then ``predict`` the last order plus
its truncation error (``kind='both'``) with the std at the midpoints.

Each call takes the next observable of a seeded pool.  The comparison takes
a seeded sample of the calls and recomputes, in float64 from the partial
sums, the coefficients, the lml and τ² at the returned θ, the best lml
within the bounds, and the prediction at the returned θ.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import data
from portbench.context import worst
from portbench.reference import (coefficients, lml_and_scale, maximize_lml, sqdist,
                         truncation_predict)

UNIT = 'analyses'


class Workload:
    units_per_call = 1

    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.pool = int(tr['pool'])
        self.order = int(tr['predict_order'])
        self.col = ctx.orders.index(self.order)
        obs = ctx.observables(self.pool)
        self.Y = obs.partials.to(ctx.dtype)
        self.ratio, self.ref = obs.ratio, obs.ref
        self.Xnew = torch.as_tensor(
            data.lattice(ctx.config['inputs'], midpoints=True),
            dtype=ctx.dtype, device=ctx.device)
        self.model = ctx.port().TruncationGP

    def __call__(self, i, spans):
        ctx = self.ctx
        j = i % self.pool
        t0 = time.perf_counter()
        tgp = self.model(kernel=ctx.kernel(), ratio=float(self.ratio[j]),
                         ref=float(self.ref[j]), excluded=ctx.excluded or None,
                         device=ctx.device, **ctx.prior_kwargs())
        tgp.fit(ctx.X, self.Y[j], orders=np.asarray(ctx.orders))
        ctx.synchronize()
        t1 = time.perf_counter()
        mean, std = tgp.predict(self.Xnew, order=self.order, kind='both',
                                return_std=True)
        ctx.synchronize()
        spans.setdefault('fit', []).append(t1 - t0)
        spans.setdefault('predict', []).append(time.perf_counter() - t1)
        cp = tgp.coeffs_process
        return (j, float(cp.kernel_.theta[0]),
                float(cp.log_marginal_likelihood_value_), cp.scale_ ** 2,
                cp.center_[0], float(cp.df_), mean, std)

    def warm_up(self, spans):
        self(0, spans)

    def flops_per_call(self):
        return None

    def failed(self, out):
        return int(not np.isfinite(out[2])) + int(
            (~torch.isfinite(out[7])).sum() > 0)

    def release(self):
        self.model = None

    def _coeffs(self, j):
        ctx = self.ctx
        return coefficients(self.Y[j].to(torch.float64), ctx.orders,
                            float(self.ratio[j]), float(self.ref[j]))

    def control(self, precision, calls=1):
        """The analyses made by the reference in ``precision``: its own
        maximum, then its prediction there."""
        ctx = self.ctx
        d2 = sqdist(ctx.X, ctx.X, precision)
        kept = []
        for i in range(calls):
            j = i % self.pool
            C = self._coeffs(j)[None]
            theta, _ = maximize_lml(d2, C, ctx.log_bounds, ctx.nugget,
                                    ctx.prior, precision)
            lml, scale_sq = lml_and_scale(d2, C, torch.exp(theta),
                                          ctx.nugget, ctx.prior, precision)
            N, m = C.shape[1], C.shape[2]
            df = ctx.prior.df + N * m
            mean, std = truncation_predict(
                ctx.X, self.Xnew, self.Y[j, :, self.col], torch.exp(theta),
                df * float(scale_sq[0]) / (df - 2), self.ratio[j],
                self.ref[j], self.order, ctx.excluded, ctx.prior.center,
                precision)
            kept.append((i, (j, float(theta[0]), float(lml[0]),
                             scale_sq[0].double(),
                             torch.tensor(ctx.prior.center,
                                          dtype=torch.float64), float(df),
                             mean.double(), std.double())))
        return kept

    def check(self, kept):
        ctx = self.ctx
        pick = ctx.sample(len(kept))
        d2 = sqdist(ctx.X, ctx.X)
        N, m = ctx.n_points, len(ctx.orders)
        df0 = ctx.prior.df + N * m
        rows = {k: [] for k in ('lml_gap', 'lml_shortfall', 'scale_gap',
                                'mean_gap', 'std_gap', 'state_mismatch')}
        for k in pick:
            j, theta, lml, scale_sq, center, df, mean, std = kept[k][1]
            C = self._coeffs(j)[None]
            th = torch.tensor([theta], dtype=torch.float64,
                              device=C.device)
            ref_lml, ref_scale = lml_and_scale(d2, C, torch.exp(th),
                                               ctx.nugget, ctx.prior)
            _, best = maximize_lml(d2, C, ctx.log_bounds, ctx.nugget,
                                   ctx.prior)
            best = torch.maximum(best, ref_lml)
            ref_mean, ref_std = truncation_predict(
                ctx.X, self.Xnew, self.Y[j, :, self.col], torch.exp(th),
                df0 * float(ref_scale[0]) / (df0 - 2), self.ratio[j],
                self.ref[j], self.order, ctx.excluded, ctx.prior.center)
            rows['lml_gap'].append(abs(lml - float(ref_lml[0])) / (N * m))
            rows['lml_shortfall'].append(float(best[0] - ref_lml[0])
                                         / (N * m))
            rows['scale_gap'].append(
                abs(float(scale_sq) / float(ref_scale[0]) - 1))
            rows['mean_gap'].append(worst(
                (mean.double() - ref_mean).abs() / ref_std))
            rows['std_gap'].append(worst((std.double() / ref_std - 1).abs()))
            rows['state_mismatch'].append(
                float(float(center) != ctx.prior.center) + float(df != df0))
        out = {k: worst(v) for k, v in rows.items()}
        out['state_mismatch'] = float(sum(rows['state_mismatch']))
        return out
