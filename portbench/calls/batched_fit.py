R"""``parallel.batched_fit``: MAP fits of many observables' coefficient
processes in one call.

Each call fits ``observables_per_call`` observables, each its orders'
coefficient curves on the configuration's points, from the kernel's start.
The answers are one (θ, lml, τ², η, ν) per fit.  The comparison takes a
seeded sample of every fit the window returned and recomputes, in float64,
the lml and τ² at the returned θ and the best lml within the bounds.
"""
from __future__ import annotations

import torch

from portbench import counts
from portbench.context import worst
from portbench.reference import lml_and_scale, maximize_lml, sqdist

UNIT = 'fits'


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.per_call = int(tr['observables_per_call'])
        self.pool_calls = int(tr['pool_calls'])
        obs = ctx.observables(self.per_call * self.pool_calls)
        N, m = ctx.n_points, len(ctx.orders)
        self.Y = obs.coeffs.to(ctx.dtype).reshape(
            self.pool_calls, self.per_call, N, m)
        self.kw = dict(ctx.prior_kwargs(), maxiter=int(tr['maxiter']),
                       ls_steps=int(tr['ls_steps']), chunk=int(tr['chunk']),
                       engine=tr['engine'],
                       precision={torch.float32: 'f32',
                                  torch.float64: 'f64'}[ctx.dtype])
        self.kernel = ctx.kernel()
        self.fit = ctx.port().parallel.batched_fit
        # a trip too short to converge every fit ('median') is judged by
        # its median fit, the others by their worst
        if tr.get('shortfall', 'worst') == 'median':
            self.shortfall_name = 'lml_shortfall_median'
            self.shortfall_of = lambda x: float(
                torch.nan_to_num(x, nan=torch.inf).median())
        else:
            self.shortfall_name, self.shortfall_of = 'lml_shortfall', worst

    units_per_call = property(lambda self: self.per_call)

    def __call__(self, i, spans):
        p = i % self.pool_calls
        post = self.fit(self.kernel, self.ctx.X, self.Y[p], **self.kw)
        return (p, post.theta[:, 0], post.lml, post.scale_sq,
                post.center[:, 0], post.df)

    def warm_up(self, spans):
        self(0, spans)

    def flops_per_call(self):
        kw, ctx = self.kw, self.ctx
        return self.per_call * counts.flops_fixed_trip_fit(
            ctx.n_points, len(ctx.orders), 1, kw['maxiter'], kw['ls_steps'])

    def failed(self, out):
        return int((~torch.isfinite(out[2])).sum())

    def release(self):
        self.kernel = self.fit = None

    def control(self, precision, calls=1):
        """What the window would keep had the reference, in ``precision``,
        made the fits: its own maximum, lml and τ² per fit."""
        ctx = self.ctx
        d2 = sqdist(ctx.X, ctx.X, precision)
        kept = []
        for i in range(calls):
            p = i % self.pool_calls
            Y = self.Y[p]
            theta, _ = maximize_lml(d2, Y, ctx.log_bounds, ctx.nugget,
                                    ctx.prior, precision)
            lml, scale_sq = lml_and_scale(d2, Y, torch.exp(theta),
                                          ctx.nugget, ctx.prior, precision)
            n = len(theta)
            df = ctx.prior.df + Y.shape[1] * Y.shape[2]
            kept.append((i, (p, theta, lml.double(), scale_sq.double(),
                             torch.full((n,), ctx.prior.center,
                                        dtype=torch.float64,
                                        device=theta.device),
                             torch.full((n,), float(df), dtype=torch.float64,
                                        device=theta.device))))
        return kept

    def check(self, kept):
        ctx = self.ctx
        fields = list(zip(*[out for _, out in kept]))
        pools = torch.as_tensor(fields[0]).repeat_interleave(self.per_call)
        within = torch.arange(self.per_call).repeat(len(kept))
        theta, lml, scale_sq, center, df = (
            torch.cat([t.to(torch.float64).reshape(-1) for t in col])
            for col in fields[1:])
        pick = torch.as_tensor(ctx.sample(len(theta)))
        Y = self.Y[pools[pick], within[pick]].to(torch.float64)
        dev = Y.device
        theta, lml, scale_sq, center, df = (
            t.to(dev)[pick.to(dev)] for t in (theta, lml, scale_sq, center,
                                              df))
        N, m = Y.shape[1], Y.shape[2]
        d2 = sqdist(ctx.X, ctx.X)
        ref_lml, ref_scale = lml_and_scale(d2, Y, torch.exp(theta),
                                           ctx.nugget, ctx.prior)
        _, best = maximize_lml(d2, Y, ctx.log_bounds, ctx.nugget, ctx.prior)
        best = torch.maximum(best, ref_lml)
        shortfall = (best - ref_lml) / (N * m)
        mismatch = ((center != ctx.prior.center).sum()
                    + (df != ctx.prior.df + N * m).sum())
        return {
            'lml_gap': worst((lml - ref_lml).abs() / (N * m)),
            self.shortfall_name: self.shortfall_of(shortfall),
            'scale_gap': worst((scale_sq / ref_scale - 1).abs()),
            'state_mismatch': float(mismatch),
        }
