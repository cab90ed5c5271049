R"""``parallel.truncation_lml_grid``: the joint (length scale, ratio)
log-likelihood surface of one observable's partial sums, change of
variables included, as the publication's (Q, ℓ) posterior needs it.

Each call takes the next observable of a seeded pool and the mix's grids.
The comparison takes a seeded sample of the surfaces and recomputes each
in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import counts
from portbench.context import worst
from portbench.reference import sqdist, truncation_lml_surface

UNIT = 'evals'


def _axis(spec):
    lo, hi, n = float(spec['low']), float(spec['high']), int(spec['count'])
    if spec.get('spacing') == 'log':
        return np.geomspace(lo, hi, n)
    return np.linspace(lo, hi, n)


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.pool = int(tr['pool'])
        obs = ctx.observables(self.pool)
        self.Y = obs.partials.to(ctx.dtype)
        self.ref = obs.ref
        self.ls = torch.as_tensor(_axis(tr['length_scales']),
                                  dtype=torch.float64, device=ctx.device)
        self.ratios = torch.as_tensor(_axis(tr['ratios']), dtype=ctx.dtype,
                                      device=ctx.device)
        self.thetas = torch.log(self.ls)[:, None].to(ctx.dtype)
        self.kernel = ctx.kernel()
        self.grid = ctx.port().parallel.truncation_lml_grid

    units_per_call = property(lambda self: self.ls.numel()
                              * self.ratios.numel())

    def __call__(self, i, spans):
        ctx = self.ctx
        j = i % self.pool
        surf = self.grid(self.kernel, ctx.X, self.Y[j],
                         np.asarray(ctx.orders), self.ratios, self.thetas,
                         ref=float(self.ref[j]),
                         excluded=ctx.excluded or None,
                         **ctx.prior_kwargs())
        return j, surf

    def warm_up(self, spans):
        self(0, spans)

    def flops_per_call(self):
        ctx = self.ctx
        return counts.flops_truncation_grid(
            ctx.n_points, len(ctx.orders), 1, self.ls.numel(),
            self.ratios.numel())

    def failed(self, out):
        return int((~torch.isfinite(out[1])).sum())

    def release(self):
        self.kernel = self.grid = None

    def _surface(self, j, precision='f64'):
        ctx = self.ctx
        return truncation_lml_surface(
            sqdist(ctx.X, ctx.X, precision), self.Y[j].to(torch.float64),
            ctx.orders, self.ratios.to(torch.float64), float(self.ref[j]),
            self.ls, ctx.nugget, ctx.prior, precision)

    def control(self, precision, calls=1):
        """The surfaces computed by the reference in ``precision``."""
        return [(i, (i % self.pool, self._surface(i % self.pool, precision)))
                for i in range(calls)]

    def check(self, kept):
        N, m = self.ctx.n_points, len(self.ctx.orders)
        gaps, mismatch = [], 0
        for k in self.ctx.sample(len(kept)):
            j, surf = kept[k][1]
            ref = self._surface(j)
            surf = surf.to(torch.float64)
            both = torch.isfinite(surf) & torch.isfinite(ref)
            mismatch += int((torch.isfinite(surf) != torch.isfinite(ref))
                            .sum())
            gaps.append(worst((surf - ref)[both].abs() / (N * m)))
        return {'lml_gap': worst(gaps), 'inf_mismatch': float(mismatch)}
