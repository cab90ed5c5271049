R"""What every kind of call shares: the cell's configuration read into
tensors on the run's device, the model's prior and kernel settings, and
helpers for the comparison that decides ``correct``."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import data
from .reference import Prior


class Context:
    """One run of one cell: its files, seed and device."""

    def __init__(self, spec, seed, device):
        self.spec = spec
        self.seed = int(seed)
        self.device = torch.device(device)
        cfg = spec.config
        self.config, self.traffic = cfg, spec.traffic
        self.dtype = data.DTYPES[cfg['dtype']]
        self.X64 = torch.as_tensor(data.lattice(cfg['inputs']),
                                   dtype=torch.float64, device=self.device)
        self.X = self.X64.to(self.dtype)
        self.orders = list(cfg['orders'])
        self.excluded = list(cfg.get('excluded', []))
        p = cfg['prior']
        if p.get('disp', 0) != 0:
            raise ValueError('the reference takes a known mean (disp 0)')
        self.prior = Prior(float(p['center']), float(p['df']),
                           float(p['scale']))
        self.nugget = float(cfg['nugget'])
        k = cfg['kernel']
        if k['kind'] != 'RBF':
            raise ValueError(f"no reference for kernel {k['kind']!r}")
        self.length_scale0 = float(k['length_scale'])
        self.bounds = tuple(float(b) for b in k['bounds'])
        self.log_bounds = tuple(math.log(b) for b in self.bounds)

    @property
    def n_points(self):
        return self.X.shape[0]

    def port(self):
        import gsum_tpu_torch
        return gsum_tpu_torch

    def kernel(self):
        return self.port().RBF(self.length_scale0, self.bounds)

    def prior_kwargs(self):
        return dict(center=self.prior.center, disp=0, df=self.prior.df,
                    scale=self.prior.scale, nugget=self.nugget)

    def synchronize(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def observables(self, count, stream='pool'):
        return data.observables(self.config, self.traffic, self.X64, count,
                                self.seed, stream)

    def sample(self, total, stream='check'):
        """Indices of the answers compared: ``check_sample`` of ``total``,
        drawn from the seed once the window has closed."""
        k = min(int(self.traffic['check_sample']), total)
        rng = data.host_rng(self.seed, stream)
        return np.sort(rng.choice(total, size=k, replace=False))


def worst(x):
    """The largest entry of ``x`` as a float, NaN counting as infinite."""
    x = torch.as_tensor(x, dtype=torch.float64)
    if x.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(x, nan=math.inf).max())
