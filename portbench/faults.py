R"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches them.  Each is a context manager that patches
the program while a workload is built and run, and undoes the patch after:

- ``frozen_step``: the optimizer's step returns its state unchanged (the
  lockstep L-BFGS's ``step``, or the host L-BFGS-B's whole run);
- ``half_batch``: half of the batch is left out and the answers of the rest
  stand for it (fits, ratios of a surface, curves of an observable);
- ``altered_answer``: every answer is altered a little where it is
  produced (θ moved by 1%, a surface by one nat, a mean by a tenth of a
  std).

Used by the tests on the CPU and by ``portbench.control`` on the card; a
benchmark run never imports this module.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ('frozen_step', 'half_batch', 'altered_answer')


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def planted(fault, call):
    """The context manager that plants ``fault`` under the kind of call
    ``call`` (a traffic mix's ``call``); ``None`` where the call cannot
    have that fault."""
    import gsum_tpu_torch as port
    from gsum_tpu_torch import models, optimize, parallel

    if fault not in FAULTS:
        raise ValueError(f'unknown fault {fault!r}')
    if call == 'batched_fit':
        fit = parallel.batched_fit
        if fault == 'frozen_step':
            return _patched(optimize._Lbfgs, 'step', lambda self: None)
        if fault == 'half_batch':
            def half(kernel, X, Y, **kw):
                n = Y.shape[0]
                post = fit(kernel, X, Y[:(n + 1) // 2], **kw)
                idx = torch.arange(n, device=Y.device) % ((n + 1) // 2)
                return type(post)(**{k: getattr(post, k)[idx]
                                     for k in post.__dataclass_fields__})
            return _patched(parallel, 'batched_fit', half)

        def altered(kernel, X, Y, **kw):
            post = fit(kernel, X, Y, **kw)
            return type(post)(**{**{k: getattr(post, k)
                                    for k in post.__dataclass_fields__},
                                 'theta': post.theta + 0.01})
        return _patched(parallel, 'batched_fit', altered)

    if call == 'truncation_grid':
        grid = parallel.truncation_lml_grid
        if fault == 'frozen_step':
            return None
        if fault == 'half_batch':
            def half(kernel, X, y, orders, ratios, thetas, **kw):
                n = ratios.shape[0]
                surf = grid(kernel, X, y, orders, ratios[:(n + 1) // 2],
                            thetas, **kw)
                idx = torch.arange(n, device=surf.device) % ((n + 1) // 2)
                return surf[:, idx]
            return _patched(parallel, 'truncation_lml_grid', half)
        return _patched(parallel, 'truncation_lml_grid',
                        lambda *a, **kw: grid(*a, **kw) + 1.0)

    if call == 'truncation_analysis':
        if fault == 'frozen_step':
            def frozen(obj_func, initial_theta, bounds):
                return initial_theta, obj_func(initial_theta, False)
            return _patched(models, 'scipy_lbfgsb', frozen)
        if fault == 'half_batch':
            fit = port.TruncationGP.fit

            def half(self, X, y, orders, **kw):
                fit(self, X, y, orders, **kw)
                keep = (self.coeffs_.shape[1] + 1) // 2
                self.coeffs_process.fit(self.X_train_,
                                        self.coeffs_[:, :keep])
                return self
            return _patched(port.TruncationGP, 'fit', half)
        predict = port.TruncationGP.predict

        def altered(self, *a, **kw):
            mean, std = predict(self, *a, **kw)
            return mean + 0.1 * std, std
        return _patched(port.TruncationGP, 'predict', altered)
    return None
