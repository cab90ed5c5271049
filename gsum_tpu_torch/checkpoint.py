R"""Checkpoint / resume for fitted models (counterpart of
``gsum_tpu/checkpoint.py``).

The fitted state of a conjugate process is a set of arrays plus a static
metadata dict (kernel, hyperparameters, priors), saved as one numpy ``.npz``
with the metadata as embedded JSON.  The format and the metadata are the
JAX package's, so a file written by ``gsum_tpu.checkpoint.save`` loads into
the port's model and a file written here loads into ``gsum_tpu``: the second
way, beside ``convert``, of carrying fitted state across.  Arrays are saved
from whatever device they are on and restored onto the model's device in
their own dtype.

``save_orbax`` / ``load_orbax`` are not ported: orbax is a JAX library.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

__all__ = ['state_dict', 'restore_state', 'save', 'load']


def _kernel_sig(kernel_repr):
    """Structural signature of a kernel repr: float literals normalized
    to 6 significant digits (see the kernel check in restore_state)."""
    return re.sub(r'-?\d+(?:\.\d*)?(?:[eE][+-]?\d+)?',
                  lambda m: '%.6g' % float(m.group(0)), kernel_repr)


# Fitted attributes that form the array state
_ARRAY_FIELDS = [
    'X_train_', 'y_train_', 'corr_', 'corr_sqrt_', 'center_', 'disp_',
    'scale_', 'cov_factor_', 'cbar_sq_mean_', 'basis_train_',
]
_TRUNC_ARRAY_FIELDS = ['X_train_', 'y_train_', 'coeffs_', 'dX_', 'dy_',
                       'dderivs_']
# kept as numpy integer arrays in the port: they are orders, not data
_HOST_FIELDS = ('dderivs_',)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def state_dict(gp):
    """The fitted state of a conjugate process as numpy arrays.

    Also accepts the TruncationGP / TruncationTP wrappers: their state is
    the fitted coefficient process plus the extracted coefficients and any
    (dX, dy, dderivs) constraint data.  (A TruncationPointwise refits in
    closed form in O(N·k): persist its inputs instead.)

    Returns (arrays, meta): a dict of numpy arrays and a JSON-serializable
    metadata dict (kernel structure, hyperparameters, priors).
    """
    if not getattr(gp, '_fit', False):
        raise ValueError('Model must be fitted before checkpointing')
    if type(gp).__name__ == 'TruncationPointwise':
        raise ValueError(
            'TruncationPointwise has no expensive fitted state — refit in '
            'closed form (O(N*k)) from the persisted inputs instead')
    if hasattr(gp, 'coeffs_process'):
        inner_arrays, inner_meta = state_dict(gp.coeffs_process)
        arrays = {'cp.' + k: v for k, v in inner_arrays.items()}
        for f in _TRUNC_ARRAY_FIELDS:
            v = getattr(gp, f, None)
            if v is not None:
                arrays[f] = _np(v)
        meta = {
            'class': type(gp).__name__,
            'orders_': np.asarray(gp.orders_).tolist(),
            'excluded': (None if gp.excluded is None
                         else np.atleast_1d(gp.excluded).tolist()),
            'coeffs_process': inner_meta,
        }
        return arrays, meta
    arrays = {}
    for f in _ARRAY_FIELDS:
        v = getattr(gp, f, None)
        if v is not None:
            arrays[f] = _np(v)
    if gp._eigh_tuple_ is not None:
        arrays['_eigh_eig'] = _np(gp._eigh_tuple_[0])
        arrays['_eigh_Q'] = _np(gp._eigh_tuple_[1])

    meta = {
        'class': type(gp).__name__,
        'kernel_repr': repr(gp.kernel_),
        'kernel_theta': np.asarray(gp.kernel_.theta).tolist(),
        'df_': float(gp.df_),
        'log_marginal_likelihood_value_': (
            float(_np(gp.log_marginal_likelihood_value_))
            if gp.log_marginal_likelihood_value_ is not None else None),
        'priors': {
            'center0': np.asarray(gp.center0).tolist(),
            'disp0': np.asarray(gp.disp0).tolist(),
            'df0': 'inf' if np.isinf(gp.df0) else float(gp.df0),
            'scale0': float(gp.scale0),
        },
        'nugget': float(gp.nugget),
        'decomposition': gp.decomposition,
        'dorders_': (None if gp.dorders_ is None
                     else np.asarray(gp.dorders_).tolist()),
    }
    return arrays, meta


def _check_restore_compat(gp, meta):
    """Raises if ``gp`` was constructed with other priors, nugget,
    decomposition or class than the checkpoint: the stored posterior state
    would disagree with accessors that recompute from the priors."""
    mismatches = []
    p = meta.get('priors', {})

    def near(a, b):
        return np.allclose(np.asarray(a, dtype=float),
                           np.asarray(b, dtype=float), rtol=0, atol=0)

    if 'center0' in p and not near(gp.center0, p['center0']):
        mismatches.append('center0: instance %r vs checkpoint %r'
                          % (np.asarray(gp.center0).tolist(), p['center0']))
    if 'disp0' in p and not near(gp.disp0, p['disp0']):
        mismatches.append('disp0: instance %r vs checkpoint %r'
                          % (np.asarray(gp.disp0).tolist(), p['disp0']))
    if 'df0' in p:
        df0_ckpt = np.inf if p['df0'] == 'inf' else float(p['df0'])
        if not (np.isinf(gp.df0) and np.isinf(df0_ckpt)) \
                and float(gp.df0) != df0_ckpt:
            mismatches.append('df0: instance %r vs checkpoint %r'
                              % (gp.df0, df0_ckpt))
    if 'scale0' in p and float(gp.scale0) != float(p['scale0']):
        mismatches.append('scale0: instance %r vs checkpoint %r'
                          % (gp.scale0, p['scale0']))
    if 'nugget' in meta and float(gp.nugget) != float(meta['nugget']):
        mismatches.append('nugget: instance %r vs checkpoint %r'
                          % (gp.nugget, meta['nugget']))
    if 'decomposition' in meta and gp.decomposition != meta['decomposition']:
        mismatches.append('decomposition: instance %r vs checkpoint %r'
                          % (gp.decomposition, meta['decomposition']))
    if 'class' in meta and type(gp).__name__ != meta['class']:
        mismatches.append('class: instance %s vs checkpoint %s'
                          % (type(gp).__name__, meta['class']))
    if mismatches:
        raise ValueError(
            'checkpoint is incompatible with this instance:\n  '
            + '\n  '.join(mismatches))


def _tensor(gp, a):
    return torch.as_tensor(np.asarray(a), device=gp.device)


def restore_state(gp, arrays, meta):
    """Restores fitted state into a compatible (unfitted) model instance.

    The caller constructs ``gp`` with the same constructor arguments
    (kernel structure, priors, and for a truncation model the same
    ``ratio`` / ``ref`` callables, which are code and are not saved); this
    validates what it can, fills in the fitted attributes on the model's
    device, and marks the model fitted.
    """
    if 'coeffs_process' in meta:
        if type(gp).__name__ != meta['class']:
            raise ValueError('checkpoint is a %s, instance is a %s'
                             % (meta['class'], type(gp).__name__))
        exc_ckpt = meta.get('excluded')
        exc_inst = (None if gp.excluded is None
                    else np.atleast_1d(gp.excluded).tolist())
        if exc_ckpt != exc_inst:
            raise ValueError('excluded orders differ: instance %r vs '
                             'checkpoint %r' % (exc_inst, exc_ckpt))
        inner = {k[3:]: v for k, v in arrays.items() if k.startswith('cp.')}
        restore_state(gp.coeffs_process, inner, meta['coeffs_process'])
        for f in _TRUNC_ARRAY_FIELDS:
            if f in arrays:
                setattr(gp, f, np.asarray(arrays[f], dtype=int)
                        if f in _HOST_FIELDS else _tensor(gp, arrays[f]))
        gp.orders_ = np.asarray(meta['orders_'])
        gp._fit = True
        return gp

    _check_restore_compat(gp, meta)
    kernel = gp.kernel if gp.kernel is not None else gp._default_kernel
    gp.kernel_ = kernel.clone()
    theta = np.asarray(meta['kernel_theta'], dtype=float)
    n_theta = np.asarray(gp.kernel_.theta).size
    if theta.size != n_theta:
        raise ValueError(
            'checkpoint kernel theta has %d entries but this instance\'s '
            'kernel %r expects %d — kernel structure mismatch'
            % (theta.size, gp.kernel_, n_theta))
    if theta.size:
        gp.kernel_.theta = theta
    # the kernel's STRUCTURE must match (θ sizes can coincide between,
    # say, an RBF and a Matern): reprs at the restored θ are compared with
    # float literals normalized to 6 significant digits, since the exp/log
    # round trip of θ may move the last digits, while class names,
    # composition and fixed shape parameters (Matern ν, periodicity) must
    # agree
    want = meta.get('kernel_repr')
    if want is not None:
        got = repr(gp.kernel_)
        if _kernel_sig(got) != _kernel_sig(want):
            raise ValueError(
                'checkpoint kernel %s does not match this instance\'s '
                'kernel %s' % (want, got))
    for f in _ARRAY_FIELDS:
        if f in arrays:
            setattr(gp, f, _tensor(gp, arrays[f]))
    gp.corr_L_ = gp.corr_sqrt_
    if '_eigh_eig' in arrays:
        gp._eigh_tuple_ = (_tensor(gp, arrays['_eigh_eig']),
                           _tensor(gp, arrays['_eigh_Q']))
    gp.df_ = meta['df_']
    if meta.get('log_marginal_likelihood_value_') is not None:
        gp.log_marginal_likelihood_value_ = meta['log_marginal_likelihood_value_']
    gp.dorders_ = (None if meta.get('dorders_') is None
                   else np.asarray(meta['dorders_'], dtype=int))
    gp._fit = True
    return gp


def save(path, gp):
    """Saves a fitted model to ``<path>.npz`` (arrays + embedded metadata).

    The archive is stored uncompressed (the JAX package compresses it;
    ``numpy.load`` reads either): a fitted model's factors do not
    compress, and zlib takes about ten seconds for the 0.5 GB of an
    N = 4096 model."""
    arrays, meta = state_dict(gp)
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load(path, gp):
    """Loads fitted state saved by :func:`save` (or by
    ``gsum_tpu.checkpoint.save``) into model instance ``gp``."""
    with np.load(path if str(path).endswith('.npz') else str(path) + '.npz',
                 allow_pickle=False) as data:
        meta = json.loads(str(data['__meta__']))
        arrays = {k: data[k] for k in data.files if k != '__meta__'}
    return restore_state(gp, arrays, meta)
