R"""The Gauss hypergeometric function of the variogram's fourth-root
correlation (counterpart of ``hyp2f1_variogram`` in ``gsum_tpu/_accmath.py``).

Torch has no ``hyp2f1``.  :func:`hyp2f1_variogram` evaluates
:math:`{}_2F_1(3/4, 3/4; 1/2; x)` on [0, 1) from host-precomputed float64
tables, as the JAX package does.  The JAX module's ``exp64`` is not
ported: it rebuilt a float64 ``exp`` for a TPU whose scalar-shape ``exp``
was only float32-accurate; float64 ``exp`` is native on the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ['hyp2f1_variogram']


def _hyp2f1_variogram_tables(n_terms=64):
    """Host float64 coefficient tables for :func:`hyp2f1_variogram`.

    Direct branch (x <= 1/2): the Gauss series of F(3/4, 3/4; 1/2; x),
    g_{n+1} = g_n (3/4+n)^2 / ((1/2+n)(1+n)); 64 terms leave < 6e-20
    relative at the x = 1/2 crossover.

    Near-1 branch (x > 1/2, w = 1-x): Euler's transformation gives
    F(3/4, 3/4; 1/2; x) = G(x)/w with G = F(-1/4, -1/4; 1/2; x), and
    G' = F(3/4, 3/4; 3/2; x)/8 is the logarithmic case c = a+b (DLMF
    15.8.10).  Integrating that series termwise from 1-w to 1,

        F = A/w + ln(w) P(w) - Q(w),
        A = sqrt(pi)/Gamma(3/4)^2 = G(1),
        P_n = C e_n/(n+1),  Q_n = P_n (d_n + 1/(n+1)),
        C = sqrt(pi)/(16 Gamma(3/4)^2),  e_n = ((3/4)_n / n!)^2,
        d_n = 2 psi(n+1) - 2 psi(n+3/4),

    with the digamma values built by exact recurrence from psi(1) = -gamma
    and psi(3/4) = -gamma - 3 ln 2 + pi/2.
    """
    n = np.arange(n_terms, dtype=np.float64)
    g = np.ones(n_terms)
    g[1:] = np.cumprod((0.75 + n[:-1]) ** 2 / ((0.5 + n[:-1]) * (1.0 + n[:-1])))
    gamma34_sq = math.gamma(0.75) ** 2
    A = math.sqrt(math.pi) / gamma34_sq
    C = math.sqrt(math.pi) / (16.0 * gamma34_sq)
    euler = 0.5772156649015328606
    psi1 = -euler + np.concatenate([[0.0], np.cumsum(1.0 / (n[:-1] + 1.0))])
    psi34 = (-euler - 3.0 * math.log(2.0) + math.pi / 2.0) \
        + np.concatenate([[0.0], np.cumsum(1.0 / (n[:-1] + 0.75))])
    e = np.ones(n_terms)
    e[1:] = np.cumprod(((0.75 + n[:-1]) / (1.0 + n[:-1])) ** 2)
    P = C * e / (n + 1.0)
    Q = P * (2.0 * (psi1 - psi34) + 1.0 / (n + 1.0))
    return A, g, P, Q


_H2F1_A, _H2F1_G, _H2F1_P, _H2F1_Q = _hyp2f1_variogram_tables()


def _horner(coeffs, x):
    """``sum_n coeffs[n] x^n`` by Horner's rule, in place on one buffer."""
    p = torch.full_like(x, float(coeffs[-1]))
    for c in coeffs[-2::-1]:
        p.mul_(x).add_(float(c))
    return p


def hyp2f1_variogram(x):
    R"""Gauss hypergeometric :math:`{}_2F_1(3/4, 3/4; 1/2; x)` on [0, 1).

    Horner evaluation of the host tables and one ``log``; within 1.8e-15
    of scipy across the domain (the JAX package's measurement of the same
    tables).  A float32 ``x`` evaluates the tables in float32.  It
    diverges as x -> 1 (a pole 1/(1-x)); callers clamp the argument below 1.
    """
    w = 1.0 - x
    direct = _horner(_H2F1_G, x)
    pP = _horner(_H2F1_P, w)
    pQ = _horner(_H2F1_Q, w)
    # keep log's argument positive on the branch that is not taken
    w_safe = torch.where(w > 0, w, 1.0)
    near1 = _H2F1_A / w_safe + torch.log(w_safe) * pP - pQ
    return torch.where(x <= 0.5, direct, near1)
