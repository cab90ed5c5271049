"""The arithmetic of the warp-per-element incomplete-beta kernel
(``gsum_tpu_torch/csrc/incbeta.cu``, ``cf_warp``) emulated in PyTorch on the
CPU: it gives each element the plain version's value bit for bit, and so
meets the limits that the card's checks apply to the kernel.

The kernel's warp form takes the Lentz-Thompson-Barnett loop of the
continued fraction of ``I_x(a, b)`` apart: lane k forms the partial
numerator of term n0 + k, 32 at a time; the even lanes run the recurrence
of c and the odd lanes that of d, over chunks of 8 terms without a test;
then the products delta = c d, the value h and the stop test, which keeps
the value after the chunk's first converged term (or the cap, term
``kTerms - 1``) and discards the terms after it.  The emulation below does
the same operations in the same order (IEEE division and reciprocal,
products and sums unfused, as the kernel's ``mul``), and counts the terms
up to the stop term and the chunks run as the kernel's ``terms`` and
``chunks`` do.  The rest of ``betainc`` (edges, swap, prefactor) and
``betaincinv``'s Newton iteration are the plain version's
(``stats._special``), which both of the kernel's forms follow operation
for operation.

Checks:

- against the plain version (``betainc_plain`` / ``betaincinv_plain``, the
  Lentz loop one term at a time, on the CPU): equal bit for bit, NaN where
  it is NaN; for betaincinv on arguments where the 50 Newton steps do not
  converge (the beta bands' and a QQ panel's t quantiles at large ν), whose
  end follows every rounding of every betainc the iteration takes;
- against ``jax.scipy.special.betainc`` and ``gsum_tpu``'s ``betaincinv``:
  1e-13 / 1e-11 relative (the card's limits for the kernel against the
  plain version), plus for betainc the condition of the prefactor that
  ``tests/test_torch_special.py`` states (its exponent sums terms as large
  as S, each rounded: 4 eps (S + 64) |r'|, r' the value before the swap's
  1 - r'; XLA's lgamma is not torch's) and the smallest normal number (XLA
  on the CPU flushes subnormal results to 0), and for betaincinv that error
  divided by the density at the root.

Inputs (``time_incbeta.inputs``, seeded; a numpy draw picks the elements
compared with JAX): the t quantile's arguments (a = df/2, b = 1/2), the beta
bands' (a = 4096 s + 1, b = 4097 - a), ``helpers.hpd``'s a = b = 2049, a QQ
panel's t quantiles at ν = 20485 and XLA's edge values.
"""
import jax
import numpy as np
import pytest
import scipy.special as sp
import torch
from jax.scipy.special import betainc as jax_betainc

from gsum_tpu.stats import _special as jsp
from gsum_tpu_torch.stats import _special as tsp
from gsum_tpu_torch.time_incbeta import inputs
from _port import one_intra_op_thread  # noqa: F401 (autouse)

LANES = 32                   # partial numerators formed at a time
CHUNK = 8                    # terms between two stop tests
EPS = np.finfo(np.float64).eps
TOL = {'betainc': 1e-13, 'betaincinv': 1e-11}


def cf_warp(a, b, x):
    """The warp form's continued fraction of same-shape 1-D tensors (after
    the swap); returns (value, terms up to the stop term, chunks run)."""
    small = torch.finfo(x.dtype).eps / 2
    cap = (200 if x.dtype == torch.float32 else 600) - 1   # kTerms - 1
    ab = a + b
    h = torch.full_like(x, small)
    c, d = h, torch.zeros_like(x)       # the even lanes' c, the odd lanes' d
    value = torch.full_like(x, float('nan'))
    terms = torch.zeros(x.shape, dtype=torch.int64)
    chunks = torch.zeros_like(terms)
    done = torch.zeros(x.shape, dtype=torch.bool)
    n0 = 1
    while not bool(done.all()):
        # lane k's partial numerator, of term n0 + k
        nums = [tsp._numerator(n0 + k, a, b, x, ab) for k in range(LANES)]
        for k0 in range(0, LANES, CHUNK):
            # the two recurrences over the chunk, without a test
            seen = []
            for num in nums[k0:k0 + CHUNK]:
                e = 1 + num * d
                e = torch.where(torch.abs(e) < small, small, e)
                c, d = 1 + num / c, 1 / e       # the warp's one division
                c = torch.where(torch.abs(c) < small, small, c)
                seen.append((c, d))
            chunks += (~done).long()
            # then the products, the value and the stop test
            first = torch.full_like(terms, CHUNK)
            for k, (ck, dk) in enumerate(seen):
                delta = ck * dk
                h = h * delta
                # NaN counts as converged, as in XLA
                stop = ~(torch.abs(delta - 1) >= small) \
                    | (n0 + k0 + k == cap)
                new = stop & (first == CHUNK) & ~done
                value = torch.where(new, h, value)
                first = torch.where(new, k, first)
            hit = first < CHUNK
            terms += torch.where(done, 0, torch.where(hit, first + 1, CHUNK))
            done = done | hit
        n0 += LANES
    return value, terms, chunks


def _with_warp_fraction(fn, *args):
    """``fn`` (a plain version of ``stats._special``) with the warp form's
    continued fraction in place of the Lentz loop."""
    saved = tsp._continued_fraction
    tsp._continued_fraction = lambda a, b, x: cf_warp(a, b, x)[0]
    try:
        return fn(*args)
    finally:
        tsp._continued_fraction = saved


def _newton_steps(a, b, p):
    """The steps of the plain version's Newton iteration that changed each
    element's (x, lo, hi): 50 where it has not converged."""
    x = tsp._betaincinv_start(a, b, p)
    afac = -torch.lgamma(a) - torch.lgamma(b) + torch.lgamma(a + b)
    lo, hi = torch.zeros_like(x), torch.ones_like(x)
    steps = torch.zeros(x.shape, dtype=torch.int64)
    for _ in range(50):
        err = tsp.betainc_plain(a, b, x) - p
        lo_n = torch.where(err < 0.0, torch.maximum(lo, x), lo)
        hi_n = torch.where(err > 0.0, torch.minimum(hi, x), hi)
        t = torch.exp((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x)
                      + afac)
        newton = x - torch.where(t > 0, err / t, 0.0)
        good = torch.isfinite(newton) & (newton > lo_n) & (newton < hi_n)
        x_n = torch.where(good, newton, 0.5 * (lo_n + hi_n))
        same = torch.ones_like(good)
        for u, v in ((x, x_n), (lo, lo_n), (hi, hi_n)):
            same &= (u == v) | (torch.isnan(u) & torch.isnan(v))
        steps += (~same).long()
        if bool(same.all()):
            break
        x, lo, hi = x_n, lo_n, hi_n
    return steps


def _elements(which, n=None, seed=0):
    """A case's elements, flattened: the first ``n`` (all where None), or,
    with ``seed``, ``n`` of them chosen by a seeded numpy draw."""
    a, b, u = (v.flatten() for v in inputs(which, torch.float64, 'cpu'))
    if n is not None and a.numel() > n:
        idx = (torch.from_numpy(np.random.RandomState(seed).choice(
            a.numel(), n, replace=False)) if seed else torch.arange(n))
        a, b, u = a[idx], b[idx], u[idx]
    return a, b, u


# the elements held to the plain version: the beta bands' first 2048 hold
# eleven whose Newton iteration does not converge, the QQ panel's 1024 452
EXACT = {'t': (2048, None), 'beta': (2048, None), 'hpd57': (None, None),
         'qq': (None, None), 'edge': (None, None)}
UNCONVERGED = ('beta', 'qq')
# the elements compared with JAX: (count, seed of the draw)
AGAINST_JAX = {'t': (200, 1), 'beta': (200, 2), 'hpd57': (57, 0),
               'edge': (25, 0)}
_JAX_WIDTH = 256           # every case's JAX call at one shape: one compile


def _jax(fn, *args):
    """``fn`` (jitted) of the 1-D float64 arrays ``args``, each repeated to
    _JAX_WIDTH elements: the repeats change no value (XLA's continued
    fraction stops where every element has converged, and a repeat
    converges with its original), and every case shares one compile."""
    n = args[0].shape[0]
    out = jax.jit(fn)(*(np.resize(np.asarray(v), _JAX_WIDTH)
                        for v in args))
    return np.asarray(out)[:n]


def _prefactor_limit(a, b, x, ref):
    """The prefactor's condition (``tests/test_torch_special.py``)."""
    swap = ~(x < (a + 1) / (a + b + 2))
    a2, b2 = np.where(swap, b, a), np.where(swap, a, b)
    x2 = np.where(swap, 1 - x, x)
    with np.errstate(divide='ignore', invalid='ignore'):
        S = (np.abs(a2 * np.log(x2)) + np.abs(b2 * np.log1p(-x2))
             + np.abs(sp.gammaln(a2)) + np.abs(sp.gammaln(b2))
             + np.abs(sp.gammaln(a2 + b2)))
    S = np.nan_to_num(S, nan=0.0, posinf=0.0)
    return 4 * EPS * (S + 64) * np.abs(np.where(swap, 1 - ref, ref))


def _bitwise(got, want):
    return torch.equal(got.nan_to_num(nan=2.0), want.nan_to_num(nan=2.0)) \
        and torch.equal(torch.isnan(got), torch.isnan(want))


@pytest.mark.parametrize('which', list(EXACT))
def test_betainc_warp_bit_for_bit_with_the_plain_loop(which):
    a, b, x = _elements(which, *EXACT[which])
    got = _with_warp_fraction(tsp.betainc_plain, a, b, x)
    assert _bitwise(got, tsp.betainc_plain(a, b, x))


@pytest.mark.parametrize('which', list(AGAINST_JAX))
def test_betainc_warp_against_jax(which):
    a, b, x = _elements(which, *AGAINST_JAX[which])
    got = _with_warp_fraction(tsp.betainc_plain, a, b, x).numpy()
    want = _jax(jax_betainc, a, b, x)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    an, bn, xn = a.numpy()[ok], b.numpy()[ok], x.numpy()[ok]
    # XLA on the CPU flushes a subnormal result to 0: the smallest normal
    # number is the absolute floor
    limit = (TOL['betainc'] * np.abs(want[ok])
             + _prefactor_limit(an, bn, xn, want[ok])
             + np.finfo(np.float64).tiny)
    assert np.all(np.abs(got[ok] - want[ok]) <= limit)


@pytest.mark.parametrize('which', list(EXACT))
def test_betaincinv_warp_bit_for_bit_with_the_plain_version(which):
    a, b, p = _elements(which, *EXACT[which])
    got = _with_warp_fraction(tsp.betaincinv_plain, a, b, p)
    assert _bitwise(got, tsp.betaincinv_plain(a, b, p))
    if which in UNCONVERGED:
        unconverged = _with_warp_fraction(_newton_steps, a, b, p) == 50
        assert int(unconverged.sum()) >= 10


@pytest.mark.parametrize('which', ['t', 'beta', 'hpd57'])
def test_betaincinv_warp_against_jax(which):
    """(The edge set is held to the plain version above:
    ``tests/test_torch_special.py`` states where the plain version departs
    from JAX there, subnormal arguments among them.)"""
    n, seed = AGAINST_JAX[which]
    a, b, p = _elements(which, min(n, 60), seed)
    got = _with_warp_fraction(tsp.betaincinv_plain, a, b, p).numpy()
    want = _jax(jsp.betaincinv, a, b, p)
    assert np.isfinite(want).all() and np.all((want > 0) & (want < 1))
    an, bn = a.numpy(), b.numpy()
    density = np.exp(-sp.betaln(an, bn) + (an - 1) * np.log(want)
                     + (bn - 1) * np.log1p(-want))
    fwd = _prefactor_limit(an, bn, want, sp.betainc(an, bn, want))
    limit = TOL['betaincinv'] * want + (fwd + 4 * EPS) / density
    assert np.all(np.abs(got - want) <= limit)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_warp_terms_chunks_and_cap(dtype):
    """The terms up to the stop term are the Lentz loop's, the chunks
    their count in chunks of 8; an element that never converges stops at
    term kTerms - 1 (599 in f64, 199 in f32) with that term's value, as the
    Lentz loop does, after 75 or 25 chunks."""
    a, b, x = (v.to(dtype) for v in _elements('beta', 256))
    conv = x < (a + 1) / (a + b + 2)
    a, b = torch.where(conv, a, b), torch.where(conv, b, a)
    x = torch.where(conv, x, 1 - x)
    value, terms, chunks = cf_warp(a, b, x)
    assert _bitwise(value, tsp._continued_fraction(a, b, x))
    # the Lentz loop's count: the terms up to the first converged one
    small = torch.finfo(dtype).eps / 2
    c, d = torch.full_like(x, small), torch.zeros_like(x)
    want = torch.zeros_like(terms)
    done = torch.zeros_like(conv)
    for n in range(1, 600 if dtype == torch.float64 else 200):
        num = tsp._numerator(n, a, b, x, a + b)
        c = 1 + num / c
        c = torch.where(torch.abs(c) < small, small, c)
        d = 1 + num * d
        d = 1 / torch.where(torch.abs(d) < small, small, d)
        want += (~done).long()
        done = done | ~(torch.abs(c * d - 1) >= small)
        if bool(done.all()):
            break
    assert torch.equal(terms, want)
    assert torch.equal(chunks, (terms + CHUNK - 1) // CHUNK)
    # x = 1 after no swap: the partial numerators stay large and the
    # fraction does not settle within the cap
    one = torch.ones(1, dtype=dtype)
    value, terms, chunks = cf_warp(one * 5000.0, one * 0.5, one)
    cap = 599 if dtype == torch.float64 else 199
    assert terms.item() == cap and chunks.item() == -(-cap // CHUNK)
    assert _bitwise(value, tsp._continued_fraction(one * 5000.0, one * 0.5,
                                                   one))
