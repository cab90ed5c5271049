R"""Times the incomplete-beta kernels (``csrc/incbeta.cu``) on the card.

For each case below, and each of ``betainc`` and ``betaincinv`` where the
case calls it, the kernel of this tree in each of its two forms (and, with
``--earlier PATH``, the kernel built from another version of
``incbeta.cu``, in alternating order in the same run) is

- checked against the plain version (``stats._special``) on the card;
- timed on the device: CUDA events around ten launches queued behind a
  spin kernel, so that the card runs them back to back however long the
  host takes to issue them; the median of five such samples;
- counted: the continued-fraction terms its elements took (summed over the
  Newton steps of ``betaincinv``), the bound from them (``CF_FLOPS`` flops a
  term at the card's f64 or f32 rate, or the bytes of the inputs and the
  output, whichever is larger), and its lane use: the terms over the terms
  its lanes ran (:func:`lane_terms`).

The plain version's time (host clock around one call ending in a
synchronise) stands beside them.  Then the two forms' ``betaincinv`` by
size (:func:`sweep`), from which ``ops.incbeta.WARP_MAX`` is chosen.

Cases (:func:`inputs`): ``t``, the t quantile's arguments at (4096, 5)
(a = df/2 per column, b = 1/2); ``beta``, the beta bands' (a = 4096 s + 1,
b = 4097 - a) at (4096, 5); ``hpd 0.16`` and ``hpd 0.84``, the one-element
quantile of ``helpers.hpd`` on a beta band at N = 4096, s = 0.5
(a = b = 2049); ``interval``, the two-element t quantile of
``TruncationPointwise.interval`` (a = 3, b = 1/2: ν = 6; p = 1 - alpha for
alpha 0.68 and 0.95).  ``hpd57`` (57 elements), ``qq`` (the 1024 t
quantiles of a QQ panel at ν = ``QQ_DF``) and ``edge`` (XLA's edge values)
are for the checks of ``chip_smoke.py`` and the GPU tests.

Run: ``python -m gsum_tpu_torch.time_incbeta [--earlier PATH
[--earlier-without-forms]]`` (needs nvcc and a card).  An earlier tree's
source comes from ``git archive`` into the git-ignored ``_checkout/``;
``--earlier-without-forms`` calls a source from before the two forms,
whose entries take (a, b, x, out, terms, n, stream).
"""
import argparse
import ctypes
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from gsum_tpu_torch import _build

SHAPE = (4096, 5)
T_DF = (1.0, 3.0, 5.0, 30.0, 6.0)      # t quantiles; 6 = path 6's ν
HPD_AB = 2049.0                        # Beta(N s + 1, N - N s + 1), N = 4096
QQ_N, QQ_DF = 1024, 20485.0            # a QQ panel; ν of chip_smoke's TP
CF_FLOPS = 20      # floating-point operations per continued-fraction term
RATE = {torch.float64: 34e12, torch.float32: 67e12}   # H100 SXM, no TC
HBM_BYTES_PER_S = 3.35e12
TIMED = (('t', torch.float64), ('t', torch.float32), ('beta', torch.float64),
         ('beta', torch.float32), ('hpd 0.16', torch.float64),
         ('hpd 0.84', torch.float64), ('interval', torch.float64),
         ('qq', torch.float64))


def _edges():
    """XLA's edge values of betainc (a = 0, b = inf, b = 0, a = inf, NaN,
    negative arguments, x at 0, 1 and outside [0, 1], a subnormal a) and of
    the inverse (p at 0, 1, outside [0, 1], NaN), beside ordinary
    elements."""
    a = [0.0, 0.0, 2.0, 2.0, 2.0, 2.0, float('inf'), float('inf'), 0.0,
         float('inf'), float('nan'), 2.0, 2.0, -1.0, 2.0, 2.0, 2.0, 1e-310,
         2.0, 2.0, 2.0, 2.0, 2.0, 0.5, 15.0]
    b = [3.0, 3.0, float('inf'), float('inf'), 0.0, 0.0, 3.0, 3.0, 0.0,
         float('inf'), 3.0, float('nan'), 3.0, 3.0, -1.0, 3.0, 3.0, 3.0,
         3.0, 3.0, 3.0, 3.0, 3.0, 0.5, 0.5]
    u = [0.5, 0.0, 0.5, 0.0, 0.5, 1.0, 0.5, 1.0, 0.5, 0.5, 0.5, 0.5,
         float('nan'), 0.5, 0.5, -0.1, 1.1, 0.5, 0.0, 1.0, 1.5, 1e-300,
         0.9, 0.999, 1e-6]
    return a, b, u


def inputs(which, dtype, device):
    R"""``(a, b, u)`` of one case (see the module's docstring) as
    contiguous tensors of ``dtype`` on ``device``; u is x of betainc and p
    of betaincinv."""
    f64 = torch.float64
    gen = torch.Generator(device='cpu').manual_seed(6)
    if which in ('t', 'beta'):
        u = torch.rand(SHAPE, generator=gen, dtype=f64)
        if which == 't':
            a = torch.tensor(T_DF, dtype=f64).expand(SHAPE) / 2
            b = torch.full(SHAPE, 0.5, dtype=f64)
        else:
            s = torch.rand(SHAPE, generator=gen, dtype=f64)
            a, b = 4096 * s + 1, 4096 - 4096 * s + 1
    elif which.startswith('hpd'):
        u = (torch.linspace(0.02, 0.98, 57, dtype=f64) if which == 'hpd57'
             else torch.tensor([float(which.split()[1])], dtype=f64))
        a = b = torch.full_like(u, HPD_AB)
    elif which == 'qq':
        # stats.t.ppf's call: the standardized reference's quantiles at
        # (k - 1/2) / 1024
        q = (torch.arange(1, QQ_N + 1, dtype=f64) - 0.5) / QQ_N
        u = 2 * torch.minimum(q, 1 - q)
        a, b = torch.full_like(u, QQ_DF / 2), torch.full_like(u, 0.5)
    elif which == 'interval':
        u = torch.tensor([1 - 0.68, 1 - 0.95], dtype=f64)
        a, b = torch.full_like(u, 3.0), torch.full_like(u, 0.5)
    elif which == 'edge':
        a, b, u = (torch.tensor(v, dtype=f64) for v in _edges())
    else:
        raise ValueError(f'unknown case {which!r}')
    return [v.to(device=device, dtype=dtype).contiguous() for v in (a, b, u)]


# the cases that the checks run (chip_smoke.py, tests/test_torch_gpu.py)
CHECKED = ('t', 'beta', 'hpd 0.16', 'hpd 0.84', 'hpd57', 'qq', 'edge')
# the first elements of the beta bands' arguments, among them some whose
# 50 Newton steps do not converge, checked in one launch (the thread form)
# and in launches of SLICE elements (the warp form)
SLICED, SLICE = 8192, 32


def check_cases(dtype, device):
    """{name: [(a, b, u), ...]} for the checks, each list a case's
    launches: each of CHECKED as one launch; hpd57, qq and the edge set
    repeated past ``ops.incbeta.WARP_MAX`` elements (so that they take the
    thread form where the case alone takes the warp form); the t
    quantile's arguments at ``WARP_MAX`` elements and one more (the two
    sides of the size at which launches turn from a warp per element to a
    thread); the first SLICED of the beta bands' arguments in one launch
    and in launches of SLICE; and qq in launches of SLICE."""
    from gsum_tpu_torch.ops.incbeta import WARP_MAX as w

    cases = {which: [inputs(which, dtype, device)] for which in CHECKED}
    for which in ('hpd57', 'qq', 'edge'):
        args = cases[which][0]
        reps = w // args[0].numel() + 1
        cases[f'{which} repeated past {w}'] = [[v.repeat(reps)
                                                for v in args]]
    t_args = [v.flatten() for v in cases['t'][0]]
    for n in (w, w + 1):
        cases[f't[:{n}]'] = [[v[:n].contiguous() for v in t_args]]
    beta = [v.flatten()[:SLICED].contiguous() for v in cases['beta'][0]]
    cases[f'beta[:{SLICED}]'] = [beta]
    for name, args in (('qq', cases['qq'][0]), (f'beta[:{SLICED}]', beta)):
        cases[f'{name} in launches of {SLICE}'] = [
            [v[i:i + SLICE].contiguous() for v in args]
            for i in range(0, args[0].numel(), SLICE)]
    return cases


def bound_ms(terms, n, dtype):
    """Least time in ms for ``terms`` continued-fraction terms over ``n``
    elements (three inputs read, one output written), and which bounds
    it."""
    itemsize = torch.finfo(dtype).bits // 8
    t_bytes = 4 * n * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = CF_FLOPS * terms / RATE[dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def lane_terms(terms, chunks, form):
    """The terms that the lanes of a launch ran: a warp per element (form
    1), 32 lanes for each chunk of 8 terms (two recurrences, each on 16
    lanes); a thread per element, 32 lanes for as long as their warp's
    slowest lane runs."""
    if form:
        return 32 * 8 * chunks.sum().item()
    t = torch.nn.functional.pad(terms.flatten(), (0, -terms.numel() % 32))
    return 32 * t.view(-1, 32).max(1).values.sum().item()


class Library:
    """One build of ``incbeta.cu``, called through its C entries in one of
    its forms: ``form`` 1 a warp per element, 0 a thread per element, None
    for a source from before the two forms (entries (a, b, x, out, terms,
    n, stream) where this tree's take (a, b, x, out, terms, chunks, n,
    form, stream))."""

    def __init__(self, path, form=None):
        self.lib = ctypes.CDLL(str(path))
        self.form = form

    def call(self, name, a, b, x, terms=None, chunks=None):
        suffix = 'f32' if x.dtype == torch.float32 else 'f64'
        fn = getattr(self.lib, f'gsum_{name}_{suffix}')
        out = torch.empty_like(x)
        ptrs = [a.data_ptr(), b.data_ptr(), x.data_ptr(), out.data_ptr(),
                None if terms is None else terms.data_ptr()]
        tail = [x.numel()]
        types = [ctypes.c_longlong]
        if self.form is not None:
            ptrs.append(None if chunks is None else chunks.data_ptr())
            tail.append(self.form)
            types.append(ctypes.c_int)
        fn.argtypes = [ctypes.c_void_p] * len(ptrs) + types + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(*ptrs, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'CUDA error {err} at the launch of {name}')
        return out

    def lane_use(self, name, a, b, x):
        """(out, terms, lane use) of one launch."""
        terms = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        chunks = torch.zeros_like(terms)
        out = self.call(name, a, b, x, terms, chunks)
        n_terms = terms.sum().item()
        lanes = lane_terms(terms, chunks, self.form)
        return out, n_terms, n_terms / max(lanes, 1)


def compile_source(src, d):
    """Builds ``src`` alone into a library in the new directory ``d``;
    returns the path and ptxas's register counts."""
    d.mkdir()
    so = d / 'libincbeta.so'
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-shared',
                           '-o', str(so), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError('nvcc failed:\n' + proc.stdout + proc.stderr)
    log = '; '.join(line.split(': ', 1)[-1].strip()
                    for line in (proc.stdout + proc.stderr).splitlines()
                    if 'registers' in line)
    return so, log


def device_ms(fns, rounds=5, calls=10):
    """Per launch, in ms, of each function in ``fns``: the median of
    ``rounds`` samples of ``calls`` launches queued behind a spin kernel,
    the functions in alternating order."""
    names = list(fns)
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    samples = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(100_000_000)
            start.record()
            for _ in range(calls):
                fns[name]()
            stop.record()
            stop.synchronize()
            samples[name].append(start.elapsed_time(stop) / calls)
    return {name: statistics.median(v) for name, v in samples.items()}


def rel_err(got, want):
    """Largest |got - want| / max(|want|, tiny), and the largest absolute
    difference (NaN where exactly one of the two is NaN)."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return float('nan'), float('nan')
    ok = ~torch.isnan(want)
    if not ok.any():
        return 0.0, 0.0
    d = (got[ok].double() - want[ok].double()).abs()
    floor = torch.finfo(want.dtype).tiny
    rel = (d / want[ok].double().abs().clamp(min=floor)).max().item()
    return rel, d.max().item()


def plain_ms(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def run(libs, card, cases=TIMED):
    from gsum_tpu_torch.stats._special import betainc_plain, betaincinv_plain

    plain = {'betainc': betainc_plain, 'betaincinv': betaincinv_plain}
    dev = torch.device('cuda:0')
    for which, dtype in cases:
        a, b, u = inputs(which, dtype, dev)
        names = (('betainc', 'betaincinv') if which in ('t', 'beta')
                 else ('betaincinv',))
        for name in names:
            want = plain[name](a, b, u)
            t_plain = plain_ms(plain[name], a, b, u)
            fns, notes = {}, {}
            for label, lib in libs.items():
                got, n_terms, use = lib.lane_use(name, a, b, u)
                bnd = bound_ms(n_terms, u.numel(), dtype)
                notes[label] = (rel_err(got, want)[0], n_terms, use, bnd)
                fns[label] = (lambda lib=lib: lib.call(name, a, b, u))
            times = device_ms(fns)
            for label, ms in times.items():
                err, n_terms, use, bnd = notes[label]
                print(f'[{card}] {name} {which} {tuple(u.shape)} '
                      f'{str(dtype)[6:]} {label}: {ms:.5f} ms a launch, '
                      f'terms {n_terms}, lane use {use:.3f}, bound '
                      f'{bnd[0]:.3e} ms ({bnd[1]}, {bnd[0] / ms:.3%} of '
                      f'it), plain {t_plain:.3f} ms, max rel diff vs plain '
                      f'{err:.3e}')


SWEEP = (1, 8, 32, 64, 128, 256, 512, 1024, 2048, 8192, 20480)


def sweep(lib_so, card):
    """The two forms of this tree's ``betaincinv`` on the first n elements
    of the ``t`` and ``beta`` cases, n in SWEEP, f64 and f32: the time of
    each by size (from which ``ops.incbeta.WARP_MAX`` is chosen), and
    whether the two agree bit for bit."""
    forms = {'warp': Library(lib_so, 1), 'thread': Library(lib_so, 0)}
    dev = torch.device('cuda:0')
    for dtype in (torch.float64, torch.float32):
        for which in ('t', 'beta'):
            a, b, u = (v.flatten() for v in inputs(which, dtype, dev))
            for n in SWEEP:
                args = [v[:n].contiguous() for v in (a, b, u)]
                outs = [f.call('betaincinv', *args) for f in forms.values()]
                same = torch.equal(*(o.nan_to_num(nan=2.0) for o in outs))
                times = device_ms({k: (lambda f=f: f.call('betaincinv',
                                                          *args))
                                   for k, f in forms.items()})
                print(f'[{card}] sweep betaincinv {which} {str(dtype)[6:]} '
                      f'n={n}: warp {times["warp"]:.5f} ms, thread '
                      f'{times["thread"]:.5f} ms, warp / thread '
                      f'{times["warp"] / times["thread"]:.3f}, bit for bit '
                      f'{same}')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--earlier', metavar='PATH',
                    help="another version of incbeta.cu to time beside "
                         "this tree's")
    ap.add_argument('--earlier-without-forms', action='store_true',
                    help='the earlier source is from before the two forms')
    args = ap.parse_args()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        this, log = compile_source(_build.CSRC / 'incbeta.cu',
                                   Path(work) / 'this')
        print(f'build this tree: {log}')
        libs = {'warp': Library(this, 1), 'thread': Library(this, 0)}
        if args.earlier:
            so, log = compile_source(Path(args.earlier),
                                     Path(work) / 'earlier')
            print(f'build earlier ({args.earlier}): {log}')
            if args.earlier_without_forms:
                libs['earlier'] = Library(so)
            else:
                libs['earlier, warp'] = Library(so, 1)
                libs['earlier, thread'] = Library(so, 0)
        run(libs, card)
        sweep(this, card)


if __name__ == '__main__':
    main()
