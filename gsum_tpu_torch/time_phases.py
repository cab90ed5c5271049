"""Times the phases inside the kernels on the card.

Sections (all by default, or those named on the command line):

``k3`` and ``k1``: builds copies of ``csrc/fused_chol.cu`` and ``csrc/chol_inv_block.cu`` into a
temporary directory under the package's git-ignored ``build/``, with the
device clock (``%globaltimer``) read by thread 0 of block 0 after every
barrier that ends a phase, and runs each once after a warm-up:

- the fused blocked Cholesky (K3) at B=16, N=4096, block 256 and 128: the
  time of each column block's history, diagonal and panel phase;
- the diagonal-block kernel (K1) at (16, 128, 128): the first panel's
  diagonal tile (A), then each panel's products below it (B) and its
  rank-32 updates (C, with the next panel's A inside).

``k2``: the tiled covariance kernel (K2) at (16, 4096, 2) f32, beside
copies of ``csrc/rbf_cov.cu`` edited into probes of its parts: *store only*
(the same tiles and stores, writing a constant), *compute only* (everything
but the stores, one sum a thread kept by a store that never happens) and
the design's alternatives, and beside ``torch.Tensor.fill_`` of the same
1 GiB, the practical rate of writing it.  ``--k2-earlier PATH`` adds the
same probes of another version of the source (an earlier tree's
``rbf_cov.cu``) to the same alternation.  CUDA-event medians.

The kernels in ``csrc/`` carry no timing code; only these copies do.
Run: ``python -m gsum_tpu_torch.time_phases [k3] [k1] [k2]`` (needs nvcc
and a card).
"""
import argparse
import ctypes
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from gsum_tpu_torch import _build

STAMP = r'''
__device__ unsigned long long g_stamp[4096];
__device__ __forceinline__ void stamp(int& i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamp[i] = t;
  }
  ++i;
}
extern "C" int gsum_read_stamps(unsigned long long* out, int n) {
  return cudaMemcpyFromSymbol(out, g_stamp, n * sizeof(unsigned long long));
}
'''

# per kernel: (source compiled, file edited, [(anchor, replacement)]); the
# anchors are lines of the kernels' code
EDITS = {
    'chol_inv_block': ('chol_inv_block.cu', 'chol_inv_block.cuh', [
        ('#pragma once\n', '#pragma once\n' + STAMP),
        ('  if (warp == 0) panel_diagonal(W, ldw, M, ldm, 0, Xs, nb);\n'
         '  __syncthreads();\n',
         '  int si = 0;\n  stamp(si);\n'
         '  if (warp == 0) panel_diagonal(W, ldw, M, ldm, 0, Xs, nb);\n'
         '  __syncthreads();\n  stamp(si);\n'),
        ('    __syncthreads();\n    if (nq == 0) break;\n',
         '    __syncthreads();\n    stamp(si);\n    if (nq == 0) break;\n'),
        ('      panel_diagonal(W, ldw, M, ldm, e, Xs, nb);\n    }\n'
         '    __syncthreads();\n',
         '      panel_diagonal(W, ldw, M, ldm, e, Xs, nb);\n    }\n'
         '    __syncthreads();\n    stamp(si);\n')]),
    'fused_chol': ('fused_chol.cu', 'fused_chol.cu', [
        ('#include "chol_inv_block.cuh"\n',
         '#include "chol_inv_block.cuh"\n' + STAMP),
        ('  float acc[kTM][kTN];\n\n  for (int k = 0; k < nb; ++k) {\n',
         '  float acc[kTM][kTN];\n  int si = 0;\n  stamp(si);\n\n'
         '  for (int k = 0; k < nb; ++k) {\n'),
        ('    grid.sync();\n\n    // (b)',
         '    grid.sync();\n    stamp(si);\n\n    // (b)'),
        ('    grid.sync();\n\n    // (c)',
         '    grid.sync();\n    stamp(si);\n\n    // (c)'),
        ('      grid.sync();\n    }\n  }\n}\n',
         '      grid.sync();\n    }\n    stamp(si);\n  }\n}\n')]),
}


K2_SHAPE = (16, 4096, 2)
K2_LS, K2_AMP, K2_NOISE = 0.25, 1.0, 1e-2

# Lines of the persistent symmetric design (csrc/rbf_cov.cu) that its
# probes edit: the test for a full aligned tile, and the end of the kernel.
K2_FULL = '    if (vec && i0 + kT <= n && j0 + kT <= n) {\n'
K2_END = (
    '            if (I != J) __stcs(Km + static_cast<size_t>(j) * n + i, acc[u][v]);\n'
    '          }\n'
    '        }\n'
    '    }\n'
    '  }\n')

# The other store candidate: each full tile and its transpose are written
# into one of two shared-memory buffers (rows padded, 16-byte aligned), then
# sent out row by row with bulk copies (cp.async.bulk, shared to global)
# that drain while the block computes its next tile; a buffer is refilled
# once the copies from it have been read.  Staging holds 8 dimensions at a
# time so that three blocks fit on an SM.
K2_BULK = [
    ('constexpr int kDs = 32; ', 'constexpr int kDs = 8; '),
    ('  __shared__ T xs[2][kT * kDs];',
     '  extern __shared__ __align__(16) unsigned char dyn[];\n'
     '  constexpr int kP = kT + 16 / sizeof(T);\n'
     '  T (*tb)[2][kT][kP] = reinterpret_cast<T (*)[2][kT][kP]>(dyn);\n'
     '  int buf = 0;\n'
     '  __shared__ T xs[2][kT * kDs];'),
    (K2_FULL,
     K2_FULL +
     '      if (threadIdx.x < 2 * kT)   // the copies from buf have been read\n'
     '        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");\n'
     '      __syncthreads();\n'
     '#pragma unroll\n'
     '      for (int u = 0; u < 4; ++u)\n'
     '#pragma unroll\n'
     '        for (int v = 0; v < 4; ++v) {\n'
     '          tb[buf][0][at<W>(ty, u)][at<W>(tx, v)] = acc[u][v];\n'
     '          tb[buf][1][at<W>(tx, v)][at<W>(ty, u)] = acc[u][v];\n'
     '        }\n'
     '      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");\n'
     '      __syncthreads();\n'
     '      if (threadIdx.x < (I != J ? 2 : 1) * kT) {\n'
     '        const int h = threadIdx.x / kT, row = threadIdx.x % kT;\n'
     '        T* g = h == 0 ? Km + static_cast<size_t>(i0 + row) * n + j0\n'
     '                      : Km + static_cast<size_t>(j0 + row) * n + i0;\n'
     '        const unsigned sa = static_cast<unsigned>(\n'
     '            __cvta_generic_to_shared(&tb[buf][h][row][0]));\n'
     '        asm volatile(\n'
     '            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"\n'
     '            :: "l"(g), "r"(sa), "n"(kT * sizeof(T)) : "memory");\n'
     '      }\n'
     '      if (threadIdx.x < 2 * kT)\n'
     '        asm volatile("cp.async.bulk.commit_group;" ::: "memory");\n'
     '      buf ^= 1;\n'
     '    } else if (false) {\n'),
    (K2_END + '}\n',
     K2_END + '  if (threadIdx.x < 2 * kT)\n'
              '    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");\n}\n'),
    ('  int dev = 0, sms = 0, per_sm = 0;\n',
     '  constexpr size_t kSmem = 4 * kT * (kT + 16 / sizeof(T)) * sizeof(T);\n'
     '  int dev = 0, sms = 0, per_sm = 0;\n'),
    ('    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n'
     '        &per_sm, rbf_cov_kernel<T>, kThreads, 0);\n',
     '    err = cudaFuncSetAttribute(rbf_cov_kernel<T>,\n'
     '        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);\n'
     '  if (err == cudaSuccess)\n'
     '    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n'
     '        &per_sm, rbf_cov_kernel<T>, kThreads, kSmem);\n'),
    ('<<<grid, kThreads, 0, ', '<<<grid, kThreads, kSmem, ')]

# K2's probes for each design of rbf_cov.cu, told apart by a line that only
# that design has: {design: (marker, {probe: (writes K, [(anchor, new)])})}.
# A probe that writes K is held to the kernel's K bit for bit.
K2_PROBES = {
    'persistent symmetric tiles': ('const T* xj = xs[I != J];', {
        'store only': (False, [
            ('    for (int k0 = 0; k0 < d; k0 += kDs) {\n',
             '    for (int k0 = 0; k0 < 0; k0 += kDs) {\n'),
            ('        acc[u][v] = rbf(acc[u][v], amp);\n',
             '        acc[u][v] = amp;\n')]),
        'compute only': (False, [
            ('  const long long tiles = per * batch;\n',
             '  const long long tiles = per * batch;\n  T sink = 0;\n'),
            (K2_FULL, '#pragma unroll\n    for (int u = 0; u < 16; ++u)\n'
                      '      sink += acc[u / 4][u % 4];\n    if (false) {\n'),
            ('    } else {\n', '    } else if (false) {\n'),
            (K2_END + '}\n', K2_END + '  if (sink == T(-1)) K[0] = sink;\n}\n')]),
        'bulk-copy stores': (True, K2_BULK)}),
    'one block per 32 x 128 tile': ('constexpr int kDc = 8;', {
        'store only': (False, [
            ('  for (int k0 = 0; k0 < d; k0 += kDc) {\n',
             '  for (int k0 = 0; k0 < 0; k0 += kDc) {\n'),
            ('        T val = amp * exp_accurate(T(-0.5) * acc[u][v]);\n',
             '        T val = amp;\n')]),
        'compute only': (False, [
            ('  T acc[4][4];\n', '  T acc[4][4];\n  T sink = 0;\n'),
            ('        Km[static_cast<size_t>(i) * n + j] = val;\n'
             '      }\n    }\n  }\n',
             '        sink += val;\n      }\n    }\n  }\n'
             '  if (sink == T(-1)) Km[0] = sink;\n')])}),
}


def compile_copy(d, source, texts):
    """Writes ``texts`` ({file name: text}) into the new directory ``d``,
    compiles ``source`` among them into a shared library and loads it;
    returns the library and nvcc's output (ptxas register counts)."""
    d.mkdir()
    for name, text in texts.items():
        (d / name).write_text(text)
    so = d / (Path(source).stem + '.so')
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-shared',
                           '-o', str(so), str(d / source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError('nvcc failed:\n' + proc.stdout + proc.stderr)
    return ctypes.CDLL(str(so)), proc.stdout + proc.stderr


def edited(text, edits, what):
    """``text`` with each anchor replaced once; raises if one is missing."""
    for anchor, new in edits:
        if anchor not in text:
            raise RuntimeError(f'{what} no longer has the line this script '
                               f'edits: {anchor!r}')
        text = text.replace(anchor, new, 1)
    return text


def build(work):
    """Compiles each kernel's stamped copy in a directory of its own (the
    diagonal-block routine is stamped only in K1's); returns
    {kernel: loaded library}."""
    libs = {}
    for stem, (source, name, edits) in EDITS.items():
        srcs = {p.name: p.read_text() for p in _build._sources()}
        srcs[name] = edited(srcs[name], edits, name)
        libs[stem], _ = compile_copy(Path(work) / stem, source, srcs)
    return libs


def intervals(lib, n):
    """Microseconds between the first n stamps of the last launch."""
    buf = (ctypes.c_ulonglong * n)()
    _build.check(lib.gsum_read_stamps(buf, n))
    return [(buf[i + 1] - buf[i]) / 1e3 for i in range(n - 1)]


def launch(fn, *args):
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):   # the second run is the one read
        _build.check(fn(*(a.data_ptr() if torch.is_tensor(a) else a
                          for a in args), stream))
    torch.cuda.synchronize()


def phases_k3(lib, dev, gen):
    fn = lib.gsum_fused_chol_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    B, N = 16, 4096
    A = torch.randn(B, N, N, device=dev, generator=gen)
    K = torch.matmul(A, A.transpose(-1, -2)).div_(N)
    K.diagonal(dim1=-2, dim2=-1).add_(1.0)
    del A
    L = torch.empty_like(K)
    for blk in (256, 128):
        minvs = K.new_empty((B, N // blk, blk, blk))
        launch(fn, K, L, minvs, B, N, blk)
        nk = N // blk
        d = intervals(lib, 1 + 3 * nk)
        phases = {'history': d[0::3], 'diagonal': d[1::3], 'panel': d[2::3]}
        print(f'K3 ({B}, {N}) block {blk}: total {sum(d):.1f} us; '
              + ', '.join(f'{k} {sum(v):.1f} us' for k, v in phases.items()))
        for k, v in phases.items():
            print(f'  {k} per column block (us): '
                  + ' '.join(f'{x:.1f}' for x in v))


def phases_k1(lib, dev, gen):
    fn = lib.gsum_chol_inv_block_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    B, nb = 16, 128
    A = torch.randn(B, nb, nb, device=dev, generator=gen)
    Kb = torch.matmul(A, A.transpose(-1, -2)).div_(nb)
    Kb.diagonal(dim1=-2, dim2=-1).add_(1.0)
    Lb, Mb = torch.empty_like(Kb), torch.empty_like(Kb)
    launch(fn, Kb, Lb, Mb, B, nb)
    d = intervals(lib, 2 + 2 * (nb // 32 - 1) + 1)
    print(f'K1 ({B}, {nb}, {nb}) phases of block 0 (us): A0 {d[0]:.2f}, '
          + ', '.join(f'B{p} {d[1 + 2 * p]:.2f}'
                      + (f' C{p} {d[2 + 2 * p]:.2f}'
                         if 2 + 2 * p < len(d) else '')
                      for p in range(nb // 32))
          + f'; sum {sum(d):.2f}')


def alternating_ms(fns, rounds=8, reps=5):
    """CUDA-event time per call of each function in ``fns`` (a dict), in
    ms: the median of ``rounds`` samples of ``reps`` calls, taken in
    alternating order after a warm-up call each."""
    names = list(fns)
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    samples = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[name]()
            stop.record()
            stop.synchronize()
            samples[name].append(start.elapsed_time(stop) / reps)
    return {name: statistics.median(v) for name, v in samples.items()}


def k2_copies(path):
    """{probe: (writes K, source text)} for the K2 source at ``path``: the
    kernel as it is and each probe of its design."""
    text = Path(path).read_text()
    for design, (marker, probes) in K2_PROBES.items():
        if marker in text:
            return design, {'kernel': (True, text), **{
                name: (writes, edited(text, edits, str(path)))
                for name, (writes, edits) in probes.items()}}
    raise RuntimeError(f'{path}: not a K2 design this script knows')


def probes_k2(work, dev, gen, earlier=None):
    B, N, D = K2_SHAPE
    X32 = torch.rand(B, N, D, device=dev, generator=gen)
    args = {'f32': (X32, torch.empty(B, N, N, device=dev)),
            'f64': (X32.double(), torch.empty(B, N, N, device=dev,
                                              dtype=torch.float64))}
    stream = torch.cuda.current_stream().cuda_stream
    copies = {}
    for prefix, path in (('', _build.CSRC / 'rbf_cov.cu'),
                         ('earlier ', earlier)):
        if path is not None:
            design, texts = k2_copies(path)
            copies.update({f'{prefix}{design}: {name}': text
                           for name, text in texts.items()})

    def compile_one(item):
        k, (label, (writes, text)) = item
        return label, writes, compile_copy(
            Path(work) / f'k2-{k}', 'rbf_cov.cu', {'rbf_cov.cu': text})

    fns = {t: {} for t in args}
    with ThreadPoolExecutor() as pool:     # one nvcc per copy, together
        built = list(pool.map(compile_one, enumerate(copies.items())))
    for label, writes, (lib, log) in built:
        print(f'K2 build {label}: ' + '; '.join(
            line.split(': ', 1)[-1].strip() for line in log.splitlines()
            if 'registers' in line))
        for t, (X, K) in args.items():
            fn = getattr(lib, f'gsum_rbf_cov_{t}')
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                           + [ctypes.c_double] * 3 + [ctypes.c_void_p])
            fns[t][label] = (lambda fn=fn, X=X, K=K: _build.check(fn(
                X.data_ptr(), K.data_ptr(), B, N, D, 1.0 / K2_LS, K2_AMP,
                K2_NOISE, stream)))
    for t, (X, K) in args.items():
        want = None
        for label, writes, _ in built:
            if writes:   # the same K as its design's kernel, bit for bit
                K.fill_(float('nan'))
                fns[t][label]()
                if label.endswith(': kernel'):
                    want = K.clone()
                elif not torch.equal(K, want):
                    raise AssertionError(f'{label} does not write the '
                                         f'kernel\'s K in {t}')
        del want
        fns[t][f'torch fill_(1.0) of the same {K.nbytes / 2**30:g} GiB'] = (
            lambda K=K: K.fill_(1.0))
        times = alternating_ms(fns[t])
        bound = (X.nbytes + K.nbytes) / 3.35e12 * 1e3
        for label, ms in times.items():
            print(f'K2 ({B}, {N}, {D}) {t} {label}: {ms:.4f} ms, K written '
                  f'at {K.nbytes / ms / 1e9:.3f} TB/s ({bound / ms:.1%} of '
                  f'the {bound:.4f} ms bound)')


def main():
    ap = argparse.ArgumentParser(
        description='Times the phases inside the kernels on the card.')
    ap.add_argument('sections', nargs='*', metavar='{k3,k1,k2}',
                    help='sections to run (default: all)')
    ap.add_argument('--k2-earlier', metavar='PATH',
                    help="another version of rbf_cov.cu to probe beside "
                         "this tree's")
    args = ap.parse_args()
    sections = set(args.sections or ('k3', 'k1', 'k2'))
    if not sections <= {'k3', 'k1', 'k2'}:
        ap.error(f'unknown sections: {sorted(sections - {"k3", "k1", "k2"})}')
    dev = torch.device('cuda:0')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        if sections & {'k3', 'k1'}:
            libs = build(work)
            for lib in libs.values():
                lib.gsum_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
            if 'k3' in sections:
                phases_k3(libs['fused_chol'], dev, gen)
            if 'k1' in sections:
                phases_k1(libs['chol_inv_block'], dev, gen)
        if 'k2' in sections:
            probes_k2(work, dev, gen, args.k2_earlier)


if __name__ == '__main__':
    main()
