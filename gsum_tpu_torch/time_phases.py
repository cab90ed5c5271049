"""Times the phases inside the two factorization kernels on the card.

Builds copies of ``csrc/fused_chol.cu`` and ``csrc/chol_inv_block.cu`` into a
temporary directory under the package's git-ignored ``build/``, with the
device clock (``%globaltimer``) read by thread 0 of block 0 after every
barrier that ends a phase, and runs each once after a warm-up:

- the fused blocked Cholesky (K3) at B=16, N=4096, block 256 and 128: the
  time of each column block's history, diagonal and panel phase;
- the diagonal-block kernel (K1) at (16, 128, 128): the first panel's
  diagonal tile (A), then each panel's products below it (B) and its
  rank-32 updates (C, with the next panel's A inside).

The kernels in ``csrc/`` carry no timing code; only these copies do.
Run: ``python -m gsum_tpu_torch.time_phases`` (needs nvcc and a card).
"""
import ctypes
import subprocess
import tempfile
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


def build(work):
    """Compiles each kernel's stamped copy in a directory of its own (the
    diagonal-block routine is stamped only in K1's); returns
    {kernel: loaded library}."""
    libs = {}
    for stem, (source, edited, edits) in EDITS.items():
        d = Path(work) / stem
        d.mkdir()
        srcs = {p.name: p.read_text() for p in _build._sources()}
        for anchor, new in edits:
            if anchor not in srcs[edited]:
                raise RuntimeError(f'{edited} no longer has the line this '
                                   f'script stamps after: {anchor!r}')
            srcs[edited] = srcs[edited].replace(anchor, new, 1)
        for name, text in srcs.items():
            (d / name).write_text(text)
        so = d / f'{stem}.so'
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-shared',
                               '-o', str(so), str(d / source)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError('nvcc failed:\n' + proc.stdout + proc.stderr)
        libs[stem] = ctypes.CDLL(str(so))
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


def main():
    dev = torch.device('cuda:0')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        libs = build(work)
        V, I = ctypes.c_void_p, ctypes.c_int
        k3 = libs['fused_chol'].gsum_fused_chol_f32
        k3.argtypes = [V, V, V, I, I, I, V]
        k1 = libs['chol_inv_block'].gsum_chol_inv_block_f32
        k1.argtypes = [V, V, V, I, I, V]
        for lib in libs.values():
            lib.gsum_read_stamps.argtypes = [V, I]

        gen = torch.Generator(device=dev).manual_seed(0)
        B, N = 16, 4096
        A = torch.randn(B, N, N, device=dev, generator=gen)
        K = torch.matmul(A, A.transpose(-1, -2)).div_(N)
        K.diagonal(dim1=-2, dim2=-1).add_(1.0)
        del A
        L = torch.empty_like(K)
        for blk in (256, 128):
            minvs = K.new_empty((B, N // blk, blk, blk))
            launch(k3, K, L, minvs, B, N, blk)
            nk = N // blk
            d = intervals(libs['fused_chol'], 1 + 3 * nk)
            phases = {'history': d[0::3], 'diagonal': d[1::3],
                      'panel': d[2::3]}
            print(f'K3 ({B}, {N}) block {blk}: total {sum(d):.1f} us; '
                  + ', '.join(f'{k} {sum(v):.1f} us'
                              for k, v in phases.items()))
            for k, v in phases.items():
                print(f'  {k} per column block (us): '
                      + ' '.join(f'{x:.1f}' for x in v))
        del K, L, minvs

        nb = 128
        A = torch.randn(B, nb, nb, device=dev, generator=gen)
        Kb = torch.matmul(A, A.transpose(-1, -2)).div_(nb)
        Kb.diagonal(dim1=-2, dim2=-1).add_(1.0)
        Lb, Mb = torch.empty_like(Kb), torch.empty_like(Kb)
        launch(k1, Kb, Lb, Mb, B, nb)
        d = intervals(libs['chol_inv_block'], 2 + 2 * (nb // 32 - 1) + 1)
        print(f'K1 ({B}, {nb}, {nb}) phases of block 0 (us): A0 {d[0]:.2f}, '
              + ', '.join(f'B{p} {d[1 + 2 * p]:.2f}'
                          + (f' C{p} {d[2 + 2 * p]:.2f}'
                             if 2 + 2 * p < len(d) else '')
                          for p in range(nb // 32))
              + f'; sum {sum(d):.2f}')


if __name__ == '__main__':
    main()
