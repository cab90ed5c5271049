R"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ``ctypes``.

Every ``*.cu`` file under ``csrc/`` is compiled for Hopper (``sm_90a``), one
``nvcc`` process per file, all started together, and the objects are linked
into one shared library with a plain C interface.  The library's name carries a
hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is.  The build runs at first use, inside the
package's ``build/`` directory (ignored by git).  A failed build raises with
``nvcc``'s output; nothing falls back.

Nothing here runs at import: the CPU tests import every module of the port
on machines that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / 'build'
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = (*ARCH_FLAGS, '-std=c++17', '-O3', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in ('.cu', '.cuh'))


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f'libgsum_kernels-{h.hexdigest()[:16]}.so'


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError('no CUDA toolkit found: the kernels need nvcc '
                           '(set CUDA_HOME to the toolkit)')
    return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def build():
    """Compiles the library unless it is already built.

    Returns ``(path, log)``: ``log`` is nvcc's output (ptxas register and
    shared-memory counts per kernel), empty when nothing was compiled.
    """
    path = library_path()
    if path.exists():
        return path, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = []
        for src in _sources():
            if src.suffix == '.cu':
                cmd = [nvcc, *NVCC_FLAGS, '-c', str(src), '-o',
                       os.path.join(work, src.stem + '.o')]
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        logs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in jobs]
        # link to a private name and rename: a process that builds at the
        # same time never loads a half-written library
        tmp = os.path.join(work, 'lib.so')
        link = [nvcc, *ARCH_FLAGS, '-shared', '-o', tmp,
                *(cmd[-1] for cmd, _, _ in logs)]
        failed = [(cmd, out, rc) for cmd, out, rc in logs if rc]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, proc.stdout + proc.stderr, proc.returncode))
            if proc.returncode:
                failed = logs[-1:]
        if failed:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(
                'exit code %d: %s\n%s' % (rc, ' '.join(cmd), out)
                for cmd, out, rc in failed))
        os.replace(tmp, path)
    return path, ''.join(out for _, out, _ in logs)


@functools.cache
def load():
    """The loaded kernel library (built first if needed)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.gsum_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gsum_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err):
    """Raises if a kernel entry point returned a CUDA error code."""
    if err:
        msg = load().gsum_cuda_error_string(err).decode()
        raise RuntimeError(f'CUDA error {err} at kernel launch: {msg}')
