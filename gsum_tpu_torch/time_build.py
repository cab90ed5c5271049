"""Times the kernel library's build two ways, from nothing, on this machine.

- ``parallel``: what ``_build.build`` does, one ``nvcc -c`` per source, all
  started together, then one link;
- ``single``: one ``nvcc`` command given every source, which compiles them
  one after another and links.

Each build goes into a fresh temporary directory under the package's
git-ignored ``build/``, in the order parallel,
single, single, parallel; the script prints every time and each way's
median.  Run: ``python -m gsum_tpu_torch.time_build`` (needs ``nvcc``, not
a card).
"""
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

from gsum_tpu_torch import _build


def build_parallel(work):
    saved = _build.BUILD_DIR
    _build.BUILD_DIR = Path(work)
    try:
        _build.build()
    finally:
        _build.BUILD_DIR = saved


def build_single(work):
    sources = [str(p) for p in _build._sources() if p.suffix == '.cu']
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-shared',
                           '-o', str(Path(work) / 'lib.so'), *sources],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError('nvcc failed:\n' + proc.stdout + proc.stderr)


def main():
    ways = {'parallel': build_parallel, 'single': build_single}
    times = {name: [] for name in ways}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ('parallel', 'single', 'single', 'parallel'):
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
            t0 = time.perf_counter()
            ways[name](work)
            times[name].append(time.perf_counter() - t0)
        print(f'build {name}: {times[name][-1]:.2f} s')
    for name, t in times.items():
        print(f'build {name}: median {statistics.median(t):.2f} s of {t}')


if __name__ == '__main__':
    main()
