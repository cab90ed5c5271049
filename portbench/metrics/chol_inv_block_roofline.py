"""chol_inv_block_roofline: K1's share of its roofline in the traced window,
read from the program's counters: the least time of the blocks K1 factored
(``k1.matrices.<nb>``: blocks of width nb; portbench.counts.bound_chol_inv,
bytes at 3.35 TB/s against operations at 67 TFLOP/s) over the device time
of K1's kernels there, in percent.

Counters are added again at every replay of a captured CUDA graph, which
a probe around the Python call does not see.  The program's launches
(``k1.launches``) must equal the kernels the profiler saw, or nothing is
reported; a program without the width counters reports nothing.
"""
from portbench.counts import bound_chol_inv
from portbench.program_trace import KEY, probe  # noqa: F401

KERNEL = 'chol_inv_block'
PREFIX = 'k1.matrices.'


def read(run):
    seen = run.probes.get(KEY)
    if run.trace is None or not seen or not seen['counters']:
        return None
    counted = seen['counters']
    blocks = {int(k[len(PREFIX):]): n for k, n in counted.items()
              if k.startswith(PREFIX) and n > 0}
    launches = counted.get('k1.launches', 0)
    if not blocks or launches <= 0:
        return None
    seconds, traced = run.trace.op_seconds(KERNEL)
    if traced != launches or seconds <= 0:
        return None
    return 100.0 * sum(bound_chol_inv(n, nb)[0]
                       for nb, n in blocks.items()) / seconds
