"""k1_roofline: K1's share of its roofline in the traced window: the sum,
over every launch, of the least time its batch needs (portbench.counts.
bound_chol_inv: bytes at 3.35 TB/s against operations at 67 TFLOP/s), over
the device time of K1's kernels there, in percent.

The batch of each launch is read by a probe around the blocked
factorization's call of ``chol_inv_block``; the probe's launches must
equal the kernels the profiler saw, or nothing is reported.
"""
import contextlib

from portbench.counts import bound_chol_inv

KERNEL = 'chol_inv_block'


@contextlib.contextmanager
def probe(run):
    try:
        from gsum_tpu_torch.ops import blockchol
    except ImportError:
        yield
        return
    inner = blockchol.chol_inv_block
    seen = run.probes.setdefault('k1', {'bound_s': 0.0, 'launches': 0})

    def counted(A):
        out = inner(A)
        if A.is_cuda and A.shape[0]:
            seen['bound_s'] += bound_chol_inv(A.shape[0], A.shape[-1])[0]
            seen['launches'] += 1
        return out

    blockchol.chol_inv_block = counted
    try:
        yield
    finally:
        blockchol.chol_inv_block = inner


def read(run):
    seen = run.probes.get('k1')
    if run.trace is None or not seen or not seen['launches']:
        return None
    seconds, launches = run.trace.op_seconds(KERNEL)
    if launches != seen['launches'] or seconds <= 0:
        return None
    return 100.0 * seen['bound_s'] / seconds
