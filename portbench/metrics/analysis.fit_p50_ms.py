"""analysis.fit_p50_ms: median over the window's analyses of the span
around ``TruncationGP.fit``, synchronized (host clock)."""
import numpy as np


def read(run):
    values = run.spans.get('fit')
    return float(np.median(values)) * 1e3 if values else None
