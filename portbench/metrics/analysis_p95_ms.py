"""analysis_p95_ms: the 95th percentile, over every analysis of the window,
of one observable's wall time: model construction, fit and the 'both'
prediction with its std, synchronized (host clock)."""
import numpy as np


def read(run):
    if run.unit != 'analyses' or not run.window.latencies:
        return None
    return float(np.percentile(run.window.latencies, 95)) * 1e3
