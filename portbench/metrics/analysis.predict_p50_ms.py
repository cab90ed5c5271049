"""analysis.predict_p50_ms: median over the window's analyses of the span
around ``TruncationGP.predict(kind='both', return_std=True)``,
synchronized (host clock)."""
import numpy as np


def read(run):
    values = run.spans.get('predict')
    return float(np.median(values)) * 1e3 if values else None
