"""fits_per_s: MAP fits returned by every call completed in the window, over
the window's wall time (host clock; each call ends in a synchronize)."""


def read(run):
    if run.unit != 'fits':
        return None
    return run.window.units / run.window.seconds
