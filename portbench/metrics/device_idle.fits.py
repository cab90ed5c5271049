"""device_idle.fits: the share of the traced window in which nothing ran on
the device (the union of its kernels, copies and fills), in percent."""


def read(run):
    if run.unit != 'fits' or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
