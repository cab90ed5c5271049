"""lml_evals_per_s: (θ, ratio) log-likelihood values of every surface
completed in the window, over the window's wall time (host clock)."""


def read(run):
    if run.unit != 'evals':
        return None
    return run.window.units / run.window.seconds
