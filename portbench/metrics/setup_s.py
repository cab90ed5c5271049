"""setup_s: seconds from the process's start to the first timed call
(imports, the kernel library's load or build, inputs on the card from the
seed, and one warm-up call of the cell's own shapes)."""


def read(run):
    return run.setup_s
