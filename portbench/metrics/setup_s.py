"""setup_s: from the process's start to the first timed step: inputs,
ε, the index build, on a checkout's first run the kernels' build, and
the warm-up of the cell's traffic."""


def read(run):
    return run.setup_s
