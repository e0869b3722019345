"""join_io_wait_s: ``timings["io_wait"]``, the executor's time blocked on bucket reads. Mean a join of the window."""
from portbench.readers import join_mean


def read(run):
    return join_mean(run, lambda s: s["timings"]["io_wait"])
