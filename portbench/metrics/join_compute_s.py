"""join_compute_s: ``timings["compute"]``, the verify engine's time (its syncs included). Mean a join of the window."""
from portbench.readers import join_mean


def read(run):
    return join_mean(run, lambda s: s["timings"]["compute"])
