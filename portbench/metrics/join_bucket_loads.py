"""join_bucket_loads: ``JoinResult.bucket_loads``, the cache schedule's reads. Mean a join of the window."""
from portbench.readers import join_mean


def read(run):
    return join_mean(run, lambda s: s["bucket_loads"])
