"""join_orchestration_s: the join's ``timings["orchestration"]``: the bucket graph and ``JoinExecutor.plan`` (edge schedule, Belady simulation). Mean a join of the window."""
from portbench.readers import join_mean


def read(run):
    return join_mean(run, lambda s: s["timings"]["orchestration"])
