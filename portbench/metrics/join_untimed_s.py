"""join_untimed_s: a join step's wall time outside the program's ``timings`` (orchestration, execute): opening the session, Gorder in ``DiskJoinIndex._order_for``, ``dedup_pairs``, closing. Mean a join of the window."""
from portbench.readers import join_mean


def read(run):
    return join_mean(run, lambda s: s["wall_s"] - s["timings"]["orchestration"] - s["timings"]["execute"])
