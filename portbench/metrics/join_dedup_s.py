"""join_dedup_s: the time in ``join.dedup`` spans (``JoinExecutor.run``
after its walk: the engine's results concatenated and ``dedup_pairs``),
over the window's joins."""
from portbench.spantime import per_join_s


def read(run):
    return per_join_s(run, "join.dedup")
