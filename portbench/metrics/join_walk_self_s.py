"""join_walk_self_s: the executor walk's own time: each ``join.run``
span's duration less the union of what the other spans on its thread
cover inside it (reads waited for, staging, verify dispatch and
collect), over the window's joins: schedule bookkeeping, evictions,
cache checkouts and the per-edge id copies."""
from portbench.spantime import self_per_join_s


def read(run):
    return self_per_join_s(run, "join.run")
