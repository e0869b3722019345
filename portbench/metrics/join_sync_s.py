"""join_sync_s: the time in ``device.sync`` spans (the device engine's
collect blocked on a batch's first fetch until its kernels have run, an
overflow's re-compaction and second fetch included), over the window's
joins."""
from portbench.spantime import per_join_s


def read(run):
    return per_join_s(run, "device.sync")
