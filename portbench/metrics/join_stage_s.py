"""join_stage_s: the time in ``h2d.stage`` spans (the host's part of a
slab's first touch in ``DeviceSlabPool.operand``: the pinned copy and
the queued H2D copy), over the window's joins."""
from portbench.spantime import per_join_s


def read(run):
    return per_join_s(run, "h2d.stage")
