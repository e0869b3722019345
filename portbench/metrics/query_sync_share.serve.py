"""query_sync_share: the time in ``device.sync`` spans (the drain thread
blocked on a probed bucket's first fetch until its verify and compaction
have run) over the time in ``serve.wave`` spans, in per cent."""
from portbench.spantime import wave_share_pct


def read(run):
    return wave_share_pct(run, "device.sync")
