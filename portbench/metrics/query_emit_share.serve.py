"""query_emit_share: the time in ``query.emit`` spans (a probed bucket's
three result fetches and the per-query accumulation) over the time in
``serve.wave`` spans, in per cent."""
from portbench.spantime import wave_share_pct


def read(run):
    return wave_share_pct(run, "query.emit")
