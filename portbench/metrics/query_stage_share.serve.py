"""query_stage_share: the time in ``h2d.stage`` spans (each probed
bucket's pad and the H2D copies of its slab and row index) over the time
in ``serve.wave`` spans, in per cent."""
from portbench.spantime import wave_share_pct


def read(run):
    return wave_share_pct(run, "h2d.stage")
