"""verify_roofline: the verify operation's share of its roofline, in per
cent: its least time on the card (``yardstick/roofline.py``: 2·d
operations a live row pair at the TF32 peak, or each live row of each
lane read once and each emitted member written once at HBM's bandwidth,
whichever is larger) over the device time of everything a wave queues in
its ``query.execute`` spans (the query rows' gather, the E = 1 verify
tile, the compaction; host <-> device copies left out)."""
from portbench.readers import roofline_pct

SPANS = ("query.execute",)


def read(run):
    return roofline_pct(run, SPANS)
