"""verify_roofline: the verify operation's share of its roofline, in per
cent: its least time on the card (``yardstick/roofline.py``: 2·d
operations a live row pair at the TF32 peak, or each live row of each
lane read once and each emitted pair written once at HBM's bandwidth,
whichever is larger) over the device time of everything the engine
queues in its ``verify.*`` spans (the lanes' stack, the verify kernel,
the compaction; host <-> device copies left out)."""
from portbench.readers import roofline_pct

SPANS = ("verify.",)


def read(run):
    return roofline_pct(run, SPANS)
