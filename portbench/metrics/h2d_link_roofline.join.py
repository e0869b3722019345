"""h2d_link_roofline: the first-touch copies' share of the host link's
peak, in per cent: the bytes of the ``h2d.stage`` spans (their ``bytes``
arg, the padded slab that a first touch puts on the card) over the
device time of the host-to-device copies launched inside them, over the
link's peak.

The peak is PCIe 5.0 x16 in one direction, the H100 SXM's host link:
32 GT/s x 16 lanes x 128/130 (the 128b/130b encoding) / 8 bits, 63.0
GB/s. A copy counts by its launch and whole (``launches.launched_in``).
A span whose copy the profiler did not record adds no bytes, so a missed
copy cannot push the share up. None without a device trace or without a
copy inside such a span."""
from portbench.launches import launched_in, spans_with_args

PEAK_H2D_BYTE_S = 32e9 * 16 * 128 / 130 / 8
SPAN = "h2d.stage"
COPY = "Memcpy HtoD"


def read(run):
    if run.device_trace is None:
        return None
    spans = [s for s in spans_with_args(run, SPAN) if "bytes" in s[2]]
    copies = launched_in(run, spans, COPY)
    ns = sum(t for _, t in copies)
    if not ns:
        return None
    nbytes = sum(spans[k][2]["bytes"] for k in {k for k, _ in copies})
    return 100.0 * nbytes / (ns / 1e9) / PEAK_H2D_BYTE_S
