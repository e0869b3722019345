"""device_idle (``device_idle.join``, ``device_idle.serve``, ...): the
share of the traced window, in per cent, in which no operation (kernel,
copy, set) ran on the card."""
from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
