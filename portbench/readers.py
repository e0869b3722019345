"""Helpers the metric readers in ``metrics/`` share. A reader returns
None where its run has nothing for it to read."""
from __future__ import annotations

import numpy as np

from .yardstick import roofline
from .yardstick.trace import launched_within


def join_mean(run, fn):
    """``fn(step)``'s mean over the window's joins."""
    steps = getattr(run.mix, "steps", None)
    if not steps:
        return None
    return sum(fn(s) for s in steps) / len(steps)


def roofline_pct(run, spans: tuple) -> float | None:
    """The verify operation's least time (from its counted work) over the
    device time of every operation, host <-> device copies left out, that
    the program queued inside a tracer span whose name starts with one of
    ``spans``."""
    if run.device_trace is None or run.work is None:
        return None
    within = [s for s in run.prof_spans if s[0].startswith(spans)]
    t = launched_within(run.device_events, run.launches, within,
                        run.prof_window)
    return roofline.share_pct(*run.work, t)


def idle_pct(run) -> float | None:
    """The window's share in which no operation ran on the device."""
    dt = run.device_trace
    if dt is None or dt["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dt["busy_s"] / dt["window_s"])


def span_seconds(run, name: str) -> float:
    return sum(e.get("dur", 0.0) for e in run.spans(name)) / 1e6


def latency_pct_ms(run, q: float) -> float | None:
    if not hasattr(run.mix, "latencies_s"):
        return None
    lat = run.mix.latencies_s()
    return float(np.percentile(lat, q)) * 1e3 if lat.size else None
