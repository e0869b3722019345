"""Span time as the span readers of ``metrics/`` see it: a span's seconds
a join of the window, a span's share of the waves' time, and a span's
self time (its duration less what other spans on its thread cover
inside it). Each returns None where the run recorded no such span."""
from __future__ import annotations

import bisect
from collections import defaultdict

from .readers import span_seconds


def _joins(run) -> int:
    return len(getattr(run.mix, "steps", None) or ())


def per_join_s(run, name: str) -> float | None:
    """Seconds in ``name`` spans over the window's joins."""
    n = _joins(run)
    if not n or not run.spans(name):
        return None
    return span_seconds(run, name) / n


def wave_share_pct(run, name: str) -> float | None:
    """Seconds in ``name`` spans over seconds in ``serve.wave`` spans, in
    per cent (the denominator of ``query_plan_share``)."""
    waves = span_seconds(run, "serve.wave")
    if not waves or not run.spans(name):
        return None
    return 100.0 * span_seconds(run, name) / waves


def _covered(intervals) -> float:
    """Length of the union of [start, end) intervals sorted by start."""
    total, end = 0.0, float("-inf")
    for s, e in intervals:
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def self_us(events: list[dict], name: str) -> list[float]:
    """For each ``name`` span, its duration in µs less the union of the
    intervals that the other spans starting inside it on the same thread
    cover there (its children, nested or overlapping, cut at its end)."""
    by_tid = defaultdict(list)
    for e in events:
        if e.get("ph") == "X":
            by_tid[e["tid"]].append(e)
    out = []
    for spans in by_tid.values():
        spans.sort(key=lambda e: e["ts"])
        starts = [e["ts"] for e in spans]
        for p in spans:
            if p["name"] != name:
                continue
            t0, t1 = p["ts"], p["ts"] + p["dur"]
            lo = bisect.bisect_left(starts, t0)
            hi = bisect.bisect_left(starts, t1)
            # a span that began at the same time and outlasts this one
            # encloses it: not a child
            kids = [(c["ts"], min(c["ts"] + c["dur"], t1))
                    for c in spans[lo:hi] if c is not p
                    and not (c["ts"] == t0 and c["dur"] > p["dur"])]
            out.append(p["dur"] - _covered(kids))
    return out


def self_per_join_s(run, name: str) -> float | None:
    """Self seconds of ``name`` spans over the window's joins."""
    n = _joins(run)
    own = self_us(run.events, name)
    if not n or not own:
        return None
    return sum(own) / 1e6 / n
