"""From a traced window to numbers: the device's busy time, the device
operations that took most time, the idle gaps labelled by what the host
was doing, and the device time of the work the host launched inside
given spans.

Inputs are plain lists, so the arithmetic is testable without a card:

- device events: (name, start_ns, end_ns) of every operation the profiler
  saw on the device (kernels, copies, sets), with its correlation id as
  a fourth entry where launches are matched;
- launches: {correlation id: launch_ns}, the runtime calls that queued
  each device operation;
- spans: (name, start_ns, end_ns) of the program's and the harness's
  tracer spans, on every thread, moved onto the profiler's clock;
- the window: (start_ns, end_ns) on the same clock.
"""
from __future__ import annotations

import bisect
import heapq
from collections import defaultdict

NO_SPAN = "(no span open)"


def clip(events, window):
    """Events cut to the window; those outside it dropped."""
    w0, w1 = window
    return [(n, max(s, w0), min(e, w1)) for n, s, e in events
            if e > w0 and s < w1 and min(e, w1) > max(s, w0)]


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, merged [start, end) intervals."""
    out: list[list[int]] = []
    for s, e in sorted((s, e) for _, s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy, window) -> list[tuple[int, int]]:
    """The window's stretches in which no device operation ran."""
    out, t = [], window[0]
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def label_gaps(gap_list, spans) -> dict[str, float]:
    """Idle nanoseconds by the innermost span open (the latest started)
    at each gap's midpoint, on any thread."""
    spans = sorted(spans, key=lambda s: s[1])
    out: dict[str, float] = defaultdict(float)
    active: list = []         # heap of (end, -start, name)
    j = 0
    for g0, g1 in sorted(gap_list):
        mid = (g0 + g1) / 2
        while j < len(spans) and spans[j][1] <= mid:
            name, s, e = spans[j]
            heapq.heappush(active, (e, -s, name))
            j += 1
        while active and active[0][0] <= mid:
            heapq.heappop(active)
        label = min(active, key=lambda a: a[1])[2] if active else NO_SPAN
        out[label] += g1 - g0
    return dict(out)


def reduce(device_events, spans, window) -> dict:
    """busy_s, window_s, the device operations by total time and the idle
    time by label (both lists of [name, seconds], largest first)."""
    ev = clip(device_events, window)
    busy = union(ev)
    by_name: dict[str, float] = defaultdict(float)
    for n, s, e in ev:
        by_name[n] += e - s
    idle = label_gaps(gaps(busy, window), clip(spans, window))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    lab = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=sum(e - s for s, e in busy) / 1e9,
                window_s=(window[1] - window[0]) / 1e9,
                device_ops=[[n, v / 1e9] for n, v in top],
                idle_gaps=[[n, v / 1e9] for n, v in lab])


# host <-> device copies: the transfer layer's, not the launching span's
TRANSFERS = ("Memcpy HtoD", "Memcpy DtoH")


def launched_within(device_events, launches, spans, window) -> float:
    """Device seconds in the window of the operations queued while one of
    ``spans`` was open, on any host thread, host <-> device copies left
    out. An operation counts by its launch, so work a span queued counts
    wherever it runs, and fusing or splitting kernels inside the span
    leaves the count whole."""
    open_ = union(spans)
    starts = [s for s, _ in open_]
    total = 0
    for name, s, e, corr in device_events:
        if name.startswith(TRANSFERS) or corr not in launches:
            continue
        t = launches[corr]
        k = bisect.bisect_right(starts, t) - 1
        if k < 0 or t >= open_[k][1]:
            continue
        for _, s1, e1 in clip([(name, s, e)], window):
            total += e1 - s1
    return total / 1e9
