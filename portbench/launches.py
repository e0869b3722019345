"""Device operations by the tracer span that queued them, as the
device-trace readers of ``metrics/`` see them: a traced run's spans on
the profiler's clock with their args, and the operations each span
launched. ``yardstick.trace.launched_within`` matches operations to
spans the same way, by launch, but sums them over the union of its spans
with the copies left out; these keep each span and take the operations
that a reader names."""
from __future__ import annotations

import bisect


def spans_with_args(run, name: str) -> list[tuple[int, int, dict]]:
    """(start, end, args) of the run's ``name`` spans on the profiler's
    clock (ns), sorted by start: ``run.prof_spans``, which the harness
    puts on that clock in the order of the tracer's X events, beside
    those events' args. Empty in a run without a device trace."""
    xs = [e for e in run.events
          if e.get("ph") == "X" and e.get("name") != "bench.window"]
    if len(xs) != len(run.prof_spans):
        return []
    return sorted(((s, e, x.get("args") or {})
                   for x, (n, s, e) in zip(xs, run.prof_spans) if n == name),
                  key=lambda span: span[:2])


def launched_in(run, spans, prefix: str) -> list[tuple[int, int]]:
    """(index into ``spans``, device ns) of each device operation whose
    name starts with ``prefix`` and whose launch (the runtime call that
    queued it) fell inside one of ``spans``, counted whole wherever it
    ran. ``spans`` as ``spans_with_args`` gives them, none inside
    another, as one thread records them."""
    starts = [s for s, _, _ in spans]
    out = []
    for name, s, e, corr in run.device_events:
        t = run.launches.get(corr)
        if t is None or not name.startswith(prefix):
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t < spans[k][1]:
            out.append((k, e - s))
    return out
