"""Chrome-trace export + programmatic trace analysis.

``export_chrome_trace`` writes the Trace Event Format JSON that Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing`` load directly;
``validate_chrome_trace`` is the schema check CI and tests run against
every exported file.

``TraceAnalysis`` computes, **from spans alone**, the quantities the
pipeline's claims are made of:

  * per-stage wall breakdown (``wall_breakdown``): span count, summed
    duration, and *busy* time (union of intervals — concurrent spans of
    one stage counted once);
  * pairwise overlap (``overlap_seconds`` / ``hidden_fraction``): how
    much of stage A's time coincided with stage B. The fig19 "read time
    hidden under verification" claim is
    ``hidden_fraction("io.read", "io.wait")`` — read time not covered by
    executor stall time — and must agree with
    ``PipelineStats``' counter-derived ``overlap_efficiency``;
  * critical-path attribution (``critical_path``): every instant of the
    trace's wall clock attributed to exactly one stage (first active
    name in priority order), so "where did the time go" sums to the
    wall time instead of double-counting overlapped stages.

Name specs: everywhere a span name is accepted, ``"verify.*"`` matches
by prefix and a list/tuple unions several specs.
"""
from __future__ import annotations

import bisect
import json
import warnings
from typing import Iterable

_PHASES = frozenset("XiICbensftMOP")  # common Trace Event Format phases


def export_chrome_trace(tracer, path: str) -> str:
    """Write ``tracer``'s events as Chrome-trace JSON → ``path``.

    Warns when the tracer's rings wrapped (``tracer.dropped > 0``): the
    exported trace is then missing its oldest events and overlap/critical-
    path numbers derived from it undercount — raise ``ring_capacity``."""
    dropped = getattr(tracer, "dropped", 0)
    if dropped:
        warnings.warn(
            f"trace export is incomplete: {dropped} events were "
            f"overwritten by ring wrap-around; re-run with a larger "
            f"ring_capacity (enable_tracing(ring_capacity=...))",
            stacklevel=2)
    events = tracer.events()
    # thread-name metadata rows make the Perfetto timeline readable
    for tid, tname in sorted(tracer.thread_names().items()):
        events.append({"name": "thread_name", "ph": "M", "pid": events[0][
            "pid"] if events else 0, "tid": tid,
            "ts": 0, "args": {"name": tname}})
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def validate_chrome_trace(source) -> int:
    """Validate Trace Event Format structure; returns the event count.

    ``source`` is a path, a loaded trace dict (``{"traceEvents": [...]}``)
    or a bare event list. Raises ``ValueError`` on the first violation:
    missing required keys, unknown phase, non-numeric timestamps,
    negative durations, non-dict args, or async events without an id.
    """
    if isinstance(source, str):
        with open(source) as f:
            source = json.load(f)
    if isinstance(source, dict):
        events = source.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("trace JSON must carry a 'traceEvents' list")
    elif isinstance(source, list):
        events = source
    else:
        raise ValueError(f"unsupported trace source {type(source)!r}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for key in ("name", "ph", "pid", "tid", "ts"):
            if key not in ev:
                raise ValueError(f"event {i}: missing required key {key!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i}: non-numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: 'X' event needs dur >= 0")
        if ph in ("b", "e", "n", "s", "f", "t") and "id" not in ev:
            raise ValueError(f"event {i}: async/flow event needs an id")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i}: args must be an object")
    return len(events)


def _merge_intervals(iv: list[tuple[float, float]]
                     ) -> list[tuple[float, float]]:
    if not iv:
        return []
    iv = sorted(iv)
    out = [iv[0]]
    for s, e in iv[1:]:
        ls, le = out[-1]
        if s <= le:
            out[-1] = (ls, max(le, e))
        else:
            out.append((s, e))
    return out


def _intersect(a: list[tuple[float, float]],
               b: list[tuple[float, float]]) -> float:
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


class TraceAnalysis:
    """Stage timing analysis over exported Chrome-trace events.

    Accepts the event list ``Tracer.events()`` returns (or a loaded trace
    document). Only 'X' (span) events carry timing; instants/counters/
    async events are kept for ``async_pairs`` but excluded from the
    interval math. All returned times are **seconds**.
    """

    def __init__(self, events):
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        self.events = events
        self._spans: dict[str, list[tuple[float, float]]] = {}
        self._async: dict[tuple[str, int], list[dict]] = {}
        for ev in events:
            if ev.get("ph") == "X":
                s = ev["ts"] * 1e-6
                self._spans.setdefault(ev["name"], []).append(
                    (s, s + ev.get("dur", 0.0) * 1e-6))
            elif ev.get("ph") in ("b", "e"):
                self._async.setdefault((ev["name"], ev.get("id")),
                                       []).append(ev)
        self._unions: dict[tuple[str, ...], list] = {}

    # -- name specs -----------------------------------------------------------
    def names(self) -> list[str]:
        return sorted(self._spans)

    def _match(self, spec) -> tuple[str, ...]:
        """Resolve a name spec (exact, ``"prefix.*"``, or an iterable of
        specs) to the matching span names, as a canonical tuple."""
        if isinstance(spec, str):
            specs: Iterable[str] = (spec,)
        else:
            specs = tuple(spec)
        names: set[str] = set()
        for s in specs:
            if s.endswith("*"):
                pre = s[:-1]
                names.update(n for n in self._spans if n.startswith(pre))
            elif s in self._spans:
                names.add(s)
        return tuple(sorted(names))

    def _intervals(self, spec) -> list[tuple[float, float]]:
        out: list[tuple[float, float]] = []
        for n in self._match(spec):
            out.extend(self._spans[n])
        return out

    def _union(self, spec) -> list[tuple[float, float]]:
        key = self._match(spec)
        u = self._unions.get(key)
        if u is None:
            u = _merge_intervals([iv for n in key for iv in self._spans[n]])
            self._unions[key] = u
        return u

    # -- stage timing ---------------------------------------------------------
    def count(self, spec) -> int:
        return len(self._intervals(spec))

    def total_seconds(self, spec) -> float:
        """Summed span durations (concurrent spans double-count — this is
        the 'thread-seconds' a stage consumed, e.g. ``read_s``)."""
        return sum(e - s for s, e in self._intervals(spec))

    def busy_seconds(self, spec) -> float:
        """Union length: wall time during which ≥1 span of the stage was
        open (concurrency counted once)."""
        return sum(e - s for s, e in self._union(spec))

    def overlap_seconds(self, spec_a, spec_b) -> float:
        """Wall time during which both stages had an open span
        (|union(A) ∩ union(B)|)."""
        return _intersect(self._union(spec_a), self._union(spec_b))

    def overlap_fraction(self, spec_a, spec_b) -> float:
        """Fraction of stage A's total span time that coincided with
        stage B (0.0 when A recorded nothing)."""
        tot = self.total_seconds(spec_a)
        if tot <= 0:
            return 0.0
        return min(1.0, self.overlap_seconds(spec_a, spec_b) / tot)

    def hidden_fraction(self, spec_a, visible_spec) -> float:
        """Fraction of stage A's time NOT covered by ``visible_spec`` —
        the span-derived analogue of ``PipelineStats.overlap_efficiency``
        when called as ``hidden_fraction("io.read", "io.wait")``: read
        thread-seconds minus the wall time the executor was actually
        stalled, over read thread-seconds. 1.0 when A recorded nothing
        (matching the stats convention for ``read_s == 0``)."""
        tot = self.total_seconds(spec_a)
        if tot <= 0:
            return 1.0
        vis = self.overlap_seconds(spec_a, visible_spec)
        return max(0.0, tot - vis) / tot

    def wall_breakdown(self) -> dict[str, dict]:
        """Per-stage {count, total_s, busy_s}, all recorded span names."""
        return {n: {"count": len(iv),
                    "total_s": sum(e - s for s, e in iv),
                    "busy_s": self.busy_seconds(n)}
                for n, iv in sorted(self._spans.items())}

    def span_bounds(self) -> tuple[float, float]:
        iv = [b for ivs in self._spans.values() for b in ivs]
        if not iv:
            return (0.0, 0.0)
        return (min(s for s, _ in iv), max(e for _, e in iv))

    def critical_path(self, priorities: list | None = None
                      ) -> dict[str, float]:
        """Exclusive wall-time attribution over the trace's span extent.

        Each instant is attributed to the FIRST spec in ``priorities``
        with an open span at that time (default: every recorded name,
        most total time first); instants covered by no span are
        ``"idle"``. Values sum to the span extent — overlap never
        double-counts, which is what makes this a critical-path view:
        a stage only owns the time it was the reason the clock advanced.
        """
        if priorities is None:
            bd = self.wall_breakdown()
            priorities = sorted(bd, key=lambda n: -bd[n]["total_s"])
        unions = [(self._spec_label(p), self._union(p))
                  for p in priorities]
        t0, t1 = self.span_bounds()
        cuts = {t0, t1}
        for _, u in unions:
            for s, e in u:
                cuts.add(max(t0, min(s, t1)))
                cuts.add(max(t0, min(e, t1)))
        edges = sorted(cuts)
        out: dict[str, float] = {label: 0.0 for label, _ in unions}
        out["idle"] = 0.0
        starts = [(label, [s for s, _ in u], u) for label, u in unions]
        for a, b in zip(edges, edges[1:]):
            if b <= a:
                continue
            mid = (a + b) / 2
            owner = "idle"
            for label, ss, u in starts:
                k = bisect.bisect_right(ss, mid) - 1
                if k >= 0 and u[k][1] > mid:
                    owner = label
                    break
            out[owner] += b - a
        return out

    @staticmethod
    def _spec_label(spec) -> str:
        if isinstance(spec, str):
            return spec
        return "|".join(str(s) for s in spec)

    # -- async (request) events -----------------------------------------------
    def async_pairs(self, name: str) -> list[dict]:
        """Matched async begin/end pairs for ``name`` →
        [{id, start_s, end_s, duration_s, args}] (unterminated begins are
        skipped). Serving uses these for request lifetimes that span the
        submitter and drain threads."""
        out = []
        for (n, aid), evs in self._async.items():
            if n != name:
                continue
            begins = sorted((e for e in evs if e["ph"] == "b"),
                            key=lambda e: e["ts"])
            ends = sorted((e for e in evs if e["ph"] == "e"),
                          key=lambda e: e["ts"])
            for b, e in zip(begins, ends):
                args = dict(b.get("args") or {})
                args.update(e.get("args") or {})
                out.append({"id": aid, "start_s": b["ts"] * 1e-6,
                            "end_s": e["ts"] * 1e-6,
                            "duration_s": (e["ts"] - b["ts"]) * 1e-6,
                            "args": args})
        out.sort(key=lambda p: p["start_s"])
        return out

    # -- one-call summary -----------------------------------------------------
    def summary(self) -> dict:
        """JSON-ready digest: stage breakdown, critical path, and the
        pipeline's headline overlap figures (present stages only)."""
        t0, t1 = self.span_bounds()
        d = {
            "span_events": sum(len(v) for v in self._spans.values()),
            "stages": self.wall_breakdown(),
            "wall_s": t1 - t0,
            "critical_path_s": self.critical_path(),
        }
        if "io.read" in self._spans:
            d["read_hidden_fraction"] = self.hidden_fraction("io.read",
                                                             "io.wait")
            d["read_verify_overlap_s"] = self.overlap_seconds(
                "io.read", ("verify.*", "join.run"))
        return d
