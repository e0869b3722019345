"""Continuous observability: streaming rollups, SLO burn-rate alerting,
and live cost-model recalibration.

The tracer and the metrics registry make DiskJoin's temporal claims
measurable *after the fact* — export the trace, run the analysis. This
module watches the system *while it runs*, at fixed memory and near-zero
overhead (copied from the JAX package's ``obs/live.py``; plain Python, no
torch: its rollups run in the tracer sink, on whichever thread records
the event, and never touch the card):

  * **``TimeSeries``** — a tracer *sink* (``Tracer.add_sink``) folding
    every recorded event into time-windowed ``RollupWindow`` aggregates:
    per-span counts, summed duration, and a log-bucket duration histogram
    (the same geometric bounds as ``repro_torch.obs.metrics.Histogram``, so
    per-shard windows merge *exactly* — counts add, percentiles are
    re-derived). Async ``b``/``e`` pairs (serving requests) are matched
    into latency samples; ``C`` counter samples and ``i`` instants get
    last/max and count rollups. Windows close as events arrive (or on
    ``poll()``); in-process consumers subscribe to closed windows.
  * **``Slo`` / ``SloMonitor``** — declarative objectives (request p95
    latency, deadline-drop rate, cache hit rate, goodput, io-retry
    budget) evaluated per closed window with Google-SRE-style
    *multi-window burn rates*: an alert fires only when both the fast
    window (catches sharp degradation quickly) and the slow window
    (rejects blips) burn the error budget faster than ``burn_threshold``.
    Structured ``Alert`` records go to callbacks, the tracer (as
    ``slo.alert`` instants) and the metrics snapshot.
  * **``LiveCalibrator``** — rolling medians of span-derived unit costs
    (``io.read`` seconds/bucket, ``link.xfer`` bytes/second) that
    ``CostModel.from_telemetry(..., live=...)`` consumes as the ``live``
    provenance tier: long-running sessions re-price their ``WavePlan``s
    from what the hardware is doing *now*, not what it averaged since
    startup. Plans stay byte-neutral — costs size and place work, never
    change results.

``DiskJoinIndex.attach_live()`` wires all three to a session;
``repro_torch.obs.dash`` renders the result as a one-screen text dashboard.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import statistics
import threading
import time
from collections import deque

from repro_torch.obs.metrics import Histogram, log_bounds

# span arg naming the per-event unit count for unit-cost calibration
# (io.read may serve several coalesced buckets per event; link.xfer
# carries its byte volume)
UNIT_ARGS = {"io.read": "buckets", "link.xfer": "bytes"}
# span args that mark a completion as failed (deadline drops, errors)
BAD_ARGS = ("dropped", "error")
# open async begins kept for pairing; beyond this, oldest are forgotten
_OPEN_CAP = 8192


class _SpanAgg:
    """One span name's fixed-memory rollup inside one window."""

    __slots__ = ("count", "total_s", "units", "bad", "counts",
                 "min", "max")

    def __init__(self, nbuckets: int):
        self.count = 0
        self.total_s = 0.0
        self.units = 0.0       # Σ unit arg (buckets, bytes); count if none
        self.bad = 0           # completions flagged dropped/error
        self.counts = [0] * nbuckets
        self.min = math.inf
        self.max = -math.inf


class RollupWindow:
    """All events folded between ``t0`` and ``t1`` (tracer clock)."""

    __slots__ = ("t0", "t1", "spans", "counters", "instants")

    def __init__(self, t0: float, t1: float):
        self.t0 = t0
        self.t1 = t1
        self.spans: dict[str, _SpanAgg] = {}
        self.counters: dict[str, dict] = {}
        self.instants: dict[str, int] = {}

    @property
    def events(self) -> int:
        return (sum(a.count for a in self.spans.values())
                + sum(c["n"] for c in self.counters.values())
                + sum(self.instants.values()))


class TimeSeries:
    """Fixed-memory streaming rollup over tracer events.

    Install with ``tracer.add_sink(ts.on_event)``. Folding happens on
    the recording thread under one re-entrant lock (windows are shared
    state; tracer rings stay lock-free). Retains the last ``windows``
    closed windows plus the one being filled; a traffic gap fast-forwards
    through (bounded) empty windows so burn rates decay honestly.
    """

    def __init__(self, *, window_s: float = 1.0, windows: int = 60,
                 lo: float = 1e-6, hi: float = 1e4, factor: float = 2.0):
        self.window_s = float(window_s)
        self.retain = max(2, int(windows))
        self.bounds = log_bounds(lo, hi, factor)
        self._nbuckets = len(self.bounds) + 1
        self.windows: deque[RollupWindow] = deque(maxlen=self.retain)
        self.current: RollupWindow | None = None
        # RLock: a subscriber may emit a tracer instant (slo.alert) whose
        # sink delivery re-enters on_event on the same thread
        self._lock = threading.RLock()
        self._subs: list = []
        self._open: dict[tuple, float] = {}
        self.events_folded = 0

    # -- sink (hot path) ------------------------------------------------------
    def on_event(self, ev) -> None:
        ph = ev[0]
        if ph not in ("X", "i", "C", "b", "e"):
            return
        name, ts = ev[1], ev[2]
        with self._lock:
            self._roll(ts)
            w = self.current
            self.events_folded += 1
            if ph == "X":
                self._fold_span(w, name, ev[3], ev[4])
            elif ph == "b":
                if len(self._open) >= _OPEN_CAP:
                    self._open.pop(next(iter(self._open)))
                self._open[(name, ev[5])] = ts
            elif ph == "e":
                t0 = self._open.pop((name, ev[5]), None)
                if t0 is not None:
                    self._fold_span(w, name, ts - t0, ev[4])
            elif ph == "C":
                a = ev[4] or {}
                v = a.get("value", 0)
                ent = w.counters.get(name)
                if ent is None:
                    w.counters[name] = {"last": v, "max": v, "n": 1}
                else:
                    ent["last"] = v
                    if v > ent["max"]:
                        ent["max"] = v
                    ent["n"] += 1
            else:  # instant
                w.instants[name] = w.instants.get(name, 0) + 1

    def _fold_span(self, w: RollupWindow, name: str, dur: float,
                   args) -> None:
        agg = w.spans.get(name)
        if agg is None:
            agg = w.spans[name] = _SpanAgg(self._nbuckets)
        dur = max(0.0, float(dur))
        agg.count += 1
        agg.total_s += dur
        agg.counts[bisect.bisect_left(self.bounds, dur)] += 1
        if dur < agg.min:
            agg.min = dur
        if dur > agg.max:
            agg.max = dur
        unit_arg = UNIT_ARGS.get(name)
        units = 1.0
        if args:
            if unit_arg is not None:
                units = float(args.get(unit_arg) or 1.0)
            if any(args.get(k) for k in BAD_ARGS):
                agg.bad += 1
        agg.units += units

    def _roll(self, ts: float) -> None:
        if self.current is None:
            self.current = RollupWindow(ts, ts + self.window_s)
            return
        steps = 0
        while ts >= self.current.t1:
            if steps > self.retain:
                # gap longer than retention: every retained window is
                # already empty — snap the grid forward instead of
                # looping per elapsed window
                k = math.floor((ts - self.current.t0) / self.window_s)
                t0 = self.current.t0 + k * self.window_s
                if t0 > ts:   # fp rounding over ~k windows can overshoot
                    t0 -= self.window_s
                self.current = RollupWindow(t0, t0 + self.window_s)
                return
            closed = self.current
            self.windows.append(closed)
            self.current = RollupWindow(closed.t1,
                                        closed.t1 + self.window_s)
            steps += 1
            for fn in list(self._subs):
                try:
                    fn(closed)
                except Exception:  # consumers never take the session down
                    pass

    def poll(self, now: float | None = None) -> None:
        """Close overdue windows without waiting for traffic (dashboards
        and tests drive this; the tracer clock is ``time.perf_counter``)."""
        with self._lock:
            if self.current is not None:
                self._roll(time.perf_counter() if now is None else now)

    # -- consumers ------------------------------------------------------------
    def subscribe(self, fn) -> None:
        """``fn(closed_window)`` on every window close, on the folding
        thread. Exceptions are swallowed."""
        with self._lock:
            self._subs.append(fn)

    def unsubscribe(self, fn) -> None:
        with self._lock:
            self._subs = [s for s in self._subs if s != fn]

    # -- aggregate views ------------------------------------------------------
    def recent(self, n: int | None = None) -> list[RollupWindow]:
        """The last ``n`` *closed* windows, oldest first."""
        with self._lock:
            ws = list(self.windows)
        return ws if n is None else ws[-n:]

    def span_aggregate(self, name: str, n: int | None = None
                       ) -> dict | None:
        """Merge one span's rollup over the last ``n`` closed windows →
        histogram-snapshot-shaped dict (plus ``total_s``/``units``/
        ``bad``), or None if the span never fired."""
        merged: _SpanAgg | None = None
        for w in self.recent(n):
            agg = w.spans.get(name)
            if agg is None:
                continue
            if merged is None:
                merged = _SpanAgg(self._nbuckets)
            merged.count += agg.count
            merged.total_s += agg.total_s
            merged.units += agg.units
            merged.bad += agg.bad
            merged.counts = [a + b for a, b in zip(merged.counts,
                                                   agg.counts)]
            merged.min = min(merged.min, agg.min)
            merged.max = max(merged.max, agg.max)
        if merged is None:
            return None
        return self._agg_snapshot(merged)

    def _agg_snapshot(self, agg: _SpanAgg) -> dict:
        pct = Histogram.percentile_from
        return {"count": agg.count, "sum": agg.total_s,
                "total_s": agg.total_s, "units": agg.units,
                "bad": agg.bad,
                "min": agg.min if agg.count else 0.0,
                "max": agg.max if agg.count else 0.0,
                "p50": pct(self.bounds, agg.counts, 50),
                "p95": pct(self.bounds, agg.counts, 95),
                "p99": pct(self.bounds, agg.counts, 99),
                "bounds": list(self.bounds),
                "buckets": list(agg.counts)}

    def rate(self, name: str, n: int | None = None) -> float:
        """Span completions per second over the last ``n`` closed windows."""
        ws = self.recent(n)
        if not ws:
            return 0.0
        total = sum(w.spans[name].count for w in ws if name in w.spans)
        return total / (len(ws) * self.window_s)

    def percentile(self, name: str, q: float,
                   n: int | None = None) -> float:
        agg = self.span_aggregate(name, n)
        if agg is None:
            return 0.0
        return Histogram.percentile_from(self.bounds, agg["buckets"], q)

    def unit_cost_series(self, name: str, n: int | None = None
                         ) -> list[tuple[float, int]]:
        """Per-window ``(seconds-per-unit, sample count)`` for a span,
        oldest first — the calibrator's raw material."""
        out = []
        for w in self.recent(n):
            agg = w.spans.get(name)
            if agg is not None and agg.units > 0:
                out.append((agg.total_s / agg.units, agg.count))
        return out

    def span_names(self, n: int | None = None) -> list[str]:
        names: set[str] = set()
        for w in self.recent(n):
            names.update(w.spans)
        return sorted(names)

    def section(self, n: int | None = None) -> dict:
        """JSON-able rollup of the retained windows — the ``live``
        provider payload in ``metrics_snapshot()``. Mergeable across
        shards with ``merge_live_sections`` (exact histogram merge)."""
        ws = self.recent(n)
        spans = {name: self.span_aggregate(name, n)
                 for name in self.span_names(n)}
        counters: dict[str, dict] = {}
        instants: dict[str, int] = {}
        for w in ws:
            for name, ent in w.counters.items():
                cur = counters.get(name)
                if cur is None:
                    counters[name] = dict(ent)
                else:
                    cur["last"] = ent["last"]
                    cur["max"] = max(cur["max"], ent["max"])
                    cur["n"] += ent["n"]
            for name, cnt in w.instants.items():
                instants[name] = instants.get(name, 0) + cnt
        return {"window_s": self.window_s, "windows": len(ws),
                "events": sum(w.events for w in ws),
                "spans": spans, "counters": counters,
                "instants": instants}

    def fraction_leq(self, name: str, threshold_s: float,
                     window: RollupWindow) -> tuple[int, int]:
        """(samples ≤ threshold, total samples) for one span in one
        window, at bucket resolution: a bucket counts as "good" when its
        geometric midpoint is ≤ the threshold."""
        agg = window.spans.get(name)
        if agg is None or agg.count == 0:
            return 0, 0
        good = 0
        for i, c in enumerate(agg.counts):
            if not c:
                continue
            if i == 0:
                mid = self.bounds[0]
            elif i >= len(self.bounds):
                mid = self.bounds[-1]
            else:
                mid = math.sqrt(self.bounds[i - 1] * self.bounds[i])
            if mid <= threshold_s:
                good += c
        return good, agg.count


# -- SLOs ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Slo:
    """One declarative objective: "at least ``objective`` of the events
    must be good", where *good* depends on ``kind``:

      * ``latency``   — span ``span`` samples ≤ ``threshold_s``
      * ``bad_fraction`` — span completions not flagged dropped/error
      * ``pipeline_ratio`` — Δ``good_fields`` / Δ``total_fields`` over
        the window (or ``1 − Δbad/Δtotal`` when ``bad_fields`` is set),
        from the session's ``PipelineStats`` counter deltas

    Burn rate over a window span = (1 − good fraction) / (1 − objective);
    1.0 means the error budget is being spent exactly at the sustainable
    rate. The alert fires when BOTH the fast (last ``fast_windows``) and
    the slow (last ``slow_windows``) burn rates are ≥ ``burn_threshold``,
    and resolves when the fast one recovers below it.
    """

    name: str
    objective: float
    kind: str
    span: str | None = None
    threshold_s: float | None = None
    good_fields: tuple = ()
    bad_fields: tuple = ()
    total_fields: tuple = ()
    fast_windows: int = 3
    slow_windows: int = 12
    burn_threshold: float = 4.0

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), "
                             f"got {self.objective}")
        if self.kind not in ("latency", "bad_fraction", "pipeline_ratio"):
            raise ValueError(f"unknown Slo kind {self.kind!r}")
        if self.kind == "latency" and (self.span is None
                                       or self.threshold_s is None):
            raise ValueError("latency Slo needs span and threshold_s")
        if self.kind == "bad_fraction" and self.span is None:
            raise ValueError("bad_fraction Slo needs span")
        if self.kind == "pipeline_ratio":
            if not self.total_fields or not (bool(self.good_fields)
                                             ^ bool(self.bad_fields)):
                raise ValueError("pipeline_ratio Slo needs total_fields "
                                 "and exactly one of good_fields/"
                                 "bad_fields")
        if self.fast_windows > self.slow_windows:
            raise ValueError("fast_windows must be ≤ slow_windows")

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def latency(name: str, span: str, threshold_s: float,
                objective: float = 0.95, **kw) -> "Slo":
        """"``objective`` of ``span`` samples complete within
        ``threshold_s``" — e.g. a serve p95 latency objective."""
        return Slo(name, objective, "latency", span=span,
                   threshold_s=threshold_s, **kw)

    @staticmethod
    def drop_rate(name: str, span: str = "serve.request",
                  objective: float = 0.99, **kw) -> "Slo":
        """"``objective`` of requests complete un-dropped" (deadline
        drops and errors both count against the budget)."""
        return Slo(name, objective, "bad_fraction", span=span, **kw)

    @staticmethod
    def ratio(name: str, good_fields, total_fields, objective: float,
              **kw) -> "Slo":
        """Pipeline-counter ratio objective, e.g. warm-cache hit rate:
        Δgood / Δtotal ≥ objective per window."""
        return Slo(name, objective, "pipeline_ratio",
                   good_fields=tuple(good_fields),
                   total_fields=tuple(total_fields), **kw)

    @staticmethod
    def budget_rate(name: str, bad_fields, total_fields,
                    objective: float, **kw) -> "Slo":
        """Pipeline-counter *budget* objective, e.g. io_retries:
        1 − Δbad/Δtotal ≥ objective per window."""
        return Slo(name, objective, "pipeline_ratio",
                   bad_fields=tuple(bad_fields),
                   total_fields=tuple(total_fields), **kw)


def default_serving_slos(latency_threshold_s: float = 0.25,
                         availability: float = 0.99,
                         hit_rate: float = 0.5,
                         goodput: float = 0.9,
                         retry_budget: float = 0.01) -> tuple:
    """The serving objectives a fresh ``attach_live()`` watches."""
    return (
        Slo.latency("serve_p95_latency", "serve.request",
                    latency_threshold_s, objective=0.95),
        Slo.drop_rate("serve_availability", objective=availability),
        Slo.ratio("cache_hit_rate", ("query_warm_hits",),
                  ("query_warm_hits", "query_reads",
                   "query_fallback_reads"), objective=hit_rate),
        Slo.budget_rate("serve_goodput", ("deadline_drops",),
                        ("queries", "deadline_drops"),
                        objective=goodput),
        Slo.budget_rate("io_retry_budget", ("io_retries",),
                        ("loads", "query_reads", "query_fallback_reads"),
                        objective=1.0 - retry_budget),
    )


@dataclasses.dataclass
class Alert:
    """One SLO state transition (``firing`` or ``resolved``)."""

    slo: str
    state: str
    t: float                 # window close time (tracer clock)
    fast_burn: float
    slow_burn: float
    good_fraction: float | None
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SloMonitor:
    """Evaluates ``Slo`` specs on every closed window of a ``TimeSeries``.

    ``pipeline_source`` (a ``PipelineStats.snapshot`` callable) feeds the
    counter-delta objectives; per-window deltas are diffed here so the
    cumulative counters never dilute a fresh regression. Alerts go to
    ``on_alert`` callbacks, the ``tracer`` as ``slo.alert`` instants, and
    ``metrics`` counters (``slo.alerts_fired``/``slo.alerts_resolved``,
    gauge ``slo.firing``).
    """

    def __init__(self, timeseries: TimeSeries, slos, *,
                 pipeline_source=None, tracer=None, metrics=None,
                 on_alert=None, history: int = 256):
        self.ts = timeseries
        self.slos = list(slos)
        self._pipeline_source = pipeline_source
        self._tracer = tracer
        self._metrics = metrics
        self._cbs = [on_alert] if on_alert is not None else []
        self._lock = threading.RLock()
        self._prev_pipe = self._numeric(pipeline_source()) \
            if pipeline_source else None
        depth = max([s.slow_windows for s in self.slos] or [1])
        self._entries: deque = deque(maxlen=depth)
        self._state = {s.name: {"firing": False, "since": None,
                                "fast_burn": 0.0, "slow_burn": 0.0,
                                "good_fraction": None}
                       for s in self.slos}
        self.alerts: deque[Alert] = deque(maxlen=history)
        self.fired = 0
        self.resolved = 0
        timeseries.subscribe(self._on_window)

    @staticmethod
    def _numeric(snap: dict) -> dict:
        return {k: v for k, v in snap.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)}

    def close(self) -> None:
        self.ts.unsubscribe(self._on_window)

    def on_alert(self, fn) -> None:
        """Add an alert callback (``fn(Alert)``)."""
        with self._lock:
            self._cbs.append(fn)

    # -- evaluation (window-close cadence) ------------------------------------
    def _on_window(self, window: RollupWindow) -> None:
        delta = None
        if self._pipeline_source is not None:
            snap = self._numeric(self._pipeline_source())
            prev, self._prev_pipe = self._prev_pipe, snap
            delta = {k: v - prev.get(k, 0) for k, v in snap.items()}
        with self._lock:
            self._entries.append((window, delta))
            for slo in self.slos:
                self._evaluate(slo, window)

    def _good_total(self, slo: Slo, window: RollupWindow,
                    delta: dict | None) -> tuple[float, float]:
        if slo.kind == "latency":
            return self.ts.fraction_leq(slo.span, slo.threshold_s, window)
        if slo.kind == "bad_fraction":
            agg = window.spans.get(slo.span)
            if agg is None:
                return 0, 0
            return agg.count - agg.bad, agg.count
        if delta is None:
            return 0, 0
        total = sum(delta.get(f, 0) for f in slo.total_fields)
        if total <= 0:
            return 0, 0
        if slo.good_fields:
            good = sum(delta.get(f, 0) for f in slo.good_fields)
        else:
            good = total - sum(delta.get(f, 0) for f in slo.bad_fields)
        return max(0.0, min(good, total)), total

    def _burn(self, slo: Slo, n: int) -> tuple[float, float | None]:
        """(burn rate, good fraction) over the last ``n`` entries. No
        traffic ⇒ burn 0 (idle systems don't spend error budget)."""
        good = total = 0.0
        for window, delta in list(self._entries)[-n:]:
            g, t = self._good_total(slo, window, delta)
            good += g
            total += t
        if total <= 0:
            return 0.0, None
        frac = good / total
        return (1.0 - frac) / (1.0 - slo.objective), frac

    def _evaluate(self, slo: Slo, window: RollupWindow) -> None:
        fast, frac = self._burn(slo, slo.fast_windows)
        slow, _ = self._burn(slo, slo.slow_windows)
        st = self._state[slo.name]
        st["fast_burn"], st["slow_burn"] = fast, slow
        st["good_fraction"] = frac
        thr = slo.burn_threshold
        if not st["firing"] and fast >= thr and slow >= thr:
            st["firing"] = True
            st["since"] = window.t1
            self.fired += 1
            if self._metrics is not None:
                self._metrics.counter("slo.alerts_fired").inc()
            self._emit(slo, "firing", window, fast, slow, frac)
        elif st["firing"] and fast < thr:
            st["firing"] = False
            st["since"] = None
            self.resolved += 1
            if self._metrics is not None:
                self._metrics.counter("slo.alerts_resolved").inc()
            self._emit(slo, "resolved", window, fast, slow, frac)
        if self._metrics is not None:
            firing = sum(1 for s in self._state.values() if s["firing"])
            self._metrics.gauge("slo.firing").set(firing)

    def _emit(self, slo: Slo, state: str, window: RollupWindow,
              fast: float, slow: float, frac: float | None) -> None:
        msg = (f"SLO {slo.name} {state}: burn fast={fast:.2f} "
               f"slow={slow:.2f} (threshold {slo.burn_threshold:g}, "
               f"objective {slo.objective:g})")
        alert = Alert(slo.name, state, window.t1, fast, slow, frac, msg)
        self.alerts.append(alert)
        if self._tracer is not None:
            self._tracer.instant("slo.alert", slo=slo.name, state=state,
                                 fast_burn=round(fast, 3),
                                 slow_burn=round(slow, 3))
        for fn in list(self._cbs):
            try:
                fn(alert)
            except Exception:
                pass

    # -- views ----------------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            out = {}
            for slo in self.slos:
                st = self._state[slo.name]
                out[slo.name] = {
                    "state": "firing" if st["firing"] else "ok",
                    "objective": slo.objective,
                    "fast_burn": st["fast_burn"],
                    "slow_burn": st["slow_burn"],
                    "good_fraction": st["good_fraction"],
                    "since": st["since"],
                }
            return out

    def active_alerts(self) -> list[dict]:
        with self._lock:
            return [{"slo": name, "since": st["since"],
                     "fast_burn": st["fast_burn"],
                     "slow_burn": st["slow_burn"]}
                    for name, st in self._state.items() if st["firing"]]

    def section(self) -> dict:
        return {"slos": self.status(),
                "alerts": {"fired": self.fired,
                           "resolved": self.resolved,
                           "active": self.active_alerts()}}


# -- live cost calibration ----------------------------------------------------

class LiveCalibrator:
    """Rolling span-derived unit costs for ``CostModel``'s ``live`` tier.

    Per closed window, the rollup already holds each span's summed
    duration and unit count; the calibrator takes the *median* of the
    per-window seconds-per-unit ratios over the last ``windows`` windows
    — robust to one outlier window, O(windows) memory, and quick to
    converge after a regime shift (a stale window falls out of the
    median after ``windows`` closes, where a cumulative mean would
    remember it forever).
    """

    READ_SPAN = "io.read"
    XFER_SPAN = "link.xfer"

    def __init__(self, timeseries: TimeSeries, *, windows: int = 8,
                 min_samples: int = 4):
        self.ts = timeseries
        self.windows = max(1, int(windows))
        self.min_samples = max(1, int(min_samples))

    def read_s_per_bucket(self) -> dict | None:
        rows = self.ts.unit_cost_series(self.READ_SPAN, self.windows)
        n = sum(c for _, c in rows)
        if n < self.min_samples:
            return None
        return {"value": statistics.median(r for r, _ in rows),
                "samples": n, "windows": len(rows)}

    def link_gb_s(self) -> dict | None:
        rows = self.ts.unit_cost_series(self.XFER_SPAN, self.windows)
        n = sum(c for _, c in rows)
        if n < self.min_samples:
            return None
        # rows are seconds per byte; median then convert to GB/s
        s_per_byte = statistics.median(r for r, _ in rows)
        if s_per_byte <= 0:
            return None
        return {"value": 1.0 / (s_per_byte * 1e9),
                "samples": n, "windows": len(rows)}

    def constants(self) -> dict:
        """``{coefficient: {value, samples, windows}}`` for every
        coefficient with enough recent samples — the shape
        ``CostModel.from_telemetry(live=...)`` consumes."""
        out = {}
        read = self.read_s_per_bucket()
        if read is not None:
            out["read_s_per_bucket"] = read
        link = self.link_gb_s()
        if link is not None:
            out["h2d_gb_s"] = link
        return out

    def section(self) -> dict | None:
        c = self.constants()
        return c or None


# -- session bundle -----------------------------------------------------------

class LiveObserver:
    """One session's live-observability bundle: a ``TimeSeries`` sink on
    the session tracer, an optional ``SloMonitor``, and an optional
    ``LiveCalibrator``. Constructed by ``DiskJoinIndex.attach_live()``;
    ``section()`` is the ``live`` provider in ``metrics_snapshot()``.
    """

    def __init__(self, tracer, *, window_s: float = 1.0,
                 windows: int = 60, slos=None, pipeline_source=None,
                 metrics=None, on_alert=None, calibrate: bool = True,
                 calibrate_windows: int = 8, calibrate_min_samples: int = 4,
                 owns_tracing: bool = False, hist_factor: float = 2.0):
        self.tracer = tracer
        self.owns_tracing = bool(owns_tracing)
        self.timeseries = TimeSeries(window_s=window_s, windows=windows,
                                     factor=hist_factor)
        self.monitor = None
        if slos:
            self.monitor = SloMonitor(self.timeseries, slos,
                                      pipeline_source=pipeline_source,
                                      tracer=tracer, metrics=metrics,
                                      on_alert=on_alert)
        self.calibrator = None
        if calibrate:
            self.calibrator = LiveCalibrator(
                self.timeseries, windows=calibrate_windows,
                min_samples=calibrate_min_samples)
        self._closed = False
        tracer.add_sink(self.timeseries.on_event)

    def poll(self) -> None:
        """Close overdue windows (traffic gaps don't freeze the view)."""
        self.timeseries.poll()

    def live_constants(self) -> dict:
        """Calibrator constants (``{}`` when calibration is off or has
        too few samples) — what ``_planner_for`` feeds the cost model."""
        if self.calibrator is None:
            return {}
        return self.calibrator.constants()

    def slo_firing(self) -> int:
        """Number of SLOs currently firing (0 without a monitor) — the
        burn-state fold consumed by ``serve.replica.HealthTracker``: a
        replica whose SLOs are burning is DEGRADED for routing even
        before individual requests visibly fail."""
        if self.monitor is None:
            return 0
        self.timeseries.poll()
        return len(self.monitor.active_alerts())

    def section(self) -> dict:
        # a scrape wants the windows as of *now* — close overdue ones so
        # a traffic gap doesn't freeze the reported aggregates
        self.timeseries.poll()
        out = self.timeseries.section()
        if self.monitor is not None:
            out.update(self.monitor.section())
        if self.calibrator is not None:
            out["calibration"] = self.calibrator.section()
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.tracer.remove_sink(self.timeseries.on_event)
        if self.monitor is not None:
            self.monitor.close()
        if self.owns_tracing:
            from repro_torch.obs.tracer import disable_tracing, get_tracer
            if get_tracer() is self.tracer:
                disable_tracing()


# -- fleet rollup -------------------------------------------------------------

def merge_live_sections(sections: list[dict]) -> dict:
    """Merge per-shard ``live`` sections into one fleet view: span
    histograms merge *exactly* (same geometric bounds ⇒ counts add,
    percentiles re-derived — never an average of shard percentiles),
    counts/instants/alert totals sum, SLO states take the worst, and
    per-shard calibrations are kept as a list (unit costs of different
    hardware don't average meaningfully). Zero-traffic shards contribute
    empty sections and merge cleanly."""
    sections = [s for s in sections if isinstance(s, dict)]
    out: dict = {"window_s": None, "windows": 0, "events": 0,
                 "spans": {}, "counters": {}, "instants": {}}
    from repro_torch.obs.metrics import MetricsRegistry
    for s in sections:
        if out["window_s"] is None:
            out["window_s"] = s.get("window_s")
        out["windows"] = max(out["windows"], s.get("windows", 0))
        out["events"] += s.get("events", 0)
        for name, agg in (s.get("spans") or {}).items():
            if agg is None:
                continue
            cur = out["spans"].get(name)
            merged = MetricsRegistry._merge_hist(cur, agg)
            # _merge_hist covers the histogram part; sum the extras
            for k in ("total_s", "units", "bad"):
                merged[k] = ((cur or {}).get(k, 0)
                             + agg.get(k, 0)) if cur else agg.get(k, 0)
            out["spans"][name] = merged
        for name, ent in (s.get("counters") or {}).items():
            cur = out["counters"].get(name)
            if cur is None:
                out["counters"][name] = dict(ent)
            else:
                cur["max"] = max(cur["max"], ent["max"])
                cur["last"] = max(cur["last"], ent["last"])
                cur["n"] += ent["n"]
        for name, cnt in (s.get("instants") or {}).items():
            out["instants"][name] = out["instants"].get(name, 0) + cnt
    # SLO/alert rollup
    slos: dict = {}
    alerts = {"fired": 0, "resolved": 0, "active": []}
    any_slo = False
    for s in sections:
        a = s.get("alerts")
        if a:
            alerts["fired"] += a.get("fired", 0)
            alerts["resolved"] += a.get("resolved", 0)
            alerts["active"].extend(a.get("active", []))
        for name, st in (s.get("slos") or {}).items():
            any_slo = True
            cur = slos.get(name)
            if cur is None:
                slos[name] = dict(st)
            else:
                if st.get("state") == "firing":
                    cur["state"] = "firing"
                cur["fast_burn"] = max(cur.get("fast_burn", 0.0),
                                       st.get("fast_burn", 0.0))
                cur["slow_burn"] = max(cur.get("slow_burn", 0.0),
                                       st.get("slow_burn", 0.0))
    if any_slo or any("alerts" in s for s in sections):
        out["slos"] = slos
        out["alerts"] = alerts
    cals = [s.get("calibration") for s in sections if s.get("calibration")]
    if cals:
        out["calibration"] = cals
    return out
