"""Low-overhead, thread-aware span tracing for the DiskJoin pipeline.

Every pipeline stage (prefetch workers, the executor walk, verify
dispatch/collect, scheduler waves) records *spans* — named, nestable
wall-time intervals — into a per-thread ring buffer:

    with tracer.span("verify.flush", edges=E):
        ...

Design constraints, in order:

1. **Disabled must be ~free.** The tracer ships disabled; every
   instrumentation site pays one method call that returns a shared no-op
   context manager. No allocation, no clock read, no branch beyond
   ``if not self.enabled``.
2. **No cross-thread contention on the hot path.** Each thread appends
   to its own ring buffer (registered once per thread under a lock);
   record appends take no lock — the GIL serializes the two plain
   stores a ring append performs. Rings are fixed-capacity and overwrite
   oldest-first, so a forgotten enabled tracer degrades to bounded
   memory, never unbounded growth.
3. **One export surface.** ``export(path)`` writes Chrome-trace /
   Perfetto JSON (open at https://ui.perfetto.dev); ``analysis()``
   returns a programmatic ``TraceAnalysis`` over the same events, so
   overlap fractions and stage breakdowns are *derived from spans*
   rather than hand-maintained counters.

Event kinds (Chrome trace phases):
  span      'X'  complete event with duration (``span``/``complete``)
  instant   'i'  point event (``instant``)
  counter   'C'  sampled counter track (``counter``)
  async     'b'/'e'  cross-thread request lifetimes (``async_begin`` /
                 ``async_end``) — e.g. a serving request from submit on
                 the caller thread to completion on the drain thread.

A module-level *current tracer* (disabled by default) is what
instrumented components use when no tracer is passed explicitly:
``enable_tracing()`` swaps in a recording tracer, ``trace_session()``
scopes one to a ``with`` block and restores the previous on exit.
"""
from __future__ import annotations

import os
import threading
import time


class _Ring:
    """Fixed-capacity per-thread event ring; overwrites oldest on wrap."""

    __slots__ = ("buf", "cap", "i", "n", "dropped")

    def __init__(self, cap: int):
        self.buf: list = [None] * cap
        self.cap = cap
        self.i = 0        # next write position
        self.n = 0        # live entries
        self.dropped = 0  # overwritten (oldest-first) events

    def append(self, ev) -> None:
        self.buf[self.i] = ev
        self.i = (self.i + 1) % self.cap
        if self.n < self.cap:
            self.n += 1
        else:
            self.dropped += 1

    def snapshot(self) -> list:
        """Events oldest → newest (tolerates concurrent appends: a racing
        write may or may not be included, never torn — list stores are
        atomic reference assignments)."""
        if self.n < self.cap:
            return [e for e in self.buf[:self.n] if e is not None]
        out = self.buf[self.i:] + self.buf[:self.i]
        return [e for e in out if e is not None]


class _NoopSpan:
    """Shared do-nothing span: the disabled tracer's entire fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    """A live recording span; records an 'X' event on ``__exit__``."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._tracer._record(
            ("X", self.name, self._t0, t1 - self._t0, self.args, None))
        return False

    def set(self, **args) -> "_Span":
        """Attach/overwrite args on the span (appear in the exported
        event's ``args``)."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)
        return self


class Tracer:
    """Thread-aware span/instant/counter recorder with ring storage.

    ``enabled=False`` constructs a permanent no-op tracer (every method
    returns immediately); the module-level default tracer is exactly
    that until ``enable_tracing()``.
    """

    def __init__(self, *, enabled: bool = True,
                 ring_capacity: int = 1 << 16):
        self.enabled = bool(enabled)
        self.ring_capacity = max(16, int(ring_capacity))
        self._epoch = time.perf_counter()
        self._tls = threading.local()
        self._rings: list[tuple[int, str, _Ring]] = []
        self._reg_lock = threading.Lock()
        # streaming consumers (repro.obs.live rollups): a usually-empty
        # tuple so the no-sink hot path pays one falsy check
        self._sinks: tuple = ()

    # -- recording (hot path) -------------------------------------------------
    def _ring(self) -> _Ring:
        r = getattr(self._tls, "ring", None)
        if r is None:
            r = _Ring(self.ring_capacity)
            self._tls.ring = r
            t = threading.current_thread()
            with self._reg_lock:
                self._rings.append((t.ident or 0, t.name, r))
        return r

    def _record(self, ev) -> None:
        self._ring().append(ev)
        if self._sinks:
            for fn in self._sinks:
                try:
                    fn(ev)
                except Exception:  # a broken consumer must not kill the
                    pass           # recording thread (serve path)

    # -- streaming consumers --------------------------------------------------
    def add_sink(self, fn) -> None:
        """Subscribe ``fn(event_tuple)`` to every recorded event — the
        raw ``(ph, name, ts, dur, args, async_id)`` tuples, called on the
        recording thread. Sinks must be cheap and never raise (exceptions
        are swallowed). ``repro.obs.live.TimeSeries.on_event`` is the
        canonical sink."""
        with self._reg_lock:
            self._sinks = self._sinks + (fn,)

    def remove_sink(self, fn) -> None:
        with self._reg_lock:
            self._sinks = tuple(s for s in self._sinks if s != fn)

    def span(self, name: str, **args):
        """Nestable wall-time span context manager (Chrome 'X' event)."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, args or None)

    def complete(self, name: str, t_start: float, duration_s: float,
                 **args) -> None:
        """Record a span from an interval the caller already timed
        (``t_start`` from ``time.perf_counter()``) — instrumentation that
        must agree *exactly* with an existing stats accumulator uses this
        so the trace and the counter see one measurement."""
        if not self.enabled:
            return
        self._record(("X", name, t_start, duration_s, args or None, None))

    def instant(self, name: str, **args) -> None:
        """Point-in-time event (Chrome 'i')."""
        if not self.enabled:
            return
        self._record(("i", name, time.perf_counter(), 0.0,
                      args or None, None))

    def counter(self, name: str, value, **args) -> None:
        """Sampled counter track (Chrome 'C'): one series per ``name``."""
        if not self.enabled:
            return
        a = {"value": value}
        if args:
            a.update(args)
        self._record(("C", name, time.perf_counter(), 0.0, a, None))

    def async_begin(self, name: str, async_id: int, **args) -> None:
        """Open a cross-thread async interval (Chrome 'b'); close it with
        ``async_end`` under the same (name, id) — from any thread."""
        if not self.enabled:
            return
        self._record(("b", name, time.perf_counter(), 0.0,
                      args or None, int(async_id)))

    def async_end(self, name: str, async_id: int, **args) -> None:
        if not self.enabled:
            return
        self._record(("e", name, time.perf_counter(), 0.0,
                      args or None, int(async_id)))

    # -- draining -------------------------------------------------------------
    def events(self) -> list[dict]:
        """All recorded events as Chrome-trace dicts (ts/dur in µs since
        the tracer epoch), sorted by timestamp."""
        pid = os.getpid()
        out: list[dict] = []
        with self._reg_lock:
            rings = list(self._rings)
        for tid, tname, ring in rings:
            for ph, name, ts, dur, args, aid in ring.snapshot():
                ev = {"name": name, "ph": ph, "pid": pid, "tid": tid,
                      "ts": (ts - self._epoch) * 1e6}
                if ph == "X":
                    ev["dur"] = dur * 1e6
                if ph in ("b", "e"):
                    ev["cat"] = "async"
                    ev["id"] = aid
                if args:
                    ev["args"] = dict(args)
                out.append(ev)
        out.sort(key=lambda e: e["ts"])
        return out

    def thread_names(self) -> dict[int, str]:
        with self._reg_lock:
            return {tid: tname for tid, tname, _ in self._rings}

    @property
    def dropped(self) -> int:
        """Events lost to ring wrap-around (size ``ring_capacity`` up)."""
        with self._reg_lock:
            return sum(r.dropped for _, _, r in self._rings)

    def ring_stats(self) -> dict:
        """Per-thread ring occupancy/capacity/drop counts plus totals —
        the session metrics surface exposes this so span drops are
        visible without holding the tracer object."""
        with self._reg_lock:
            rings = list(self._rings)
        threads = [{"tid": tid, "thread": tname, "occupancy": r.n,
                    "capacity": r.cap, "dropped": r.dropped}
                   for tid, tname, r in rings]
        return {"dropped": sum(t["dropped"] for t in threads),
                "events": sum(t["occupancy"] for t in threads),
                "ring_capacity": self.ring_capacity,
                "threads": threads}

    def clear(self) -> None:
        """Drop all recorded events (rings stay registered)."""
        with self._reg_lock:
            for _, _, r in self._rings:
                r.buf = [None] * r.cap
                r.i = r.n = 0

    # -- export / analysis (repro_torch.obs.export) ---------------------------
    def export(self, path: str) -> str:
        from repro_torch.obs.export import export_chrome_trace
        return export_chrome_trace(self, path)

    def analysis(self) -> "TraceAnalysis":
        from repro_torch.obs.export import TraceAnalysis
        return TraceAnalysis(self.events())


# -- module-level current tracer ----------------------------------------------
_DISABLED = Tracer(enabled=False)
_current: Tracer = _DISABLED
_current_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The current tracer — a no-op unless tracing was enabled.
    Instrumented components resolve this when no tracer is injected."""
    return _current


def enable_tracing(ring_capacity: int = 1 << 16) -> Tracer:
    """Install (and return) a fresh recording tracer as the current one."""
    global _current
    with _current_lock:
        _current = Tracer(enabled=True, ring_capacity=ring_capacity)
        return _current


def disable_tracing() -> Tracer:
    """Swap the no-op tracer back in; returns the tracer that was active
    (its recorded events remain exportable)."""
    global _current
    with _current_lock:
        prev = _current
        _current = _DISABLED
        return prev


class trace_session:
    """``with trace_session() as tracer:`` — scope a recording tracer to
    a block; the previous current tracer is restored on exit and the
    session's tracer (with its events) is the bound value."""

    def __init__(self, ring_capacity: int = 1 << 16):
        self.ring_capacity = ring_capacity
        self.tracer: Tracer | None = None
        self._prev: Tracer | None = None

    def __enter__(self) -> Tracer:
        global _current
        with _current_lock:
            self._prev = _current
            self.tracer = Tracer(enabled=True,
                                 ring_capacity=self.ring_capacity)
            _current = self.tracer
        return self.tracer

    def __exit__(self, *exc) -> bool:
        global _current
        with _current_lock:
            _current = self._prev
        return False
