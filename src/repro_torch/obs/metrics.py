"""Metrics registry: counters, gauges and log-bucketed histograms.

One ``MetricsRegistry`` per index session is the single metrics surface
DiskJoin components publish into: typed instruments created through
``counter``/``gauge``/``histogram`` get-or-create calls, plus *providers*
— named snapshot-time callables that fold existing stats objects
(``PipelineStats``, the store's ``IOStats``, a scheduler's wave stats, a
query service's latency percentiles) into the same ``snapshot()`` /
``to_json()`` output without duplicating their bookkeeping.

Histograms use **fixed log-scale buckets** (geometric bounds, factor
``factor`` apart between ``lo`` and ``hi``): two histograms created with
the same parameters are bucket-compatible, which is what makes
``MetricsRegistry.merge`` an *exact* rollup — counts add element-wise
and percentiles are re-derived from the merged counts, instead of the
meaningless "average of shard p95s". ``merge`` is the router/fleet
aggregation seed: counters sum, gauges take the max, histograms merge
by bucket, and any provider sections are collected per-shard.

Naming convention (the JAX package's ``obs/README.md``): dotted lowercase
``subsystem.metric``, unit-suffixed where not obvious
(``serve.latency_s``, ``io.read_bytes``).
"""
from __future__ import annotations

import bisect
import json
import math
import threading


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v


class Gauge:
    """Point-in-time reading (last set wins)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._v = v

    def max(self, v) -> None:
        """High-watermark update."""
        with self._lock:
            if v > self._v:
                self._v = v

    @property
    def value(self):
        return self._v


def log_bounds(lo: float, hi: float, factor: float) -> list[float]:
    """Geometric bucket upper bounds: lo, lo·f, lo·f², … ≥ hi."""
    if lo <= 0 or hi <= lo or factor <= 1.0:
        raise ValueError(f"need 0 < lo < hi and factor > 1, "
                         f"got lo={lo}, hi={hi}, factor={factor}")
    n = max(1, math.ceil(math.log(hi / lo, factor)))
    return [lo * factor ** i for i in range(n + 1)]


class Histogram:
    """Fixed log-scale-bucket histogram (plus exact count/sum/min/max).

    ``observe(v)`` lands ``v`` in the first bucket whose upper bound is
    ≥ v; values past the top bound land in a final overflow bucket,
    values ≤ the lowest bound in the first. Percentiles interpolate at
    the geometric midpoint of the winning bucket — resolution is the
    bucket ``factor`` (default 2, i.e. percentiles within 2×), which is
    the price of mergeability and O(1) memory.
    """

    __slots__ = ("name", "bounds", "counts", "count", "sum",
                 "min", "max", "_lock")

    def __init__(self, name: str, *, lo: float = 1e-6, hi: float = 1e4,
                 factor: float = 2.0):
        self.name = name
        self.bounds = log_bounds(lo, hi, factor)
        self.counts = [0] * (len(self.bounds) + 1)  # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @staticmethod
    def percentile_from(bounds: list[float], counts: list[int],
                        q: float) -> float:
        """q-th percentile (0–100) from bucket counts — shared by live
        histograms and merged snapshots."""
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = max(1, math.ceil(total * min(max(q, 0.0), 100.0) / 100.0))
        run = 0
        for i, c in enumerate(counts):
            run += c
            if run >= rank:
                if i == 0:
                    return bounds[0]
                if i >= len(bounds):
                    return bounds[-1]
                return math.sqrt(bounds[i - 1] * bounds[i])
        return bounds[-1]

    def percentile(self, q: float) -> float:
        with self._lock:
            return self.percentile_from(self.bounds, self.counts, q)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.percentile_from(self.bounds, self.counts, 50),
                "p95": self.percentile_from(self.bounds, self.counts, 95),
                "p99": self.percentile_from(self.bounds, self.counts, 99),
                "bounds": list(self.bounds),
                "buckets": list(self.counts),
            }


class MetricsRegistry:
    """Get-or-create instrument registry + provider snapshot surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}
        self._providers: dict[str, object] = {}

    # -- instruments ----------------------------------------------------------
    def _get_or_create(self, name: str, kind, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {kind.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, *, lo: float = 1e-6, hi: float = 1e4,
                  factor: float = 2.0) -> Histogram:
        return self._get_or_create(
            name, Histogram,
            lambda: Histogram(name, lo=lo, hi=hi, factor=factor))

    # -- providers ------------------------------------------------------------
    def register_provider(self, name: str, fn) -> str:
        """Attach a snapshot-time callable (→ dict) under ``name``. A
        taken name gets a ``#k`` suffix (two services on one session must
        not shadow each other); the actual key is returned — keep it for
        ``unregister_provider``."""
        with self._lock:
            key, k = name, 2
            while key in self._providers:
                key = f"{name}#{k}"
                k += 1
            self._providers[key] = fn
            return key

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    # -- snapshot surface -----------------------------------------------------
    def snapshot(self) -> dict:
        """One dict: typed instruments under ``counters``/``gauges``/
        ``histograms``, each provider's dict under its own key. A raising
        provider contributes ``{"error": ...}`` instead of killing the
        whole surface (telemetry must not take the session down)."""
        with self._lock:
            instruments = dict(self._instruments)
            providers = dict(self._providers)
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in sorted(instruments.items()):
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            else:
                out["histograms"][name] = inst.snapshot()
        for name, fn in sorted(providers.items()):
            try:
                out[name] = fn()
            except Exception as e:  # pragma: no cover - defensive
                out[name] = {"error": repr(e)}
        return out

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, default=str)

    # -- rollup ---------------------------------------------------------------
    @staticmethod
    def merge(snapshots: list[dict]) -> dict:
        """Merge ``snapshot()`` dicts from several registries (e.g. one
        per router shard) into one rollup: counters sum, gauges max,
        bucket-compatible histograms merge exactly (counts added,
        percentiles re-derived); histograms with differing bounds fall
        back to count/sum/min/max only. Provider sections (any other
        top-level key) are collected as per-shard lists under the same
        key — domain-aware merges (``PipelineStats.merge``) happen at
        the caller."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        sections: dict[str, list] = {}
        for snap in snapshots:
            for name, v in snap.get("counters", {}).items():
                out["counters"][name] = out["counters"].get(name, 0) + v
            for name, v in snap.get("gauges", {}).items():
                cur = out["gauges"].get(name)
                out["gauges"][name] = v if cur is None else max(cur, v)
            for name, h in snap.get("histograms", {}).items():
                out["histograms"][name] = MetricsRegistry._merge_hist(
                    out["histograms"].get(name), h)
            for key, v in snap.items():
                if key not in ("counters", "gauges", "histograms"):
                    sections.setdefault(key, []).append(v)
        out.update(sections)
        return out

    @staticmethod
    def _merge_hist(acc: dict | None, h: dict) -> dict:
        if acc is None:
            return {k: (list(v) if isinstance(v, list) else v)
                    for k, v in h.items()}
        merged = dict(acc)
        merged["count"] = acc["count"] + h["count"]
        merged["sum"] = acc["sum"] + h["sum"]
        if h["count"]:
            merged["min"] = (min(acc["min"], h["min"]) if acc["count"]
                             else h["min"])
            merged["max"] = (max(acc["max"], h["max"]) if acc["count"]
                             else h["max"])
        if (acc.get("bounds") and h.get("bounds")
                and acc["bounds"] == h["bounds"]):
            merged["buckets"] = [a + b for a, b in zip(acc["buckets"],
                                                       h["buckets"])]
            for q, key in ((50, "p50"), (95, "p95"), (99, "p99")):
                merged[key] = Histogram.percentile_from(
                    merged["bounds"], merged["buckets"], q)
        else:  # incompatible buckets: exact aggregates only
            for key in ("p50", "p95", "p99", "bounds", "buckets"):
                merged.pop(key, None)
        return merged
