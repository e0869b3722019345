"""Online ε-range vector query serving (ROADMAP: serving integration).

``VectorQueryService`` is the synchronous facade over a ``DiskJoinIndex``
session: point queries route their candidate-bucket reads through the
index's shared ``BufferPool``/prefetcher and verify path, so online
traffic and any concurrently-running batch joins share one slab memory
budget and one ``PipelineStats`` telemetry surface.

Two serving modes:

* **direct** (default): each call runs ``DiskJoinIndex.query_batch``
  inline. Latency accounting is per *request as the caller experienced
  it* — every member of a batch records the batch's full wall time
  (a request is not done until its batch returns), and a separate
  per-batch ("wave") histogram keeps batch size/service time, so p95
  stays meaningful under mixed batch sizes.
* **scheduled**: construct with ``scheduler=`` (a
  ``repro_torch.serve.QueryScheduler``, or ``True`` to own a default one) and
  calls enqueue into the shared wave scheduler — concurrent callers'
  overlapping probes collapse into one read per distinct bucket, and the
  recorded latency is the request's true enqueue→complete time.

Result ordering is deterministic in both modes: nearest first, ties
broken by vector id (identical queries return identical orderings across
io_mode and striping configurations).
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from repro_torch.core.index import DiskJoinIndex
from repro_torch.serve.scheduler import (QueryScheduler, order_result,
                                         summarize_waves)


class VectorQueryService:
    """Serve ε-range point lookups from a built DiskJoin index.

    ``epsilon`` is the default threshold (falls back to the index's
    query-time default); per-request ``epsilon=``/``io_mode=`` overrides
    pass straight through. ``k`` truncates to the k nearest matches
    inside the ε ball.
    """

    def __init__(self, index: DiskJoinIndex, *,
                 epsilon: float | None = None,
                 latency_window: int = 4096,
                 scheduler: QueryScheduler | bool | None = None):
        self.index = index
        if epsilon is None:
            if index.query_defaults is None:
                raise ValueError(
                    "epsilon required: the index has no query-time defaults")
            epsilon = index.query_defaults.epsilon
        self.epsilon = float(epsilon)
        self._owns_scheduler = scheduler is True
        if scheduler is True:
            scheduler = QueryScheduler(index, epsilon=self.epsilon)
        self.scheduler = scheduler or None
        self.requests = 0
        self._latencies: deque[float] = deque(maxlen=int(latency_window))
        # per-wave histogram: (batch size, service seconds) — separate
        # from per-request latency so mixed batch sizes stay analyzable
        self._waves: deque[tuple[int, float]] = deque(
            maxlen=int(latency_window))
        self._lock = threading.Lock()
        # request counts + latency percentiles on the session's metrics
        # surface, alongside the pipeline/io/scheduler sections
        self._metrics_key = index.metrics.register_provider(
            "service", self._metrics_section)

    # -- serving --------------------------------------------------------------
    def query(self, q: np.ndarray, epsilon: float | None = None,
              k: int | None = None,
              **overrides) -> tuple[np.ndarray, np.ndarray]:
        """One ε-range lookup → (ids, distances), nearest first (ties by
        id)."""
        return self.query_batch(np.asarray(q, np.float32)[None, :],
                                epsilon, k=k, **overrides)[0]

    def query_batch(self, Q: np.ndarray, epsilon: float | None = None,
                    k: int | None = None, **overrides
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
        eps = self.epsilon if epsilon is None else float(epsilon)
        if self.scheduler is not None:
            return self._query_batch_scheduled(Q, eps, k, overrides)
        t0 = time.perf_counter()
        raw = self.index.query_batch(Q, eps, **overrides)
        dt = time.perf_counter() - t0
        out = [order_result(ids, dists, k) for ids, dists in raw]
        with self._lock:
            self.requests += len(out)
            # a member request completes when its batch does: each one
            # records the full batch wall time (true caller-observed
            # latency), and the batch itself lands in the wave histogram
            self._latencies.extend([dt] * len(out))
            self._waves.append((len(out), dt))
        return out

    def _query_batch_scheduled(self, Q: np.ndarray, eps: float,
                               k: int | None, overrides: dict
                               ) -> list[tuple[np.ndarray, np.ndarray]]:
        Q = np.atleast_2d(np.asarray(Q, np.float32))
        futs = [self.scheduler.submit(q, epsilon=eps, k=k, **overrides)
                for q in Q]
        out = [f.result() for f in futs]
        with self._lock:
            self.requests += len(out)
            # true enqueue→complete latency, as recorded by the scheduler
            self._latencies.extend(f.latency_s for f in futs)
        return out

    # -- telemetry ------------------------------------------------------------
    def _metrics_section(self) -> dict:
        """Provider for the index session's ``MetricsRegistry``: request
        count and true per-request latency percentiles."""
        with self._lock:
            lats = np.asarray(self._latencies, np.float64)
            requests = self.requests
        return {
            "requests": requests,
            "latency_p50_ms": (float(np.percentile(lats, 50)) * 1e3
                               if lats.size else 0.0),
            "latency_p95_ms": (float(np.percentile(lats, 95)) * 1e3
                               if lats.size else 0.0),
            "latency_p99_ms": (float(np.percentile(lats, 99)) * 1e3
                               if lats.size else 0.0),
        }

    def snapshot(self) -> dict:
        """Service counters + the index session's PipelineStats (one
        surface for online reads and batch-join loads). ``latency_*`` are
        true per-request figures; ``wave`` summarizes the per-batch
        histogram (direct mode) or defers to the scheduler's own waves."""
        with self._lock:
            lats = np.asarray(self._latencies, np.float64)
            waves = list(self._waves)
            requests = self.requests
        d = {
            "requests": requests,
            "latency_p50_ms": (float(np.percentile(lats, 50)) * 1e3
                               if lats.size else 0.0),
            "latency_p95_ms": (float(np.percentile(lats, 95)) * 1e3
                               if lats.size else 0.0),
            "latency_mean_ms": (float(lats.mean()) * 1e3
                                if lats.size else 0.0),
        }
        if self.scheduler is not None:
            sched = self.scheduler.snapshot()
            d["wave"] = sched["wave"]
            d["scheduler"] = {key: sched[key] for key in
                              ("submitted", "completed", "rejected",
                               "deadline_drops", "waves", "pending")}
        else:
            d["wave"] = summarize_waves(waves)
        d["pipeline"] = self.index.pipeline_snapshot()
        return d

    def close(self) -> None:
        """Close the service's own scheduler (no-op for an injected one —
        its owner closes it; the index always belongs to the caller)."""
        if self._owns_scheduler and self.scheduler is not None:
            self.scheduler.close()
        self.index.metrics.unregister_provider(self._metrics_key)
