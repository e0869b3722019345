"""Wave-batched query scheduler: probe-sharing across concurrent requests.

DiskJoin's regime is I/O-bound, so the dominant serving cost is candidate-
bucket reads — and concurrent ε-range queries over a clustered corpus probe
heavily *overlapping* bucket sets. The synchronous facade
(``VectorQueryService`` calling ``DiskJoinIndex.query_batch`` per request)
makes N callers probing the same hot bucket pay N reads. Work-sharing
vector-join systems (Kim et al., PAPERS.md) show that merging overlapping
probe work across concurrent threshold queries is the dominant win in
exactly this setting.

``QueryScheduler`` is that merge point, mirroring the wave design of
``serve/engine.py``:

  1. **queue** — ``submit`` validates the request eagerly and enqueues it
     into a bounded queue (admission control: ``SchedulerQueueFull`` when
     ``max_queue`` requests are already pending), returning a
     ``QueryFuture``;
  2. **wave** — a drain thread forms waves of up to ``wave_size`` requests,
     waiting at most ``max_wait_s`` past the first pending request (size OR
     time-window trigger);
  3. **deadline** — requests whose deadline already passed are dropped
     *before any read* and resolve with ``DeadlineExceeded``
     (``PipelineStats.deadline_drops``); requests that expire *mid-wave*
     are cancelled between buckets — remaining reads for buckets only
     they probe are skipped (``midwave_skipped_reads``) and their future
     raises ``DeadlineExceeded`` too (``deadline_drops_midwave``).
     With ``admission="estimate"`` the planner (``repro_torch.plan``) predicts
     each deadline request's wave service time at ``submit`` and sheds
     predicted-doomed requests before they even enqueue
     (``AdmissionRejected``, ``PipelineStats.admission_rejects``) —
     distinct from the capacity bound ``SchedulerQueueFull``;
  4. **shared probe** — the wave is planned once
     (``DiskJoinIndex.plan_probes``: center index + triangle inequality +
     Eq. 3 pruning, no disk I/O), the per-query candidate-bucket sets are
     unioned, and ``execute_probes`` issues ONE read per distinct bucket
     through the session's shared ``BufferPool``/prefetcher — the resident
     slab fans out to every member query's verify
     (``PipelineStats.shared_probe_reads`` / ``reads_saved_by_sharing``);
  5. **future** — results are ordered deterministically (distance, then id)
     and delivered; ``QueryFuture.latency_s`` records the true
     enqueue→complete latency of *that request* (not a share of the wave's
     wall time), and the scheduler keeps a separate per-wave histogram.

Requests carrying different query-time overrides (ε, io_mode, …) are
grouped within the wave and share probes within their group only — one
``plan``/``execute`` cycle needs one config.

Thread model: any number of submitter threads; ONE drain thread executes
waves, so scheduler traffic presents to the index exactly like the
single-threaded ``query_batch`` caller the session pool's liveness
reasoning assumes (warm pins, one transient slab per miss, fallback reads
under contention) — safe to race against concurrent batch joins.

Copied from the JAX package's ``serve/scheduler.py``. In the port the
drain thread's waves verify on the session's ``device`` (the E = 1 verify
kernel on the card), named explicitly, never the thread's current device;
the per-bucket ``counts.cpu()`` sync of ``execute_probes`` is what lets a
mid-wave cancellation land between buckets.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from repro_torch.core.index import DiskJoinIndex
from repro_torch.core.types import BUILD_TIME_FIELDS, QUERY_TIME_FIELDS
from repro_torch.ft.atomic import AsyncCommitter, atomic_write_json
from repro_torch.obs import get_tracer

QUEUE_SPILL_FORMAT = "diskjoin-queue/v1"


class DeadlineExceeded(Exception):
    """The request's deadline passed before its wave started reading, or
    (mid-wave cancellation) while the wave was still reading buckets —
    the message says which."""


class SchedulerClosed(RuntimeError):
    """submit() after close()."""


class SchedulerQueueFull(RuntimeError):
    """Admission control: the bounded request queue is at capacity."""


class AdmissionRejected(RuntimeError):
    """Estimate-based admission (``admission="estimate"``): the planner
    predicts the request cannot meet its deadline, so it is shed at the
    door before any queueing or disk read. Distinct from
    ``SchedulerQueueFull`` — that is the *capacity* bound; this is the
    *feasibility* bound. Carries the model's numbers so callers can
    re-submit with a looser deadline — ``suggested_deadline_s`` is the
    smallest deadline the model considers feasible (prediction plus the
    wave wait window, with a 25% slack margin): re-pricing instead of
    turning traffic away blind."""

    def __init__(self, msg: str, predicted_s: float | None = None,
                 deadline_s: float | None = None,
                 suggested_deadline_s: float | None = None):
        super().__init__(msg)
        self.predicted_s = predicted_s
        self.deadline_s = deadline_s
        self.suggested_deadline_s = suggested_deadline_s


def _check_k(k) -> int | None:
    if k is None:
        return None
    k = int(k)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    return k


def order_result(ids: np.ndarray, dists: np.ndarray,
                 k: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic result ordering: by distance, ties broken by vector
    id — identical queries return identical orderings regardless of
    io_mode, striping or candidate-bucket read order."""
    order = np.lexsort((ids, dists))
    k = _check_k(k)
    if k is not None:
        order = order[:k]
    return ids[order], dists[order]


def summarize_waves(waves: list[tuple[int, float]]) -> dict:
    """Percentile summary of a (size, service seconds) wave histogram —
    one schema for the scheduler's and the direct service's snapshots."""
    sizes = np.asarray([w[0] for w in waves], np.float64)
    svc = np.asarray([w[1] for w in waves], np.float64) * 1e3
    return {
        "count": len(waves),
        "size_mean": float(sizes.mean()) if sizes.size else 0.0,
        "size_max": int(sizes.max()) if sizes.size else 0,
        "service_p50_ms": (float(np.percentile(svc, 50))
                           if svc.size else 0.0),
        "service_p95_ms": (float(np.percentile(svc, 95))
                           if svc.size else 0.0),
    }


class QueryFuture(Future):
    """Handle for one scheduled request.

    ``result(timeout)`` → (ids, distances), nearest first with ties broken
    by id, truncated to the request's ``k``. Raises ``DeadlineExceeded`` if
    the request expired pre-read, ``SchedulerClosed`` if the scheduler shut
    down underneath it. ``latency_s`` (set on completion) is the request's
    true enqueue→complete latency.
    """

    latency_s: float | None = None


@dataclasses.dataclass
class _Request:
    q: np.ndarray                 # (dim,) float32, validated
    k: int | None
    overrides: tuple              # sorted (key, value) pairs — group key
    enqueue_t: float
    deadline_t: float | None
    future: QueryFuture
    rid: int = 0                  # request id: links trace async events


class QueryScheduler:
    """Wave-batched serving frontend over one ``DiskJoinIndex`` session.

    Parameters:
      index: the session to serve from.
      epsilon: default threshold (falls back to the index's query-time
        defaults; required if the index has none).
      wave_size: max requests per wave (size trigger).
      max_wait_s: max time a wave waits past its first request before
        executing partially filled (time-window trigger). 0 drains
        whatever is queued without waiting.
      max_queue: admission bound — ``submit`` raises
        ``SchedulerQueueFull`` beyond this many pending requests.
      admission: "queue" (default) admits anything the queue has room
        for; "estimate" additionally predicts each *deadline* request's
        wave service time via the session planner (``repro_torch.plan`` —
        sketch-based probe cardinality x calibrated read/verify costs)
        and raises ``AdmissionRejected`` when the prediction says the
        deadline cannot be met even if the wave started immediately.
        Requests without a deadline are never estimate-rejected.
      share_probes: plan the wave once and read each distinct bucket once
        (the point of this class). False executes members independently —
        wave batching without sharing, kept for A/B measurement
        (``benchmarks/fig22_scheduler.py``'s "naive-batch").
      **overrides: query-time config overrides applied to every request
        (e.g. ``io_mode="prefetch"``), validated eagerly.
    """

    def __init__(self, index: DiskJoinIndex, *,
                 epsilon: float | None = None,
                 wave_size: int = 32, max_wait_s: float = 0.002,
                 max_queue: int = 1024, share_probes: bool = True,
                 admission: str = "queue",
                 latency_window: int = 8192,
                 resume_queue: str | None = None, **overrides):
        if wave_size < 1:
            raise ValueError(f"wave_size must be >= 1, got {wave_size}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if admission not in ("queue", "estimate"):
            raise ValueError(f"admission must be 'queue' or 'estimate', "
                             f"got {admission!r}")
        self.index = index
        self.wave_size = int(wave_size)
        self.max_wait_s = float(max_wait_s)
        self.max_queue = int(max_queue)
        self.share_probes = bool(share_probes)
        self.admission = admission
        self._check_overrides(overrides)
        self._overrides = dict(overrides)
        if epsilon is None and "epsilon" not in overrides \
                and index.query_defaults is None:
            raise ValueError(
                "epsilon required: the index has no query-time defaults")
        self.epsilon = None if epsilon is None else float(epsilon)

        self._queue: deque[_Request] = deque()
        self._cond = threading.Condition()
        self._closed = False
        # telemetry (under _stats_lock; the drain thread and submitters
        # both touch it)
        self._stats_lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.admission_rejects = 0
        self.deadline_drops = 0
        self.deadline_drops_midwave = 0
        self.waves = 0
        self._rid = 0            # request ids for trace async linkage
        self._latencies: deque[float] = deque(maxlen=int(latency_window))
        self._wave_hist: deque[tuple[int, float]] = deque(
            maxlen=int(latency_window))
        # queue checkpoint (repro_torch.ft): a predecessor scheduler that was
        # closed with persist_queue= spilled its admitted-but-unserved
        # requests; re-enqueued below with their remaining deadlines
        self.resumed: list[QueryFuture] = []
        self.resume_dropped = 0
        # fold wave/latency counters into the session's metrics surface;
        # keep the returned (possibly suffixed) key for close()
        self._metrics_key = index.metrics.register_provider(
            "scheduler", self._metrics_section)
        self._drain = threading.Thread(target=self._drain_loop,
                                       name="diskjoin-serve-drain",
                                       daemon=True)
        self._drain.start()
        if resume_queue is not None:
            self._resume_from(resume_queue)

    @staticmethod
    def _check_overrides(overrides: dict) -> None:
        bad = sorted(set(overrides) & BUILD_TIME_FIELDS)
        if bad:
            raise ValueError(
                f"build-time parameter(s) {bad} are fixed by the on-disk "
                f"index; rebuild with DiskJoinIndex.build to change them")
        unknown = sorted(set(overrides) - QUERY_TIME_FIELDS)
        if unknown:
            raise TypeError(f"unknown query-time parameter(s) {unknown}")

    # -- submission -----------------------------------------------------------
    def submit(self, q: np.ndarray, *, epsilon: float | None = None,
               k: int | None = None, deadline_s: float | None = None,
               **overrides) -> QueryFuture:
        """Enqueue one ε-range request → ``QueryFuture``.

        ``deadline_s`` is a relative deadline from now; a request whose
        deadline passes while it waits is dropped before any disk read
        and its future raises ``DeadlineExceeded`` (a deadline that
        expires while its wave is already reading cancels the remaining
        work mid-wave and raises the same error). Raises
        ``SchedulerQueueFull`` when ``max_queue`` requests are pending
        (admission control — shed load at the door, not after the reads)
        and, under ``admission="estimate"``, ``AdmissionRejected`` when
        the planner predicts the deadline is infeasible.
        """
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        k = _check_k(k)
        q = self.index._validate_queries(q)
        if q.shape[0] != 1:
            raise ValueError(
                f"submit takes one query vector, got a batch of "
                f"{q.shape[0]}; submit them individually to share waves")
        ov = dict(self._overrides)
        ov.update(overrides)
        eps = self.epsilon if epsilon is None else float(epsilon)
        if eps is not None:
            ov["epsilon"] = eps
        self._check_overrides(ov)
        if self.admission == "estimate" and deadline_s is not None:
            pred = self._predict_service_s(q, ov)
            # even an instantly-formed wave waits out the batching window
            if pred is not None and self.max_wait_s + pred > deadline_s:
                self.index.stats.add("admission_rejects", 1)
                with self._stats_lock:
                    self.admission_rejects += 1
                suggested = (self.max_wait_s + pred) * 1.25
                get_tracer().instant(
                    "serve.admission_reject", predicted_s=pred,
                    deadline_s=float(deadline_s),
                    suggested_deadline_s=suggested)
                raise AdmissionRejected(
                    f"predicted service {pred * 1e3:.2f}ms (+ up to "
                    f"{self.max_wait_s * 1e3:.2f}ms wave wait) exceeds "
                    f"the {deadline_s * 1e3:.2f}ms deadline; rejected "
                    f"before any read (smallest feasible deadline_s "
                    f"~= {suggested * 1e3:.2f}ms)", predicted_s=pred,
                    deadline_s=float(deadline_s),
                    suggested_deadline_s=suggested)
        fut = QueryFuture()
        now = time.perf_counter()
        req = _Request(q=q[0], k=k,
                       overrides=tuple(sorted(ov.items())),
                       enqueue_t=now,
                       deadline_t=None if deadline_s is None
                       else now + float(deadline_s),
                       future=fut)
        with self._cond:
            if self._closed:
                raise SchedulerClosed("scheduler is closed")
            if len(self._queue) >= self.max_queue:
                with self._stats_lock:
                    self.rejected += 1
                raise SchedulerQueueFull(
                    f"request queue full ({self.max_queue} pending)")
            self._rid += 1
            req.rid = self._rid
            self._queue.append(req)
            self._cond.notify_all()
        # async begin on the submitter thread; the matching end fires on
        # the drain thread (with the wave id) — one interval per request
        get_tracer().async_begin("serve.request", req.rid)
        with self._stats_lock:
            self.submitted += 1
        return fut

    def _predict_service_s(self, q: np.ndarray, ov: dict) -> float | None:
        """Planner-predicted wave service time for one request: probe the
        candidate buckets (metadata only, no reads), then cost the wave
        plan (reads for cold probes + verify over estimated pair counts).
        Returns None when no prediction is possible (admission must fail
        open — a broken estimator should never turn into dropped traffic)."""
        try:
            cfg = self.index._resolve(ov)
            Q = np.atleast_2d(np.asarray(q))
            per_q = self.index.plan_probes(Q, **ov)
            wplan = self.index._planner_for(cfg).plan_wave(
                Q, per_q, self.index.meta, cfg, self.index.bucket_capacity,
                warm=set(self.index.warm_buckets()))
            return float(wplan.predicted_s)
        except Exception:
            return None

    def query(self, q: np.ndarray, *, epsilon: float | None = None,
              k: int | None = None, deadline_s: float | None = None,
              timeout: float | None = None,
              **overrides) -> tuple[np.ndarray, np.ndarray]:
        """Synchronous convenience: ``submit`` + wait."""
        return self.submit(q, epsilon=epsilon, k=k, deadline_s=deadline_s,
                           **overrides).result(timeout=timeout)

    # -- queue checkpoint (repro_torch.ft) -----------------------------------
    def _resume_from(self, path: str) -> None:
        """Re-enqueue requests a predecessor spilled with
        ``close(persist_queue=…)``. Each rides in with its remaining
        deadline budget — one that expired during the restart goes
        through the normal pre-read drop path (an honest
        ``DeadlineExceeded``, not silent loss). The spill file is
        consumed (removed) so a crash loop cannot double-resume it."""
        if not os.path.exists(path):
            return
        with open(path) as f:
            payload = json.load(f)
        if payload.get("format") != QUEUE_SPILL_FORMAT:
            raise ValueError(f"{path}: not a {QUEUE_SPILL_FORMAT} spill")
        os.remove(path)
        # deadlines are wall-clock promises to callers: time spent down
        # between spill and resume is charged against each request's
        # remaining budget (perf_counter does not survive a process
        # restart, so the spill stamps wall time)
        downtime = max(0.0, time.time() - payload.get("spilled_at_unix",
                                                      time.time()))
        for rec in payload["requests"]:
            ov = dict(rec["overrides"])
            eps = ov.pop("epsilon", None)
            rem = rec["remaining_s"]
            if rem is not None:
                rem -= downtime
            try:
                fut = self.submit(
                    np.asarray(rec["q"], np.float32),
                    epsilon=eps, k=rec["k"],
                    deadline_s=None if rem is None else max(rem, 1e-9),
                    **ov)
            except (AdmissionRejected, SchedulerQueueFull):
                self.resume_dropped += 1
                continue
            self.resumed.append(fut)

    def _spill_queue(self, path: str, spilled: list[_Request]) -> None:
        """Persist admitted-but-unserved requests through the ft async
        committer (same atomic-write discipline as checkpoints)."""
        now = time.perf_counter()
        payload = {
            "format": QUEUE_SPILL_FORMAT,
            "spilled_at_unix": time.time(),
            "requests": [{
                "q": [float(v) for v in r.q],
                "k": r.k,
                "overrides": [[k, v] for k, v in r.overrides],
                "remaining_s": (None if r.deadline_t is None
                                else r.deadline_t - now),
            } for r in spilled],
        }
        committer = AsyncCommitter(name="queue-spill")
        try:
            committer.submit(lambda: atomic_write_json(path, payload))
        finally:
            committer.close()

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- wave formation -------------------------------------------------------
    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:       # closed and fully drained
                    return
                # time-window trigger: wait for the wave to fill, but at
                # most max_wait_s past the FIRST pending request
                window_end = self._queue[0].enqueue_t + self.max_wait_s
                while (len(self._queue) < self.wave_size
                       and not self._closed):
                    remaining = window_end - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                wave = [self._queue.popleft()
                        for _ in range(min(self.wave_size,
                                           len(self._queue)))]
            try:
                self._run_wave(wave)
            except BaseException as e:      # never kill the drain thread
                for r in wave:
                    if not r.future.done():
                        r.future.set_exception(e)

    # -- wave execution -------------------------------------------------------
    def _run_wave(self, wave: list[_Request]) -> None:
        t0 = time.perf_counter()
        tracer = get_tracer()
        with self._stats_lock:
            wave_id = self.waves + 1
        with tracer.span("serve.wave", wave=wave_id, size=len(wave)):
            # transition every member to RUNNING: a client that cancel()ed
            # a pending future drops out here, and no later cancel can race
            # the set_result/set_exception below (InvalidStateError-free)
            wave = [r for r in wave
                    if r.future.set_running_or_notify_cancel()]
            live: list[_Request] = []
            drops = 0
            for r in wave:
                if r.deadline_t is not None and t0 > r.deadline_t:
                    r.future.latency_s = t0 - r.enqueue_t
                    r.future.set_exception(DeadlineExceeded(
                        f"deadline passed {t0 - r.deadline_t:.4f}s before "
                        f"the wave started (no read was issued)"))
                    tracer.async_end("serve.request", r.rid, wave=wave_id,
                                     dropped=True)
                    drops += 1
                else:
                    live.append(r)
            if drops:
                self.index.stats.add("deadline_drops", drops)
                with self._stats_lock:
                    self.deadline_drops += drops

            # group by effective query-time config: probe sharing needs one
            # plan/execute cycle per config (most traffic uses the defaults
            # and lands in a single group)
            groups: dict[tuple, list[_Request]] = {}
            for r in live:
                groups.setdefault(r.overrides, []).append(r)
            for key, members in groups.items():
                self._run_group(dict(key), members, wave_id)

        self.index.stats.add("waves", 1)
        with self._stats_lock:
            self.waves += 1
            self._wave_hist.append((len(wave), time.perf_counter() - t0))

    def _run_group(self, ov: dict, members: list[_Request],
                   wave_id: int = 0) -> None:
        tracer = get_tracer()
        Q = np.stack([r.q for r in members])

        # mid-wave cancellation: execute_probes consults cancel(qi) before
        # fanning each bucket out (and skips reads no live prober needs).
        # Expiry is sticky — once a member misses its deadline it stays
        # cancelled for the rest of the wave, and its future raises below.
        deadlines = [r.deadline_t for r in members]
        expired: set[int] = set()
        cancel = None
        if any(d is not None for d in deadlines):
            def cancel(qi: int) -> bool:
                if qi in expired:
                    return True
                dl = deadlines[qi]
                if dl is not None and time.perf_counter() > dl:
                    expired.add(qi)
                    return True
                return False

        try:
            plan = self.index.plan_probes(Q, **ov)
            if self.share_probes:
                refs = sum(len(p) for p in plan)
                distinct = len({int(b) for p in plan for b in p})
                if distinct:
                    self.index.stats.add("shared_probe_reads", distinct)
                    self.index.stats.add("reads_saved_by_sharing",
                                         refs - distinct)
                results = self.index.execute_probes(Q, plan, cancel=cancel,
                                                    **ov)
            else:
                # A/B baseline: per-request execution, no sharing
                results = []
                for i in range(len(members)):
                    sub_cancel = (None if cancel is None
                                  else lambda qi, i=i: cancel(i))
                    results.extend(self.index.execute_probes(
                        Q[i:i + 1], [plan[i]], cancel=sub_cancel, **ov))
        except BaseException as e:
            now = time.perf_counter()
            for r in members:
                r.future.latency_s = now - r.enqueue_t
                r.future.set_exception(e)
                tracer.async_end("serve.request", r.rid, wave=wave_id,
                                 error=type(e).__name__)
            return
        now = time.perf_counter()
        lats = []
        midwave = 0
        for qi, (r, (ids, dists)) in enumerate(zip(members, results)):
            r.future.latency_s = now - r.enqueue_t
            if qi in expired:
                # cancelled mid-wave: its partial result set is discarded
                # (a deadline miss must not masquerade as a complete,
                # possibly-truncated answer)
                r.future.set_exception(DeadlineExceeded(
                    f"deadline passed mid-wave "
                    f"({now - r.deadline_t:.4f}s over); remaining probe "
                    f"work was cancelled"))
                tracer.async_end("serve.request", r.rid, wave=wave_id,
                                 dropped=True, midwave=True)
                midwave += 1
                continue
            lats.append(r.future.latency_s)
            r.future.set_result(order_result(ids, dists, r.k))
            tracer.async_end("serve.request", r.rid, wave=wave_id)
        if midwave:
            self.index.stats.add("deadline_drops", midwave)
            self.index.stats.add("deadline_drops_midwave", midwave)
        with self._stats_lock:
            self.completed += len(members) - midwave
            self.deadline_drops += midwave
            self.deadline_drops_midwave += midwave
            self._latencies.extend(lats)

    # -- telemetry / lifecycle ------------------------------------------------
    def _metrics_section(self) -> dict:
        """Provider for the index session's ``MetricsRegistry``: the
        scheduler's counters, latency percentiles and wave summary —
        without the pipeline section the registry already carries."""
        with self._stats_lock:
            lats = np.asarray(self._latencies, np.float64)
            waves = list(self._wave_hist)
            d = {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "admission_rejects": self.admission_rejects,
                "deadline_drops": self.deadline_drops,
                "deadline_drops_midwave": self.deadline_drops_midwave,
                "waves": self.waves,
            }
        d["latency_p50_ms"] = (float(np.percentile(lats, 50)) * 1e3
                               if lats.size else 0.0)
        d["latency_p95_ms"] = (float(np.percentile(lats, 95)) * 1e3
                               if lats.size else 0.0)
        d["wave"] = summarize_waves(waves)
        return d

    def snapshot(self) -> dict:
        """Scheduler counters, true per-request latency percentiles, the
        per-wave histogram summary, and the index session's PipelineStats
        (one surface for waves, shared reads, joins and queries)."""
        with self._stats_lock:
            lats = np.asarray(self._latencies, np.float64)
            waves = list(self._wave_hist)
            d = {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "admission_rejects": self.admission_rejects,
                "deadline_drops": self.deadline_drops,
                "deadline_drops_midwave": self.deadline_drops_midwave,
                "waves": self.waves,
            }
        d["pending"] = self.pending
        d["resumed"] = len(self.resumed)
        d["resume_dropped"] = self.resume_dropped
        d["latency_p50_ms"] = (float(np.percentile(lats, 50)) * 1e3
                               if lats.size else 0.0)
        d["latency_p95_ms"] = (float(np.percentile(lats, 95)) * 1e3
                               if lats.size else 0.0)
        d["latency_mean_ms"] = (float(lats.mean()) * 1e3
                                if lats.size else 0.0)
        d["wave"] = summarize_waves(waves)
        d["pipeline"] = self.index.pipeline_snapshot()
        return d

    def close(self, persist_queue: str | None = None) -> None:
        """Stop accepting requests, drain every pending wave, join the
        drain thread. Pending futures complete normally (or with their
        deadline/config error) — close never abandons accepted work.

        ``persist_queue`` is the supervised-restart path: instead of
        executing the pending queue (pointless against a dead store),
        spill it to ``persist_queue`` via the ft ``AsyncCommitter``; a
        successor scheduler opened with ``resume_queue=`` re-enqueues
        every spilled request with its remaining deadline. The spilled
        futures resolve with ``SchedulerClosed`` so a replica-set
        caller fails over immediately rather than waiting on a corpse.
        """
        spilled: list[_Request] = []
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if persist_queue is not None:
                while self._queue:
                    spilled.append(self._queue.popleft())
            self._cond.notify_all()
        self._drain.join()
        if persist_queue is not None:
            self._spill_queue(persist_queue, spilled)
            exc = SchedulerClosed(
                f"scheduler closed for restart; request spilled to "
                f"{persist_queue} and will be re-executed on resume")
            for r in spilled:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(exc)
        # a closed scheduler must not linger on the session's metrics
        # surface (tests open several schedulers per index)
        self.index.metrics.unregister_provider(self._metrics_key)

    def __enter__(self) -> "QueryScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
