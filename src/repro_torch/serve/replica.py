"""Replica sets: health-gated routing, failover, hedging, supervision.

A single-copy shard is a single point of failure: one dead SSD, one
browned-out store, one crashed session and every request routed there is
lost. This module gives ``IndexRouter`` (and standalone callers) a
replicated serving tier:

  * **ReplicaSet** — N replicas of one logical shard (same on-disk
    manifest, independent ``DiskJoinIndex`` sessions with their own
    ``BufferPool``/``QueryScheduler``). Each admitted request is routed
    to ONE replica by a pluggable policy: ``least_loaded`` scores a
    replica by queue depth x its per-request service time (seeded from
    the planner's ``WavePlan.predicted_s``, refined by an EWMA of
    observed latencies — ``repro_torch.plan.predict_replica_service_s``),
    falling back to round-robin when no service estimate exists yet.
  * **HealthTracker** — folds per-replica outcomes (errors, deadline
    drops), the session's ``io_read_errors`` counter, and the live SLO
    burn state (``LiveObserver.slo_firing``) into one of
    ``HEALTHY``/``DEGRADED``/``DOWN``. ``DOWN`` replicas are ejected
    from routing; ``DEGRADED`` ones serve only when no healthy sibling
    can.
  * **failover** — a request that fails on one replica (store error,
    ``InjectedKill``, scheduler refusal, deadline drop with budget
    remaining) is transparently retried on a sibling with its remaining
    deadline. An optional hedging knob issues a backup probe to a second
    replica when the first exceeds its plan-predicted service by
    ``HEDGE_FACTOR`` — first successful result wins.
  * **ReplicaSupervisor** — a background thread that detects ``DOWN``
    replicas and restarts them off the request path: the dead
    scheduler's pending queue is spilled (``close(persist_queue=…)``),
    the session is reopened via ``DiskJoinIndex.reopen()``
    (``open(warm_start=True)`` under the hood), spilled requests are
    re-enqueued, and the replica is re-admitted only after a health
    probe query succeeds. Restart attempts back off exponentially up to
    a cap.

Degraded-mode coverage accounting (``Coverage``/``ShardStatus``) lives
here too: when every replica of a shard is down, the router's gather can
return partial results that SAY they are partial instead of failing the
whole fan-out — see ``RouterFuture`` in ``serve/router.py``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import wait as futures_wait

import numpy as np

from repro_torch.core.index import DiskJoinIndex
from repro_torch.ft.fault import InjectedKill
from repro_torch.plan.planner import predict_replica_service_s
from repro_torch.serve.scheduler import (AdmissionRejected, DeadlineExceeded,
                                         QueryScheduler, SchedulerClosed,
                                         SchedulerQueueFull)

HEALTHY = "healthy"
DEGRADED = "degraded"
DOWN = "down"

# backup probe fires when the first replica exceeds its predicted
# service by this factor (a cheap p95 proxy: predictions are means)
HEDGE_FACTOR = 3.0
_EWMA_ALPHA = 0.2
_MIN_RETRY_BUDGET_S = 1e-4   # don't failover a request that is already dead


class ShardUnavailable(RuntimeError):
    """Every replica of a selected shard is DOWN (or restarting) — there
    is nowhere to route the request. Under
    ``require_full_coverage=False`` the router converts this into a
    coverage gap instead of raising."""


class HealthTracker:
    """Per-replica health state machine.

    Outcome events (``record_ok``/``record_error``/``record_drop``) land
    in a sliding window; the ``state`` property folds the window's error
    and deadline-drop rates with two external signals:

      * ``pipeline_source`` (a ``PipelineStats.snapshot`` callable) —
        ``io_read_errors`` accumulated since the last ``reset()``; a
        replica absorbing transient read errors through retry/backoff is
        browned out even if every request ultimately succeeds.
      * ``slo_source`` (callable → firing-SLO count, e.g.
        ``LiveObserver.slo_firing``) — a replica whose burn-rate alerts
        are firing is degraded even before requests visibly fail.

    ``mark_down`` is the immediate ejection path (``InjectedKill``, a
    permanent store error); only ``reset()`` — the supervisor's
    post-probe re-admission — clears it.
    """

    def __init__(self, *, window: int = 32, min_events: int = 4,
                 degraded_error_rate: float = 0.1,
                 down_error_rate: float = 0.5,
                 degraded_drop_rate: float = 0.25,
                 io_error_limit: int = 8,
                 slo_source=None, pipeline_source=None):
        self.min_events = int(min_events)
        self.degraded_error_rate = float(degraded_error_rate)
        self.down_error_rate = float(down_error_rate)
        self.degraded_drop_rate = float(degraded_drop_rate)
        self.io_error_limit = int(io_error_limit)
        self._slo_source = slo_source
        self._pipeline_source = pipeline_source
        self._lock = threading.Lock()
        self._events: deque[str] = deque(maxlen=int(window))
        self._down_reason: str | None = None
        self._io_base = self._io_errors_now()
        self.errors = 0
        self.drops = 0
        self.oks = 0

    def _io_errors_now(self) -> int:
        if self._pipeline_source is None:
            return 0
        try:
            return int(self._pipeline_source().get("io_read_errors", 0))
        except Exception:
            return 0

    def record_ok(self) -> None:
        with self._lock:
            self._events.append("ok")
            self.oks += 1

    def record_error(self, exc: BaseException | None = None) -> None:
        with self._lock:
            self._events.append("err")
            self.errors += 1
            if isinstance(exc, InjectedKill):
                self._down_reason = f"injected kill: {exc}"

    def record_drop(self) -> None:
        with self._lock:
            self._events.append("drop")
            self.drops += 1

    def mark_down(self, reason: str) -> None:
        with self._lock:
            self._down_reason = reason

    def reset(self) -> None:
        """Re-admission (after a successful health probe): clear the
        window, the forced-down latch, and the io-error baseline."""
        with self._lock:
            self._events.clear()
            self._down_reason = None
        self._io_base = self._io_errors_now()

    def _rates(self) -> tuple[int, float, float]:
        n = len(self._events)
        if not n:
            return 0, 0.0, 0.0
        errs = sum(1 for e in self._events if e == "err")
        drops = sum(1 for e in self._events if e == "drop")
        return n, errs / n, drops / n

    @property
    def state(self) -> str:
        with self._lock:
            if self._down_reason is not None:
                return DOWN
            n, err_rate, drop_rate = self._rates()
        if n >= self.min_events and err_rate >= self.down_error_rate:
            return DOWN
        if n >= self.min_events and (err_rate >= self.degraded_error_rate
                                     or drop_rate >= self.degraded_drop_rate):
            return DEGRADED
        if self._io_errors_now() - self._io_base >= self.io_error_limit:
            return DEGRADED
        if self._slo_source is not None:
            try:
                if self._slo_source() > 0:
                    return DEGRADED
            except Exception:
                pass
        return HEALTHY

    def snapshot(self) -> dict:
        with self._lock:
            n, err_rate, drop_rate = self._rates()
            reason = self._down_reason
        return {
            "state": self.state, "events": n,
            "error_rate": round(err_rate, 4),
            "drop_rate": round(drop_rate, 4),
            "errors": self.errors, "drops": self.drops, "oks": self.oks,
            "io_errors_since_reset":
                self._io_errors_now() - self._io_base,
            "down_reason": reason,
        }


class Replica:
    """One replica: a ``DiskJoinIndex`` session + its wave scheduler +
    health. ``swap()`` is the supervisor's restart handoff — routing
    always reads ``index``/``scheduler`` through the attribute, so a
    swapped-in fresh session is picked up by the next request."""

    def __init__(self, index: DiskJoinIndex, scheduler: QueryScheduler,
                 health: HealthTracker, name: str):
        self.index = index
        self.scheduler = scheduler
        self.health = health
        self.name = name
        self.inflight = 0               # submitted, not yet resolved
        self.service_ewma: float | None = None   # observed s/request
        self.predicted_s: float | None = None    # planner seed (lazy)
        self.restarting = False
        self.restarts = 0
        self.next_restart_t = 0.0       # perf_counter gate for backoff
        self.backoff_s = 0.0
        self._lock = threading.Lock()

    def note_latency(self, s: float) -> None:
        with self._lock:
            self.service_ewma = (s if self.service_ewma is None else
                                 (1 - _EWMA_ALPHA) * self.service_ewma
                                 + _EWMA_ALPHA * s)

    def service_estimate(self) -> float | None:
        """Per-request service estimate: observed EWMA, else the
        planner's wave prediction (seeded on first submit)."""
        return self.service_ewma if self.service_ewma is not None \
            else self.predicted_s

    def swap(self, index: DiskJoinIndex,
             scheduler: QueryScheduler) -> None:
        with self._lock:
            self.index = index
            self.scheduler = scheduler
            self.inflight = 0
            self.service_ewma = None     # fresh pool: re-learn
            self.predicted_s = None
            self.restarts += 1
            self.backoff_s = 0.0

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "health": self.health.snapshot(),
            "inflight": self.inflight,
            "pending": self.scheduler.pending,
            "service_ewma_ms": (None if self.service_ewma is None
                                else round(self.service_ewma * 1e3, 3)),
            "restarting": self.restarting,
            "restarts": self.restarts,
        }


class ReplicaSet:
    """N replicas of one logical shard behind one submit surface.

    Parameters:
      indexes: the replica sessions (same manifest — typically N
        ``DiskJoinIndex.open`` calls on one workdir).
      epsilon: default threshold forwarded to each replica scheduler.
      scheduler: kwargs for every per-replica ``QueryScheduler``.
      policy: ``"least_loaded"`` (queue depth x per-request service via
        ``predict_replica_service_s``; round-robin tiebreak) or
        ``"round_robin"``.
      hedge: ``None`` (off), a float (backup probe after that many
        seconds), or ``"plan"`` (after ``HEDGE_FACTOR`` x the replica's
        predicted/observed service + the wave wait window).
      health: kwargs for every per-replica ``HealthTracker``.
    """

    def __init__(self, indexes: list[DiskJoinIndex], *,
                 epsilon: float | None = None,
                 scheduler: dict | None = None,
                 policy: str = "least_loaded",
                 hedge=None,
                 health: dict | None = None,
                 name: str = "shard"):
        if not indexes:
            raise ValueError("replica set needs at least one replica")
        if policy not in ("least_loaded", "round_robin"):
            raise ValueError(f"policy must be 'least_loaded' or "
                             f"'round_robin', got {policy!r}")
        if hedge is not None and hedge != "plan":
            hedge = float(hedge)
            if hedge <= 0:
                raise ValueError(f"hedge must be > 0, got {hedge}")
        self.name = name
        self.epsilon = None if epsilon is None else float(epsilon)
        self.policy = policy
        self.hedge = hedge
        self.sched_kw = dict(scheduler or {})
        self.health_kw = dict(health or {})
        self.replicas = [self._make_replica(idx, i)
                         for i, idx in enumerate(indexes)]
        self._lock = threading.Lock()
        self._rr = 0
        self.counters = {
            "submitted": 0, "failovers": 0, "submit_redirects": 0,
            "hedges": 0, "hedge_wins": 0, "unavailable": 0,
            "restarts": 0, "failed_restarts": 0,
        }

    def _make_replica(self, index: DiskJoinIndex, i: int) -> Replica:
        name = f"{self.name}/r{i}"
        rep_box: list = []   # closure cell: health sources must follow swaps

        def pipeline_source():
            return rep_box[0].index.stats.snapshot()

        def slo_source():
            live = getattr(rep_box[0].index, "live", None)
            return live.slo_firing() if live is not None else 0

        health = HealthTracker(slo_source=slo_source,
                               pipeline_source=pipeline_source,
                               **self.health_kw)
        sched = QueryScheduler(index, epsilon=self.epsilon, **self.sched_kw)
        rep = Replica(index, sched, health, name)
        rep_box.append(rep)
        return rep

    # -- routing policy -------------------------------------------------------
    def routable(self) -> list[Replica]:
        """Replicas eligible for new traffic: not DOWN, not mid-restart.
        DEGRADED replicas are kept but deprioritized by ``_pick``."""
        return [r for r in self.replicas
                if not r.restarting and r.health.state != DOWN]

    def _pick(self, exclude: list[Replica]) -> Replica | None:
        cands = [r for r in self.routable() if r not in exclude]
        if not cands:
            return None
        healthy = [r for r in cands if r.health.state == HEALTHY]
        pool = healthy or cands        # degraded only when nothing healthy
        with self._lock:
            self._rr += 1
            rr = self._rr
        if self.policy == "round_robin" or len(pool) == 1:
            return pool[rr % len(pool)]
        # least_loaded: modeled time for a NEW request to clear each
        # replica — its own predicted service plus the backlog ahead of
        # it (repro_torch.plan.predict_replica_service_s). No estimate on any
        # candidate yet → fall back to (queue depth, round-robin).
        ests = [r.service_estimate() for r in pool]
        if any(e is None or e <= 0 for e in ests):
            return min(zip(pool, range(len(pool))),
                       key=lambda t: (t[0].scheduler.pending
                                      + t[0].inflight,
                                      (t[1] - rr) % len(pool)))[0]
        scored = [(predict_replica_service_s(
                       e, r.scheduler.pending + r.inflight), r)
                  for r, e in zip(pool, ests)]
        # near-equal scores rotate round-robin: a deterministic argmin
        # over noisy EWMAs would pin ALL idle-time traffic to whichever
        # replica happened to measure fastest, starving the others of
        # both load spread and health signal
        best = min(s for s, _ in scored)
        near = [r for s, r in scored if s <= best * 1.25]
        return near[rr % len(near)]

    def _hedge_threshold_s(self, replica: Replica) -> float | None:
        if self.hedge is None or len(self.routable()) < 2:
            return None
        if self.hedge != "plan":
            return float(self.hedge)
        base = replica.service_estimate()
        if base is None or base <= 0:
            return None
        return HEDGE_FACTOR * base + replica.scheduler.max_wait_s

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    # -- serving --------------------------------------------------------------
    def submit(self, q: np.ndarray, *, epsilon: float | None = None,
               k: int | None = None, deadline_s: float | None = None,
               **overrides) -> "ReplicaFuture":
        """Route one request to a replica → ``ReplicaFuture``.

        Raises at the door only when EVERY routable replica refused the
        enqueue (queue full / admission) — single-replica semantics are
        unchanged. With zero routable replicas the future is created
        anyway and raises ``ShardUnavailable`` at gather, so the
        router's coverage accounting can excuse it.
        """
        self._count("submitted")
        return ReplicaFuture(self, q, epsilon=epsilon, k=k,
                             deadline_s=deadline_s, overrides=overrides)

    def query(self, q: np.ndarray, *, timeout: float | None = None,
              **kw) -> tuple[np.ndarray, np.ndarray]:
        return self.submit(q, **kw).result(timeout=timeout)

    # -- telemetry / lifecycle ------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        return {
            "name": self.name,
            "policy": self.policy,
            "hedge": self.hedge,
            "counters": counters,
            "replicas": [r.snapshot() for r in self.replicas],
        }

    def close(self, *, close_indexes: bool = False) -> None:
        for r in self.replicas:
            r.scheduler.close()
        if close_indexes:
            for r in self.replicas:
                r.index.close()


class ReplicaFuture:
    """Handle for one request routed through a ``ReplicaSet``: retries
    on sibling replicas when an attempt fails, optionally hedges a
    backup probe, and records outcomes into the replicas' health.

    ``result(timeout)`` → (ids, distances) like ``QueryFuture``; raises
    ``ShardUnavailable`` when no replica could take the request, or the
    last attempt's error once every sibling has been tried.
    """

    def __init__(self, rset: ReplicaSet, q: np.ndarray, *,
                 epsilon: float | None, k: int | None,
                 deadline_s: float | None, overrides: dict):
        self._rset = rset
        self._q = q
        self._epsilon = epsilon
        self._k = k
        self._overrides = dict(overrides)
        self._t0 = time.perf_counter()
        self._deadline_t = (None if deadline_s is None
                            else self._t0 + float(deadline_s))
        self._tried: list[Replica] = []
        self._fut = None
        self._replica: Replica | None = None
        self._dead_exc: Exception | None = None
        self.latency_s: float | None = None
        self.attempts = 0
        self.hedged = False
        self._submit_attempt(first=True)

    # -- submission -----------------------------------------------------------
    def _remaining_deadline_s(self) -> float | None:
        if self._deadline_t is None:
            return None
        return max(self._deadline_t - time.perf_counter(), 1e-9)

    def _submit_to(self, replica: Replica):
        fut = replica.scheduler.submit(
            self._q, epsilon=self._epsilon, k=self._k,
            deadline_s=self._remaining_deadline_s(), **self._overrides)
        self.attempts += 1
        replica.inflight += 1
        if replica.predicted_s is None and (
                self._rset.policy == "least_loaded"
                or self._rset.hedge == "plan"):
            try:
                p = replica.scheduler._predict_service_s(
                    np.atleast_2d(np.asarray(self._q, np.float32)),
                    self._effective_overrides(replica))
                replica.predicted_s = p if p is None else float(p)
            except Exception:
                pass

        def _done(_f, r=replica):
            r.inflight = max(0, r.inflight - 1)

        fut.add_done_callback(_done)
        return fut

    def _effective_overrides(self, replica: Replica) -> dict:
        ov = dict(replica.scheduler._overrides)
        ov.update(self._overrides)
        eps = (replica.scheduler.epsilon if self._epsilon is None
               else float(self._epsilon))
        if eps is not None:
            ov["epsilon"] = eps
        return ov

    def _submit_attempt(self, first: bool = False) -> bool:
        """Enqueue on the best untried replica. Returns False when no
        routable replica remains (``_dead_exc`` set). Door refusals
        (queue full / admission) cascade to the next replica; if every
        candidate refuses, the last refusal is raised — backpressure
        must stay visible."""
        last_refusal = None
        while True:
            replica = self._rset._pick(self._tried)
            if replica is None:
                if last_refusal is not None:
                    raise last_refusal
                self._dead_exc = ShardUnavailable(
                    f"{self._rset.name}: no routable replica "
                    f"({len(self._rset.replicas)} configured, all "
                    f"down or restarting)")
                if not first:
                    return False
                self._rset._count("unavailable")
                return False
            self._tried.append(replica)
            try:
                fut = self._submit_to(replica)
            except (SchedulerQueueFull, AdmissionRejected,
                    SchedulerClosed) as e:
                last_refusal = e
                self._rset._count("submit_redirects")
                continue
            self._fut, self._replica = fut, replica
            return True

    # -- gather ---------------------------------------------------------------
    @staticmethod
    def _retryable(exc: BaseException) -> bool:
        if isinstance(exc, (FuturesTimeout, TimeoutError)):
            return False             # caller timeout, not replica death
        if isinstance(exc, DeadlineExceeded):
            return True              # budget check happens at the call
        return isinstance(exc, (OSError, InjectedKill, SchedulerClosed,
                                SchedulerQueueFull, AdmissionRejected))

    def _record(self, replica: Replica, exc: BaseException | None) -> None:
        if exc is None:
            replica.health.record_ok()
        elif isinstance(exc, DeadlineExceeded):
            replica.health.record_drop()
        elif isinstance(exc, (OSError, InjectedKill)):
            replica.health.record_error(exc)
        # scheduler refusals are load signals, not health signals

    def done(self) -> bool:
        if self._dead_exc is not None and self._fut is None:
            return True
        return self._fut is not None and self._fut.done()

    def result(self, timeout: float | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        end = (None if timeout is None
               else time.perf_counter() + timeout)
        while True:
            if self._fut is None:
                raise self._dead_exc or ShardUnavailable(self._rset.name)
            try:
                out = self._wait_current(end)
            except (FuturesTimeout, TimeoutError):
                raise
            except BaseException as e:
                self._record(self._replica, e)
                if not self._retryable(e):
                    raise
                rem = self._remaining_deadline_s()
                if rem is not None and rem <= _MIN_RETRY_BUDGET_S:
                    raise      # budget exhausted: the drop is final
                if not self._submit_attempt():
                    raise      # no sibling left: propagate last error
                self._rset._count("failovers")
                continue
            self._record(self._replica, None)
            self._replica.note_latency(time.perf_counter() - self._t0)
            self.latency_s = time.perf_counter() - self._t0
            return out

    def _wait_current(self, end: float | None):
        """Wait on the current attempt; fire a backup probe once the
        hedge threshold passes. First successful result wins; if the
        winner errors, the other attempt is still consulted before the
        error escalates to the failover loop."""
        fut = self._fut
        hedge_s = (None if self.hedged
                   else self._rset._hedge_threshold_s(self._replica))
        if hedge_s is not None:
            rem = None if end is None else max(0.0, end - time.perf_counter())
            wait_s = hedge_s if rem is None else min(hedge_s, rem)
            try:
                return fut.result(timeout=wait_s)
            except FuturesTimeout:
                if end is not None and time.perf_counter() >= end:
                    raise
                backup = self._launch_hedge()
                if backup is not None:
                    return self._wait_hedged([fut, backup], end)
        rem = None if end is None else max(0.0, end - time.perf_counter())
        return fut.result(timeout=rem)

    def _launch_hedge(self):
        sibling = self._rset._pick(self._tried)
        if sibling is None:
            return None
        self._tried.append(sibling)
        try:
            backup = self._submit_to(sibling)
        except (SchedulerQueueFull, AdmissionRejected, SchedulerClosed):
            return None
        self.hedged = True
        self._rset._count("hedges")
        self._hedge_primary = self._fut
        return backup

    def _wait_hedged(self, futs: list, end: float | None):
        errors: list[BaseException] = []
        pending = list(futs)
        while pending:
            rem = None if end is None else max(0.0, end - time.perf_counter())
            done, not_done = futures_wait(pending, timeout=rem,
                                          return_when=FIRST_COMPLETED)
            if not done:
                raise FuturesTimeout()
            for f in done:
                try:
                    out = f.result(timeout=0)
                except BaseException as e:
                    errors.append(e)
                    continue
                if f is not getattr(self, "_hedge_primary", None):
                    self._rset._count("hedge_wins")
                    # the winner is the replica whose health gets credit
                    self._replica = self._tried[-1]
                return out
            pending = list(not_done)
        raise errors[0]


@dataclasses.dataclass
class ShardStatus:
    """Per-shard outcome of one routed request's gather."""

    shard: int
    status: str                  # "ok" | "unavailable" | "deadline" | "error"
    error: str | None = None     # exception repr for non-ok shards

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Coverage:
    """Which shards actually answered a fan-out: the degraded-mode
    contract. ``answered``/``total`` count the shards the request was
    routed to; ``statuses`` carries the per-shard outcome."""

    answered: int
    total: int
    statuses: list[ShardStatus]

    @property
    def complete(self) -> bool:
        return self.answered == self.total

    def to_dict(self) -> dict:
        return {"answered": self.answered, "total": self.total,
                "complete": self.complete,
                "statuses": [s.to_dict() for s in self.statuses]}


class ReplicaSupervisor:
    """Detects DOWN replicas and restarts them off the request path.

    The restart sequence per dead replica:

      1. spill its scheduler's pending queue
         (``QueryScheduler.close(persist_queue=…)`` — the ft queue
         checkpoint; spilled requests ALSO fail over to siblings, the
         resumed copies are recomputed work, not duplicate deliveries);
      2. close the dead session (best effort — it may be wedged);
      3. ``DiskJoinIndex.open(warm_start=True)`` on the dead session's
         workdir and ``device`` (what ``reopen()`` does): a fresh session
         pre-faulted from the residency snapshot;
      4. a fresh ``QueryScheduler`` with ``resume_queue=`` re-enqueues
         the spilled requests with their remaining deadlines;
      5. a health probe query (the shard's first center — must hit) on
         the fresh scheduler; only on success is the replica swapped in
         and its health reset. Any failure re-arms the restart with
         exponentially backed-off delay (capped).

    ``target`` is an ``IndexRouter``, a ``ReplicaSet`` or a list of
    sets. ``start()``/``close()`` manage the poll thread; ``poll_once``
    is the synchronous core (tests drive it directly).
    """

    def __init__(self, target, *, poll_s: float = 0.2,
                 backoff_s: float = 0.25, backoff_cap_s: float = 8.0,
                 warm_start: bool = True, persist_queue: bool = True,
                 probe_timeout_s: float = 30.0, on_event=None):
        if hasattr(target, "replica_sets"):
            self.sets = list(target.replica_sets)
        elif isinstance(target, ReplicaSet):
            self.sets = [target]
        else:
            self.sets = list(target)
        self.poll_s = float(poll_s)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.warm_start = bool(warm_start)
        self.persist_queue = bool(persist_queue)
        self.probe_timeout_s = float(probe_timeout_s)
        self._on_event = on_event
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.restarts = 0
        self.failed_restarts = 0

    def _event(self, kind: str, replica: Replica, **kw) -> None:
        if self._on_event is not None:
            try:
                self._on_event({"event": kind, "replica": replica.name,
                                **kw})
            except Exception:
                pass

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="diskjoin-replica-supervisor",
                daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "ReplicaSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:
                pass           # the supervisor itself must never die

    # -- restart core ---------------------------------------------------------
    def poll_once(self) -> int:
        """Scan every set, restart due DOWN replicas. Returns restarts
        performed this pass."""
        n = 0
        for rset in self.sets:
            for replica in rset.replicas:
                if replica.restarting:
                    continue
                if replica.health.state != DOWN:
                    continue
                if time.perf_counter() < replica.next_restart_t:
                    continue
                if self._restart(rset, replica):
                    n += 1
        return n

    def _restart(self, rset: ReplicaSet, replica: Replica) -> bool:
        replica.restarting = True
        self._event("restart_begin", replica)
        try:
            workdir = replica.index.workdir
            qpath = None
            if self.persist_queue:
                qpath = os.path.join(workdir,
                                     f"pending_queue_{replica.restarts}.json")
            try:
                replica.scheduler.close(persist_queue=qpath)
            except Exception:
                pass
            try:
                replica.index.close()
            except Exception:
                pass           # a dead session may fail its own teardown
            # on the dead session's device: a CPU session restarts on
            # the CPU, a card session on its card — never a fallback
            index = DiskJoinIndex.open(workdir,
                                       replica.index.query_defaults,
                                       warm_start=self.warm_start,
                                       device=replica.index.device)
            try:
                sched = QueryScheduler(index, epsilon=rset.epsilon,
                                       resume_queue=qpath,
                                       **rset.sched_kw)
                # health probe: the first center must answer (it is the
                # center of a real bucket — an empty result is still a
                # successful read path)
                probe = np.ascontiguousarray(index.meta.centers[0],
                                             dtype=np.float32)
                sched.query(probe, timeout=self.probe_timeout_s)
            except BaseException:
                try:
                    index.close()
                except Exception:
                    pass
                raise
        except Exception as e:
            replica.backoff_s = min(
                max(self.backoff_s, replica.backoff_s * 2),
                self.backoff_cap_s)
            replica.next_restart_t = time.perf_counter() + replica.backoff_s
            self.failed_restarts += 1
            rset._count("failed_restarts")
            self._event("restart_failed", replica, error=repr(e),
                        backoff_s=replica.backoff_s)
            return False
        else:
            replica.swap(index, sched)
            replica.health.reset()
            self.restarts += 1
            rset._count("restarts")
            self._event("restart_ok", replica,
                        resumed=len(sched.resumed))
            return True
        finally:
            replica.restarting = False
