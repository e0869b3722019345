"""Multi-index router: one serving front door over sharded corpora.

A billion-scale corpus is built as several ``DiskJoinIndex`` shards
(separate bucketizations, separate stores — often separate machines'
worth of SSDs). ``IndexRouter`` fronts them with the same request surface
as a single index:

  * **route** — a request only scatters to shards that can possibly
    answer it: shard ``s`` is selected iff some bucket of ``s`` satisfies
    the center-index proximity test ``‖q − c_b‖ − r_b ≤ ε`` (the same
    triangle-inequality bound ``plan_probes`` uses, evaluated against the
    shard's in-memory centers/radii — no disk I/O). A query deep inside
    one shard's clusters skips the others entirely.
  * **replicate** — each logical shard may be a LIST of replica sessions
    (same manifest, independent ``BufferPool``/``QueryScheduler``): the
    request goes to ONE replica chosen by the set's routing policy
    (least-loaded by queue depth x predicted service, health-gated:
    ``DOWN`` replicas are ejected, ``DEGRADED`` deprioritized), fails
    over to a sibling when an attempt dies, and can hedge a backup probe
    — see ``serve/replica.py``.
  * **scatter/gather** — each selected shard's replica set forms its own
    waves and shares probes across ALL concurrent traffic it sees. The
    returned ``RouterFuture`` gathers the per-shard futures.
  * **merge** — shard-local ids are offset into one global id space
    (``id_offsets``; defaults to cumulative shard sizes) and the merged
    ε-result is ordered deterministically (distance, then global id) —
    exactly the ordering an unsharded index over the concatenated
    dataset returns. With every replica healthy, replicated routing is
    byte-identical to single-copy routing (replicas serve the same
    manifest).

Coverage contract: by default deadline/availability semantics are strict
— a request resolves with the underlying error if ANY selected shard
failed it (a silently partial answer is not an ε-range answer). With
``require_full_coverage=False`` a shard whose every replica is dead (or
that dropped its deadline) becomes a COVERAGE GAP instead: ``result()``
returns the surviving shards' merge and ``RouterFuture.coverage`` says
exactly which shards answered (``Coverage.answered/total`` plus
per-shard ``ShardStatus``). Callers that can tolerate partial recall
(e.g. best-effort retrieval under an outage) opt in; callers that cannot
keep the default and get the exception.
"""
from __future__ import annotations

import time
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np

from repro_torch.core.index import DiskJoinIndex
from repro_torch.io import PipelineStats
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.live import merge_live_sections
from repro_torch.serve.replica import (Coverage, ReplicaSet, ShardStatus,
                                       ShardUnavailable)
from repro_torch.serve.scheduler import (DeadlineExceeded, _check_k,
                                         order_result)

_EMPTY = (np.zeros(0, np.int64), np.zeros(0, np.float32))


class RouterFuture:
    """Gather handle over the selected shards' replica futures.

    ``result(timeout)`` waits for every part, offsets shard-local ids
    into the router's global id space, merges, and orders
    deterministically (distance, then global id; truncated to the
    request's ``k``).

    Strict mode (``require_full_coverage=True``, the default): raises
    the first shard exception (``DeadlineExceeded``,
    ``ShardUnavailable``, a store error that exhausted every replica) —
    all-or-nothing semantics.

    Degraded mode (``require_full_coverage=False``): shard-level
    failures become coverage gaps — ``result()`` returns the surviving
    shards' merge and ``self.coverage`` records per-shard status.
    Gather-level ``TimeoutError`` and request-validation errors always
    raise; they are caller problems, not shard outages.
    """

    def __init__(self, parts: list[tuple], k: int | None,
                 require_full_coverage: bool = True):
        self._parts = parts     # [(future, id_offset, shard_index), ...]
        self._k = k
        self._require_full = bool(require_full_coverage)
        self.coverage: Coverage | None = None

    def done(self) -> bool:
        return all(f.done() for f, _, _ in self._parts)

    @property
    def latency_s(self) -> float | None:
        """Slowest part's enqueue→complete latency (None until done)."""
        lats = [f.latency_s for f, _, _ in self._parts]
        if not lats:
            return 0.0
        return None if any(v is None for v in lats) else max(lats)

    def result(self, timeout: float | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        if not self._parts:
            self.coverage = Coverage(answered=0, total=0, statuses=[])
            return _EMPTY
        end = None if timeout is None else time.perf_counter() + timeout
        acc_i, acc_d, statuses = [], [], []
        for fut, off, si in self._parts:
            rem = (None if end is None
                   else max(0.0, end - time.perf_counter()))
            try:
                ids, dists = fut.result(timeout=rem)
            except (FuturesTimeout, TimeoutError):
                raise               # the gather timed out, not the shard
            except (ValueError, TypeError):
                raise               # bad request: never a coverage gap
            except ShardUnavailable as e:
                if self._require_full:
                    raise
                statuses.append(ShardStatus(si, "unavailable", repr(e)))
                continue
            except DeadlineExceeded as e:
                if self._require_full:
                    raise
                statuses.append(ShardStatus(si, "deadline", repr(e)))
                continue
            except (OSError, RuntimeError) as e:
                if self._require_full:
                    raise
                statuses.append(ShardStatus(si, "error", repr(e)))
                continue
            statuses.append(ShardStatus(si, "ok"))
            acc_i.append(ids + off)
            acc_d.append(dists)
        self.coverage = Coverage(
            answered=sum(1 for s in statuses if s.status == "ok"),
            total=len(self._parts), statuses=statuses)
        if not acc_i:
            return _EMPTY
        return order_result(np.concatenate(acc_i), np.concatenate(acc_d),
                            self._k)


class IndexRouter:
    """Scatter/gather ε-range serving over multiple ``DiskJoinIndex``
    shards, each behind a health-gated replica set.

    Parameters:
      shards: the member sessions. Each entry is either one
        ``DiskJoinIndex`` (single copy) or a LIST of sessions over the
        same manifest (a replica set — typically N ``open()`` calls on
        one workdir).
      epsilon: default threshold; None falls back to each shard's own
        query-time defaults (every shard must then have them).
      id_offsets: global id base per logical shard; defaults to
        cumulative shard sizes.
      scheduler: kwargs forwarded to every per-replica
        ``QueryScheduler`` (wave_size, max_wait_s, max_queue, …).
      policy / hedge / health: forwarded to every ``ReplicaSet`` —
        routing policy (``"least_loaded"``/``"round_robin"``), hedging
        knob (None / seconds / ``"plan"``) and ``HealthTracker`` kwargs.
      require_full_coverage: default strictness of ``RouterFuture``
        gathers (overridable per request).
      close_shards: make ``close()`` also close the member indexes.
    """

    def __init__(self, shards: list, *,
                 epsilon: float | None = None,
                 id_offsets: list[int] | None = None,
                 scheduler: dict | None = None,
                 close_shards: bool = False,
                 policy: str = "least_loaded",
                 hedge=None,
                 health: dict | None = None,
                 require_full_coverage: bool = True):
        if not shards:
            raise ValueError("router needs at least one shard")
        groups = [list(s) if isinstance(s, (list, tuple)) else [s]
                  for s in shards]
        if any(not g for g in groups):
            raise ValueError("a shard's replica list cannot be empty")
        flat = [r for g in groups for r in g]
        dims = {s.dim for s in flat}
        if len(dims) != 1:
            raise ValueError(f"shards disagree on vector dim: {sorted(dims)}")
        self.dim = dims.pop()
        if epsilon is None:
            missing = [i for i, g in enumerate(groups)
                       if any(s.query_defaults is None for s in g)]
            if missing:
                raise ValueError(
                    f"epsilon required: shard(s) {missing} have no "
                    f"query-time defaults")
        # primaries: routing metadata (centers/radii/sizes — identical
        # across a set's replicas, which serve the same manifest)
        self.shards = [g[0] for g in groups]
        self.epsilon = None if epsilon is None else float(epsilon)
        if id_offsets is None:
            sizes = [s.num_vectors for s in self.shards]
            id_offsets = [0] + list(np.cumsum(sizes[:-1], dtype=np.int64))
        if len(id_offsets) != len(groups):
            raise ValueError(f"{len(id_offsets)} id_offsets for "
                             f"{len(groups)} shards")
        self.id_offsets = [int(o) for o in id_offsets]
        self.replica_sets = [
            ReplicaSet(g, epsilon=epsilon, scheduler=scheduler,
                       policy=policy, hedge=hedge, health=health,
                       name=f"shard{i}")
            for i, g in enumerate(groups)]
        self.require_full_coverage = bool(require_full_coverage)
        self._close_shards = bool(close_shards)
        self.requests = 0
        self.scattered = 0

    @property
    def all_indexes(self) -> list[DiskJoinIndex]:
        """Every replica session across every logical shard."""
        return [r.index for rset in self.replica_sets
                for r in rset.replicas]

    @property
    def schedulers(self) -> list:
        """Every replica scheduler (flat; one per replica session)."""
        return [r.scheduler for rset in self.replica_sets
                for r in rset.replicas]

    # -- routing --------------------------------------------------------------
    def _effective_eps(self, shard: DiskJoinIndex,
                       epsilon: float | None) -> float:
        if epsilon is not None:
            return float(epsilon)
        if self.epsilon is not None:
            return self.epsilon
        return float(shard.query_defaults.epsilon)

    def route(self, q: np.ndarray,
              epsilon: float | None = None) -> list[int]:
        """Shard indices whose center-index proximity test admits ``q`` —
        the shards that can possibly hold an ε-neighbor (in-memory test,
        no disk reads). Validates the query the same way the shards do
        (dim + finiteness): a NaN query must raise, not silently admit
        zero shards and read as "no neighbors"."""
        q = self.shards[0]._validate_queries(q)[0]
        out = []
        for si, shard in enumerate(self.shards):
            eps = self._effective_eps(shard, epsilon)
            d = np.linalg.norm(shard.meta.centers - q[None, :], axis=1)
            if np.any(d - shard.meta.radii <= eps):
                out.append(si)
        return out

    # -- serving --------------------------------------------------------------
    def submit(self, q: np.ndarray, *, epsilon: float | None = None,
               k: int | None = None, deadline_s: float | None = None,
               require_full_coverage: bool | None = None,
               **overrides) -> RouterFuture:
        """Scatter one request to the admitted shards → ``RouterFuture``.

        Per-shard truncation to ``k`` is sound (the k nearest of the union
        lie within the union of per-shard k-nearest); the gather merges
        and truncates again globally. ``require_full_coverage`` overrides
        the router default for this request only.
        """
        k = _check_k(k)
        selected = self.route(q, epsilon)
        parts = []
        for si in selected:
            fut = self.replica_sets[si].submit(
                q, epsilon=epsilon, k=k, deadline_s=deadline_s,
                **overrides)
            parts.append((fut, self.id_offsets[si], si))
        self.requests += 1
        self.scattered += len(parts)
        strict = (self.require_full_coverage
                  if require_full_coverage is None
                  else bool(require_full_coverage))
        return RouterFuture(parts, k, require_full_coverage=strict)

    def query(self, q: np.ndarray, *, epsilon: float | None = None,
              k: int | None = None, deadline_s: float | None = None,
              timeout: float | None = None,
              require_full_coverage: bool | None = None,
              **overrides) -> tuple[np.ndarray, np.ndarray]:
        """Synchronous scatter/gather for one query."""
        return self.submit(q, epsilon=epsilon, k=k, deadline_s=deadline_s,
                           require_full_coverage=require_full_coverage,
                           **overrides).result(timeout=timeout)

    def query_batch(self, Q: np.ndarray, *, epsilon: float | None = None,
                    k: int | None = None, deadline_s: float | None = None,
                    timeout: float | None = None, **overrides
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Submit a batch (members share shard waves), gather all."""
        Q = np.atleast_2d(np.asarray(Q, np.float32))
        futs = [self.submit(q, epsilon=epsilon, k=k, deadline_s=deadline_s,
                            **overrides) for q in Q]
        return [f.result(timeout=timeout) for f in futs]

    # -- telemetry / lifecycle ------------------------------------------------
    def pipeline_snapshot(self) -> dict:
        """Fleet-level ``PipelineStats`` rollup over every replica
        session (``PipelineStats.merge``: counters sum, gauges max,
        per-device lists concatenate — sessions own distinct pools)."""
        return PipelineStats.merge([s.stats.snapshot()
                                    for s in self.all_indexes])

    def metrics_snapshot(self) -> dict:
        """Fleet-level ``MetricsRegistry`` rollup over every replica
        session, with the pipeline sections re-merged domain-aware."""
        merged = MetricsRegistry.merge([s.metrics_snapshot()
                                        for s in self.all_indexes])
        if isinstance(merged.get("pipeline"), list):
            merged["pipeline"] = PipelineStats.merge(merged["pipeline"])
        if isinstance(merged.get("live"), list):
            # per-session rollup windows share log-bucket bounds, so the
            # span histograms merge exactly (same path as _merge_hist)
            merged["live"] = merge_live_sections(merged["live"])
        return merged

    def attach_live(self, **kw) -> list:
        """``DiskJoinIndex.attach_live`` on every replica session (same
        kwargs); returns the observers. Attaching live also arms the
        health trackers' SLO fold (``HealthTracker`` consults
        ``LiveObserver.slo_firing``)."""
        return [s.attach_live(**kw) for s in self.all_indexes]

    def detach_live(self) -> None:
        for s in self.all_indexes:
            if s.live is not None:
                s.detach_live()

    def snapshot(self) -> dict:
        """Router fan-out counters, every replica scheduler's snapshot
        (grouped per logical shard under ``replica_sets``), and the
        merged fleet pipeline view."""
        return {
            "requests": self.requests,
            "scattered": self.scattered,
            "fanout_mean": self.scattered / self.requests
            if self.requests else 0.0,
            "num_shards": len(self.replica_sets),
            "shards": [r.scheduler.snapshot()
                       for rset in self.replica_sets
                       for r in rset.replicas],
            "replica_sets": [rset.snapshot()
                             for rset in self.replica_sets],
            "pipeline": self.pipeline_snapshot(),
        }

    def close(self) -> None:
        for rset in self.replica_sets:
            rset.close(close_indexes=self._close_shards)

    def __enter__(self) -> "IndexRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
