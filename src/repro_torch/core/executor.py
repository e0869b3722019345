"""Task execution engine (paper §3 "task execution").

Replays the orchestration schedule: walks the edge order, keeps the bucket
cache in sync with the cache schedule (load on miss, evict the designated
victim), and verifies bucket pairs with the pairwise-distance kernel.
Intra-bucket pairs are verified on each bucket's first touch.

Fixed shapes: every bucket is padded to ``bucket_capacity`` rows, so every
verify launch of a join has one shape. Padded rows sit at coordinates 1e15
and are killed by the live-row counts (a pad-vs-pad d² is ≈ 0 and would
pass ε), never by their distance alone.

Batched dispatch: edges accumulate into ``JoinConfig.verify_batch``-sized
batches verified by a verify engine (``repro_torch.compute``) with one
kernel launch per flush; cache-evicted slabs stay alive through the
pending batch's pins (slot references in sync mode, buffer-pool pins in
prefetch mode, device copies in device compute mode).

I/O modes (``JoinConfig.io_mode``): ``"sync"`` reads every missed bucket
inline; ``"prefetch"`` consumes slabs from ``repro_torch.io``'s
schedule-driven prefetcher, whose worker threads read with numpy only
(no torch or CUDA call runs off the executor thread). With
``plan_mode="on"`` a ``repro_torch.plan.Planner`` sizes the device
compaction, retunes the flush threshold per schedule region and routes
each verify unit to the host or the device engine
(``compute_mode="auto"``).

Tracing: while the tracer is on, a join that may verify on the card
tallies the ``tc`` route's in-band re-checks
(``kernels.pairwise_l2.counting_rechecks``, unless a tally is already
open) and records them after the engine's last collect as one
``verify.rechecks`` instant (arg ``pairs``: the outputs recomputed in
float32). With the tracer off the kernels get no tally.

Port of the JAX package's ``core/executor.py``. Every combination of I/O
mode, compute mode and plan replays the same cache schedule and gives
byte-identical results.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from repro_torch.compute import make_verify_engine
from repro_torch.compute.slab_pool import HostSlot
from repro_torch.core import cache as cache_mod
from repro_torch.core import ordering
from repro_torch.core.bucket_graph import candidate_pair_count
from repro_torch.core.types import (BucketGraph, BucketMeta, JoinConfig,
                                    JoinResult, dedup_pairs,
                                    resolve_bucket_capacity,
                                    resolve_cache_buckets)
from repro_torch.io import PipelineStats, PrefetchedBucketCache
from repro_torch.io.retry import read_with_retry
from repro_torch.kernels import pairwise_l2
from repro_torch.obs import get_tracer
from repro_torch.store.vector_store import BucketedVectorStore

PAD_COORD = 1e15  # padded rows: astronomically far from everything


class BucketCache:
    """Padded bucket slabs (host staging), driven by the cache schedule.

    The sync I/O backend: ``load`` reads inline on the executor thread,
    straight into a slot of an arena of padded ``(capacity_rows, dim)``
    float32 slabs and their int64 id sidecars (``HostSlot``s), allocated
    once per cache at ``slots`` slots: in pinned memory when ``pin`` (a
    CUDA join), so the device pool DMAs a slab from its slot with no
    staging copy. Pad rows are written once, when a slot is made; a refill
    re-pads only the rows its previous bucket held (``sizes``: each
    bucket's row count, so the read knows how far it writes).

    Shares the ``checkout``/``release`` surface with
    ``repro_torch.io.PrefetchedBucketCache``: a slot's residency and each
    checkout hold a reference, and the slot is refilled only once it is
    evicted, released by every pending verify batch and past its last H2D
    copy (``copy_done``). A load that finds no such slot waits on the
    oldest copy when two or more are in flight (``h2d_slot_waits``); else
    it adds a slot (``cache_slot_grows``), as when every slot is resident
    or pinned, so a pending host batch never deadlocks the walk.
    """

    def __init__(self, store: BucketedVectorStore, sizes: np.ndarray,
                 capacity_rows: int, retries: int = 0,
                 retry_backoff_s: float = 0.005, stats=None,
                 slots: int = 2, pin: bool = False):
        self.store = store
        self.sizes = sizes
        self.capacity_rows = capacity_rows
        self.retries = max(0, int(retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.stats = stats
        self.pin = pin
        self._slabs: dict[int, tuple[np.ndarray, np.ndarray, int,
                                     HostSlot]] = {}
        self._free = self._new_slots(slots)
        self._draining: collections.deque[HostSlot] = collections.deque()
        self.slots = slots
        self.loads = 0
        self.slot_waits = 0
        self.slot_grows = 0

    def _new_slots(self, k: int) -> list[HostSlot]:
        vecs = torch.empty((k, self.capacity_rows, self.store.dim),
                           dtype=torch.float32, pin_memory=self.pin)
        vecs.fill_(PAD_COORD)
        ids = np.full((k, self.capacity_rows), -1, np.int64)
        return [HostSlot(vecs[i], ids[i], self.pin) for i in range(k)]

    def __contains__(self, b: int) -> bool:
        return b in self._slabs

    load_issued = True  # sync loads never need a pipeline to catch up

    def _count(self, field: str) -> None:
        if self.stats is not None:
            self.stats.add(field, 1)

    def _take_slot(self) -> HostSlot:
        if not self._free:
            for slot in [s for s in self._draining if s.copy_done.query()]:
                self._draining.remove(slot)
                self._free.append(slot)
        # what still drains has its copy in flight
        if not self._free and len(self._draining) >= 2:
            # a task first-touches at most its two endpoints before the
            # next load, so the oldest of two copies in flight is nearly
            # done: wait for it rather than pin a slot for the whole join
            slot = self._draining.popleft()
            slot.copy_done.synchronize()
            self.slot_waits += 1
            self._count("h2d_slot_waits")
            self._free.append(slot)
        if self._free:
            return self._free.pop()
        self.slots += 1
        self.slot_grows += 1
        self._count("cache_slot_grows")
        return self._new_slots(1)[0]

    def _unref(self, slot: HostSlot) -> None:
        slot.refs -= 1
        if slot.refs == 0:
            (self._draining if slot.copy_done is not None
             else self._free).append(slot)

    def load(self, b: int) -> None:
        slot = self._take_slot()
        # rows past both this bucket and the slot's last one are pad rows
        rows = max(int(self.sizes[b]), slot.live)
        slot.live = rows  # what a failed read may have written
        try:
            n = read_with_retry(
                lambda: self.store.read_bucket_into(
                    b, slot.vecs[:rows], slot.ids[:rows],
                    pad_value=PAD_COORD),
                retries=self.retries, backoff_s=self.retry_backoff_s,
                stats=self.stats)
        except BaseException:
            self._free.append(slot)
            raise
        slot.live = n
        slot.refs = 1
        self._slabs[b] = (slot.vecs, slot.ids, n, slot)
        self.loads += 1

    def evict(self, b: int) -> None:
        entry = self._slabs.pop(b, None)
        if entry is not None:
            self._unref(entry[3])

    def get(self, b: int):
        return self._slabs[b]

    def rows(self, b: int) -> int:
        return self._slabs[b][2]

    def checkout(self, b: int):
        entry = self._slabs[b]
        entry[3].refs += 1
        return entry

    def release(self, entry) -> None:
        self._unref(entry[3])

    def close(self) -> None:
        pass

    @property
    def resident(self) -> int:
        return len(self._slabs)


class JoinExecutor:
    intra_join = True  # the cross-join subclass disables intra-bucket pairs

    def __init__(self, store: BucketedVectorStore, meta: BucketMeta,
                 config: JoinConfig, *, device: torch.device,
                 attribute_mask: np.ndarray | None = None,
                 shared_pool=None, shared_stats=None, tracer=None,
                 planner=None):
        """``attribute_mask``: (N,) bool — attribute filtering (paper §3
        extension): vectors failing the predicate are excluded from
        verification via a bitmap, before any distance is computed.

        ``shared_pool`` / ``shared_stats``: a ``DiskJoinIndex`` session's
        lifetime ``BufferPool`` and ``PipelineStats`` — batch joins and
        online point queries then share one memory budget and one
        telemetry surface. The pool is used only when its slab shape and
        size fit this run (otherwise a private pool is created; the stats
        are shared regardless).

        ``planner``: a ``repro_torch.plan.Planner`` (usually the index
        session's) consulted when ``config.plan_mode == "on"``; with
        plan_mode on and no planner supplied, one is built lazily by
        sampling the bucketed store (the one-shot / cross-join path).

        ``device``: where the verify engine runs (its kernels on CUDA,
        their plain versions on the CPU); it also picks the planner's
        static cost constants."""
        self.store = store
        self.meta = meta
        self.config = config
        self.device = torch.device(device)
        self.attribute_mask = attribute_mask
        self.shared_pool = shared_pool
        self.shared_stats = shared_stats
        self.planner = planner
        self.tracer = tracer if tracer is not None else get_tracer()
        cap = resolve_bucket_capacity(config, meta.sizes)
        self.bucket_capacity = cap
        self.padded_bucket_bytes = cap * store.dim * 4
        self.cache_buckets = resolve_cache_buckets(config, cap, store.dim)

    # -- orchestration -------------------------------------------------------
    def plan(self, graph: BucketGraph, node_order: np.ndarray | None = None):
        """Gorder (optional) → edge order → access seq → cache schedule.

        ``node_order`` short-circuits the ordering step when the caller
        already planned it (e.g. the disk-layout pass of the build) —
        identical by construction since both go through
        ``ordering.compute_node_order``.
        """
        t0 = time.perf_counter()
        with self.tracer.span("join.plan", edges=graph.num_edges,
                              buckets=graph.num_nodes):
            if node_order is None:
                node_order = ordering.compute_node_order(
                    graph, self.meta, self.config, self.cache_buckets)
            tasks, access_seq, pins = ordering.edge_schedule(graph,
                                                            node_order)
            schedule = cache_mod.simulate_policy(
                access_seq, graph.num_nodes, self.cache_buckets,
                self.config.eviction_policy, pins)
        plan_seconds = time.perf_counter() - t0
        return tasks, access_seq, schedule, plan_seconds

    # -- execution -----------------------------------------------------------
    def _make_cache(self, schedule):
        """Cache backend per JoinConfig.io_mode (+ pipeline stats or None)."""
        if self.config.io_mode != "prefetch":
            stats = self.shared_stats
            if stats is None and self.config.compute_mode != "host":
                # device telemetry (h2d/compaction counters) needs a
                # stats surface even without the prefetch pipeline
                stats = PipelineStats()
            return BucketCache(self.store, self.meta.sizes,
                               self.bucket_capacity,
                               retries=self.config.io_retries,
                               retry_backoff_s=self.config.io_retry_backoff_s,
                               stats=stats,
                               slots=min(self.cache_buckets,
                                         self.meta.num_buckets or 1),
                               pin=self.device.type == "cuda"), stats
        cap_buckets = min(self.cache_buckets, self.meta.num_buckets or 1)
        pool_slabs = self.config.io_pool_slabs
        if pool_slabs is None:
            pool_slabs = cap_buckets + self.config.io_lookahead
        pool_slabs = max(pool_slabs, cap_buckets + 1)  # liveness floor
        stats = (self.shared_stats if self.shared_stats is not None
                 else PipelineStats())
        pool = self.shared_pool
        if pool is not None and (pool.capacity_rows != self.bucket_capacity
                                 or pool.dim != self.store.dim
                                 or pool.num_slabs < pool_slabs):
            pool = None  # session pool doesn't fit this run: go private
        cache = PrefetchedBucketCache(
            self.store, self.bucket_capacity, schedule.actions,
            lookahead=self.config.io_lookahead, pool_slabs=pool_slabs,
            num_threads=self.config.io_threads, pad_value=PAD_COORD,
            batch_reads=self.config.io_batch_reads,
            coalesce=self.config.io_coalesce, stats=stats, pool=pool,
            tracer=self.tracer, retries=self.config.io_retries,
            retry_backoff_s=self.config.io_retry_backoff_s)
        return cache, stats

    def _resolve_planner(self, pstats):
        """The session planner when given, else (plan_mode on) a lazily
        built one sampling this executor's store — the one-shot and
        cross-join paths, whose stores have no persisted sketch."""
        if self.planner is not None or self.config.plan_mode != "on":
            return self.planner
        from repro_torch.plan import CardinalityEstimator, CostModel, Planner
        est = CardinalityEstimator.sample_bucketed(
            self.store, self.meta.sizes, seed=self.config.seed)
        cost = CostModel.from_telemetry(
            self.config, pstats.snapshot() if pstats is not None else None,
            device=self.device)
        self.planner = Planner(est, cost, tracer=self.tracer,
                               pstats=pstats)
        return self.planner

    def _recheck_tally(self):
        """The re-check tally for a traced join that may verify on the
        card (yields the counts), else a context that yields None."""
        if (self.tracer.enabled and self.config.compute_mode != "host"
                and pairwise_l2.RECHECKS is None):
            return pairwise_l2.counting_rechecks(self.device)
        return contextlib.nullcontext()

    def run(self, graph: BucketGraph,
            node_order: np.ndarray | None = None) -> JoinResult:
        tasks, access_seq, schedule, plan_seconds = self.plan(graph,
                                                             node_order)
        cache, pstats = self._make_cache(schedule)
        # on a session's lifetime stats, this run's result must still
        # report per-run numbers: diff against a baseline at the end
        pstats_base = (pstats.snapshot() if pstats is not None
                       and self.shared_stats is not None else None)
        jplan = None
        if self.config.plan_mode == "on":
            planner = self._resolve_planner(pstats)
            jplan = planner.plan_join(tasks, schedule.actions, self.meta,
                                      self.config, self.bucket_capacity,
                                      intra_join=self.intra_join)
        engine = make_verify_engine(self.config, cache,
                                    self.bucket_capacity, self.store.dim,
                                    self.device,
                                    attribute_mask=self.attribute_mask,
                                    pstats=pstats, tracer=self.tracer,
                                    plan=jplan)

        tracer = self.tracer
        run_span = tracer.span("join.run", edges=graph.num_edges,
                               io_mode=self.config.io_mode,
                               compute_mode=self.config.compute_mode)
        run_span.__enter__()
        t0 = time.perf_counter()
        ai = 0  # index into access_seq / schedule.actions
        actions = schedule.actions
        io_wait = 0.0   # executor time blocked in cache.load

        def ensure(b: int) -> None:
            nonlocal io_wait
            nonlocal ai
            bb, is_hit, victim = actions[ai]
            assert bb == b, f"schedule desync at access {ai}: {bb} != {b}"
            ai += 1
            if not is_hit:
                if victim is not None:
                    cache.evict(victim)
                    engine.evict(victim)
                if not cache.load_issued:
                    # the prefetcher is behind AND may be blocked on the
                    # pool: flush every engine's pending pins so a slab
                    # frees up (liveness; the routed engine flushes both)
                    if engine.pending and pstats is not None:
                        pstats.add("flush_on_stall", 1)
                    engine.flush()
                t1 = time.perf_counter()
                cache.load(b)
                dt = time.perf_counter() - t1
                io_wait += dt
                # same interval as the io_wait accumulator
                tracer.complete("io.wait", t1, dt, bucket=b)

        # plan cursor: unit_params is in exact enqueue order (the planner
        # replayed this same task walk), so consumption is a single index
        ui = 0
        unit_params = jplan.unit_params if jplan is not None else None

        def tune() -> None:
            nonlocal ui
            route, vb = unit_params[ui]
            ui += 1
            engine.set_route(route)
            engine.set_verify_batch(vb)

        try:
            with self._recheck_tally() as rechecks:
                for task in tasks:
                    if task[0] == "touch":
                        b = int(task[1])
                        ensure(b)
                        if self.intra_join and cache.rows(b) >= 2:
                            if unit_params is not None:
                                tune()
                            engine.enqueue(b, b, True)
                    else:
                        _, u, v = task
                        ensure(int(u))
                        ensure(int(v))
                        if unit_params is not None:
                            tune()
                        engine.enqueue(int(u), int(v), False)
                engine.finish()
                if rechecks is not None:
                    # the last collect has waited for every kernel that
                    # adds to the tally
                    tracer.instant("verify.rechecks",
                                   pairs=int(rechecks[0].item()))
        finally:
            engine.abort()
            cache.close()
            run_span.__exit__(None, None, None)
        exec_seconds = time.perf_counter() - t0
        compute_t = engine.compute_s  # engine time in stage/dispatch/extract

        pairs_list, dists_list = engine.results()
        with tracer.span("join.dedup") as dedup_span:
            if pairs_list:
                pairs = np.concatenate(pairs_list)
                dedup_span.set(pairs=len(pairs))
                pairs, dists = dedup_pairs(pairs,
                                           np.concatenate(dists_list))
            else:
                dedup_span.set(pairs=0)
                pairs = np.zeros((0, 2), np.int64)
                dists = np.zeros(0, np.float32)

        io_stats = self.store.stats.snapshot()
        timings = {"plan": plan_seconds, "execute": exec_seconds,
                   "io_wait": io_wait, "compute": compute_t}
        if pstats is not None:
            pstats.add("io_wait_s", io_wait)
            pstats.add("compute_s", compute_t)
            if self.config.io_mode != "prefetch":
                # prefetch-mode loads are counted at pop_next; count sync
                # loads here so a session's stats see both join kinds
                pstats.add("loads", cache.loads)
            io_stats["pipeline"] = (pstats.snapshot_since(pstats_base)
                                    if pstats_base is not None
                                    else pstats.snapshot())

        return JoinResult(
            pairs=pairs, distances=dists,
            num_distance_computations=engine.dc,
            num_candidate_pairs=candidate_pair_count(graph, self.meta),
            cache_hits=schedule.hits, cache_misses=schedule.misses,
            bucket_loads=cache.loads,
            io_stats=io_stats,
            timings=timings,
            plan=jplan,
        )
