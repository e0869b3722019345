"""Schedule-driven prefetching: perfect-future reads ahead of the executor.

The cache schedule (``repro_torch.core.cache``) already fixes, offline, exactly
which accesses miss and in what order — the same offline knowledge the
paper uses for Belady eviction (§4.2). ``SchedulePrefetcher`` therefore
needs no prediction: an issue thread walks the schedule's miss sequence up
to ``lookahead`` loads ahead of the executor, takes a slab from the
``BufferPool`` (blocking when the pool is exhausted — backpressure), and
hands the read to a worker pool. The executor consumes loads in schedule
order via ``pop_next``; out-of-order *completion* is fine, consumption is
serialized by load index.

Multi-device stores (``StripedBucketedVectorStore``): the prefetcher keeps
one submission queue (worker pool of ``num_threads``) *per device*, so
lookahead saturates every device independently instead of serializing
through one shared pool — reads for device 1 never queue behind a full
device-0 queue.

Batched submission (io_uring-style): adjacent schedule misses landing on
the same device are submitted as ONE request (one task on that device's
queue). With ``coalesce``, batch members that are also disk-contiguous
(the bucketed writer lays extents out in schedule order, so
schedule-adjacent ⇒ disk-adjacent) collapse further into a single
sequential read, split into slabs on completion — one device round trip
instead of k.

Liveness: the executor evicts the scheduled victim (releasing its
residency pin) and flushes its pending verify batch (releasing batch pins)
*before* blocking on a load that has not been issued yet, so a pool with
at least (cache capacity + 1) slabs always frees a slab for the load the
executor is about to wait on. Batch extension only ever uses
``try_acquire`` — the issue thread never blocks while holding slabs beyond
the group's first.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.io.buffer_pool import BufferPool
from repro_torch.io.pipeline import PipelineStats
from repro_torch.io.retry import read_with_retry
from repro_torch.obs import get_tracer

MAX_BATCH = 8  # reads per batched submission (io_uring SQ burst analogue)


class SchedulePrefetcher:
    """Issues the schedule's bucket loads ahead of time into pool slabs."""

    def __init__(self, store, actions, pool: BufferPool, *,
                 lookahead: int = 8, num_threads: int = 2,
                 stats: PipelineStats | None = None,
                 pad_value: float = 0.0,
                 batch_reads: bool = False, coalesce: bool = False,
                 max_batch: int = MAX_BATCH, close_pool: bool = True,
                 tracer=None, retries: int = 0,
                 retry_backoff_s: float = 0.005):
        """``close_pool=False`` marks ``pool`` as shared (owned by a
        ``DiskJoinIndex`` session, outliving this prefetcher): ``close()``
        then only wakes/cancels this prefetcher's waiters instead of
        closing the pool for every other consumer. ``retries`` tolerates
        that many transient read errors per run (capped exponential
        backoff, ``repro_torch.io.retry``) before the error surfaces at
        ``pop_next``."""
        self.store = store
        self.pool = pool
        self.retries = max(0, int(retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.close_pool = bool(close_pool)
        self.lookahead = max(1, int(lookahead))
        self.stats = stats if stats is not None else PipelineStats()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.pad_value = pad_value
        self.coalesce = bool(coalesce)
        self.batch_reads = bool(batch_reads) or self.coalesce
        self.max_batch = max(1, int(max_batch))
        self.num_devices = int(getattr(store, "num_devices", 1))
        self._device_of = (store.device_of if hasattr(store, "device_of")
                           else (lambda b: 0))
        self.stats.init_devices(self.num_devices)
        # the miss sequence: the only accesses that touch the disk.
        # ``actions`` is either a cache schedule ((bucket, is_hit, victim)
        # tuples — hits are skipped) or a plain bucket-id list (an ad-hoc
        # miss set, e.g. a serving wave's unioned probe set, every entry
        # of which is a read).
        self._loads = []
        for a in actions:
            if isinstance(a, (int, np.integer)):
                self._loads.append(int(a))
            elif not a[1]:
                self._loads.append(int(a[0]))
        self._results: dict[int, tuple[int, int] | BaseException] = {}
        self._issued = 0
        self._consumed = 0
        self._closed = False
        self._cond = threading.Condition()
        self._dev_inflight = [0] * self.num_devices
        # one submission queue per device: num_threads models the
        # device's usable queue depth; a striped store gets D independent
        # queues so no device idles behind another's backlog
        self._workers = [
            ThreadPoolExecutor(max_workers=max(1, int(num_threads)),
                               thread_name_prefix=f"diskjoin-io-d{d}")
            for d in range(self.num_devices)]
        self._issuer = threading.Thread(target=self._issue_loop,
                                        name="diskjoin-io-issue", daemon=True)
        self._issuer.start()

    # -- producer side -------------------------------------------------------
    def _issue_loop(self) -> None:
        try:
            loads = self._loads
            k = 0
            while k < len(loads):
                with self._cond:
                    while (k - self._consumed >= self.lookahead
                           and not self._closed):
                        self._cond.wait()
                    if self._closed:
                        return
                # backpressure: blocks when full; on a shared pool the wait
                # is cancellable so close() never strands this thread
                with self.tracer.span("io.acquire", bucket=loads[k]):
                    slot = self.pool.acquire(
                        cancelled=None if self.close_pool
                        else (lambda: self._closed))
                dev = self._device_of(loads[k])
                group = [(k, loads[k], slot)]
                if self.batch_reads:
                    self._extend_group(group, dev)
                with self._cond:
                    if self._closed:
                        for _, _, s in group:
                            self.pool.unpin(s)
                        return
                    self._issued = k + len(group)
                    depth = self._issued - self._consumed
                    self.stats.observe_depth(depth)
                    if self.tracer.enabled:
                        # rollup-visible queue depth (live dashboards)
                        self.tracer.counter("io.depth", value=depth)
                    self._dev_inflight[dev] += len(group)
                    self.stats.observe_device_depth(dev,
                                                    self._dev_inflight[dev])
                if len(group) > 1:
                    self.stats.add("batched_submissions", 1)
                    self.stats.add("batched_reads", len(group))
                # one submission, but each run is its own task: the device
                # serves batch entries concurrently (its queue depth =
                # io_threads), it does not serialize them — only
                # disk-contiguous runs collapse into a single read
                for run in self._partition_runs(group):
                    self._workers[dev].submit(self._read_run, dev, run)
                k += len(group)
        except BaseException as e:  # pool closed mid-acquire, etc.
            with self._cond:
                if not self._closed:
                    self._results[self._issued] = e
                    self._issued += 1
                    self._cond.notify_all()

    def _extend_group(self, group: list, dev: int) -> None:
        """Batch in the *adjacent* schedule misses that hit ``dev``.

        Stops at the first device change, the lookahead horizon, the batch
        cap, or pool exhaustion (``try_acquire`` never blocks — see module
        docstring liveness note)."""
        loads = self._loads
        j = group[0][0] + 1
        while j < len(loads) and len(group) < self.max_batch:
            if self._device_of(loads[j]) != dev:
                break
            with self._cond:
                if self._closed or j - self._consumed >= self.lookahead:
                    break
            slot = self.pool.try_acquire()
            if slot is None:
                break
            group.append((j, loads[j], slot))
            j += 1

    def _partition_runs(self, group: list) -> list[list]:
        """Split a batched submission into disk-contiguous runs (coalesced
        into one sequential read each) and singleton reads."""
        runs = [[group[0]]]
        for item in group[1:]:
            if (self.coalesce
                    and self.store.contiguous_after(runs[-1][-1][1],
                                                    item[1])):
                runs[-1].append(item)
            else:
                runs.append([item])
        return runs

    def _read_run(self, dev: int, run: list) -> None:
        t0 = time.perf_counter()
        try:
            if len(run) == 1:
                k, b, slot = run[0]
                n = read_with_retry(
                    lambda: self.store.read_bucket_into(
                        b, self.pool.vecs(slot), self.pool.ids(slot),
                        pad_value=self.pad_value),
                    retries=self.retries,
                    backoff_s=self.retry_backoff_s, stats=self.stats)
                results = [(k, (slot, n))]
            else:
                ns = read_with_retry(
                    lambda: self.store.read_run_into(
                        [b for _, b, _ in run],
                        [self.pool.vecs(s) for _, _, s in run],
                        [self.pool.ids(s) for _, _, s in run],
                        pad_value=self.pad_value),
                    retries=self.retries,
                    backoff_s=self.retry_backoff_s, stats=self.stats)
                self.stats.add("coalesced_reads", 1)
                self.stats.add("coalesced_buckets", len(run))
                results = [(k, (s, n))
                           for (k, _, s), n in zip(run, ns)]
        except BaseException as e:
            for _, _, slot in run:
                self.pool.unpin(slot)
            results = [(k, e) for k, _, _ in run]
        dt = time.perf_counter() - t0
        self.stats.add("read_s", dt)
        # complete() replays the exact interval read_s accumulated, so the
        # trace-derived hidden_fraction and overlap_efficiency see one
        # measurement, not two clocks
        self.tracer.complete("io.read", t0, dt, dev=dev,
                             buckets=[b for _, b, _ in run])
        self.stats.count_device_loads(dev, len(run))
        with self._cond:
            self._dev_inflight[dev] -= len(run)
            for k, res in results:
                self._results[k] = res
            self._cond.notify_all()

    # -- consumer side -------------------------------------------------------
    @property
    def next_issued(self) -> bool:
        """True iff the next load to consume has already been issued."""
        with self._cond:
            return self._issued > self._consumed

    def pop_next(self) -> tuple[int, int, int]:
        """Next scheduled load, in order → (bucket, slot, rows). Blocks
        (and counts a stall) if the read hasn't completed yet."""
        k = self._consumed
        if k >= len(self._loads):
            raise IndexError("prefetcher exhausted: schedule desync")
        with self._cond:
            if k not in self._results:
                self.stats.add("stalls", 1)
                while k not in self._results and not self._closed:
                    self._cond.wait()
                if self._closed and k not in self._results:
                    raise RuntimeError("prefetcher closed mid-run")
            res = self._results.pop(k)
            self._consumed = k + 1
            self.stats.add("loads", 1)
            self._cond.notify_all()
        if isinstance(res, BaseException):
            raise res
        slot, n = res
        return self._loads[k], slot, n

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self.close_pool:
            self.pool.close()
        else:
            self.pool.kick()  # shared pool stays open for other consumers
        self._issuer.join(timeout=10)
        for w in self._workers:
            w.shutdown(wait=True)
        # release any loads that completed but were never consumed
        with self._cond:
            for res in self._results.values():
                if not isinstance(res, BaseException):
                    self.pool.unpin(res[0])
            self._results.clear()


class PrefetchedBucketCache:
    """Executor-facing cache frontend backed by the prefetch pipeline.

    Mirrors the sync ``BucketCache`` surface (load/evict/rows/resident)
    plus explicit ``checkout``/``release`` pinning so pending verify
    batches keep their slabs alive across evictions.
    """

    def __init__(self, store, capacity_rows: int, actions, *,
                 lookahead: int = 8, pool_slabs: int | None = None,
                 num_threads: int = 2, pad_value: float = 0.0,
                 batch_reads: bool = False, coalesce: bool = False,
                 stats: PipelineStats | None = None,
                 pool: BufferPool | None = None, tracer=None,
                 retries: int = 0, retry_backoff_s: float = 0.005):
        """``pool``: an externally-owned (session) pool to read into —
        slab shape must match (``capacity_rows`` × ``store.dim``); it is
        left open by ``close()``. Without it a private pool of
        ``pool_slabs`` slabs is created and closed with the cache."""
        self.stats = stats if stats is not None else PipelineStats()
        self.capacity_rows = int(capacity_rows)
        if pool_slabs is None:
            raise ValueError("pool_slabs must be sized by the caller "
                             "(>= cache capacity + 1 for liveness)")
        self._owns_pool = pool is None
        if pool is None:
            pool = BufferPool(pool_slabs, capacity_rows, store.dim)
        elif (pool.capacity_rows != int(capacity_rows)
              or pool.dim != store.dim):
            raise ValueError(
                f"shared pool slabs are ({pool.capacity_rows}, {pool.dim}), "
                f"need ({capacity_rows}, {store.dim})")
        self.pool = pool
        self.stats.pool_slabs = pool.num_slabs
        self.stats.lookahead = int(lookahead)
        self.prefetcher = SchedulePrefetcher(
            store, actions, self.pool, lookahead=lookahead,
            num_threads=num_threads, stats=self.stats, pad_value=pad_value,
            batch_reads=batch_reads, coalesce=coalesce,
            close_pool=self._owns_pool, tracer=tracer,
            retries=retries, retry_backoff_s=retry_backoff_s)
        self._slots: dict[int, tuple[int, int]] = {}  # bucket -> (slot, rows)
        self.loads = 0

    def __contains__(self, b: int) -> bool:
        return b in self._slots

    @property
    def resident(self) -> int:
        return len(self._slots)

    @property
    def load_issued(self) -> bool:
        return self.prefetcher.next_issued

    def load(self, b: int) -> None:
        bucket, slot, n = self.prefetcher.pop_next()
        if bucket != b:
            raise AssertionError(
                f"prefetch desync: schedule wants {b}, stream has {bucket}")
        self._slots[b] = (slot, n)
        self.loads += 1

    def evict(self, b: int) -> None:
        ent = self._slots.pop(b, None)
        if ent is not None:
            self.pool.unpin(ent[0])  # drop the residency pin

    def rows(self, b: int) -> int:
        return self._slots[b][1]

    def checkout(self, b: int):
        """Pin bucket ``b``'s slab for a verify batch → (vecs, ids, n, slot)."""
        slot, n = self._slots[b]
        self.pool.pin(slot)
        return (self.pool.vecs(slot), self.pool.ids(slot), n, slot)

    def release(self, entry) -> None:
        self.pool.unpin(entry[3])

    def close(self) -> None:
        self.stats.max_slabs_in_use = self.pool.max_in_use
        self.stats.blocked_acquires = self.pool.blocked_acquires
        # drop the residency pins of buckets still resident at the end of
        # the schedule — on a shared (session) pool the slabs must return
        # to the free list for the next join/query, not leak
        for slot, _ in self._slots.values():
            self.pool.unpin(slot)
        self._slots.clear()
        self.prefetcher.close()
