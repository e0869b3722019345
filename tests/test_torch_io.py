"""The port's join I/O: the prefetcher (``repro_torch.io.prefetcher``, the
executor's ``io_mode="prefetch"`` and the query waves' prefetched misses):
its order, content, backpressure and queue bound, as
``tests/test_io_pipeline.py::TestPrefetcher`` holds the JAX package's;
the sync ``BucketCache``'s slot arena: pins, refills, pad rows, copy
guards and growth; sync and prefetch joins byte-identical in the port;
and the port's sync and prefetch joins against the JAX package's on the
same data."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import DiskJoinIndex as JIndex  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.compute import HostVerifyEngine  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.core.executor import PAD_COORD, BucketCache  # noqa: E402
from repro_torch.io import (BufferPool, PipelineStats,  # noqa: E402
                            SchedulePrefetcher)
from repro_torch.store.vector_store import (  # noqa: E402
    BucketedVectorStore, FlatVectorStore)
from torch_parity import assert_identical, assert_same_pairs  # noqa: E402

BASE = dict(pad_align=64, num_buckets=24, memory_budget_bytes=1 << 20,
            io_lookahead=6)
LATENCY = 2e-4  # emulated per-read latency: the prefetcher runs ahead


def _bucketed_store(tmp_path, num_buckets=12, rows=40, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, rows, size=num_buckets)
    centers = rng.normal(size=(num_buckets, dim)).astype(np.float32)
    radii = np.ones(num_buckets, np.float32)
    w = BucketedVectorStore.create(str(tmp_path / "bk"), dim, np.float32,
                                   sizes, centers, radii)
    vid = 0
    for b, n in enumerate(sizes):
        for _ in range(int(n)):
            w.append(b, rng.normal(size=dim).astype(np.float32), vid)
            vid += 1
    return w.finalize(), sizes


class TestPrefetcher:
    def test_delivers_schedule_order_with_content(self, tmp_path):
        store, sizes = _bucketed_store(tmp_path)
        cap = int(sizes.max())
        order = list(range(12)) + list(range(11, -1, -1))
        actions = [(b, False, None) for b in order]
        pool = BufferPool(4, cap, store.dim)
        pf = SchedulePrefetcher(store, actions, pool, lookahead=3,
                                num_threads=3)
        try:
            for b in order:
                bucket, slot, n = pf.pop_next()
                assert bucket == b
                assert n == int(sizes[b])
                ref_vecs, ref_ids = store.read_bucket(b)
                np.testing.assert_array_equal(pool.vecs(slot)[:n], ref_vecs)
                np.testing.assert_array_equal(pool.ids(slot)[:n], ref_ids)
                pool.unpin(slot)
        finally:
            pf.close()

    def test_backpressure_lookahead_exceeds_pool(self, tmp_path):
        """lookahead >> pool: the issue thread blocks on the pool (no
        crash, no dropped load) and drains as slabs free up."""
        store, sizes = _bucketed_store(tmp_path)
        order = list(range(12)) * 3
        actions = [(b, False, None) for b in order]
        pool = BufferPool(2, int(sizes.max()), store.dim)
        pf = SchedulePrefetcher(store, actions, pool, lookahead=64,
                                num_threads=2)
        try:
            import time
            time.sleep(0.05)  # let the issue thread reach the pool limit
            assert pool.in_use <= 2
            for b in order:
                bucket, slot, _ = pf.pop_next()
                assert bucket == b
                pool.unpin(slot)
            assert pool.blocked_acquires > 0
        finally:
            pf.close()

    def test_lookahead_bounds_queue_depth(self, tmp_path):
        store, sizes = _bucketed_store(tmp_path)
        order = list(range(12)) * 2
        actions = [(b, False, None) for b in order]
        stats = PipelineStats()
        pool = BufferPool(32, int(sizes.max()), store.dim)
        pf = SchedulePrefetcher(store, actions, pool, lookahead=3,
                                num_threads=2, stats=stats)
        try:
            for _ in order:
                _, slot, _ = pf.pop_next()
                pool.unpin(slot)
        finally:
            pf.close()
        assert 1 <= stats.max_queue_depth <= 3


class _Copy:
    """Stands in for the CUDA event after a slot's H2D copy."""

    def __init__(self, done: bool):
        self.done = done
        self.waits = 0

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.waits += 1
        self.done = True


def _arena(tmp_path, slots):
    store, sizes = _bucketed_store(tmp_path)
    stats = PipelineStats()
    return (BucketCache(store, sizes, int(sizes.max()), stats=stats,
                        slots=slots), store, sizes, stats)


class TestBucketCacheArena:
    def test_pins_hold_a_slot_until_every_release(self, tmp_path):
        cache, store, sizes, stats = _arena(tmp_path, 2)
        cache.load(0)
        a, b = cache.checkout(0), cache.checkout(0)
        slot = a[3]
        assert slot.refs == 3
        cache.evict(0)
        cache.release(a)
        cache.load(1)              # the free slot, not bucket 0's
        assert cache.get(1)[3] is not slot
        cache.load(2)              # 0's slot is still pinned: one more
        assert cache.get(2)[3] is not slot
        assert cache.slot_grows == stats.cache_slot_grows == 1
        ref_vecs, _ = store.read_bucket(0)
        np.testing.assert_array_equal(b[0][:b[2]], ref_vecs)
        cache.release(b)
        assert slot.refs == 0
        cache.evict(1)
        cache.load(3)              # the pool of three refills, no growth
        assert cache.slots == 3 and cache.slot_grows == 1

    def test_smaller_bucket_overwrites_a_larger_ones_rows(self, tmp_path):
        """A fresh slot and a slot a larger bucket held both read as the
        bucket's rows, then pad rows at ``PAD_COORD`` and ids -1."""
        cache, store, sizes, _ = _arena(tmp_path, 1)
        big, small = int(np.argmax(sizes)), int(np.argmin(sizes))
        assert sizes[big] > sizes[small]
        for b in (small, big, small):
            cache.load(b)
            vecs, ids, n, _ = cache.get(b)
            assert n == sizes[b]
            ref_vecs, ref_ids = store.read_bucket(b)
            np.testing.assert_array_equal(vecs[:n], ref_vecs)
            np.testing.assert_array_equal(ids[:n], ref_ids)
            assert (vecs[n:] == np.float32(PAD_COORD)).all()
            assert (ids[n:] == -1).all()
            cache.evict(b)
        assert cache.slots == 1

    @pytest.mark.parametrize("copies,waits,grows", [
        ((True,), 0, 0), ((False,), 0, 1), ((False, False), 1, 0),
        ((False, True), 0, 0)])
    def test_refill_waits_only_behind_two_copies(self, tmp_path, copies,
                                                 waits, grows):
        """A slot is refilled only once its last H2D copy has passed. With
        one copy in flight a new slot is made; with two, the load waits
        for the oldest; a finished copy costs neither."""
        cache, _, _, stats = _arena(tmp_path, len(copies))
        fakes = []
        for b, done in enumerate(copies):
            cache.load(b)
            fakes.append(_Copy(done))
            cache.get(b)[3].copy_done = fakes[-1]
        for b in range(len(copies)):
            cache.evict(b)
        cache.load(len(copies))
        assert sum(f.waits for f in fakes) == waits
        assert cache.slot_waits == stats.h2d_slot_waits == waits
        assert cache.slot_grows == stats.cache_slot_grows == grows

    def test_pending_host_batch_keeps_its_slabs(self, tmp_path):
        """Slabs evicted under a pending host batch are not refilled: the
        arena grows instead, counted, and the batch verifies the bytes it
        was given."""
        eps = 3.5
        store, sizes = _bucketed_store(tmp_path)
        out = []
        for slots in (2, 12):
            stats = PipelineStats()
            cache = BucketCache(store, sizes, int(sizes.max()),
                                stats=stats, slots=slots)
            eng = HostVerifyEngine(
                cache, epsilon=eps, capacity_rows=cache.capacity_rows,
                dim=store.dim, verify_batch=64, device=torch.device("cpu"),
                pstats=stats)
            cache.load(0)
            cache.load(1)
            eng.enqueue(0, 1, False)
            eng.enqueue(0, 0, True)
            cache.evict(0)
            cache.evict(1)
            for b in (2, 3):
                cache.load(b)
                eng.enqueue(b, b, True)
            eng.finish()
            assert stats.cache_slot_grows == (2 if slots == 2 else 0)
            pairs, dists = eng.results()
            out.append((np.concatenate(pairs), np.concatenate(dists)))
        assert out[0][0].shape[0] > 0
        np.testing.assert_array_equal(out[0][0], out[1][0])
        np.testing.assert_array_equal(out[0][1], out[1][1])


@pytest.fixture(scope="module")
def indexes(small_dataset, tmp_path_factory):
    x, eps = small_dataset
    tmp = tmp_path_factory.mktemp("io")
    cfg = dict(epsilon=eps, emulate_read_latency_s=LATENCY, **BASE)
    port = DiskJoinIndex.build(
        FlatVectorStore.from_array(str(tmp / "t.bin"), x), JoinConfig(**cfg),
        str(tmp / "t"), device="cpu")
    ref = JIndex.build(JFlat.from_array(str(tmp / "j.bin"), x),
                       JJoinConfig(**cfg), str(tmp / "j"))
    yield x, eps, port, ref
    port.close()
    ref.close()


@pytest.mark.parametrize("masked", [False, True])
def test_prefetch_join_matches_sync_and_jax(indexes, masked):
    """Prefetch and sync joins of the port are byte-identical, with and
    without an attribute mask; the prefetch join matches the JAX
    package's, and the prefetcher ran ahead of the executor."""
    x, eps, port, ref = indexes
    mask = (np.arange(x.shape[0]) % 3 != 0) if masked else None
    sync = port.self_join(attribute_mask=mask)
    pre = port.self_join(attribute_mask=mask, io_mode="prefetch")
    assert_identical(sync, pre)
    assert pre.bucket_loads == sync.bucket_loads
    j = ref.self_join(attribute_mask=mask, io_mode="prefetch")
    assert_same_pairs(x, eps, pre, j)
    assert pre.bucket_loads == j.bucket_loads
    if masked:
        assert mask[pre.pairs].all()
    pipe = pre.io_stats["pipeline"]
    assert pipe["loads"] == pre.bucket_loads
    assert 1 <= pipe["max_queue_depth"] <= BASE["io_lookahead"]
    assert pipe["read_s"] > 0.0


@pytest.mark.parametrize("mode", ["host", "device"])
def test_prefetch_compute_modes_match_sync_host(indexes, mode):
    """Every compute mode under prefetch gives the sync host join's bytes
    at a cache of a few buckets and slow reads, where the host engine's
    pending pins force the executor's stall flush; every pin returns to
    the pool."""
    x, eps, port, _ = indexes
    small = dict(memory_budget_bytes=1 << 17, emulate_read_latency_s=5e-3)
    sync = port.self_join(**small)
    pre = port.self_join(io_mode="prefetch", compute_mode=mode,
                         io_lookahead=16, **small)
    assert_identical(sync, pre)
    if mode == "host":
        assert pre.io_stats["pipeline"]["flush_on_stall"] > 0
    assert port._pool.in_use == 0


def test_prefetch_query_batch_matches_sync(indexes):
    x, eps, port, _ = indexes
    Q = x[200:230] + 0.001
    port.drop_warm_cache()
    sync = port.query_batch(Q)
    before = port.pipeline_snapshot()["query_reads"]
    port.drop_warm_cache()
    for mode in ("host", "device"):
        pre = port.query_batch(Q, io_mode="prefetch", compute_mode=mode)
        port.drop_warm_cache()
        for (si, sd), (pi, pd) in zip(sync, pre):
            a = dict(zip(si.tolist(), sd))
            b = dict(zip(pi.tolist(), pd))
            assert set(a) == set(b)
            np.testing.assert_allclose([a[k] for k in a],
                                       [b[k] for k in a], atol=1e-3)
    assert port.pipeline_snapshot()["query_reads"] > before


def test_worker_threads_make_no_torch_call(indexes):
    """The prefetcher's threads read with numpy only: a profile hook on
    every thread started during a prefetch join sees no frame of torch's
    code in the I/O threads."""
    x, eps, port, _ = indexes
    seen: list[str] = []
    io_frames = []

    def hook(frame, event, arg):
        if not threading.current_thread().name.startswith("diskjoin-io"):
            return
        io_frames.append(1)
        mod = frame.f_globals.get("__name__", "")
        if mod == "torch" or mod.startswith("torch."):
            seen.append(mod)

    threading.setprofile(hook)
    try:
        port.self_join(io_mode="prefetch", compute_mode="device")
    finally:
        threading.setprofile(None)
    assert io_frames, "no I/O thread ran"
    assert not seen, sorted(set(seen))


@pytest.mark.parametrize("override,mode", [
    (dict(), "host"),
    (dict(compute_mode="device"), "device"),
    (dict(plan_mode="on", compute_mode="auto", emulate_xfer_gb_s=50.0),
     "mixed"),
])
def test_sync_slot_arena_joins_match_jax(indexes, override, mode):
    """Sync joins at a cache of a few buckets, where pending host batches
    grow the slot arena: every compute mode gives the sync host join's
    bytes and the JAX package's pairs. On the CPU no slot is pinned, so
    every first touch is staged."""
    x, eps, port, ref = indexes
    small = dict(memory_budget_bytes=1 << 17)
    host = port.self_join(**small)
    t = port.self_join(**small, **override)
    assert (t.plan.compute_mode if t.plan else mode) == mode
    assert_identical(host, t)
    assert_same_pairs(x, eps, t, ref.self_join(**small, **override))
    pipe = t.io_stats["pipeline"]
    assert pipe["h2d_direct"] == pipe["h2d_slot_waits"] == 0
    if mode == "device":
        assert pipe["h2d_staged"] == pipe["h2d_transfers"] > 0
    else:   # the host engine counts two staging transfers a flush
        assert (pipe["h2d_staged"] > 0) == (mode == "mixed")
        assert pipe["h2d_staged"] < pipe["h2d_transfers"]
    assert (pipe["cache_slot_grows"] > 0) == (mode != "device")
