"""The port's prefetch I/O (``repro_torch.io.prefetcher``, the executor's
``io_mode="prefetch"`` and the query waves' prefetched misses): the
prefetcher's order, content, backpressure and queue bound, as
``tests/test_io_pipeline.py::TestPrefetcher`` holds the JAX package's;
sync and prefetch joins byte-identical in the port; and the port's
prefetch join against the JAX package's on the same data."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import DiskJoinIndex as JIndex  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
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
