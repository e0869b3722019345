"""The port's spans inside its two host loops, on the CPU: the join's
graph, node order and dedup, slab staging, device waits and result
fan-out, and a query wave's staging, launch, wait and fan-out. Each span
appears where its work runs, as often as that work runs, nested inside
the span that the benchmark's rooflines read; tracing changes no byte."""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.data import clustered_vectors  # noqa: E402
from repro_torch.kernels import pairwise_l2  # noqa: E402
from repro_torch.obs import trace_session  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402

EPS = 0.35
CFG = dict(epsilon=EPS, recall_target=0.9, pad_align=64, num_buckets=20,
           memory_budget_bytes=1 << 20)
TOL_US = 1e-3   # float rounding of the exported µs timestamps


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    x = clustered_vectors(2500, 24, seed=9)
    DiskJoinIndex.build(
        FlatVectorStore.from_array(str(root / "x.bin"), x),
        JoinConfig(**CFG), str(root / "idx"), device="cpu").close()
    return x, str(root / "idx")


@pytest.fixture
def fresh(index_dir):
    """A new session over the built index: its graph and node order are
    not cached yet."""
    x, path = index_dir
    idx = DiskJoinIndex.open(path, device="cpu")
    yield x, idx
    idx.close()


def _spans(events, name):
    return [e for e in events if e["ph"] == "X" and e["name"] == name]


def _inside(child, parents) -> bool:
    end = child["ts"] + child["dur"]
    return any(p["tid"] == child["tid"]
               and p["ts"] - TOL_US <= child["ts"]
               and end <= p["ts"] + p["dur"] + TOL_US for p in parents)


def _traced_join(idx):
    with trace_session(ring_capacity=1 << 18) as tr:
        res = idx.self_join(compute_mode="device")
    assert tr.dropped == 0
    return res, tr.events()


def test_graph_and_order_spans_only_on_a_cache_miss(fresh):
    _, idx = fresh
    _, first = _traced_join(idx)
    _, second = _traced_join(idx)
    for name, arg in (("join.graph", "buckets"), ("join.order", "strategy")):
        spans = _spans(first, name)
        assert len(spans) == 1, name
        assert arg in spans[0]["args"]
        assert _spans(second, name) == [], name
    assert _spans(first, "join.graph")[0]["args"]["buckets"] == \
        idx.meta.num_buckets
    assert _spans(first, "join.order")[0]["args"]["strategy"] == "gorder"


def test_dedup_span_once_a_join_after_the_walk(fresh):
    _, idx = fresh
    for _ in range(2):
        res, events = _traced_join(idx)
        dedup = _spans(events, "join.dedup")
        run = _spans(events, "join.run")
        assert len(dedup) == 1 and len(run) == 1
        assert dedup[0]["ts"] >= run[0]["ts"] + run[0]["dur"] - TOL_US
        # the engine emits each pair once here: nothing to drop, and the
        # count before dedup is the result's
        assert dedup[0]["args"]["pairs"] >= res.pairs.shape[0] > 0


def test_stage_and_sync_spans_count_the_pipelines_events(fresh):
    _, idx = fresh
    res, events = _traced_join(idx)
    pipe = res.io_stats["pipeline"]
    stages = _spans(events, "h2d.stage")
    assert len(stages) == pipe["h2d_transfers"] > 0
    assert sum(e["args"]["bytes"] for e in stages) == pipe["h2d_bytes"]
    assert not [e for e in events if e["name"] == "h2d.stage"
                and e["ph"] != "X"]
    syncs = _spans(events, "device.sync")
    assert len(syncs) == pipe["device_batches"] > 0
    assert len(_spans(events, "verify.emit")) == pipe["device_batches"]
    # a bucket is staged once a residency: no more than its loads
    assert pipe["h2d_transfers"] <= res.bucket_loads


def test_join_spans_nest_in_the_walk_or_the_collect(fresh):
    _, idx = fresh
    _, events = _traced_join(idx)
    outer = _spans(events, "join.run") + _spans(events, "verify.collect")
    for name in ("h2d.stage", "device.sync", "verify.emit"):
        spans = _spans(events, name)
        assert spans, name
        assert all(_inside(e, outer) for e in spans), name
    collects = _spans(events, "verify.collect")
    for name in ("device.sync", "verify.emit"):
        assert all(_inside(e, collects) for e in _spans(events, name))
    emitted = sum(e["args"]["pairs"] for e in _spans(events, "verify.emit"))
    dedup = _spans(events, "join.dedup")[0]["args"]["pairs"]
    assert emitted == dedup


def test_query_wave_spans_once_a_verified_bucket(fresh):
    x, idx = fresh
    Q = x[:200] + np.float32(1e-3)
    before = idx.stats.snapshot()["h2d_transfers"]
    with trace_session(ring_capacity=1 << 18) as tr:
        answers = idx.query_batch(Q, compute_mode="device")
    events = tr.events()
    staged = idx.stats.snapshot()["h2d_transfers"] - before - 1  # - Q
    execute = _spans(events, "query.execute")
    assert len(execute) == 1
    names = ("h2d.stage", "query.launch", "device.sync", "query.emit")
    buckets = {}
    for name in names:
        spans = _spans(events, name)
        assert all(_inside(e, execute) for e in spans), name
        count = collections.Counter(e["args"]["bucket"] for e in spans)
        assert set(count.values()) == {1}, name
        buckets[name] = set(count)
    assert len(buckets["h2d.stage"]) == staged > 0
    assert all(b == buckets["h2d.stage"] for b in buckets.values())
    assert {e["args"]["queries"] for e in _spans(events, "query.launch")} \
        <= set(range(1, Q.shape[0] + 1))
    members = sum(e["args"]["members"] for e in _spans(events, "query.emit"))
    assert members == sum(ids.size for ids, _ in answers) > 0


def test_query_wave_overflow_keeps_one_span_each(fresh):
    """A bucket whose members overflow the compaction's first capacity
    relaunches inside its ``device.sync``: still one span of each kind a
    bucket, and the answers of an untraced wave."""
    x, idx = fresh
    Q = np.repeat(x[:4], 100, axis=0) + np.float32(1e-3)
    plain = idx.query_batch(Q, compute_mode="device")
    with trace_session(ring_capacity=1 << 18) as tr:
        traced = idx.query_batch(Q, compute_mode="device")
    events = tr.events()
    assert max(e["args"]["members"]
               for e in _spans(events, "query.emit")) > 256
    for name in ("h2d.stage", "query.launch", "device.sync", "query.emit"):
        count = collections.Counter(e["args"]["bucket"]
                                    for e in _spans(events, name))
        assert set(count.values()) == {1}, name
    for (ia, da), (ib, db) in zip(plain, traced):
        assert ia.tobytes() == ib.tobytes() and da.tobytes() == db.tobytes()


def test_traced_and_untraced_joins_give_the_same_bytes(index_dir):
    x, path = index_dir
    out = []
    for traced in (False, True):
        idx = DiskJoinIndex.open(path, device="cpu")
        try:
            if traced:
                res, _ = _traced_join(idx)
            else:
                res = idx.self_join(compute_mode="device")
        finally:
            idx.close()
        out.append((res.pairs.tobytes(), res.distances.tobytes()))
    assert out[0] == out[1]
    assert len(out[0][0]) > 0


def _rechecks(events):
    return [e for e in events
            if e["ph"] == "i" and e["name"] == "verify.rechecks"]


def test_one_recheck_instant_a_traced_join(fresh, monkeypatch):
    """A traced device-mode join records one ``verify.rechecks`` instant,
    after its last collect and inside ``join.run``; the CPU path launches
    no kernel, so it counts 0 pairs. An untraced join opens no tally, and
    a traced one inside a tally already open leaves it alone and records
    nothing."""
    _, idx = fresh
    _, events = _traced_join(idx)
    marks = _rechecks(events)
    assert len(marks) == 1
    last = max(c["ts"] + c["dur"] for c in _spans(events, "verify.collect"))
    (run,) = _spans(events, "join.run")
    assert last - TOL_US <= marks[0]["ts"] <= run["ts"] + run["dur"] + TOL_US
    assert marks[0]["args"] == {"pairs": 0}
    assert pairwise_l2.RECHECKS is None
    opened = []
    real = pairwise_l2.counting_rechecks
    monkeypatch.setattr(pairwise_l2, "counting_rechecks",
                        lambda dev: opened.append(dev) or real(dev))
    idx.self_join(compute_mode="device")
    assert opened == [] and pairwise_l2.RECHECKS is None
    with real(torch.device("cpu")) as outer:
        _, events = _traced_join(idx)
        assert pairwise_l2.RECHECKS is outer
    assert opened == [] and _rechecks(events) == []
