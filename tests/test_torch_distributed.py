"""The port's superstep join (``repro_torch.core.distributed``), its join
checkpoints and the ``runtime`` helpers against the JAX package's, on the
CPU: the same plan and counts on the same bucketed store, the pair
contract against the JAX join, byte parity with the port's single-box
join in both compute modes and at any ``verify_batch``, kill/resume byte
parity, and checkpoint chains that restore across the two packages."""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.runtime as jruntime  # noqa: E402
import repro_torch.runtime as truntime  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.core import build_bucket_graph as jbuild_graph  # noqa: E402
from repro.core import bucketize as jbucketize  # noqa: E402
from repro.core.distributed import DistributedJoin as JDist  # noqa: E402
from repro.core.distributed import plan_supersteps as jplan  # noqa: E402
from repro.ft import JoinCheckpointer as JCheckpointer  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.core import (BucketGraph, BucketMeta,  # noqa: E402
                              JoinConfig, JoinExecutor)
from repro_torch.core.distributed import (DistributedJoin,  # noqa: E402
                                          plan_supersteps)
from repro_torch.data import (clustered_vectors,  # noqa: E402
                              epsilon_for_avg_neighbors)
from repro_torch.ft import (FaultInjector, InjectedKill,  # noqa: E402
                            JoinCheckpointer)
from repro_torch.store.vector_store import (  # noqa: E402
    BucketedVectorStore)
from torch_parity import assert_identical, assert_same_pairs  # noqa: E402

# tests/test_ft.py's checkpoint configuration: many supersteps, so a kill
# lands between commits
FT_CFG = dict(epsilon=0.3, recall_target=0.95, pad_align=64,
              memory_budget_bytes=128 << 10, num_buckets=24)
# tests/test_join_integration.py's superstep configuration
JOIN_CFG = dict(recall_target=0.95, pad_align=64,
                memory_budget_bytes=4 << 20, num_buckets=24)


def _ft_data():
    return clustered_vectors(3000, 32, seed=4), FT_CFG


def _join_data():
    x = clustered_vectors(4000, 32, seed=5)
    return x, dict(JOIN_CFG, epsilon=epsilon_for_avg_neighbors(x, 10))


DATA = {"ft": _ft_data, "join": _join_data}


def _same_store(tmp_path, x, cfg):
    """Bucketize once with the JAX package; both packages read those
    files. Returns (x, the JAX (store, meta, graph), the port's)."""
    jstore = JFlat.from_array(str(tmp_path / "x.bin"), x)
    jcfg = JJoinConfig(**cfg)
    jbs, jmeta, _ = jbucketize(jstore, str(tmp_path / "bk"), jcfg)
    jgraph = jbuild_graph(jmeta, jcfg)
    bs = BucketedVectorStore(str(tmp_path / "bk"))
    meta = BucketMeta(centers=jmeta.centers, radii=jmeta.radii,
                      sizes=jmeta.sizes)
    graph = BucketGraph(num_nodes=jgraph.num_nodes, edges=jgraph.edges)
    return (jbs, jmeta, jgraph), (bs, meta, graph)


@pytest.fixture(scope="module", params=sorted(DATA))
def stores(request, tmp_path_factory):
    x, cfg = DATA[request.param]()
    j, t = _same_store(tmp_path_factory.mktemp(request.param), x, cfg)
    return x, cfg, j, t


@pytest.fixture(scope="module")
def ft_both(tmp_path_factory):
    x, cfg = _ft_data()
    return _same_store(tmp_path_factory.mktemp("ftstore"), x, cfg)


@pytest.fixture(scope="module")
def ft_store(ft_both):
    return ft_both[1]


def _result(pairs, info):
    return types.SimpleNamespace(pairs=pairs, distances=info["dists"])


def _dist(store, cfg_kw, **over):
    bs, meta, _ = store
    return DistributedJoin(bs, meta, JoinConfig(**dict(cfg_kw, **over)),
                           device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package, on the same store
# ---------------------------------------------------------------------------
def test_plan_supersteps_matches_jax(stores):
    _, cfg, (_, jmeta, jgraph), (bs, meta, graph) = stores
    dj = _dist((bs, meta, graph), cfg)
    mine = plan_supersteps(graph, JoinConfig(**cfg), dj.cache_buckets,
                           meta=meta)
    ref = jplan(jgraph, JJoinConfig(**cfg), dj.cache_buckets, meta=jmeta)
    assert len(mine) == len(ref) >= 1
    for a, b in zip(mine, ref):
        for f in ("bucket_ids", "edges_local", "edges_global"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("mode", ["host", "device"])
def test_superstep_join_matches_jax(stores, mode):
    x, cfg, (jbs, jmeta, jgraph), (bs, meta, graph) = stores
    pairs, info = _dist((bs, meta, graph), cfg,
                        compute_mode=mode).run(graph)
    jpairs, jinfo = JDist(jbs, jmeta, JJoinConfig(
        compute_mode=mode, **cfg)).run(jgraph)
    assert_same_pairs(x, cfg["epsilon"], _result(pairs, info),
                      _result(jpairs, jinfo))
    # these follow from the plan alone
    for k in ("supersteps", "host_loads", "host_hits", "prefetched_buckets",
              "distance_computations"):
        assert info[k] == jinfo[k], k
    if mode == "device":
        for k in ("h2d_transfers", "device_slab_hits", "h2d_bytes"):
            assert info[k] == jinfo[k], k
        assert info["h2d_transfers"] <= info["host_loads"]
    assert set(info) == set(jinfo)


# ---------------------------------------------------------------------------
# against the port's single-box join
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def single_box(stores):
    _, cfg, _, (bs, meta, graph) = stores
    return JoinExecutor(bs, meta, JoinConfig(**cfg),
                        device="cpu").run(graph)


@pytest.mark.parametrize("verify_batch", [1, 4, 32])
@pytest.mark.parametrize("mode", ["host", "device"])
def test_superstep_join_is_the_single_box_join(stores, single_box, mode,
                                               verify_batch):
    """The same bytes as ``JoinExecutor`` (pairs and distances), whatever
    the chunking of a superstep's edges."""
    _, cfg, _, (bs, meta, graph) = stores
    pairs, info = _dist((bs, meta, graph), cfg, compute_mode=mode,
                        verify_batch=verify_batch).run(graph)
    assert_identical(_result(pairs, info), single_box)
    assert info["distance_computations"] == \
        single_box.num_distance_computations


@pytest.mark.parametrize("verify_batch", [1, 4])
def test_compaction_overflow_redispatch_keeps_bytes(stores, single_box,
                                                   verify_batch):
    """A compaction capacity of one pair makes every chunk with a pair
    overflow: each is re-dispatched at a larger, sticky capacity, and the
    bytes stay the single-box join's."""
    _, cfg, _, (bs, meta, graph) = stores
    dj = _dist((bs, meta, graph), cfg, compute_mode="device",
               verify_batch=verify_batch)
    caps = []
    extract = dj._extract_compact

    def spy(*a):
        out = extract(*a)
        caps.append(dj._pair_cap)
        return out

    dj._pair_cap = 1
    dj._extract_compact = spy
    pairs, info = dj.run(graph)
    assert_identical(_result(pairs, info), single_box)
    assert caps[-1] > 1
    assert caps == sorted(caps)  # the sticky capacity never shrinks


def test_keep_set_counts(tmp_path):
    """tests/test_striping.py's windows {0,1},{1,2},{1,5},{2,3},{3,4},{5}:
    keeping the upcoming window retains the gap-skipping buckets —
    6 loads, 5 hits."""
    num_buckets, dim = 6, 4
    sizes = np.full(num_buckets, 2, np.int64)
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(num_buckets, dim)).astype(np.float32)
    w = BucketedVectorStore.create(str(tmp_path / "bk"), dim, np.float32,
                                   sizes, centers,
                                   np.ones(num_buckets, np.float32))
    vid = 0
    for b, n in enumerate(sizes):
        for _ in range(int(n)):
            w.append(b, rng.normal(size=dim).astype(np.float32), vid)
            vid += 1
    store = w.finalize()
    meta = BucketMeta(centers=centers, radii=np.ones(6, np.float32),
                      sizes=sizes)
    graph = BucketGraph(num_nodes=6, edges=np.array([[1, 2], [1, 5], [3, 4]],
                                                    dtype=np.int64))
    cfg = JoinConfig(epsilon=10.0, reorder=False, bucket_capacity=8,
                     pad_align=8, num_buckets=6,
                     memory_budget_bytes=2 * 8 * 4 * 4)  # 2 slots
    dj = DistributedJoin(store, meta, cfg, device="cpu")
    assert dj.cache_buckets == 2
    pairs, info = dj.run(graph)
    assert info["host_loads"] == 6
    assert info["host_hits"] == 5
    assert pairs.shape[0] > 0


def test_refusals(ft_store, monkeypatch):
    bs, meta, _ = ft_store
    with pytest.raises(ValueError, match="'data' axis"):
        DistributedJoin(bs, meta, JoinConfig(**FT_CFG),
                        mesh=types.SimpleNamespace(shape={"model": 2}),
                        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedJoin(bs, meta, JoinConfig(**FT_CFG))


# ---------------------------------------------------------------------------
# join checkpoints (tests/test_ft.py's TestJoinCheckpointer on the port)
# ---------------------------------------------------------------------------
class TestJoinCheckpointer:
    def test_checkpointed_run_matches_plain(self, ft_store, tmp_path):
        dj = _dist(ft_store, FT_CFG)
        graph = ft_store[2]
        base_pairs, base_info = dj.run(graph)
        ck = JoinCheckpointer(str(tmp_path / "ck"))
        pairs, info = dj.run(graph, checkpointer=ck)
        assert np.array_equal(pairs, base_pairs)
        assert np.array_equal(info["dists"], base_info["dists"])
        assert info["ckpt"]["saves"] > 0

    @pytest.mark.parametrize("mode", ["host", "device"])
    def test_kill_and_resume_byte_parity(self, ft_store, tmp_path, mode):
        dj = _dist(ft_store, FT_CFG, compute_mode=mode)
        graph = ft_store[2]
        base_pairs, base_info = dj.run(graph)
        assert base_info["supersteps"] > 3
        kill_at = max(1, int(base_info["supersteps"] * 0.6))

        ckdir = str(tmp_path / "ck")
        ck = JoinCheckpointer(ckdir)
        fi = FaultInjector(kill_at_superstep=kill_at)
        with pytest.raises(InjectedKill):
            dj.run(graph, checkpointer=ck, fault=fi)
        assert fi.kills == 1
        ck.finish()  # flush the async writer before reopening the dir

        ck2 = JoinCheckpointer(ckdir)
        pairs, info = dj.run(graph, checkpointer=ck2, resume_from=ckdir)
        assert info["resumed_at"] > 0
        assert info["restore_s"] >= 0.0
        assert np.array_equal(pairs, base_pairs)
        assert np.array_equal(info["dists"], base_info["dists"])
        assert info["watermark_rows"] == base_info["watermark_rows"]

    def test_resume_skips_committed_supersteps(self, ft_store, tmp_path):
        dj = _dist(ft_store, FT_CFG)
        graph = ft_store[2]
        _, base_info = dj.run(graph)
        kill_at = max(1, int(base_info["supersteps"] * 0.6))
        ckdir = str(tmp_path / "ck")
        ck = JoinCheckpointer(ckdir)
        with pytest.raises(InjectedKill):
            dj.run(graph, checkpointer=ck,
                   fault=FaultInjector(kill_at_superstep=kill_at))
        ck.finish()
        _, info = dj.run(graph, resume_from=ckdir)
        assert 0 < info["resumed_at"] <= kill_at

    def test_restore_refuses_fingerprint_mismatch(self, ft_store, tmp_path):
        dj = _dist(ft_store, FT_CFG)
        graph = ft_store[2]
        ckdir = str(tmp_path / "ck")
        dj.run(graph, checkpointer=JoinCheckpointer(ckdir))
        with pytest.raises(ValueError, match="fingerprint"):
            JoinCheckpointer.restore(ckdir, fingerprint="deadbeef")
        dj2 = _dist(ft_store, FT_CFG, epsilon=0.31)
        with pytest.raises(ValueError, match="refusing to resume"):
            dj2.run(graph, resume_from=ckdir)

    def test_torn_tmp_checkpoint_ignored_and_reaped(self, ft_store,
                                                    tmp_path):
        dj = _dist(ft_store, FT_CFG)
        graph = ft_store[2]
        ckdir = str(tmp_path / "ck")
        base_pairs, _ = dj.run(graph, checkpointer=JoinCheckpointer(ckdir))
        FaultInjector.tear_checkpoint(ckdir)
        assert any(n.endswith(".tmp") for n in os.listdir(ckdir))
        rs = JoinCheckpointer.restore(ckdir, fingerprint=dj.fingerprint())
        assert rs is not None
        assert not any(n.endswith(".tmp") for n in os.listdir(ckdir))
        pairs, _ = dj.run(graph, resume_from=ckdir)
        assert np.array_equal(pairs, base_pairs)

    def test_restore_empty_dir_returns_none(self, tmp_path):
        assert JoinCheckpointer.restore(str(tmp_path / "nope"),
                                        fingerprint="x") is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_chain_restores_across_packages(ft_both, tmp_path,
                                                   writer):
    """A chain written by either package's ``JoinCheckpointer`` restores
    in the other to the same ``ResumeState``; equal configs give one
    fingerprint in both packages."""
    (jbs, jmeta, jgraph), (bs, meta, graph) = ft_both
    dj = _dist((bs, meta, graph), FT_CFG)
    jdj = JDist(jbs, jmeta, JJoinConfig(**FT_CFG))
    assert dj.fingerprint() == jdj.fingerprint()
    ckdir = str(tmp_path / "ck")
    if writer == "jax":
        jdj.run(jgraph, checkpointer=JCheckpointer(ckdir, every=2))
    else:
        dj.run(graph, checkpointer=JoinCheckpointer(ckdir, every=2))
    mine = JoinCheckpointer.restore(ckdir, fingerprint=dj.fingerprint())
    ref = JCheckpointer.restore(ckdir, fingerprint=jdj.fingerprint())
    assert mine.superstep == ref.superstep > 0
    assert mine.watermark_rows == ref.watermark_rows > 0
    assert len(mine.pairs) == len(ref.pairs) > 0
    for a, b in zip(mine.pairs + mine.dists, ref.pairs + ref.dists):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# ---------------------------------------------------------------------------
# runtime: the JAX package's outputs on its own cases
# ---------------------------------------------------------------------------
def test_runtime_exports_the_reference_names():
    assert truntime.__all__ == jruntime.__all__


@pytest.mark.parametrize("chips", [0, 1, 8, 200, 256, 512, 1000])
@pytest.mark.parametrize("batch", [6, 256, 1000])
def test_plan_mesh_matches_jax(chips, batch):
    mine = truntime.plan_mesh(chips, global_batch=batch)
    ref = jruntime.plan_mesh(chips, global_batch=batch)
    if ref is None:
        assert mine is None
    else:
        assert (mine.pod, mine.data, mine.model, mine.chips, mine.axes()) \
            == (ref.pod, ref.data, ref.model, ref.chips, ref.axes())


def _elastic_events(rt):
    t = [0.0]
    reg = rt.HeartbeatRegistry(timeout_s=10, clock=lambda: t[0])
    for h in ("h0", "h1", "h2", "h3"):
        reg.heartbeat(h, chips=128)
    ctl = rt.ElasticController(reg, global_batch=256)
    out = [ctl.evaluate()]
    t[0] = 20.0  # h* all stale
    reg.heartbeat("h0", chips=128)
    reg.heartbeat("h1", chips=128)
    out.append(ctl.evaluate())
    out.append(ctl.evaluate())
    for h in ("h2", "h3"):
        reg.heartbeat(h, chips=128)
    out.append(ctl.evaluate())
    return [(e.kind, None if e.new_plan is None
             else (e.new_plan.pod, e.new_plan.data, e.new_plan.model))
            for e in out], sorted(reg.live_hosts()), reg.live_chips()


def _straggler_outcome(rt):
    mon = rt.HostMonitor(threshold=1.5, patience=2)
    newly = []
    for _ in range(6):
        for h in ("a", "b", "c"):
            mon.record(h, 1.0)
        mon.record("slow", 5.0)
        newly.append(mon.evaluate())
    assign = {"a": [1], "b": [2], "c": [], "slow": [3, 4]}
    out = rt.rebalance_edges(assign, ["slow"], mon.healthy_hosts())
    t = rt.StepTimer()
    flags = [t.record(0.1) for _ in range(20)] + [t.record(1.0)]
    return newly, mon.healthy_hosts(), out, flags, t.report()


@pytest.mark.parametrize("case", [_elastic_events, _straggler_outcome])
def test_runtime_matches_jax(case):
    assert case(truntime) == case(jruntime)


def test_rebalance_without_healthy_hosts_raises():
    with pytest.raises(RuntimeError, match="no healthy hosts"):
        truntime.rebalance_edges({"a": [1]}, ["a"], [])
