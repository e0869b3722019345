"""The port's slice as a whole — ``DiskJoinIndex.build`` → ``self_join``
(host and device) → ``query_batch`` (host and device) — against the JAX
package's ``DiskJoinIndex`` on the same data and config, plus the on-disk
index opening across the two packages."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import DiskJoinIndex as JIndex  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.core.join import similarity_self_join  # noqa: E402
from repro_torch.data import brute_force_pairs  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402
from torch_parity import (assert_identical, assert_same_file,  # noqa: E402
                          assert_same_pairs)

BASE = dict(pad_align=64, num_buckets=24, memory_budget_bytes=1 << 20)
EVENT_COUNTERS = ("h2d_transfers", "h2d_transfers_saved", "device_slab_hits",
                  "device_batches", "device_compact_overflows")


@pytest.fixture(scope="module")
def built(small_dataset, tmp_path_factory):
    x, eps = small_dataset
    tmp = tmp_path_factory.mktemp("slice")
    cfg = dict(epsilon=eps, **BASE)
    port = DiskJoinIndex.build(
        FlatVectorStore.from_array(str(tmp / "t.bin"), x), JoinConfig(**cfg),
        str(tmp / "tidx"), device="cpu")
    ref = JIndex.build(JFlat.from_array(str(tmp / "j.bin"), x),
                       JJoinConfig(**cfg), str(tmp / "jidx"))
    yield x, eps, port, ref, tmp
    port.close()
    ref.close()


def test_self_join_host_and_device_match_jax(built):
    x, eps, port, ref, _ = built
    th = port.self_join()
    td = port.self_join(compute_mode="device")
    jh = ref.self_join()
    jd = ref.self_join(compute_mode="device")
    # the port's two compute modes: byte-identical
    assert np.array_equal(th.pairs, td.pairs)
    assert np.array_equal(th.distances, td.distances)
    assert th.pairs.shape[0] > 1000
    for t in (th, td):
        assert_same_pairs(x, eps, t, jh)
        assert t.num_distance_computations == jh.num_distance_computations
        assert t.bucket_loads == jh.bucket_loads
        assert t.num_candidate_pairs == jh.num_candidate_pairs
    tp, jp = td.io_stats["pipeline"], jd.io_stats["pipeline"]
    for k in EVENT_COUNTERS:
        assert tp[k] == jp[k], k
    assert tp["h2d_transfers"] > 0 and tp["device_slab_hits"] > 0
    # the CPU's slot arena is not pinned: every first touch is staged
    assert (tp["h2d_staged"], tp["h2d_direct"]) == (tp["h2d_transfers"], 0)
    assert set(th.timings) >= {"bucketing", "graph", "orchestration",
                               "execute", "io_wait", "compute"}


def test_self_join_recall_against_brute_force(built):
    x, eps, port, _, _ = built
    from repro_torch.core import recall
    r = port.self_join(compute_mode="device")
    assert recall(r.pairs, brute_force_pairs(x, eps)) >= 0.9


@pytest.mark.parametrize("mode", ["host", "device"])
def test_query_batch_matches_jax(built, mode):
    x, eps, port, ref, _ = built
    Q = x[:40] + 0.001
    tq = port.query_batch(Q, compute_mode=mode)
    jq = ref.query_batch(Q, compute_mode=mode)
    th = port.query_batch(Q) if mode == "device" else tq
    total = 0
    for qi, ((ti, td), (ji, jd), (hi, _)) in enumerate(zip(tq, jq, th)):
        a = dict(zip(ti.tolist(), td))
        b = dict(zip(ji.tolist(), jd))
        q64 = Q[qi].astype(np.float64)
        for diff in (set(a) ^ set(b), set(a) ^ set(hi.tolist())):
            for v in diff:   # only ε-boundary members may differ
                d2 = ((x[v].astype(np.float64) - q64) ** 2).sum()
                assert abs(d2 - eps * eps) <= 1e-4
        common = sorted(set(a) & set(b))
        total += len(common)
        np.testing.assert_allclose([a[k] for k in common],
                                   [b[k] for k in common], atol=1e-3)
    assert total > 40


def test_query_device_counts_one_staging_per_wave(built):
    x, eps, port, _, _ = built
    base = port.pipeline_snapshot()
    port.drop_warm_cache()
    out = port.query_batch(x[100:120], compute_mode="device")
    snap = port.pipeline_snapshot()
    assert all(ids.size > 0 for ids, _ in out)   # each query finds itself
    assert snap["h2d_transfers"] > base["h2d_transfers"]
    assert snap["h2d_transfers_saved"] > base["h2d_transfers_saved"]
    assert snap["queries"] == base["queries"] + 20


def test_query_single_and_probes(built):
    x, eps, port, _, _ = built
    ids, dists = port.query(x[7], epsilon=eps)
    assert 7 in ids.tolist()
    per_q = port.plan_probes(x[:3])
    out = port.execute_probes(x[:3], per_q)
    assert [set(i.tolist()) for i, _ in out] == \
        [set(i.tolist()) for i, _ in port.query_batch(x[:3])]
    with pytest.raises(ValueError):
        port.query(np.full(x.shape[1], np.nan, np.float32))


def test_index_built_by_jax_opens_in_port(built):
    x, eps, port, ref, tmp = built
    opened = DiskJoinIndex.open(str(tmp / "jidx"), device="cpu")
    try:
        r = opened.self_join(compute_mode="device")
        j = ref.self_join()
        assert_same_pairs(x, eps, r, j)
        assert r.bucket_loads == j.bucket_loads
    finally:
        opened.close()


def test_index_built_by_port_opens_in_jax(built):
    x, eps, port, ref, tmp = built
    opened = JIndex.open(str(tmp / "tidx"))
    try:
        j = opened.self_join()
        t = port.self_join()
        assert_same_pairs(x, eps, t, j)
        assert j.num_distance_computations == t.num_distance_computations
        assert len(opened.query_batch(x[:5])) == 5
    finally:
        opened.close()


def test_reopen_in_port_gives_identical_join(built):
    x, eps, port, _, tmp = built
    again = DiskJoinIndex.open(str(tmp / "tidx"), device="cpu")
    try:
        a, b = again.self_join(), port.self_join()
        assert np.array_equal(a.pairs, b.pairs)
        assert np.array_equal(a.distances, b.distances)
    finally:
        again.close()


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32)
    store = FlatVectorStore.from_array(str(tmp_path / "x.bin"), x)
    cfg = JoinConfig(epsilon=0.5, pad_align=64, num_buckets=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiskJoinIndex.build(store, cfg, str(tmp_path / "i"))
    with pytest.raises(RuntimeError, match="CUDA"):
        similarity_self_join(store, cfg, str(tmp_path / "j"))
    DiskJoinIndex.build(store, cfg, str(tmp_path / "k"), device="cpu").close()
    with pytest.raises(RuntimeError, match="CUDA"):
        DiskJoinIndex.open(str(tmp_path / "k"))


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_one_shot_self_join_matches_session(tmp_path, small_dataset):
    x, eps = small_dataset
    x = x[:1500]
    cfg = JoinConfig(epsilon=eps, **BASE)
    store = FlatVectorStore.from_array(str(tmp_path / "x.bin"), x)
    r = similarity_self_join(store, cfg, str(tmp_path / "w"), device="cpu")
    with DiskJoinIndex.build(store, cfg, str(tmp_path / "s"),
                             device="cpu") as index:
        s = index.self_join()
    assert np.array_equal(r.pairs, s.pairs)
    assert np.array_equal(r.distances, s.distances)
    assert r.timings["bucketing"] > 0 == s.timings["bucketing"]


@pytest.mark.parametrize("override,item", [
    (dict(io_mode="prefetch"), "prefetch"),
    (dict(plan_mode="on", compute_mode="auto"), "planner"),
    (dict(io_mode="prefetch", plan_mode="on", compute_mode="device"),
     "prefetch-planner"),
])
def test_unported_options_raise(built, override, item):
    """Prefetch I/O and the planner, alone and together: the port's join
    matches the JAX package's under the same options, and its own default
    join byte for byte (they change when reads happen and how work is
    sized, never the result)."""
    x, eps, port, ref, _ = built
    t = port.self_join(**override)
    assert_identical(t, port.self_join())
    j = ref.self_join(**override)
    assert_same_pairs(x, eps, t, j)
    assert t.bucket_loads == j.bucket_loads
    assert t.num_distance_computations == j.num_distance_computations
    if "plan_mode" in override:
        assert (t.plan.pair_cap, t.plan.compute_mode, t.plan.unit_params) \
            == (j.plan.pair_cap, j.plan.compute_mode, j.plan.unit_params)
    if override.get("io_mode") == "prefetch":
        assert t.io_stats["pipeline"]["loads"] == t.bucket_loads


def _store_files(prefix):
    d, base = os.path.split(str(prefix))
    return sorted(f for f in os.listdir(d) if f.startswith(base))


def test_unported_build_options_raise(tmp_path):
    """A striped build (``io_devices > 1``) writes the JAX package's files
    (byte for byte but the radii, see ``assert_same_file``), and the two
    indexes join alike."""
    x = np.random.default_rng(8).normal(size=(700, 8)).astype(np.float32)
    cfg = dict(epsilon=1.0, io_devices=2, pad_align=64, num_buckets=8,
               memory_budget_bytes=1 << 20)
    port = DiskJoinIndex.build(
        FlatVectorStore.from_array(str(tmp_path / "x.bin"), x),
        JoinConfig(**cfg), str(tmp_path / "i"), device="cpu")
    ref = JIndex.build(JFlat.from_array(str(tmp_path / "j.bin"), x),
                       JJoinConfig(**cfg), str(tmp_path / "j"))
    try:
        assert port.store.num_devices == 2
        files = _store_files(tmp_path / "i" / "buckets")
        assert files == _store_files(tmp_path / "j" / "buckets")
        assert any(".d1" in f for f in files)
        for f in files:
            assert_same_file(tmp_path / "i" / f, tmp_path / "j" / f)
        assert_same_pairs(x, 1.0, port.self_join(), ref.self_join())
    finally:
        port.close()
        ref.close()


def test_coalesced_layout_build_matches_jax(tmp_path, small_dataset):
    """``io_coalesce`` lays extents out in schedule order at build time;
    the port plans the same order, so the stores agree byte for byte."""
    x, eps = small_dataset
    cfg = dict(epsilon=eps, io_coalesce=True, **BASE)
    port = DiskJoinIndex.build(
        FlatVectorStore.from_array(str(tmp_path / "t.bin"), x),
        JoinConfig(**cfg), str(tmp_path / "t"), device="cpu")
    ref = JIndex.build(JFlat.from_array(str(tmp_path / "j.bin"), x),
                       JJoinConfig(**cfg), str(tmp_path / "j"))
    try:
        for suffix in ("", ".ids", ".meta"):
            with open(str(tmp_path / "t" / "buckets") + suffix, "rb") as f, \
                    open(str(tmp_path / "j" / "buckets") + suffix, "rb") as g:
                assert f.read() == g.read(), suffix
        assert_same_pairs(x, eps, port.self_join(), ref.self_join())
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("device,expect", [
    ("cpu", "cpu"), (torch.device("cpu"), "cpu"), ("meta", ValueError),
])
def test_resolve_device(device, expect):
    from repro_torch.device import resolve_device
    if isinstance(expect, str):
        assert resolve_device(device).type == expect
    else:
        with pytest.raises(expect):
            resolve_device(device)
