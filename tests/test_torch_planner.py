"""The port's planner (``repro_torch.plan``) against the JAX package's:
the cardinality sketch and its estimates, ``JoinPlan``/``WavePlan``/
``PoolPlan`` decisions on the CPU, plan on/off byte parity with zero
compaction overflows, the host/device route flip under link emulation,
the sketch's lazy rebuild, and the cost model's per-device static tier."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import DiskJoinIndex as JIndex  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.plan import CardinalityEstimator as JEstimator  # noqa: E402
from repro.plan import CostModel as JCostModel  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.compute import engine as eng  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.core.index import MANIFEST_NAME  # noqa: E402
from repro_torch.plan import (SKETCH_FILE, CardinalityEstimator,  # noqa: E402
                              CostModel)
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402
from torch_parity import assert_identical, assert_same_pairs  # noqa: E402

BASE = dict(pad_align=64, num_buckets=24, memory_budget_bytes=1 << 20)


def _flat(x, tmp_path, name):
    return FlatVectorStore.from_array(str(tmp_path / name), x)


def test_estimator_matches_jax(tmp_path):
    """Same flat store and assignment → the JAX package's samples, edge
    estimates (est, lo, hi) and query estimates; the bucketed-store
    rebuild too; and each package loads the other's sketch file."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(900, 8)).astype(np.float32)
    assignment = rng.integers(0, 12, size=900)
    assignment[:12] = np.arange(12)
    t = CardinalityEstimator.sample_flat(_flat(x, tmp_path, "t.bin"),
                                         assignment, 12, seed=3)
    j = JEstimator.sample_flat(JFlat.from_array(str(tmp_path / "j.bin"), x),
                               assignment, 12, seed=3)
    for k in ("samples", "rows", "sizes"):
        assert np.array_equal(getattr(t, k), getattr(j, k)), k
    edges = np.array([(u, v) for u in range(12) for v in range(u, 12)])
    for got, want in zip(t.est_edges(edges, 1.7), j.est_edges(edges, 1.7)):
        np.testing.assert_array_equal(got, want)
    Q = x[:20] + 0.01
    per_q = [np.arange(12)[::k + 1] for k in range(20)]
    tq, jq = t.est_queries(Q, per_q, 1.7), j.est_queries(Q, per_q, 1.7)
    np.testing.assert_array_equal(tq[0], jq[0])
    np.testing.assert_array_equal(tq[1], jq[1])
    assert tq[2] == jq[2]
    t.save(str(tmp_path / "t.npz"))
    j.save(str(tmp_path / "j.npz"))
    for a, b in ((JEstimator.load(str(tmp_path / "t.npz")), t),
                 (CardinalityEstimator.load(str(tmp_path / "j.npz")), j)):
        assert np.array_equal(a.samples, b.samples)
        assert a.seed == b.seed


@pytest.fixture(scope="module")
def pair(small_dataset, tmp_path_factory):
    x, eps = small_dataset
    tmp = tmp_path_factory.mktemp("plan")
    cfg = dict(epsilon=eps, **BASE)
    port = DiskJoinIndex.build(_flat(x, tmp, "t.bin"), JoinConfig(**cfg),
                               str(tmp / "t"), device="cpu")
    ref = JIndex.build(JFlat.from_array(str(tmp / "j.bin"), x),
                       JJoinConfig(**cfg), str(tmp / "j"))
    yield x, eps, port, ref
    port.close()
    ref.close()


def test_build_sketch_matches_jax(pair):
    """The build samples the sketch from the flat store, as the JAX
    package's does, and records it in the manifest."""
    _, _, port, ref = pair
    for k in ("samples", "rows", "sizes"):
        assert np.array_equal(getattr(port.estimator, k),
                              getattr(ref.estimator, k)), k
    with open(os.path.join(port.workdir, MANIFEST_NAME)) as f:
        assert json.load(f)["sketch"]["file"] == SKETCH_FILE
    assert "sketch" in port.build_timings


@pytest.mark.parametrize("override,mode", [
    (dict(), "host"),
    (dict(compute_mode="device"), "device"),
    (dict(compute_mode="auto"), "host"),
    (dict(compute_mode="auto", emulate_xfer_gb_s=50.0, io_mode="prefetch"),
     "mixed"),
    (dict(compute_mode="auto", emulate_xfer_gb_s=5.0), "device"),
])
def test_join_plan_matches_jax(pair, override, mode):
    """On the CPU the port's JoinPlan is the JAX package's: pair_cap,
    routing mode and each unit's (route, verify batch); the join's bytes
    are the plan-off join's, on a mixed plan too."""
    x, eps, port, ref = pair
    t = port.self_join(plan_mode="on", **override)
    j = ref.self_join(plan_mode="on", **override)
    tp, jp = t.plan, j.plan
    assert tp.compute_mode == mode
    assert (tp.pair_cap, tp.compute_mode, tp.num_units) == \
        (jp.pair_cap, jp.compute_mode, jp.num_units)
    assert tp.unit_params == jp.unit_params
    assert tp.est_total == pytest.approx(jp.est_total)
    assert_identical(t, port.self_join())
    assert_same_pairs(x, eps, t, j)


@pytest.mark.parametrize("mode", ["host", "device", "auto"])
def test_wave_plan_matches_jax(pair, mode):
    x, eps, port, ref = pair
    Q = x[300:340] + 0.001
    per_q = port.plan_probes(Q)
    tw = port._planner_for(port._resolve(dict(
        plan_mode="on", compute_mode=mode))).plan_wave(
        Q, per_q, port.meta, port._resolve({}), port.bucket_capacity)
    jw = ref._planner_for(ref._resolve(dict(
        plan_mode="on", compute_mode=mode))).plan_wave(
        Q, per_q, ref.meta, ref._resolve({}), ref.bucket_capacity)
    for k in ("num_buckets", "cold_reads", "k_cap", "compute_mode"):
        assert getattr(tw, k) == getattr(jw, k), k
    assert tw.est_pairs == pytest.approx(jw.est_pairs)
    assert tw.hi_pairs == pytest.approx(jw.hi_pairs)
    # the planned query batch keeps the unplanned one's memberships
    planned = port.query_batch(Q, plan_mode="on", compute_mode=mode)
    plain = port.query_batch(Q)
    for (a, _), (b, _) in zip(planned, plain):
        assert set(a.tolist()) == set(b.tolist())


def test_pool_plan_matches_jax(pair):
    _, _, port, ref = pair
    cfg = port._resolve(dict(plan_mode="on"))
    stats = {"waves": 10, "shared_probe_reads": 38}
    tp = port._planner_for(cfg).plan_pool(cfg, 6, 4, stats, floor=2)
    jp = ref._planner_for(ref._resolve(dict(plan_mode="on"))).plan_pool(
        cfg, 6, 4, stats, floor=2)
    assert (tp.num_slabs, tp.warm_quota) == (jp.num_slabs, jp.warm_quota)


def _force_tiny_default_pair_cap(monkeypatch, cap=64):
    """The device engine's *default* compaction capacity made tiny, as a
    mistuned baseline; a planner-passed cap is untouched."""
    orig = eng.DeviceVerifyEngine.__init__

    def patched(self, cache, **kw):
        if kw.get("pair_cap") is None:
            kw["pair_cap"] = cap
        orig(self, cache, **kw)

    monkeypatch.setattr(eng.DeviceVerifyEngine, "__init__", patched)


@pytest.mark.parametrize("io_mode,devices", [
    ("sync", 1), ("prefetch", 1), ("prefetch", 4)])
def test_plan_on_off_byte_parity_and_zero_overflow(
        small_dataset, tmp_path, monkeypatch, io_mode, devices):
    """The planner only sizes and places work: plan-on results are
    byte-identical to plan-off, and the planned pair_cap absorbs the
    dense units a mistuned default overflows on."""
    _force_tiny_default_pair_cap(monkeypatch)
    x, eps = small_dataset
    cfg = JoinConfig(epsilon=eps, io_mode=io_mode, io_devices=devices,
                     compute_mode="device", io_batch_reads=devices > 1,
                     io_coalesce=devices > 1, **BASE)
    with DiskJoinIndex.build(_flat(x, tmp_path, "x.bin"), cfg,
                             str(tmp_path / "i"), device="cpu") as idx:
        r_off = idx.self_join()
        off = idx.pipeline_snapshot()
        r_on = idx.self_join(plan_mode="on")
        on = idx.pipeline_snapshot()
    assert r_off.pairs.shape[0] > 0
    assert_identical(r_off, r_on)
    assert off["device_compact_overflows"] > 0
    assert on["device_compact_overflows"] == off["device_compact_overflows"]
    assert r_on.plan.pair_cap > 64
    assert on["planned_pair_cap"] == r_on.plan.pair_cap
    assert on["plans"] == 1


def test_route_flips_with_link_emulation(tmp_path):
    """compute_mode="auto": a free link routes to the host; a slow
    emulated link to the device. Same bytes either way, and the JAX
    package's routes."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(600, 8)).astype(np.float32)
    cfg = dict(epsilon=1.1, num_buckets=10, pad_align=64,
               memory_budget_bytes=1 << 20)
    with DiskJoinIndex.build(_flat(x, tmp_path, "t.bin"), JoinConfig(**cfg),
                             str(tmp_path / "t"), device="cpu") as idx, \
            JIndex.build(JFlat.from_array(str(tmp_path / "j.bin"), x),
                         JJoinConfig(**cfg), str(tmp_path / "j")) as jdx:
        r_ref = idx.self_join()
        r_free = idx.self_join(plan_mode="on", compute_mode="auto")
        r_slow = idx.self_join(plan_mode="on", compute_mode="auto",
                               emulate_xfer_gb_s=0.01)
        j_slow = jdx.self_join(plan_mode="on", compute_mode="auto",
                               emulate_xfer_gb_s=0.01)
    assert r_free.plan.compute_mode == "host"
    assert r_slow.plan.compute_mode in ("device", "mixed")
    assert r_slow.plan.unit_params == j_slow.plan.unit_params
    for r in (r_free, r_slow):
        assert_identical(r_ref, r)


def test_pre_sketch_manifest_rebuilds_once(tmp_path):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(500, 8)).astype(np.float32)
    wd = str(tmp_path / "idx")
    cfg = JoinConfig(epsilon=1.0, num_buckets=8, pad_align=64,
                     memory_budget_bytes=1 << 20)
    with DiskJoinIndex.build(_flat(x, tmp_path, "x.bin"), cfg, wd,
                             device="cpu") as idx:
        r_new = idx.self_join(plan_mode="on")
    os.remove(os.path.join(wd, SKETCH_FILE))
    mpath = os.path.join(wd, MANIFEST_NAME)
    with open(mpath) as f:
        m = json.load(f)
    m.pop("sketch", None)
    with open(mpath, "w") as f:
        json.dump(m, f)
    with DiskJoinIndex.open(wd, device="cpu") as idx:
        with pytest.warns(UserWarning, match="predates planner"):
            r_old = idx.self_join(plan_mode="on")
        assert_identical(r_new, r_old)
    assert os.path.exists(os.path.join(wd, SKETCH_FILE))
    with open(mpath) as f:
        assert json.load(f)["sketch"]["file"] == SKETCH_FILE
    with DiskJoinIndex.open(wd, device="cpu") as idx:
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            r2 = idx.self_join(plan_mode="on")
        assert_identical(r_new, r2)
    # the JAX package opens the port's index with its sketch
    with JIndex.open(wd) as jdx:
        assert np.array_equal(jdx.estimator.samples,
                              CardinalityEstimator.load(
                                  os.path.join(wd, SKETCH_FILE)).samples)


def test_cost_model_static_tier_per_device():
    """The CPU's static tier is the JAX package's (so CPU plans match it);
    CUDA's is the card's own, with its provenance; the config tier beats
    either."""
    cfg = JoinConfig(epsilon=0.5)
    cpu = CostModel.from_telemetry(cfg, None, device=torch.device("cpu"))
    ref = JCostModel.from_telemetry(JJoinConfig(epsilon=0.5), None)
    for k in ("read_s_per_bucket", "h2d_gb_s", "d2h_gb_s", "host_cell_ns",
              "device_cell_ns", "host_dispatch_s", "device_dispatch_s"):
        assert getattr(cpu, k) == getattr(ref, k), k
    assert cpu.provenance == ref.provenance
    assert cpu.describe() == ref.describe()
    card = CostModel.from_telemetry(cfg, None, device=torch.device("cuda"))
    assert card.h2d_gb_s > 0 and card.d2h_gb_s > 0
    assert "H100" in card.provenance["link"]
    assert "H100" in card.provenance["device_cell_ns"]
    assert "H100" in card.describe()
    emu = CostModel.from_telemetry(
        JoinConfig(epsilon=0.5, emulate_xfer_gb_s=2.0,
                   emulate_read_latency_s=0.004), None, device="cuda")
    assert emu.h2d_gb_s == emu.d2h_gb_s == 2.0
    assert emu.provenance["link"] == "config(emulate_xfer_gb_s)"
    measured = CostModel.from_telemetry(None, {"loads": 10, "read_s": 0.05},
                                        device="cuda")
    assert measured.read_s_per_bucket == pytest.approx(0.005)
    assert "measured" in measured.provenance["read_s_per_bucket"]
