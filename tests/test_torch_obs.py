"""The port's observability (``repro_torch.obs``: metrics, Chrome-trace
export and ``TraceAnalysis``, live rollups, SLO alerts, the live cost
tier, the dashboard) against the JAX package's on the same seeded data and
the same calls, on the CPU. Structures (exported names, metrics keys,
trace events by name and phase, histogram bounds) must be equal; counts
must be equal where the calls are deterministic (a sync join, a fixed
number of queries)."""
import collections
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.ft as jft  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.ft as tft  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.core import DiskJoinIndex as JIndex  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.obs import dash as jdash  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.data import clustered_vectors  # noqa: E402
from repro_torch.obs import dash as tdash  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402

EPS = 0.35
CFG = dict(epsilon=EPS, recall_target=0.9, pad_align=64, num_buckets=20,
           memory_budget_bytes=1 << 20)
PKG = {"port": (tobs, tserve, tdash), "ref": (jobs, jserve, jdash)}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    x = clustered_vectors(2500, 24, seed=9)
    idx = {"port": DiskJoinIndex.build(
        FlatVectorStore.from_array(str(root / "t.bin"), x),
        JoinConfig(**CFG), str(root / "tidx"), device="cpu"),
        "ref": JIndex.build(JFlat.from_array(str(root / "j.bin"), x),
                            JJoinConfig(**CFG), str(root / "jidx"))}
    yield x, idx, root
    for i in idx.values():
        i.close()


@pytest.mark.parametrize("port,ref,left_out", [
    (tobs, jobs, set()), (tserve, jserve, set()),
    (tft, jft, set()),
])
def test_packages_export_the_reference_names(port, ref, left_out):
    """``obs``, ``serve`` and ``ft`` export the JAX package's names."""
    assert set(port.__all__) == set(ref.__all__) - left_out
    for name in port.__all__:
        assert getattr(port, name) is not None


def _keys(d, depth=0):
    if not isinstance(d, dict) or depth > 1:
        return None
    return {k: _keys(v, depth + 1) for k, v in d.items()}


# the port's own pipeline counters: the sync cache's pinned slot arena and
# the direct first-touch copies from it, which the JAX package has not
PORT_ONLY_PIPELINE = {"h2d_direct", "h2d_staged", "h2d_slot_waits",
                      "cache_slot_grows"}


def test_metrics_snapshot_keys_match_jax(built):
    """The session's metrics surface with a query service and a scheduler
    registered on it: the same sections and the same keys in each, but
    the port's own pipeline counters."""
    x, idx, _ = built
    got = {}
    for name, (obs, serve, _) in PKG.items():
        svc = serve.VectorQueryService(idx[name])
        sched = serve.QueryScheduler(idx[name])
        svc.query(x[0])
        sched.query(x[1], timeout=60)
        got[name] = _keys(idx[name].metrics_snapshot())
        sched.close()
        svc.close()
    pipeline = got["port"]["pipeline"]
    assert PORT_ONLY_PIPELINE <= set(pipeline)
    for k in PORT_ONLY_PIPELINE:
        del pipeline[k]
    assert got["port"] == got["ref"]
    assert {"pipeline", "io", "tracer", "service",
            "scheduler"} <= set(got["port"])


@pytest.mark.parametrize("bounds", [(1e-6, 10.0, 2.0), (1.0, 1e6, 4.0)])
def test_histogram_bounds_and_percentiles_match_jax(bounds):
    rng = np.random.default_rng(3)
    vals = rng.lognormal(-3, 2, 500)
    out = {}
    for name, (obs, _, _) in PKG.items():
        b = obs.log_bounds(*bounds)
        reg = obs.MetricsRegistry()
        lo, hi, factor = bounds
        h = reg.histogram("lat_s", lo=lo, hi=hi, factor=factor)
        for v in vals:
            h.observe(float(v))
        reg.counter("n").inc(7)
        out[name] = (list(b), reg.snapshot())
    assert out["port"] == out["ref"]


def _events(path):
    with open(path) as f:
        doc = json.load(f)
    return collections.Counter((e["name"], e["ph"])
                               for e in doc["traceEvents"])


# spans the port records and the JAX package does not, on this test's
# path: the join's graph, node order and dedup, the device engine's wait
# and result fan-out
PORT_ONLY_SPANS = ("join.graph", "join.order", "join.dedup", "device.sync",
                   "verify.emit")


def test_chrome_trace_events_match_jax(built):
    """A traced sync join (device mode) and a query wave: the exported
    Chrome trace holds the same events, by name and phase, the same
    number of times, and both pass the schema check. Three differences
    are the port's own: it records slab staging as an ``h2d.stage`` span
    where the reference records an instant, once a staging each, it
    records the spans of ``PORT_ONLY_SPANS``, each at least once, and its
    device engine records one ``verify.rechecks`` instant a join."""
    x, idx, root = built
    got, fractions = {}, {}
    for name, (obs, _, _) in PKG.items():
        idx[name].drop_warm_cache()
        with obs.trace_session() as tr:
            idx[name].self_join(compute_mode="device")
            idx[name].query_batch(x[:20] + np.float32(1e-3))
        path = tr.export(str(root / f"{name}.trace.json"))
        with open(path) as f:
            obs.validate_chrome_trace(json.load(f))
        got[name] = _events(path)
        fractions[name] = tr.analysis().hidden_fraction("io.read",
                                                        "io.wait")
    port, ref = got["port"].copy(), got["ref"].copy()
    for name in PORT_ONLY_SPANS:
        assert port.pop((name, "X"), 0) > 0, name
    assert port.pop(("h2d.stage", "X"), 0) == \
        ref.pop(("h2d.stage", "i"), 0) > 0
    assert port.pop(("verify.rechecks", "i"), 0) == 1
    assert port == ref
    assert {"io.read", "verify.dispatch", "query.execute"} <= \
        {n for n, _ in got["port"]}
    assert 0.0 <= fractions["port"] <= 1.0


@pytest.mark.parametrize("name", ["port", "ref"])
def test_live_rollup_counts_and_slo_alerts(built, name):
    """``attach_live``: the rollup's ``query.execute`` count equals the
    queries sent; a latency objective every query misses fires an alert;
    ``detach_live`` takes the section and the owned tracing away."""
    x, idx, _ = built
    obs, serve, dash = PKG[name]
    index = idx[name]
    alerts = []
    live = index.attach_live(window_s=0.05, windows=400, slos=(
        obs.Slo.latency("q", "query.execute", threshold_s=1e-9,
                        objective=0.5, fast_windows=1, slow_windows=2,
                        burn_threshold=1.5),), on_alert=alerts.append)
    svc = serve.VectorQueryService(index)
    n = 40
    try:
        for q in x[:n]:
            svc.query(q)
            time.sleep(0.002)
        time.sleep(0.06)
        live.poll()
        section = index.metrics_snapshot()["live"]
        text = dash.render(index)
    finally:
        svc.close()
        index.detach_live()
    assert section["spans"]["query.execute"]["count"] == n
    assert live.monitor.fired >= 1 and alerts
    assert "query.execute" in text
    assert f"{live.monitor.fired} fired" in text
    assert index.live is None
    assert "live" not in index.metrics_snapshot()
    assert not obs.get_tracer().enabled


@pytest.mark.parametrize("name", ["port", "ref"])
def test_live_constants_reach_the_cost_model(built, name):
    """The live tier feeds ``CostModel.from_telemetry``: serving feeds no
    cumulative load counter, so the read constant is the live one, with
    its provenance."""
    x, idx, _ = built
    index = idx[name]
    live = index.attach_live(window_s=0.02, calibrate_min_samples=1,
                             calibrate_windows=16)
    try:
        for q in x[:30]:
            index.query(q, emulate_read_latency_s=2e-3)
            index.drop_warm_cache()
        time.sleep(0.03)
        live.poll()
        consts = live.live_constants()
        cost = index._planner_for(index._resolve({"epsilon": EPS})).cost
    finally:
        index.detach_live()
    assert "live(" in cost.provenance["read_s_per_bucket"]
    assert cost.read_s_per_bucket == pytest.approx(
        consts["read_s_per_bucket"]["value"])


def test_router_merges_live_sections_of_its_shards(built, tmp_path):
    """The router's metrics re-merge the shards' live sections exactly
    (``merge_live_sections``), as the JAX package's do."""
    x, _, _ = built
    shards = []
    for i, part in enumerate((x[:1250], x[1250:])):
        shards.append(DiskJoinIndex.build(
            FlatVectorStore.from_array(str(tmp_path / f"s{i}.bin"), part),
            JoinConfig(**CFG), str(tmp_path / f"s{i}"), device="cpu"))
    router = tserve.IndexRouter(shards, epsilon=EPS, close_shards=True)
    router.attach_live(window_s=0.05, slos=())
    for q in x[:15]:
        shards[0].query(q)
    time.sleep(0.06)
    merged = router.metrics_snapshot()["live"]
    s0 = shards[0].metrics_snapshot()["live"]
    s1 = shards[1].metrics_snapshot()["live"]
    direct = tobs.merge_live_sections([s0, s1])
    assert merged["spans"]["query.execute"]["count"] >= 15
    assert merged["spans"]["query.execute"]["buckets"] == \
        direct["spans"]["query.execute"]["buckets"]
    router.detach_live()
    router.close()
