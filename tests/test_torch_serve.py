"""The port's serving layer (``repro_torch.serve``) against the JAX
package's on the same seeded data, on the CPU: the wave scheduler and the
query service give the JAX package's answers (the query contract of
``torch_parity.assert_same_answers``: the same members but ε-boundary
rows, distances allclose at rtol 1e-4, atol 1e-3); the router's scatter
and gather over two replicated shards, its failover after a killed
replica and a supervised restart that stays on the session's device;
deadline drops and admission rejects; the launch counters under eight
threads; and no torch call on any background thread that is not a drain
thread."""
import http.server
import sys
import threading
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import DiskJoinIndex as JIndex  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.serve import IndexRouter as JRouter  # noqa: E402
from repro.serve import QueryScheduler as JScheduler  # noqa: E402
from repro.serve import VectorQueryService as JService  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.data import clustered_vectors  # noqa: E402
from repro_torch.ft import FaultInjector  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pairwise_l2  # noqa: E402
from repro_torch.obs import Slo, WebhookSink  # noqa: E402
from repro_torch.serve import (DOWN, HEALTHY,  # noqa: E402
                               AdmissionRejected, DeadlineExceeded,
                               IndexRouter, QueryScheduler,
                               ReplicaSupervisor, SchedulerQueueFull,
                               VectorQueryService, order_result)
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402
from torch_parity import (assert_identical_answers,  # noqa: E402
                          assert_same_answers)

EPS = 0.35
CFG = dict(epsilon=EPS, recall_target=0.9, pad_align=64, num_buckets=20,
           memory_budget_bytes=1 << 20)
WAIT = 60  # seconds any future or thread may take


@pytest.fixture(scope="module")
def data():
    return clustered_vectors(2500, 24, seed=9)


@pytest.fixture(scope="module")
def built(data, tmp_path_factory):
    """One index per package over the same rows and config, and two
    shard workdirs per package (rows split in half) for the router."""
    root = tmp_path_factory.mktemp("serve")
    x = data
    port = DiskJoinIndex.build(FlatVectorStore.from_array(
        str(root / "t.bin"), x), JoinConfig(**CFG), str(root / "tidx"),
        device="cpu")
    ref = JIndex.build(JFlat.from_array(str(root / "j.bin"), x),
                       JJoinConfig(**CFG), str(root / "jidx"))
    shards = {"port": [], "ref": []}
    for i, part in enumerate((x[:1250], x[1250:])):
        DiskJoinIndex.build(FlatVectorStore.from_array(
            str(root / f"ts{i}.bin"), part), JoinConfig(**CFG),
            str(root / f"tshard{i}"), device="cpu").close()
        JIndex.build(JFlat.from_array(str(root / f"js{i}.bin"), part),
                     JJoinConfig(**CFG), str(root / f"jshard{i}")).close()
        shards["port"].append(str(root / f"tshard{i}"))
        shards["ref"].append(str(root / f"jshard{i}"))
    yield x, port, ref, shards, root
    port.close()
    ref.close()


def _bounded(fn):
    """``fn()`` on a daemon thread, waited for at most ``WAIT`` seconds
    (a scheduler-backed service waits on its futures without a
    timeout)."""
    box = {}
    t = threading.Thread(target=lambda: box.update(out=fn()), daemon=True)
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive() and "out" in box
    return box["out"]


def _overlapping(x, n, seed):
    """Queries that crowd a few rows (heavy probe overlap), seeded."""
    rng = np.random.default_rng(seed)
    return (x[rng.choice(200, n)] + rng.normal(scale=1e-3, size=(
        n, x.shape[1]))).astype(np.float32)


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("mode", ["host", "device"])
def test_scheduler_matches_jax(built, share, mode):
    x, port, ref, _, _ = built
    Q = _overlapping(x, 64, seed=0)
    out = {}
    for name, idx, cls in (("port", port, QueryScheduler),
                           ("ref", ref, JScheduler)):
        idx.drop_warm_cache()
        saved = idx.pipeline_snapshot()["reads_saved_by_sharing"]
        with cls(idx, wave_size=32, max_wait_s=0.05, share_probes=share,
                 compute_mode=mode) as sched:
            futs = [sched.submit(q) for q in Q]
            out[name] = [f.result(timeout=WAIT) for f in futs]
            snap = sched.snapshot()
        assert snap["completed"] == 64 and snap["waves"] >= 2
        saved = snap["pipeline"]["reads_saved_by_sharing"] - saved
        assert (saved > 0) == share
    assert assert_same_answers(x, Q, out["port"], out["ref"], EPS) > 64
    for ids, dists in out["port"]:   # ordered by distance, then id
        assert np.all(np.diff(dists) >= 0)


def test_scheduler_answers_equal_query_batch(built):
    """A wave groups queries differently from ``query_batch``. In host
    mode (float64 per row) the answers are the same bytes either way; in
    device mode the CPU's plain version is a BLAS product whose sums
    depend on how many rows a tile holds, so the query contract holds
    there (on the card the verify kernel's bytes do not depend on the
    tile: ``chip_smoke.py`` checks it)."""
    x, port, _, _, _ = built
    Q = _overlapping(x, 40, seed=1)
    for mode in ("host", "device"):
        with QueryScheduler(port, wave_size=16, max_wait_s=0.01,
                            compute_mode=mode) as sched:
            waves = [f.result(timeout=WAIT)
                     for f in [sched.submit(q) for q in Q]]
        batch = [order_result(i, d, None)
                 for i, d in port.query_batch(Q, compute_mode=mode)]
        if mode == "host":
            assert_identical_answers(waves, batch)
        else:
            assert_same_answers(x, Q, waves, batch, EPS)


@pytest.mark.parametrize("use_scheduler", [False, True])
def test_query_service_matches_jax_and_repeats_warm(built, use_scheduler):
    x, port, ref, _, _ = built
    Q = x[300:340] + np.float32(1e-3)
    out = {}
    for name, idx, cls in (("port", port, VectorQueryService),
                           ("ref", ref, JService)):
        idx.drop_warm_cache()
        svc = cls(idx, scheduler=use_scheduler)
        first = _bounded(lambda: [svc.query(q) for q in Q])
        before = idx.pipeline_snapshot()["query_warm_hits"]
        again = _bounded(lambda: [svc.query(q) for q in Q])
        svc.close()
        out[name] = first
        if name == "port":
            assert_identical_answers(first, again)
            assert idx.pipeline_snapshot()["query_warm_hits"] > before
    assert_same_answers(x, Q, out["port"], out["ref"], EPS)


def test_router_two_shards_failover_and_restart_on_cpu(built):
    """Scatter/gather over two shards of two replicas each: the JAX
    package's answers; after ``kill_replica`` the same bytes come back
    through the sibling; the supervisor's restart reopens the dead
    replica's session on the CPU, as the dead one was, and its answers
    are the same again."""
    x, _, _, shards, _ = built
    Q = _overlapping(x, 24, seed=2)
    Q[12:] = x[1250:1262] + np.float32(1e-3)   # the second shard too
    port = IndexRouter([[DiskJoinIndex.open(d, device="cpu")
                         for _ in range(2)] for d in shards["port"]],
                       epsilon=EPS, close_shards=True,
                       scheduler=dict(max_wait_s=0.001))
    ref = JRouter([[JIndex.open(d) for _ in range(2)]
                   for d in shards["ref"]], epsilon=EPS, close_shards=True,
                  scheduler=dict(max_wait_s=0.001))
    try:
        first = [port.query(q, timeout=WAIT) for q in Q]
        assert_same_answers(x, Q, first,
                            [ref.query(q, timeout=WAIT) for q in Q], EPS)
        rset = port.replica_sets[0]
        dead = rset.replicas[0]
        FaultInjector().kill_replica(dead)
        for r in rset.replicas:   # pin the rotation: both get picked
            r.service_ewma = 0.001
        assert_identical_answers(first, [port.query(q, timeout=WAIT)
                                         for q in Q])
        snap = rset.snapshot()
        assert snap["counters"]["failovers"] > 0
        assert dead.health.state == DOWN
        dead_index = dead.index
        sup = ReplicaSupervisor(port, poll_s=0.02, backoff_s=0.05)
        assert sup.poll_once() == 1
        assert dead.health.state == HEALTHY
        assert dead.index is not dead_index
        assert dead.index.device == torch.device("cpu")
        assert_identical_answers(
            [rset.replicas[1].scheduler.query(q, timeout=WAIT)
             for q in Q[:12]],
            [dead.scheduler.query(q, timeout=WAIT) for q in Q[:12]])
        # the warm cache holds the only pins, and gives them all back
        pool = dead.index._pool
        assert pool.in_use == len(dead.index.warm_buckets()) > 0
        dead.index.drop_warm_cache()
        assert pool.in_use == 0
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("case", ["deadline", "admission", "queue_full"])
def test_drops_and_rejects(built, case):
    """A request whose deadline passes while queued is dropped before any
    read; ``admission="estimate"`` sheds a doomed request at ``submit``
    with the JAX package's predicted service time (the CPU's cost tier is
    the JAX constants); a full queue refuses at the door."""
    x, _, _, shards, _ = built
    idx = DiskJoinIndex.open(shards["port"][0], device="cpu")
    try:
        if case == "deadline":
            sched = QueryScheduler(idx, epsilon=EPS, wave_size=8,
                                   max_wait_s=0.05,
                                   emulate_read_latency_s=0.02)
            filler = sched.submit(x[0])
            doomed = sched.submit(x[1], deadline_s=1e-4)
            with pytest.raises(DeadlineExceeded):
                doomed.result(timeout=WAIT)
            assert len(filler.result(timeout=WAIT)[0]) >= 1
            sched.close()
            snap = sched.snapshot()
            assert snap["deadline_drops"] == 1
            assert snap["pipeline"]["deadline_drops"] == 1
        elif case == "admission":
            from repro.serve import AdmissionRejected as JRejected
            q = x[0] + np.float32(1e-3)
            preds = []
            jidx = JIndex.open(shards["ref"][0])
            for i, cls, exc in ((idx, QueryScheduler, AdmissionRejected),
                                (jidx, JScheduler, JRejected)):
                s = cls(i, epsilon=EPS, admission="estimate",
                        max_wait_s=0.0, emulate_read_latency_s=0.05)
                with pytest.raises(exc) as ei:
                    s.submit(q, deadline_s=0.001)
                preds.append(ei.value.predicted_s)
                ok = s.submit(q, deadline_s=ei.value.suggested_deadline_s)
                assert len(ok.result(timeout=WAIT)[0]) >= 1
                s.close()
            jidx.close()
            assert preds[0] == pytest.approx(preds[1], rel=1e-9)
            assert idx.pipeline_snapshot()["admission_rejects"] == 1
        else:
            sched = QueryScheduler(idx, epsilon=EPS, wave_size=1,
                                   max_wait_s=0.0, max_queue=2,
                                   emulate_read_latency_s=0.02)
            sched.submit(x[0])
            threading.Event().wait(0.01)
            sched.submit(x[1])
            sched.submit(x[2])
            with pytest.raises(SchedulerQueueFull):
                sched.submit(x[3])
            assert sched.snapshot()["rejected"] == 1
            sched.close()
    finally:
        idx.close()


def test_launch_counters_lose_nothing_under_eight_threads(monkeypatch):
    """``count_launch`` and the E = 1 verify wrapper (its kernel replaced,
    its operands taken for the card's), hammered from 8 threads with a
    tiny switch interval: every increment lands. (On CPython 3.12 with
    its GIL a bare ``+=`` on a dict entry is not interrupted either, so
    this holds the helper to its guarantee rather than showing a loss;
    the lock keeps it on interpreters that switch threads mid-statement.)"""
    # the wrapper's launch, as the card runs it, minus the kernel
    monkeypatch.setattr(pairwise_l2, "pairwise_l2_threshold_batched",
                        lambda a, b, eps2, plan: (
                            torch.zeros(1, 1, 1),
                            torch.zeros(1, 1, 1, dtype=torch.int8)))
    monkeypatch.setattr(ops, "_same_device",
                        lambda *xs: torch.device("cuda"))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    ops.reset_launches()
    n = 4000
    a = torch.zeros(64, 128)

    def work():
        for _ in range(n):
            ops.count_launch("bucket_assign")
            ops.pairwise_l2_threshold(a, a, 0.1)

    threads = [threading.Thread(target=work) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        snap = ops.launches_snapshot()
    finally:
        sys.setswitchinterval(old)
        ops.reset_launches()
    assert not any(t.is_alive() for t in threads)
    assert snap["bucket_assign"] == 8 * n
    assert snap["pairwise_l2_threshold"] == snap["verify_tc"] == 8 * n
    assert ops.launches_snapshot()["verify_tc"] == 0


def test_background_threads_make_no_torch_call(built, tmp_path):
    """A served (scheduler), live (``attach_live`` with a webhook on its
    alerts), snapshotting (``enable_residency_snapshots``) session: a
    profile hook on every thread sees no torch frame on any thread but
    the scheduler's drain thread and the caller's, and no torch frame
    under the live rollups, the metrics registry, the committer or the
    webhook on any thread."""
    x, _, _, shards, _ = built
    idx = DiskJoinIndex.open(shards["port"][0], device="cpu")
    posted = []

    class Hook(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            posted.append(self.rfile.read(int(self.headers["Content-Length"])))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    seen, threads_seen, under_obs = [], set(), []
    quiet = ("repro_torch.obs.", "repro_torch.ft.")
    serving = ("diskjoin-serve-drain", "MainThread")

    def hook(frame, event, arg):
        name = threading.current_thread().name
        threads_seen.add(name)
        if event != "call":
            return
        mod = frame.f_globals.get("__name__", "")
        if mod != "torch" and not mod.startswith("torch."):
            return
        if name not in serving:
            seen.append((name, mod))
        f = frame.f_back
        while f is not None:
            if f.f_globals.get("__name__", "").startswith(quiet):
                under_obs.append((name, mod, "".join(
                    traceback.format_stack(frame, limit=4))))
                break
            f = f.f_back

    threading.setprofile(hook)
    sys.setprofile(hook)
    sink = WebhookSink(f"http://127.0.0.1:{server.server_port}/alerts")
    try:
        # every query misses a 1 ns objective: the alert fires as soon as
        # two windows close
        idx.attach_live(window_s=0.05, slos=(Slo.latency(
            "q", "query.execute", threshold_s=1e-9, objective=0.5,
            fast_windows=1, slow_windows=2, burn_threshold=1.5),),
            on_alert=sink)
        idx.enable_residency_snapshots(0.0)
        with QueryScheduler(idx, epsilon=EPS, wave_size=8,
                            max_wait_s=0.005,
                            compute_mode="device") as sched:
            for f in [sched.submit(q) for q in x[:48]]:
                f.result(timeout=WAIT)
        threading.Event().wait(0.1)
        idx.live.poll()
        assert idx.metrics_snapshot()["live"]["spans"]["query.execute"][
            "count"] > 0
        assert idx.live.monitor.fired >= 1
        sink.close()   # drains the alerts queued so far
    finally:
        sys.setprofile(None)
        threading.setprofile(None)
        idx.close()
        sink.close()
        server.shutdown()
    assert posted and sink.delivered == len(posted)
    assert {"diskjoin-serve-drain", "residency-snapshot",
            "diskjoin-webhook"} <= threads_seen, threads_seen
    assert not seen, sorted(set(seen))
    assert not under_obs, under_obs[:1]
