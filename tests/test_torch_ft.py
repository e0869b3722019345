"""The port's fault tolerance (``repro_torch.ft``) against the JAX
package's, on the CPU: resumable builds (a build killed after its assign
scan resumes without rescanning and leaves the uninterrupted build's
bucket files byte for byte; a config change discards stale phases; the
phase log has the JAX package's layout, so a build killed under either
package resumes under the other), residency snapshots that warm a session
of either package, ``reopen`` keeping the session device, the fault
injector's store proxy on every read path, and the pool giving back every
pin after a replica is killed in the middle of a wave."""
import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.ft.atomic as jatomic  # noqa: E402
import repro_torch.ft.atomic as tatomic  # noqa: E402
from repro.core import DiskJoinIndex as JIndex  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.core.index import RESIDENCY_NAME  # noqa: E402
from repro_torch.data import clustered_vectors  # noqa: E402
from repro_torch.ft import (FaultInjector, FlakyStore,  # noqa: E402
                            InjectedKill, PhaseLog)
from repro_torch.serve import QueryScheduler  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402
from torch_parity import (assert_identical,  # noqa: E402
                          assert_identical_answers, assert_same_answers,
                          assert_same_file)

# the modules (each package's ``core`` exports a function of this name)
jbz = sys.modules["repro.core.bucketize"]
tbz = sys.modules["repro_torch.core.bucketize"]

EPS = 0.35
CFG = dict(epsilon=EPS, recall_target=0.9, pad_align=64, num_buckets=20,
           memory_budget_bytes=1 << 20)
LAYOUT = dict(io_coalesce=True, io_mode="prefetch")   # adds a layout phase
WAIT = 60


@pytest.fixture(scope="module")
def data():
    return clustered_vectors(2500, 24, seed=9)


def _kill_write_scan(monkeypatch, module, n_kills=1):
    """Make the build's write scan raise ``InjectedKill`` ``n_kills``
    times: every phase before it has committed by then."""
    orig = module.write_buckets
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] <= n_kills:
            raise InjectedKill("kill during write scan")
        return orig(*a, **k)

    monkeypatch.setattr(module, "write_buckets", flaky)


def _bucket_files(workdir):
    return sorted(f for f in os.listdir(workdir)
                  if f.startswith("buckets") and os.path.isfile(
                      os.path.join(workdir, f)))


@pytest.mark.parametrize("extra", [{}, LAYOUT], ids=["plain", "layout"])
def test_killed_build_resumes_byte_identical(data, tmp_path, monkeypatch,
                                             extra):
    x = data
    flat = FlatVectorStore.from_array(str(tmp_path / "x.bin"), x)
    cfg = JoinConfig(**CFG, **extra)
    wd = str(tmp_path / "idx")
    _kill_write_scan(monkeypatch, tbz)
    with pytest.raises(InjectedKill):
        DiskJoinIndex.build(flat, cfg, wd, device="cpu")
    phases = sorted(os.listdir(os.path.join(wd, "build_phases")))
    assert phases == sorted(["sample", "assign", "sketch"]
                            + (["layout"] if extra else []))
    ops0 = flat.stats.snapshot()["read_ops"]
    resumed = DiskJoinIndex.build(flat, cfg, wd, device="cpu")
    resumed_ops = flat.stats.snapshot()["read_ops"] - ops0
    assert resumed.build_timings["sample"] == 0.0
    assert resumed.build_timings["assign"] == 0.0
    assert not os.path.isdir(os.path.join(wd, "build_phases"))
    fresh = DiskJoinIndex.build(flat, cfg, str(tmp_path / "fresh"),
                                device="cpu")
    fresh_ops = flat.stats.snapshot()["read_ops"] - ops0 - resumed_ops
    assert resumed_ops < fresh_ops   # the skipped scans saved real reads
    assert fresh.build_timings["assign"] > 0.0
    files = _bucket_files(wd)
    assert files == _bucket_files(str(tmp_path / "fresh")) and files
    for f in files:
        with open(os.path.join(wd, f), "rb") as a, \
                open(os.path.join(str(tmp_path / "fresh"), f), "rb") as b:
            assert a.read() == b.read(), f
    assert_identical(resumed.self_join(), fresh.self_join())
    resumed.close()
    fresh.close()


def test_config_change_discards_stale_phases(data, tmp_path, monkeypatch):
    x = data
    flat = FlatVectorStore.from_array(str(tmp_path / "x.bin"), x)
    wd = str(tmp_path / "idx")
    _kill_write_scan(monkeypatch, tbz)
    with pytest.raises(InjectedKill):
        DiskJoinIndex.build(flat, JoinConfig(**CFG), wd, device="cpu")
    idx = DiskJoinIndex.build(flat, JoinConfig(**dict(CFG, num_buckets=24)),
                              wd, device="cpu")
    assert idx.build_timings["sample"] > 0.0   # the scans re-ran
    assert idx.build_timings["assign"] > 0.0
    assert idx.num_buckets >= 24 - 4           # under the NEW config
    idx.close()


@pytest.mark.parametrize("killed_under", ["ref", "port"])
def test_build_killed_under_one_package_resumes_under_the_other(
        data, tmp_path, monkeypatch, killed_under):
    """The phase log's markers, array names and fingerprint are the JAX
    package's: a build killed under one package resumes under the other
    without rescanning, and its bucket files are those of an
    uninterrupted build (byte for byte, radii to the d² tolerance)."""
    x = data
    tflat = FlatVectorStore.from_array(str(tmp_path / "t.bin"), x)
    jflat = JFlat.from_array(str(tmp_path / "j.bin"), x)
    wd = str(tmp_path / "idx")
    if killed_under == "ref":
        _kill_write_scan(monkeypatch, jbz)
        with pytest.raises(Exception, match="kill during write scan"):
            JIndex.build(jflat, JJoinConfig(**CFG, **LAYOUT), wd)
        resumed = DiskJoinIndex.build(tflat, JoinConfig(**CFG, **LAYOUT),
                                      wd, device="cpu")
        fresh = JIndex.build(jflat, JJoinConfig(**CFG, **LAYOUT),
                             str(tmp_path / "fresh"))
    else:
        _kill_write_scan(monkeypatch, tbz)
        with pytest.raises(InjectedKill):
            DiskJoinIndex.build(tflat, JoinConfig(**CFG, **LAYOUT), wd,
                                device="cpu")
        resumed = JIndex.build(jflat, JJoinConfig(**CFG, **LAYOUT), wd)
        fresh = DiskJoinIndex.build(tflat, JoinConfig(**CFG, **LAYOUT),
                                    str(tmp_path / "fresh"), device="cpu")
    assert resumed.build_timings["sample"] == 0.0
    assert resumed.build_timings["assign"] == 0.0
    files = _bucket_files(wd)
    assert files == _bucket_files(str(tmp_path / "fresh")) and files
    for f in files:
        assert_same_file(os.path.join(wd, f),
                         os.path.join(str(tmp_path / "fresh"), f))
    resumed.close()
    fresh.close()


def test_phase_log_fingerprints_match_jax(tmp_path):
    obj = {"cfg": dict(CFG), "shape": [2500, 24], "layout": "auto"}
    assert tatomic.fingerprint(obj) == jatomic.fingerprint(obj)
    log = PhaseLog(str(tmp_path / "ph"), "fp-a")
    log.commit_arrays("sample", centers=np.ones((3, 2), np.float32))
    os.makedirs(str(tmp_path / "ph" / "assign.tmp"))   # a torn commit
    assert PhaseLog(str(tmp_path / "ph"), "fp-a").has("sample")
    assert not os.path.exists(str(tmp_path / "ph" / "assign.tmp"))
    assert not PhaseLog(str(tmp_path / "ph"), "fp-b").has("sample")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_residency_snapshot_warms_the_other_package(data, tmp_path,
                                                    writer):
    """``residency.json`` is the JAX package's format: a snapshot saved
    by either package's session warms a session of the other on
    ``open(warm_start=True)``, and the warm session answers as the cold
    one did."""
    x = data
    wd = str(tmp_path / "idx")
    DiskJoinIndex.build(FlatVectorStore.from_array(
        str(tmp_path / "x.bin"), x), JoinConfig(**CFG), wd,
        device="cpu").close()
    assert not os.path.exists(os.path.join(wd, RESIDENCY_NAME))
    Q = x[100:140] + np.float32(1e-3)
    opener = {"port": lambda **kw: DiskJoinIndex.open(wd, device="cpu",
                                                      **kw),
              "ref": lambda **kw: JIndex.open(wd, **kw)}
    src = opener[writer]()
    cold = src.query_batch(Q)
    assert src.save_residency_snapshot() > 0
    saved = src.warm_buckets()
    src.close()                       # close() snapshots again, the same
    with open(os.path.join(wd, RESIDENCY_NAME)) as f:
        doc = json.load(f)
    assert doc["format"] == "diskjoin-residency/v1"
    assert doc["buckets"] == saved
    other = "ref" if writer == "port" else "port"
    warm = opener[other](warm_start=True)
    try:
        assert sorted(warm.warm_buckets()) == sorted(saved)
        assert warm.pipeline_snapshot()["warm_prefaults"] == len(saved)
        base = warm.pipeline_snapshot()["query_reads"]
        answers = warm.query_batch(Q)
        assert warm.pipeline_snapshot()["query_reads"] == base  # all warm
        assert_same_answers(x, Q, answers, cold, EPS)
    finally:
        warm.close()


def test_reopen_keeps_device_and_periodic_snapshots(data, tmp_path):
    x = data
    idx = DiskJoinIndex.build(FlatVectorStore.from_array(
        str(tmp_path / "x.bin"), x), JoinConfig(**CFG),
        str(tmp_path / "idx"), device="cpu")
    path = os.path.join(idx.workdir, RESIDENCY_NAME)
    idx.enable_residency_snapshots(interval_s=0.0)
    for q in x[:8]:
        idx.query(q)
    idx._residency_committer.drain()
    assert os.path.exists(path)
    assert idx.pipeline_snapshot()["residency_snapshots"] >= 1
    idx.disable_residency_snapshots()
    warm = idx.warm_buckets()
    idx.save_residency_snapshot()
    again = idx.reopen()
    try:
        assert again.device == torch.device("cpu")
        assert again.workdir == idx.workdir
        assert sorted(again.warm_buckets()) == sorted(warm)
        assert_identical_answers(again.query_batch(x[:8]),
                                 idx.query_batch(x[:8]))
    finally:
        again.close()
        idx.close()


@pytest.mark.parametrize("method", ["read_bucket", "read_bucket_into",
                                    "read_run_into"])
def test_flaky_store_fails_every_read_path(data, tmp_path, method):
    """Each read method the port's stores and prefetcher use raises under
    the fault modes; a transiently flaky store retried in place gives the
    clean join's bytes."""
    x = data
    idx = DiskJoinIndex.build(FlatVectorStore.from_array(
        str(tmp_path / "x.bin"), x), JoinConfig(**CFG, io_coalesce=True),
        str(tmp_path / "idx"), device="cpu")
    store = idx.store
    cap = idx.bucket_capacity
    vecs = np.zeros((2 * cap, x.shape[1]), np.float32)
    ids = np.zeros(2 * cap, np.int64)
    call = {"read_bucket": lambda s: s.read_bucket(0),
            "read_bucket_into": lambda s: s.read_bucket_into(
                0, vecs[:cap], ids[:cap]),
            "read_run_into": lambda s: s.read_run_into(
                run, [vecs[:cap], vecs[cap:]], [ids[:cap], ids[cap:]])}[
        method]
    run = next([a, b] for a in range(idx.num_buckets)
               for b in range(idx.num_buckets)
               if a != b and store.contiguous_after(a, b))
    flaky = FlakyStore(store, read_error_every=1, max_errors=1)
    with pytest.raises(IOError):
        call(flaky)
    call(flaky)                      # the error budget is spent
    flaky.kill()
    with pytest.raises(InjectedKill):
        call(flaky)
    flaky.revive()
    clean = idx.self_join(io_mode="prefetch", io_batch_reads=True)
    idx.store = FlakyStore(store, read_error_every=3, max_errors=4)
    flaky_run = idx.self_join(io_mode="prefetch", io_batch_reads=True,
                              io_retries=8, io_retry_backoff_s=0.0)
    injected = idx.store.errors_injected
    assert injected >= 1
    assert flaky_run.io_stats["pipeline"]["io_retries"] == injected
    assert_identical(clean, flaky_run)
    idx.store = store
    idx.close()


def test_kill_mid_wave_returns_every_pin(data, tmp_path):
    """``kill_replica`` lands while a wave reads (emulated latency): the
    doomed requests fail, the session's pool is left holding only its warm
    pins, and dropping the warm cache leaves 0 slabs in use."""
    x = data
    idx = DiskJoinIndex.build(FlatVectorStore.from_array(
        str(tmp_path / "x.bin"), x), JoinConfig(**CFG),
        str(tmp_path / "idx"), device="cpu")
    killed = threading.Event()
    sched = QueryScheduler(idx, wave_size=16, max_wait_s=0.01,
                           emulate_read_latency_s=0.01,
                           compute_mode="device")
    futs = [sched.submit(q) for q in x[::150][:16] + np.float32(1e-3)]

    def kill():
        threading.Event().wait(0.03)
        FaultInjector().kill_replica(idx)
        killed.set()

    t = threading.Thread(target=kill)
    t.start()
    outcomes = []
    for f in futs:
        try:
            f.result(timeout=WAIT)
            outcomes.append("ok")
        except Exception as e:   # the dead store's reads
            outcomes.append(type(e).__name__)
    t.join(timeout=WAIT)
    sched.close()
    assert killed.is_set()
    assert "InjectedKill" in outcomes, outcomes
    pool = idx._pool
    assert pool.in_use == len(idx.warm_buckets())
    idx.drop_warm_cache()
    assert pool.in_use == 0
    idx.close()
