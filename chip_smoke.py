#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and nothing is caught:

1. Device and build: the card's name and power limit (``nvidia-smi``), the
   TF32 settings (the port needs full float32 matmuls), and the nvcc build
   of every kernel in ``src/repro_torch/kernels/csrc`` with its time.
2. The main path at SIFT1M's shape (1,000,000 × 128 float32 from the
   seeded generator ``clustered_vectors``; ε for ≈20 neighbours;
   1,000 buckets, the paper's 1‰; a cache of 10% of the data):
   ``DiskJoinIndex.build`` → ``self_join`` (device mode) →
   ``query_batch`` of 1,000 queries in host and device mode. The kernels'
   launch counts are zeroed just before and read just after; every kernel
   must have launched. Recall against brute force (float64, on the card)
   for 2,000 rows must reach 0.88; query memberships of the two modes must
   agree except on ε-boundary pairs.
3. Every kernel against its plain PyTorch version at the shapes the main
   path gave it, then timed (CUDA events over warm launches) beside its
   plain version, a library call where one exists, and its bound.
4. Host/device byte parity of ``self_join`` at 100,000 × 128.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA it exits nonzero
before printing any result. The sizes are fixed (``N_MAIN`` …); the only
option, ``--profile``, adds a traced repeat of the device-mode join.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.core.bucketize import sample_centers  # noqa: E402
from repro_torch.data import (clustered_vectors,  # noqa: E402
                              epsilon_for_avg_neighbors)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet), at the 700 W limit
PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # HBM3
D2_RTOL, D2_ATOL = 1e-4, 1e-3   # tests/test_kernels.py's d² tolerance
MASK_BAND = 1e-2                # mask may differ only this close to ε²
DIM = 128
N_MAIN = 1_000_000      # SIFT1M's 1,000,000 x 128
N_PARITY = 100_000      # host mode fetches whole d²/mask batches: cut here
N_QUERIES = 1_000
N_RECALL_ROWS = 2_000


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """Fail the run (a raise, so ``python -O`` cannot drop it)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------
def phase_device() -> None:
    log(gpu_name_and_power())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls on")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    t0 = time.perf_counter()
    _build.load()
    built = ("none, library already built in this checkout"
             if _build.build_seconds is None
             else f"{_build.build_seconds:.2f} s")
    log(f"[build] nvcc build {built}, load {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: the main path at SIFT1M shape
# ---------------------------------------------------------------------------
def brute_force_recall(x: np.ndarray, eps: float, pairs: np.ndarray,
                       rows: np.ndarray) -> tuple[float, int]:
    """Recall of ``pairs`` on every true ε-pair touching ``rows``; the
    truth is float64 distances on the card."""
    xd = torch.from_numpy(x).cuda().double()
    sq = (xd * xd).sum(1)
    eps2 = float(eps) * float(eps)
    truth = []
    for i0 in range(0, rows.size, 250):
        r = torch.from_numpy(rows[i0:i0 + 250]).cuda()
        q = xd[r]
        d2 = (q * q).sum(1)[:, None] - 2.0 * (q @ xd.T) + sq[None, :]
        qi, j = torch.nonzero(d2 <= eps2, as_tuple=True)
        i = r[qi]
        keep = i != j
        lo = torch.minimum(i[keep], j[keep])
        hi = torch.maximum(i[keep], j[keep])
        truth.append(lo * x.shape[0] + hi)
    truth = torch.unique(torch.cat(truth))
    got = torch.from_numpy(pairs[:, 0] * x.shape[0] + pairs[:, 1]).cuda()
    hit = torch.isin(truth, got)
    return hit.double().mean().item(), int(truth.numel())


def check_join_output(x: np.ndarray, eps: float, res) -> None:
    p, d = res.pairs, res.distances
    check(p.ndim == 2 and p.shape[1] == 2 and p.shape[0] == d.shape[0] > 0,
          f"pairs {p.shape} / distances {d.shape}")
    check(d.dtype == np.float32 and np.isfinite(d).all(), "distances")
    check((p[:, 0] < p[:, 1]).all() and p.min() >= 0
          and p.max() < x.shape[0], "pair ids")
    # distances agree with float64 on a sample, and all lie within ε
    rng = np.random.default_rng(0)
    s = rng.choice(p.shape[0], size=min(20_000, p.shape[0]), replace=False)
    d64 = np.sqrt(((x[p[s, 0]].astype(np.float64) - x[p[s, 1]]) ** 2)
                  .sum(1))
    err = np.abs(d[s] - d64).max()
    check(err <= 1e-3, f"distance error {err} vs float64")
    check(d.max() <= eps * (1 + 1e-5) + 1e-6, "a distance exceeds eps")


def check_query_agreement(x, Q, src, eps, host, dev):
    """Memberships of the two modes agree except on ε-boundary pairs, and
    (nearly) every query finds the row it was drawn next to (the pruning
    is probabilistic). Returns (members, boundary, found)."""
    members = boundary = found = 0
    eps2 = float(eps) * float(eps)
    for qi, ((hi, hd), (di, dd)) in enumerate(zip(host, dev)):
        check(np.isfinite(hd).all() and np.isfinite(dd).all(),
              f"query {qi} distances")
        check((hd <= eps * (1 + 1e-5) + 1e-6).all(), f"query {qi} > eps")
        found += int(src[qi] in set(hi.tolist()))
        q64 = Q[qi].astype(np.float64)
        for v in set(hi.tolist()) ^ set(di.tolist()):
            d2 = ((x[v].astype(np.float64) - q64) ** 2).sum()
            check(abs(d2 - eps2) <= 1e-4 * max(1.0, eps2),
                  f"query {qi} member {v} off the boundary (d2 {d2})")
            boundary += 1
        members += hi.size
    check(found >= 0.99 * len(host), f"{found} queries found their row")
    return members, boundary, found


def phase_main_path(workdir: str) -> dict:
    n, n_queries, n_recall = N_MAIN, N_QUERIES, N_RECALL_ROWS
    t = {}
    t0 = time.perf_counter()
    x = clustered_vectors(n, DIM, seed=1)
    t["data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eps = epsilon_for_avg_neighbors(x, 20)
    t["calibrate_eps"] = time.perf_counter() - t0
    store = FlatVectorStore.from_array(os.path.join(workdir, "x.bin"), x)
    cfg = JoinConfig(epsilon=eps, num_buckets=n // 1000,
                     memory_budget_bytes=x.nbytes // 10, pad_align=128,
                     compute_mode="device")
    rng = np.random.default_rng(7)
    src = rng.choice(n, size=n_queries, replace=False)
    Q = (x[src] + rng.normal(scale=1e-3, size=(n_queries, DIM))
         ).astype(np.float32)
    log(f"[main] {n} x {DIM} float32, eps={eps!r}, cfg: "
        f"num_buckets={cfg.num_buckets} memory_budget_bytes="
        f"{cfg.memory_budget_bytes} pad_align={cfg.pad_align} "
        f"verify_batch={cfg.verify_batch}")

    # --- the main path: counts zeroed just before, read just after -------
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = DiskJoinIndex.build(store, cfg, os.path.join(workdir, "index"))
    t["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = index.self_join()
    torch.cuda.synchronize()
    t["self_join"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_host = index.query_batch(Q, compute_mode="host")
    t["query_host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_dev = index.query_batch(Q, compute_mode="device")
    torch.cuda.synchronize()
    t["query_device"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # -----------------------------------------------------------------------
    log(f"[main] launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel never launched on the main path: {launches}")

    check_join_output(x, eps, res)
    t0 = time.perf_counter()
    rows = np.random.default_rng(3).choice(n, size=n_recall,
                                           replace=False)
    rec, n_truth = brute_force_recall(x, eps, res.pairs, rows)
    t["recall_check"] = time.perf_counter() - t0
    members, boundary, found = check_query_agreement(x, Q, src, eps, q_host,
                                                     q_dev)
    pipe = res.io_stats["pipeline"]
    log(f"[main] build timings {index.build_timings}")
    log(f"[main] buckets {index.num_buckets} capacity "
        f"{index.bucket_capacity}; pairs {res.pairs.shape[0]} "
        f"distance computations {res.num_distance_computations} "
        f"candidate pairs {res.num_candidate_pairs}")
    log(f"[main] join timings "
        f"{ {k: round(v, 4) for k, v in res.timings.items()} }; outside "
        f"them (first join's node ordering): "
        f"{t['self_join'] - res.timings['execute'] - res.timings['orchestration']:.3f} s")
    log(f"[main] cache hits {res.cache_hits} misses {res.cache_misses} "
        f"bucket loads {res.bucket_loads}")
    log("[main] pipeline " + json.dumps({k: pipe[k] for k in (
        "h2d_transfers", "h2d_transfers_saved", "device_slab_hits",
        "device_batches", "device_compact_overflows", "h2d_bytes",
        "d2h_bytes", "d2h_overlap_s", "loads", "io_wait_s", "compute_s")}))
    log(f"[main] recall {rec!r} on {n_truth} true pairs touching "
        f"{n_recall} rows (need >= 0.88)")
    log(f"[main] queries {n_queries}: {members} members, {boundary} "
        f"host/device differences, all on the eps boundary; {found} found "
        f"their source row")
    log(f"[main] phase seconds {json.dumps(t)}")
    check(rec >= 0.88, f"recall {rec} < 0.88")

    per_q = index.plan_probes(Q)
    probes = np.bincount(np.concatenate(per_q),
                         minlength=index.num_buckets)
    q_rows = int(1 << max(0, int(round(probes[probes > 0].mean())) - 1)
                 .bit_length())
    shapes = dict(x=x, eps=eps, cap=index.bucket_capacity,
                  E=cfg.verify_batch, Q=Q, q_rows=q_rows,
                  centers=sample_centers(store, n // 1000, cfg.seed,
                                         cfg.block_rows),
                  block_rows=cfg.block_rows, index=index)
    return dict(launches=launches, shapes=shapes, recall=rec)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, timed
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_mem = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def check_d2(d2k, d2r, mk, mr, eps) -> tuple[float, int]:
    over = (d2k - d2r).abs() - (D2_ATOL + D2_RTOL * d2r.abs())
    check(over.max().item() <= 0, f"d2 outside tolerance by "
          f"{over.max().item()}")
    dis = mk != mr
    n_dis = int(dis.sum().item())
    if n_dis:
        band = (d2r[dis] - ops.eps2_f32(eps)).abs().max().item()
        check(band < MASK_BAND, f"mask differs {band} from eps^2")
    return (d2k - d2r).abs().max().item(), n_dis


def bucket_lanes(index, E: int) -> torch.Tensor:
    """E real buckets as (E, cap, d) slabs, rows cycled to the capacity
    (the verify kernel's intra-bucket shape with real data, no pad rows)."""
    lanes = []
    for b in range(E):
        vecs, _ = index.store.read_bucket(b % index.num_buckets)
        lanes.append(np.resize(vecs, (index.bucket_capacity, vecs.shape[1])))
    return torch.from_numpy(np.stack(lanes)).cuda()


def phase_kernels(main: dict) -> list[dict]:
    s = main["shapes"]
    eps, cap, E, d = s["eps"], s["cap"], s["E"], DIM
    eps2 = ops.eps2_f32(eps)
    out = []

    # verify, batched: (E, cap, d) x (E, cap, d)
    u = bucket_lanes(s["index"], E)
    v = torch.roll(u, shifts=1, dims=0)   # lane e: bucket e vs bucket e-1
    v[: E // 2] = u[: E // 2]             # half the lanes intra-bucket
    d2k, mk = ops.verify_pairs_batch(u, v, eps)
    d2r, mr = ref.pairwise_l2_threshold(u, v, eps2)
    torch.cuda.synchronize()
    err, n_dis = check_d2(d2k, d2r, mk, mr, eps)
    ms = cuda_ms(lambda: ops.verify_pairs_batch(u, v, eps))
    plain = cuda_ms(lambda: ref.pairwise_l2_threshold(u, v, eps2))
    lib = cuda_ms(lambda: torch.cdist(u, v))
    bms, by = bound(2.0 * E * cap * cap * d,
                    4.0 * E * 2 * cap * d + 5.0 * E * cap * cap)
    log(f"[kernel] verify_pairs_batch ({E}, {cap}, {cap}, {d}): max abs "
        f"err {err!r}, mask disagreements {n_dis} (all within "
        f"{MASK_BAND} of eps^2), pairs in mask {int(mk.sum().item())}")
    out.append(dict(
        name="pairwise_l2_threshold_batched", route="cuda",
        source="src/repro_torch/kernels/csrc/pairwise_l2.cu",
        replaces="src/repro/kernels/pairwise_l2.py:86",
        launches=main["launches"]["verify_pairs_batch"], max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        shape=[E, cap, cap, d], ok=True))
    del d2k, mk, d2r, mr

    # verify, unbatched (E = 1): the device query path's (q_rows, cap) tile
    qr = s["q_rows"]
    q = torch.from_numpy(s["Q"][:qr]).cuda()
    slab = u[0]
    d2k, mk = ops.pairwise_l2_threshold(q, slab, eps)
    d2r, mr = ref.pairwise_l2_threshold(q, slab, eps2)
    torch.cuda.synchronize()
    err1, n_dis1 = check_d2(d2k, d2r, mk, mr, eps)
    ms = cuda_ms(lambda: ops.pairwise_l2_threshold(q, slab, eps), reps=100)
    plain = cuda_ms(lambda: ref.pairwise_l2_threshold(q, slab, eps2),
                    reps=100)
    lib = cuda_ms(lambda: torch.cdist(q, slab), reps=100)
    bms, by = bound(2.0 * qr * cap * d, 4.0 * (qr + cap) * d
                    + 5.0 * qr * cap)
    # lane independence: the E = 1 launch gives the batched launch's bytes
    d2a, _ = ops.verify_pairs_batch(u[:2], v[:2], eps)
    d2b, _ = ops.pairwise_l2_threshold(u[1], v[1], eps)
    check(torch.equal(d2a[1], d2b), "E=1 launch differs from its lane")
    log(f"[kernel] pairwise_l2_threshold ({qr}, {cap}, {d}): max abs err "
        f"{err1!r}, mask disagreements {n_dis1}; E=1 launch bytes == "
        f"batched lane bytes")
    out.append(dict(
        name="pairwise_l2_threshold", route="cuda",
        source="src/repro_torch/kernels/csrc/pairwise_l2.cu",
        replaces="src/repro/kernels/pairwise_l2.py:128",
        launches=main["launches"]["pairwise_l2_threshold"],
        max_abs_err=err1, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib, shape=[qr, cap, d], ok=True))
    del u, v

    # assign: one scan-2 block against the sampled centers
    xb = torch.from_numpy(s["x"][: s["block_rows"]]).cuda()
    c = torch.from_numpy(s["centers"]).cuda()
    m, b = xb.shape[0], c.shape[0]
    dk, ik = ops.bucket_assign(xb, c)
    dr, ir = ref.bucket_assign(xb, c)
    torch.cuda.synchronize()
    check(torch.equal(ik, ir), f"argmin differs on "
          f"{int((ik != ir).sum().item())} rows")
    over = (dk - dr).abs() - (D2_ATOL + D2_RTOL * dr.abs())
    check(over.max().item() <= 0, "assign d2 outside tolerance")
    err2 = (dk - dr).abs().max().item()
    ms = cuda_ms(lambda: ops.bucket_assign(xb, c), reps=50)
    plain = cuda_ms(lambda: ref.bucket_assign(xb, c), reps=50)
    bms, by = bound(2.0 * m * b * d, 4.0 * (m + b) * d + 8.0 * m)
    log(f"[kernel] bucket_assign ({m}, {b}, {d}): argmin equal, max abs err "
        f"{err2!r}")
    out.append(dict(
        name="bucket_assign", route="cuda",
        source="src/repro_torch/kernels/csrc/bucket_assign.cu",
        replaces="src/repro/kernels/bucket_assign.py:49",
        launches=main["launches"]["bucket_assign"], max_abs_err=err2,
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        shape=[m, b, d], ok=True))
    for k in out:
        log(f"[kernel] {k['name']}: kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}), roofline share "
            f"{k['bound_ms'] / k['ms']:.3f}")
    return out


def phase_profile(index) -> None:
    """One more device-mode self_join (graph and node order cached) under
    torch.profiler: device time by kernel and copy, and the device's busy
    share of the join's wall time. Only with ``--profile``: tracing slows
    the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.self_join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    log(f"[profile] self_join wall {wall:.3f} s, device kernels + copies "
        f"{busy:.3f} s (busy share {busy / wall:.3f}, one stream)")
    for key, us, n in rows[:10]:
        log(f"[profile] {us / 1e3:10.2f} ms  {n:6d} x  {key[:90]}")


# ---------------------------------------------------------------------------
# phase 4: host/device byte parity at 100k
# ---------------------------------------------------------------------------
def phase_parity(workdir: str) -> None:
    n = N_PARITY
    x = clustered_vectors(n, DIM, seed=2)
    eps = epsilon_for_avg_neighbors(x, 20)
    store = FlatVectorStore.from_array(os.path.join(workdir, "p.bin"), x)
    cfg = JoinConfig(epsilon=eps, num_buckets=n // 1000,
                     memory_budget_bytes=x.nbytes // 10, pad_align=128)
    with DiskJoinIndex.build(store, cfg,
                             os.path.join(workdir, "pidx")) as index:
        t0 = time.perf_counter()
        host = index.self_join(compute_mode="host")
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = index.self_join(compute_mode="device")
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
    check_join_output(x, eps, host)
    check(np.array_equal(host.pairs, dev.pairs), "host/device pairs differ")
    check(np.array_equal(host.distances, dev.distances),
          "host/device distances differ")
    check(host.num_distance_computations == dev.num_distance_computations,
          "host/device distance computations differ")
    log(f"[parity] {n} x {DIM}: {host.pairs.shape[0]} pairs, host "
        f"and device byte-identical (pairs and distances); self_join host "
        f"{t_host:.3f} s, device {t_dev:.3f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one more device-mode self_join with "
                    "torch.profiler: device busy share and top kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    phase_device()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        main_path = phase_main_path(workdir)
        kernels = phase_kernels(main_path)
        phase_parity(workdir)
        if args.profile:
            phase_profile(main_path["shapes"]["index"])
        main_path["shapes"]["index"].close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"[done] total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
