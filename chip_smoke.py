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
   must have launched, every verify launch (batched and E = 1) must have
   taken the tensor-core route (``pairwise_l2_sm90.cu``), and every assign
   launch of the build too (``bucket_assign_sm90.cu``); the build's
   timings give the assign scan's share of it. Recall
   against brute force (float64, on the card) for 2,000 rows must reach
   0.88; query memberships of the two modes must agree except on
   ε-boundary pairs.
3. Every kernel against its plain PyTorch version at the shapes the main
   path gave it, then timed beside its plain version, a library call where
   one exists, and its bound: device time from CUDA graphs, with the eager
   loop's time (launch latency included) beside it. The verify kernel's
   CUDA-core route (``pairwise_l2.cu``) is checked and timed at the
   batched shape too, and both routes and the plain version are held
   against float64 on the same lanes (d² bias near ε², ε-pairs missed and
   kept). Both assign routes (``bucket_assign_sm90.cu``,
   ``bucket_assign.cu``) are checked and timed at one scan block of the
   build (8,192 × 1,000 centers) and against 65,536 centers (the
   reference's center-index crossover), beside the center index's own
   matmul + argmin, and on near-ties (duplicated centers; centers moved
   by a few ulps).
4. ``[io]``, on the main path's 1M index (graph and node order cached):
   ``self_join`` with prefetch I/O (``io_mode="prefetch"``,
   ``io_batch_reads``), then with the planner (prefetch, ``plan_mode="on"``,
   ``compute_mode="auto"``): both byte-identical to the main path's sync
   join (pairs and distances), ``execute``/``io_wait``/``compute`` and the
   prefetcher's counters logged beside the sync join's, the cost model and
   the plan (routes, ``pair_cap``, verify batches, compaction overflows,
   which must be 0). ``query_batch`` of the 1,000 queries with prefetch and
   the planner in host and device mode: the sync waves' memberships but
   for ε-boundary pairs. A cross-join against a second corpus of 100,000
   near-duplicates (rows of the data + N(0, 1e-3)), built striped over 4
   devices with coalescing and a spatial layout: sync and prefetch
   byte-identical, recall against float64 ≥ 0.88 on 2,000 rows of the
   second side. Every verify launch of each path (counts zeroed just
   before it) must take the tensor-core route. Then the planner's CUDA
   coefficients (copy rates, each verify engine's flush at the verify
   shape and its fixed cost; ``plan/cost_model.py``) and the IVF center
   index's assign above the crossover (8,192 rows × 65,537 centers) on the
   card against the CPU.
5. ``[serve]``, on the same 1M index (launch counts zeroed just before):
   the 1,000 queries through ``VectorQueryService`` one at a time, then
   again under ``attach_live`` with a p95 latency objective (warm hits;
   the rollup must count each query; ``query_batch``'s memberships but
   for ε-boundary rows; the dashboard logged); fig22's burst (4,096
   requests at t = 0 from 8 threads, 70% near 16 hot anchors, N(0, 0.01)
   noise, a 30 s deadline) through ``QueryScheduler`` with and without
   probe sharing (sharing must save reads; reads a request logged), then
   its first 256 requests through both policies without a deadline
   (sharing must read less on the same requests, all answered); every
   answer holds the query contract against ``query_batch``; an
   ``IndexRouter`` over two replica sessions of the 1M workdir, one
   killed (the same answers, byte for byte, through the other) and
   restarted by ``ReplicaSupervisor`` on the card; 4 spatial
   shards of 250,000 rows behind one router (recall against float64
   ≥ 0.88, no member outside ε beyond the boundary band); a residency
   snapshot and a warm ``reopen`` (the snapshot's buckets warm, each a
   hit for the first 64 queries, the cold session's bytes). Every verify
   launch of the phase takes the tensor-core route.
6. Byte parity of ``self_join`` at 100,000 × 128: host and device mode,
   sync and prefetch I/O, and a second build striped over 4 devices with
   coalescing; every join (device mode in each I/O × striping corner)
   gives the plain sync host join's bytes. The prefetch join again under
   ``trace_session``: its bytes, exported as a Chrome trace
   (``hidden_fraction(io.read, io.wait)`` logged beside the untraced
   join's time). A device join with every verify launch forced onto
   the CUDA-core route (``pairwise_l2.cu``): each pair in its difference
   from the tensor-core join lies within 1e-2 of ε² in float64. A resumable build killed after its assign
   scan, then resumed: no rescan, and the uninterrupted build's bucket
   files and join bytes.
7. ``[lm]``: LM serving at qwen3-0.6b's full width (28 layers, bf16
   weights from a seeded generator on the card): ``ServeEngine(slots=4,
   max_seq=512)`` serves 8 random prompts (4 of 64 tokens, 4 of 128;
   32 new tokens each, no EOS: two waves), then ``prefill`` runs on
   (4, 2048) tokens. The flash-attention launch count, zeroed just before,
   must be 28 × decode steps + 28 per prefill, every decode call served by
   the split-KV kernel (``flash_decode.cu``) and every prefill call by the
   tensor-core kernel (``flash_prefill_sm90.cu``). The kernels are held
   against their plain version at the prefill and decode shapes in bf16
   and float32 (float32 prefill runs the CUDA-core kernel,
   ``flash_attention.cu``), and timed (device time, from CUDA graphs)
   beside their bound and ``scaled_dot_product_attention``. In float32,
   decode must reproduce the teacher-forced forward over a 64-token
   prompt, B = 4 (tests/test_models.py's tolerance).

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA it exits nonzero
before printing any result. The sizes are fixed (``N_MAIN`` …); the only
option, ``--profile``, adds a traced repeat of the device-mode join,
profiled point queries one at a time and traced LM decode steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.compute import (DeviceVerifyEngine,  # noqa: E402
                                  HostVerifyEngine)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.core import center_index  # noqa: E402
from repro_torch.core.index import RESIDENCY_NAME  # noqa: E402
from repro_torch.core.bucketize import sample_centers  # noqa: E402
from repro_torch.data import (clustered_vectors,  # noqa: E402
                              epsilon_for_avg_neighbors)
from repro_torch.ft import FaultInjector, InjectedKill  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import bucket_assign as assign  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import pairwise_l2 as verify  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.obs import Slo, dash, trace_session  # noqa: E402
from repro_torch.plan import cost_model  # noqa: E402
from repro_torch.serve import (DOWN, HEALTHY,  # noqa: E402
                               DeadlineExceeded, IndexRouter,
                               QueryScheduler, ReplicaSupervisor,
                               ServeEngine, VectorQueryService,
                               order_result)
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet), at the 700 W limit
PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12  # TF32 on the tensor cores, dense
PEAK_BF16_FLOPS = 989e12   # bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12       # HBM3
D2_RTOL, D2_ATOL = 1e-4, 1e-3   # tests/test_kernels.py's d² tolerance
MASK_BAND = 1e-2                # mask may differ only this close to ε²
DIM = 128
N_MAIN = 1_000_000      # SIFT1M's 1,000,000 x 128
N_PARITY = 100_000      # host mode fetches whole d²/mask batches: cut here
N_QUERIES = 1_000
N_RECALL_ROWS = 2_000
N_CROSS = 100_000       # the cross-join's second side: near-duplicates
N_SERVE_REQUESTS = 4096  # fig22's burst: every request at t = 0
N_SAME_REQUESTS = 256   # its head, served by both policies, none dropped
SERVE_SUBMITTERS = 8
N_HOT_ANCHORS = 16
N_REPLICA_ANSWERS = 64
N_SHARDS = 4            # 250,000 rows each
N_PROFILE_QUERIES = 50  # --profile: point queries per profiled pass
JOIN_KERNELS = ("pairwise_l2_threshold", "verify_pairs_batch",
                "bucket_assign")
LM_ARCH = "qwen3-0.6b"
LM_SLOTS, LM_MAX_SEQ = 4, 512
LM_PROMPT_LENS = (64, 128) * 4     # interleaved: the engine forms 2 waves
LM_NEW_TOKENS = 32
LM_PREFILL_SHAPE = (4, 2048)
LM_TF_SHAPE = (4, 64)              # decode vs teacher forcing, float32
LM_DECODE_POS = 300                # decode check: cache slots >= 301 empty
# rtol = atol, as |got - want| <= tol * (1 + |want|). bf16: one bf16 ulp
# (2^-8 relative) of the output, since a kernel whose float32 result
# differs from the plain version's in the last bits may round to the
# neighbouring bf16 value
ATTN_TOL = {torch.bfloat16: 4e-3, torch.float32: 2e-4}
VERIFY_SOURCES = {
    "tc": "src/repro_torch/kernels/csrc/pairwise_l2_sm90.cu",
    "simt": "src/repro_torch/kernels/csrc/pairwise_l2.cu"}
ASSIGN_SOURCES = {
    "tc": "src/repro_torch/kernels/csrc/bucket_assign_sm90.cu",
    "simt": "src/repro_torch/kernels/csrc/bucket_assign.cu"}
CROSSOVER_CENTERS = 65_536   # the reference's center-index crossover
FLASH_SOURCES = {
    "tc": "src/repro_torch/kernels/csrc/flash_prefill_sm90.cu",
    "split": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"}


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
    for line in _build.build_log.splitlines():  # per kernel: name, then use
        if ("entry function" in line or "registers" in line
                or "spill" in line or "Performance" in line):
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


def ordered(answers) -> list:
    """(ids, distances) pairs in the scheduler's order: distance, then id."""
    return [order_result(i, d, None) for i, d in answers]


def check_query_agreement(x, Q, src, eps, a, b, what: str = "query"):
    """The query contract between two answer lists of the same queries:
    finite distances within ε; the same members except ε-boundary rows
    (float64 d² within 1e-4 of ε²); distances of common members within
    1e-3; and, where ``src`` is given, (nearly) every query finds the row
    it was drawn next to (the pruning is probabilistic). Counts members
    (of ``a``), boundary differences, queries that found their row (None
    without ``src``) and answers whose bytes differ after ordering."""
    members = boundary = found = byte_diff = 0
    eps2 = float(eps) * float(eps)
    for qi, ((ai, ad), (bi, bd)) in enumerate(zip(ordered(a), ordered(b))):
        check(np.isfinite(ad).all() and np.isfinite(bd).all(),
              f"{what} {qi} distances")
        check((ad <= eps * (1 + 1e-5) + 1e-6).all(), f"{what} {qi} > eps")
        if not (np.array_equal(ai, bi) and np.array_equal(ad, bd)):
            byte_diff += 1
        if src is not None:
            found += int(src[qi] in set(ai.tolist()))
        q64 = Q[qi].astype(np.float64)
        for v in set(ai.tolist()) ^ set(bi.tolist()):
            d2 = ((x[v].astype(np.float64) - q64) ** 2).sum()
            check(abs(d2 - eps2) <= 1e-4 * max(1.0, eps2),
                  f"{what} {qi} member {v} off the boundary (d2 {d2})")
            boundary += 1
        da, db = dict(zip(ai.tolist(), ad)), dict(zip(bi.tolist(), bd))
        check(all(abs(da[k] - db[k]) <= 1e-3 for k in da if k in db),
              f"{what} {qi}: distances of common members differ")
        members += ai.size
    if src is None:
        found = None
    else:
        check(found >= 0.99 * len(a), f"{found} queries found their row")
    return dict(members=members, boundary=boundary, found=found,
                byte_diff=byte_diff)


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
    check(all(launches[k] > 0 for k in JOIN_KERNELS),
          f"a kernel never launched on the main path: {launches}")
    verify_launches = (launches["verify_pairs_batch"]
                       + launches["pairwise_l2_threshold"])
    check(launches["verify_simt"] == 0
          and launches["verify_tc"] == verify_launches,
          f"a verify launch left the tensor-core route: {launches}")
    check(launches["assign_simt"] == 0
          and launches["assign_tc"] == launches["bucket_assign"],
          f"an assign launch left the tensor-core route: {launches}")

    check_join_output(x, eps, res)
    t0 = time.perf_counter()
    rows = np.random.default_rng(3).choice(n, size=n_recall,
                                           replace=False)
    rec, n_truth = brute_force_recall(x, eps, res.pairs, rows)
    t["recall_check"] = time.perf_counter() - t0
    agree = check_query_agreement(x, Q, src, eps, q_host, q_dev)
    pipe = res.io_stats["pipeline"]
    bt = index.build_timings
    log(f"[main] build timings {bt}; the assign scan {bt['assign']:.3f} s "
        f"of the {t['build']:.3f} s build ({bt['assign'] / t['build']:.3f})")
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
    log(f"[main] queries {n_queries}: {agree['members']} members, "
        f"{agree['boundary']} host/device differences, all on the eps "
        f"boundary; {agree['found']} found their source row")
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
                  block_rows=cfg.block_rows, index=index, store=store)
    return dict(launches=launches, shapes=shapes, recall=rec, res=res,
                q_host=q_host, q_dev=q_dev, src=src, cfg=cfg)


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


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: ``reps`` calls captured in
    a CUDA graph, replayed ``replays`` times between CUDA events after a
    warm replay, so the host's launch cost (tens of µs a call) does not
    set the reading of a kernel shorter than it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def bound(flops: float, nbytes: float, flops_bf16: float = 0.0,
          flops_tf32: float = 0.0) -> tuple[float, str]:
    """Least time in ms: float32 ``flops`` at the CUDA cores' peak plus
    ``flops_bf16`` (bf16 operands) and ``flops_tf32`` (TF32 operands) at the
    tensor cores', or ``nbytes`` at HBM's rate, whichever is larger."""
    t_ops = (flops / PEAK_F32_FLOPS + flops_bf16 / PEAK_BF16_FLOPS
             + flops_tf32 / PEAK_TF32_FLOPS)
    t_mem = nbytes / PEAK_BYTES
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


def f64_agreement(u, v, eps, outs: dict) -> dict:
    """Each version's (d², mask) against float64 truth on the same lanes:
    the mean signed d² error where the truth lies within 0.02 of ε², and
    the true ε-pairs missed and false ones kept."""
    u64, v64 = u.double(), v.double()
    t64 = ((u64 * u64).sum(-1)[..., :, None]
           + (v64 * v64).sum(-1)[..., None, :]
           - 2.0 * (u64 @ v64.transpose(1, 2))).clamp_min(0.0)
    eps2 = float(eps) * float(eps)
    truth = t64 <= eps2
    near = (t64 - eps2).abs() < 0.02
    res = {}
    for name, (d2, mask) in outs.items():
        res[name] = dict(
            bias_near_eps=(d2.double() - t64)[near].mean().item(),
            missed=int((truth & ~mask).sum().item()),
            extra=int((mask & ~truth).sum().item()))
    res["true_pairs"] = int(truth.sum().item())
    return res


def verify_bound(e: int, m: int, n: int, d: int) -> tuple[float, str]:
    """Least time of float32-accurate verify on the card: its products as
    three TF32 tensor-core passes (the 3×TF32 split; one pass keeps too few
    digits), or each operand read once and d² + mask written once."""
    return bound(0.0, 4.0 * e * (m + n) * d + 5.0 * e * m * n,
                 flops_tf32=3 * 2.0 * e * m * n * d)


def assign_bound(m: int, b: int, d: int) -> tuple[float, str]:
    """Least time of float32-accurate assign on the card: its products as
    three TF32 tensor-core passes (the 3×TF32 split), or X and the centers
    read once and (d², index) written once."""
    return bound(0.0, 4.0 * (m + b) * d + 8.0 * m,
                 flops_tf32=3 * 2.0 * m * b * d)


def assign_row(xb: torch.Tensor, c: torch.Tensor) -> dict:
    """Both assign routes at (M, B, d) against the plain version: argmin
    equal, d² within tolerance, the tc route's bytes against simt's;
    device times beside the plain version, the center index's own
    matmul + argmin (context, not a yardstick) and the bound."""
    m, d = xb.shape
    b = c.shape[0]
    plan = assign.launch_plan(m, b, d)
    check(plan.route == "tc", f"assign ({m}, {b}, {d}) routed to {plan}")
    simt = assign.LaunchPlan("simt")
    dk, ik = ops.bucket_assign(xb, c)
    ds, is_ = assign.bucket_assign(xb, c, simt)
    dr, ir = ref.bucket_assign(xb, c)
    torch.cuda.synchronize()
    for route, (dv, iv) in (("tc", (dk, ik)), ("simt", (ds, is_))):
        check(torch.equal(iv, ir), f"{route} argmin differs from plain on "
              f"{int((iv != ir).sum().item())} rows at ({m}, {b}, {d})")
        over = (dv - dr).abs() - (D2_ATOL + D2_RTOL * dr.abs())
        check(over.max().item() <= 0, f"{route} assign d2 outside tolerance")
    err = (dk - dr).abs().max().item()
    err_simt = (ds - dr).abs().max().item()
    differ = int(((ik != is_) | (dk != ds)).sum().item())
    del dr, ir
    many = b > 10_000   # one call takes milliseconds: fewer in a graph
    ms = graph_ms(lambda: ops.bucket_assign(xb, c))
    simt_ms = graph_ms(lambda: assign.bucket_assign(xb, c, simt),
                       reps=5 if many else 20)
    eager = cuda_ms(lambda: ops.bucket_assign(xb, c), reps=10 if many else 50)
    plain = graph_ms(lambda: ref.bucket_assign(xb, c), reps=2 if many else 20)
    csq = torch.sum(c * c, dim=1)
    index_ms = graph_ms(lambda: center_index._nearest(xb, c, csq),
                        reps=2 if many else 20)
    bms, by = assign_bound(m, b, d)
    f32_bms, _ = bound(2.0 * m * b * d, 4.0 * (m + b) * d + 8.0 * m)
    log(f"[kernel] bucket_assign ({m}, {b}, {d}): route tc (block "
        f"{plan.block_m}, {plan.splits} splits); argmin equal to plain on "
        f"both routes, max abs err tc {err!r}, simt {err_simt!r}; tc bytes "
        f"differ from simt on {differ} rows; device ms tc {ms:.4f}, simt "
        f"{simt_ms:.4f} (tc {simt_ms / ms:.2f}x faster), plain {plain:.4f}, "
        f"center index matmul + argmin {index_ms:.4f} (context); eager tc "
        f"{eager:.4f}; bound {bms:.4f} ({by}; float32 CUDA-core pricing "
        f"{f32_bms:.4f}), share {bms / ms:.3f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None, eager_ms=eager,
                simt_ms=simt_ms, simt_max_abs_err=err_simt,
                simt_bytes_differ=differ, f32_bound_ms=f32_bms,
                center_index_ms=index_ms, splits=plan.splits,
                shape=[m, b, d])


def assign_near_ties(xb: torch.Tensor, c: torch.Tensor) -> dict:
    """The tc route on near-ties, rows = 64 centers then the scan block.
    Centers twice (split sub-buckets share theirs): argmin equal to the
    plain version's, the lowest index wins. Each center beside a copy moved
    by 3 ulps: the result is the CUDA-core kernel's, byte for byte (both
    decide in float32 FMAs); a row that is a center gets it, at d² 0; where
    the plain version (another float32 order) picks the other of a pair,
    the pair's exact d² must lie within float32 rounding of each other."""
    rows = torch.cat([c[:64], xb[: xb.shape[0] - 64]])
    own = torch.arange(64, device=rows.device, dtype=torch.int32)
    dups = torch.cat([c, c])
    dk, ik = ops.bucket_assign(rows, dups)
    dr, ir = ref.bucket_assign(rows, dups)
    check(torch.equal(ik, ir), "near-ties: argmin differs from plain on "
          f"duplicated centers ({int((ik != ir).sum().item())} rows)")
    check(torch.equal(ik[:64], own), "near-ties: a duplicated center "
          "did not go to the lower index")
    moved = c
    for _ in range(3):
        moved = torch.nextafter(moved, torch.full_like(moved, float("inf")))
    pairs = torch.cat([c, moved])
    dk, ik = ops.bucket_assign(rows, pairs)
    ds, is_ = assign.bucket_assign(rows, pairs, assign.LaunchPlan("simt"))
    _, ir = ref.bucket_assign(rows, pairs)
    check(torch.equal(ik, is_) and torch.equal(dk, ds),
          "near-ties: tc bytes differ from simt on moved centers")
    check(torch.equal(ik[:64], own) and (dk[:64] == 0).all().item(),
          "near-ties: a row that is a center did not get it at d2 0")
    differ = ik != ir
    r64 = rows[differ].double()
    gap = ((r64 - pairs[ik[differ].long()].double()) ** 2).sum(1) \
        - ((r64 - pairs[ir[differ].long()].double()) ** 2).sum(1)
    check((gap.abs() <= 2.0 ** -20 * (r64 * r64).sum(1)).all().item(),
          "near-ties: tc and plain differ on a row that is no float32 tie")
    return dict(rows=rows.shape[0], centers=pairs.shape[0],
                plain_differs=int(differ.sum().item()))


def phase_kernels(main: dict) -> list[dict]:
    s = main["shapes"]
    eps, cap, E, d = s["eps"], s["cap"], s["E"], DIM
    eps2 = ops.eps2_f32(eps)
    out = []

    # verify, batched: (E, cap, d) x (E, cap, d), both routes
    u = bucket_lanes(s["index"], E)
    v = torch.roll(u, shifts=1, dims=0)   # lane e: bucket e vs bucket e-1
    v[: E // 2] = u[: E // 2]             # half the lanes intra-bucket
    plan = verify.launch_plan(cap, cap, d)
    check(plan.route == "tc", f"main verify shape routed to {plan}")
    d2k, mk = ops.verify_pairs_batch(u, v, eps)
    d2r, mr = ref.pairwise_l2_threshold(u, v, eps2)
    torch.cuda.synchronize()
    err, n_dis = check_d2(d2k, d2r, mk, mr, eps)
    n_pairs = int(mk.sum().item())
    simt = verify.LaunchPlan("simt")
    d2s, ms_ = verify.pairwise_l2_threshold_batched(u, v, eps2, simt)
    ms_ = ms_.view(torch.bool)
    torch.cuda.synchronize()
    err_simt, n_dis_simt = check_d2(d2s, d2r, ms_, mr, eps)
    f64 = f64_agreement(u, v, eps, {"tc": (d2k, mk), "simt": (d2s, ms_),
                                    "plain": (d2r, mr)})
    del d2k, mk, d2s, ms_, d2r, mr
    ms = graph_ms(lambda: ops.verify_pairs_batch(u, v, eps))
    simt_ms = graph_ms(lambda: verify.pairwise_l2_threshold_batched(
        u, v, eps2, simt))
    eager = cuda_ms(lambda: ops.verify_pairs_batch(u, v, eps))
    plain = graph_ms(lambda: ref.pairwise_l2_threshold(u, v, eps2), reps=5)
    lib = graph_ms(lambda: torch.cdist(u, v), reps=5)
    bms, by = verify_bound(E, cap, cap, d)
    log(f"[kernel] verify_pairs_batch ({E}, {cap}, {cap}, {d}): route "
        f"{plan.route} (block {plan.block_m}); max abs err {err!r}, mask "
        f"disagreements {n_dis} (all within {MASK_BAND} of eps^2), pairs in "
        f"mask {n_pairs}; simt route max abs err {err_simt!r}, mask "
        f"disagreements {n_dis_simt}; device ms tc {ms:.4f}, simt "
        f"{simt_ms:.4f} (tc {simt_ms / ms:.2f}x faster); eager tc "
        f"{eager:.4f}")
    log(f"[kernel] verify_pairs_batch vs float64 on the same lanes "
        f"({f64['true_pairs']} true pairs): " + "; ".join(
            f"{k} mean d2 error near eps^2 {f64[k]['bias_near_eps']:+.3e}, "
            f"missed {f64[k]['missed']}, extra {f64[k]['extra']}"
            for k in ("tc", "simt", "plain")))
    out.append(dict(
        name="pairwise_l2_threshold_batched", route="cuda",
        source=VERIFY_SOURCES["tc"],
        replaces="src/repro/kernels/pairwise_l2.py:86",
        launches=main["launches"]["verify_pairs_batch"], max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        kernel_route=plan.route, simt_ms=simt_ms, simt_max_abs_err=err_simt,
        simt_source=VERIFY_SOURCES["simt"], eager_ms=eager, f64=f64,
        shape=[E, cap, cap, d], ok=True))

    # verify, unbatched (E = 1): the device query path's (q_rows, cap) tile
    qr = s["q_rows"]
    q = torch.from_numpy(s["Q"][:qr]).cuda()
    slab = u[0]
    plan1 = verify.launch_plan(qr, cap, d)
    check(plan1.route == "tc", f"query tile routed to {plan1}")
    d2k, mk = ops.pairwise_l2_threshold(q, slab, eps)
    d2r, mr = ref.pairwise_l2_threshold(q, slab, eps2)
    torch.cuda.synchronize()
    err1, n_dis1 = check_d2(d2k, d2r, mk, mr, eps)
    ms = graph_ms(lambda: ops.pairwise_l2_threshold(q, slab, eps))
    eager = cuda_ms(lambda: ops.pairwise_l2_threshold(q, slab, eps),
                    reps=100)
    plain = graph_ms(lambda: ref.pairwise_l2_threshold(q, slab, eps2))
    lib = graph_ms(lambda: torch.cdist(q, slab))
    bms, by = verify_bound(1, qr, cap, d)
    # lane independence: the E = 1 launch gives the batched launch's bytes,
    # and the query tile's bytes do not depend on the tile shape
    d2a, _ = ops.verify_pairs_batch(u[:2], v[:2], eps)
    d2b, _ = ops.pairwise_l2_threshold(u[1], v[1], eps)
    check(torch.equal(d2a[1], d2b), "E=1 launch differs from its lane")
    d2t, _ = verify.pairwise_l2_threshold_batched(
        q[None], slab[None], eps2, verify.LaunchPlan("tc", 128))
    check(torch.equal(d2t[0], d2k), "query tile bytes depend on the tile")
    log(f"[kernel] pairwise_l2_threshold ({qr}, {cap}, {d}): route "
        f"{plan1.route} (block {plan1.block_m}); max abs err {err1!r}, mask "
        f"disagreements {n_dis1}; E=1 launch bytes == batched lane bytes; "
        f"64- and 128-row tiles give the same bytes; device ms {ms:.4f}, "
        f"eager {eager:.4f}")
    out.append(dict(
        name="pairwise_l2_threshold", route="cuda",
        source=VERIFY_SOURCES["tc"],
        replaces="src/repro/kernels/pairwise_l2.py:128",
        launches=main["launches"]["pairwise_l2_threshold"],
        max_abs_err=err1, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib, kernel_route=plan1.route, eager_ms=eager,
        shape=[qr, cap, d], ok=True))
    del u, v, d2a, d2b, d2t

    # assign: one scan-2 block against the sampled centers, then against
    # the reference's center-index crossover count, on both routes
    xb = torch.from_numpy(s["x"][: s["block_rows"]]).cuda()
    c = torch.from_numpy(s["centers"]).cuda()
    m, b = xb.shape[0], c.shape[0]
    row = assign_row(xb, c)
    c_big = torch.from_numpy(sample_centers(
        s["store"], CROSSOVER_CENTERS, 1, s["block_rows"])).cuda()
    big = assign_row(xb, c_big)
    del c_big
    ties = assign_near_ties(xb, c)
    log(f"[kernel] bucket_assign near-ties ({m} rows incl. 64 centers): "
        f"duplicated centers {b} x 2: argmin equal to plain, lowest index "
        f"wins; centers moved by 3 ulps: tc bytes == simt bytes, rows that "
        f"are centers get their own index at d2 0, plain's argmin differs "
        f"on {ties['plain_differs']} rows, each a tie within float32 "
        f"rounding (exact d2 gap <= 2^-20 |x|^2)")
    out.append(dict(
        name="bucket_assign", route="cuda", source=ASSIGN_SOURCES["tc"],
        replaces="src/repro/kernels/bucket_assign.py:49",
        launches=main["launches"]["bucket_assign"], **row,
        kernel_route="tc", simt_source=ASSIGN_SOURCES["simt"],
        crossover={k: big[k] for k in (
            "shape", "max_abs_err", "ms", "simt_ms", "plain_ms", "bound_ms",
            "bound_by", "f32_bound_ms", "center_index_ms", "splits",
            "simt_bytes_differ", "simt_max_abs_err")},
        near_ties=ties, ok=True))
    for k in out:
        log(f"[kernel] {k['name']}: kernel {k['ms']:.4f} ms (eager "
            f"{k['eager_ms']:.4f}), plain "
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


def profile_queries(index, Q: np.ndarray) -> None:
    """Where a point query's time goes, one query at a time (the query
    service's pattern): probes a query and ms a query in device and host
    mode; then, for the device mode, the host's own time by function
    (cProfile) and the kernel launches and device time a probed bucket
    (torch.profiler). Only with ``--profile``."""
    import cProfile
    import pstats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = N_PROFILE_QUERIES
    probes = [len(p) for p in index.plan_probes(Q[:n])]
    ms = {}
    for mode in ("device", "host"):
        index.drop_warm_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in Q[:n]:
            index.query_batch(q[None], compute_mode=mode)
        torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t0) / n * 1e3
    log(f"[profile] point queries one at a time ({n}): {np.mean(probes):.2f} "
        f"probed buckets a query (p50 {np.percentile(probes, 50):.0f}, p95 "
        f"{np.percentile(probes, 95):.0f}); device mode {ms['device']:.2f} "
        f"ms a query, host mode {ms['host']:.2f} ms")
    index.drop_warm_cache()
    prof = cProfile.Profile()
    prof.enable()
    for q in Q[n:2 * n]:
        index.query_batch(q[None], compute_mode="device")
    prof.disable()
    st = pstats.Stats(prof)
    total = sum(v[2] for v in st.stats.values())
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:10]
    log(f"[profile] host time by function, device mode ({n} queries, "
        f"{total:.3f} s under cProfile):")
    for (path, line, fn), (_, calls, tot, cum, _) in top:
        log(f"[profile] {tot:8.3f} s own {cum:8.3f} s cum {calls:7d} x  "
            f"{os.path.basename(path)}:{line}({fn})")
    index.drop_warm_cache()
    buckets = sum(len(p) for p in index.plan_probes(Q[2 * n:3 * n]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        for q in Q[2 * n:3 * n]:
            index.query_batch(q[None], compute_mode="device")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = tprof.key_averages()
    launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    busy = sum(e.self_device_time_total for e in ev
               if e.device_type == DeviceType.CUDA) / 1e6
    log(f"[profile] device mode, {n} queries, {buckets} probed buckets: "
        f"{launches / buckets:.1f} kernel launches and "
        f"{busy / buckets * 1e3:.4f} ms of device time a bucket; busy "
        f"share {busy / wall:.3f} of {wall:.3f} s (traced)")


# ---------------------------------------------------------------------------
# phase 4: the I/O pipeline, the planner, the cross-join (1M index)
# ---------------------------------------------------------------------------
def verify_launches_all_tc(launches: dict, what: str) -> int:
    n = launches["verify_pairs_batch"] + launches["pairwise_l2_threshold"]
    check(n > 0, f"{what}: no verify launch")
    check(launches["verify_simt"] == 0 and launches["verify_tc"] == n,
          f"{what}: a verify launch left the tensor-core route: {launches}")
    return n


def assign_launches_all_tc(launches: dict, what: str) -> None:
    check(launches["assign_simt"] == 0
          and launches["assign_tc"] == launches["bucket_assign"] > 0,
          f"{what}: an assign launch left the tensor cores: {launches}")


def check_identical(a, b, what: str) -> None:
    check(np.array_equal(a.pairs, b.pairs), f"{what}: pairs differ")
    check(np.array_equal(a.distances, b.distances),
          f"{what}: distances differ")


def pipeline_line(r) -> dict:
    p = r.io_stats["pipeline"]
    out = {k: round(r.timings[k], 4) for k in ("execute", "io_wait",
                                                "compute")}
    out.update({k: p[k] for k in (
        "loads", "stalls", "flush_on_stall", "blocked_acquires",
        "max_queue_depth", "max_slabs_in_use", "pool_slabs",
        "batched_submissions", "coalesced_reads", "coalesced_buckets",
        "device_compact_overflows")})
    out["read_s"] = round(p["read_s"], 4)
    out["overlap_efficiency"] = round(p["overlap_efficiency"], 4)
    return out


class _Slabs:
    """A verify engine's cache surface over fixed host slabs."""

    def __init__(self, slabs: np.ndarray):
        self.slabs = slabs
        self.ids = np.arange(slabs.shape[1], dtype=np.int64)

    def checkout(self, b: int):
        return (self.slabs[b], self.ids, self.slabs.shape[1], None)

    def release(self, entry) -> None:
        pass


def engine_flush_s(kind: str, slabs: np.ndarray, eps: float, edges: int,
                   reps: int = 5) -> float:
    """Median wall time of one flush of ``edges`` edges (lane e: slab e vs
    slab e + 1) through a real verify engine, results fetched to the host.
    The device engine's operands are resident from a warm pass, so a flush
    pays verify, compaction and the compacted readback, not slab copies."""
    cache = _Slabs(slabs)
    cap, dim = slabs.shape[1], slabs.shape[2]
    kw = dict(epsilon=eps, capacity_rows=cap, dim=dim, verify_batch=edges,
              device=torch.device("cuda"))
    eng = (HostVerifyEngine(cache, **kw) if kind == "host"
           else DeviceVerifyEngine(cache, **kw))
    times = []
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(edges):
            eng.enqueue(e, e + 1, False)
        eng.finish()
        torch.cuda.synchronize()
        if rep:  # the first pass warms the kernels and the slab pool
            times.append(time.perf_counter() - t0)
        eng.pairs_out.clear()
        eng.dists_out.clear()
    eng.abort()
    return float(np.median(times))


def copy_gb_s(nbytes: int, direction: str, pinned: bool) -> float:
    """Host↔device copy rate of one ``nbytes`` copy (median of 5)."""
    n = nbytes // 4
    host = torch.empty(n, dtype=torch.float32, pin_memory=pinned)
    host.numpy()[:] = 1.0
    dev = torch.empty(n, dtype=torch.float32, device="cuda")
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if direction == "h2d":
            dev.copy_(host, non_blocking=pinned)
            torch.cuda.synchronize()
        else:
            if pinned:
                host.copy_(dev, non_blocking=True)
                torch.cuda.synchronize()
            else:
                dev.cpu()   # the host engine's fetch: a fresh pageable copy
        times.append(time.perf_counter() - t0)
    return nbytes / float(np.median(times[1:])) / 1e9


def calibrate_cost_model(index, eps: float, E: int) -> dict:
    """The planner's CUDA coefficients on this card (``CostModel``'s
    static tier): copy rates at a slab-sized and a batch-sized copy, each
    engine's flush at the verify shape (E, cap, cap, d), and each engine's
    fixed cost (a flush of one 64-row lane). The per-cell costs are what
    is left of the measured flush once the model's link and dispatch terms
    are taken out, so ``CostModel`` reproduces the measured flush."""
    cap, d = index.bucket_capacity, index.dim
    slab_bytes = cap * d * 4
    batch_bytes = E * slab_bytes
    fetch_bytes = E * cap * cap * 5   # the host engine's d² + mask fetch
    rates = {
        "h2d_pinned_slab": copy_gb_s(slab_bytes, "h2d", True),
        "h2d_pinned_batch": copy_gb_s(batch_bytes, "h2d", True),
        "d2h_pinned_slab": copy_gb_s(slab_bytes, "d2h", True),
        "d2h_pageable_fetch": copy_gb_s(fetch_bytes, "d2h", False),
    }
    lanes = bucket_lanes(index, E + 1).cpu().numpy()
    t_host = engine_flush_s("host", lanes, eps, E)
    t_dev = engine_flush_s("device", lanes, eps, E)
    small = np.ascontiguousarray(lanes[:2, :64])
    t_host_fixed = engine_flush_s("host", small, eps, 1, reps=20)
    t_dev_fixed = engine_flush_s("device", small, eps, 1, reps=20)
    cells = E * cap * cap
    h2d, d2h = rates["h2d_pinned_batch"], rates["d2h_pageable_fetch"]
    # the device engine's readback: compacted triples of its pair_cap
    dev_fetch = E * (8 * cap * 12 + 4)
    link_host = (E * 2 * slab_bytes / h2d + fetch_bytes / d2h) / 1e9
    link_dev = dev_fetch / d2h / 1e9
    coef = dict(
        h2d_gb_s=h2d, d2h_gb_s=d2h,
        host_cell_ns=(t_host - link_host - t_host_fixed) / cells * 1e9,
        device_cell_ns=(t_dev - link_dev - t_dev_fixed) / cells * 1e9,
        host_dispatch_s=t_host_fixed, device_dispatch_s=t_dev_fixed)
    check(coef["host_cell_ns"] > 0 and coef["device_cell_ns"] > 0,
          f"cost model: a per-cell cost came out <= 0: {coef}")
    log(f"[io] cost model, measured on this card: copy rates GB/s "
        f"{json.dumps({k: round(v, 3) for k, v in rates.items()})}; flush "
        f"at ({E}, {cap}, {cap}, {d}): host {t_host * 1e3:.3f} ms, device "
        f"{t_dev * 1e3:.3f} ms; one 64-row lane: host "
        f"{t_host_fixed * 1e3:.4f} ms, device {t_dev_fixed * 1e3:.4f} ms")
    log("[io] cost model coefficients measured "
        + json.dumps({k: float(f"{v:.6g}") for k, v in coef.items()})
        + "; in code " + json.dumps(cost_model._CUDA_STATIC))
    return dict(rates=rates, coef=coef, flush_host_s=t_host,
                flush_device_s=t_dev)


def cross_recall(x: np.ndarray, y: np.ndarray, eps: float,
                 pairs: np.ndarray, rows: np.ndarray) -> tuple[float, int]:
    """Recall of a cross-join's pairs (x id, len(x) + y id) on every true
    ε-pair of the sampled ``rows`` of y; the truth is float64 on the card."""
    xd = torch.from_numpy(x).cuda().double()
    sq = (xd * xd).sum(1)
    eps2 = float(eps) * float(eps)
    n_x = x.shape[0]
    truth = []
    for i0 in range(0, rows.size, 250):
        r = torch.from_numpy(rows[i0:i0 + 250]).cuda()
        q = torch.from_numpy(y[rows[i0:i0 + 250]]).cuda().double()
        d2 = (q * q).sum(1)[:, None] - 2.0 * (q @ xd.T) + sq[None, :]
        qi, j = torch.nonzero(d2 <= eps2, as_tuple=True)
        truth.append(j * (n_x + y.shape[0]) + n_x + r[qi])
    truth = torch.unique(torch.cat(truth))
    got = torch.from_numpy(pairs[:, 0] * (n_x + y.shape[0])
                           + pairs[:, 1]).cuda()
    return (torch.isin(truth, got).double().mean().item(),
            int(truth.numel()))


def ivf_assign_timing(store) -> dict:
    """Scan 2 above the reference's crossover: the IVF center index's
    assign of one scan block (8,192 rows) against 65,537 centers sampled
    from the smoke data, on the card and on the CPU; the two must agree
    except on float32 ties (two centers whose float64 d² lie within
    2^-20 |x|² of each other)."""
    centers = sample_centers(store, CROSSOVER_CENTERS + 1, 5, 8192)
    x = np.ascontiguousarray(store.read_rows(np.arange(8192)),
                             dtype=np.float32)
    t0 = time.perf_counter()
    on_card = center_index.make_center_index(centers, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(isinstance(on_card, center_index.IVFCenterIndex),
          "65,537 centers did not select the IVF index")
    t0 = time.perf_counter()
    d_card, i_card = on_card.assign(x)
    t_assign = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = center_index.make_center_index(centers, device="cpu")
    d_cpu, i_cpu = on_cpu.assign(x)
    t_cpu = time.perf_counter() - t0
    same = i_card == i_cpu
    over = (np.abs(d_card[same] - d_cpu[same])
            - (D2_ATOL + D2_RTOL * np.abs(d_cpu[same])))
    check((over <= 0).all(), "IVF assign d2 on the card outside tolerance")
    x64, c64 = x[~same].astype(np.float64), centers.astype(np.float64)
    gap = (((x64 - c64[i_card[~same]]) ** 2).sum(1)
           - ((x64 - c64[i_cpu[~same]]) ** 2).sum(1))
    check((np.abs(gap) <= 2.0 ** -20 * (x64 * x64).sum(1)).all(),
          f"IVF assign: {int((~same).sum())} rows differ from the CPU's "
          f"off float32 ties")
    log(f"[io] IVF assign above the crossover (8192 rows x "
        f"{centers.shape[0]} centers, nprobe {on_card.nprobe}, "
        f"{on_card.ncoarse} cells): card build {t_build:.3f} s, assign "
        f"{t_assign:.3f} s ({t_assign / 8192 * 1e6:.1f} us a row, one "
        f".cpu() a row); CPU build + assign {t_cpu:.3f} s; ids equal on "
        f"{int(same.sum())} rows, {int((~same).sum())} float32 ties")
    return dict(build_s=t_build, assign_s=t_assign, cpu_s=t_cpu,
                tie_rows=int((~same).sum()))


AUTO = dict(io_mode="prefetch", plan_mode="on", compute_mode="auto")


def planned_join(index, ref, tag: str) -> dict:
    """The join with the planner (prefetch, ``compute_mode="auto"``):
    byte-identical to ``ref``, every verify launch on the tensor-core
    route, no compaction overflow; logs the plan. Returns its launches."""
    cost = index._planner_for(index._resolve(dict(AUTO))).cost
    log(f"[{tag}] cost model: {cost.describe()}")
    ops.reset_launches()
    t0 = time.perf_counter()
    planned = index.self_join(**AUTO)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches_snapshot()
    verify_launches_all_tc(launches, "planned join")
    check_identical(ref, planned, "planned auto vs sync join")
    plan = planned.plan
    routes = {r: sum(1 for rt, _ in plan.unit_params if rt == r)
              for r in ("host", "device")}
    batches = sorted({b for _, b in plan.unit_params})
    overflows = planned.io_stats["pipeline"]["device_compact_overflows"]
    log(f"[{tag}] planned join (prefetch, plan on, compute auto) "
        f"{wall:.3f} s: byte-identical to the sync join; plan "
        f"{plan.compute_mode}, units {plan.num_units} (host "
        f"{routes['host']}, device {routes['device']}), pair_cap "
        f"{plan.pair_cap}, verify batches {batches[0]}..{batches[-1]} "
        f"({len(batches)} distinct), est pairs {plan.est_total:.4g} [hi "
        f"{plan.hi_total:.4g}], device compaction overflows {overflows}; "
        f"verify launches {launches['verify_pairs_batch']}, all tc")
    log(f"[{tag}] planned  " + json.dumps(pipeline_line(planned)))
    log(f"[{tag}] " + plan.explain().replace("\n", f"\n[{tag}] "))
    check(overflows == 0, f"the planned join overflowed its pair_cap "
          f"{overflows} times")
    return launches


def phase_io(main: dict, workdir: str) -> dict:
    """Prefetch I/O and the planner on the 1M index that the main path
    built (graph and node order cached), the prefetched and planned query
    waves, a cross-join against a striped near-duplicate corpus, the cost
    model's coefficients, and the IVF assign's time. Each driven path has
    its launch counts zeroed just before and read just after."""
    s = main["shapes"]
    index, x, eps, Q = s["index"], s["x"], s["eps"], s["Q"]
    res = main["res"]
    out = {}
    t = {}

    # 1. prefetch join: byte-identical to the main path's sync join
    ops.reset_launches()
    t0 = time.perf_counter()
    pre = index.self_join(io_mode="prefetch", io_batch_reads=True)
    torch.cuda.synchronize()
    t["prefetch_join"] = time.perf_counter() - t0
    launches_pre = ops.launches_snapshot()
    verify_launches_all_tc(launches_pre, "prefetch join")
    check_identical(res, pre, "prefetch vs sync join")
    out["sync"], out["prefetch"] = pipeline_line(res), pipeline_line(pre)
    log(f"[io] prefetch join (1M, device mode, io_batch_reads): "
        f"byte-identical to the sync join; verify launches "
        f"{launches_pre['verify_pairs_batch']}, all tc")
    log("[io] sync     " + json.dumps(out["sync"]))
    log("[io] prefetch " + json.dumps(out["prefetch"]))

    # 2. planned join, compute_mode="auto": byte-identical as well
    t0 = time.perf_counter()
    launches_plan = planned_join(index, res, "io")
    t["planned_join"] = time.perf_counter() - t0

    # 3. prefetched, planned query waves: the sync waves' memberships
    ops.reset_launches()
    qt = {}
    q_out = {}
    for mode in ("host", "device"):
        index.drop_warm_cache()
        t0 = time.perf_counter()
        q_out[mode] = index.query_batch(Q, io_mode="prefetch",
                                        plan_mode="on", compute_mode=mode)
        torch.cuda.synchronize()
        qt[mode] = time.perf_counter() - t0
    launches_q = dict(ops.LAUNCHES)
    verify_launches_all_tc(launches_q, "prefetched query waves")
    for mode, sync in (("host", main["q_host"]), ("device", main["q_dev"])):
        agree = check_query_agreement(x, Q, main["src"], eps, sync,
                                      q_out[mode])
        log(f"[io] query_batch {len(Q)} (prefetch, plan on, {mode}): "
            f"{qt[mode]:.3f} s; {agree['members']} members, "
            f"{agree['boundary']} differences from the sync {mode} wave, "
            f"all on the eps boundary")
    check_query_agreement(x, Q, main["src"], eps, q_out["host"],
                          q_out["device"])
    out["query_s"] = qt

    # 4. cross-join against a striped near-duplicate corpus
    n_y = N_CROSS
    rng = np.random.default_rng(17)
    y = (x[rng.choice(x.shape[0], size=n_y, replace=False)]
         + rng.normal(scale=1e-3, size=(n_y, DIM))).astype(np.float32)
    ystore = FlatVectorStore.from_array(os.path.join(workdir, "y.bin"), y)
    ycfg = dataclasses.replace(main["cfg"], num_buckets=n_y // 1000,
                               io_devices=4, io_coalesce=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    other = DiskJoinIndex.build(ystore, ycfg, os.path.join(workdir, "yidx"),
                                layout="spatial")
    t["cross_build"] = time.perf_counter() - t0
    check(other.store.num_devices == 4, "the second side is not striped")
    t0 = time.perf_counter()
    c_sync = index.cross_join(other)
    torch.cuda.synchronize()
    t["cross_sync"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_pre = index.cross_join(other, io_mode="prefetch", io_batch_reads=True)
    torch.cuda.synchronize()
    t["cross_prefetch"] = time.perf_counter() - t0
    launches_x = dict(ops.LAUNCHES)
    verify_launches_all_tc(launches_x, "cross-join")
    assign_launches_all_tc(launches_x, "the striped build")
    check_identical(c_sync, c_pre, "cross-join sync vs prefetch")
    n_x = x.shape[0]
    p = c_sync.pairs
    check(p.shape[0] > 0 and (p[:, 0] < n_x).all()
          and (p[:, 1] >= n_x).all() and (p[:, 1] < n_x + n_y).all(),
          "cross-join pair ids")
    d64 = np.sqrt(((x[p[:5000, 0]].astype(np.float64)
                    - y[p[:5000, 1] - n_x]) ** 2).sum(1))
    check(np.abs(c_sync.distances[:5000] - d64).max() <= 1e-3,
          "cross-join distances vs float64")
    rows = np.random.default_rng(4).choice(n_y, size=N_RECALL_ROWS,
                                           replace=False)
    rec, n_truth = cross_recall(x, y, eps, p, rows)
    pipe = c_pre.io_stats["pipeline"]
    out["cross"] = dict(pairs=int(p.shape[0]), recall=rec,
                        sync=pipeline_line(c_sync),
                        prefetch=pipeline_line(c_pre),
                        device_loads=pipe["device_loads"])
    log(f"[io] cross-join {n_x} x {n_y} (striped side: 4 devices, coalesced, "
        f"spatial layout; built in {t['cross_build']:.3f} s): "
        f"{p.shape[0]} pairs, sync and prefetch byte-identical; recall "
        f"{rec!r} on {n_truth} true pairs of {N_RECALL_ROWS} rows of the "
        f"second side (need >= 0.88); verify launches "
        f"{launches_x['verify_pairs_batch']}, all tc")
    log(f"[io] cross-join prefetch: per-device loads {pipe['device_loads']} "
        f"(device 0: the 1M side), coalesced reads {pipe['coalesced_reads']}"
        f" of {pipe['coalesced_buckets']} buckets, batched submissions "
        f"{pipe['batched_submissions']}")
    log("[io] cross sync     " + json.dumps(out["cross"]["sync"]))
    log("[io] cross prefetch " + json.dumps(out["cross"]["prefetch"]))
    check(rec >= 0.88, f"cross-join recall {rec} < 0.88")
    other.close()

    # 5. the planner's CUDA coefficients, and the IVF assign's time
    t0 = time.perf_counter()
    out["cost_model"] = calibrate_cost_model(index, eps, s["E"])
    t["calibrate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ivf"] = ivf_assign_timing(s["store"])
    t["ivf"] = time.perf_counter() - t0
    log(f"[io] phase seconds {json.dumps({k: round(v, 3) for k, v in t.items()})}")
    out["launches"] = dict(prefetch=launches_pre, planned=launches_plan,
                           queries=launches_q, cross=launches_x)
    return out


# ---------------------------------------------------------------------------
# phase 5: serving over the 1M index (scheduler, service, live, replicas)
# ---------------------------------------------------------------------------
def fig22_requests(x: np.ndarray, n: int, rng) -> np.ndarray:
    """fig22's request stream (``benchmarks/fig22_scheduler.py:47-57``):
    70% of queries near one of 16 hot anchors, 30% roaming, plus
    N(0, 0.01) noise."""
    anchors = x[rng.choice(x.shape[0], N_HOT_ANCHORS, replace=False)]
    hot = anchors[rng.integers(0, N_HOT_ANCHORS, n)]
    roam = x[rng.choice(x.shape[0], n)]
    pick = rng.random(n) < 0.7
    q = np.where(pick[:, None], hot, roam)
    return (q + rng.normal(scale=0.01, size=q.shape)).astype(np.float32)


def serve_burst(index, reqs: np.ndarray, share: bool,
                deadline_s: float | None) -> dict:
    """All of ``reqs`` submitted at t = 0 from ``SERVE_SUBMITTERS``
    threads to a fresh scheduler (fig22's wave settings), traced; returns
    the answers (None for a request its deadline dropped, which is
    counted, not an error), latencies, reads and waves."""
    index.drop_warm_cache()
    base = index.pipeline_snapshot()
    answers = [None] * len(reqs)
    lat = np.zeros(len(reqs))
    go = threading.Barrier(SERVE_SUBMITTERS + 1)
    with trace_session(ring_capacity=1 << 20) as tr:
        sched = QueryScheduler(index, wave_size=32, max_wait_s=0.005,
                               max_queue=len(reqs), share_probes=share)

        def submitter(k):
            go.wait()
            futs = [(i, sched.submit(reqs[i], deadline_s=deadline_s))
                    for i in range(k, len(reqs), SERVE_SUBMITTERS)]
            for i, f in futs:
                try:
                    answers[i] = f.result(timeout=120)
                except DeadlineExceeded:
                    pass
                lat[i] = f.latency_s

        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(SERVE_SUBMITTERS)]
        for th in threads:
            th.start()
        go.wait()
        t0 = time.perf_counter()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        sched.close()
        snap = sched.snapshot()
    pipe = index.pipeline_snapshot()
    reads = sum(pipe[k] - base[k] for k in ("query_reads",
                                            "query_fallback_reads"))
    spans = sum(1 for e in tr.events() if e.get("name") == "serve.wave")
    dropped = sum(a is None for a in answers)
    check(dropped == snap["deadline_drops"], f"{dropped} requests without "
          f"an answer, {snap['deadline_drops']} deadline drops")
    answered = len(reqs) - dropped
    check(answered > 0, "the burst answered no request")
    return dict(answers=answers, wall_s=wall, waves=snap["waves"],
                wave_spans=spans, reads=reads, answered=answered,
                reads_per_query=reads / len(reqs),
                reads_per_answer=reads / answered,
                saved=pipe["reads_saved_by_sharing"]
                - base["reads_saved_by_sharing"],
                drops=snap["deadline_drops"],
                p50_ms=float(np.percentile(lat, 50)) * 1e3,
                p95_ms=float(np.percentile(lat, 95)) * 1e3)


def pc1_split(x: np.ndarray, parts: int) -> list[np.ndarray]:
    """Row ids of ``parts`` equal spatial slabs: sorted along the data's
    first principal axis (float64 covariance on the card) and cut."""
    xd = torch.from_numpy(x).cuda().double()
    xc = xd - xd.mean(0)
    _, vecs = torch.linalg.eigh(xc.T @ xc)
    key = (xc @ vecs[:, -1]).cpu().numpy()
    order = np.argsort(key, kind="stable")
    return np.array_split(order, parts)


def brute_force_members(x: np.ndarray, Q: np.ndarray, eps: float) -> list:
    """Every row within ε of each query (float64 on the card)."""
    xd = torch.from_numpy(x).cuda().double()
    sq = (xd * xd).sum(1)
    eps2 = float(eps) * float(eps)
    out = []
    for i0 in range(0, Q.shape[0], 250):
        q = torch.from_numpy(Q[i0:i0 + 250]).cuda().double()
        d2 = (q * q).sum(1)[:, None] - 2.0 * (q @ xd.T) + sq[None, :]
        qi, j = torch.nonzero(d2 <= eps2, as_tuple=True)
        qi, j = qi.cpu().numpy(), j.cpu().numpy()
        for k in range(q.shape[0]):
            out.append(set(j[qi == k].tolist()))
    return out


def phase_serve(main: dict, workdir: str) -> dict:
    """The serving layer over the 1M index the main path built: the query
    service (its repeat under live observability), the wave scheduler
    under fig22's burst, a replicated router with a killed replica and a
    supervised restart, a 4-shard scatter/gather, and a residency snapshot
    with a warm reopen. Launch counts are zeroed just before the phase and
    read just after."""
    s = main["shapes"]
    index, x, eps, Q = s["index"], s["x"], s["eps"], s["Q"]
    out, t = {}, {}
    ops.reset_launches()
    t_phase = time.perf_counter()

    # 1. the query service: one request at a time, then the same again
    # under live observability (a p95 latency objective)
    index.drop_warm_cache()
    svc = VectorQueryService(index)
    t0 = time.perf_counter()
    first = [svc.query(q) for q in Q]
    t["service_first"] = time.perf_counter() - t0
    hits0 = index.pipeline_snapshot()["query_warm_hits"]
    live = index.attach_live(window_s=0.2, windows=3000, slos=(
        Slo.latency("query_p95", "query.execute", threshold_s=0.05,
                    objective=0.9),))
    t0 = time.perf_counter()
    again = [svc.query(q) for q in Q]
    t["service_repeat_live"] = time.perf_counter() - t0
    warm_hits = index.pipeline_snapshot()["query_warm_hits"] - hits0
    svc.close()
    time.sleep(0.25)
    live.poll()
    n_exec = index.metrics_snapshot()["live"]["spans"]["query.execute"][
        "count"]
    board = dash.render(index)
    consts = live.live_constants()
    index.detach_live()
    check(warm_hits > 0, "the repeated service queries never hit warm")
    check(n_exec == len(Q), f"live rollup counted {n_exec} query.execute "
          f"spans for {len(Q)} queries")
    vs_batch = check_query_agreement(x, Q, main["src"], eps, first,
                                     main["q_dev"], "service query")
    vs_again = check_query_agreement(x, Q, None, eps, first, again,
                                     "service repeat")
    out["service"] = dict(first_s=t["service_first"],
                          repeat_s=t["service_repeat_live"],
                          warm_hits=warm_hits, vs_batch=vs_batch,
                          repeat_byte_diff=vs_again["byte_diff"])
    out["live"] = dict(count=n_exec, constants=consts)
    log(f"[serve] VectorQueryService {len(Q)} queries one at a time: "
        f"{t['service_first']:.3f} s, repeated under attach_live "
        f"{t['service_repeat_live']:.3f} s ({warm_hits} warm hits); "
        f"against query_batch: {vs_batch['members']} members, "
        f"{vs_batch['boundary']} differences, all on the eps boundary, "
        f"{vs_batch['byte_diff']} answers differ in their bytes; repeat "
        f"differs in {vs_again['byte_diff']}; live rollup query.execute "
        f"count {n_exec}")
    log("[serve] " + board.replace("\n", "\n[serve] "))
    log("[serve] live cost constants " + json.dumps(consts, default=str))

    # 2. the wave scheduler under fig22's burst, with and without sharing;
    # then both policies on the same requests, all answered
    reqs = fig22_requests(x, N_SERVE_REQUESTS, np.random.default_rng(22))
    t0 = time.perf_counter()
    truth = index.query_batch(reqs)
    t["burst_query_batch"] = time.perf_counter() - t0
    burst = {}
    for n_reqs, deadline in ((N_SERVE_REQUESTS, 30.0), (N_SAME_REQUESTS,
                                                        None)):
        for share in (True, False):
            key = ("shared" if share else "naive") + (
                "" if deadline else "_same")
            b = serve_burst(index, reqs[:n_reqs], share, deadline)
            got = b.pop("answers")
            kept = [i for i, a in enumerate(got) if a is not None]
            b["vs_batch"] = check_query_agreement(
                x, reqs[kept], None, eps, [got[i] for i in kept],
                [truth[i] for i in kept], f"scheduler ({key}) request")
            burst[key] = b
            t[f"burst_{key}"] = b["wall_s"]
            log(f"[serve] scheduler {key} ({n_reqs} requests at t=0 from "
                f"{SERVE_SUBMITTERS} threads, wave 32, max_wait 5 ms, "
                f"deadline {deadline} s): wall {b['wall_s']:.3f} s, waves "
                f"{b['waves']} (serve.wave spans {b['wave_spans']}), p50 "
                f"{b['p50_ms']:.1f} ms, p95 {b['p95_ms']:.1f} ms, reads "
                f"{b['reads']} ({b['reads_per_query']:.3f} a request, "
                f"{b['reads_per_answer']:.3f} an answer), saved by sharing "
                f"{b['saved']}, deadline drops {b['drops']} (answered "
                f"{b['answered']}, {b['answered'] / b['wall_s']:.1f} a "
                f"second); against query_batch: "
                f"{b['vs_batch']['boundary']} boundary differences, "
                f"{b['vs_batch']['byte_diff']} answers differ in their "
                f"bytes")
    # the 30 s deadline drops most of the burst before any read, and the
    # two policies answer different requests: their reads a request are
    # logged, and held against each other on the same requests, all
    # answered
    shared, naive = burst["shared"], burst["naive"]
    log(f"[serve] burst reads a request (deadline 30 s): shared "
        f"{shared['reads_per_query']:.3f}, naive "
        f"{naive['reads_per_query']:.3f} (answered {shared['answered']} "
        f"and {naive['answered']}); the same {N_SAME_REQUESTS} requests, "
        f"no deadline: shared "
        f"{burst['shared_same']['reads_per_query']:.3f}, naive "
        f"{burst['naive_same']['reads_per_query']:.3f}")
    check(shared["saved"] > 0, "probe sharing saved no read")
    check(burst["shared_same"]["answered"] == N_SAME_REQUESTS
          and burst["naive_same"]["answered"] == N_SAME_REQUESTS,
          "a request without a deadline went unanswered")
    check(burst["shared_same"]["reads"] < burst["naive_same"]["reads"],
          "shared waves read no less than the naive policy on the same "
          "requests")
    check(shared["wave_spans"] > 0, "no serve.wave span traced")
    out["burst"] = burst

    # 3. replicas and failover: two sessions of the 1M workdir on the card
    reps = [DiskJoinIndex.open(index.workdir) for _ in range(2)]
    for r in reps:      # first-use costs before any deadline applies
        r.query_batch(Q[:8])
    router = IndexRouter([reps], epsilon=eps, close_shards=True,
                         scheduler=dict(max_wait_s=0.001))
    rset = router.replica_sets[0]
    qs = Q[:N_REPLICA_ANSWERS]
    t0 = time.perf_counter()
    before = [router.query(q, timeout=120) for q in qs]
    dead = rset.replicas[0]
    FaultInjector().kill_replica(dead)
    for r in rset.replicas:     # both in the rotation: the kill is met
        r.service_ewma = 0.001
    after = [router.query(q, timeout=120) for q in qs]
    failovers = rset.snapshot()["counters"]["failovers"]
    state_dead = dead.health.state
    sup = ReplicaSupervisor(router)
    restarted = sup.poll_once()
    restarted_answers = [dead.scheduler.query(q, timeout=120) for q in qs]
    t["replicas"] = time.perf_counter() - t0
    same_after = sum(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                     for a, b in zip(before, after))
    same_restart = sum(np.array_equal(a[0], b[0])
                       and np.array_equal(a[1], b[1])
                       for a, b in zip(before, restarted_answers))
    pool = dead.index._pool
    warm_pins = pool.in_use
    n_warm = len(dead.index.warm_buckets())
    dead.index.drop_warm_cache()
    pins_left = pool.in_use
    device = str(dead.index.device)
    router.close()
    check(same_after == len(qs), f"failover answers: {same_after} of "
          f"{len(qs)} byte-identical")
    check(failovers > 0 and state_dead == DOWN,
          f"the kill: failovers {failovers}, state {state_dead}")
    check(restarted == 1 and dead.health.state == HEALTHY
          and device == str(index.device),
          f"restart: {restarted}, {dead.health.state}, {device}")
    check(same_restart == len(qs), f"restarted answers: {same_restart} of "
          f"{len(qs)} byte-identical")
    check(warm_pins == n_warm and pins_left == 0,
          f"pins after the restart: {warm_pins} for {n_warm} warm, "
          f"{pins_left} left")
    out["replicas"] = dict(failovers=failovers, restarted=restarted,
                           device=device, pins_left=pins_left)
    log(f"[serve] replicas: 2 sessions of the 1M index on {device}; "
        f"{len(qs)} answers; replica 0 killed: the same {same_after} "
        f"answers byte-identical through replica 1, failovers {failovers}, "
        f"replica 0 {state_dead}; supervisor restart on {device}: "
        f"{dead.health.state}, the same {same_restart} answers; pool pins "
        f"{warm_pins} (= {n_warm} warm), 0 after dropping them; "
        f"{t['replicas']:.3f} s")

    # 4. scatter and gather over 4 spatial shards of 250,000 rows
    t0 = time.perf_counter()
    parts = pc1_split(x, N_SHARDS)
    shards = []
    for si, rows in enumerate(parts):
        part = np.ascontiguousarray(x[rows])
        st = FlatVectorStore.from_array(
            os.path.join(workdir, f"shard{si}.bin"), part)
        scfg = dataclasses.replace(main["cfg"],
                                   num_buckets=len(rows) // 1000,
                                   memory_budget_bytes=part.nbytes // 10)
        shards.append(DiskJoinIndex.build(
            st, scfg, os.path.join(workdir, f"shard{si}"), layout="spatial"))
    t["shard_builds"] = time.perf_counter() - t0
    gid = np.concatenate(parts)     # router id -> row of x
    # the 1,000 queries arrive as one batch, so each shard's waves take
    # up to 256 of them and share their probe reads
    router = IndexRouter(shards, epsilon=eps, close_shards=True,
                         scheduler=dict(wave_size=256, max_wait_s=0.005,
                                        max_queue=len(Q)))
    for sh in shards:
        sh.query_batch(Q[:8])
    t0 = time.perf_counter()
    got = router.query_batch(Q, timeout=120)
    t["router_queries"] = time.perf_counter() - t0
    fanout = router.snapshot()["fanout_mean"]
    router.close()
    truth_sets = brute_force_members(x, Q, eps)
    eps2 = float(eps) * float(eps)
    hit = total = outside = 0
    for qi, (ids, dists) in enumerate(got):
        rows = gid[ids]
        d64 = ((x[rows].astype(np.float64) - Q[qi]) ** 2).sum(1)
        outside += int((d64 > eps2 + 1e-4 * max(1.0, eps2)).sum())
        check(np.abs(dists - np.sqrt(d64)).max(initial=0.0) <= 1e-3,
              f"router query {qi} distances vs float64")
        hit += len(set(rows.tolist()) & truth_sets[qi])
        total += len(truth_sets[qi])
    rec = hit / max(total, 1)
    out["router"] = dict(recall=rec, truth=total, outside=outside,
                         fanout=fanout, sizes=[len(p) for p in parts])
    log(f"[serve] router over {N_SHARDS} spatial shards "
        f"{[len(p) for p in parts]} (built in {t['shard_builds']:.3f} s, "
        f"spatial layout; waves of up to 256): {len(Q)} queries in "
        f"{t['router_queries']:.3f} s, "
        f"fan-out {fanout:.3f}; recall {rec!r} on {total} true members "
        f"(need >= 0.88), {outside} returned outside eps beyond the "
        f"boundary band")
    check(rec >= 0.88, f"router recall {rec} < 0.88")
    check(outside == 0, f"{outside} router members outside eps")

    # 5. a residency snapshot, then a warm reopen
    qs = Q[:N_REPLICA_ANSWERS]
    index.drop_warm_cache()
    base = index.pipeline_snapshot()
    cold = index.query_batch(qs)
    after = index.pipeline_snapshot()
    cold_reads = sum(after[k] - base[k] for k in ("query_reads",
                                                  "query_fallback_reads"))
    saved = index.save_residency_snapshot()
    with open(os.path.join(index.workdir, RESIDENCY_NAME)) as f:
        snap_ids = json.load(f)["buckets"]
    t0 = time.perf_counter()
    warm = index.reopen()
    t["reopen"] = time.perf_counter() - t0
    warm_ids = warm.warm_buckets()
    base = warm.pipeline_snapshot()
    warm_answers = warm.query_batch(qs)
    after = warm.pipeline_snapshot()
    same_warm = sum(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                    for a, b in zip(cold, warm_answers))
    warm.close()
    reads = sum(after[k] - base[k] for k in ("query_reads",
                                             "query_fallback_reads"))
    hits = after["query_warm_hits"] - base["query_warm_hits"]
    check(saved == len(snap_ids) > 0, "empty residency snapshot")
    check(sorted(warm_ids) == sorted(snap_ids)
          and base["warm_prefaults"] == len(snap_ids),
          "the reopened session's warm buckets are not the snapshot's")
    # the same wave probes the same buckets: every snapshotted one is a
    # warm hit, and only the rest (past the warm quota) is read
    check(hits == len(snap_ids) and reads == cold_reads - hits,
          f"warm reopen: {hits} warm hits and {reads} reads for "
          f"{len(snap_ids)} snapshotted buckets, {cold_reads} cold reads")
    check(same_warm == len(qs), f"warm answers: {same_warm} of {len(qs)} "
          f"byte-identical to the cold session's")
    out["residency"] = dict(buckets=len(snap_ids), reopen_s=t["reopen"],
                            warm_hits=hits, reads=reads,
                            cold_reads=cold_reads)
    log(f"[serve] residency: {len(snap_ids)} buckets snapshotted (the warm "
        f"quota's worth of {cold_reads} read cold); reopen "
        f"{t['reopen']:.3f} s pre-faulted {base['warm_prefaults']}; the "
        f"first {len(qs)} queries: {hits} warm hits, {reads} reads, "
        f"answers byte-identical to the cold session's")

    launches = ops.launches_snapshot()
    verify_launches_all_tc(launches, "[serve]")
    assign_launches_all_tc(launches, "[serve] shard builds")
    out["launches"] = launches
    t["phase"] = time.perf_counter() - t_phase
    log(f"[serve] launches {launches}")
    log(f"[serve] phase seconds "
        f"{json.dumps({k: round(v, 3) for k, v in t.items()})}")
    return out


def simt_difference(index, tc_res, x: np.ndarray, eps: float,
                    what: str) -> dict:
    """One more device join with every verify launch forced onto the
    CUDA-core route (``pairwise_l2.cu``) by patching ``launch_plan`` in
    this process; the pairs that differ from the tensor-core join's, each
    of which must have a float64 d² within ``MASK_BAND`` of ε²."""
    plan = verify.launch_plan
    verify.launch_plan = lambda m, n, d: verify.LaunchPlan("simt")
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        simt = index.self_join(compute_mode="device")
        torch.cuda.synchronize()
    finally:
        verify.launch_plan = plan
    wall = time.perf_counter() - t0
    launches = ops.launches_snapshot()
    n = launches["verify_pairs_batch"] + launches["pairwise_l2_threshold"]
    check(n > 0 and launches["verify_simt"] == n
          and launches["verify_tc"] == 0,
          f"{what}: the simt join left the CUDA-core route: {launches}")
    key = x.shape[0]
    a = tc_res.pairs[:, 0] * key + tc_res.pairs[:, 1]
    b = simt.pairs[:, 0] * key + simt.pairs[:, 1]
    only_tc = np.setdiff1d(a, b)
    only_simt = np.setdiff1d(b, a)
    diff = np.concatenate([only_tc, only_simt])
    i, j = diff // key, diff % key
    d2 = ((x[i].astype(np.float64) - x[j]) ** 2).sum(1)
    eps2 = float(eps) * float(eps)
    band = np.abs(d2 - eps2).max(initial=0.0)
    check(band <= MASK_BAND, f"{what}: a tc/simt difference lies "
          f"{band} from eps^2 (band {MASK_BAND})")
    out = dict(tc_pairs=int(a.size), simt_pairs=int(b.size),
               only_tc=int(only_tc.size), only_simt=int(only_simt.size),
               max_from_eps2=float(band), simt_s=wall)
    log(f"[{what}] tc vs simt join: tc {a.size} pairs, simt {b.size}; "
        f"|tc - simt| {only_tc.size}, |simt - tc| {only_simt.size}; every "
        f"difference within {band:.3e} of eps^2 (band {MASK_BAND}); simt "
        f"join {wall:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phase 6: byte parity at 100k: host/device x sync/prefetch x striping
# ---------------------------------------------------------------------------
def traced_join(index, untraced, workdir: str) -> dict:
    """The prefetch device join again under ``trace_session``: the
    untraced one's bytes; its spans exported as a Chrome trace, and
    ``hidden_fraction(io.read, io.wait)`` logged beside both times."""
    t0 = time.perf_counter()
    with trace_session(ring_capacity=1 << 20) as tr:
        traced = index.self_join(compute_mode="device", io_mode="prefetch")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_identical(untraced, traced, "traced vs untraced prefetch join")
    path = tr.export(os.path.join(workdir, "prefetch_join.trace.json"))
    hidden = tr.analysis().hidden_fraction("io.read", "io.wait")
    ring = tr.ring_stats()
    check(ring["events"] > 0 and ring["dropped"] == 0,
          f"the traced join's ring: {ring}")
    log(f"[parity] prefetch join traced ({wall:.3f} s; execute "
        f"{traced.timings['execute']:.3f} s against "
        f"{untraced.timings['execute']:.3f} s untraced): byte-identical; "
        f"{ring['events']} trace events, Chrome trace "
        f"{os.path.getsize(path)} bytes, hidden_fraction(io.read, io.wait) "
        f"{hidden!r}")
    return dict(events=ring["events"], hidden=hidden, wall_s=wall,
                execute_s=traced.timings["execute"])


def resumed_build(store, cfg, workdir: str, plain_dir: str, plain):
    """A build killed after its assign scan (the write scan raises, by a
    patch in this process), then resumed: no sample or assign scan and no
    assign launch on the resume; its bucket files and device self_join
    bytes are those of the uninterrupted build at ``plain_dir``."""
    bz = sys.modules["repro_torch.core.bucketize"]
    write = bz.write_buckets

    def killed(*a, **k):
        bz.write_buckets = write
        raise InjectedKill("kill after the assign scan")

    bz.write_buckets = killed
    rdir = os.path.join(workdir, "ridx")
    t0 = time.perf_counter()
    try:
        DiskJoinIndex.build(store, cfg, rdir)
    except InjectedKill:
        t_killed = time.perf_counter() - t0
    else:
        check(False, "the patched write scan did not kill the build")
    finally:
        bz.write_buckets = write
    phases = sorted(os.listdir(os.path.join(rdir, "build_phases")))
    ops.reset_launches()
    t0 = time.perf_counter()
    with DiskJoinIndex.build(store, cfg, rdir) as resumed:
        t_resume = time.perf_counter() - t0
        launches = ops.launches_snapshot()
        bt = resumed.build_timings
        check(bt["sample"] == 0.0 and bt["assign"] == 0.0
              and launches["bucket_assign"] == 0,
              f"the resumed build rescanned: {bt}, {launches}")
        files = sorted(f for f in os.listdir(plain_dir)
                       if f.startswith("buckets")
                       and os.path.isfile(os.path.join(plain_dir, f)))
        for f in files:
            with open(os.path.join(plain_dir, f), "rb") as a, \
                    open(os.path.join(rdir, f), "rb") as b:
                check(a.read() == b.read(), f"resumed build: {f} differs")
        check_identical(plain, resumed.self_join(compute_mode="device"),
                        "resumed build's join vs the uninterrupted build's")
    log(f"[parity] resumable build killed after assign "
        f"({t_killed:.3f} s; committed phases {phases}) and resumed in "
        f"{t_resume:.3f} s: sample and assign 0 s, 0 assign launches; "
        f"{len(files)} bucket files and the device self_join "
        f"byte-identical to the uninterrupted build's")


def phase_parity(workdir: str) -> dict:
    n = N_PARITY
    x = clustered_vectors(n, DIM, seed=2)
    eps = epsilon_for_avg_neighbors(x, 20)
    store = FlatVectorStore.from_array(os.path.join(workdir, "p.bin"), x)
    cfg = JoinConfig(epsilon=eps, num_buckets=n // 1000,
                     memory_budget_bytes=x.nbytes // 10, pad_align=128)
    runs = {}
    with DiskJoinIndex.build(store, cfg,
                             os.path.join(workdir, "pidx")) as index:
        t0 = time.perf_counter()
        host = index.self_join(compute_mode="host")
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = index.self_join(compute_mode="device")
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        runs[("plain", "prefetch", "device")] = index.self_join(
            compute_mode="device", io_mode="prefetch")
        trace = traced_join(index, runs[("plain", "prefetch", "device")],
                            workdir)
        simt = simt_difference(index, dev, x, eps, "parity")
        resumed_build(store, cfg, workdir, index.workdir, dev)
    check_join_output(x, eps, host)
    check(np.array_equal(host.pairs, dev.pairs), "host/device pairs differ")
    check(np.array_equal(host.distances, dev.distances),
          "host/device distances differ")
    check(host.num_distance_computations == dev.num_distance_computations,
          "host/device distance computations differ")
    log(f"[parity] {n} x {DIM}: {host.pairs.shape[0]} pairs, host "
        f"and device byte-identical (pairs and distances); self_join host "
        f"{t_host:.3f} s, device {t_dev:.3f} s")
    t0 = time.perf_counter()
    scfg = dataclasses.replace(cfg, io_devices=4, io_coalesce=True)
    with DiskJoinIndex.build(store, scfg,
                             os.path.join(workdir, "psidx")) as striped:
        t_build = time.perf_counter() - t0
        check(striped.store.num_devices == 4, "parity: not striped")
        # host mode fetches whole d²/mask batches (about a minute a join
        # here): it runs once, device mode in every I/O × striping corner
        for io_mode in ("sync", "prefetch"):
            runs[("striped", io_mode, "device")] = striped.self_join(
                compute_mode="device", io_mode=io_mode)
    for key, r in runs.items():
        check_identical(host, r, f"parity {key} vs plain sync host")
    log(f"[parity] striped build (4 devices, coalesced) {t_build:.3f} s; "
        f"byte-identical to plain sync host (pairs and distances): "
        + ", ".join("/".join(k) for k in runs))
    log("[parity] execute / io_wait / compute s: " + "; ".join(
        "/".join(k) + " " + "/".join(f"{r.timings[t]:.3f}" for t in (
            "execute", "io_wait", "compute"))
        for k, r in [(("plain", "sync", "host"), host),
                     (("plain", "sync", "device"), dev), *runs.items()]))
    return dict(simt=simt, trace=trace)


# ---------------------------------------------------------------------------
# phase 7: LM serving at qwen3-0.6b's full width
# ---------------------------------------------------------------------------
def host_ms(fn, reps: int = 3) -> float:
    """Host clock around ``reps`` calls that end in a synchronise (after one
    warm call): for work of many launches, such as a whole prefill."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def rolling_positions(steps: int, written: int) -> torch.Tensor:
    """kpos of a decode cache after positions 0..written-1 (−1: empty)."""
    pos = torch.arange(steps, dtype=torch.int32)
    return torch.where(pos < written, pos, -1).cuda()


def attn_inputs(cfg, b, sq, t, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, sq, cfg.n_heads, cfg.head_dim, device="cuda",
                    generator=g).to(dtype)
    k, v = (torch.randn(b, t, cfg.n_kv_heads, cfg.head_dim, device="cuda",
                        generator=g).to(dtype) for _ in range(2))
    return q, k, v


def check_attention(q, k, v, kw) -> float:
    """Kernel vs plain version on the same inputs; → max abs error."""
    got = ops.gqa_attention(q, k, v, **kw).float()
    want = ref.gqa_attention(q, k, v, **kw).float()
    torch.cuda.synchronize()
    tol = ATTN_TOL[q.dtype]
    over = (got - want).abs() - tol * (1.0 + want.abs())
    check(torch.isfinite(got).all().item(), "flash output not finite")
    check(over.max().item() <= 0, f"flash {q.dtype} {tuple(q.shape)} x "
          f"{tuple(k.shape)} outside tolerance by {over.max().item()}")
    return (got - want).abs().max().item()


def attention_row(name, cfg, sq, t, kw, launches) -> dict:
    """One shape of the path: checked in bf16 (the path's dtype) and
    float32, each through the route ``launch_plan`` gives it; timed in both
    beside the plain version, SDPA and the bound. ``launches``: the main
    path's count of the bf16 route."""
    errs, routes, ms, plain, lib = {}, {}, {}, {}, {}
    mask = ref.gqa_mask(sq, kw.get("kv_positions",
                                   torch.arange(t, device="cuda")),
                        causal=True, window=0, q_offset=kw.get("q_offset", 0))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attn_inputs(cfg, LM_SLOTS, sq, t, dtype, seed=sq + t)
        routes[dtype] = flash.launch_plan(
            LM_SLOTS, sq, t, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype).route
        errs[dtype] = check_attention(q, k, v, kw)
        ms[dtype] = graph_ms(lambda: ops.gqa_attention(q, k, v, **kw))
        plain[dtype] = graph_ms(lambda: ref.gqa_attention(q, k, v, **kw),
                                reps=5)
        # the library call computes the same function: is_causal (top-left
        # aligned) for S == T from position 0, a boolean key mask for decode
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if sq == t and "kv_positions" not in kw:
            lib_fn = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                                  enable_gqa=True)
        else:
            lib_fn = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                                  enable_gqa=True)
        lib[dtype] = graph_ms(lib_fn)
    want = ref.gqa_attention(q, k, v, **kw).float()
    lib_err = (lib_fn().transpose(1, 2).float() - want).abs().max().item()
    # every product at the bf16 tensor-core rate (Q·Kᵀ and P·V: 2 x matmul
    # FLOPs; the prefill kernel's split of P into two bf16 products is its
    # design's cost, not the work's). Bytes: Q and O, the K/V rows some
    # query sees, and the positions if given.
    visible = int(mask.sum().item())        # (query, key) pairs computed
    keys = int(mask.any(0).sum().item())    # cache rows that must be read
    matmul = 2.0 * LM_SLOTS * cfg.n_heads * cfg.head_dim * visible
    pos = kw.get("kv_positions")
    elems = (2 * q.numel()
             + 2 * LM_SLOTS * keys * cfg.n_kv_heads * cfg.head_dim)
    pos_bytes = 0 if pos is None else pos.numel() * pos.element_size()
    bms, by = bound(0.0, 2 * elems + pos_bytes, flops_bf16=2.0 * matmul)
    # float32 runs on the CUDA cores: every product at their rate
    bms32, by32 = bound(2.0 * matmul, 4 * elems + pos_bytes)
    route = routes[torch.bfloat16]
    log(f"[lm] flash {name} {tuple(q.shape)} x {tuple(k.shape)}: routes "
        f"bf16 {route}, f32 {routes[torch.float32]}; max abs err bf16 "
        f"{errs[torch.bfloat16]!r}, f32 {errs[torch.float32]!r}; kernel "
        f"{ms[torch.bfloat16]:.4f} ms (f32 {ms[torch.float32]:.4f} ms), "
        f"plain {plain[torch.bfloat16]:.4f} ms (f32 "
        f"{plain[torch.float32]:.4f}), sdpa {lib[torch.bfloat16]:.4f} ms "
        f"(f32 {lib[torch.float32]:.4f}; bf16 sdpa vs plain max abs "
        f"{lib_err:.3g}), bound {bms:.4f} ms ({by}; f32 {bms32:.4f}, "
        f"{by32}), share {bms / ms[torch.bfloat16]:.3f} (f32 "
        f"{bms32 / ms[torch.float32]:.3f})")
    return dict(
        name=f"flash_attention ({name})", route="cuda",
        source=FLASH_SOURCES[route],
        replaces="src/repro/kernels/flash_attention.py:77",
        launches=launches, max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32=errs[torch.float32], ms=ms[torch.bfloat16],
        f32_ms=ms[torch.float32], plain_ms=plain[torch.bfloat16],
        f32_plain_ms=plain[torch.float32], bound_ms=bms, bound_by=by,
        f32_bound_ms=bms32, f32_bound_by=by32,
        library_ms=lib[torch.bfloat16], f32_library_ms=lib[torch.float32],
        library_max_abs_err=lib_err,
        kernel_route=route, f32_route=routes[torch.float32],
        f32_source=FLASH_SOURCES[routes[torch.float32]],
        shape=[LM_SLOTS, sq, t, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
        dtype="bfloat16", ok=True)


def check_decode_vs_forward(cfg) -> float:
    """float32 at full width: decode step by step reproduces the
    teacher-forced forward's logits (tests/test_models.py:107-109)."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    bundle = build_model(cfg32)
    params = bundle.init(1)
    b, s = LM_TF_SHAPE
    g = torch.Generator(device="cuda").manual_seed(5)
    tok = torch.randint(0, cfg.vocab, (b, s), device="cuda", generator=g)
    with torch.inference_mode():
        hidden, _ = transformer.forward(params, tok)
        tf = transformer.lm_logits(params, hidden)
        caches = bundle.init_cache(b, s)
        steps = torch.stack([bundle.decode(params, tok[:, i:i + 1],
                                           caches)[0] for i in range(s)], 1)
    over = (steps - tf).abs() - (2e-3 + 2e-2 * tf.abs())
    check(torch.isfinite(steps).all().item(), "decode logits not finite")
    check(over.max().item() <= 0, f"float32 decode vs forward outside "
          f"rtol 2e-2 / atol 2e-3 by {over.max().item()}")
    return (steps - tf).abs().max().item()


def phase_lm(profile: bool) -> list[dict]:
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    bundle = build_model(cfg)
    params = bundle.init(0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    engine = ServeEngine(cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                         params=params)
    rng = np.random.default_rng(11)
    for n in LM_PROMPT_LENS:
        engine.submit(rng.integers(0, cfg.vocab, n),
                      max_new_tokens=LM_NEW_TOKENS)
    finite = []
    inner = engine._decode

    def decode(p, t, c):  # every step's logits checked, read once at the end
        logits, c = inner(p, t, c)
        finite.append(torch.isfinite(logits).all())
        return logits, c
    engine._decode = decode
    g = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, LM_PREFILL_SHAPE, device="cuda",
                           generator=g)

    # --- the main path: counts zeroed just before, read just after -------
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        pre = bundle.prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    t_prefill_first = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # -----------------------------------------------------------------------
    steps = engine.stats["steps"]
    log(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, vocab "
        f"{cfg.vocab}, {n_params} params in {cfg.param_dtype}, made on the "
        f"card in {t_init:.2f} s")
    log(f"[lm] launches {launches}; engine stats {engine.stats}")
    check(launches["flash_attention"] == cfg.n_layers * (steps + 1) > 0,
          f"flash launches {launches['flash_attention']} != "
          f"{cfg.n_layers} x ({steps} steps + 1 prefill)")
    check(launches["flash_decode_split"] == cfg.n_layers * steps
          and launches["flash_prefill_tc"] == cfg.n_layers
          and launches["flash_simt"] == 0,
          f"flash routes: {cfg.n_layers * steps} split-KV decode and "
          f"{cfg.n_layers} tensor-core prefill calls expected, got {launches}")
    check(sorted(results) == list(range(1, len(LM_PROMPT_LENS) + 1)),
          f"answered {sorted(results)}")
    check(all(len(r) == LM_NEW_TOKENS for r in results.values()),
          "a request got the wrong number of tokens")
    check(engine.stats["waves"] == 2, f"waves {engine.stats['waves']}")
    check(torch.stack(finite).all().item(), "non-finite decode logits")
    check(pre.shape == (LM_PREFILL_SHAPE[0], cfg.vocab)
          and torch.isfinite(pre).all().item(), "prefill logits")
    generated = sum(len(r) for r in results.values())
    log(f"[lm] served {len(results)} requests, {generated} tokens, {steps} "
        f"decode steps in {t_serve:.3f} s: {t_serve * 1e3 / steps:.3f} "
        f"ms/step, {generated / t_serve:.1f} generated tokens/s "
        f"({LM_SLOTS * steps / t_serve:.1f} slot-tokens/s)")
    with torch.inference_mode():
        prefill_ms = host_ms(lambda: bundle.prefill(params,
                                                    {"tokens": prompt}))
        caches = bundle.init_cache(LM_SLOTS, LM_MAX_SEQ)
        tok = prompt[:, :1]
        step_ms = host_ms(lambda: bundle.decode(params, tok, caches),
                          reps=20)
    log(f"[lm] prefill {LM_PREFILL_SHAPE}: first {t_prefill_first * 1e3:.1f}"
        f" ms, warm {prefill_ms:.1f} ms; warm decode step (4 slots) "
        f"{step_ms:.3f} ms")
    if profile:
        profile_lm_decode(bundle, params, tok)
    del engine, caches, pre

    rows = []
    s, t = LM_PREFILL_SHAPE[1], LM_PREFILL_SHAPE[1]
    rows.append(attention_row("prefill", cfg, s, t, dict(causal=True),
                              launches["flash_prefill_tc"]))
    kw = dict(causal=True, q_offset=LM_DECODE_POS,
              kv_positions=rolling_positions(LM_MAX_SEQ, LM_DECODE_POS + 1))
    rows.append(attention_row("decode", cfg, 1, LM_MAX_SEQ, kw,
                              launches["flash_decode_split"]))
    check(rows[0]["kernel_route"] == "tc"
          and rows[1]["kernel_route"] == "split",
          "the smoke shapes' bf16 routes are not tensor-core prefill and "
          "split-KV decode")
    del params, bundle
    torch.cuda.empty_cache()
    err = check_decode_vs_forward(cfg)
    log(f"[lm] float32 decode vs forward {LM_TF_SHAPE}: max abs err "
        f"{err!r} (rtol 2e-2, atol 2e-3)")
    share = cfg.n_layers * rows[1]["ms"] / step_ms
    log(f"[lm] flash decode kernels per step {cfg.n_layers} x "
        f"{rows[1]['ms']:.4f} ms = {share:.3f} of a warm decode step")
    return rows


def profile_lm_decode(bundle, params, tok) -> None:
    """Eight warm decode steps under torch.profiler: device time by kernel
    and the device's busy share of the steps' wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    caches = bundle.init_cache(LM_SLOTS, LM_MAX_SEQ)
    bundle.decode(params, tok, caches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            bundle.decode(params, tok, caches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    log(f"[profile-lm] 8 decode steps wall {wall * 1e3:.2f} ms, device "
        f"kernels {busy * 1e3:.2f} ms (busy share {busy / wall:.3f})")
    for key, us, n in rows[:10]:
        log(f"[profile-lm] {us / 1e3:9.3f} ms  {n:5d} x  {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one more device-mode self_join, point "
                    "queries one at a time (host functions, launches a "
                    "probed bucket) and eight LM decode steps with "
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
        t_io = time.perf_counter()
        io = phase_io(main_path, workdir)
        log(f"[io] phase {time.perf_counter() - t_io:.1f} s")
        # the [io] paths' own launch counts beside the main path's
        wrapper = {"pairwise_l2_threshold_batched": "verify_pairs_batch",
                   "pairwise_l2_threshold": "pairwise_l2_threshold",
                   "bucket_assign": "bucket_assign"}
        for k in kernels:
            k["io_launches"] = {path: n[wrapper[k["name"]]]
                                for path, n in io["launches"].items()}
        t_serve = time.perf_counter()
        serve = phase_serve(main_path, workdir)
        log(f"[serve] phase {time.perf_counter() - t_serve:.1f} s")
        for k in kernels:   # the [serve] phase's own launch counts
            k["serve_launches"] = serve["launches"][wrapper[k["name"]]]
        t_parity = time.perf_counter()
        phase_parity(workdir)
        log(f"[parity] phase {time.perf_counter() - t_parity:.1f} s")
        if args.profile:
            phase_profile(main_path["shapes"]["index"])
            profile_queries(main_path["shapes"]["index"],
                            main_path["shapes"]["Q"])
        main_path["shapes"]["index"].close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del main_path
    torch.cuda.empty_cache()
    t_lm = time.perf_counter()
    kernels += phase_lm(args.profile)
    log(f"[lm] phase {time.perf_counter() - t_lm:.1f} s")
    log(f"[done] total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
