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
4. Host/device byte parity of ``self_join`` at 100,000 × 128.
5. ``[lm]``: LM serving at qwen3-0.6b's full width (28 layers, bf16
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
option, ``--profile``, adds a traced repeat of the device-mode join and
traced LM decode steps.
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
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.core import center_index  # noqa: E402
from repro_torch.core.bucketize import sample_centers  # noqa: E402
from repro_torch.data import (clustered_vectors,  # noqa: E402
                              epsilon_for_avg_neighbors)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import bucket_assign as assign  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import pairwise_l2 as verify  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
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
    members, boundary, found = check_query_agreement(x, Q, src, eps, q_host,
                                                     q_dev)
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
                  block_rows=cfg.block_rows, index=index, store=store)
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


# ---------------------------------------------------------------------------
# phase 5: LM serving at qwen3-0.6b's full width
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
                    help="also trace one more device-mode self_join and "
                    "eight LM decode steps with torch.profiler: device busy "
                    "share and top kernels")
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
