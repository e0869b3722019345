#!/usr/bin/env python3
"""Compare the port's squared-L2 kernels between two checkouts on one card.

    python3 kernel_ab.py [--join] OTHER_CHECKOUT

Runs four turns, OTHER, this, this, OTHER, each in a fresh process that
imports ``repro_torch`` from that checkout's ``src`` (and so builds that
checkout's kernels), and prints one JSON line per turn:

* ``verify_sha256``: the SHA-256 of verify's (d², mask) and of the E = 1
  launch's, on seeded inputs at four shapes (the smoke join's
  (32, 2048, 2048, 128) batch and three ragged ones);
* ``verify_ms``: verify's device time at (32, 2048, 2048, 128), three
  readings, and where the checkout counts them, the pairs its re-check
  recomputed in one such launch (``verify_rechecked``);
* ``assign_ms`` (where the checkout has the tensor-core assign route):
  ``bucket_assign``'s device time at (8192, 1000, 128) and
  (8192, 65536, 128), per split count, and where counted, the rows
  rescanned (``assign_rescanned``);
* with ``--join``, ``join``: the main path's own verify inputs and the
  join users run, as ``chip_smoke.py``'s ``[main]`` and ``[kernel]`` make
  them: 1,000,000 × 128 seeded clustered rows, ε for about 20 neighbours,
  ``DiskJoinIndex.build`` and one device-mode ``self_join`` (its wall
  seconds, its ``execute`` seconds, its pairs, its verify launches and
  the pairs they recomputed), then verify's device time on the
  ``[kernel]`` phase's 32 bucket lanes (half of them a bucket against
  itself) and the pairs one launch there recomputes.

The first turn of each checkout also leaves its verify outputs in a
scratch directory. The last line says whether each checkout's turns gave
the same verify hashes, and compares the two checkouts' outputs: how many
d² and mask bytes differ, and whether each differing output lies within
the re-check band of ε² (``csrc/l2_sm90.cuh``; κ(d)·2⁻²³·(‖a‖² + ‖b‖²),
from float64 norms with a 1e-4 margin) as the OTHER checkout computed it:
a checkout whose verify decides inside that band as the CUDA-core route
does differs from one that does not only there. Device times come from
CUDA graphs, as in ``chip_smoke.py``. Needs one CUDA device; the data
comes from seeded generators on the card.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

VERIFY_SHAPES = [(32, 2048, 2048, 128), (3, 200, 150, 96), (2, 65, 63, 4),
                 (1, 37, 500, 960)]
ASSIGN_SHAPES = [(8192, 1000, 128), (8192, 65536, 128)]


def graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls in a CUDA graph,
    replayed ``replays`` times between events after a warm replay."""
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


def verify_inputs(torch, e: int, m: int, n: int, d: int):
    """The seeded (u, v, ε) of one hashed shape."""
    g = torch.Generator(device="cuda").manual_seed(e + m + n + d)
    u = torch.randn(e, m, d, device="cuda", generator=g)
    v = torch.randn(e, n, d, device="cuda", generator=g)
    return u, v, (2.0 * d) ** 0.5


def join_turn(torch, counting) -> dict:
    """The ``--join`` readings of the checkout already on ``sys.path``."""
    import time

    import numpy as np
    from repro_torch.core import DiskJoinIndex, JoinConfig
    from repro_torch.data import clustered_vectors, epsilon_for_avg_neighbors
    from repro_torch.kernels import ops
    from repro_torch.store.vector_store import FlatVectorStore
    n, dim, lanes = 1_000_000, 128, 32
    x = clustered_vectors(n, dim, seed=1)
    eps = epsilon_for_avg_neighbors(x, 20)
    out = {"eps": eps}
    with tempfile.TemporaryDirectory(prefix="kernel_ab_join_") as work:
        store = FlatVectorStore.from_array(os.path.join(work, "x.bin"), x)
        cfg = JoinConfig(epsilon=eps, num_buckets=n // 1000,
                         memory_budget_bytes=x.nbytes // 10, pad_align=128,
                         compute_mode="device")
        index = DiskJoinIndex.build(store, cfg, os.path.join(work, "index"))
        ops.reset_launches()
        rec = (counting(torch.device("cuda")) if counting is not None
               else contextlib.nullcontext())
        with rec as counts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = index.self_join()
            torch.cuda.synchronize()
            out["self_join_s"] = time.perf_counter() - t0
        out["execute_s"] = res.timings["execute"]
        out["pairs"] = int(res.pairs.shape[0])
        out["verify_launches"] = (ops.LAUNCHES["verify_pairs_batch"]
                                  + ops.LAUNCHES["pairwise_l2_threshold"])
        if counts is not None:
            out["verify_rechecked"] = int(counts[0].item())
        u = torch.from_numpy(np.stack([
            np.resize(index.store.read_bucket(b)[0],
                      (index.bucket_capacity, dim))
            for b in range(lanes)])).cuda()
        v = torch.roll(u, shifts=1, dims=0)
        v[: lanes // 2] = u[: lanes // 2]
        out["lanes_shape"] = list(u.shape)
        out["lanes_verify_ms"] = [graph_ms(torch, lambda: ops
                                           .verify_pairs_batch(u, v, eps))
                                  for _ in range(3)]
        if counting is not None:
            with counting(u.device) as counts:
                ops.verify_pairs_batch(u, v, eps)
            out["lanes_rechecked"] = int(counts[0].item())
    return out


def turn(src: str, keep: str | None, join: bool) -> dict:
    """One checkout's readings (run in a process of its own); ``keep``: a
    directory for its verify outputs, or None; ``join``: add the
    ``--join`` readings."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import bucket_assign, ops
    from repro_torch.kernels import pairwise_l2 as verify
    counting = getattr(verify, "counting_rechecks", None)
    out = {"src": src, "verify_sha256": {}, "assign_ms": {}}
    for e, m, n, d in VERIFY_SHAPES:
        u, v, eps = verify_inputs(torch, e, m, n, d)
        h = hashlib.sha256()
        outs = (*ops.verify_pairs_batch(u, v, eps),
                *ops.pairwise_l2_threshold(u[0, :64], v[0], eps))
        for t in outs:
            h.update(t.contiguous().cpu().numpy().tobytes())
        out["verify_sha256"][str((e, m, n, d))] = h.hexdigest()
        if keep is not None:
            torch.save([t.cpu() for t in outs],
                       os.path.join(keep, f"{e}_{m}_{n}_{d}.pt"))
    u, v = (torch.randn(32, 2048, 128, device="cuda") for _ in range(2))
    out["verify_ms"] = [graph_ms(torch, lambda: ops.verify_pairs_batch(
        u, v, 16.0)) for _ in range(3)]
    if counting is not None:
        with counting(u.device) as counts:
            ops.verify_pairs_batch(u, v, 16.0)
        out["verify_rechecked"] = int(counts[0].item())
    if hasattr(bucket_assign, "launch_plan"):
        for m, b, d in ASSIGN_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(m + b)
            x = torch.randn(m, d, device="cuda", generator=g)
            c = torch.randn(b, d, device="cuda", generator=g)
            plan = bucket_assign.launch_plan(m, b, d)
            tiles = -(-b // plan.block_m)
            times = {}
            for s in sorted({1, 2, plan.splits, 2 * plan.splits}):
                if s <= tiles:
                    p = bucket_assign.LaunchPlan("tc", plan.block_m, s)
                    times[s] = graph_ms(torch, lambda: bucket_assign
                                        .bucket_assign(x, c, p))
            row = {"plan_splits": plan.splits, "by_splits": times}
            if counting is not None:
                with counting(x.device) as counts:
                    ops.bucket_assign(x, c)
                row["assign_rescanned"] = int(counts[1].item())
            out["assign_ms"][str((m, b, d))] = row
    if join:
        out["join"] = join_turn(torch, counting)
    return out


def compare(other_dir: str, here_dir: str, here_src: str) -> dict:
    """The two checkouts' verify outputs, shape by shape: d² and mask
    bytes that differ, and how many of them lie outside the re-check band
    of ε² around the OTHER checkout's d² (``band_scale`` from the
    ``here_src`` checkout's ``repro_torch.kernels.pairwise_l2``)."""
    sys.path.insert(0, here_src)
    import torch
    from repro_torch.kernels.pairwise_l2 import band_scale
    res = {"d2_differ": 0, "mask_differ": 0, "outside_band": 0}
    for e, m, n, d in VERIFY_SHAPES:
        name = f"{e}_{m}_{n}_{d}.pt"
        a = torch.load(os.path.join(other_dir, name))
        b = torch.load(os.path.join(here_dir, name))
        u, v, eps = verify_inputs(torch, e, m, n, d)
        u, v = u.cpu().double(), v.cpu().double()
        eps2 = float(torch.tensor(eps * eps, dtype=torch.float32))
        for (d2a, ma, d2b, mb), (x, y) in (
                ((a[0], a[1], b[0], b[1]), (u, v)),
                ((a[2], a[3], b[2], b[3]), (u[0, :64], v[0]))):
            nx = (x * x).sum(-1)[..., :, None]
            ny = (y * y).sum(-1)[..., None, :]
            w = band_scale(d) * (nx + ny) * (1 + 1e-4) + 2.0 ** -100
            differ = (d2a != d2b) | (ma != mb)
            res["d2_differ"] += int((d2a != d2b).sum())
            res["mask_differ"] += int((ma != mb).sum())
            far = (d2a.double() - eps2).abs() > w
            res["outside_band"] += int((differ & far).sum())
    return res


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--turn":
        keep = sys.argv[3] or None
        print(json.dumps(turn(sys.argv[2], keep, sys.argv[4] == "join")))
        return 0
    args = sys.argv[1:]
    join = args[:1] == ["--join"]
    args = args[1:] if join else args
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    other = os.path.join(os.path.abspath(args[0]), "src")
    scratch = tempfile.mkdtemp(prefix="kernel_ab_")
    keeps = [os.path.join(scratch, k) for k in ("other", "here")]
    hashes = {other: [], here: []}
    try:
        for i, src in enumerate((other, here, here, other)):
            keep = keeps[i] if i < 2 else ""
            if keep:
                os.mkdir(keep)
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--turn", src, keep,
                                  "join" if join else ""],
                                 capture_output=True, text=True,
                                 timeout=900)
            if run.returncode != 0:
                print(run.stderr, file=sys.stderr)
                return run.returncode
            line = run.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            hashes[src].append(json.loads(line)["verify_sha256"])
        same = {k: all(h == v[0] for h in v) for k, v in
                (("other", hashes[other]), ("here", hashes[here]))}
        across = compare(*keeps, here)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps({"verify_bytes_identical_within_each_checkout": same,
                      "verify_bytes_identical_across":
                          hashes[other][0] == hashes[here][0],
                      "across": across}))
    return 0 if all(same.values()) and across["outside_band"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
