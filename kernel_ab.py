#!/usr/bin/env python3
"""Compare the port's squared-L2 kernels between two checkouts on one card.

    python3 kernel_ab.py OTHER_CHECKOUT

Runs four turns, OTHER, this, this, OTHER, each in a fresh process that
imports ``repro_torch`` from that checkout's ``src`` (and so builds that
checkout's kernels), and prints one JSON line per turn:

* ``verify_sha256``: the SHA-256 of verify's (d², mask) and of the E = 1
  launch's, on seeded inputs at four shapes (the smoke join's
  (32, 2048, 2048, 128) batch and three ragged ones);
* ``verify_ms``: verify's device time at (32, 2048, 2048, 128), three
  readings;
* ``assign_ms`` (where the checkout has the tensor-core assign route):
  ``bucket_assign``'s device time at (8192, 1000, 128) and
  (8192, 65536, 128), per split count.

The last line says whether every turn gave the same verify hashes. Device
times come from CUDA graphs, as in ``chip_smoke.py``. Needs one CUDA
device; the data comes from seeded generators on the card.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

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


def turn(src: str) -> dict:
    """One checkout's readings (run in a process of its own)."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import bucket_assign, ops
    out = {"src": src, "verify_sha256": {}, "assign_ms": {}}
    for e, m, n, d in VERIFY_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(e + m + n + d)
        u = torch.randn(e, m, d, device="cuda", generator=g)
        v = torch.randn(e, n, d, device="cuda", generator=g)
        eps = (2.0 * d) ** 0.5
        h = hashlib.sha256()
        for t in (*ops.verify_pairs_batch(u, v, eps),
                  *ops.pairwise_l2_threshold(u[0, :64], v[0], eps)):
            h.update(t.contiguous().cpu().numpy().tobytes())
        out["verify_sha256"][str((e, m, n, d))] = h.hexdigest()
    u, v = (torch.randn(32, 2048, 128, device="cuda") for _ in range(2))
    out["verify_ms"] = [graph_ms(torch, lambda: ops.verify_pairs_batch(
        u, v, 16.0)) for _ in range(3)]
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
            out["assign_ms"][str((m, b, d))] = {
                "plan_splits": plan.splits, "by_splits": times}
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2])))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    other = os.path.join(os.path.abspath(sys.argv[1]), "src")
    hashes = []
    for src in (other, here, here, other):
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", src], capture_output=True,
                             text=True, timeout=900)
        if run.returncode != 0:
            print(run.stderr, file=sys.stderr)
            return run.returncode
        line = run.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        hashes.append(json.loads(line)["verify_sha256"])
    same = all(h == hashes[0] for h in hashes)
    print(json.dumps({"verify_bytes_identical": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
