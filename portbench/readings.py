"""The readings that the limits of ``correct`` are set from, several seeds
in one process (the set-up of each seed is paid, the process's start once).

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 \
        [--seconds 5] [--control]

Without ``--control``: the program's compared numbers, a short window of
the cell at its own size per seed (the lower readings). With
``--control``: the reference put in the program's place one precision
below the configuration's float32 (``reference.py``'s TF32), at the cell's
own size: every pair of the join, or as many queries of the cell's stream
as a run compares (the upper readings). One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(spec: dict, seed: int, device) -> dict:
    """The control's numbers for one seed, at the cell's own size."""
    import numpy as np
    import torch

    from portbench import harness
    from portbench.yardstick import compare, reference
    from portbench.yardstick.data import QueryStream

    x, eps, base = harness.make_inputs(spec["config"], seed, device)
    mix = spec["traffic"]
    xd = torch.from_numpy(x).to(device)
    if mix["kind"] == "join":
        pairs, d2 = reference.join(xd, eps, "tf32")
        return compare.join_numbers(
            x, eps, pairs.cpu().numpy(),
            d2.sqrt().float().cpu().numpy(), device)
    stream = QueryStream(base, seed, anchor_seed=spec["config"]["data_seed"],
                         **mix.get("stream", {}))
    for _ in range(int(mix.get("warm_queries", 0))):
        stream.next()
    drawn = [stream.next() for _ in range(int(mix["check_queries"]))]
    Q = np.stack([q for q, _ in drawn])
    answers = []
    for ids, d2 in reference.members(xd, torch.from_numpy(Q).to(device),
                                     eps, "tf32"):
        d = np.sqrt(d2).astype(np.float32)
        order = np.lexsort((ids, d))
        answers.append((ids[order], d[order]))
    return compare.query_numbers(x, eps, Q, answers, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness
    from portbench.yardstick import compare
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    spec = harness.cell_spec(bench, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        metrics = {}
        if args.control:
            numbers = control_numbers(spec, seed, torch.device("cuda"))
            ok, checks = compare.judge(numbers, spec["limits"])
        else:
            out = harness.run_cell(args.workload, seed, args.seconds, False,
                                   device="cuda", bench=bench,
                                   log=lambda m: None)
            ok, checks = out["correct"], out["checks"]
            metrics = {k: v["value"] for k, v in out["metrics"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "correct": ok,
                          "seconds": time.perf_counter() - t0,
                          "numbers": {k: v["value"]
                                      for k, v in checks.items()},
                          "metrics": metrics}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
