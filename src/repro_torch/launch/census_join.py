"""Census of the DiskJoin verify superstep on one card: the counterpart of
the JAX package's ``launch/dryrun_join.py``.

The paper's own workload at pod scale: a billion-vector join (1M buckets,
capacity 1,024, d = 128) runs as supersteps of E edges against a window
of W buckets resident on the device. The reference lowers one superstep
(``core/distributed.py::verify_edges``) on its meshes, edges sharded over
every chip; here all E edges run on the one card, through the port's
``verify_edges`` (one verify launch, ``kernels/csrc/pairwise_l2_sm90.cu``
at d % 4 == 0). The defaults are the reference's: E 4,096, cap 1,024,
d 128, W 512. They fit: the window is 256 MiB, the gathered lanes 2 GiB a
side, and d² (float32) with the mask (one byte) E·cap²·5 B ≈ 21.5 GB.

The window holds W clusters of cap rows (a center, N(0, 1) per
coordinate, plus N(0, σ²) with 2σ²·d = ε²), so a bucket's own lane holds
pairs within ε and the rest hold almost none; an eighth of the edges are
a bucket against itself. ε = 1, the ε² = 1.0 the reference lowers with.

The record keeps the reference's fields and its convention for them:
``params`` = ``active_params`` = W·cap·d (the resident floats) and
``tokens`` = E, so ``roofline.model_flops_per_device`` gives 2·W·cap·d·E
for a superstep. That is not the verify's own work, 2·E·cap²·d, which
``op_cost`` counts; the port copies the formula because it is held to the
reference. So the record has no ``mfu``: its model FLOPs measure nothing
the card does. It is measured as ``census.run_cell`` measures a cell.

    python -m repro_torch.launch.census_join [--edges 4096] [--cap 1024]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.distributed import verify_edges
from repro_torch.device import resolve_device
from repro_torch.launch import roofline
from repro_torch.launch.census import (RESULTS, SEED, append_result,
                                       card_info, measure, record_line,
                                       tree_bytes)

EPS = 1.0
SELF_EDGES = 0.125


def make_superstep(edges: int, cap: int, dim: int, window: int, *,
                   device=None):
    """A window of clustered buckets and its edges → (slab (W, cap, d)
    float32 on ``device``, edges (E, 2) int32 host indices into it)."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(SEED)
    sigma = EPS / np.sqrt(2.0 * dim)
    slab = (torch.randn(window, 1, dim, generator=g)
            + sigma * torch.randn(window, cap, dim, generator=g))
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, window, edges)
    b = np.where(rng.random(edges) < SELF_EDGES, a,
                 rng.integers(0, window, edges))
    return slab.to(device), np.stack([a, b], axis=1).astype(np.int32)


def run(edges: int = 4096, cap: int = 1024, dim: int = 128,
        window: int = 512, *, device=None, superstep=None) -> dict:
    """The superstep's census record (module docstring); ``superstep``, a
    ``make_superstep`` result of these sizes, saves making it again.
    Raises on a failure."""
    device = resolve_device(device)
    card = card_info(device)
    rec = {"arch": "diskjoin-verify", "shape": f"E{edges}_cap{cap}_d{dim}",
           "mesh": "1", "tag": "baseline", "step": "join_superstep",
           "card": card["name"], "power_limit": card["power_limit"],
           "card_bytes": card["total_memory"]}
    t0 = time.time()
    slab, eidx = superstep or make_superstep(edges, cap, dim, window,
                                             device=device)
    if tuple(slab.shape) != (window, cap, dim) or len(eidx) != edges:
        raise ValueError(f"superstep {tuple(slab.shape)}, {len(eidx)} edges "
                         f"is not ({window}, {cap}, {dim}), {edges}")

    counts = []

    def step(slab, eidx):   # keeps each call's per-edge counts, no more
        counts[:] = [verify_edges(slab, eidx, EPS)[0]]

    rec.update(live_bytes=tree_bytes(slab) + eidx.nbytes,
               **measure(step, (slab, eidx), device))
    rec["pairs"] = int(counts[0].sum().item())
    del slab, counts
    rec.update(params=window * cap * dim, active_params=window * cap * dim,
               tokens=edges, chips=1, status="ok",
               fits_card=(rec["peak_bytes"] or 0) <= card["total_memory"],
               elapsed_s=round(time.time() - t0, 1))
    rec["roofline"] = roofline.roofline_terms(rec)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--edges", type=int, default=4096)
    ap.add_argument("--cap", type=int, default=1024)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)
    rec = run(args.edges, args.cap, args.dim, args.window)
    print(record_line(rec), flush=True)
    append_result(rec, args.out)


if __name__ == "__main__":
    main()
