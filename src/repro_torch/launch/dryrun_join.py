"""Dry-run of the DiskJoin verify superstep on the production meshes: a port
of the JAX package's ``launch/dryrun_join.py``.

The paper's own workload at pod scale: a billion-vector join (1M buckets,
capacity 1,024, d = 128) runs as supersteps of E edges against a window of
W buckets resident on each chip. The reference lowers one superstep
(``core/distributed.py::verify_edges``) with the window replicated and the
edge tasks sharded over every mesh axis: independent tasks, no state
across them, so its program has no collective. Here the superstep runs as
rank 0 of the mesh in a fake world (``launch/dryrun.py``): the whole
window resident on the card, and the rank's E / world edges (16 on 16×16,
8 on 2×16×16 at the default E 4,096) through the port's ``verify_edges``
(one verify launch). The window is ``census_join.make_superstep``'s; the
record is ``census_join``'s, measured as ``dryrun.measure`` measures a
cell, with the reference's mesh keying and ``chips`` the mesh's size.

    python -m repro_torch.launch.dryrun_join [--edges 4096] [--both-meshes]
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.core.distributed import verify_edges
from repro_torch.device import resolve_device
from repro_torch.launch import roofline
from repro_torch.launch.census import append_result, card_info, tree_bytes
from repro_torch.launch.census_join import EPS, make_superstep
from repro_torch.launch.collectives import collective_bytes
from repro_torch.launch.dryrun import (RESULTS, ensure_world, measure,
                                       mesh_name, record_line)
from repro_torch.launch.mesh import make_production_mesh


def run(edges: int = 4096, cap: int = 1024, dim: int = 128,
        window: int = 512, multi_pod: bool = False, *, device=None,
        superstep=None) -> dict:
    """The superstep's record as rank 0 of the mesh (module docstring);
    ``superstep``, a ``make_superstep`` result of these sizes, saves making
    it again. Raises on a failure."""
    device = resolve_device(device)
    card = card_info(device)
    ensure_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    rec = {"arch": "diskjoin-verify", "shape": f"E{edges}_cap{cap}_d{dim}",
           "mesh": mesh_name(multi_pod), "tag": "baseline",
           "step": "join_superstep", "card": card["name"],
           "power_limit": card["power_limit"]}
    if edges % mesh.size:
        raise ValueError(f"{edges} edges do not split over {mesh.size} "
                         "ranks")
    t0 = time.time()
    slab, eidx = superstep or make_superstep(edges, cap, dim, window,
                                             device=device)
    per = edges // mesh.size
    mine = eidx[mesh.rank * per:(mesh.rank + 1) * per]
    counts = []

    def step(slab, mine):
        counts[:] = [verify_edges(slab, mine, EPS)[0]]

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    m = measure(step, (slab, mine), mesh, device)
    coll = collective_bytes(m["tally"], mesh.size)
    rec.update(
        status="ok", rank_edges=per, pairs=int(counts[0].sum().item()),
        memory={"params_bytes": tree_bytes(slab), "opt_bytes": 0,
                "cache_bytes": 0,
                "peak_allocated_bytes": m["peak_allocated_bytes"],
                "peak_reserved_bytes": m["peak_reserved_bytes"],
                "first_build_peak_bytes": None},
        op_cost=dict(m["summary"],
                     collective_traffic_bytes=coll["total_traffic_bytes"]),
        collectives=coll, collective_s=roofline.collective_seconds(
            m["tally"]), collective_ops=len(m["tally"]),
        step_s=m["step_s"], step_times_s=m["step_times_s"],
        steps_run=m["steps_run"],
        live_bytes=tree_bytes(slab) + mine.nbytes,
        peak_bytes=m["peak_allocated_bytes"],
        params=window * cap * dim, active_params=window * cap * dim,
        tokens=edges, rank_rows=per, chips=int(mesh.size),
        elapsed_s=round(time.time() - t0, 1))
    rec["roofline"] = roofline.roofline_terms(rec)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--edges", type=int, default=4096)
    ap.add_argument("--cap", type=int, default=1024)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)
    step = None
    for mp in ([False, True] if args.both_meshes else [False]):
        step = step or make_superstep(args.edges, args.cap, args.dim,
                                      args.window)
        rec = run(args.edges, args.cap, args.dim, args.window, mp,
                  superstep=step)
        print(record_line(rec), flush=True)
        append_result(rec, args.out)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
