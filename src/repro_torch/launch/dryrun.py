"""Dry-run of the production meshes: a port of the JAX package's
``launch/dryrun.py``.

For every (architecture × input shape) cell, the reference lowers and
compiles the train or serve step on the production meshes,

    16×16 ("data", "model")           — single pod, 256 chips
    2×16×16 ("pod", "data", "model")   — 2 pods, 512 chips,

and records the compiled program's memory analysis, its cost analysis and
the collective bytes of its post-SPMD HLO. PyTorch has no compiled
program to read, so the port runs the step instead, as one rank of the
mesh on one card: rank 0 of a world of 256 or 512 in torch's ``"fake"``
process-group backend (``launch.mesh.init_fake_world``), where no other
rank exists and no collective moves data. The rank holds what the
reference's shardings give a chip (``steps.prepare_cell(mesh=...)``): its
rows of the global batch, its parameter parts, its AdamW state, its slice
of each decode cache, and it runs its share of every block's compute
(``dist.tensor_parallel``). Its values mean nothing (a collective returns
the rank's own part), while its shapes, kernel launches, FLOPs, bytes,
peak memory and collective tally are those of a rank of the mesh.

A record has the reference's keys — ``status``, ``step``, ``memory``, the
cost, ``params``, ``active_params``, ``tokens`` (the global batch's),
``chips`` — and the card's name and power limit:

* ``memory``: measured. The rank's peak allocated and reserved bytes over
  the timed steps (the counter is reset after the parameter store is
  built), the bytes of its parameter parts, its optimizer state and its
  caches, and the first build's own peak (``first_build_peak_bytes``: the
  store is built from the whole model on the card; ROADMAP keeps that
  open);
* ``cost``: ``op_cost``'s per-rank FLOPs by dtype and bytes of one step,
  with ``collectives`` (``launch/collectives.py::collective_bytes`` of the
  step's tally, the counterpart of ``hlo_analysis.collective_bytes``) and
  ``collective_traffic_bytes``;
* ``roofline``: ``roofline.roofline_terms`` with its collective term from
  the tally at the assumed link rates.

The flags are the reference's (``--fsdp``, ``--capacity-data``,
``--dp-over-model``, ``--moe-replicated-dispatch``, ``--moe-a2a``; each sets
the rule the reference sets). ``--decode-unroll`` selects nothing here: the
reference unrolls its layer scan in decode so the compiler sees each
layer; the port runs its layers in a Python loop already. A flag is
recorded in the record's ``flags`` and, without ``--tag``, in its tag.

Results are appended to ``results/dryrun.json`` (``--out``) with the
reference's keying, (arch, shape, mesh, tag), one cell at a time;
``--resume`` skips cells recorded ``ok`` or ``skipped``. The counterpart of
the reference's ``_save_hlo``: a gzip file per cell under
``results/dryrun_ops/`` with the step's op table and its tally. A cell that
fails is recorded with ``status = "error"`` and its message (an
out-of-memory one with ``oom = True``), never skipped in silence.

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes [--resume]
    python -m repro_torch.launch.dryrun --summary [--out PATH]
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import statistics
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.device import resolve_device
from repro_torch.launch import roofline
from repro_torch.launch.census import (GIB, SEED, append_result, card_info,
                                       free_device_memory, load_results,
                                       tree_bytes)
from repro_torch.launch.collectives import collective_bytes
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.steps import prepare_cell
from repro_torch.models import build_model

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
RESULTS = os.path.join(_ROOT, "results", "dryrun.json")
TIMED_STEPS = 3
FLAGS = ("decode_unroll", "capacity_data", "dp_over_model",
         "moe_replicated_dispatch", "moe_a2a")


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def ensure_world(world: int) -> None:
    """A fake world of ``world`` ranks, this process rank 0 (a world of
    another size is left first)."""
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                str(dist.get_backend()) == "fake":
            return
        dist.destroy_process_group()
    init_fake_world(world)


def extra_rules(capacity_data: bool = False, dp_over_model: bool = False,
                moe_replicated_dispatch: bool = False,
                moe_a2a: bool = False) -> dict:
    """The rules the reference's flags install (its ``run_cell``)."""
    extra: dict = {}
    if capacity_data:
        extra["capacity"] = (("data", "model") if dp_over_model
                             else "data")
    if dp_over_model:
        extra["batch"] = ("pod", "data", "model")
    if moe_replicated_dispatch:
        extra["moe_tokens"] = ()
    if moe_a2a:
        extra["moe_a2a"] = "model"
    return extra


def default_tag(fsdp: bool, flags: dict) -> str:
    return "+".join(["fsdp" if fsdp else "baseline"]
                    + [f for f in FLAGS if flags.get(f)])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state_bytes(args: tuple, kind: str) -> dict:
    """Bytes of the rank's parameter parts, optimizer state and caches."""
    store = args[0]
    out = {"params_bytes": sum(tree_bytes(p) for p in store.parts.values()),
           "opt_bytes": 0, "cache_bytes": 0}
    if kind == "train_step":
        out["opt_bytes"] = tree_bytes({k: v for k, v in args[1].items()
                                       if k != "step"})
    if kind == "serve_step":
        out["cache_bytes"] = tree_bytes(args[1])
    return out


def _save_ops(path_dir: str, rec: dict, summary: dict, tally: list) -> None:
    """The counterpart of the reference's ``_save_hlo``: the step's op
    table and collective tally, gzip'd JSON."""
    os.makedirs(path_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec['tag']}"
    with gzip.open(os.path.join(path_dir, name + ".json.gz"), "wt") as f:
        json.dump({"ops": summary["by_op"], "kernels": summary["kernels"],
                   "tally": tally}, f)


def measure(step, args, mesh, device: torch.device,
            timed: int = TIMED_STEPS) -> dict:
    """A warm-up step; one step under ``OpCost`` and the mesh's tally (the
    step's collectives); ``timed`` timed steps (the median ``step_s``); the
    peaks since the last reset; ``steps_run``, the step calls made."""
    step(*args)
    _sync(device)
    with mesh.tallying() as tally, OpCost() as oc:
        step(*args)
        _sync(device)
    times = []
    for _ in range(timed):
        _sync(device)
        t0 = time.perf_counter()
        step(*args)
        _sync(device)
        times.append(time.perf_counter() - t0)
    cuda = device.type == "cuda"
    return {"summary": oc.summary(), "tally": tally, "steps_run": timed + 2,
            "step_s": statistics.median(times), "step_times_s": times,
            "peak_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                     if cuda else None),
            "peak_reserved_bytes": (torch.cuda.max_memory_reserved(device)
                                    if cuda else None)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             fsdp: bool = False, tag: str = "",
             decode_unroll: bool = False, capacity_data: bool = False,
             dp_over_model: bool = False,
             moe_replicated_dispatch: bool = False, moe_a2a: bool = False,
             *, device=None, ops_dir: str | None = None) -> dict:
    """One cell's record (module docstring), rank 0 of the mesh on
    ``device`` (None: the card). Raises on a failure."""
    flags = dict(decode_unroll=decode_unroll, capacity_data=capacity_data,
                 dp_over_model=dp_over_model,
                 moe_replicated_dispatch=moe_replicated_dispatch,
                 moe_a2a=moe_a2a)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": mesh_name(multi_pod),
                 "tag": tag or default_tag(fsdp, flags),
                 "flags": dict(flags, fsdp=fsdp)}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    device = resolve_device(device)
    card = card_info(device)
    rec.update(card=card["name"], power_limit=card["power_limit"])
    t0 = time.time()
    ensure_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    bundle = build_model(cfg, device=device)
    step, args, info = prepare_cell(
        bundle, shape, device=device,
        generator=torch.Generator().manual_seed(SEED), mesh=mesh,
        fsdp=fsdp, extra_rules=extra_rules(
            capacity_data, dp_over_model, moe_replicated_dispatch,
            moe_a2a))
    first_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    free_device_memory()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state = _state_bytes(args, info["kind"])
    m = measure(step, args, mesh, device)
    coll = collective_bytes(m["tally"], mesh.size)
    summary = dict(m["summary"],
                   collective_traffic_bytes=coll["total_traffic_bytes"])
    rec.update(
        status="ok", step=info["kind"],
        memory=dict(state, peak_allocated_bytes=m["peak_allocated_bytes"],
                    peak_reserved_bytes=m["peak_reserved_bytes"],
                    first_build_peak_bytes=first_peak),
        op_cost=summary, collectives=coll,
        collective_s=roofline.collective_seconds(m["tally"]),
        collective_ops=len(m["tally"]),
        step_s=m["step_s"], step_times_s=m["step_times_s"],
        steps_run=m["steps_run"],
        live_bytes=tree_bytes(args[1:]) + state["params_bytes"],
        peak_bytes=m["peak_allocated_bytes"],
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        tokens=(shape.global_batch if shape.kind == "decode"
                else shape.global_batch * shape.seq_len),
        rank_rows=info["rows"], batch_axes=list(info["batch_axes"]),
        chips=int(mesh.size), elapsed_s=round(time.time() - t0, 1))
    rec["roofline"] = roofline.roofline_terms(rec)
    _save_ops(ops_dir or os.path.join(os.path.dirname(RESULTS),
                                      "dryrun_ops"), rec, summary,
              m["tally"])
    return rec


def failure_record(arch: str, shape: str, mesh: str, tag: str,
                   e: BaseException, t0: float) -> dict:
    """A failed cell's record: its message; an out-of-memory error marked
    ``oom``."""
    return {"arch": arch, "shape": shape, "mesh": mesh, "tag": tag,
            "status": "error", "oom": isinstance(e, torch.OutOfMemoryError),
            "error": f"{type(e).__name__}: {e}"[:2000],
            "trace": traceback.format_exc()[-2000:],
            "elapsed_s": round(time.time() - t0, 1)}


def record_line(rec: dict) -> str:
    """One log line of a record."""
    head = (f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']} "
            f"{rec['tag']}")
    if rec["status"] != "ok":
        return f"{head}: {rec['status']}: " + rec.get(
            "reason", rec.get("error", ""))
    mem, r, c = rec["memory"], rec["roofline"], rec["collectives"]
    peak = mem["peak_allocated_bytes"]
    return (f"{head} {rec['step']}: rows {rec['rank_rows']}, peak "
            + ("n/a" if peak is None else f"{peak / GIB:.2f} GiB")
            + f" (params {mem['params_bytes'] / GIB:.2f}, opt "
            f"{mem['opt_bytes'] / GIB:.2f}, caches "
            f"{mem['cache_bytes'] / GIB:.2f} GiB), flops/dev "
            f"{rec['op_cost']['flops']:.4e} (work "
            f"{rec['op_cost']['work_flops']:.4e}), coll/dev "
            f"{c['total_traffic_bytes']:.4e} B in {rec['collective_ops']} "
            f"ops, compute {r['compute_s']:.4e} s, memory "
            f"{r['memory_s']:.4e} s, collective {r['collective_s']:.4e} s, "
            f"dominant {r['dominant']}; step {rec['step_s']:.6f} s")


def summary_markdown(rows: list[dict]) -> str:
    """A table of the records, one line a record (``--summary``): arch,
    shape, mesh, tag, status, the rank's peak GiB, step s, FLOPs a rank,
    collective traffic bytes and seconds, the dominant term; then every
    skip and error with its reason."""
    out = ["| arch | shape | mesh | tag | status | peak GiB | step s | "
           "FLOPs/rank | coll. bytes | coll. s | dominant |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    notes = []
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"],
                                         r.get("tag", ""))):
        head = f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['tag']} | "
        if r["status"] != "ok":
            notes.append(f"{r['arch']} {r['shape']} {r['mesh']} {r['tag']}: "
                         f"{r['status']}: "
                         + r.get("reason", r.get("error", ""))[:300])
            if r["status"] == "error":
                out.append(head + "error (oom)" * bool(r.get("oom"))
                           + "error" * (not r.get("oom")) + " |" * 7)
            continue
        peak = r["memory"]["peak_allocated_bytes"]
        t = r["roofline"]
        out.append(head + "ok | " + ("—" if peak is None
                                     else f"{peak / GIB:.2f}")
                   + f" | {r['step_s']:.4g} | {r['op_cost']['flops']:.3e} | "
                   f"{r['collectives']['total_traffic_bytes']:.3e} | "
                   f"{t['collective_s']:.4g} | {t['dominant']} |")
    return "\n".join(out + [""] + notes) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--decode-unroll", action="store_true",
                    help="recorded only: the port's layers run in a loop")
    ap.add_argument("--capacity-data", action="store_true",
                    help="shard MoE dispatch capacity over the data axis")
    ap.add_argument("--dp-over-model", action="store_true",
                    help="batch also sharded over the model axis")
    ap.add_argument("--moe-replicated-dispatch", action="store_true",
                    help="the reference's empty moe_tokens rule")
    ap.add_argument("--moe-a2a", action="store_true",
                    help="all-to-all expert-parallel dispatch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already recorded ok/skipped")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--summary", action="store_true",
                    help="print the records of --out as a table, and stop")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary_markdown(load_results(args.out)), end="")
        return
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    flags = {f: getattr(args, f) for f in FLAGS}
    tag = args.tag or default_tag(args.fsdp, flags)
    done = set()
    if args.resume:
        done = {(r["arch"], r["shape"], r["mesh"], r.get("tag", "baseline"))
                for r in load_results(args.out)
                if r.get("status") in ("ok", "skipped")}
    ops_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                           "dryrun_ops")
    for arch, shape in cells:
        for mp in meshes:
            if (arch, shape, mesh_name(mp), tag) in done:
                continue
            t0 = time.time()
            try:
                rec = run_cell(arch, shape, mp, fsdp=args.fsdp, tag=args.tag,
                               ops_dir=ops_dir, **flags)
            except Exception as e:  # noqa: BLE001 — recorded, sweep goes on
                rec = failure_record(arch, shape, mesh_name(mp), tag, e, t0)
            free_device_memory()
            print(record_line(rec), flush=True)
            append_result(rec, args.out)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
