"""Census of one card: the counterpart of the JAX package's
``launch/dryrun.py``.

The reference lowers and compiles each (architecture × input shape) cell
on its 256- and 512-chip meshes and reads the compiled artifact's memory
and cost. PyTorch has no compiled artifact to read, so the census runs
the cell on one card instead, at its published widths and full depth:

1. ``shape_applicable`` first: the reference's design skips (7 of 40).
2. The static byte reckoning: the weights (for training also the
   gradients and AdamW's float32 μ and ν), plus the caches for decode. A
   cell above the card's memory is recorded ``skipped`` with a reason that
   starts ``exceeds one card:``; a census on a mesh takes these up
   (ROADMAP §1).
3. The run (``steps.prepare_cell``, per-card batch ``global_batch //
   256``, at least one sequence): one warm-up step; one step under
   ``op_cost.OpCost`` (FLOPs and bytes, the hand-written kernels' from
   their launch sites); 5 timed warm steps (median ``step_s``, the
   device synchronised); one step under ``torch.profiler`` (``device_s``
   and the 10 top kernels); ``peak_bytes`` from
   ``torch.cuda.max_memory_allocated`` after a reset.

Records carry the reference's fields (``params``, ``active_params``,
``tokens``, ``chips`` = 1, ``mesh`` = "1", ``step``) and ``pod_batch``
(the reference's global batch), the card's name, power limit and memory,
and ``roofline`` (``roofline.roofline_terms``). They are appended to
``results/census.json`` (``--out``) with an atomic replace, one cell at a
time, so a call cut short keeps what it finished; ``--resume`` skips the
cells recorded ``ok`` or ``skipped``.

``run_cell`` raises on a failure. The CLI records it as ``status =
"error"`` (an out-of-memory one with its message), frees the cell's
memory and goes on, as the reference's sweep does.

    python -m repro_torch.launch.census --arch qwen3-0.6b --shape train_4k
    python -m repro_torch.launch.census --all [--resume] [--out PATH]
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import time
import traceback

import torch

from repro_torch.configs import (ARCHS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.launch import roofline
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.steps import per_card_batch, prepare_cell
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.transformer import init_block_cache, layer_kinds

RESULTS = roofline.RESULTS
GIB = 2 ** 30
TIMED_STEPS = 5
TOP_KERNELS = 10
SEED = 0        # of the generator that fills a cell's inputs
# the card whose memory a CPU run reckons against: one H100 80GB HBM3
NOMINAL_CARD_BYTES = 80 * GIB


def card_info(device: torch.device) -> dict:
    """The card's name, power limit (``nvidia-smi``) and memory; on the
    CPU, the nominal H100 80GB the static reckoning is held to."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None,
                "total_memory": NOMINAL_CARD_BYTES}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    index = device.index or 0
    name, power = (smi[min(index, len(smi) - 1)].rsplit(",", 1) + [""])[:2]
    return {"name": name.strip(), "power_limit": power.strip(),
            "total_memory": torch.cuda.get_device_properties(
                device).total_memory}


def tree_bytes(x) -> int:
    """Bytes of the tensors in ``x``: a tensor, a module's parameters, or
    dicts, lists and tuples of them."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, torch.nn.Module):
        return sum(tree_bytes(p) for p in x.parameters())
    if isinstance(x, dict):
        return sum(tree_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(tree_bytes(v) for v in x)
    return 0


def cache_bytes(cfg: ArchConfig, batch: int, max_seq: int) -> int:
    """Bytes of the decode caches ``init_cache`` allocates, reckoned on
    the meta device (nothing allocated)."""
    meta = torch.device("meta")
    if cfg.enc_dec:
        per_layer = tree_bytes(L.init_attn_cache(cfg, batch, max_seq,
                                                 device=meta))
        cross = 2 * batch * cfg.encoder.n_frames * cfg.n_kv_heads \
            * cfg.head_dim * L.dtype_of(cfg).itemsize
        return cfg.n_layers * (per_layer + cross)
    return sum(tree_bytes(init_block_cache(cfg, kind, batch, max_seq, meta))
               for kind in layer_kinds(cfg))


def static_bytes(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """What the cell must hold before any activation: the weights at the
    parameter dtype; for training also the gradients (the same dtype) and
    AdamW's float32 μ and ν; for decode the caches of the full sequence."""
    n = cfg.param_count()
    size = L.dtype_of(cfg).itemsize
    out = {"weights": n * size}
    if shape.kind == "train":
        out["gradients"] = n * size
        out["adamw"] = 8 * n
    if shape.kind == "decode":
        out["caches"] = cache_bytes(cfg, per_card_batch(shape),
                                    shape.seq_len)
    out["total"] = sum(out.values())
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(step, args, device: torch.device) -> dict:
    """One step under ``torch.profiler``: the device's kernel time and the
    top kernels by it (CUDA); on the CPU, no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return {"device_s": None, "top_kernels": []}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*args)
        _sync(device)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {"device_s": sum(r[1] for r in rows) / 1e6,
            "top_kernels": [{"name": k[:120], "ms": us / 1e3, "count": c}
                            for k, us, c in rows[:TOP_KERNELS]]}


def measure(step, args, device: torch.device) -> dict:
    """The run of one cell's step (module docstring, step 3) → its record
    fields: ``op_cost``, ``step_s`` (median of TIMED_STEPS),
    ``step_times_s``, ``device_s``, ``top_kernels``, ``peak_bytes`` and
    ``steps_run`` (the step calls made: warm-up, census, timed,
    profiled)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step(*args)
    _sync(device)
    with OpCost() as oc:
        step(*args)
        _sync(device)
    times = []
    for _ in range(TIMED_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        step(*args)
        _sync(device)
        times.append(time.perf_counter() - t0)
    out = {"op_cost": oc.summary(), "step_s": statistics.median(times),
           "step_times_s": times, **_profile(step, args, device),
           "steps_run": TIMED_STEPS + 3}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else None)
    return out


def tokens_of(shape: ShapeSpec) -> int:
    """Tokens one card runs a step: per-card sequences × sequence length
    (decode: one token a sequence)."""
    b = per_card_batch(shape)
    return b if shape.kind == "decode" else b * shape.seq_len


def run_cell(arch: str, shape_name: str, *, device=None,
             tag: str = "") -> dict:
    """One cell's census record (module docstring). Raises on a
    failure."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": "1",
                 "tag": tag or "baseline", "chips": 1}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    device = resolve_device(device)
    card = card_info(device)
    static = static_bytes(cfg, shape)
    rec.update(card=card["name"], power_limit=card["power_limit"],
               card_bytes=card["total_memory"], params=cfg.param_count(),
               active_params=cfg.active_param_count(),
               tokens=tokens_of(shape), pod_batch=shape.global_batch,
               per_card_batch=per_card_batch(shape), static_bytes=static)
    if static["total"] > card["total_memory"]:
        parts = ", ".join(f"{k} {v / GIB:.1f}" for k, v in static.items()
                          if k != "total")
        rec.update(status="skipped", reason=(
            f"exceeds one card: {static['total'] / GIB:.1f} GiB ({parts}) "
            f"against the card's {card['total_memory'] / GIB:.1f} GiB"))
        return rec
    t0 = time.time()
    bundle = build_model(cfg, device=device)
    gen = torch.Generator().manual_seed(SEED)
    step, args, info = prepare_cell(bundle, shape, device=device,
                                    generator=gen)
    rec.update(step=info["kind"], live_bytes=tree_bytes(args),
               **measure(step, args, device))
    del step, args, bundle
    rec["fits_card"] = (rec["peak_bytes"] or static["total"]) \
        <= card["total_memory"]
    rec.update(status="ok", elapsed_s=round(time.time() - t0, 1))
    rec["roofline"] = roofline.roofline_terms(rec)
    return rec


def record_line(rec: dict) -> str:
    """One log line of a record."""
    head = f"[census] {rec['arch']} {rec['shape']}"
    if rec["status"] != "ok":
        return f"{head}: {rec['status']}: " + rec.get(
            "reason", rec.get("error", ""))
    r = rec["roofline"]
    share = (f"mfu {r['mfu']:.4f}" if "mfu" in r
             else f"bw_share {r['bw_share']:.4f}" if "bw_share" in r
             else "no mfu")
    peak = rec["peak_bytes"]
    return (f"{head} {rec['step']}: batch "
            f"{rec.get('per_card_batch', '-')}, tokens {rec['tokens']}, "
            f"counted flops {r['hlo_flops_per_dev']:.4e} (work "
            f"{rec['op_cost']['work_flops']:.4e}), model flops "
            f"{r['model_flops_per_dev']:.4e} (useful "
            f"{r['useful_flops_ratio']:.4f}), compute {r['compute_s']:.4e} "
            f"s, memory {r['memory_s']:.4e} s, dominant {r['dominant']}, "
            f"roofline fraction {r['roofline_fraction']:.4f}; step "
            f"{rec['step_s']:.6f} s, {share}, device "
            + ("n/a" if rec["device_s"] is None
               else f"{rec['device_s']:.6f} s")
            + ", peak " + ("n/a" if peak is None else f"{peak / GIB:.2f} GiB")
            + f", fits {rec['fits_card']}")


def load_results(path: str = RESULTS) -> list[dict]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def append_result(rec: dict, path: str = RESULTS) -> None:
    """Replace the record of the same (arch, shape, mesh, tag) in ``path``
    and write the file atomically (a temporary file, then ``os.replace``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rows = [r for r in load_results(path)
            if not (r["arch"] == rec["arch"] and r["shape"] == rec["shape"]
                    and r["mesh"] == rec["mesh"]
                    and r.get("tag") == rec.get("tag"))]
    rows.append(rec)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rows, f, indent=1)
    os.replace(tmp, path)


def free_device_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def summary_markdown(rows: list[dict]) -> str:
    """``roofline.to_markdown`` of the records, then every skip and error
    with its reason."""
    out = roofline.to_markdown(roofline.analyze_records(rows))
    for r in rows:
        if r.get("status") == "error":
            out += f"\nerror: {r['arch']} {r['shape']}: {r['error']}"
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already recorded ok/skipped")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    tag = args.tag or "baseline"
    done = set()
    if args.resume:
        done = {(r["arch"], r["shape"], r.get("tag", "baseline"))
                for r in load_results(args.out)
                if r.get("status") in ("ok", "skipped")}
    for arch, shape in cells:
        if (arch, shape, tag) in done:
            continue
        t0 = time.time()
        try:
            rec = run_cell(arch, shape, tag=args.tag)
        except Exception as e:  # noqa: BLE001 — recorded, the sweep goes on
            rec = {"arch": arch, "shape": shape, "mesh": "1", "tag": tag,
                   "chips": 1, "status": "error",
                   "error": f"{type(e).__name__}: {e}"[:2000],
                   "trace": traceback.format_exc()[-2000:],
                   "elapsed_s": round(time.time() - t0, 1)}
        free_device_memory()
        print(record_line(rec), flush=True)
        append_result(rec, args.out)
    print(summary_markdown(load_results(args.out)), flush=True)


if __name__ == "__main__":
    main()
