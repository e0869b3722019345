"""Roofline of one H100 over the census records: a port of the JAX
package's ``launch/roofline.py``.

Per (arch × shape) cell, from ``launch/op_cost.py``'s census of one
executed step on the card (``launch/census.py``):

  compute term    = Σ_dtype work FLOPs / that dtype's peak
                    (bf16 on the tensor cores; float32 on the CUDA cores;
                    a 3×TF32 route as three TF32 products)
  memory term     = (counted bytes + one pass over the live arguments)
                    / HBM's rate
  collective term = Σ over the step's collectives of their traffic
                    (``launch/collectives.py``) / the rate of the link the
                    group crosses (``collective_seconds``); 0 on one card

The step-time lower bound is max(terms) (perfect overlap), and

  roofline_fraction = (MODEL_FLOPS / bf16 peak) / max(terms)

with MODEL_FLOPS = 6·N·D (train) or 2·N·D (prefill and decode), N the
active parameters and D the tokens the card ran. Beside these bounds the
record carries what the card did: ``mfu`` = MODEL_FLOPS / (measured step
seconds × bf16 peak) for train and prefill steps, ``bw_share`` =
``bw_floor_s`` / measured step seconds for decode.

Two FLOP counts: ``hlo_flops_per_dev`` (and ``useful_flops_ratio``) is
the dense count, which the CPU census holds to the reference's
``analyze_hlo``; the compute term, ``dominant`` and the fraction are
priced from the work count (``op_cost``'s ``work_flops_by_dtype``), in
which each attention kernel counts only the (query, key) pairs its mask
lets through, so no step can beat its compute term by skipping masked
work.

``kernel_cost`` gives each hand-written kernel's FLOPs, by operand type,
and its bytes (each operand read once, each output written once): the
census adds them at the launch sites, which no dispatch-level counter
sees, and ``chip_smoke.py`` prices its kernel rows with them.

Not ported: the reference's ``flash_kernel_traffic``. It models the bytes
of a Pallas kernel that could not compile on its host; here the kernel
runs, and its cost enters the census from ``kernel_cost`` where it
launches.

    python -m repro_torch.launch.roofline [--results results/census.json]
        [--markdown]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet), at the 700 W limit
PEAK_BF16_FLOPS = 989e12    # bf16 on the tensor cores, dense
PEAK_TF32_FLOPS = 494.7e12  # TF32 on the tensor cores, dense
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3

# Per-GPU link rates of a DGX H100 deployment, one direction: ASSUMPTIONS
# from NVIDIA's DGX H100 datasheet, not measurements (nothing here has run
# across cards). NVLink 4 inside a node of 8 cards; one 400 Gb/s NDR
# InfiniBand port a card across nodes. Which groups lie inside a node is the
# mesh's to say (``launch.mesh.NODE_RANKS``, each entry's ``intra_node``).
LINK_NVLINK_BYTES = 450e9
LINK_IB_BYTES = 50e9

# FLOP classes of a census: a torch dtype's name, or "tf32x3" for products
# that a 3×TF32 kernel route runs as three TF32 products
TF32X3 = "tf32x3"

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
RESULTS = os.path.join(_ROOT, "results", "census.json")
OUT = os.path.join(_ROOT, "results", "census_roofline.json")


def flop_seconds(flops_by_dtype: dict) -> float:
    """Least time of counted FLOPs, each class at its own peak: bf16 and
    float16 at the tensor cores' rate, a 3×TF32 route's products as three
    TF32 products each, every other dtype on the CUDA cores."""
    t = 0.0
    for cls, f in flops_by_dtype.items():
        if cls in ("bfloat16", "float16"):
            t += f / PEAK_BF16_FLOPS
        elif cls == TF32X3:
            t += 3.0 * f / PEAK_TF32_FLOPS
        else:
            t += f / PEAK_F32_FLOPS
    return t


def kernel_bound(cost: dict) -> tuple[float, str]:
    """Least time in ms of one ``kernel_cost``: its FLOPs at their classes'
    peaks or its bytes at HBM's rate, whichever is larger, with which
    ("operations" or "bytes")."""
    t_ops = flop_seconds(cost["flops"])
    t_mem = cost["bytes"] / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def _flop_class(dtype: str, route: str) -> str:
    """bf16 operands run at the bf16 rate on every route; float32 on a
    3×TF32 route (``tc32``, verify's and assign's ``tc``) as three TF32
    products; float32 elsewhere on the CUDA cores."""
    if dtype == "bfloat16":
        return "bfloat16"
    return TF32X3 if route in ("tc", "tc32") else "float32"


_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def attention_counts(sq: int, t: int, *, causal: bool, window: int = 0,
                     q_offset: int = 0, positions=None) -> dict:
    """``kernel_cost``'s mask counts of one attention call, as
    ``kernels/ref.py::gqa_mask`` masks it: ``visible``, the (query, key)
    pairs seen; ``keys``, the keys some query sees; ``pos_bytes``, the
    int32 positions read. ``positions`` is a host array of the T keys'
    positions (−1 an empty slot), None for ``arange(t)``."""
    pos = np.arange(t) if positions is None else np.asarray(positions)
    pos = np.sort(pos[pos >= 0])
    q = q_offset + np.arange(sq)
    hi = (np.searchsorted(pos, q, "right") if causal
          else np.full(sq, len(pos)))
    lo = np.searchsorted(pos, q - window, "right") if window > 0 else 0
    seen = np.ones(len(pos), bool)
    if causal:
        seen &= pos <= q[-1]
    if window > 0:
        seen &= pos > q[0] - window
    return {"visible": int(np.maximum(hi - lo, 0).sum()),
            "keys": int(seen.sum()),
            "pos_bytes": 0 if positions is None else 4 * t}


def kernel_cost(name: str, shape, dtype: str = "float32", route: str = "tc",
                *, visible: int | None = None, keys: int | None = None,
                pos_bytes: int = 0) -> dict:
    """FLOPs by class and bytes of one launch of a hand-written kernel →
    ``{"flops": {class: n}, "bytes": n, "plain_flops": n}``.

    ``flops`` is the work the kernel must do: its products at the class
    ``route`` runs them in. ``plain_flops`` is what the kernel's plain
    version (``kernels/ref.py``) counts on the CPU under
    ``torch.utils.flop_counter``: its dense products, as XLA counts the
    reference's. The two differ only for attention under a mask
    (``visible`` < Sq·T) and for the backward's δ = rowsum(dO∘O).

    * ``"flash_attention"``, shape (B, Sq, T, H, Hkv, D): Q·Kᵀ and P·V over
      the ``visible`` (query, key) pairs (default Sq·T); bytes: Q and O,
      the ``keys`` K/V rows some query sees (default T), and the
      ``pos_bytes`` of the cache positions.
    * ``"flash_attention_bwd"``, the same shape: five products (S, dP, dV,
      dQ, dK); bytes: Q, O, dO and dQ, K and V over the seen keys, dK and
      dV over all T.
    * ``"verify"``, shape (E, M, N, d): the lanes' products; bytes: each
      operand read once, d² (float32) and the mask (one byte) written once.
    * ``"bucket_assign"``, shape (M, B, d): X·Cᵀ; bytes: X and the centers
      read once, (d², index) written once.
    * ``"flash_decode_merge"``, shape (n, B, Sq, H, D): n slices' float32
      outputs weighted and summed (2 FLOPs an element); bytes: the outputs
      and log-sum-exps read once, the merged output written once.
    """
    if name == "flash_decode_merge":
        n, b, sq, h, d = shape
        flops = 2.0 * n * b * sq * h * d
        return {"flops": {"float32": flops},
                "bytes": 4.0 * n * b * sq * h * (d + 1)
                + _ITEMSIZE[dtype] * b * sq * h * d,
                "plain_flops": 0}
    if name in ("flash_attention", "flash_attention_bwd"):
        b, sq, t, h, hkv, d = shape
        visible = sq * t if visible is None else visible
        keys = t if keys is None else keys
        matmul = 2.0 * b * h * d * visible
        dense = 2 * b * h * d * sq * t
        size = _ITEMSIZE[dtype]
        if name == "flash_attention":
            flops = 2.0 * matmul
            plain = 2 * dense
            nbytes = size * (2 * b * sq * h * d + 2 * b * keys * hkv * d) \
                + pos_bytes
        else:
            flops = 5 * matmul
            plain = 5 * dense + 2 * b * sq * h * d
            q_elems, kv_elems = b * sq * h * d, b * hkv * d
            nbytes = size * (4 * q_elems + 2 * kv_elems * keys
                             + 2 * kv_elems * t)
        return {"flops": {_flop_class(dtype, route): flops},
                "bytes": nbytes, "plain_flops": plain}
    if name == "verify":
        e, m, n, d = shape
        return {"flops": {_flop_class("float32", route): 2.0 * e * m * n * d},
                "bytes": 4.0 * e * (m + n) * d + 5.0 * e * m * n,
                "plain_flops": 2 * e * m * n * d}
    if name == "bucket_assign":
        m, b, d = shape
        return {"flops": {_flop_class("float32", route): 2.0 * m * b * d},
                "bytes": 4.0 * (m + b) * d + 8.0 * m,
                "plain_flops": 2 * m * b * d}
    raise KeyError(f"no cost formula for kernel {name!r}")


def collective_seconds(tally: list[dict]) -> float:
    """Least time of a step's collectives (``launch.mesh.Mesh.tally``):
    each op's traffic over the assumed rate of its link (NVLink inside a
    node, InfiniBand across), one after another."""
    from repro_torch.launch.collectives import op_traffic
    return sum(op_traffic(e["kind"], e["bytes"], e["n"])
               / (LINK_NVLINK_BYTES if e["intra_node"] else LINK_IB_BYTES)
               for e in tally)


def model_flops_per_device(rec: dict) -> float:
    n = rec["active_params"]
    tokens = rec["tokens"]
    chips = rec["chips"]
    kind = rec.get("step", "train_step")
    if kind == "train_step":
        total = 6.0 * n * tokens
    else:  # prefill_step / serve_step: forward only
        total = 2.0 * n * tokens
    return total / chips


def roofline_terms(rec: dict) -> dict | None:
    """The roofline of one ``ok`` census record (None otherwise)."""
    if rec.get("status") != "ok" or "op_cost" not in rec:
        return None
    c = rec["op_cost"]
    live = rec.get("live_bytes", 0)
    t_c = flop_seconds(c["work_flops_by_dtype"])
    t_m = (c["bytes"] + max(live, 0)) / PEAK_BYTES
    t_x = rec.get("collective_s", 0.0)   # 0 on one card: no link
    dominant = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
    mf = model_flops_per_device(rec)
    t_model = mf / PEAK_BF16_FLOPS
    denom = max(t_c, t_m, t_x, 1e-30)
    out = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "tag": rec.get("tag", "baseline"), "step": rec.get("step"),
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dominant[1],
        "step_time_lb_s": denom,
        "model_flops_per_dev": mf,
        "hlo_flops_per_dev": c["flops"],
        "useful_flops_ratio": mf / max(c["flops"], 1e-30),
        "roofline_fraction": t_model / denom,
        "mem_bytes_per_dev": rec.get("peak_bytes"),
        "fits_card": rec.get("fits_card"),
    }
    step_s = rec.get("step_s")
    if rec.get("step") == "serve_step":
        # decode streams the live state once at the least: the weights,
        # the caches and the tokens (the argument set)
        floor = live / PEAK_BYTES
        out["bw_floor_s"] = floor
        out["bw_fraction"] = floor / denom if denom > 0 else 0.0
        if step_s:
            out["bw_share"] = floor / step_s
    elif step_s and rec.get("step") in ("train_step", "prefill_step"):
        out["mfu"] = mf / (step_s * PEAK_BF16_FLOPS)
    if step_s is not None:
        out["step_s"] = step_s
    out["note"] = _suggestion(out)
    return out


def _suggestion(t: dict) -> str:
    if t["dominant"] == "compute":
        if t["useful_flops_ratio"] < 0.5:
            return ("compute-bound with low useful-FLOP ratio — cut remat "
                    "recompute / padding waste to move the term down")
        return ("compute-bound near useful FLOPs — gains need lower-"
                "precision matmuls or fewer model FLOPs")
    if t["dominant"] == "memory":
        return ("memory-bound — fuse/retile to raise arithmetic intensity; "
                "check cache/scan buffers for gratuitous HBM round-trips")
    return ("collective-bound — reshard to shrink cross-device traffic or "
            "overlap collectives behind compute (async/latency-hiding)")


def analyze_records(rows: list[dict]) -> list[dict]:
    """Each ``ok`` record's terms; a skipped one passes through with its
    reason, as the reference's ``analyze`` does (a failed or partial one
    is left out: ``census.py`` lists those)."""
    out = []
    for rec in rows:
        t = roofline_terms(rec)
        if t is not None:
            out.append(t)
        elif rec.get("status") == "skipped":
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": rec["mesh"], "status": "skipped",
                        "reason": rec.get("reason", "")})
    return out


def analyze(path: str = RESULTS) -> list[dict]:
    with open(path) as f:
        return analyze_records(json.load(f))


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | step | compute(s) | memory(s) | dominant | "
           "MODEL/counted | roofline frac | step(s) | mfu / bw share | "
           "fits |\n|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if "dominant" not in r:
            lines.append(f"| {r['arch']} | {r['shape']} | skipped — "
                         f"{r['reason'][:80]} |" + " |" * 8)
            continue
        share = r.get("mfu", r.get("bw_share"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['step']} | "
            f"{r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_flops_ratio']:.3f} | "
            f"{r['roofline_fraction']:.3f} | "
            + (f"{r['step_s']:.4g}" if "step_s" in r else "—") + " | "
            + (f"{share:.3f}" if share is not None else "—") + " | "
            + ("y" if r["fits_card"] else "N") + " |")
    return hdr + "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    rows = analyze(args.results)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    if args.markdown:
        print(to_markdown(rows))
    else:
        for r in rows:
            if "dominant" in r:
                print(f"{r['arch']:20s} {r['shape']:12s} "
                      f"{r['dominant']:10s} frac={r['roofline_fraction']:.3f}"
                      f" useful={r['useful_flops_ratio']:.2f}")


if __name__ == "__main__":
    main()
