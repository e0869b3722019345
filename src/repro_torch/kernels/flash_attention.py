"""Launch of the grouped-head flash-attention CUDA kernels, which replace
the JAX package's Pallas ``flash_attention`` and compute the model's
attention region (``gqa_scores_chunked``). Four routes, chosen once per
call by ``launch_plan`` from dtype and shape alone:

* ``"split"`` — decode, Sq·g ≤ 16 query rows, bf16 or float32:
  ``csrc/flash_decode.cu``, split-KV in two launches (partials per 64-key
  split into float32 scratch allocated here, then a combine); with
  ``with_lse`` the combine also writes each row's log-sum-exp and the
  output in float32, for ``decode_merge``: the merge of the slices of a
  cache split over ranks, which is the combine launch alone;
* ``"tc"`` — bf16 prefill (Sq·g > 16) at head dims 64, 128 and 256:
  ``csrc/flash_prefill_sm90.cu``, ``wgmma`` on the tensor cores fed by TMA;
* ``"tc32"`` — float32 prefill at head dims 64, 128 and 256:
  ``csrc/flash_prefill_sm90_f32.cu``, TF32 ``wgmma`` with every float32
  operand split into two TF32 halves (3×TF32) and partial sums, fed by TMA;
* ``"simt"`` — the rest (prefill at other head dims, either dtype):
  ``csrc/flash_attention.cu`` on the CUDA cores.

There is no fallback between routes: a refused launch raises. Callers go
through ``ops``, which checks inputs, dispatches by device and counts
launches.

The gradient, ``flash_attention_bwd``, takes one of three routes, chosen
once per call by ``bwd_launch_plan``:

* ``"tc"`` — bf16 at head dims 64, 128 and 256:
  ``csrc/flash_backward_sm90.cu``, ``wgmma`` on the tensor cores with P
  and dS split into two bf16 halves; three launches (each row's softmax
  statistics and dO·O; dK and dV per key tile, its row walk split where
  the key tiles alone would not fill the card; dQ per row tile), and a
  fourth that sums the splits' float32 partials in a fixed order;
* ``"tc32"`` — float32 at head dims 64, 128 and 256:
  ``csrc/flash_backward_sm90_f32.cu``, TF32 ``wgmma`` at 3×TF32 with
  partial sums; the same launches (statistics; dK and dV per key tile,
  split where the first route splits; dQ per row tile; the sum of the
  splits);
* ``"simt"`` — the rest (either dtype at other head dims):
  ``csrc/flash_backward.cu`` on the CUDA cores, the same three launches.

None uses atomics, so two calls give the same bits. The gradient has no
TPU counterpart: the JAX package differentiates its plain attention."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128, 256)   # the tensor-core kernels' instantiations
DECODE_MAX_ROWS = 16            # Sq·g at or below which decode splits KV
SPLIT_KEYS = 64                 # keys per split (kSplit in flash_decode.cu)
ROUTE_COUNTERS = {"tc": "flash_prefill_tc", "tc32": "flash_prefill_tc32",
                  "split": "flash_decode_split", "simt": "flash_simt"}
BWD_ROUTE_COUNTERS = {"tc": "flash_bwd_tc", "tc32": "flash_bwd_tc32",
                      "simt": "flash_bwd_simt"}
# the tensor-core route of each dtype and the element alignment it reads
# strides at (16 bytes: TMA's rule)
TC_ROUTES = {torch.bfloat16: ("tc", 8), torch.float32: ("tc32", 4)}
BWD_TILE = 64       # rows and keys a tile in flash_backward_sm90.cu (kTile)
SM_COUNT = 132      # an H100 SXM's SMs: the dK/dV grid the split aims for


@dataclass(frozen=True)
class LaunchPlan:
    """How one attention call launches: its route, the element alignment
    the route reads strides at (16 bytes for TMA and the decode loads, 4
    elements for the CUDA-core kernel), and for the split route the split
    count and the float32 scratch shapes, (B, Hkv, splits, Sq·g, 2) for
    (m, l) and (B, Hkv, splits, Sq·g, D) for the partial sums."""
    route: str
    align: int
    n_splits: int = 0
    ml_shape: tuple[int, ...] = ()
    acc_shape: tuple[int, ...] = ()


def launch_plan(b: int, sq: int, t: int, h: int, hkv: int, d: int,
                dtype: torch.dtype) -> LaunchPlan:
    """The route and launch sizes for q (b, sq, h, d) against k/v
    (b, t, hkv, d) of ``dtype``; a pure function of ints and a dtype."""
    rows = sq * (h // hkv)
    if rows <= DECODE_MAX_ROWS:
        n = -(-t // SPLIT_KEYS)
        return LaunchPlan("split", 16 // dtype.itemsize, n,
                          (b, hkv, n, rows, 2), (b, hkv, n, rows, d))
    if d in TC_HEAD_DIMS:
        return LaunchPlan(*TC_ROUTES[dtype])
    return LaunchPlan("simt", 4)


@dataclass(frozen=True)
class BwdLaunchPlan:
    """How one attention backward call launches: its route, the element
    alignment the route reads strides at (16 bytes for TMA and the 16-byte
    copies, 4 elements for the CUDA-core kernel), the number of parts the
    dK/dV row walk is split into, and the float32 scratch shapes:
    (B, Hkv, Sq·g, 2) for each row's (m, l), (B, Hkv, Sq·g) for dO·O, and
    (n_split, B, T, Hkv, D) for each of the partial dK and dV (empty when
    the walk is not split)."""
    route: str
    align: int
    n_split: int
    stats_shape: tuple[int, ...]
    delta_shape: tuple[int, ...]
    part_shape: tuple[int, ...] = ()


def bwd_launch_plan(b: int, sq: int, t: int, h: int, hkv: int, d: int,
                    dtype: torch.dtype) -> BwdLaunchPlan:
    """The backward's route and launch sizes for q (b, sq, h, d) against
    k/v (b, t, hkv, d) of ``dtype``; a pure function of ints and a dtype.
    On the tensor-core routes (``tc``, ``tc32``), where the dK/dV grid (one
    block per 64-key tile, KV head and batch) is under ``SM_COUNT`` blocks,
    each key tile's row walk is split into the fewest parts that bring the
    grid to ``SM_COUNT``, and at most one part per 64-row tile."""
    rows = sq * (h // hkv)
    stats, delta = (b, hkv, rows, 2), (b, hkv, rows)
    if d in TC_HEAD_DIMS:
        blocks = b * hkv * -(-t // BWD_TILE)
        n = 1 if blocks >= SM_COUNT else min(-(-SM_COUNT // blocks),
                                             -(-rows // BWD_TILE))
        return BwdLaunchPlan(*TC_ROUTES[dtype], n, stats, delta,
                             (n, b, t, hkv, d) if n > 1 else ())
    return BwdLaunchPlan("simt", 4, 1, stats, delta)


def _check_route(route: str, q: torch.Tensor) -> None:
    """A tensor-core route takes only its dtype at ``TC_HEAD_DIMS``: raise
    before any launch otherwise."""
    takes = {r: dt for dt, (r, _) in TC_ROUTES.items()}
    if route in takes and (q.dtype != takes[route]
                           or q.shape[-1] not in TC_HEAD_DIMS):
        raise ValueError(f"the {route} route takes {takes[route]} at head "
                         f"dims {TC_HEAD_DIMS}, got {q.dtype} at "
                         f"{q.shape[-1]}")


def _aligned(x: torch.Tensor, elems: int) -> bool:
    """The last dimension dense, every other stride and the base address a
    multiple of ``elems`` elements."""
    return (x.stride(-1) == 1
            and all(s % elems == 0 for s in x.stride()[:-1])
            and x.data_ptr() % (elems * x.element_size()) == 0)


def _dense(x: torch.Tensor, elems: int) -> torch.Tensor:
    """x contiguous with its base aligned to ``elems`` elements (a copy of
    its own where it is not)."""
    if x.is_contiguous() and x.data_ptr() % (elems * x.element_size()) == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, q_offset: int, scale: float,
                    kv_positions: torch.Tensor | None,
                    plan: LaunchPlan, with_lse: bool = False):
    """q (B, Sq, H, D), k/v (B, T, Hkv, D) CUDA tensors of one dtype in
    ``DTYPES``, read through their strides; ``kv_positions`` a (T,) int32
    CUDA tensor or None → (B, Sq, H, D) contiguous in q's dtype, launched on
    the current stream by ``plan``'s route. A tensor whose strides the
    route cannot read in place is copied to contiguous first. With
    ``with_lse`` (the ``split`` route only) → (out in float32, lse
    (B, Sq, H) float32)."""
    _check_route(plan.route, q)
    if with_lse and plan.route != "split":
        raise ValueError(f"the log-sum-exp comes from the split route, "
                         f"not {plan.route}")
    q, k, v = (x if _aligned(x, plan.align) else x.contiguous()
               for x in (q, k, v))
    b, sq, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=torch.float32 if with_lse
                      else q.dtype, device=q.device)
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    pos_ptr = None if kv_positions is None else kv_positions.data_ptr()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            pos_ptr, strides, b, sq, t, h, hkv, d, int(causal), int(window),
            int(q_offset), float(scale))
    device = q.device.index
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _build.load()
    if plan.route == "split":
        ml = torch.empty(plan.ml_shape, dtype=torch.float32, device=q.device)
        acc = torch.empty(plan.acc_shape, dtype=torch.float32,
                          device=q.device)
        rc = lib.flash_decode_launch(
            *head, bf16, SPLIT_KEYS, plan.n_splits, ml.data_ptr(),
            acc.data_ptr(), None if lse is None else lse.data_ptr(),
            int(with_lse), device, stream)
    elif plan.route == "tc":
        rc = lib.flash_prefill_sm90_launch(*head, device, stream)
    elif plan.route == "tc32":
        rc = lib.flash_prefill_sm90_f32_launch(*head, device, stream)
    else:
        rc = lib.flash_simt_launch(*head, bf16, device, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention {plan.route} kernel launch failed (cudaError "
            f"{rc}) at B={b} Sq={sq} T={t} H={h} Hkv={hkv} D={d} {q.dtype}")
    return (out, lse) if with_lse else out


def decode_merge(outs: torch.Tensor, lses: torch.Tensor,
                 dtype: torch.dtype, hkv: int) -> torch.Tensor:
    """n slices' outputs (n, B, Sq, H, D) and log-sum-exps (n, B, Sq, H),
    float32 CUDA tensors from ``flash_attention(..., with_lse=True)`` →
    (B, Sq, H, D) contiguous in ``dtype``, by the combine launch of
    ``csrc/flash_decode.cu`` over the slices laid out as its splits
    ((lse, 1) and the output: a copy in torch of n·B·Sq·H·(D + 2)
    floats)."""
    n, b, sq, h, d = outs.shape
    g = h // hkv
    # (n, B, Sq, Hkv, g, ·) → (B, Hkv, n, Sq, g, ·): the splits' layout
    acc = outs.reshape(n, b, sq, hkv, g, d).permute(1, 3, 0, 2, 4, 5) \
        .contiguous()
    ml = torch.stack([lses, torch.ones_like(lses)], dim=-1).reshape(
        n, b, sq, hkv, g, 2).permute(1, 3, 0, 2, 4, 5).contiguous()
    out = torch.empty((b, sq, h, d), dtype=dtype, device=outs.device)
    rc = _build.load().flash_decode_merge_launch(
        ml.data_ptr(), acc.data_ptr(), out.data_ptr(), b, sq, h, hkv, d, n,
        int(dtype == torch.bfloat16), outs.device.index,
        torch.cuda.current_stream(outs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash decode merge launch failed (cudaError "
                           f"{rc}) at n={n} B={b} Sq={sq} H={h} D={d}")
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool, window: int, q_offset: int,
                        scale: float, kv_positions: torch.Tensor | None,
                        plan: BwdLaunchPlan
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention``: q (B, Sq, H, D), k/v
    (B, T, Hkv, D) CUDA tensors of one dtype in ``DTYPES`` (read through
    their strides), ``out`` the forward's output and ``dout`` its gradient
    (B, Sq, H, D) → (dq, dk, dv), contiguous, in q's dtype, launched on the
    current stream by ``plan``'s route. The float32 scratch (each row's
    softmax max, sum and dO·O; the split walk's partial dK and dV) is
    allocated here."""
    _check_route(plan.route, q)
    q, k, v = (x if _aligned(x, plan.align) else _dense(x, plan.align)
               for x in (q, k, v))
    out = _dense(out.to(q.dtype), plan.align)
    dout = _dense(dout.to(q.dtype), plan.align)
    b, sq, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stats = torch.empty(plan.stats_shape, dtype=torch.float32,
                        device=q.device)
    delta = torch.empty(plan.delta_shape, dtype=torch.float32,
                        device=q.device)
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    pos_ptr = None if kv_positions is None else kv_positions.data_ptr()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            pos_ptr, strides, b, sq, t, h, hkv, d, int(causal), int(window),
            int(q_offset), float(scale))
    device = q.device.index
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _build.load()
    if plan.route in ("tc", "tc32"):
        parts = (torch.empty((2, *plan.part_shape), dtype=torch.float32,
                             device=q.device) if plan.part_shape else None)
        fn = (lib.flash_bwd_sm90_launch if plan.route == "tc"
              else lib.flash_bwd_sm90_f32_launch)
        rc = fn(*head, plan.n_split, stats.data_ptr(), delta.data_ptr(),
                None if parts is None else parts[0].data_ptr(),
                None if parts is None else parts[1].data_ptr(), device,
                stream)
    else:
        rc = lib.flash_bwd_launch(
            *head, int(q.dtype == torch.bfloat16), stats.data_ptr(),
            delta.data_ptr(), device, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention backward {plan.route} kernel launch failed "
            f"(cudaError {rc}) at B={b} Sq={sq} T={t} H={h} Hkv={hkv} D={d} "
            f"{q.dtype}")
    return dq, dk, dv
