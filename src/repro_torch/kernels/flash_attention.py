"""Launch of the grouped-head flash-attention CUDA kernels, which replace
the JAX package's Pallas ``flash_attention`` and compute the model's
attention region (``gqa_scores_chunked``). Three routes, chosen once per
call by ``launch_plan`` from dtype and shape alone:

* ``"split"`` — decode, Sq·g ≤ 16 query rows, bf16 or float32:
  ``csrc/flash_decode.cu``, split-KV in two launches (partials per 64-key
  split into float32 scratch allocated here, then a combine);
* ``"tc"`` — bf16 prefill (Sq·g > 16) at head dims 64, 128 and 256:
  ``csrc/flash_prefill_sm90.cu``, ``wgmma`` on the tensor cores fed by TMA;
* ``"simt"`` — the rest (float32 prefill, bf16 prefill at other head
  dims): ``csrc/flash_attention.cu`` on the CUDA cores.

There is no fallback between routes: a refused launch raises. Callers go
through ``ops``, which checks inputs, dispatches by device and counts
launches.

The gradient, ``flash_attention_bwd``, has one route for every shape and
dtype: ``csrc/flash_backward.cu`` on the CUDA cores, three launches (each
row's softmax statistics and dO·O; dK and dV per key tile; dQ per row
tile) with no atomics. It has no TPU counterpart: the JAX package
differentiates its plain attention."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128, 256)   # flash_prefill_sm90.cu's instantiations
DECODE_MAX_ROWS = 16            # Sq·g at or below which decode splits KV
SPLIT_KEYS = 64                 # keys per split (kSplit in flash_decode.cu)
ROUTE_COUNTERS = {"tc": "flash_prefill_tc", "split": "flash_decode_split",
                  "simt": "flash_simt"}


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
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return LaunchPlan("tc", 8)
    return LaunchPlan("simt", 4)


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
                    plan: LaunchPlan) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, T, Hkv, D) CUDA tensors of one dtype in
    ``DTYPES``, read through their strides; ``kv_positions`` a (T,) int32
    CUDA tensor or None → (B, Sq, H, D) contiguous in q's dtype, launched on
    the current stream by ``plan``'s route. A tensor whose strides the
    route cannot read in place is copied to contiguous first."""
    q, k, v = (x if _aligned(x, plan.align) else x.contiguous()
               for x in (q, k, v))
    b, sq, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
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
        rc = lib.flash_decode_launch(*head, bf16, SPLIT_KEYS, plan.n_splits,
                                     ml.data_ptr(), acc.data_ptr(), device,
                                     stream)
    elif plan.route == "tc":
        rc = lib.flash_prefill_sm90_launch(*head, device, stream)
    else:
        rc = lib.flash_simt_launch(*head, bf16, device, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention {plan.route} kernel launch failed (cudaError "
            f"{rc}) at B={b} Sq={sq} T={t} H={h} Hkv={hkv} D={d} {q.dtype}")
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool, window: int, q_offset: int,
                        scale: float, kv_positions: torch.Tensor | None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention``: q (B, Sq, H, D), k/v
    (B, T, Hkv, D) CUDA tensors of one dtype in ``DTYPES`` (read through
    their strides), ``out`` the forward's output and ``dout`` its gradient
    (B, Sq, H, D) → (dq, dk, dv), contiguous, in q's dtype, launched on the
    current stream (``csrc/flash_backward.cu``). float32 scratch for each
    row's softmax max, sum and dO·O is allocated here."""
    q, k, v = (x if _aligned(x, 4) else _dense(x, 4) for x in (q, k, v))
    out = _dense(out.to(q.dtype), 4)
    dout = _dense(dout.to(q.dtype), 4)
    b, sq, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rows = sq * (h // hkv)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stats = torch.empty((b, hkv, rows, 2), dtype=torch.float32,
                        device=q.device)
    delta = torch.empty((b, hkv, rows), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    pos_ptr = None if kv_positions is None else kv_positions.data_ptr()
    rc = _build.load().flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        pos_ptr, strides, b, sq, t, h, hkv, d, int(causal), int(window),
        int(q_offset), float(scale), int(q.dtype == torch.bfloat16),
        stats.data_ptr(), delta.data_ptr(), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention backward kernel launch failed (cudaError "
            f"{rc}) at B={b} Sq={sq} T={t} H={h} Hkv={hkv} D={d} {q.dtype}")
    return dq, dk, dv
