"""Public wrappers around the port's CUDA kernels.

Each wrapper checks its inputs (tensor type, floating dtype, rank, matching
widths, one device) and dispatches by the tensors' device. The distance
wrappers first cast to contiguous float32, since float16 inputs go through
the same float32 arithmetic; the attention wrappers hand bf16 and float32
tensors to the kernel as they are, strides and all. By device:

* a CUDA tensor launches the hand-written kernel on the current stream and
  raises if the launch is refused. There is no fallback;
* a CPU tensor runs the plain PyTorch version in ``ref``.

``JoinConfig.use_pallas`` plays no part here. ``LAUNCHES`` counts kernel
launches per wrapper (CPU calls never count), so a run can show that its
path went through the kernels. Every increment goes through
``count_launch``, under one lock: the drain threads of several replicas
launch at once, and a bare ``+=`` on a shared dict can lose counts. The
kernels mask ragged edges themselves, so no wrapper pads. The DiskJoin
engines and the build call only this layer; the LM's attention calls
``gqa_attention``.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import bucket_assign as _assign_kernel
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import pairwise_l2 as _pairwise_kernel
from repro_torch.kernels import ref

# per wrapper; the route counters say which kernel served each call: the
# verify routes count the launches of both distance wrappers, the assign
# routes those of ``bucket_assign``, the flash routes the calls of the
# attention region (one a layer)
LAUNCHES = {"pairwise_l2_threshold": 0, "verify_pairs_batch": 0,
            **{c: 0 for c in _pairwise_kernel.ROUTE_COUNTERS.values()},
            "bucket_assign": 0,
            **{c: 0 for c in _assign_kernel.ROUTE_COUNTERS.values()},
            "flash_attention": 0,
            **{c: 0 for c in _flash_kernel.ROUTE_COUNTERS.values()}}
_LAUNCHES_LOCK = threading.Lock()


def count_launch(*names: str) -> None:
    """Add one to each named counter, all under one lock (called only
    where a CUDA launch happened)."""
    with _LAUNCHES_LOCK:
        for name in names:
            LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches_snapshot() -> dict:
    """A consistent copy of every counter."""
    with _LAUNCHES_LOCK:
        return dict(LAUNCHES)


def eps2_f32(eps: float) -> float:
    """ε² as the kernels compare it: the float64 product rounded once to
    float32 (the rounding the JAX package's programs apply)."""
    return float(np.float32(float(eps) * float(eps)))


def _operand(x, ndim: int, name: str) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if not x.is_floating_point():
        raise TypeError(f"{name} must be floating point, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on unsupported device {x.device}")
    return x.to(torch.float32).contiguous()


def _same_device(*xs: torch.Tensor) -> torch.device:
    dev = xs[0].device
    for x in xs[1:]:
        if x.device != dev:
            raise ValueError(f"operands lie on different devices: "
                             f"{dev} and {x.device}")
    return dev


# ---------------------------------------------------------------------------
# pairwise distance + threshold (DiskJoin verify step)
# ---------------------------------------------------------------------------
def pairwise_l2_threshold(a, b, eps: float):
    """(M, d) × (N, d) → (d2 (M, N) float32, mask (M, N) bool)."""
    a = _operand(a, 2, "a")
    b = _operand(b, 2, "b")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"width mismatch: {a.shape[1]} vs {b.shape[1]}")
    dev = _same_device(a, b)
    eps2 = eps2_f32(eps)
    if dev.type == "cpu":
        return ref.pairwise_l2_threshold(a, b, eps2)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return (torch.empty((a.shape[0], b.shape[0]), device=dev),
                torch.empty((a.shape[0], b.shape[0]), dtype=torch.bool,
                            device=dev))
    d2, mask = _launch_verify(a[None], b[None], eps2)
    count_launch("pairwise_l2_threshold")
    return d2[0], mask[0].view(torch.bool)


def verify_pairs_batch(u, v, eps: float):
    """Batched verify: (E, M, d) × (E, N, d) → (d2, mask), (E, M, N).

    ONE launch for the whole edge batch. Both verify engines call this, so
    host and device compute modes see bitwise-identical d2.
    """
    u = _operand(u, 3, "u")
    v = _operand(v, 3, "v")
    if u.shape[0] != v.shape[0] or u.shape[2] != v.shape[2]:
        raise ValueError(f"batch/width mismatch: {tuple(u.shape)} vs "
                         f"{tuple(v.shape)}")
    dev = _same_device(u, v)
    eps2 = eps2_f32(eps)
    if dev.type == "cpu":
        return ref.pairwise_l2_threshold(u, v, eps2)
    shape = (u.shape[0], u.shape[1], v.shape[1])
    if 0 in shape:
        return (torch.empty(shape, device=dev),
                torch.empty(shape, dtype=torch.bool, device=dev))
    d2, mask = _launch_verify(u, v, eps2)
    count_launch("verify_pairs_batch")
    return d2, mask.view(torch.bool)


def _launch_verify(a: torch.Tensor, b: torch.Tensor, eps2: float):
    """Launch the route ``launch_plan`` picks for (E, M, d) × (E, N, d)
    operands and count it under its route."""
    plan = _pairwise_kernel.launch_plan(a.shape[1], b.shape[1], a.shape[2])
    out = _pairwise_kernel.pairwise_l2_threshold_batched(a, b, eps2, plan)
    count_launch(_pairwise_kernel.ROUTE_COUNTERS[plan.route])
    return out


# ---------------------------------------------------------------------------
# nearest-center assignment (bucketization scan 2)
# ---------------------------------------------------------------------------
def bucket_assign(x, centers):
    """(M, d) × (B, d) → (min_d2 (M,) float32, argmin (M,) int32); ties go
    to the lowest center index."""
    x = _operand(x, 2, "x")
    centers = _operand(centers, 2, "centers")
    if x.shape[1] != centers.shape[1]:
        raise ValueError(f"width mismatch: {x.shape[1]} vs "
                         f"{centers.shape[1]}")
    if centers.shape[0] == 0:
        raise ValueError("bucket_assign needs at least one center")
    dev = _same_device(x, centers)
    if dev.type == "cpu":
        return ref.bucket_assign(x, centers)
    if x.shape[0] == 0:
        return (torch.empty(0, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    return _launch_assign(x, centers)


def _launch_assign(x: torch.Tensor, centers: torch.Tensor):
    """Launch the route ``launch_plan`` picks for (M, d) × (B, d) operands
    and count the call, once in all and once under its route."""
    plan = _assign_kernel.launch_plan(x.shape[0], centers.shape[0],
                                      x.shape[1])
    out = _assign_kernel.bucket_assign(x, centers, plan)
    count_launch("bucket_assign", _assign_kernel.ROUTE_COUNTERS[plan.route])
    return out


# ---------------------------------------------------------------------------
# flash attention (LM substrate)
# ---------------------------------------------------------------------------
def _attn_operand(x, name: str) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if not x.is_floating_point():
        raise TypeError(f"{name} must be floating point, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} must be 4-D, got shape {tuple(x.shape)}")
    return x


def _check_kernel_operands(q, k, v) -> None:
    if not q.dtype == k.dtype == v.dtype or q.dtype not in \
            _flash_kernel.DTYPES:
        raise TypeError(f"the flash kernel takes one dtype of "
                        f"{_flash_kernel.DTYPES}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    d = q.shape[-1]
    if d % 16 or d > _flash_kernel.MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not a multiple of 16 up to "
                         f"{_flash_kernel.MAX_HEAD_DIM}")


def gqa_attention(q, k, v, *, causal: bool, window: int = 0,
                  q_offset: int = 0, kv_positions=None) -> torch.Tensor:
    """Grouped-head attention in the model's layout: q (B, Sq, H, D),
    k/v (B, T, Hkv, D) → (B, Sq, H, D) in q's dtype. Query head h reads KV
    head h // (H / Hkv); ``kv_positions`` (T,) are the keys' absolute
    positions (−1 = empty slot; default ``arange(T)``) and ``q_offset``
    the position of q[:, 0]; ``window > 0`` keeps the trailing ``window``
    keys. The function of the JAX package's ``gqa_scores_chunked``.

    On CUDA, q, k and v share one dtype, float32 or bfloat16, D is a
    multiple of 16 up to 256, and the kernel reads them through their
    strides."""
    q = _attn_operand(q, "q")
    k = _attn_operand(k, "k")
    v = _attn_operand(v, "v")
    b, sq, h, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or k.shape[2] == 0 or h % k.shape[2]):
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    t = k.shape[1]
    if kv_positions is not None and tuple(kv_positions.shape) != (t,):
        raise ValueError(f"kv_positions must be ({t},), got "
                         f"{tuple(kv_positions.shape)}")
    dev = _same_device(q, k, v, *(() if kv_positions is None
                                  else (kv_positions,)))
    if dev.type == "cpu":
        return ref.gqa_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset,
                                 kv_positions=kv_positions)
    _check_kernel_operands(q, k, v)
    if 0 in (b, sq, h, t):
        return torch.zeros((b, sq, h, d), dtype=q.dtype, device=dev)
    if kv_positions is not None:
        kv_positions = kv_positions.to(torch.int32).contiguous()
    return _launch_flash(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, scale=d ** -0.5,
                         kv_positions=kv_positions)


def _launch_flash(q, k, v, **kw) -> torch.Tensor:
    """Launch the route ``launch_plan`` picks for (B, S, H, D) operands and
    count the call, once in all and once under its route."""
    b, sq, h, d = q.shape
    plan = _flash_kernel.launch_plan(b, sq, k.shape[1], h, k.shape[2], d,
                                     q.dtype)
    out = _flash_kernel.flash_attention(q, k, v, plan=plan, **kw)
    count_launch("flash_attention", _flash_kernel.ROUTE_COUNTERS[plan.route])
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, use_pallas: bool = False):
    """q: (B, H, S, D); k/v: (B, H, T, D) → (B, H, S, D) in q's dtype.
    Causal is ``tril(k=T−S)`` (query row i sees keys j ≤ i + T − S), for
    any S and T: the kernel masks ragged and offset shapes itself, so no
    shape is sent elsewhere. ``use_pallas`` is kept for the JAX package's
    signature and chooses nothing: a CUDA tensor launches the kernel (with
    no copy of the transposed layout), a CPU tensor runs ``ref``."""
    del use_pallas
    q = _attn_operand(q, "q")
    k = _attn_operand(k, "k")
    v = _attn_operand(v, "v")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dev = _same_device(q, k, v)
    if dev.type == "cpu":
        return ref.attention(q, k, v, causal=causal, scale=scale)
    _check_kernel_operands(q, k, v)
    b, h, s, t = *q.shape[:3], k.shape[2]
    if 0 in (b, h, s, t):
        return torch.zeros_like(q)
    out = _launch_flash(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=0,
                        q_offset=t - s, scale=scale, kv_positions=None)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# host-side helper for the executor
# ---------------------------------------------------------------------------
def extract_pairs(d2: np.ndarray, mask: np.ndarray,
                  ids_a: np.ndarray, ids_b: np.ndarray,
                  *, upper_triangle: bool = False):
    """mask → (pairs (P,2) int64 original ids, dists (P,) f32)."""
    m = np.asarray(mask)
    if upper_triangle:
        m = np.triu(m, k=1)
    rows, cols = np.nonzero(m)
    if rows.size == 0:
        return np.zeros((0, 2), np.int64), np.zeros(0, np.float32)
    d = np.sqrt(np.asarray(d2)[rows, cols].astype(np.float32))
    pairs = np.stack([ids_a[rows], ids_b[cols]], axis=1).astype(np.int64)
    return pairs, d
