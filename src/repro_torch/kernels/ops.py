"""Public wrappers around the port's CUDA kernels.

Each wrapper checks its inputs (tensor type, floating dtype, rank, matching
widths, one device), casts them to contiguous float32 — before anything
else, since float16 inputs go through the same float32 arithmetic — and
dispatches by the tensors' device:

* a CUDA tensor launches the hand-written kernel on the current stream and
  raises if the launch is refused. There is no fallback;
* a CPU tensor runs the plain PyTorch version in ``ref``.

``JoinConfig.use_pallas`` plays no part here. ``LAUNCHES`` counts kernel
launches per wrapper (CPU calls never count), so a run can show that its
path went through the kernels. The kernels mask ragged edges themselves,
so no wrapper pads. The DiskJoin engines and the build call only this
layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import bucket_assign as _assign_kernel
from repro_torch.kernels import pairwise_l2 as _pairwise_kernel
from repro_torch.kernels import ref

LAUNCHES = {"pairwise_l2_threshold": 0, "verify_pairs_batch": 0,
            "bucket_assign": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    d2, mask = _pairwise_kernel.pairwise_l2_threshold_batched(
        a[None], b[None], eps2)
    LAUNCHES["pairwise_l2_threshold"] += 1
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
    d2, mask = _pairwise_kernel.pairwise_l2_threshold_batched(u, v, eps2)
    LAUNCHES["verify_pairs_batch"] += 1
    return d2, mask.view(torch.bool)


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
    out = _assign_kernel.bucket_assign(x, centers)
    LAUNCHES["bucket_assign"] += 1
    return out


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
