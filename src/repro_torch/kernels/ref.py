"""Plain PyTorch versions of the port's kernels, in float32.

They compute what the CUDA kernels compute and are what a CPU tensor runs
(``ops`` dispatches by device); ``chip_smoke.py`` holds each kernel against
them on the card. Counterparts of the JAX package's ``kernels/ref.py``.
"""
from __future__ import annotations

import torch


def pairwise_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances: (..., M, d) × (..., N, d) → (..., M, N) f32."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    d2 = a2 - 2.0 * (a @ b.transpose(-1, -2)) + b2.transpose(-1, -2)
    return torch.clamp_min(d2, 0.0)


def pairwise_l2_threshold(a: torch.Tensor, b: torch.Tensor, eps2: float):
    """(d2, mask) with mask = d2 ≤ eps² (eps2 compared in float32)."""
    d2 = pairwise_l2(a, b)
    return d2, d2 <= eps2


def bucket_assign(x: torch.Tensor, centers: torch.Tensor):
    """Nearest center: (M, d) × (B, d) → (min_d2 (M,), argmin (M,) int32).
    ``torch.argmin`` returns the first minimum, so ties go to the lowest
    center index, as in the kernel."""
    d2 = pairwise_l2(x, centers)
    idx = torch.argmin(d2, dim=1)
    mind2 = torch.gather(d2, 1, idx[:, None])[:, 0]
    return mind2, idx.to(torch.int32)
