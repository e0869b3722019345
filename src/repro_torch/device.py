"""Where the port runs: an explicit ``torch.device`` for every entry point.

``None`` means CUDA. Without CUDA an entry point raises instead of quietly
running on the CPU; the plain CPU path runs only when a caller asks for it
with ``device="cpu"`` (the tests do).
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # pinned to a card index here, so threads that serve the session
        # later (a scheduler's drain thread) launch on this card, not on
        # whichever device is current in that thread
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → a tensor of its own on ``device`` (later writes to
    ``x`` never reach it). A CUDA copy goes through pinned
    memory with ``non_blocking=True``: it queues on the current stream and
    never blocks the host behind kernels already in flight (a copy from
    pageable memory may). The caching host allocator keeps the pinned
    buffer alive until the copy has run."""
    if device.type == "cpu":
        return torch.from_numpy(np.array(x))
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory().to(device, non_blocking=True)
