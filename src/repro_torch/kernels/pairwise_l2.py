"""Launch of the batched pairwise squared-L2 + threshold CUDA kernel.

The kernel (``csrc/pairwise_l2.cu``) replaces the JAX package's Pallas
``pairwise_l2_threshold_batched`` and, as its E = 1 launch,
``pairwise_l2_threshold``. Callers go through ``ops``, which checks
inputs, dispatches by device and counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def pairwise_l2_threshold_batched(a: torch.Tensor, b: torch.Tensor,
                                  eps2: float):
    """(E, M, d) × (E, N, d) float32 contiguous CUDA tensors →
    (d2 (E, M, N) float32, mask (E, M, N) int8), launched on the current
    stream. ``eps2`` is passed to the kernel as a float32."""
    e, m, d = a.shape
    n = b.shape[1]
    d2 = torch.empty((e, m, n), dtype=torch.float32, device=a.device)
    mask = torch.empty((e, m, n), dtype=torch.int8, device=a.device)
    lib = _build.load()
    rc = lib.pairwise_l2_threshold_launch(
        a.data_ptr(), b.data_ptr(), d2.data_ptr(), mask.data_ptr(),
        e, m, n, d, eps2, a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_l2_threshold kernel launch failed "
                           f"(cudaError {rc}) at E={e} M={m} N={n} d={d}")
    return d2, mask
