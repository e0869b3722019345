"""Launch of the fused nearest-center CUDA kernel (``csrc/bucket_assign.cu``),
which replaces the JAX package's Pallas ``bucket_assign``. Callers go
through ``ops``, which checks inputs, dispatches by device and counts
launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def bucket_assign(x: torch.Tensor, centers: torch.Tensor):
    """(M, d) × (B, d) float32 contiguous CUDA tensors →
    (min_d2 (M,) float32, argmin (M,) int32), launched on the current
    stream."""
    m, d = x.shape
    b = centers.shape[0]
    mind2 = torch.empty(m, dtype=torch.float32, device=x.device)
    idx = torch.empty(m, dtype=torch.int32, device=x.device)
    lib = _build.load()
    rc = lib.bucket_assign_launch(
        x.data_ptr(), centers.data_ptr(), mind2.data_ptr(), idx.data_ptr(),
        m, b, d, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bucket_assign kernel launch failed "
                           f"(cudaError {rc}) at M={m} B={b} d={d}")
    return mind2, idx
