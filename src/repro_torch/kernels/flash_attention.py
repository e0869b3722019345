"""Launch of the grouped-head flash-attention CUDA kernel
(``csrc/flash_attention.cu``), which replaces the JAX package's Pallas
``flash_attention`` and computes the model's attention region
(``gqa_scores_chunked``). Callers go through ``ops``, which checks inputs,
dispatches by device and counts launches."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def _aligned(x: torch.Tensor) -> bool:
    """The kernel reads 4 elements at a time: the last dimension must be
    dense and every other stride and the base address a multiple of 4
    elements."""
    return (x.stride(-1) == 1
            and all(s % 4 == 0 for s in x.stride()[:-1])
            and x.data_ptr() % (4 * x.element_size()) == 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, q_offset: int, scale: float,
                    kv_positions: torch.Tensor | None) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, T, Hkv, D) CUDA tensors of one dtype in
    ``DTYPES``, read through their strides; ``kv_positions`` a (T,) int32
    CUDA tensor or None → (B, Sq, H, D) contiguous in q's dtype, launched on
    the current stream. A tensor whose strides the kernel cannot read in
    place is copied to contiguous first."""
    q, k, v = (x if _aligned(x) else x.contiguous() for x in (q, k, v))
    b, sq, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    pos_ptr = None if kv_positions is None else kv_positions.data_ptr()
    lib = _build.load()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), pos_ptr,
        strides, b, sq, t, h, hkv, d, int(causal), int(window),
        int(q_offset), float(scale), int(q.dtype == torch.bfloat16),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed (cudaError {rc}) at "
            f"B={b} Sq={sq} T={t} H={h} Hkv={hkv} D={d} {q.dtype}")
    return out
