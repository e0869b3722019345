"""Gradient compression with error feedback: a port of the JAX package's
``train/grad_compress.py``.

int8 symmetric quantization with an error-feedback accumulator: the
quantization residual is carried into the next step (Karimireddy et al.,
2019). The reference takes one scale, max |g + e| / 127, per leaf of its
parameter tree, and its decoder-only leaves are stacked over each pattern
group's layers. The port holds one tensor per layer, so the scale is taken
over the same elements: the tensors are grouped by the reference leaf they
came from (``models.convert.reference_leaves``) and share one scale. With
no config, each tensor is its own leaf. ``torch.round`` rounds half to
even, as ``jnp.round`` does.

Usage: ``AdamW(cfg, grad_transform=make_int8_compressor(arch_cfg))``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.convert import reference_leaves


def quantize_int8(xs: list[torch.Tensor]):
    """float32 tensors sharing one scale → (int8 tensors, scale)."""
    amax = torch.stack([torch.max(torch.abs(x)) for x in xs]).max()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    return [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            for x in xs], scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def make_int8_compressor(cfg: ArchConfig | None = None):
    """grad_transform(grads, error) → (decompressed grads, new error), both
    dicts by parameter name; one scale per reference leaf of ``cfg``."""

    def transform(grads: dict, error: dict):
        names = list(grads)
        groups = (reference_leaves(cfg, names) if cfg is not None
                  else [[n] for n in names])
        out, new_error = {}, {}
        for group in groups:
            g32 = [grads[n].to(torch.float32) + error[n] for n in group]
            qs, scale = quantize_int8(g32)
            for n, x, q in zip(group, g32, qs):
                deq = dequantize_int8(q, scale)
                out[n] = deq.to(grads[n].dtype)
                new_error[n] = x - deq
        return out, new_error

    return transform
