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
even, as ``jnp.round`` does. Under an ambient mesh (``dist.sharding.
set_mesh``) the gradients are this rank's parts, and each leaf's max is
taken over the mesh.

Usage: ``AdamW(cfg, grad_transform=make_int8_compressor(arch_cfg))``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import current_mesh
from repro_torch.models.convert import reference_leaves


def _amax(xs: list[torch.Tensor]) -> torch.Tensor:
    """max |x| over tensors (an empty part, held by another rank, adds 0)."""
    return torch.stack([torch.max(torch.abs(x)) if x.numel()
                        else x.new_zeros(()) for x in xs]).max()


def quantize_int8(xs: list[torch.Tensor], amax=None):
    """float32 tensors sharing one scale → (int8 tensors, scale); ``amax``
    (default: theirs) sets the scale."""
    amax = _amax(xs) if amax is None else amax
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
        g32s = [[grads[n].to(torch.float32) + error[n] for n in group]
                for group in groups]
        amaxes = torch.stack([_amax(g32) for g32 in g32s])
        mesh = current_mesh()
        if mesh is not None:   # parts of a sharded leaf: the mesh's max
            amaxes = mesh.all_reduce(amaxes, mesh.axis_names, op="max")
        out, new_error = {}, {}
        for group, g32, amax in zip(groups, g32s, amaxes):
            qs, scale = quantize_int8(g32, amax)
            for n, x, q in zip(group, g32, qs):
                deq = dequantize_int8(q, scale)
                out[n] = deq.to(grads[n].dtype)
                new_error[n] = x - deq
        return out, new_error

    return transform
