"""Shared transformer layers: norms, RoPE, SwiGLU MLP, GQA attention.

Port of the JAX package's ``models/layers.py``. Parameters live in
``nn.Module``s (weights stored (in, out), applied as ``x @ w``, as the
reference stores them, so ``convert.params_from_jax`` copies them as they
are); the math is plain functions. Dtypes: parameters in
``cfg.param_dtype``, activations in the same dtype, with float32 norm and
RoPE internals. Attention goes through ``kernels.ops.gqa_attention``: the
flash kernel on CUDA, its plain version on the CPU. The reference's
``shard(...)`` annotations are the identity on one card and are dropped.
Parameters are built without ``requires_grad``, so serving builds no graph;
the training entry points (``launch.steps.make_train_step``) turn it on,
and attention then runs under autograd with the backward kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


# ---------------------------------------------------------------------------
# init helpers (a seeded torch.Generator in place of jax.random keys)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    scale = 1.0 / np.sqrt(in_dim)
    return (torch.randn((in_dim, out_dim), generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    # std d^-0.5: unit-variance inputs after the sqrt(d) embedding scale,
    # and O(1) logits through the tied head
    return (torch.randn((vocab, dim), generator=gen, device=device,
                        dtype=torch.float32) / np.sqrt(dim)).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm: scales by (1 + scale), scale initialised to ones (as the
# reference does)
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.scale = _param(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


# ---------------------------------------------------------------------------
# RoPE (standard / half-dim "2d" GLM style), interleaved even/odd pairs
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, rope_dim: int,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, rope_dim, 2, dtype=torch.float32,
                            device=device) / rope_dim
    return 1.0 / (theta ** exponent)                       # (rope_dim/2,)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                mode: str = "full"):
    """(cos, sin), each (..., S, 1, rope_dim/2) float32, for positions
    (..., S): computed once per forward pass and shared by every layer."""
    rope_dim = head_dim if mode == "full" else head_dim // 2
    freqs = rope_freqs(head_dim, theta, rope_dim, positions.device)
    ang = positions[..., :, None].to(torch.float32) * freqs
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """Rotate the even/odd pairs of x's first ``2 * cos.shape[-1]``
    features (x: (..., S, H, D))."""
    rope_dim = 2 * cos.shape[-1]
    xr = x[..., :rope_dim].to(torch.float32)
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    if rope_dim == x.shape[-1]:
        return rotated
    return torch.cat([rotated, x[..., rope_dim:]], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mode: str = "full") -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    if mode == "none":
        return x
    cos, sin = rope_tables(positions, x.shape[-1], theta, mode)
    return rotate(x, cos, sin)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, gen, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.w_gate = _param(dense_init(gen, d_model, d_ff, dtype, device))
        self.w_up = _param(dense_init(gen, d_model, d_ff, dtype, device))
        self.w_down = _param(dense_init(gen, d_ff, d_model, dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.nn.functional.silu(x @ self.w_gate) * (x @ self.w_up)
        return h @ self.w_down


# ---------------------------------------------------------------------------
# depthwise causal conv (the SSM and RG-LRU blocks' input conv)
# ---------------------------------------------------------------------------
def causal_conv(seq: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along dim 1: seq (B, S, C), w (W, C), state
    (B, W − 1, C) of the rows before seq (zeros when None) → (out
    (B, S, C), new state: the last W − 1 rows). The taps are summed in
    order in seq's dtype, as the reference's Python ``sum`` does."""
    wsize, s = w.shape[0], seq.shape[1]
    if state is None:
        state = seq.new_zeros((seq.shape[0], wsize - 1, seq.shape[2]))
    full = torch.cat([state, seq], dim=1)
    out = sum(full[:, i:i + s] * w[i] for i in range(wsize))
    return out, (full[:, -(wsize - 1):] if wsize > 1 else state)


# ---------------------------------------------------------------------------
# GQA attention (full / sliding-window) through the flash kernel
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Causal self-attention with an optional decode cache (``forward``), or
    non-causal attention without RoPE over keys and values given (``attend``:
    the enc-dec encoder's self-attention and the decoder's cross-attention).
    ``cross=True`` builds the cross-attention of the enc-dec decoder, which
    has no qk-norm (as the reference's ``init_attention(cross=True)``)."""

    def __init__(self, gen, cfg: ArchConfig, device, cross: bool = False):
        super().__init__()
        d, hd, dtype = cfg.d_model, cfg.head_dim, dtype_of(cfg)
        self.cfg = cfg
        self.wq = _param(dense_init(gen, d, cfg.n_heads * hd, dtype, device))
        self.wk = _param(dense_init(gen, d, cfg.n_kv_heads * hd, dtype,
                                    device))
        self.wv = _param(dense_init(gen, d, cfg.n_kv_heads * hd, dtype,
                                    device))
        self.wo = _param(dense_init(gen, cfg.n_heads * hd, d, dtype, device))
        if cfg.qk_norm and not cross:
            self.q_norm = RMSNorm(hd, dtype, device)
            self.k_norm = RMSNorm(hd, dtype, device)

    def query(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, d) → q (B, S, H, D), qk-normed where the layer has it."""
        cfg = self.cfg
        q = (x @ self.wq).view(*x.shape[:2], cfg.n_heads, cfg.head_dim)
        return self.q_norm(q, cfg.norm_eps) if hasattr(self, "q_norm") else q

    def keys_values(self, src: torch.Tensor):
        """src (B, T, d) → (k, v), each (B, T, Hkv, D); k qk-normed where
        the layer has it."""
        cfg = self.cfg
        shape = (*src.shape[:2], cfg.n_kv_heads, cfg.head_dim)
        k = (src @ self.wk).view(shape)
        v = (src @ self.wv).view(shape)
        if hasattr(self, "k_norm"):
            k = self.k_norm(k, cfg.norm_eps)
        return k, v

    def attend(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
        """x (B, S, d) attending to (k, v) (B, T, Hkv, D) from
        ``keys_values``, non-causal, no RoPE → y (B, S, d)."""
        return self.project(kops.gqa_attention(self.query(x), k, v,
                                               causal=False))

    def forward(self, x: torch.Tensor, rope, *, kind: str = "global",
                cache: Optional[dict] = None):
        """Causal self-attention: x (B, S, d); rope = (cos, sin) from
        ``rope_tables`` or None. → (y (B, S, d), cache). The cache is
        updated in place (the reference returns a new one): rows
        (pos0 + arange(S)) % steps of k/v and kpos are written, and pos
        advances by S."""
        q = self.query(x)
        k, v = self.keys_values(x)
        window = self.cfg.window if kind == "local" else 0
        if rope is not None:
            q = rotate(q, *rope)
            k = rotate(k, *rope)
        if cache is None:
            out = kops.gqa_attention(q, k, v, causal=True, window=window)
        else:
            pos0 = cache["pos"]
            _write_cache(cache, k, v, pos0)
            out = kops.gqa_attention(q, cache["k"], cache["v"], causal=True,
                                     window=window, q_offset=pos0,
                                     kv_positions=cache["kpos"])
        return self.project(out), cache

    def project(self, out: torch.Tensor) -> torch.Tensor:
        """(B, S, H, D) heads → (B, S, d) through ``wo``."""
        b, s = out.shape[:2]
        return out.reshape(b, s, -1) @ self.wo


def _write_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                 pos0: int) -> None:
    """Rolling write of S new keys at rows (pos0 + arange(S)) % steps."""
    steps, s = cache["k"].shape[1], k.shape[1]
    start = pos0 % steps
    if start + s <= steps:  # one slice: no index tensor
        idx = slice(start, start + s)
    else:
        idx = (pos0 + torch.arange(s, device=k.device)) % steps
    cache["k"][:, idx] = k.to(cache["k"].dtype)
    cache["v"][:, idx] = v.to(cache["v"].dtype)
    cache["kpos"][idx] = torch.arange(pos0, pos0 + s, dtype=torch.int32,
                                      device=k.device)
    cache["pos"] = pos0 + s


def init_attn_cache(cfg: ArchConfig, batch: int, max_seq: int,
                    kind: str = "global", dtype=None, device=None) -> dict:
    """Decode cache. Local layers only keep a rolling window. ``pos`` is a
    host int (the reference keeps a device scalar; the positions are the
    same)."""
    dtype = dtype or dtype_of(cfg)
    steps = min(max_seq, cfg.window) if kind == "local" else max_seq
    shape = (batch, steps, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "kpos": torch.full((steps,), -1, dtype=torch.int32, device=device),
        "pos": 0,
    }
