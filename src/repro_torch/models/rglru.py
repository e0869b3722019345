"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): a
port of the JAX package's ``models/rglru.py``.

Real-Gated Linear Recurrent Unit:
    r_t = σ(W_a x_t)                     (recurrence gate)
    i_t = σ(W_x_gate x_t)                (input gate)
    a_t = exp(−c · softplus(Λ) · r_t)    (per-channel decay ∈ (0,1))
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill runs the recurrence as a log-depth scan over the sequence
(``linear_scan``: log₂ S doubling steps on whole tensors, where the
reference runs ``lax.associative_scan``); decode is the float32 O(1)
step. A depthwise causal conv (width 4, no activation) precedes the
recurrence, and its last W − 1 rows are carried in the cache.

On a mesh the width splits over ``model`` (the reference's ``mlp``
annotation): rank j of m takes its W/m columns of ``w_x``, ``w_gate_in``
and the conv, its channels' gates and decay, and ``out``'s rows, followed
by one reduction; its cache holds its channels.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import layers as L

F = torch.nn.functional


def width(cfg: ArchConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


class RGLRU(nn.Module):
    """w_x, w_gate_in (d_model, W); conv (W_conv, W); a_param (Λ),
    in_gate_w, rec_gate_w (W,) float32; out (W, d_model)."""

    def __init__(self, gen, cfg: ArchConfig, device):
        super().__init__()
        w, dtype = width(cfg), L.dtype_of(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        self.cfg = cfg
        self.w_x = L._param(L.dense_init(gen, cfg.d_model, w, dtype, device))
        self.w_gate_in = L._param(L.dense_init(gen, cfg.d_model, w, dtype,
                                               device))
        self.conv = L._param((torch.randn(
            (cfg.rglru.conv_width, w), generator=gen,
            **f32) * 0.1).to(dtype))
        self.a_param = L._param(torch.full((w,), 0.7, **f32))
        self.in_gate_w = L._param(torch.zeros(w, **f32))
        self.rec_gate_w = L._param(torch.zeros(w, **f32))
        self.out = L._param(L.dense_init(gen, w, cfg.d_model, dtype, device))

    def forward(self, u: torch.Tensor,
                cache: Optional[dict] = None) -> torch.Tensor:
        """u (B, S, d_model) → (B, S, d_model). With a cache (decode) its
        ``state`` and ``conv`` are replaced by the new ones."""
        w = width(self.cfg)
        m, j = tp.split(w, "mlp")
        w_gate_in, w_x, conv = (tp.take(t, 1, m, j, w) for t in (
            self.w_gate_in, self.w_x, self.conv))
        a_param, in_gate_w, rec_gate_w, w_out = (
            tp.take(t, 0, m, j, w) for t in (
                self.a_param, self.in_gate_w, self.rec_gate_w, self.out))
        u = tp.copy_in(u, m)
        gate = F.gelu(u @ w_gate_in, approximate="tanh")  # jax's gelu
        x, new_conv = L.causal_conv(u @ w_x, conv,
                                    None if cache is None else cache["conv"])
        xf = x.to(torch.float32)
        rec_gate = torch.sigmoid(xf * rec_gate_w + 0.0)
        in_gate = torch.sigmoid(xf * in_gate_w)
        a = torch.exp(-self.cfg.rglru.c_constant * F.softplus(a_param)
                      * rec_gate)
        beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
        v = beta * in_gate * xf                                 # (B,S,W)
        if cache is not None:
            h = cache["state"]                                  # (B, W)
            hs = []
            for t in range(u.shape[1]):
                h = a[:, t] * h + v[:, t]
                hs.append(h)
            hseq = torch.stack(hs, dim=1)
            cache["state"], cache["conv"] = h, new_conv
        else:
            hseq = linear_scan(a, v)
        return tp.reduce_out((hseq.to(u.dtype) * gate) @ w_out, m)


def linear_scan(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t−1} + v_t along dim 1 from h_{−1} = 0, for all t at
    once: log₂ S doubling steps (Hillis–Steele) of the associative
    combine (a₁, v₁) ∘ (a₂, v₂) = (a₁a₂, a₂v₁ + v₂), each on whole tensors.
    The reference's ``lax.associative_scan`` combines in another tree, so
    the two agree to float32 rounding, not bit for bit."""
    s = a.shape[1]
    off = 1
    while off < s:
        v = torch.cat([v[:, :off], a[:, off:] * v[:, :-off] + v[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return v


def init_rglru_cache(cfg: ArchConfig, batch: int, device=None) -> dict:
    """The state and conv rows of the rank's channels (all on one
    card)."""
    w = width(cfg)
    w //= tp.split(w, "mlp")[0]
    return {
        "state": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                            dtype=L.dtype_of(cfg), device=device),
    }
