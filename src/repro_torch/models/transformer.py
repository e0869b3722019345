"""Decoder-only LM: the attention families (dense, with global and local
layers) of the JAX package's ``models/transformer.py``.

The reference stacks each pattern group's parameters and runs it under
``lax.scan``; here the layers are a plain ``nn.ModuleList`` run by a Python
loop (PyTorch runs eagerly, so there is no program size to bound). Layer
``i`` has kind ``block_pattern[i % len(block_pattern)]``, which is what the
reference's groups give each layer. ``convert.params_from_jax`` maps the
stacked pytree onto these layers. Decode caches are one dict per layer.

Not ported yet (each raises ``NotImplementedError``): SSM and RG-LRU
blocks, MoE FFNs, the VLM frontend (ROADMAP module item 8).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

ATTN_KINDS = ("global", "local")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP module item 8)")


def layer_kinds(cfg: ArchConfig) -> list[str]:
    pattern = tuple(cfg.block_pattern)
    return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """Pre-norm attention + SwiGLU block."""

    def __init__(self, gen, cfg: ArchConfig, kind: str, device):
        super().__init__()
        if kind not in ATTN_KINDS:
            raise _not_ported(f"block kind {kind!r}")
        if cfg.moe is not None:
            raise _not_ported("the MoE FFN (models/moe.py, moe_a2a.py)")
        dtype = L.dtype_of(cfg)
        self.cfg, self.kind = cfg, kind
        self.norm_in = L.RMSNorm(cfg.d_model, dtype, device)
        self.norm_mid = L.RMSNorm(cfg.d_model, dtype, device)
        self.attn = L.Attention(gen, cfg, device)
        self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, dtype, device)

    def forward(self, x: torch.Tensor, rope, cache: Optional[dict]):
        """→ (x, cache)."""
        eps = self.cfg.norm_eps
        h = self.norm_in(x, eps)
        attn_out, cache = self.attn(h, rope, kind=self.kind, cache=cache)
        x = x + attn_out
        x = x + self.mlp(self.norm_mid(x, eps))
        return x, cache


class LM(nn.Module):
    """Embedding (tied by default), the layers, the final norm."""

    def __init__(self, cfg: ArchConfig, seed: int = 0, device=None):
        super().__init__()
        if cfg.family == "vlm":
            raise _not_ported("the VLM frontend")
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dtype = L.dtype_of(cfg)
        self.cfg = cfg
        self.layers = nn.ModuleList(
            Block(gen, cfg, kind, device) for kind in layer_kinds(cfg))
        self.final_norm = L.RMSNorm(cfg.d_model, dtype, device)
        self.embed = L._param(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                           dtype, device))
        if not cfg.tie_embeddings:
            self.lm_head = L._param(L.dense_init(gen, cfg.d_model, cfg.vocab,
                                                 dtype, device))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm(cfg: ArchConfig, seed: int = 0, device=None) -> LM:
    return LM(cfg, seed, device)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> list[dict]:
    device = resolve_device(device)
    return [L.init_attn_cache(cfg, batch, max_seq, kind, device=device)
            for kind in layer_kinds(cfg)]


def _embed(model: LM, tokens) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=model.device)
    x = model.embed[tokens]
    return x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype)


def _rope(cfg: ArchConfig, positions: torch.Tensor):
    if cfg.rope_mode == "none":
        return None
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                         cfg.rope_mode)


def _run_layers(model: LM, x: torch.Tensor, positions: torch.Tensor,
                caches: Optional[list]) -> torch.Tensor:
    rope = _rope(model.cfg, positions)
    for i, block in enumerate(model.layers):
        x, _ = block(x, rope, None if caches is None else caches[i])
    return x


# ---------------------------------------------------------------------------
# public forward passes
# ---------------------------------------------------------------------------
def forward(model: LM, tokens, patch_embeds=None):
    """Prefill forward → (hidden (B, S, d), aux_loss 0.0)."""
    if patch_embeds is not None:
        raise _not_ported("the VLM frontend")
    x = _embed(model, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _run_layers(model, x, positions, None)
    return model.final_norm(x, model.cfg.norm_eps), 0.0


def decode_step(model: LM, tokens, caches: list):
    """One decode step. tokens: (B, S) (S = 1 when serving) → (logits
    (B, vocab) of the last position, caches updated in place)."""
    x = _embed(model, tokens)
    pos0 = caches[0]["pos"]  # all layers advance in lockstep
    positions = torch.arange(pos0, pos0 + x.shape[1], device=x.device)[None]
    x = _run_layers(model, x, positions, caches)
    x = model.final_norm(x, model.cfg.norm_eps)
    return lm_logits(model, x[:, -1:])[:, 0], caches


def lm_logits(model: LM, hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits in the parameter dtype."""
    if model.cfg.tie_embeddings:
        return hidden @ model.embed.T
    return hidden @ model.lm_head
