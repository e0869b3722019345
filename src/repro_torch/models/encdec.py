"""Whisper-style encoder-decoder backbone (arXiv:2212.04356): a port of the
JAX package's ``models/encdec.py``.

The conv/mel frontend is a stub: callers give precomputed frame embeddings
(B, n_frames, d_model). Encoder: bidirectional self-attention with learned
positions. Decoder: causal self-attention with learned positions, then
cross-attention to the encoder output; decode caches the self-attention
K/V and the cross-attention K/V, computed once from ``enc_out``. Logits
come from the embedding table. Every attention goes through
``kernels.ops.gqa_attention``. On a mesh the attention and MLP split
over ``model`` as ``layers`` splits them, and the vocabulary as the
decoder-only LM's (``transformer.embed_lookup``, ``vocab_logits``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import embed_lookup, vocab_logits


class EncoderLayer(nn.Module):
    def __init__(self, gen, cfg: ArchConfig, device):
        super().__init__()
        dtype = L.dtype_of(cfg)
        self.norm_in = L.RMSNorm(cfg.d_model, dtype, device)
        self.attn = L.Attention(gen, cfg, device)
        self.norm_mid = L.RMSNorm(cfg.d_model, dtype, device)
        self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, dtype, device)


class DecoderLayer(nn.Module):
    def __init__(self, gen, cfg: ArchConfig, device):
        super().__init__()
        dtype = L.dtype_of(cfg)
        self.norm_in = L.RMSNorm(cfg.d_model, dtype, device)
        self.attn = L.Attention(gen, cfg, device)
        self.norm_x = L.RMSNorm(cfg.d_model, dtype, device)
        self.cross_attn = L.Attention(gen, cfg, device, cross=True)
        self.norm_mid = L.RMSNorm(cfg.d_model, dtype, device)
        self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, dtype, device)


class EncDec(nn.Module):
    """Token embedding (also the output head), learned decoder positions
    (``pos_embed``, max_position rows) and encoder positions (``enc_pos``,
    n_frames rows), the two stacks and their final norms."""

    def __init__(self, cfg: ArchConfig, seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dtype = L.dtype_of(cfg)
        self.cfg = cfg
        self.embed = L._param(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                           dtype, device))
        self.pos_embed = L._param(L.embed_init(
            gen, cfg.max_position, cfg.d_model, dtype, device) * 0.02)
        self.enc_pos = L._param(L.embed_init(
            gen, cfg.encoder.n_frames, cfg.d_model, dtype, device) * 0.02)
        self.final_norm = L.RMSNorm(cfg.d_model, dtype, device)
        self.enc_final_norm = L.RMSNorm(cfg.d_model, dtype, device)
        self.encoder = nn.ModuleList(EncoderLayer(gen, cfg, device)
                                     for _ in range(cfg.encoder.n_layers))
        self.decoder = nn.ModuleList(DecoderLayer(gen, cfg, device)
                                     for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_encdec(cfg: ArchConfig, seed: int = 0, device=None) -> EncDec:
    return EncDec(cfg, seed, device)


def encode(model: EncDec, frames) -> torch.Tensor:
    """frames (B, F, d_model) stub embeddings → encoder states."""
    cfg, eps = model.cfg, model.cfg.norm_eps
    x = torch.as_tensor(frames, device=model.device).to(L.dtype_of(cfg))
    x = x + model.enc_pos[None, :x.shape[1]]
    for lp in model.encoder:
        h = lp.norm_in(x, eps)
        # bidirectional: attends to itself, no causal mask, no RoPE
        x = x + lp.attn.attend(h, *lp.attn.keys_values(h))
        x = x + lp.mlp(lp.norm_mid(x, eps))
    return model.enc_final_norm(x, eps)


def _embed(model: EncDec, tokens, pos0: int) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=model.device)
    return embed_lookup(model.embed, tokens, model.cfg.vocab) + \
        model.pos_embed[None, pos0:pos0 + tokens.shape[1]]


def decode_train(model: EncDec, tokens, enc_out: torch.Tensor
                 ) -> torch.Tensor:
    """Teacher-forced decoder forward → hidden (B, S, d)."""
    eps = model.cfg.norm_eps
    x = _embed(model, tokens, 0)
    for lp in model.decoder:
        x = x + lp.attn(lp.norm_in(x, eps), None)[0]
        x = x + lp.cross_attn.attend(lp.norm_x(x, eps),
                                     *lp.cross_attn.keys_values(enc_out))
        x = x + lp.mlp(lp.norm_mid(x, eps))
    return model.final_norm(x, eps)


def logits(model: EncDec, hidden: torch.Tensor) -> torch.Tensor:
    """Logits from the embedding table (the head is tied)."""
    return vocab_logits(hidden, model.embed, model.cfg.vocab, 0)


def init_decode_cache(model: EncDec, batch: int, max_seq: int,
                      enc_out: Optional[torch.Tensor] = None,
                      seq_shard=None) -> dict:
    """Self-attention caches (split over their rows by ``seq_shard``, as
    ``layers.init_attn_cache``), and each layer's cross-attention K/V
    computed once from ``enc_out`` (zeros over n_frames when it is None),
    of the KV heads the rank's query heads read."""
    cfg = model.cfg
    caches = {"self": [], "cross_k": [], "cross_v": [], "pos": 0}
    for lp in model.decoder:
        caches["self"].append(L.init_attn_cache(cfg, batch, max_seq,
                                                device=model.device,
                                                seq_shard=seq_shard))
        if enc_out is not None:
            k, v = lp.cross_attn.keys_values(enc_out)
        else:
            k0, k1 = lp.cross_attn.layout()[2]
            k = torch.zeros((batch, cfg.encoder.n_frames, k1 - k0,
                             cfg.head_dim), dtype=L.dtype_of(cfg),
                            device=model.device)
            v = torch.zeros_like(k)
        caches["cross_k"].append(k)
        caches["cross_v"].append(v)
    return caches


def decode_step(model: EncDec, tokens, caches: dict):
    """One decoder step against the cached cross-attention K/V → (logits
    (B, vocab) of the last position, caches updated in place)."""
    eps = model.cfg.norm_eps
    pos0 = caches["pos"]
    x = _embed(model, tokens, pos0)
    for li, lp in enumerate(model.decoder):
        x = x + lp.attn(lp.norm_in(x, eps), None,
                        cache=caches["self"][li])[0]
        x = x + lp.cross_attn.attend(lp.norm_x(x, eps), caches["cross_k"][li],
                                     caches["cross_v"][li])
        x = x + lp.mlp(lp.norm_mid(x, eps))
    x = model.final_norm(x, eps)
    caches["pos"] = pos0 + x.shape[1]
    return logits(model, x[:, -1:])[:, 0], caches
