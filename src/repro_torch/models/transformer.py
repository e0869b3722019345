"""Decoder-only LM covering dense / MoE / SSM / hybrid / VLM: a port of the
JAX package's ``models/transformer.py``.

The reference stacks each pattern group's parameters and runs it under
``lax.scan``; here the layers are a plain ``nn.ModuleList`` run by a Python
loop (PyTorch runs eagerly, so there is no program size to bound). Layer
``i`` has kind ``block_pattern[i % len(block_pattern)]`` and takes the MoE
FFN from ``moe.first_k_dense`` on, which is what the reference's groups
give each layer. ``convert.params_from_jax`` maps the stacked pytree onto
these layers. Decode caches are one dict per layer, of the layer's kind.
``forward(..., remat=True)`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint`` over each layer group's scan body does; it acts only
where a graph is built (training).

On a mesh (``dist.tensor_parallel``) the vocabulary splits over ``model``
where it divides: the embedding looks up the rank's rows of the table
(a token elsewhere reads zeros) and one all-reduce sums them; the logits
are the rank's columns, gathered over ``model``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod

ATTN_KINDS = ("global", "local")


def layer_kinds(cfg: ArchConfig) -> list[str]:
    pattern = tuple(cfg.block_pattern)
    return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """Pre-norm mixer (attention, SSD or RG-LRU) and, but for the
    single-branch SSM block, a pre-norm FFN (SwiGLU or MoE)."""

    def __init__(self, gen, cfg: ArchConfig, kind: str, layer_idx: int,
                 device):
        super().__init__()
        dtype = L.dtype_of(cfg)
        self.cfg, self.kind = cfg, kind
        self.norm_in = L.RMSNorm(cfg.d_model, dtype, device)
        if kind in ATTN_KINDS:
            self.attn = L.Attention(gen, cfg, device)
        elif kind == "ssm":
            self.ssm = ssm_mod.SSM(gen, cfg, device)
            return  # mamba blocks are single-branch: no norm_mid, no FFN
        elif kind == "rglru":
            self.rglru = rglru_mod.RGLRU(gen, cfg, device)
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        self.norm_mid = L.RMSNorm(cfg.d_model, dtype, device)
        if cfg.moe is not None and layer_idx >= cfg.moe.first_k_dense:
            self.moe = moe_mod.MoE(gen, cfg, device)
        else:
            d_ff = cfg.d_ff if cfg.moe is None else \
                (cfg.moe.d_ff_dense or cfg.d_ff)
            self.mlp = L.MLP(gen, cfg.d_model, d_ff, dtype, device)

    def forward(self, x: torch.Tensor, rope, cache: Optional[dict]):
        """→ (x, aux loss: a float32 scalar tensor, or None without MoE).
        A cache is updated in place."""
        eps = self.cfg.norm_eps
        h = self.norm_in(x, eps)
        if self.kind == "ssm":
            return x + self.ssm(h, cache), None
        if self.kind == "rglru":
            x = x + self.rglru(h, cache)
        else:
            x = x + self.attn(h, rope, kind=self.kind, cache=cache)[0]
        h = self.norm_mid(x, eps)
        if hasattr(self, "moe"):
            out, aux = self.moe(h)
            return x + out, aux
        return x + self.mlp(h), None


class Frontend(nn.Module):
    """The VLM's patch projection: (B, P, frontend_dim) stub embeddings →
    (B, P, d_model)."""

    def __init__(self, gen, cfg: ArchConfig, device):
        super().__init__()
        fdim = cfg.encoder.frontend_dim or cfg.d_model
        self.proj = L._param(L.dense_init(gen, fdim, cfg.d_model,
                                          L.dtype_of(cfg), device))


class LM(nn.Module):
    """Embedding (tied by default), the VLM frontend where the family has
    one, the layers, the final norm."""

    def __init__(self, cfg: ArchConfig, seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dtype = L.dtype_of(cfg)
        self.cfg = cfg
        self.layers = nn.ModuleList(
            Block(gen, cfg, kind, i, device)
            for i, kind in enumerate(layer_kinds(cfg)))
        self.final_norm = L.RMSNorm(cfg.d_model, dtype, device)
        self.embed = L._param(L.embed_init(gen, cfg.vocab, cfg.d_model,
                                           dtype, device))
        if not cfg.tie_embeddings:
            self.lm_head = L._param(L.dense_init(gen, cfg.d_model, cfg.vocab,
                                                 dtype, device))
        if cfg.family == "vlm":
            self.frontend = Frontend(gen, cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm(cfg: ArchConfig, seed: int = 0, device=None) -> LM:
    return LM(cfg, seed, device)


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                     device=None, seq_shard=None) -> dict:
    """A layer's decode cache; on a mesh (inside a ``tensor_parallel``
    scope) the rank's part: attention rows split by ``seq_shard`` (the
    ``cache_seq`` rule), SSD heads and RG-LRU width over ``model``."""
    if kind in ATTN_KINDS:
        return L.init_attn_cache(cfg, batch, max_seq, kind, device=device,
                                 seq_shard=seq_shard)
    if kind == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, device)
    if kind == "rglru":
        return rglru_mod.init_rglru_cache(cfg, batch, device)
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None, seq_shards=None) -> list[dict]:
    """One cache a layer; ``seq_shards``, where given, a function of the
    layer kind's cache rows → its ``seq_shard``."""
    device = resolve_device(device)
    return [init_block_cache(
        cfg, kind, batch, max_seq, device,
        None if seq_shards is None or kind not in ATTN_KINDS
        else seq_shards(L.cache_steps(cfg, max_seq, kind)))
        for kind in layer_kinds(cfg)]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Rows of the embedding table, vocabulary-parallel over ``model``
    where the vocabulary splits: each rank reads its rows (zeros for a
    token it does not hold), then one all-reduce."""
    m, j = tp.split(vocab, "vocab")
    if m == 1:
        return table[tokens]
    part = tp.take(table, 0, m, j, vocab)
    lo = j * (vocab // m)
    local = tokens - lo
    hit = (local >= 0) & (local < part.shape[0])
    x = part[torch.where(hit, local, 0)] * hit[..., None].to(part.dtype)
    return tp.reduce_out(x, m)


def vocab_logits(hidden: torch.Tensor, w: torch.Tensor, vocab: int,
                 dim: int) -> torch.Tensor:
    """hidden @ the output matrix ``w`` (the table, vocabulary on ``dim``
    0, or the head, on ``dim`` 1), vocabulary-parallel where it splits:
    the rank's columns, gathered over ``model``."""
    m, j = tp.split(vocab, "vocab")
    w = tp.take(w, dim, m, j, vocab)
    out = tp.copy_in(hidden, m) @ (w.T if dim == 0 else w)
    return tp.gather(out, -1) if m > 1 else out


def _embed(model: LM, tokens) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=model.device)
    x = embed_lookup(model.embed, tokens, model.cfg.vocab)
    return x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype)


def _rope(cfg: ArchConfig, positions: torch.Tensor):
    if cfg.rope_mode == "none":
        return None
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                         cfg.rope_mode)


def _run_layers(model: LM, x: torch.Tensor, positions: torch.Tensor,
                caches: Optional[list], remat: bool = False):
    """→ (x, summed aux loss, float32 scalar). ``remat``: each block is
    recomputed in the backward pass instead of keeping its activations
    (only where x is part of a graph)."""
    rope = _rope(model.cfg, positions)
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and caches is None and x.requires_grad
    for i, block in enumerate(model.layers):
        if remat:
            x, aux = checkpoint(tp.captured(block), x, rope, None,
                                use_reentrant=False)
        else:
            x, aux = block(x, rope, None if caches is None else caches[i])
        if aux is not None:
            total_aux = total_aux + aux
    return x, total_aux


# ---------------------------------------------------------------------------
# public forward passes
# ---------------------------------------------------------------------------
def forward(model: LM, tokens, patch_embeds=None, remat: bool = True):
    """Training/prefill forward → (hidden (B, S, d), summed aux loss).

    VLM: ``patch_embeds`` (B, P, frontend_dim) are projected and
    prepended; the returned hidden covers the full (P + S) sequence.
    ``remat`` as the reference's: per-block recomputation in backward (the
    values are the same either way)."""
    x = _embed(model, tokens)
    if patch_embeds is not None:
        px = torch.as_tensor(patch_embeds, device=x.device).to(x.dtype)
        x = torch.cat([px @ model.frontend.proj, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = _run_layers(model, x, positions, None, remat)
    return model.final_norm(x, model.cfg.norm_eps), aux


def decode_step(model: LM, tokens, caches: list):
    """One decode step. tokens: (B, S) (S = 1 when serving) → (logits
    (B, vocab) of the last position, caches updated in place)."""
    x = _embed(model, tokens)
    pos0 = cache_pos(caches)
    positions = torch.arange(pos0, pos0 + x.shape[1], device=x.device)[None]
    x, _ = _run_layers(model, x, positions, caches)
    x = model.final_norm(x, model.cfg.norm_eps)
    return lm_logits(model, x[:, -1:])[:, 0], caches


def cache_pos(caches: list) -> int:
    """The current absolute position: that of the first cache holding one
    (every attention cache does, and all advance in lockstep); 0 where no
    cache does (SSM and RG-LRU caches keep none, as in the reference)."""
    for c in caches:
        if "pos" in c:
            return c["pos"]
    return 0


def lm_logits(model: LM, hidden: torch.Tensor) -> torch.Tensor:
    """Logits in the parameter dtype, from the tied embedding or the head."""
    if model.cfg.tie_embeddings:
        return vocab_logits(hidden, model.embed, model.cfg.vocab, 0)
    return vocab_logits(hidden, model.lm_head, model.cfg.vocab, 1)
