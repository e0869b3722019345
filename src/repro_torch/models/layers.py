"""Shared transformer layers: norms, RoPE, SwiGLU MLP, GQA attention.

Port of the JAX package's ``models/layers.py``. Parameters live in
``nn.Module``s (weights stored (in, out), applied as ``x @ w``, as the
reference stores them, so ``convert.params_from_jax`` copies them as they
are); the math is plain functions. Dtypes: parameters in
``cfg.param_dtype``, activations in the same dtype, with float32 norm and
RoPE internals. Attention goes through ``kernels.ops.gqa_attention``: the
flash kernel on CUDA, its plain version on the CPU. The reference's
``shard(...)`` annotations are the identity on one card; on a mesh, the
MLP's hidden and the attention's heads split over ``model`` as they
resolve (``dist.tensor_parallel``): each layer reads its share from the
shapes of the parameters it is given.
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
from repro_torch.dist import tensor_parallel as tp
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
    """On a mesh, ``w_gate`` and ``w_up`` split their columns and
    ``w_down`` its rows over ``model`` (the ``mlp`` axis), followed by one
    reduction."""

    def __init__(self, gen, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.d_ff = d_ff
        self.w_gate = _param(dense_init(gen, d_model, d_ff, dtype, device))
        self.w_up = _param(dense_init(gen, d_model, d_ff, dtype, device))
        self.w_down = _param(dense_init(gen, d_ff, d_model, dtype, device))

    def partial(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(this rank's share of the output, the split m): the sum of the
        shares over ``model`` is the output."""
        m, j = tp.split(self.d_ff, "mlp")
        x = tp.copy_in(x, m)
        wg, wu = (tp.take(w, 1, m, j, self.d_ff)
                  for w in (self.w_gate, self.w_up))
        h = torch.nn.functional.silu(x @ wg) * (x @ wu)
        return h @ tp.take(self.w_down, 0, m, j, self.d_ff), m

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp.reduce_out(*self.partial(x))


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
    has no qk-norm (as the reference's ``init_attention(cross=True)``).

    On a mesh whose ``model`` axis the heads resolve to, rank j of m runs
    the query heads [j·H/m, (j+1)·H/m) (``wq`` column-parallel) and the KV
    heads they read (local where the KV heads divide m, else taken from the
    whole ``wk`` and ``wv``), the flash kernel at the local head count, and
    ``wo`` row-parallel, followed by one reduction. A decode cache split
    over its sequence (``init_attn_cache(seq_shard=...)``) holds every KV
    head of T/n rows: the step attends every head to the slice, merges the
    slices' outputs over the cache's axes by their log-sum-exp, and cuts
    the merged heads back to the rank's before ``wo``."""

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

    def layout(self) -> tuple[int, int, tuple[int, int]]:
        """(m, j, (k0, k1)): the heads split m ways, this rank's index, and
        the KV heads its query heads read."""
        cfg = self.cfg
        m, j = tp.split(cfg.n_heads, "heads")
        if m == 1:
            return 1, 0, (0, cfg.n_kv_heads)
        return m, j, tp.kv_span(cfg.n_heads, cfg.n_kv_heads, m, j)

    def query(self, x: torch.Tensor, m: int = 1, j: int = 0
              ) -> torch.Tensor:
        """x (B, S, d) → q (B, S, H/m, D) of rank j of m, qk-normed where
        the layer has it."""
        cfg = self.cfg
        wq = tp.take(self.wq, 1, m, j, cfg.n_heads * cfg.head_dim)
        q = (x @ wq).view(*x.shape[:2], -1, cfg.head_dim)
        return self.q_norm(q, cfg.norm_eps) if hasattr(self, "q_norm") else q

    def _kv(self, src: torch.Tensor, span: tuple[int, int]):
        """(k, v) of the KV heads [k0, k1) from ``src`` inside the region."""
        cfg = self.cfg
        hd, full = cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        k0, k1 = span
        wk, wv = self.wk, self.wv
        if k1 - k0 < cfg.n_kv_heads and wk.shape[1] == full:
            wk, wv = (w.narrow(1, k0 * hd, (k1 - k0) * hd) for w in (wk, wv))
        shape = (*src.shape[:2], -1, hd)
        k = (src @ wk).view(shape)
        v = (src @ wv).view(shape)
        if hasattr(self, "k_norm"):
            k = self.k_norm(k, cfg.norm_eps)
        return k, v

    def keys_values(self, src: torch.Tensor):
        """src (B, T, d) → (k, v), each (B, T, Hkv', D): the KV heads this
        rank's query heads read (all Hkv on one card); k qk-normed where
        the layer has it."""
        m, _, span = self.layout()
        return self._kv(tp.copy_in(src, m), span)

    def _grouped(self, k: torch.Tensor, v: torch.Tensor, m: int, j: int,
                 span: tuple[int, int]):
        """k/v of the span laid out for the local query heads: as they are
        where local head i reads span head i // (H/m / span), else one KV
        row per query head."""
        if m == 1:
            return k, v
        hl, g = self.cfg.n_heads // m, self.cfg.n_heads // \
            self.cfg.n_kv_heads
        idx = [(j * hl + i) // g - span[0] for i in range(hl)]
        nk = span[1] - span[0]
        if hl % nk == 0 and idx == [i // (hl // nk) for i in range(hl)]:
            return k, v
        sel = torch.tensor(idx, device=k.device)
        return k.index_select(2, sel), v.index_select(2, sel)

    def attend(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
        """x (B, S, d) attending to (k, v) (B, T, Hkv', D) from
        ``keys_values``, non-causal, no RoPE → y (B, S, d)."""
        m, j, span = self.layout()
        q = self.query(tp.copy_in(x, m), m, j)
        k, v = self._grouped(k, v, m, j, span)
        return self.project(kops.gqa_attention(q, k, v, causal=False), m, j)

    def forward(self, x: torch.Tensor, rope, *, kind: str = "global",
                cache: Optional[dict] = None):
        """Causal self-attention: x (B, S, d); rope = (cos, sin) from
        ``rope_tables`` or None. → (y (B, S, d), cache). The cache is
        updated in place (the reference returns a new one): rows
        (pos0 + arange(S)) % steps of k/v and kpos are written, and pos
        advances by S."""
        m, j, span = self.layout()
        x = tp.copy_in(x, m)
        q = self.query(x, m, j)
        window = self.cfg.window if kind == "local" else 0
        if cache is not None and "seq_shard" in cache:
            return self._decode_sharded(x, q, rope, window, cache, m, j,
                                        span), cache
        k, v = self._kv(x, span)
        if rope is not None:
            q = rotate(q, *rope)
            k = rotate(k, *rope)
        if cache is None:
            k, v = self._grouped(k, v, m, j, span)
            out = kops.gqa_attention(q, k, v, causal=True, window=window)
        else:
            pos0 = cache["pos"]
            _write_cache(cache, k, v, pos0)
            ck, cv = self._grouped(cache["k"], cache["v"], m, j, span)
            out = kops.gqa_attention(q, ck, cv, causal=True, window=window,
                                     q_offset=pos0,
                                     kv_positions=cache["kpos"])
        return self.project(out, m, j), cache

    def _decode_sharded(self, x, q, rope, window: int, cache: dict,
                        m: int, j: int, span) -> torch.Tensor:
        """A decode step against a cache split over its sequence (class
        docstring) → this rank's heads, projected and reduced."""
        cfg = self.cfg
        if m > 1:
            q = tp.gather(q, 2)                    # (B, S, H, D)
        if span == (0, cfg.n_kv_heads) or self.wk.shape[1] < \
                cfg.n_kv_heads * cfg.head_dim:
            k, v = self._kv(x, span)
            if m > 1 and span != (0, cfg.n_kv_heads):
                k, v = tp.gather(k, 2), tp.gather(v, 2)
        else:   # replicated KV: every head from the whole wk and wv
            k, v = self._kv(x, (0, cfg.n_kv_heads))
        if rope is not None:
            q = rotate(q, *rope)
            k = rotate(k, *rope)
        pos0 = cache["pos"]
        _write_cache_sharded(cache, k, v, pos0)
        out, lse = kops.gqa_attention_lse(
            q, cache["k"], cache["v"], causal=True, window=window,
            q_offset=pos0, kv_positions=cache["kpos"])
        axes, n, _ = cache["seq_shard"]
        if n > 1:
            mesh = tp.scope_mesh()
            out = kops.decode_merge(mesh.all_gather(out[None], axes, 0),
                                    mesh.all_gather(lse[None], axes, 0),
                                    q.dtype, cfg.n_kv_heads)
        else:
            out = out.to(q.dtype)
        hl = cfg.n_heads // m
        return self.project(out[:, :, j * hl:(j + 1) * hl], m, j)

    def project(self, out: torch.Tensor, m: int = 1, j: int = 0
                ) -> torch.Tensor:
        """(B, S, H/m, D) heads → (B, S, d) through ``wo`` (row-parallel
        over m ranks, then reduced)."""
        b, s = out.shape[:2]
        wo = tp.take(self.wo, 0, m, j, self.cfg.n_heads * self.cfg.head_dim)
        return tp.reduce_out(out.reshape(b, s, -1) @ wo, m)


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


def _write_cache_sharded(cache: dict, k: torch.Tensor, v: torch.Tensor,
                         pos0: int) -> None:
    """The rolling write of a cache split over its sequence: position p
    lands at row p % steps of the whole cache, which rank p % steps //
    (steps / n) holds; only that rank writes it."""
    _, n, i = cache["seq_shard"]
    local = cache["k"].shape[1]
    steps = local * n
    for t in range(k.shape[1]):
        slot = (pos0 + t) % steps
        if slot // local == i:
            r = slot % local
            cache["k"][:, r] = k[:, t].to(cache["k"].dtype)
            cache["v"][:, r] = v[:, t].to(cache["v"].dtype)
            cache["kpos"][r] = pos0 + t
    cache["pos"] = pos0 + k.shape[1]


def cache_steps(cfg: ArchConfig, max_seq: int, kind: str) -> int:
    """Rows of a layer's decode cache: local layers keep a rolling
    window."""
    return min(max_seq, cfg.window) if kind == "local" else max_seq


def init_attn_cache(cfg: ArchConfig, batch: int, max_seq: int,
                    kind: str = "global", dtype=None, device=None,
                    seq_shard: Optional[tuple] = None) -> dict:
    """Decode cache. Local layers only keep a rolling window. ``pos`` is a
    host int (the reference keeps a device scalar; the positions are the
    same). ``seq_shard`` = (axes, n, i): the cache's rows are split n ways
    over the mesh ``axes`` and this rank holds slice i of them, with their
    ``kpos`` (the decode rule's ``cache_seq``)."""
    dtype = dtype or dtype_of(cfg)
    steps = cache_steps(cfg, max_seq, kind)
    if seq_shard is not None:
        steps //= seq_shard[1]
    shape = (batch, steps, cfg.n_kv_heads, cfg.head_dim)
    out = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "kpos": torch.full((steps,), -1, dtype=torch.int32, device=device),
        "pos": 0,
    }
    if seq_shard is not None:
        out["seq_shard"] = tuple(seq_shard)
    return out
