"""Plain PyTorch versions of the port's kernels, computed in float32.

They compute what the CUDA kernels compute and are what a CPU tensor runs
(``ops`` dispatches by device); ``chip_smoke.py`` holds each kernel against
them on the card. Counterparts of the JAX package's ``kernels/ref.py``.
"""
from __future__ import annotations

import torch


def pairwise_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances: (..., M, d) × (..., N, d) → (..., M, N) f32."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    d2 = a2 - 2.0 * (a @ b.transpose(-1, -2)) + b2.transpose(-1, -2)
    return torch.clamp_min(d2, 0.0)


def pairwise_l2_threshold(a: torch.Tensor, b: torch.Tensor, eps2: float):
    """(d2, mask) with mask = d2 ≤ eps² (eps2 compared in float32)."""
    d2 = pairwise_l2(a, b)
    return d2, d2 <= eps2


def bucket_assign(x: torch.Tensor, centers: torch.Tensor):
    """Nearest center: (M, d) × (B, d) → (min_d2 (M,), argmin (M,) int32).
    ``torch.argmin`` returns the first minimum, so ties go to the lowest
    center index, as in the kernel."""
    d2 = pairwise_l2(x, centers)
    idx = torch.argmin(d2, dim=1)
    mind2 = torch.gather(d2, 1, idx[:, None])[:, 0]
    return mind2, idx.to(torch.int32)


NEG_FILL = -1e30  # the reference's finite mask fill (never -inf)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: float | None = None
              ) -> torch.Tensor:
    """Attention over (B, H, S, D) × (B, H, T, D) → (B, H, S, D) in q's
    dtype, computed in float32. Causal is ``tril(k=T−S)``: query row i sees
    keys j ≤ i + T − S. Counterpart of the JAX package's
    ``ref.attention``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        s, t = q.shape[2], k.shape[2]
        mask = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(diagonal=t - s)
        logits = torch.where(mask, logits, NEG_FILL)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs,
                        v.to(torch.float32)).to(q.dtype)


def gqa_mask(sq: int, kv_pos: torch.Tensor, *, causal: bool, window: int,
             q_offset: int) -> torch.Tensor:
    """(Sq, T) bool: which keys each query sees. A key at position p is
    seen iff p ≥ 0, (causal) q_offset + row ≥ p, and (window > 0)
    p > q_offset + row − window."""
    q_pos = q_offset + torch.arange(sq, device=kv_pos.device)
    mask = (kv_pos[None, :] >= 0).expand(sq, -1)
    if causal:
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
    if window > 0:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    return mask


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int = 0, q_offset: int = 0,
                  kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped-head attention in the model's layout: q (B, Sq, H, D),
    k/v (B, T, Hkv, D) → (B, Sq, H, D) in q's dtype, computed in float32.
    Query head h reads KV head h // (H / Hkv). ``kv_positions`` (T,) gives
    each key's absolute position (−1 marks an empty cache slot; default
    ``arange(T)``) and ``q_offset`` the position of q[:, 0]. The mask is
    ``gqa_mask``'s, filled with −1e30, as the JAX package's
    ``models.layers.gqa_scores_chunked`` computes it."""
    b, sq, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kv_pos = (torch.arange(t, device=q.device) if kv_positions is None
              else kv_positions.to(q.device))
    qg = q.reshape(b, sq, hkv, g, d).to(torch.float32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg,
                     k.to(torch.float32)) * (d ** -0.5)
    mask = gqa_mask(sq, kv_pos, causal=causal, window=window,
                    q_offset=q_offset)
    s = torch.where(mask, s, NEG_FILL)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.to(q.dtype).reshape(b, sq, h, d)


def gqa_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, q_offset: int = 0,
                      kv_positions: torch.Tensor | None = None):
    """``gqa_attention`` of one slice of a cache, for a merge over slices:
    (out (B, Sq, H, D) float32, lse (B, Sq, H) float32), lse the log of
    the softmax's sum over the keys the row sees (scaled scores); a row
    that sees no key has lse −∞ and out 0, so the merge gives it no
    weight."""
    b, sq, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kv_pos = (torch.arange(t, device=q.device) if kv_positions is None
              else kv_positions.to(q.device))
    qg = q.reshape(b, sq, hkv, g, d).to(torch.float32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg,
                     k.to(torch.float32)) * (d ** -0.5)
    mask = gqa_mask(sq, kv_pos, causal=causal, window=window,
                    q_offset=q_offset)
    s = torch.where(mask, s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                      # (b, k, g, q)
    p = torch.where(mask, torch.exp(s - torch.where(
        torch.isinf(lse), 0.0, lse)[..., None]), 0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return (out.reshape(b, sq, h, d),
            lse.permute(0, 3, 1, 2).reshape(b, sq, h))


def decode_merge(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Slices' attention merged: outs (n, B, Sq, H, D) and lses
    (n, B, Sq, H) float32 from ``gqa_attention_lse`` → (B, Sq, H, D)
    float32, each slice weighted exp(lse_r − lse), lse the slices' joint
    log-sum-exp; a slice with lse −∞ has weight 0."""
    top = torch.amax(lses, dim=0)
    top = torch.where(torch.isinf(top), 0.0, top)
    w = torch.exp(lses - top)                             # 0 where −∞
    den = torch.clamp_min(w.sum(0), 1e-30)
    return (w[..., None] * outs).sum(0) / den[..., None]


def gqa_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor, *, causal: bool,
                      window: int = 0, q_offset: int = 0,
                      kv_positions: torch.Tensor | None = None):
    """The gradient of ``gqa_attention``: (dq, dk, dv) in q's, k's and v's
    dtypes, computed in float32 from the forward's output ``out`` and its
    gradient ``dout`` (B, Sq, H, D), by the explicit formulas the backward
    kernel computes: P = softmax(S) under ``gqa_mask`` with the −1e30 fill,
    δ = rowsum(dO∘O), dS = P∘(dP − δ) where a key is seen and 0 where it
    is masked (the fill passes no gradient), dQ = dS·K·scale,
    dK = dSᵀ·Q·scale, dV = Pᵀ·dO. Autograd of the JAX package's
    ``gqa_scores_chunked`` gives the same gradient; a row that sees no key
    has a uniform P there too."""
    b, sq, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d ** -0.5
    kv_pos = (torch.arange(t, device=q.device) if kv_positions is None
              else kv_positions.to(q.device))
    qg = q.reshape(b, sq, hkv, g, d).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    do = dout.reshape(b, sq, hkv, g, d).to(torch.float32)
    o = out.reshape(b, sq, hkv, g, d).to(torch.float32)
    mask = gqa_mask(sq, kv_pos, causal=causal, window=window,
                    q_offset=q_offset)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    p = torch.softmax(torch.where(mask, s, NEG_FILL), dim=-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, vf)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", do, o)
    ds = torch.where(mask, p * (dp - delta[..., None]), 0.0)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
