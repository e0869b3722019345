"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060): a port of the
JAX package's ``models/ssm.py``.

Prefill runs the chunked SSD algorithm: the sequence is split into chunks
of length Q; the quadratic intra-chunk term and the linear inter-chunk
state recurrence are combined:

  intra:  Y_intra = (L ∘ (C Bᵀ)) · X           (L = causal decay matrix)
  states: S_c     = Σ_t a(t..end) B_t X_tᵀ      (per-chunk final state)
  carry:  H_c     = decay(c) H_{c−1} + S_c      (a loop over chunks)
  inter:  Y_inter = C · H_{c−1} (decayed)

Decode is the float32 O(1) recurrence h = a·h + B x; y = C·h + D x, a
mini-scan for S ≥ 1; the state and the conv's last W − 1 rows are the
whole cache. Scalar-per-head decay a_t = exp(−Δ_t · exp(A_log)), with
Δ = softplus(dt + dt_bias); a depthwise causal conv on [x, B, C].

On a mesh the SSD heads split over ``model`` (the reference's ``mlp``
annotation): rank j of m takes its heads' columns of ``in_proj`` ([x, z,
B, C, dt] each cut to the rank's heads) and of the conv, its heads' decay
and skip, and ``out_proj``'s rows, followed by one reduction; its cache
holds its heads.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import layers as L

F = torch.nn.functional


def dims(cfg: ArchConfig):
    """(SSMConfig, d_inner, SSD heads)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return s, d_inner, d_inner // s.head_dim


def _spans(starts_sizes, m: int, j: int) -> list[tuple[int, int]]:
    """Rank j's (start, length) in each block (start, size) of columns."""
    return [(a + j * (n // m), n // m) for a, n in starts_sizes]


def _cols(w: torch.Tensor, dim: int, spans) -> torch.Tensor:
    return torch.cat([w.narrow(dim, a, n) for a, n in spans], dim=dim)


class SSM(nn.Module):
    """in_proj emits [x, z, B, C, dt]; conv (W, d_inner + 2·H·N); A_log, D,
    dt_bias (H,) float32; out_proj (d_inner, d_model)."""

    def __init__(self, gen, cfg: ArchConfig, device):
        super().__init__()
        s, d_inner, n_heads = dims(cfg)
        dtype = L.dtype_of(cfg)
        proj_out = 2 * d_inner + 2 * n_heads * s.state_dim + n_heads
        conv_dim = d_inner + 2 * n_heads * s.state_dim
        self.cfg = cfg
        self.in_proj = L._param(L.dense_init(gen, cfg.d_model, proj_out,
                                             dtype, device))
        self.conv = L._param((torch.randn(
            (s.conv_width, conv_dim), generator=gen, device=device,
            dtype=torch.float32) * 0.1).to(dtype))
        f32 = dict(dtype=torch.float32, device=device)
        self.A_log = L._param(torch.zeros(n_heads, **f32))
        self.D = L._param(torch.ones(n_heads, **f32))
        self.dt_bias = L._param(torch.zeros(n_heads, **f32))
        self.out_proj = L._param(L.dense_init(gen, d_inner, cfg.d_model,
                                              dtype, device))

    def _local(self):
        """(split m, heads, d_inner, in_proj, conv, A_log, D, dt_bias,
        out_proj) of this rank (module docstring)."""
        s, d_inner, n_heads = dims(self.cfg)
        m, j = tp.split(n_heads, "mlp")
        if m == 1:
            return (1, n_heads, d_inner, self.in_proj, self.conv, self.A_log,
                    self.D, self.dt_bias, self.out_proj)
        hn = n_heads * s.state_dim
        w_in = _cols(self.in_proj, 1, _spans(
            [(0, d_inner), (d_inner, d_inner), (2 * d_inner, hn),
             (2 * d_inner + hn, hn), (2 * d_inner + 2 * hn, n_heads)], m, j))
        conv = _cols(self.conv, 1, _spans(
            [(0, d_inner), (d_inner, hn), (d_inner + hn, hn)], m, j))
        a_log, skip, bias = (tp.take(t, 0, m, j, n_heads)
                             for t in (self.A_log, self.D, self.dt_bias))
        return (m, n_heads // m, d_inner // m, w_in, conv, a_log, skip,
                bias, tp.take(self.out_proj, 0, m, j, d_inner))

    def forward(self, u: torch.Tensor,
                cache: Optional[dict] = None) -> torch.Tensor:
        """u (B, S, d_model) → (B, S, d_model). With a cache (decode) its
        ``state`` and ``conv`` are replaced by the new ones."""
        s = self.cfg.ssm
        m, n_heads, d_inner, w_in, conv, a_log, skip, dt_bias, w_out = \
            self._local()
        u = tp.copy_in(u, m)
        b, seqlen, _ = u.shape
        bc_end = 2 * d_inner + 2 * n_heads * s.state_dim
        proj = u @ w_in
        x, z = proj[..., :d_inner], proj[..., d_inner:2 * d_inner]
        bc, dt = proj[..., 2 * d_inner:bc_end], proj[..., bc_end:]
        conv_out, new_conv = L.causal_conv(
            torch.cat([x, bc], dim=-1), conv,
            None if cache is None else cache["conv"])
        conv_out = F.silu(conv_out)
        x, bc = conv_out[..., :d_inner], conv_out[..., d_inner:]
        B, C = (t.reshape(b, seqlen, n_heads, s.state_dim)
                for t in bc.chunk(2, dim=-1))
        xh = x.reshape(b, seqlen, n_heads, s.head_dim)

        dt = F.softplus(dt.to(torch.float32) + dt_bias)           # (B,S,H)
        a = torch.exp(-dt * torch.exp(a_log))                     # ∈ (0, 1)

        if cache is not None:
            h = cache["state"]                                    # (B,H,P,N)
            ys = []
            for t in range(seqlen):
                h = (h * a[:, t, :, None, None]
                     + xh[:, t].to(torch.float32)[..., None]
                     * B[:, t].to(torch.float32)[:, :, None, :])
                ys.append(torch.einsum("bhpn,bhn->bhp", h,
                                       C[:, t].to(torch.float32)))
            y = torch.stack(ys, dim=1)                            # (B,S,H,P)
            cache["state"], cache["conv"] = h, new_conv
        else:
            y = ssd_chunked(xh, a, B, C, s.chunk)

        y = y + xh.to(torch.float32) * skip[:, None]
        y = y.reshape(b, seqlen, d_inner).to(u.dtype)
        return tp.reduce_out((y * F.silu(z)) @ w_out, m)


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked SSD scan in float32. x (B, S, H, P); a (B, S, H); B/C
    (B, S, H, N) → y (B, S, H, P). A ragged tail is padded with zero x/B/C
    and decay 1, which leaves the state as it is."""
    b, seq, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, seq)
    orig_seq = seq
    if seq % chunk:
        pad = chunk - seq % chunk
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        seq += pad
    c = seq // chunk

    def r(t):  # (B, c, Q, ...) float32 views
        return t.to(torch.float32).reshape(b, c, chunk, *t.shape[2:])

    xc, ac, Bc, Cc = r(x), r(a), r(B), r(C)
    cum = torch.cumsum(torch.log(torch.clamp_min(ac, 1e-20)), dim=2)

    # intra-chunk: L[q, t] = exp(cum[q] − cum[t]) for q ≥ t (decay t → q).
    # Above the diagonal the differences are positive and may overflow exp,
    # so they are set to −inf first: exp gives 0 there and no inf is formed
    upper = ~torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    lmat = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill_(
        upper[None, None, :, :, None], float("-inf")).exp_()  # (B,c,Q,Q,H)
    scores = torch.einsum("bcqhn,bcthn->bcqth", Cc, Bc)
    y_intra = torch.einsum("bcqth,bcthp->bcqhp", scores.mul_(lmat), xc)
    del lmat, scores

    # chunk states: S_c = Σ_t exp(cum[Q−1] − cum[t]) B_t x_tᵀ
    tail = torch.exp(cum[:, :, -1:, :] - cum)                 # (B,c,Q,H)
    states = torch.einsum("bcthn,bcthp->bchpn", Bc * tail[..., None], xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,c,H)

    # inter-chunk recurrence over c: the state entering each chunk
    hprev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    hprevs = []
    for ci in range(c):
        hprevs.append(hprev)
        hprev = hprev * chunk_decay[:, ci, :, None, None] + states[:, ci]
    hprevs = torch.stack(hprevs, dim=1)                       # (B,c,H,P,N)

    inner = torch.exp(cum)                                    # decay 0..t
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Cc * inner[..., None],
                           hprevs)
    return (y_intra + y_inter).reshape(b, seq, h, p)[:, :orig_seq]


def init_ssm_cache(cfg: ArchConfig, batch: int, device=None) -> dict:
    """The state and conv rows of the rank's heads (all on one card)."""
    s, d_inner, n_heads = dims(cfg)
    m = tp.split(n_heads, "mlp")[0]
    d_inner, n_heads = d_inner // m, n_heads // m
    return {
        "state": torch.zeros((batch, n_heads, s.head_dim, s.state_dim),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1,
                             d_inner + 2 * n_heads * s.state_dim),
                            dtype=L.dtype_of(cfg), device=device),
    }
