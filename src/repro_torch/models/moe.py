"""Mixture-of-Experts FFN (deepseek-moe fine-grained, olmoe): a port of the
JAX package's ``models/moe.py`` (``moe_ffn``) on one card.

Token-choice top-k routing with capacity bounding, GShard-style:
  1. float32 router softmax → top-k experts per token, ties to the lower
     expert index (``lax.top_k``'s order), gates renormalised;
  2. position-in-expert by rank-by-sort: a stable argsort of the (T·k,)
     expert ids and ``searchsorted``; a position at or past the capacity is
     dropped;
  3. scatter of the tokens into per-expert slabs (E, C, d); a dropped
     assignment adds a zero payload at slot C − 1;
  4. per-expert SwiGLU by batched products over the slab;
  5. weighted combine: each token's k outputs gathered back and summed.

Shared experts (deepseek) run densely on every token. The switch aux loss
is returned. Under an ambient mesh with the ``moe_a2a`` rule set
(``dist.sharding.axis_rules(moe_a2a=True)``), the expert-parallel
all-to-all dispatch of ``moe_a2a.py`` runs instead, as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.dist.sharding import current_mesh, has_rule
from repro_torch.models import layers as L


def capacity(m: MoEConfig, tokens: int) -> int:
    """Slots per expert: ``max(8, min(int(cf · T · k / E), T))`` in Python
    floats, as the reference computes it."""
    c = int(m.capacity_factor * tokens * m.top_k / m.num_experts)
    return max(8, min(c, tokens))


def top_k(probs: torch.Tensor, k: int):
    """(T, E) → (values, indices) of the k largest per row, descending, ties
    to the lower index (``lax.top_k``'s order; ``torch.topk`` does not
    promise one): a stable descending sort keeps equal values in index
    order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(logits: torch.Tensor, m: MoEConfig):
    """float32 router logits (T, E) → (probs (T, E), gates (T, k)
    renormalised, expert ids (T, k), position-in-expert (T·k,), keep
    (T·k,), capacity). Position comes from rank-by-sort: assignment j of
    expert e ranks by its place among e's assignments in (token, k) order."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = top_k(probs, m.top_k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    cap = capacity(m, t)
    eid = expert_idx.reshape(-1)
    order = torch.argsort(eid, stable=True)
    eid_sorted = eid[order]
    starts = torch.searchsorted(eid_sorted,
                                torch.arange(e, device=eid.device))
    ranks_sorted = (torch.arange(eid.numel(), device=eid.device)
                    - starts[eid_sorted])
    pos = torch.empty_like(eid).scatter_(0, order, ranks_sorted)
    return probs, gates, expert_idx, pos, pos < cap, cap


class Experts(nn.Module):
    """The routed experts' SwiGLU weights, stacked over experts:
    w_gate/w_up (E, d, d_ff_expert), w_down (E, d_ff_expert, d)."""

    def __init__(self, gen, m: MoEConfig, d: int, dtype, device):
        super().__init__()
        e, f = m.num_experts, m.d_ff_expert
        self.w_gate = L._param(_stack_init(gen, e, d, f, dtype, device))
        self.w_up = L._param(_stack_init(gen, e, d, f, dtype, device))
        self.w_down = L._param(_stack_init(gen, e, f, d, dtype, device))

    def forward(self, slab: torch.Tensor) -> torch.Tensor:
        """(E, C, d) → (E, C, d)."""
        h = (torch.nn.functional.silu(torch.bmm(slab, self.w_gate))
             * torch.bmm(slab, self.w_up))
        return torch.bmm(h, self.w_down)


def _stack_init(gen, e: int, din: int, dout: int, dtype,
                device) -> torch.Tensor:
    return (torch.randn((e, din, dout), generator=gen, device=device,
                        dtype=torch.float32) / din ** 0.5).to(dtype)


class MoE(nn.Module):
    """Router (float32, (d, E)), routed experts and, where the config has
    them, the shared experts as one dense SwiGLU of width
    ``num_shared · d_ff_shared``."""

    def __init__(self, gen, cfg: ArchConfig, device):
        super().__init__()
        m, d, dtype = cfg.moe, cfg.d_model, L.dtype_of(cfg)
        self.cfg = cfg
        self.router = L._param(L.dense_init(gen, d, m.num_experts,
                                            torch.float32, device))
        self.experts = Experts(gen, m, d, dtype, device)
        if m.num_shared:
            self.shared = L.MLP(gen, d, m.num_shared * m.d_ff_shared, dtype,
                                device)

    def forward(self, x: torch.Tensor):
        """x (B, S, d) → (y (B, S, d), switch aux loss, float32 scalar)."""
        if has_rule("moe_a2a") and current_mesh() is not None:
            # explicit expert-parallel dataflow over the mesh's model axis
            from repro_torch.models.moe_a2a import moe_ffn_a2a
            return moe_ffn_a2a(self, self.cfg, x)
        m = self.cfg.moe
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        probs, gates, expert_idx, pos, keep, cap = route(
            xf.to(torch.float32) @ self.router, m)
        eid = expert_idx.reshape(-1)
        safe_pos = torch.where(keep, pos, cap - 1)
        src = xf.repeat_interleave(m.top_k, dim=0)            # (T·k, d)
        slab = x.new_zeros((m.num_experts, cap, d))
        slab.index_put_((eid, safe_pos),
                        torch.where(keep[:, None], src, 0), accumulate=True)
        out_slab = self.experts(slab)
        gathered = torch.where(keep[:, None], out_slab[eid, safe_pos], 0)
        w = gates.reshape(-1, 1).to(gathered.dtype)
        y = (gathered * w).reshape(b * s, m.top_k, d).sum(1)
        if m.num_shared:
            y = y + self.shared(xf)
        # switch aux loss: fraction-of-tokens × mean-prob per expert
        me = probs.mean(0)
        ce = torch.nn.functional.one_hot(
            expert_idx[:, 0], m.num_experts).to(torch.float32).mean(0)
        aux = m.num_experts * (me * ce).sum() * m.router_aux_loss
        return y.reshape(b, s, d), aux
