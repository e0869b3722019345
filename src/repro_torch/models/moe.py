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

On a mesh whose ``model`` axis the experts resolve to (``experts``), rank
j of m routes the tokens it holds (the batch is replicated over ``model``)
and runs the slabs of its E/m experts, [j·E/m, (j+1)·E/m), only; one
reduction over ``model`` sums the ranks' outputs, the shared experts'
column-parallel share with them. In a training step the aux loss's
statistics are averaged over the batch axes, so that it is the whole
batch's, as the reference's (a prefill or decode step does not read it).

The slab follows the reference's ``capacity`` rule. By default the rule is
empty and the reference's (E, C, d) slab is replicated over the batch
axes: C is the capacity of the global batch, every rank holds all of it,
and a token's slot is its position among the whole batch's assignments.
So the ranks of the batch axes rank their expert ids together (one gather
of the (T·k,) ids), each scatters its own tokens into the global slots,
and one sum over the batch axes (``tensor_parallel.shared_sum``, a sum in
the backward pass too) gives every rank the whole slab, whose experts it
runs alike. ``--capacity-data`` cuts C over ``data``: the slab is then
shared only over the batch axes the rule leaves out (``pod`` on 2×16×16,
none on 16×16), and a rank's share of C is the capacity of the tokens of
its group. The reference's ``moe_tokens`` rule
(``--moe-replicated-dispatch``) installs an empty rule, which ``has_rule``
reads as none, so it changes the dataflow of neither package.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import current_mesh, has_rule, rule
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


def route(logits: torch.Tensor, m: MoEConfig, shared=None):
    """float32 router logits (T, E) → (probs (T, E), gates (T, k)
    renormalised, expert ids (T, k), position-in-expert (T·k,), keep
    (T·k,), capacity). ``shared``: (mesh, axes) whose ranks' tokens fill
    one slab (``slab_group``): the capacity is then that of the group's
    tokens and the positions are among the group's assignments, in rank
    order along ``axes``."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = top_k(probs, m.top_k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    eid = expert_idx.reshape(-1)
    if shared is None:
        cap, pos = capacity(m, t), positions(eid, e)
    else:
        mesh, axes = shared
        n = mesh.axis_size(axes)
        cap = capacity(m, n * t)
        every = mesh.all_gather(eid, axes)
        pos = positions(every, e).reshape(n, -1)[mesh.axis_index(axes)]
    return probs, gates, expert_idx, pos, pos < cap, cap


def positions(eid: torch.Tensor, e: int) -> torch.Tensor:
    """Position-in-expert of each of the (T·k,) assignments, by
    rank-by-sort: assignment j of expert e ranks by its place among e's
    assignments in (token, k) order."""
    order = torch.argsort(eid, stable=True)
    eid_sorted = eid[order]
    starts = torch.searchsorted(eid_sorted,
                                torch.arange(e, device=eid.device))
    ranks_sorted = (torch.arange(eid.numel(), device=eid.device)
                    - starts[eid_sorted])
    return torch.empty_like(eid).scatter_(0, order, ranks_sorted)


def slab_group():
    """(mesh, axes): the batch axes of the current split over which the
    reference's slab is replicated, those its ``capacity`` rule does not
    cut (module docstring); None where there are none."""
    mesh = tp.scope_mesh()
    if mesh is None:
        return None
    cut = set(rule("capacity"))
    axes = tuple(a for a in tp.batch_axes() if a not in cut)
    return (mesh, axes) if mesh.axis_size(axes) > 1 else None


class Experts(nn.Module):
    """The routed experts' SwiGLU weights, stacked over experts:
    w_gate/w_up (E, d, d_ff_expert), w_down (E, d_ff_expert, d)."""

    def __init__(self, gen, m: MoEConfig, d: int, dtype, device):
        super().__init__()
        e, f = m.num_experts, m.d_ff_expert
        self.num_experts = e
        self.w_gate = L._param(_stack_init(gen, e, d, f, dtype, device))
        self.w_up = L._param(_stack_init(gen, e, d, f, dtype, device))
        self.w_down = L._param(_stack_init(gen, e, f, d, dtype, device))

    def forward(self, slab: torch.Tensor, m: int = 1, j: int = 0
                ) -> torch.Tensor:
        """(E/m, C, d) → (E/m, C, d): the experts of rank j of m."""
        wg, wu, wd = (tp.take(w, 0, m, j, self.num_experts)
                      for w in (self.w_gate, self.w_up, self.w_down))
        h = (torch.nn.functional.silu(torch.bmm(slab, wg))
             * torch.bmm(slab, wu))
        return torch.bmm(h, wd)


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
        n, j = tp.split(m.num_experts, "experts")
        e_loc = m.num_experts // n
        xf = tp.copy_in(x, n).reshape(b * s, d)
        shared = slab_group()
        probs, gates, expert_idx, pos, keep, cap = route(
            xf.to(torch.float32) @ self.router, m, shared)
        eid = expert_idx.reshape(-1)
        if n > 1:   # this rank's experts only
            keep = keep & (eid >= j * e_loc) & (eid < (j + 1) * e_loc)
            eid = torch.where(keep, eid - j * e_loc, 0)
        safe_pos = torch.where(keep, pos, cap - 1)
        src = xf.repeat_interleave(m.top_k, dim=0)            # (T·k, d)
        slab = x.new_zeros((e_loc, cap, d))
        slab.index_put_((eid, safe_pos),
                        torch.where(keep[:, None], src, 0), accumulate=True)
        if shared is not None:   # the group's tokens in one slab
            slab = tp.shared_sum(slab, *shared)
        out_slab = self.experts(slab, n, j)
        gathered = torch.where(keep[:, None], out_slab[eid, safe_pos], 0)
        w = gates.reshape(-1, 1).to(gathered.dtype)
        y = (gathered * w).reshape(b * s, m.top_k, d).sum(1)
        if m.num_shared:
            ys, ns = self.shared.partial(x.reshape(b * s, d))
            if ns == n:   # one reduction for both
                y = tp.reduce_out(y + ys, n)
            else:
                y = tp.reduce_out(y, n) + tp.reduce_out(ys, ns)
        else:
            y = tp.reduce_out(y, n)
        # switch aux loss: fraction-of-tokens × mean-prob per expert, over
        # the whole batch where a training step splits it over ranks
        me = probs.mean(0)
        ce = torch.nn.functional.one_hot(
            expert_idx[:, 0], m.num_experts).to(torch.float32).mean(0)
        if tp.training():
            me, ce = tp.batch_mean(me), tp.batch_mean(ce)
        aux = m.num_experts * (me * ce).sum() * m.router_aux_loss
        return y.reshape(b, s, d), tp.grad_scale(aux, n)
