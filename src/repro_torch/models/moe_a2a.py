"""Expert-parallel MoE dispatch by all-to-all over the ``model`` axis: a port
of the JAX package's ``models/moe_a2a.py``.

Tokens are grouped by the rank that holds their expert and exchanged with
``all_to_all_single`` over the ``model`` group, so a rank's traffic is the
routed token payload (t_loc·k·d). Per rank, as in the reference's
``shard_map`` body:

  x_loc (t_loc, d) → route: send (ep, cap_pair, d) → all-to-all →
  recv (ep, cap_pair, d) holding tokens whose experts live here →
  local slab (e_loc, cap_loc, d) → SwiGLU → reverse all-to-all → combine.

Capacity is per (source, destination) pair, ``cap_pair``, and per local
expert the fair share ``cap_loc``; dropped tokens follow the GShard
capacity semantics. Each assignment's local expert id (+1; 0 = empty)
rides a side channel. The aux loss is averaged over every mesh axis.

``x`` is this rank's tokens: the batch is split over the axes other than
``model`` and replicated over ``model``, as the reference's batch spec has
it, so every rank of a ``model`` group routes the same tokens and each
expert sees them once from every source. The exchanges are differentiable
(``_AllToAll``: the backward is the reverse exchange); an expert's weight
gradient therefore arrives ``ep`` times, and ``_LocalExperts`` divides it
out and gathers the full gradient back onto every rank of the group, the
layout of the replicated weights the caller passes (whole, or gathered by
``dist.sharding.ShardedParams``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.dist.sharding import current_mesh
from repro_torch.models.moe import top_k


def _ranks_by_sort(dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    """Position of each element within its destination group (1-D)."""
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    starts = torch.searchsorted(sorted_dest,
                                torch.arange(n_dest, device=dest.device))
    ranks_sorted = (torch.arange(dest.shape[0], device=dest.device)
                    - starts[sorted_dest])
    return torch.empty_like(dest).scatter_(0, order, ranks_sorted)


class _AllToAll(torch.autograd.Function):
    """Blocks of dim 0 exchanged over ``axis``; backward: the reverse
    exchange, which is the same one."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g.contiguous(), ctx.axis), None, None


class _LocalExperts(torch.autograd.Function):
    """This rank's experts (rows [j·e_loc, (j+1)·e_loc) of each stacked
    weight); backward: the rank's gradient over ``ep`` identical sources,
    divided by ``ep`` and all-gathered, so every rank holds the full
    gradient of the replicated weights."""

    @staticmethod
    def forward(ctx, mesh, axis, e_loc, *ws):
        ctx.mesh, ctx.axis = mesh, axis
        j = mesh.axis_index(axis)
        return tuple(w[j * e_loc:(j + 1) * e_loc].contiguous() for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        ep = ctx.mesh.axis_size(ctx.axis)
        return (None, None, None, *(ctx.mesh.all_gather(g / ep, ctx.axis)
                                    for g in gs))


class _MeanOverMesh(torch.autograd.Function):
    """The mean of a scalar over every rank (the reference's pmean over
    each axis); its transpose is the same mean."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x, mesh.axis_names) / mesh.size

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return mesh.all_reduce(g, mesh.axis_names) / mesh.size, None


def moe_ffn_a2a(moe, cfg: ArchConfig, x: torch.Tensor,
                axis_name: str = "model"):
    """``moe``: a ``models.moe.MoE`` (router, stacked experts, shared
    experts) with its full weights; x: this rank's (b_loc, s, d) tokens →
    (y (b_loc, s, d), aux). Requires an ambient mesh with ``axis_name``."""
    mesh = current_mesh()
    if mesh is None or axis_name not in mesh.shape:
        raise ValueError("moe_ffn_a2a needs an active mesh with a "
                         f"'{axis_name}' axis")
    m: MoEConfig = cfg.moe
    ep = mesh.shape[axis_name]
    if m.num_experts % ep:
        raise ValueError(f"{m.num_experts} experts do not divide the "
                         f"{axis_name} axis of {ep}")
    e_loc = m.num_experts // ep
    b, s, d = x.shape
    t_loc = b * s
    xf = x.reshape(t_loc, d)
    logits = xf.to(torch.float32) @ moe.router
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, m.top_k)                        # (t_loc, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    flat_e = eidx.reshape(-1)                                 # (t_loc·k,)
    dest = torch.div(flat_e, e_loc, rounding_mode="floor")    # target rank
    cap_pair = max(8, int(m.capacity_factor * t_loc * m.top_k / ep))
    rank = _ranks_by_sort(dest, ep)
    keep = rank < cap_pair
    slot = torch.where(keep, rank, cap_pair - 1)

    src = xf.repeat_interleave(m.top_k, dim=0)
    payload = torch.where(keep[:, None], src, 0)
    send = x.new_zeros((ep, cap_pair, d)).index_put(
        (dest, slot), payload, accumulate=True)
    # local expert index (+1; 0 = empty slot) rides a side channel
    send_eid = torch.zeros((ep, cap_pair), dtype=torch.int64,
                           device=x.device).index_put(
        (dest, slot), torch.where(keep, flat_e % e_loc + 1, 0),
        accumulate=True)

    recv = _AllToAll.apply(send, mesh, axis_name)
    recv = recv.reshape(ep * cap_pair, d)
    eid_loc = mesh.all_to_all(send_eid, axis_name).reshape(ep * cap_pair)

    # local expert compute: scatter into (e_loc, cap_loc, d), no exchange;
    # cap_loc is the fair share per local expert (the reference's choice).
    # Empty slots rank in a group of their own (the reference ranks them
    # with local expert 0, where they take its capacity from the tokens of
    # later sources: ROADMAP §3)
    cap_loc = max(8, (ep * cap_pair) // e_loc)
    lrank = _ranks_by_sort(torch.where(eid_loc > 0, eid_loc - 1, e_loc),
                           e_loc + 1)
    occupied = (eid_loc > 0) & (lrank < cap_loc)
    lslot = torch.where(occupied, torch.clamp_max(lrank, cap_loc - 1),
                        cap_loc - 1)
    lexp = torch.where(occupied, eid_loc - 1, 0)
    slab = x.new_zeros((e_loc, cap_loc, d)).index_put(
        (lexp, lslot), torch.where(occupied[:, None], recv, 0),
        accumulate=True)
    e = moe.experts
    wg, wu, wd = _LocalExperts.apply(mesh, axis_name, e_loc, e.w_gate,
                                     e.w_up, e.w_down)
    h = torch.nn.functional.silu(torch.bmm(slab, wg)) * torch.bmm(slab, wu)
    out = torch.bmm(h, wd)
    back = torch.where(occupied[:, None], out[lexp, lslot], 0)

    # reverse route + combine
    ret = _AllToAll.apply(back.reshape(ep, cap_pair, d).contiguous(), mesh,
                          axis_name)
    gathered = torch.where(keep[:, None], ret[dest, slot], 0)
    w = gate.reshape(-1, 1).to(gathered.dtype)
    y = (gathered * w).reshape(t_loc, m.top_k, d).sum(1)

    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(
        eidx[:, 0], m.num_experts).to(torch.float32).mean(0)
    aux = m.num_experts * (me * ce).sum() * m.router_aux_loss
    aux = _MeanOverMesh.apply(aux, mesh)
    if m.num_shared:
        y = y + moe.shared(xf)
    return y.reshape(b, s, d), aux
