"""The split of the ``model`` axis's compute: the counterpart of GSPMD
partitioning the reference's activation annotations.

The reference annotates activations with logical axes (``heads`` and
``kv_heads`` at ``models/layers.py``, ``mlp`` on the MLP's hidden and the
SSD heads and RG-LRU width, ``vocab`` on the logits, ``experts`` on the MoE
slab) and GSPMD splits the compute along ``model`` wherever the rules
resolve them there. Here each rank runs its share explicitly, Megatron
style:

* **The layout.** ``split(n, logical)`` gives (m, j): the ``model`` axis's
  size and this rank's index along it where the logical axis of a
  dimension of size ``n`` resolves to ``model`` under the current rules
  (``dist.sharding.logical_spec``: permissive, so a dimension ``model``
  does not divide stays whole, m = 1), and (1, 0) outside a ``scope`` or
  where the batch itself is split over ``model`` (``--dp-over-model``: the
  reference's activations then take ``model`` on their batch dimension and
  none other).
* **The two crossings.** A split region starts at ``copy_in`` (identity
  forward, a sum over ``model`` backward: each rank's share of the input's
  gradient is partial) and ends at ``reduce_out`` (a sum over ``model``
  forward, identity backward). Column-parallel products (``wq``, ``w_gate``,
  ``w_up``, the vocabulary) open a region, row-parallel ones (``wo``,
  ``w_down``, ``out_proj``) close it with one reduction.
* **The parameters.** ``param_plan`` names, for every parameter a split
  region uses, the dimension its compute splits (None where the rank
  takes a non-contiguous selection of it, or the whole of it). The
  parameter store (``dist.sharding.ShardedParams``) keeps a parameter's
  ``model`` part local where its layout splits that same dimension over
  ``model`` and gathers it otherwise; a region then takes its share of a
  whole tensor with ``take``. The gradient of a whole tensor used in a
  region is partial on each rank and is summed over ``model``.

The module code reads the layout from the shapes it is given: a layer
whose ``wq`` holds H/m heads runs H/m heads, and a layer given whole
tensors outside a scope runs as on one card.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from repro_torch.dist import sharding as shd

AXIS = "model"
_state = threading.local()


@contextlib.contextmanager
def scope(mesh, batch_axes: tuple = (), train: bool = False):
    """Within the scope, regions split over ``mesh``'s ``model`` axis; the
    batch's rows are split over ``batch_axes``; ``train``: the scope is a
    training step's (``training``)."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, tuple(batch_axes), train)
    try:
        yield
    finally:
        _state.ctx = prev


def captured(fn):
    """``fn`` run under the scope, the sharding rules and the ambient mesh
    current now, whichever thread runs it: for a block that remat
    recomputes in the backward pass, which autograd runs on a device
    thread of its own for CUDA tensors (the three are thread-local)."""
    ctx, rules, mesh = (getattr(_state, "ctx", None), dict(shd._rules()),
                        shd.current_mesh())

    def run(*args, **kwargs):
        prev = (getattr(_state, "ctx", None), dict(shd._rules()),
                shd.current_mesh())
        _state.ctx, shd._state.rules = ctx, dict(rules)
        shd.set_mesh(mesh)
        try:
            return fn(*args, **kwargs)
        finally:
            _state.ctx, shd._state.rules = prev[0], prev[1]
            shd.set_mesh(prev[2])
    return run


def scope_mesh():
    """The mesh of the current scope (None outside one)."""
    ctx = getattr(_state, "ctx", None)
    return None if ctx is None else ctx[0]


def batch_axes() -> tuple:
    """The axes the current scope's batch rows are split over (() outside a
    scope)."""
    ctx = getattr(_state, "ctx", None)
    return () if ctx is None else ctx[1]


def training() -> bool:
    """The current scope is a training step's: a value only training reads
    (the MoE aux loss) is then worth its collectives."""
    ctx = getattr(_state, "ctx", None)
    return ctx is not None and ctx[2]


def mesh_of_scope():
    """The mesh of the current scope, where it splits ``model``; else
    None."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return None
    mesh, batch_axes = ctx[:2]
    if mesh.shape.get(AXIS, 1) == 1 or AXIS in batch_axes:
        return None
    return mesh


def split(n: int, logical: str) -> tuple[int, int]:
    """(m, j) of a dimension of size ``n`` annotated ``logical`` (module
    docstring)."""
    mesh = mesh_of_scope()
    if mesh is None:
        return 1, 0
    if shd.logical_spec(mesh, (n,), logical).spec[0] != AXIS:
        return 1, 0
    return mesh.shape[AXIS], mesh.axis_index(AXIS)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), AXIS), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, m: int) -> torch.Tensor:
    """Enter a region split m ways (identity for m = 1)."""
    return x if m == 1 else _CopyIn.apply(x, mesh_of_scope())


def reduce_out(x: torch.Tensor, m: int) -> torch.Tensor:
    """Leave a region split m ways: the sum of the ranks' partial results
    (identity for m = 1)."""
    return x if m == 1 else _ReduceOut.apply(x, mesh_of_scope())


def all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """A sum (or max) over ``model`` of a value no gradient flows through
    (a softmax's row max)."""
    return mesh_of_scope().all_reduce(x, AXIS, op)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' parts of ``dim`` concatenated over ``model`` (no
    gradient: decode and logits)."""
    return mesh_of_scope().all_gather(x.contiguous(), AXIS, dim)


def take(w: torch.Tensor, dim: int, m: int, j: int, full: int
         ) -> torch.Tensor:
    """This rank's chunk j of m along ``dim`` of a tensor whose dimension
    has ``full`` entries: a view of ``w`` where it holds them all, ``w``
    itself where it is already the chunk."""
    if m == 1 or w.shape[dim] != full:
        return w
    return w.narrow(dim, j * (full // m), full // m)


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(x, axes) / mesh.axis_size(axes)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_reduce(g.contiguous(), ctx.axes)
                / ctx.mesh.axis_size(ctx.axes), None, None)


class _SharedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axes), None, None


def shared_sum(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """The sum over ``axes`` of the ranks' parts of a value that every rank
    of the group then computes on alike (the MoE slab the reference
    replicates over the batch axes); each rank's part feeds every rank's
    loss, so its gradient is summed over ``axes`` too."""
    return _SharedSum.apply(x, mesh, tuple(axes))


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch axes of the scope of a per-rank mean over
    equal row counts: the mean over the global batch (the MoE aux loss's
    statistics, which the reference takes over the whole batch); ``x``
    itself outside a scope or where the batch is whole."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or not ctx[1]:
        return x
    return _BatchMean.apply(x, ctx[0], ctx[1])


def grad_scale(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x`` whose gradient is divided by m: a replicated value inside a
    region (the MoE aux loss), whose gradient the sum over ``model`` would
    otherwise count m times."""
    if m == 1:
        return x
    return x / m + (x - x / m).detach()


def kv_span(h: int, hkv: int, m: int, j: int) -> tuple[int, int]:
    """The KV heads [k0, k1) that the query heads of rank j (of m) read."""
    hl, g = h // m, h // hkv
    return (j * hl) // g, ((j + 1) * hl - 1) // g + 1


# -- the parameters' compute layout ------------------------------------------
def param_plan(model: torch.nn.Module, mesh, batch_axes: tuple = ()
               ) -> dict[str, Optional[int]]:
    """{parameter name: the dimension its compute splits over ``model``,
    or None} for every parameter a split region uses (module docstring);
    parameters of replicated compute are absent."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import ssm as ssm_mod
    plan: dict[str, Optional[int]] = {}
    with scope(mesh, batch_axes):
        for prefix, mod in model.named_modules():
            pre = f"{prefix}." if prefix else ""
            if isinstance(mod, L.Attention):
                cfg = mod.cfg
                if split(cfg.n_heads, "heads")[0] == 1:
                    continue
                kv = 1 if split(cfg.n_kv_heads, "kv_heads")[0] > 1 else None
                plan.update({pre + "wq": 1, pre + "wo": 0, pre + "wk": kv,
                             pre + "wv": kv})
                for norm in ("q_norm", "k_norm"):
                    if hasattr(mod, norm):
                        plan[f"{pre}{norm}.scale"] = None
            elif isinstance(mod, L.MLP):
                if split(mod.d_ff, "mlp")[0] > 1:
                    plan.update({pre + "w_gate": 1, pre + "w_up": 1,
                                 pre + "w_down": 0})
            elif isinstance(mod, moe_mod.MoE):
                if (not shd.has_rule("moe_a2a") and
                        split(mod.cfg.moe.num_experts, "experts")[0] > 1):
                    plan.update({pre + "router": None,
                                 pre + "experts.w_gate": 0,
                                 pre + "experts.w_up": 0,
                                 pre + "experts.w_down": 0})
            elif isinstance(mod, ssm_mod.SSM):
                if split(ssm_mod.dims(mod.cfg)[2], "mlp")[0] > 1:
                    plan.update({pre + "in_proj": None, pre + "conv": None,
                                 pre + "A_log": 0, pre + "D": 0,
                                 pre + "dt_bias": 0, pre + "out_proj": 0})
            elif isinstance(mod, rglru_mod.RGLRU):
                if split(rglru_mod.width(mod.cfg), "mlp")[0] > 1:
                    plan.update({pre + "w_x": 1, pre + "w_gate_in": 1,
                                 pre + "conv": 1, pre + "a_param": 0,
                                 pre + "in_gate_w": 0,
                                 pre + "rec_gate_w": 0, pre + "out": 0})
        if split(model.cfg.vocab, "vocab")[0] > 1:
            plan["embed"] = 0
            if hasattr(model, "lm_head"):
                plan["lm_head"] = 1
    return plan
