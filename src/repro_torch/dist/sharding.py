"""Logical-axis sharding over a process mesh: a port of the JAX package's
``dist/sharding.py`` (DESIGN §5), and the sharded parameter store that
stands where the reference hands its trees to GSPMD.

Model code annotates *logical* axes (``batch``, ``heads``, ``mlp``, ...);
a mutable rule table resolves them to mesh axes, flax
``logical_axis_rules`` style:

    shd.set_mesh(mesh)
    with shd.axis_rules(cache_seq=("model",)):
        spec = shd.logical_spec(mesh, x.shape, "batch", "seq", "embed").spec

Resolution is permissive, as in the reference: a logical axis with no rule,
a rule naming mesh axes that don't exist, or a dimension the mesh axes don't
divide all resolve to *replicated*. A ``NamedSharding``'s ``spec`` holds one
entry per dimension (``None``, an axis name or a tuple of them), equal to
the reference's ``PartitionSpec`` entries; the resolvers read only
``mesh.shape``. ``shard(x, *axes)`` is the identity on a rank's local
tensor: the reference's own behaviour where collectives own the layout.

``param_shardings`` derives a parameter's sharding from the name and shape
of the reference leaf it belongs to (``models.convert.reference_layout``):
embedding tables and expert stacks shard over ``model``; ``fsdp=True``
also spreads the largest remaining dim over ``data``. The reference stacks
each layer group's parameters, and its rules may shard that stack axis;
the port holds one tensor per layer, so a stack entry makes the layer's
tensor live whole on the ranks whose coordinate holds its stack position.

``ShardedParams`` is the counterpart of ``jax.device_put(params,
param_shardings(...))`` for training and serving: each rank holds its
slice of every parameter; a block's parameters are all-gathered just
before it runs (and again when remat recomputes it) and dropped after; the
gradients are reduce-scattered back onto the shards, summed over the axes
the batch was split over. The batch is replicated over ``model``, as the
reference's batch spec has it, and the ranks of a ``model`` group split
the compute of each block between them (``dist.tensor_parallel``: heads,
MLP columns, experts, SSD heads, RG-LRU width, the vocabulary, as GSPMD
splits the reference's annotated activations). A parameter is gathered
only over the axes whose split its use does not keep: its ``model`` part
stays local wherever its layout splits the dimension the compute splits
(``wq``'s columns, ``w_down``'s rows, the vocabulary's rows), and its
gradient is then summed over the batch axes only; a parameter gathered
whole for a split region (``wk`` where the KV heads do not divide
``model``; a stacked leaf whose layout names ``model`` on its layer axis)
has a partial gradient on each rank, summed over ``model`` too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional

import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

# -- rule table --------------------------------------------------------------
# logical axis -> tuple of physical mesh axes (joint sharding, flax-style).
# () = explicitly replicated. Absent = no rule (has_rule -> False), also
# replicated. Feature-flag rules ("moe_a2a", "moe_tokens") never name an
# array dimension; they gate alternative dataflows via has_rule().
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": (),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert_mlp": ("model",),
    "experts": ("model",),
    "capacity": (),
    "cache_seq": (),
}

_state = threading.local()


def _rules() -> dict[str, tuple[str, ...]]:
    if not hasattr(_state, "rules"):
        _state.rules = dict(DEFAULT_RULES)
    return _state.rules


def set_mesh(mesh) -> None:
    """Install (or clear, with None) the ambient mesh."""
    _state.mesh = mesh


def current_mesh():
    return getattr(_state, "mesh", None)


def has_rule(name: str) -> bool:
    """True iff logical axis ``name`` has a non-empty rule installed."""
    return bool(_rules().get(name))


def rule(name: str) -> tuple[str, ...]:
    """The mesh axes logical axis ``name`` resolves to (() where it has no
    rule)."""
    return tuple(_rules().get(name, ()))


@contextlib.contextmanager
def axis_rules(**rules):
    """Override logical→mesh rules within a scope.

    Values may be a mesh-axis name, a tuple of names, True (alias for a
    bare feature flag, resolved to ("model",)), or None/() to disable.
    """
    old = dict(_rules())
    table = _rules()
    for k, v in rules.items():
        table[k] = _tuplize(v)
    try:
        yield
    finally:
        _state.rules = old


def _tuplize(v) -> tuple[str, ...]:
    if v is None or v is False:
        return ()
    if v is True:
        return ("model",)
    if isinstance(v, str):
        return (v,)
    return tuple(v)


# -- resolution --------------------------------------------------------------
def _resolve_dim(mesh, dim: int, logical: Optional[str], used: set[str]):
    """Logical axis -> spec entry for one dim (or None)."""
    if logical is None:
        return None
    axes = [a for a in _rules().get(logical, ())
            if a in mesh.shape and a not in used]
    if not axes:
        return None
    prod = 1
    for a in axes:
        prod *= mesh.shape[a]
    if prod == 0 or dim % prod != 0:
        return None
    used.update(axes)
    return axes[0] if len(axes) == 1 else tuple(axes)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout on ``mesh``: ``spec``, one entry per dimension of the
    reference's array. ``stack``: for a layer's tensor, (its position, the
    stack's length) in the reference's stacked leaf, whose leading entry
    ``spec[0]`` is then the stack axis's; the tensor's own dimensions take
    ``spec[1:]``."""
    mesh: Any
    spec: tuple
    stack: Optional[tuple[int, int]] = None

    @property
    def dims(self) -> tuple:
        """The entries of the tensor's own dimensions."""
        return self.spec[1:] if self.stack is not None else self.spec

    def owner(self) -> Optional[tuple[tuple, int]]:
        """(stack axes, index along them) of the ranks holding a layer
        whose stack is sharded, else None."""
        if self.stack is None or self.spec[0] is None:
            return None
        axes = _entry_axes(self.spec[0])
        n = math.prod(self.mesh.shape[a] for a in axes)
        pos, reps = self.stack
        return axes, pos // (reps // n)

    def holds(self) -> bool:
        """This rank holds a part of the tensor."""
        own = self.owner()
        return own is None or self.mesh.axis_index(own[0]) == own[1]

    def named_axes(self) -> set[str]:
        out = {a for e in self.dims for a in _entry_axes(e)}
        own = self.owner()
        return out | set(own[0]) if own else out

    def canonical(self) -> bool:
        """This rank holds the copy of its part that a sum over the mesh
        counts: index 0 along every axis the layout does not name."""
        named = self.named_axes()
        return self.holds() and all(
            self.mesh.coords[a] == 0 for a in self.mesh.shape
            if a not in named)

    def local_shape(self, shape, keep: tuple = ()) -> tuple:
        """The shape of the tensor gathered over every named axis but
        ``keep``."""
        out = list(shape)
        for d, e in enumerate(self.dims):
            if e is not None and set(_entry_axes(e)) <= set(keep):
                out[d] //= self.mesh.axis_size(_entry_axes(e))
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``full`` (the counterpart of
        ``jax.device_put(full, sharding)``); an empty tensor where the rank
        holds none. A copy of its own."""
        if not self.holds():
            return full.new_empty((0,))
        t = full
        for d, e in enumerate(self.dims):
            if e is not None:
                axes = _entry_axes(e)
                t = t.chunk(self.mesh.axis_size(axes), d)[
                    self.mesh.axis_index(axes)]
        return t.clone()

    def gather(self, local: torch.Tensor, shape, keep: tuple = ()
               ) -> torch.Tensor:
        """The full tensor from every rank's part (collective over the
        mesh: every rank calls it for the same tensors in one order); the
        dimensions split over axes within ``keep`` stay this rank's."""
        if self.holds():
            t = local
            for d in reversed(range(len(self.dims))):
                e = self.dims[d]
                if e is not None and not set(_entry_axes(e)) <= set(keep):
                    t = self.mesh.all_gather(t, _entry_axes(e), d)
        else:
            t = local.new_empty(self.local_shape(shape, keep))
        own = self.owner()
        if own is not None:
            t = self.mesh.broadcast(t, own[0], own[1])
        return t

    def reduce_grad(self, g: torch.Tensor, batch_axes: tuple,
                    keep: tuple = ()) -> torch.Tensor:
        """A gradient of this rank's rows (of the tensor ``gather`` gave
        with ``keep``) → this rank's part of the gradient summed over
        ``batch_axes`` (collective)."""
        own = self.owner()
        if own is not None:
            axes, idx = own
            if set(axes) & set(batch_axes):
                g = self.mesh.reduce(g, axes, idx)
            if self.mesh.axis_index(axes) != idx:
                return g.new_empty((0,))
        named = self.named_axes()
        rest = tuple(a for a in batch_axes if a not in named)
        if rest:
            g = self.mesh.all_reduce(g, rest)
        for d, e in enumerate(self.dims):
            if e is None or set(_entry_axes(e)) <= set(keep):
                continue
            axes = _entry_axes(e)
            if set(axes) <= set(batch_axes):
                g = self.mesh.reduce_scatter(g, axes, d)
            else:
                g = g.chunk(self.mesh.axis_size(axes), d)[
                    self.mesh.axis_index(axes)]
        return g.contiguous()


def logical_spec(mesh, shape, *axes) -> NamedSharding:
    """NamedSharding for ``shape`` annotated with logical ``axes``, one entry
    per dim (None for replicated); extra dims beyond the list replicate."""
    used: set[str] = set()
    entries = []
    for i, dim in enumerate(shape):
        logical = axes[i] if i < len(axes) else None
        entries.append(_resolve_dim(mesh, int(dim), logical, used))
    return NamedSharding(mesh, tuple(entries))


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """The identity: a rank holds its local tensor, and the collectives of
    the mesh paths own the layout."""
    return x


# -- parameter shardings -----------------------------------------------------
# leaf-name patterns -> which dim carries the ``model`` axis. (-1 = last,
# 0 = first.) Output projections shard their *input* (contracting) dim so
# the preceding activation sharding is consumed without a reshard.
_MODEL_DIM_BY_NAME = {
    "table": 0,      # (V, d) embedding: vocab over model
    "router": -1,    # (d, E): experts over model
    "w_gate": -1, "w_up": -1, "w1": -1,
    "wq": -1, "wk": -1, "wv": -1, "w_in": -1,
    "w_down": 0, "wo": 0, "w2": 0, "w_out": 0,
}


def _param_spec(mesh, pstr: str, shape, *, fsdp: bool) -> tuple:
    """The reference's spec of the leaf at path ``pstr`` ("/"-joined)."""
    nd = len(shape)
    entries: list = [None] * nd
    model_ok = "model" in mesh.shape
    data_ok = "data" in mesh.shape
    name = pstr.rsplit("/", 1)[-1]

    if nd >= 2 and model_ok:
        m = mesh.shape["model"]
        dim = _MODEL_DIM_BY_NAME.get(name)
        if nd == 3 and "experts" in pstr:
            dim = 0  # stacked (E, din, dout): expert-parallel over model
        if dim is None:
            # fallback: largest divisible dim
            order = sorted(range(nd), key=lambda i: -shape[i])
            dim = next((i for i in order if shape[i] % m == 0), None)
        else:
            dim = dim % nd
            if shape[dim] % m != 0:
                dim = None
        if dim is not None:
            entries[dim] = "model"

    if fsdp and nd >= 2 and data_ok:
        d = mesh.shape["data"]
        order = sorted(range(nd), key=lambda i: -shape[i])
        for i in order:
            if entries[i] is None and shape[i] % d == 0:
                entries[i] = "data"
                break
    return tuple(entries)


def param_shardings(params, mesh, *, fsdp: bool = False
                    ) -> dict[str, NamedSharding]:
    """{parameter name: NamedSharding} for a model (an ``LM`` or
    ``EncDec``): each tensor takes the spec of the reference leaf it belongs
    to (its path and stacked shape from ``convert.reference_layout``)."""
    from repro_torch.models.convert import reference_layout
    out = {}
    for name, (pstr, shape, stack) in reference_layout(params).items():
        out[name] = NamedSharding(mesh, _param_spec(mesh, pstr, shape,
                                                    fsdp=fsdp), stack)
    return out


def batch_axes_of(mesh, batch_rows: int) -> tuple[str, ...]:
    """The mesh axes a global batch of ``batch_rows`` rows is split over:
    the ``"batch"`` rule's, resolved (none if they do not divide it)."""
    return _entry_axes(logical_spec(mesh, (batch_rows,), "batch").spec[0])


# -- the sharded parameter store ---------------------------------------------
class _Gather(torch.autograd.Function):
    """Parts → full tensors; backward: full gradients → the parts' summed
    gradients (one node per block, so every rank runs its collectives in
    one order)."""

    @staticmethod
    def forward(ctx, store, names, *parts):
        ctx.store, ctx.names = store, names
        return tuple(store.shardings[n].gather(p, store.shapes[n],
                                               store.keep.get(n, ()))
                     for n, p in zip(names, parts))

    @staticmethod
    def backward(ctx, *grads):
        store = ctx.store
        out = []
        for n, g in zip(ctx.names, grads):
            sh, keep = store.shardings[n], store.keep.get(n, ())
            if g is None:
                g = torch.zeros(sh.local_shape(store.shapes[n], keep),
                                dtype=store.dtypes[n], device=store.device)
            axes = store.batch_axes + (("model",) if n in store.partial
                                       else ())
            out.append(sh.reduce_grad(g, axes, keep))
        return (None, None, *out)


@contextlib.contextmanager
def _bound(model: torch.nn.Module, tensors: dict):
    """Within the scope, ``model``'s parameters ``tensors`` (by name) read
    as the given tensors; the parameters come back after."""
    saved = []
    for name, t in tensors.items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        saved.append((mod, attr, mod._parameters.pop(attr)))
        setattr(mod, attr, t)
    try:
        yield
    finally:
        for mod, attr, p in saved:
            delattr(mod, attr)
            mod._parameters[attr] = p


class ShardedParams:
    """A model's parameters held as this rank's parts on ``mesh``.

    The model keeps its structure with empty parameters; ``named_parameters``
    yields the parts (what the optimizer updates and the gradients are
    taken against). ``loss(bundle, batch)`` runs ``bundle.loss`` with every
    block's parameters gathered around its call: the top-level ones
    (embedding, final norm, frontend) for the whole loss, each of
    ``model.layers`` by forward hooks (its recomputation under remat too). ``batch_axes``: the axes the rows of
    the current batch were split over (the gradients' sum), from
    ``batch_rows``, the global batch's rows, where it is given; the compute
    split over ``model`` (``tensor_parallel.param_plan``) follows them.
    ``keep``: {name: ("model",)} for the parameters whose ``model`` part
    stays local; ``partial``: the names gathered whole whose gradient is
    summed over ``model``."""

    def __init__(self, model: torch.nn.Module, mesh, *, fsdp: bool = False,
                 batch_rows: Optional[int] = None):
        from repro_torch.dist import tensor_parallel as tp
        self.model = model
        self.mesh = mesh
        self.device = mesh.device
        self.shardings = param_shardings(model, mesh, fsdp=fsdp)
        self.batch_axes: tuple = (() if batch_rows is None
                                  else batch_axes_of(mesh, batch_rows))
        plan = tp.param_plan(model, mesh, self.batch_axes)
        self.keep = {n: ("model",) for n, d in plan.items()
                     if d is not None and self._splits(n, d)}
        self.partial = {n for n in plan if n not in self.keep}
        self.shapes, self.dtypes, self.parts = {}, {}, {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                self.shapes[name] = tuple(p.shape)
                self.dtypes[name] = p.dtype
                self.parts[name] = self.shardings[name].shard(p.data)
                p.data = p.data.new_empty((0,))
        layers = getattr(model, "layers", None)
        self.blocks = []
        if isinstance(layers, torch.nn.ModuleList):
            for i, block in enumerate(layers):
                names = [f"layers.{i}.{n}" for n, _ in
                         block.named_parameters()]
                self.blocks.append((block, names))
        in_block = {n for _, names in self.blocks for n in names}
        self.top = [n for n in self.parts if n not in in_block]
        self._hook_blocks()

    def _splits(self, name: str, dim: int) -> bool:
        """The layout of ``name`` splits its dimension ``dim`` over
        ``model`` alone, and not its layer stack."""
        sh = self.shardings[name]
        own = sh.owner()
        return (sh.dims[dim] == "model"
                and (own is None or "model" not in own[0]))

    # -- the optimizer's view ------------------------------------------------
    def named_parameters(self):
        return iter(self.parts.items())

    def requires_grad_(self, flag: bool = True) -> "ShardedParams":
        for t in self.parts.values():
            t.requires_grad_(flag)
        return self

    def grad_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of gradients given by part: every part counted
        once over the mesh."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for n, g in grads.items():
            if self.shardings[n].canonical():
                total = total + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(self.mesh.all_reduce(total, self.mesh.axis_names))

    # -- gathering -----------------------------------------------------------
    def gather(self, names: list[str]) -> dict:
        """Full tensors of ``names``, differentiable into the parts."""
        full = _Gather.apply(self, tuple(names),
                             *(self.parts[n] for n in names))
        return dict(zip(names, full))

    def _hook_blocks(self) -> None:
        """Gather each block's parameters around every call of it: its
        forward, and its recomputation in the backward pass (remat), so
        the hooks stay for the store's life."""
        for block, names in self.blocks:
            scope = []

            def pre(mod, args, names=names, scope=scope):
                # "layers.{i}.attn.wq" → the block's own "attn.wq"
                local = {n.split(".", 2)[2]: t
                         for n, t in self.gather(names).items()}
                cm = _bound(mod, local)
                cm.__enter__()
                scope.append(cm)

            def post(mod, args, out, scope=scope):
                scope.pop().__exit__(None, None, None)

            block.register_forward_pre_hook(pre)
            block.register_forward_hook(post)

    def scope(self, train: bool = False):
        """The compute split of this store's model (``tensor_parallel
        .scope``), for a call and for its backward pass; ``train``: a
        training step's."""
        from repro_torch.dist import tensor_parallel as tp
        return tp.scope(self.mesh, self.batch_axes, train)

    def call(self, fn, *args, train: bool = False):
        """``fn(model, *args)`` on this rank's rows with the gathered
        parameters, split over ``model`` (a prefill, a decode step, a
        cache's set-up; ``train``: a training step's loss)."""
        # remat's recomputation runs each block to its end, so the block's
        # post-hook drops the parameters it gathered
        with self.scope(train), set_checkpoint_early_stop(False), \
                _bound(self.model, self.gather(self.top)):
            return fn(self.model, *args)

    def loss(self, bundle, batch: dict):
        """``bundle.loss`` of a training step on this rank's batch rows
        with the gathered parameters → (loss, metrics)."""
        return self.call(bundle.loss, batch, train=True)

    def full(self, tensors: dict) -> dict:
        """Full tensors of per-name parts laid out as the parameters (the
        parameters' own, or optimizer moments), gathered without a graph;
        on every rank."""
        with torch.no_grad():
            return {n: self.shardings[n].gather(t, self.shapes[n])
                    for n, t in tensors.items()}
