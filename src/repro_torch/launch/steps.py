"""The step functions: a port of the JAX package's ``launch/steps.py``.

``make_train_step``: loss → gradients → AdamW update, one call; with a
mesh, on this rank's rows of the global batch and the parameters' parts
(``dist.sharding.ShardedParams``).
``make_serve_step``: one decode step against the caches.
``prepare_cell``: one (arch × shape) cell's step and its arguments on one
card, or as one rank of a mesh, the counterpart of the reference's
``lower_cell``.
``batch_shardings``, ``cache_shardings``, ``opt_state_shardings``: the
reference's sharding trees, as ``dist.sharding.NamedSharding``s with its
spec entries.

The reference's functions are pure and jitted, with donated buffers; these
run eagerly and update the parameters, the optimizer state and the caches
in place. ``lower_cell`` lowers a cell on an abstract mesh without
allocating; ``prepare_cell`` allocates the cell on the card, since the
census (``launch/census.py``) runs it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.dist import sharding as shd
from repro_torch.models.model_api import ModelBundle, fill_inputs
from repro_torch.train.optimizer import AdamW, AdamWConfig

# the reference's single pod: 16 × 16 chips share a cell's global batch
POD_CHIPS = 256


def make_train_step(bundle: ModelBundle, opt: AdamW, mesh=None,
                    batch_axes=None):
    """train_step(params, opt_state, batch) → (params, opt_state, metrics):
    the loss and its gradient with respect to every parameter (the
    parameters are set to require grad here: they are built without), then
    ``opt.update``. Metrics: the loss's own ("nll", "aux"), "grad_norm",
    "lr" and "loss", as 0-d tensors or floats, read by the caller.

    With ``mesh``, ``params`` is a ``ShardedParams`` and ``batch`` the
    global batch: this rank takes its rows by the ``"batch"`` rule, and
    its loss is weighted so that the sum over the batch axes is the global
    loss, the token mean over the whole batch plus the mean aux loss; the
    gradients come back onto the parts summed over those axes, and AdamW
    updates the parts (its clip norm and the int8 compressor's scales
    reduced over the mesh). ``batch_axes``, where given, says the batch is
    already this rank's rows, split over those axes (the dry-run makes
    only its own rows)."""
    if mesh is not None:
        return _sharded_train_step(bundle, opt, mesh, batch_axes)

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        names, tensors = zip(*params.named_parameters())
        with torch.enable_grad():
            loss, metrics = bundle.loss(params, batch)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        params, opt_state, opt_metrics = opt.update(
            dict(zip(names, grads)), opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def local_rows(mesh, batch: dict) -> tuple[dict, tuple]:
    """This rank's rows of a global batch (tensors with a leading batch
    dim), split as the ``"batch"`` rule resolves → (rows, the axes split
    over; () where the rule does not divide the batch)."""
    rows = next(iter(batch.values())).shape[0]
    axes = shd.batch_axes_of(mesh, rows)
    if not axes:
        return dict(batch), axes
    n, i = mesh.axis_size(axes), mesh.axis_index(axes)
    return {k: v.chunk(n, 0)[i] for k, v in batch.items()}, axes


def _sharded_train_step(bundle: ModelBundle, opt: AdamW, mesh,
                        batch_axes=None):
    def train_step(params, opt_state, batch):
        if batch_axes is None:
            local, axes = local_rows(mesh, batch)
        else:
            local, axes = batch, tuple(batch_axes)
        params.batch_axes = axes
        params.requires_grad_(True)
        labels = torch.as_tensor(local["labels"], device=mesh.device)
        count = (labels[:, 1:] >= 0).sum().to(torch.float32)
        total = mesh.all_reduce(count, axes)
        names, tensors = zip(*params.named_parameters())
        # the split over ``model`` holds for the backward pass too (remat
        # recomputes split blocks)
        with torch.enable_grad(), params.scope(train=True):
            _, metrics = params.loss(bundle, local)
            nll = metrics["nll"]
            aux = metrics.get("aux", torch.zeros_like(nll))
            # summed over the batch axes: the global token mean + mean aux
            loss = (nll * (count / torch.clamp_min(total, 1.0))
                    + aux / mesh.axis_size(axes))
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        params, opt_state, opt_metrics = opt.update(
            dict(zip(names, grads)), opt_state, params)
        out = {k: mesh.all_reduce(v.detach(), axes) / mesh.axis_size(axes)
               for k, v in metrics.items() if k != "nll"}
        out["nll"] = mesh.all_reduce(
            (nll * count).detach(), axes) / torch.clamp_min(total, 1.0)
        out.update(opt_metrics)
        out["loss"] = mesh.all_reduce(loss.detach(), axes)
        return params, opt_state, out

    return train_step


def make_serve_step(bundle: ModelBundle):
    """serve_step(params, caches, tokens) → (logits, caches), under
    ``torch.inference_mode`` (no graph, nothing saved)."""

    def serve_step(params, caches, tokens):
        with torch.inference_mode():
            return bundle.decode(params, tokens, caches)

    return serve_step


def per_card_batch(shape: ShapeSpec) -> int:
    """Sequences one card runs: the reference's 16 × 16 pod's share of a
    chip, ``global_batch // 256``, and one whole sequence where the pod
    gives a chip less than one."""
    return max(1, shape.global_batch // POD_CHIPS)


def _attn_caches(bundle: ModelBundle, caches) -> list[dict]:
    """Every self-attention cache (dicts holding ``kpos``) of ``caches``."""
    layers = caches["self"] if bundle.cfg.enc_dec else caches
    return [c for c in layers if "kpos" in c]


def fill_cache_positions(bundle: ModelBundle, caches, pos: int) -> None:
    """Set the caches as if positions 0 .. pos − 1 had been decoded: each
    attention cache's rolling slots hold the latest position ≡ slot (mod
    its length), and the next write lands at ``pos``. The keys and values
    stay as allocated (zeros): a step's work does not depend on them."""
    for c in _attn_caches(bundle, caches):
        local = c["kpos"].shape[0]
        _, n, i = c.get("seq_shard", ((), 1, 0))
        steps = local * n   # the rows of a cache split over its sequence
        slot = i * local + torch.arange(local, dtype=torch.int64)
        last = slot + steps * torch.div(pos - 1 - slot, steps,
                                        rounding_mode="floor")
        c["kpos"].copy_(torch.where(slot < pos, last, -1).to(torch.int32))
    _reset_positions(bundle, caches, pos)


def _reset_positions(bundle: ModelBundle, caches, pos: int) -> None:
    """The next write of every attention cache lands at ``pos``."""
    for c in _attn_caches(bundle, caches):
        c["pos"] = pos
    if bundle.cfg.enc_dec:
        caches["pos"] = pos


def decode_rules(shape: ShapeSpec) -> dict:
    """The reference's decode rule (``lower_cell``): a cache's rows over
    ``model``, or over ``data`` and ``model`` at batch 1."""
    if shape.kind != "decode":
        return {}
    return {"cache_seq": (("data", "model") if shape.global_batch == 1
                          else ("model",))}


def seq_shard_of(mesh, steps: int):
    """(axes, n, i) of a cache of ``steps`` rows under the ``cache_seq``
    rule on ``mesh``; None where the rule leaves it whole."""
    entry = shd.logical_spec(mesh, (steps,), "cache_seq").spec[0]
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return axes, mesh.axis_size(axes), mesh.axis_index(axes)


def _in_rules(fn, mesh, rules: dict):
    """``fn`` called with the mesh and the rules installed."""
    def run(*args):
        with shd.axis_rules(**rules):
            shd.set_mesh(mesh)
            try:
                return fn(*args)
            finally:
                shd.set_mesh(None)
    return run


def prepare_cell(bundle: ModelBundle, shape: ShapeSpec, *, device=None,
                 generator: torch.Generator, mesh=None, fsdp: bool = False,
                 extra_rules=None):
    """One cell on one card → (step, args, {"kind": ...}): ``step(*args)``
    runs the cell's step once (repeatable).

    The batch is ``per_card_batch`` sequences, filled from ``generator``
    by ``fill_inputs``; the parameters are seeded from it too.

    * ``train``: ``make_train_step`` with a fresh ``AdamW`` (the default
      config) → ``"train_step"``; each call updates the parameters and
      the optimizer state in place.
    * ``prefill``: ``bundle.prefill`` under ``torch.inference_mode`` →
      ``"prefill_step"``.
    * ``decode``: one token against caches of the full ``seq_len``, set by
      ``fill_cache_positions`` as if ``seq_len`` − 1 positions had been
      decoded, so the step attends to the whole cache; each call first
      resets the positions, so every call is that same last step →
      ``"serve_step"``. Enc-dec caches carry zero cross-attention K/V over
      the encoder's frames, as the reference's cache stand-ins do.

    ``device``, where given, must be the bundle's.

    With ``mesh``, the cell is one rank of it, as the reference's
    ``lower_cell`` shards it: the decode rule (``decode_rules``) and
    ``extra_rules`` installed; the rank's rows of the global batch
    (``batch_shardings``), made here alone; the parameters' parts
    (``ShardedParams``, ``fsdp`` as the reference's) with the compute
    split over ``model``; AdamW over the parts; the rank's slice of each
    cache (``cache_shardings``: rows by ``cache_seq``). The step installs
    the rules and the mesh around every call. → (step, args, info) with
    ``info["rows"]``, the rank's rows, split over ``info["batch_axes"]``."""
    if device is not None and torch.device(device).type != \
            bundle.device.type:
        raise ValueError(f"bundle lives on {bundle.device}, not {device}")
    if mesh is not None:
        return _prepare_sharded(bundle, shape, mesh, generator, fsdp,
                                extra_rules)
    cfg = bundle.cfg
    run = dataclasses.replace(shape, global_batch=per_card_batch(shape))
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
    params = bundle.init(seed)
    batch = fill_inputs(bundle.input_specs(run), cfg.vocab, generator,
                        bundle.device)
    if shape.kind == "train":
        opt = AdamW(AdamWConfig())
        return (make_train_step(bundle, opt),
                (params, opt.init(params), batch), {"kind": "train_step"})
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with torch.inference_mode():
                return bundle.prefill(params, batch)
        return prefill_step, (params, batch), {"kind": "prefill_step"}
    b, pos = run.global_batch, run.seq_len - 1
    if cfg.enc_dec:
        caches = bundle.init_cache(b, run.seq_len, params=params)
    else:
        caches = bundle.init_cache(b, run.seq_len)
    fill_cache_positions(bundle, caches, pos)
    serve = make_serve_step(bundle)

    def serve_step(params, caches, tokens):
        _reset_positions(bundle, caches, pos)
        return serve(params, caches, tokens)

    return serve_step, (params, caches, batch["tokens"]), \
        {"kind": "serve_step"}


def _prepare_sharded(bundle: ModelBundle, shape: ShapeSpec, mesh,
                     generator: torch.Generator, fsdp: bool, extra_rules):
    cfg = bundle.cfg
    rules = dict(decode_rules(shape))
    rules.update(extra_rules or {})
    with shd.axis_rules(**rules):
        axes = shd.batch_axes_of(mesh, shape.global_batch)
        rows = shape.global_batch // mesh.axis_size(axes)
        run = dataclasses.replace(shape, global_batch=rows)
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
        store = shd.ShardedParams(bundle.init(seed), mesh, fsdp=fsdp,
                                  batch_rows=shape.global_batch)
        batch = fill_inputs(bundle.input_specs(run), cfg.vocab, generator,
                            bundle.device)
    info = {"batch_axes": axes, "rows": rows}
    if shape.kind == "train":
        opt = AdamW(AdamWConfig())
        step = make_train_step(bundle, opt, mesh, batch_axes=axes)
        return (_in_rules(step, mesh, rules),
                (store, opt.init(store), batch), dict(info, kind="train_step"))
    if shape.kind == "prefill":
        def prefill_step(store, batch):
            with torch.inference_mode():
                return store.call(bundle.prefill, batch)
        return (_in_rules(prefill_step, mesh, rules), (store, batch),
                dict(info, kind="prefill_step"))
    pos = shape.seq_len - 1

    def make_caches(model):
        shards = (lambda steps: seq_shard_of(mesh, steps))
        if cfg.enc_dec:
            return bundle.init_cache(rows, shape.seq_len, params=model,
                                     seq_shards=shards)
        return bundle.init_cache(rows, shape.seq_len, seq_shards=shards)

    with torch.no_grad():
        caches = _in_rules(store.call, mesh, rules)(make_caches)
    fill_cache_positions(bundle, caches, pos)

    def serve_step(store, caches, tokens):
        _reset_positions(bundle, caches, pos)
        with torch.inference_mode():
            return store.call(bundle.decode, tokens, caches)

    return (_in_rules(serve_step, mesh, rules),
            (store, caches, batch["tokens"]), dict(info, kind="serve_step"))


# ---------------------------------------------------------------------------
# sharding trees (the reference's, with its spec entries)
# ---------------------------------------------------------------------------
def batch_shardings(mesh, specs: dict) -> dict:
    """{input name: NamedSharding} for ``input_specs``' stand-ins ({name:
    (shape, dtype)}): tokens and labels split their batch dim, patches and
    frames theirs; anything else replicates."""
    out = {}
    for k, (shape, _) in specs.items():
        if k in ("tokens", "labels"):
            axes = ["batch"] + [None] * (len(shape) - 1)
        elif k in ("patches", "frames"):
            axes = ["batch", None, None]
        else:
            axes = [None] * len(shape)
        out[k] = shd.logical_spec(mesh, shape, *axes)
    return out


def _cache_axes(pstr: str, nd: int) -> list:
    """Logical axes of one cache leaf by its path, right-aligned (the
    reference's stacked layer dims lead and replicate)."""
    if "cross_k" in pstr or "cross_v" in pstr:
        axes = ["batch", None, "kv_heads", None]      # (B, F, H, D)
    elif pstr.endswith("/k") or pstr.endswith("/v"):
        axes = ["batch", "cache_seq", "kv_heads", None]
    elif pstr.endswith("kpos") or pstr.endswith("pos"):
        axes = []
    elif pstr.endswith("state") and nd >= 4:
        axes = ["batch", "mlp", None, None]           # ssm (B,H,P,N)
    elif pstr.endswith("state"):
        axes = ["batch", "mlp"]                       # rglru (B,W)
    elif pstr.endswith("conv"):
        axes = ["batch", None, "mlp"]
    else:
        axes = []
    return [None] * (nd - len(axes)) + axes


def cache_shardings(mesh, caches):
    """The caches' tree (``bundle.init_cache``: a list of per-layer dicts,
    or enc-dec's dict) with a NamedSharding for every leaf, keyed on the
    leaf's path as the reference keys its own ("…/k", "cross_k/…"); an
    integer ``pos`` replicates."""
    def one(path: str, leaf):
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        return shd.logical_spec(mesh, shape,
                                *_cache_axes(path, len(shape)))

    def walk(tree, path: str):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{path}/{i}" if path else str(i))
                    for i, v in enumerate(tree)]
        return one(path, tree)

    return walk(caches, "")


def opt_state_shardings(mesh, opt_state: dict, params_shardings: dict
                        ) -> dict:
    """The optimizer state's tree: the moments (and the int8 compressor's
    error) laid out as the parameters; the step replicated."""
    out = {"mu": dict(params_shardings), "nu": dict(params_shardings),
           "step": shd.NamedSharding(mesh, ())}
    if "error" in opt_state:
        out["error"] = dict(params_shardings)
    return out
