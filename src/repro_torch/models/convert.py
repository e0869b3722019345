"""Carry the JAX package's parameters and decode caches across to the port.

Decoder-only models: the reference stacks each pattern group's layers
(``params["groups"][gi][pi][...]`` has a leading repeat axis ``r``); layer
``start + r * len(pattern) + pi`` of the port takes slice ``r``. The MoE
FFN (float32 router, experts stacked over E), the SSM and RG-LRU blocks
and the VLM frontend keep the reference's names under their layer. Enc-dec
models keep the reference's unstacked ``encoder``/``decoder`` lists. A
``"table"`` or ``"kernel"`` leaf of an embedding or head is the port's
parameter of the enclosing name. Inputs are the reference's pytrees with
every leaf already a numpy array (``jax.tree_util.tree_map(np.asarray,
params)``), so nothing here imports JAX. bfloat16 leaves (numpy's
``ml_dtypes`` bfloat16) keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer


def _groups(cfg: ArchConfig) -> list[tuple[int, tuple[str, ...], int]]:
    """(repeats, pattern, start_layer_idx) groups covering n_layers: a copy
    of the reference's ``transformer._groups``."""
    groups: list[tuple[int, tuple[str, ...], int]] = []
    pattern = tuple(cfg.block_pattern)
    start = 0
    dense_k = cfg.moe.first_k_dense if cfg.moe is not None else 0
    if dense_k:
        full, part = divmod(dense_k, len(pattern))
        if full:
            groups.append((full, pattern, 0))
        if part:
            groups.append((1, _rot(pattern, full * len(pattern))[:part],
                           full * len(pattern)))
        start = dense_k
    reps, rem = divmod(cfg.n_layers - start, len(pattern))
    if reps:
        groups.append((reps, _rot(pattern, start), start))
    if rem:
        groups.append((1, _rot(pattern, start + reps * len(pattern))[:rem],
                       start + reps * len(pattern)))
    return groups


def _rot(pattern: tuple[str, ...], abs_idx: int) -> tuple[str, ...]:
    k = abs_idx % len(pattern)
    return pattern[k:] + pattern[:k]


def to_torch(x, device=None) -> torch.Tensor:
    """numpy array (bfloat16 included) → tensor with the same bits."""
    x = np.array(x)  # a writable copy of its own
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t.to(device)


def _leaves(tree, prefix: str = ""):
    """(dotted path, leaf) of a pytree of dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            yield from _leaves(v, path + ".")
        else:
            yield path, v


def _layer_slices(cfg: ArchConfig, stacked_groups: list):
    """(layer index, leaf dict, repeat r) for every layer."""
    for gi, (reps, pattern, start) in enumerate(_groups(cfg)):
        for pi in range(len(pattern)):
            for r in range(reps):
                yield start + r * len(pattern) + pi, stacked_groups[gi][pi], r


def reference_leaves(cfg: ArchConfig, names) -> list[list[str]]:
    """The port's parameter ``names`` grouped by the reference leaf each came
    from: a decoder-only layer's ``layers.{i}.{path}`` joins the other
    layers at the same pattern position of its group (the reference stacks
    them into one leaf); every other name is a leaf of its own. Groups in
    the order of their first name, names in the given order."""
    position = {}
    if not cfg.enc_dec:
        for gi, (reps, pattern, start) in enumerate(_groups(cfg)):
            for pi in range(len(pattern)):
                for r in range(reps):
                    position[start + r * len(pattern) + pi] = (gi, pi)
    groups: dict = {}
    for name in names:
        parts = name.split(".")
        key = name
        if parts[0] == "layers" and not cfg.enc_dec:
            key = ("groups", *position[int(parts[1])], ".".join(parts[2:]))
        groups.setdefault(key, []).append(name)
    return list(groups.values())


def reference_layout(model) -> dict[str, tuple[str, tuple, object]]:
    """{port parameter name: (the reference leaf's path, "/"-joined as the
    reference's ``param_shardings`` names it; the leaf's shape; (r, reps)
    where the leaf stacks ``reps`` layers and this tensor is slice r, else
    None)} for an ``LM`` or ``EncDec`` built by the port."""
    cfg = model.cfg
    position = {}
    if not cfg.enc_dec:
        for gi, (reps, pattern, start) in enumerate(_groups(cfg)):
            for pi in range(len(pattern)):
                for r in range(reps):
                    position[start + r * len(pattern) + pi] = (gi, pi, r,
                                                               reps)
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers" and not cfg.enc_dec:
            gi, pi, r, reps = position[int(parts[1])]
            path = "/".join(["groups", str(gi), str(pi)] + parts[2:])
            out[name] = (path, (reps,) + tuple(p.shape), (r, reps))
            continue
        if len(parts) == 1:   # embed.table, pos_embed.table, lm_head.kernel
            parts.append("kernel" if name == "lm_head" else "table")
        out[name] = ("/".join(parts), tuple(p.shape), None)
    return out


def _port_name(path: str) -> str:
    """``embed.table`` → ``embed``, ``lm_head.kernel`` → ``lm_head``; other
    paths are the port's as they are."""
    for leaf in (".table", ".kernel"):
        if path.endswith(leaf) and path.count(".") == 1:
            return path[:-len(leaf)]
    return path


def _named_leaves(np_params: dict, cfg: ArchConfig):
    """(port parameter name, value) of every reference leaf."""
    for path, leaf in _leaves({k: v for k, v in np_params.items()
                               if k != "groups"}):
        yield _port_name(path), leaf
    if cfg.enc_dec:
        return
    for li, tree, r in _layer_slices(cfg, np_params["groups"]):
        for path, leaf in _leaves(tree):
            yield f"layers.{li}.{path}", np.asarray(leaf)[r]


def params_from_jax(np_params: dict, cfg: ArchConfig, device=None):
    """The reference's parameter pytree (numpy leaves) → an ``LM`` (or an
    ``EncDec``) on ``device`` holding the same values in the same dtype."""
    model = (encdec.EncDec(cfg, device=device) if cfg.enc_dec
             else transformer.LM(cfg, device=device))
    dev = model.device
    seen = set()
    with torch.no_grad():
        for name, value in _named_leaves(np_params, cfg):
            p = model.get_parameter(name)
            v = to_torch(value, dev)
            if tuple(v.shape) != tuple(p.shape) or v.dtype != p.dtype:
                raise ValueError(f"{name}: reference {tuple(v.shape)} "
                                 f"{v.dtype} vs port {tuple(p.shape)} "
                                 f"{p.dtype}")
            p.copy_(v)
            seen.add(name)
    missing = {n for n, _ in model.named_parameters()} - seen
    if missing:
        raise ValueError(f"parameters the reference did not give: "
                         f"{sorted(missing)}")
    return model


def _cache_dict(c: dict, r=None, device=None) -> dict:
    """One layer's cache (slice ``r`` of stacked leaves): ``pos`` a host
    int, every other leaf a tensor."""
    def pick(v):
        v = np.asarray(v)
        return v if r is None else v[r]
    return {k: int(pick(v)) if k == "pos" else to_torch(pick(v), device)
            for k, v in c.items()}


def cache_from_jax(np_caches, cfg: ArchConfig, device=None):
    """The reference's decode caches (numpy leaves) → the port's: for a
    decoder-only model one dict per layer (attention: k, v, kpos, pos; SSM
    and RG-LRU: state, conv); for enc-dec the reference's dict of
    ``self`` caches, ``cross_k``/``cross_v`` lists and ``pos``."""
    if cfg.enc_dec:
        return {"self": [_cache_dict(c, device=device)
                         for c in np_caches["self"]],
                "cross_k": [to_torch(k, device)
                            for k in np_caches["cross_k"]],
                "cross_v": [to_torch(v, device)
                            for v in np_caches["cross_v"]],
                "pos": int(np.asarray(np_caches["pos"]))}
    out: list = [None] * cfg.n_layers
    for li, c, r in _layer_slices(cfg, np_caches):
        out[li] = _cache_dict(c, r, device)
    return out
