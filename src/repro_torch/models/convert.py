"""Carry the JAX package's parameters and decode caches across to the port.

The reference stacks each pattern group's layers (``params["groups"][gi]
[pi][...]`` has a leading repeat axis ``r``); layer ``start + r *
len(pattern) + pi`` of the port takes slice ``r``. Inputs are the
reference's pytrees with every leaf already a numpy array
(``jax.tree_util.tree_map(np.asarray, params)``), so nothing here imports
JAX. bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16) keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


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


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path + ".")
        else:
            yield path, v


def _layer_slices(cfg: ArchConfig, stacked_groups: list):
    """(layer index, leaf dict, repeat r) for every layer."""
    for gi, (reps, pattern, start) in enumerate(_groups(cfg)):
        for pi in range(len(pattern)):
            for r in range(reps):
                yield start + r * len(pattern) + pi, stacked_groups[gi][pi], r


def params_from_jax(np_params: dict, cfg: ArchConfig,
                    device=None) -> transformer.LM:
    """The reference's parameter pytree (numpy leaves) → an ``LM`` on
    ``device`` holding the same values in the same dtype."""
    model = transformer.LM(cfg, device=device)
    dev = model.device
    seen = set()

    def put(name: str, value) -> None:
        p = model.get_parameter(name)
        v = to_torch(value, dev)
        if tuple(v.shape) != tuple(p.shape) or v.dtype != p.dtype:
            raise ValueError(f"{name}: reference {tuple(v.shape)} {v.dtype}"
                             f" vs port {tuple(p.shape)} {p.dtype}")
        p.copy_(v)
        seen.add(name)

    with torch.no_grad():
        put("embed", np_params["embed"]["table"])
        put("final_norm.scale", np_params["final_norm"]["scale"])
        if "lm_head" in np_params:
            put("lm_head", np_params["lm_head"]["kernel"])
        for li, tree, r in _layer_slices(cfg, np_params["groups"]):
            for path, leaf in _leaves(tree):
                put(f"layers.{li}.{path}", np.asarray(leaf)[r])
    missing = {n for n, _ in model.named_parameters()} - seen
    if missing:
        raise ValueError(f"parameters the reference did not give: "
                         f"{sorted(missing)}")
    return model


def cache_from_jax(np_caches: list, cfg: ArchConfig,
                   device=None) -> list[dict]:
    """The reference's stacked decode caches (numpy leaves) → the port's
    per-layer cache dicts."""
    out: list = [None] * cfg.n_layers
    for li, c, r in _layer_slices(cfg, np_caches):
        out[li] = {"k": to_torch(np.asarray(c["k"])[r], device),
                   "v": to_torch(np.asarray(c["v"])[r], device),
                   "kpos": to_torch(np.asarray(c["kpos"])[r], device),
                   "pos": int(np.asarray(c["pos"])[r])}
    return out
