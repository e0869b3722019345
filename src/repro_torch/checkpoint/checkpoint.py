"""Checkpoint/restart: a port of the JAX package's
``checkpoint/checkpoint.py``, with its on-disk layout.

Layout per step:
    <dir>/step_000000123.tmp/   — in-flight writes
        manifest.json           — step, leaf names and dtypes, extra
        arr_00000.npy …         — one file per leaf (bf16 stored as uint16)
    <dir>/step_000000123/       — atomic rename commit

A tree is nested dicts whose leaves are tensors (on any device), numpy
arrays or Python ints (the optimizer's step counter). Its leaves are
flattened in sorted-key order, as the reference's pytrees are, and named
by their dotted paths (``params.layers.0.attn.wq``, ``opt.mu.embed``);
the manifest keeps the names, and a restore whose example tree has other
names raises ``ValueError``.

Properties, as in the reference:
  * **atomic**: a checkpoint is visible only after the directory rename
    (``ft.atomic.atomic_commit_dir``); a crash mid-write leaves a ``.tmp``
    that restore ignores and cleanup reaps;
  * **async**: ``CheckpointManager(async_save=True)`` copies the tree to
    host memory on the training thread (a copy of its own, so later
    in-place updates of the parameters never reach it) and writes on a
    daemon thread (``ft.atomic.AsyncCommitter``, depth-1 backpressure);
  * the data pipeline's cursor rides in the manifest's ``extra``, so a
    restart resumes the same stream;
  * **re-sharding restore**: a checkpoint holds full arrays, whatever mesh
    wrote it (under a mesh, rank 0 writes what every rank gathered), and
    ``restore_latest(..., shardings=...)`` cuts each leaf to this rank's
    part of the current mesh: an elastic restart onto another topology, or
    onto one card without ``shardings``.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.ft.atomic import AsyncCommitter, atomic_commit_dir, reap_tmp


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(dotted name, leaf) of a tree of dicts, keys in sorted order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out += _flatten(tree[key], f"{prefix}.{key}" if prefix else key)
    return out


def _unflatten(example, values: dict, prefix: str = ""):
    if not isinstance(example, dict):
        return values[prefix]
    return {k: _unflatten(v, values, f"{prefix}.{k}" if prefix else k)
            for k, v in example.items()}


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A host copy of its own of one leaf → (array to save, dtype name);
    bf16 goes into a uint16 container."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree) -> list[tuple[str, np.ndarray, str]]:
    return [(name, *_host_array(leaf)) for name, leaf in _flatten(tree)]


def _write(directory: str, step: int, snap, extra: dict | None) -> str:
    def fill(tmp: str) -> None:
        for i, (_, arr, _) in enumerate(snap):
            np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr)
        manifest = {
            "step": step,
            "num_leaves": len(snap),
            "names": [name for name, _, _ in snap],
            "dtypes": [dtype for _, _, dtype in snap],
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    return atomic_commit_dir(directory, f"step_{step:09d}", fill)


def save_checkpoint(directory: str, step: int, tree, *,
                    extra: dict | None = None) -> str:
    """Blocking save. Returns the committed path."""
    return _write(directory, step, _snapshot(tree), extra)


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append((int(m.group(1)), os.path.join(directory, d)))
    return sorted(out)


def _restored(arr: np.ndarray, dtype: str, example):
    """A saved array as the example leaf's kind: a Python int for an int,
    else a CPU tensor of the saved dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if isinstance(example, (int, np.integer)) and arr.ndim == 0:
        return int(arr)
    return torch.from_numpy(arr)


def restore_latest(directory: str, example_tree, *, shardings=None):
    """Restore the newest checkpoint → (step, tree, extra) or None.

    ``example_tree`` fixes the structure: its leaf names must be the
    checkpoint's, else ``ValueError`` (another architecture). Tensor leaves
    come back as CPU tensors of the saved dtype; the caller copies them
    where they live. ``shardings``: a tree of the same names whose
    ``dist.sharding.NamedSharding`` leaves cut the full arrays to this
    rank's parts (None leaves stay whole)."""
    ckpts = list_checkpoints(directory)
    if not ckpts:
        return None
    step, path = ckpts[-1]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _flatten(example_tree)
    names = [name for name, _ in leaves]
    if manifest["num_leaves"] != len(leaves) or manifest["names"] != names:
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, model expects "
            f"{len(leaves)} — architecture mismatch: "
            f"{sorted(set(manifest['names']) ^ set(names))[:8]}")
    values = {}
    for i, ((name, ex), dt) in enumerate(zip(leaves, manifest["dtypes"])):
        arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"))
        values[name] = _restored(arr, dt, ex)
    if shardings is not None:
        for name, sharding in _flatten(shardings):
            if sharding is not None and isinstance(values[name],
                                                   torch.Tensor):
                values[name] = sharding.shard(values[name])
    return step, _unflatten(example_tree, values), manifest.get("extra", {})


def cleanup(directory: str, keep: int = 3) -> None:
    ckpts = list_checkpoints(directory)
    for _, path in ckpts[:-keep]:
        shutil.rmtree(path, ignore_errors=True)
    reap_tmp(directory)


class CheckpointManager:
    """Double-buffered async writer with bounded queue (depth 1: a slow
    disk can delay at most one snapshot, never corrupt one). The worker
    thread and error-surfacing live in ``ft.atomic.AsyncCommitter``."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._committer = (AsyncCommitter(name="train-ckpt")
                           if async_save else None)

    def _write(self, step: int, snap, extra: dict | None) -> None:
        _write(self.directory, step, snap, extra)
        cleanup(self.directory, self.keep)

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        snap = _snapshot(tree)   # on this thread: the state as it is now
        if self._committer is not None:
            # blocks if one write is in flight (depth-1 backpressure)
            self._committer.submit(lambda: self._write(step, snap, extra))
        else:
            self._write(step, snap, extra)

    def close(self) -> None:
        if self._committer is not None:
            self._committer.close()
