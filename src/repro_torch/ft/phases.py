"""Per-phase commit markers for resumable ``DiskJoinIndex.build``.

An index build is a pipeline of full-store scans and derivations —
sample centers → assign blocks → [sketch] → [layout order] → write
buckets. Each phase commits its outputs atomically under
``<workdir>/build_phases/<phase>/`` with a ``marker.json`` carrying the
build-config fingerprint. A build killed between phases restarts at the
first phase without a committed marker instead of rescanning the flat
store from the top; a build whose config changed (different fingerprint)
silently discards the stale phases and rebuilds from scratch — stale
markers must never leak a different config's centers into this build.

Layout per phase::

    <dir>/sample/
        marker.json         — {"fingerprint": …, "extra": {…}}
        arr_centers.npy     — named arrays committed with the marker
    <dir>/assign.tmp/       — torn write from a kill; reaped on open
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

from repro_torch.ft.atomic import atomic_commit_dir, reap_tmp
from repro_torch.ft.atomic import fingerprint as _fp

MARKER = "marker.json"


class PhaseLog:
    def __init__(self, directory: str, config_fingerprint: str):
        self.directory = directory
        self.fingerprint = config_fingerprint
        os.makedirs(directory, exist_ok=True)
        reap_tmp(directory)
        # drop committed phases from a different build config
        for name in os.listdir(directory):
            path = os.path.join(directory, name)
            marker = os.path.join(path, MARKER)
            if not os.path.isfile(marker):
                continue
            try:
                with open(marker) as f:
                    fp = json.load(f).get("fingerprint")
            except (OSError, ValueError):
                fp = None
            if fp != config_fingerprint:
                shutil.rmtree(path, ignore_errors=True)

    def path(self, phase: str) -> str:
        return os.path.join(self.directory, phase)

    def has(self, phase: str) -> bool:
        return os.path.isfile(os.path.join(self.path(phase), MARKER))

    def commit(self, phase: str, writer=None, extra: dict | None = None
               ) -> str:
        """Commit a finished phase: ``writer(tmp)`` (optional) fills the
        payload, the marker rides in the same atomic rename."""
        def fill(tmp: str) -> None:
            if writer is not None:
                writer(tmp)
            with open(os.path.join(tmp, MARKER), "w") as f:
                json.dump({"fingerprint": self.fingerprint,
                           "extra": extra or {}}, f)
        return atomic_commit_dir(self.directory, phase, fill)

    def commit_arrays(self, phase: str, extra: dict | None = None,
                      **arrays) -> str:
        return self.commit(
            phase,
            lambda tmp: [np.save(os.path.join(tmp, f"arr_{k}.npy"), v)
                         for k, v in arrays.items()],
            extra=extra)

    def load_arrays(self, phase: str) -> dict[str, np.ndarray]:
        out = {}
        for name in os.listdir(self.path(phase)):
            if name.startswith("arr_") and name.endswith(".npy"):
                out[name[4:-4]] = np.load(
                    os.path.join(self.path(phase), name))
        return out

    def load_meta(self, phase: str) -> dict:
        with open(os.path.join(self.path(phase), MARKER)) as f:
            return json.load(f).get("extra", {})

    def clear(self) -> None:
        """Build finished (manifest committed): the log has served its
        purpose; remove it so the workdir holds only live state."""
        shutil.rmtree(self.directory, ignore_errors=True)


def build_fingerprint(build_cfg_dict: dict, store_shape, layout) -> str:
    """Digest identifying one build: config + source extent + layout
    request. Any difference invalidates committed phases."""
    return _fp({"cfg": build_cfg_dict, "shape": list(store_shape),
                "layout": layout})
