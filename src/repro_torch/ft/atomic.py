"""Atomic single-file JSON commit (the index manifest's writer).

Copied from the JAX package's ``ft/atomic.py``; the port needs only the
single-file commit so far. Write ``path.tmp``, fsync, ``os.replace``: a
build killed mid-write leaves the previous manifest or none, never a torn
one.
"""
from __future__ import annotations

import json
import os

TMP_SUFFIX = ".tmp"


def atomic_write_json(path: str, obj) -> None:
    """Write ``obj`` as JSON to ``path`` atomically."""
    tmp = path + TMP_SUFFIX
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
