"""DiskJoin one-shot API (paper §3 workflow) — a DEPRECATED wrapper.

    similarity_self_join(store, config)  →  JoinResult

A thin shim over the build-once / query-many session API
(``repro_torch.core.index.DiskJoinIndex``): it builds a throwaway index in
the workdir, runs exactly one join against it, folds the build time back
into the result's timings and closes the session. Build a
``DiskJoinIndex`` once instead for ε-sweeps or repeated calls. The
one-shot cross-join waits for the cross-join slice of the port.
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.core.index import DiskJoinIndex
from repro_torch.core.types import JoinConfig, JoinResult
from repro_torch.store.vector_store import FlatVectorStore

_deprecation_warned: set[str] = set()


def _warn_deprecated(name: str) -> None:
    if name in _deprecation_warned:
        return
    _deprecation_warned.add(name)
    warnings.warn(
        f"{name}() is deprecated: it rebuilds the bucketed layout on every "
        f"call. Build a DiskJoinIndex once and use index.self_join / "
        f"index.query instead.", DeprecationWarning, stacklevel=3)


def similarity_self_join(store: FlatVectorStore, config: JoinConfig,
                         workdir: str | None = None,
                         attribute_mask=None,
                         io_mode: str | None = None, *,
                         device=None) -> JoinResult:
    """SSJ over a flat on-disk dataset under a memory budget: equivalent
    to ``DiskJoinIndex.build(store, config, workdir, device=device)
    .self_join(attribute_mask=...)`` with the build cost folded into
    ``timings``. ``device``: ``None`` (CUDA) or ``"cpu"``."""
    _warn_deprecated("similarity_self_join")
    if io_mode is not None:
        config = dataclasses.replace(config, io_mode=io_mode)
    index = DiskJoinIndex.build(store, config, workdir, device=device)
    try:
        result = index.self_join(attribute_mask=attribute_mask)
        result.timings = index.merge_build_timings(result.timings)
        return result
    finally:
        index.close()
