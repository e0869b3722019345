"""DiskJoin one-shot API (paper §3 workflow) — DEPRECATED wrappers.

    similarity_self_join(store, config)  →  JoinResult
    similarity_cross_join(store_x, store_y, config) → JoinResult

Thin shims over the build-once / query-many session API
(``repro_torch.core.index.DiskJoinIndex``): each builds throwaway indexes
in the workdir, runs exactly one join against them, folds the build time
back into the result's timings and closes the sessions. Build a
``DiskJoinIndex`` once instead for ε-sweeps or repeated calls. Each
wrapper emits a ``DeprecationWarning`` once per process.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import warnings

from repro_torch.core.bipartite import (CombinedBipartiteStore,
                                        CrossJoinExecutor)
from repro_torch.core.index import DiskJoinIndex
from repro_torch.core.types import JoinConfig, JoinResult
from repro_torch.store.vector_store import FlatVectorStore

# kept importable under the JAX package's private names
_CombinedBipartiteStore = CombinedBipartiteStore
_CrossJoinExecutor = CrossJoinExecutor

_deprecation_warned: set[str] = set()


def _warn_deprecated(name: str) -> None:
    if name in _deprecation_warned:
        return
    _deprecation_warned.add(name)
    warnings.warn(
        f"{name}() is deprecated: it rebuilds the bucketed layout on every "
        f"call. Build a DiskJoinIndex once and use index.self_join / "
        f"index.cross_join / index.query instead.",
        DeprecationWarning, stacklevel=3)


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


def similarity_cross_join(store_x: FlatVectorStore, store_y: FlatVectorStore,
                          config: JoinConfig, workdir: str | None = None,
                          reorder_larger: bool = True,
                          io_mode: str | None = None,
                          attribute_mask=None, *,
                          device=None) -> JoinResult:
    """Cross-join (§3 extension): bipartite graph over two bucketings,
    equivalent to building one ``DiskJoinIndex`` per side (on ``device``:
    ``None`` is CUDA, or ``"cpu"``) and calling
    ``index_x.cross_join(index_y, ...)``.

    ``reorder_larger=True`` is the paper's DiskJoin1 (stream the larger
    dataset in schedule order, cache the smaller); False is DiskJoin2.
    ``io_mode`` overrides ``config.io_mode`` as in ``similarity_self_join``.
    ``attribute_mask``: (N_x + N_y,) bool over the combined id space (X
    ids first, Y ids offset by ``store_x.num_vectors``) — pairs survive
    only if both endpoints pass.

    Result ids: X in [0, n_x), Y offset by n_x. The two sides get a
    spatial-tour disk layout when coalescing/striping is on (the bipartite
    schedule is unknowable before both sides are bucketized).
    """
    _warn_deprecated("similarity_cross_join")
    if io_mode is not None:
        config = dataclasses.replace(config, io_mode=io_mode)
    workdir = workdir or tempfile.mkdtemp(prefix="diskjoin_x_")
    os.makedirs(workdir, exist_ok=True)
    index_x = DiskJoinIndex.build(store_x, config,
                                  os.path.join(workdir, "x"),
                                  layout="spatial", device=device)
    index_y = DiskJoinIndex.build(store_y, config,
                                  os.path.join(workdir, "y"),
                                  layout="spatial", device=device)
    try:
        result = index_x.cross_join(index_y, reorder_larger=reorder_larger,
                                    attribute_mask=attribute_mask)
        result.timings = index_x.merge_build_timings(
            index_y.merge_build_timings(result.timings))
        return result
    finally:
        index_x.close()
        index_y.close()
