"""Semantic deduplication — DiskJoin's flagship application (paper §1).

Runs the similarity self-join over document embeddings and collapses each
connected component of the ε-pair graph to one survivor (union-find), as in
SemDeDup-style pipelines. Returns the drop list the data pipeline consumes.

A copy of the JAX package's ``data/dedup.py``; its join is the port's
``similarity_self_join`` on ``device`` (``None`` is CUDA, or ``"cpu"``),
so on the card it runs the build's assign kernel and the verify kernel.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from repro_torch.core import JoinConfig, similarity_self_join
from repro_torch.store.vector_store import FlatVectorStore


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:       # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)  # keep smallest id


@dataclasses.dataclass
class DedupReport:
    num_docs: int
    num_pairs: int
    num_dropped: int
    drop_ids: np.ndarray        # documents to drop (non-survivors)
    keep_ids: np.ndarray
    join_stats: dict

    @property
    def dedup_rate(self) -> float:
        return self.num_dropped / max(1, self.num_docs)


def semantic_dedup(embeddings: np.ndarray, epsilon: float, *,
                   recall_target: float = 0.9,
                   memory_fraction: float = 0.1,
                   workdir: str | None = None,
                   join_config: JoinConfig | None = None,
                   device=None) -> DedupReport:
    """embeddings: (N, d) float32 document embeddings → DedupReport."""
    n = embeddings.shape[0]
    workdir = workdir or tempfile.mkdtemp(prefix="dedup_")
    os.makedirs(workdir, exist_ok=True)
    store = FlatVectorStore.from_array(
        os.path.join(workdir, "embeddings.bin"),
        embeddings.astype(np.float32))
    cfg = join_config or JoinConfig(
        epsilon=epsilon,
        recall_target=recall_target,
        memory_budget_bytes=max(1 << 20,
                                int(store.nbytes * memory_fraction)),
        pad_align=64,
    )
    result = similarity_self_join(store, cfg, workdir=workdir,
                                  device=device)

    uf = UnionFind(n)
    for a, b in result.pairs:
        uf.union(int(a), int(b))
    roots = np.asarray([uf.find(i) for i in range(n)])
    keep = roots == np.arange(n)
    return DedupReport(
        num_docs=n,
        num_pairs=int(result.pairs.shape[0]),
        num_dropped=int((~keep).sum()),
        drop_ids=np.flatnonzero(~keep),
        keep_ids=np.flatnonzero(keep),
        join_stats={
            "distance_computations": result.num_distance_computations,
            "cache_hit_rate": result.cache_hit_rate,
            "read_amplification":
                result.io_stats.get("read_amplification", 1.0),
            "timings": result.timings,
        },
    )
