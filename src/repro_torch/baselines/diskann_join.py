"""DiskANN-style baseline: ε-join by per-vector search of a disk index.

Faithful to the paper's baseline setup (§1, §6.1):
  * proximity graph over the dataset; full-precision vectors live on disk
    and are fetched one vector at a time (≤ page granularity → read
    amplification, the Fig. 16 effect);
  * compressed vectors (int8 scalar quantization here, PQ in DiskANN) stay
    in memory and steer the beam search; disk fetches rerank exactly;
  * every vector is issued as a query; neighbors within ε are collected,
    growing the beam until the frontier exceeds ε (the paper's "increase k
    until the distances exceed ε").

The point of this module is the *cost profile* (disk traffic, repeated
accesses), not index-construction fidelity — construction uses exact
blocked kNN (fine at validation scale) plus long-range shortcuts.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import canonicalize_pairs
from repro_torch.store.vector_store import FlatVectorStore


@dataclasses.dataclass
class DiskANNIndex:
    graph: np.ndarray          # (N, R) int64 out-neighbors
    compressed: np.ndarray     # (N, d) int8 in-memory approximations
    scale: np.ndarray          # (d,) dequant scales
    medoid: int

    @property
    def degree(self) -> int:
        return self.graph.shape[1]


def build_index(x: np.ndarray, degree: int = 16, shortcut_frac: float = 0.25,
                seed: int = 0, block: int = 2048) -> DiskANNIndex:
    """Exact-kNN graph + random shortcuts (Vamana-flavoured, small-scale)."""
    n, d = x.shape
    rng = np.random.default_rng(seed)
    k_near = max(1, int(degree * (1 - shortcut_frac)))
    nbrs = np.empty((n, degree), dtype=np.int64)
    sq = np.sum(x.astype(np.float64) ** 2, axis=1)
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        d2 = sq[i0:i1, None] - 2.0 * x[i0:i1] @ x.T + sq[None, :]
        idx = np.argpartition(d2, k_near + 1, axis=1)[:, :k_near + 1]
        for r, i in enumerate(range(i0, i1)):
            cand = [j for j in idx[r] if j != i][:k_near]
            short = rng.choice(n, size=degree - len(cand), replace=False)
            nbrs[i] = np.concatenate([cand, short])[:degree]
    # int8 scalar quantization (in-memory footprint = N·d bytes = 25% of f32)
    scale = np.maximum(np.abs(x).max(axis=0), 1e-12) / 127.0
    compressed = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    medoid = int(np.argmin(np.sum((x - x.mean(0)) ** 2, axis=1)))
    return DiskANNIndex(nbrs, compressed, scale.astype(np.float32), medoid)


def _approx_dist2(index: DiskANNIndex, q: np.ndarray,
                  ids: np.ndarray) -> np.ndarray:
    approx = index.compressed[ids].astype(np.float32) * index.scale
    diff = approx - q[None, :]
    return np.sum(diff * diff, axis=1)


def search_eps(index: DiskANNIndex, store: FlatVectorStore, q: np.ndarray,
               epsilon: float, beam: int = 32, max_hops: int = 512,
               start: int | None = None) -> tuple[np.ndarray, int]:
    """Greedy beam search; full-precision rerank via per-vector disk reads.

    Returns (ids within ε of q, #distance computations). ``start`` seeds the
    search (for a join the query is a dataset node — start there; ad-hoc
    queries start at the medoid).
    """
    eps2 = epsilon * epsilon
    visited: set[int] = set()
    frontier = [index.medoid if start is None else int(start)]
    results: list[int] = []
    dc = 0
    best: list[tuple[float, int]] = []
    hops = 0
    while frontier and hops < max_hops:
        hops += 1
        cand = np.asarray([c for c in frontier if c not in visited])
        if cand.size == 0:
            break
        visited.update(int(c) for c in cand)
        # full-precision rerank — one random disk read per candidate
        full = store.read_rows(cand)
        d2 = np.sum((full - q[None, :]) ** 2, axis=1)
        dc += len(cand)
        for c, dd in zip(cand, d2):
            if dd <= eps2:
                results.append(int(c))
            best.append((float(dd), int(c)))
        best.sort()
        best = best[:beam]
        # expand: neighbors of the beam, steered by compressed distances
        expand = np.unique(index.graph[[b for _, b in best]].ravel())
        expand = np.asarray([e for e in expand if e not in visited])
        if expand.size == 0:
            break
        ad2 = _approx_dist2(index, q, expand)
        dc += len(expand)
        order = np.argsort(ad2)
        keep = expand[order][:beam]
        # beam termination: stop when the whole frontier is beyond ε and
        # the best beam entry is also beyond ε (paper's growing-k stop)
        if best and best[0][0] > eps2 and ad2[order[0]] > 4 * eps2:
            break
        frontier = [int(kk) for kk in keep]
    return np.asarray(sorted(set(results)), dtype=np.int64), dc


def diskann_join(store: FlatVectorStore, x: np.ndarray, epsilon: float,
                 beam: int = 32, sample_queries: np.ndarray | None = None):
    """Join by searching every vector (or a sample, as the paper does for
    time estimation). Returns (pairs, #distance computations)."""
    index = build_index(x)
    queries = (np.arange(x.shape[0]) if sample_queries is None
               else sample_queries)
    pairs = []
    dc = 0
    for qid in queries:
        ids, c = search_eps(index, store, x[qid], epsilon, beam=beam,
                            start=int(qid))
        dc += c
        for j in ids:
            if j != qid:
                pairs.append((min(qid, j), max(qid, j)))
    out = (canonicalize_pairs(np.asarray(pairs, dtype=np.int64))
           if pairs else np.zeros((0, 2), np.int64))
    return out, dc
