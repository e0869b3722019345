"""Bucket dependency graph construction (paper §3 + §5.2).

For each bucket b: fetch its L nearest candidate buckets from the center
index, keep those passing the triangle-inequality test (Eq. 1)

    ‖c_i − c_j‖ − r_i − r_j ≤ ε,

then apply probabilistic pruning (Eq. 3) against the recall budget. Edges
are directed i→j with i<j (symmetric distance ⇒ each pair once).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.center_index import make_center_index
from repro_torch.core.pruning import prune_candidates
from repro_torch.core.types import BucketGraph, BucketMeta, JoinConfig


def build_bucket_graph(meta: BucketMeta, config: JoinConfig, *,
                       device: torch.device) -> BucketGraph:
    """Edges from a center search on ``device`` (see ``center_index``)."""
    B, d = meta.centers.shape
    index = make_center_index(meta.centers, device=device)
    L = min(config.max_candidates + 1, B)  # +1: self comes back first
    dists_sq, cand_ids = index.search(meta.centers, L)
    dists = np.sqrt(np.maximum(dists_sq, 0.0))

    edges: list[tuple[int, int]] = []
    eps = float(config.epsilon)
    for b in range(B):
        ids = cand_ids[b]
        dd = dists[b]
        mask = ids != b
        ids, dd = ids[mask], dd[mask]
        # Eq. 1 triangle-inequality prefilter
        tri = dd - meta.radii[b] - meta.radii[ids] <= eps
        ids, dd = ids[tri], dd[tri]
        if config.prune and ids.size:
            keep = prune_candidates(dd, float(meta.radii[b]) + eps, d,
                                    config.recall_target)
            ids = ids[keep]
        for j in ids:
            edges.append((min(b, int(j)), max(b, int(j))))

    if edges:
        e = np.unique(np.asarray(edges, dtype=np.int64), axis=0)
    else:
        e = np.zeros((0, 2), dtype=np.int64)
    return BucketGraph(num_nodes=B, edges=e)


def candidate_pair_count(graph: BucketGraph, meta: BucketMeta) -> int:
    """#candidate vector pairs implied by the graph (Fig. 18 statistic)."""
    s = meta.sizes.astype(np.int64)
    total = int(np.sum(s * (s - 1) // 2))  # intra-bucket (implicit self edges)
    if graph.num_edges:
        total += int(np.sum(s[graph.edges[:, 0]] * s[graph.edges[:, 1]]))
    return total
