"""Bipartite (cross-join) execution core (paper §3 extension).

Shared by the deprecated one-shot ``similarity_cross_join`` wrapper and
``DiskJoinIndex.cross_join``: builds the bipartite candidate graph over two
bucketings (center search + Eq. 1 + probabilistic pruning), presents the
two bucketed stores as one combined bucket-id space, and reuses the
self-join executor with intra-bucket pairs disabled — including its verify
engines (``JoinConfig.compute_mode``): in device mode each side's slabs
cross H2D once per cache residency of the *combined* id space.

Port of the JAX package's ``core/bipartite.py``: the center search runs
on the session's device, and so do the executor's verify engines.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.center_index import make_center_index
from repro_torch.core.executor import JoinExecutor
from repro_torch.core.pruning import prune_candidates
from repro_torch.core.types import BucketGraph, BucketMeta, JoinConfig, JoinResult


def bipartite_graph(meta_d: BucketMeta, meta_c: BucketMeta,
                    config: JoinConfig, *,
                    device: torch.device) -> BucketGraph:
    """Candidate graph over (drive ++ cache) bucket ids: for each drive
    bucket, candidate cache buckets by center search (on ``device``) +
    Eq. 1 + pruning. Edges are (drive_bucket, num_drive_buckets +
    cache_bucket)."""
    index = make_center_index(meta_c.centers, device=device)
    L = min(config.max_candidates, meta_c.num_buckets)
    d2, cand = index.search(meta_d.centers, L)
    dists = np.sqrt(np.maximum(d2, 0.0))
    eps = float(config.epsilon)
    dim = meta_d.centers.shape[1]
    off = meta_d.num_buckets
    edges: list[tuple[int, int]] = []
    for b in range(meta_d.num_buckets):
        ids, dd = cand[b], dists[b]
        ok = np.isfinite(dd)
        ids, dd = ids[ok], dd[ok]
        tri = dd - meta_d.radii[b] - meta_c.radii[ids] <= eps
        ids, dd = ids[tri], dd[tri]
        if config.prune and ids.size:
            keep = prune_candidates(dd, float(meta_d.radii[b]) + eps, dim,
                                    config.recall_target,
                                    cand_radii=meta_c.radii[ids])
            ids = ids[keep]
        for j in ids:
            edges.append((b, off + int(j)))
    e = (np.asarray(edges, dtype=np.int64) if edges
         else np.zeros((0, 2), dtype=np.int64))
    return BucketGraph(num_nodes=meta_d.num_buckets + meta_c.num_buckets,
                       edges=e)


def bipartite_join(bs_d, meta_d: BucketMeta, bs_c, meta_c: BucketMeta,
                   config: JoinConfig, *, device: torch.device,
                   drive_id_offset: int, cache_id_offset: int,
                   attribute_mask: np.ndarray | None = None,
                   shared_pool=None, shared_stats=None
                   ) -> tuple[JoinResult, float]:
    """Execute the bipartite join → (result, graph_build_seconds).

    Drive buckets are streamed in schedule order, cache-side buckets
    managed by the eviction policy; result vector ids are shifted by the
    given per-side offsets (the caller fixes the global id space).
    ``attribute_mask`` is indexed by those *global* ids.
    """
    t0 = time.perf_counter()
    graph = bipartite_graph(meta_d, meta_c, config, device=device)
    graph_s = time.perf_counter() - t0

    combined = CombinedBipartiteStore(bs_d, bs_c,
                                      drive_id_offset=drive_id_offset,
                                      cache_id_offset=cache_id_offset)
    meta = BucketMeta(
        centers=np.concatenate([meta_d.centers, meta_c.centers]),
        radii=np.concatenate([meta_d.radii, meta_c.radii]),
        sizes=np.concatenate([meta_d.sizes, meta_c.sizes]),
    )
    executor = CrossJoinExecutor(combined, meta, config, device=device,
                                 attribute_mask=attribute_mask,
                                 shared_pool=shared_pool,
                                 shared_stats=shared_stats)
    return executor.run(graph), graph_s


class CombinedBipartiteStore:
    """Unified bucket-id space over (drive ++ cache) bucketed stores.

    Vector ids are tagged per side (via the id offsets) so result pairs
    are unambiguous.
    """

    def __init__(self, drive, cache, drive_id_offset: int,
                 cache_id_offset: int):
        self.drive = drive
        self.cache = cache
        self.dim = drive.dim
        self.off = drive.num_buckets
        self._offs = (drive_id_offset, cache_id_offset)
        self.stats = drive.stats  # JoinExecutor snapshots this; we override
        self._live = (drive.stats, cache.stats)
        # device surface: the two sides are distinct backing stores, so
        # their device ids are disjoint; the prefetcher gets one queue per
        # underlying device across both
        self.num_devices = drive.num_devices + cache.num_devices

    def device_of(self, b: int) -> int:
        if b < self.off:
            return self.drive.device_of(b)
        return self.drive.num_devices + self.cache.device_of(b - self.off)

    def contiguous_after(self, a: int, b: int) -> bool:
        if a < self.off and b < self.off:
            return self.drive.contiguous_after(a, b)
        if a >= self.off and b >= self.off:
            return self.cache.contiguous_after(a - self.off, b - self.off)
        return False

    def read_run_into(self, buckets, out_vecs, out_ids,
                      pad_value: float = 0.0) -> list[int]:
        if buckets[0] < self.off:
            side, locs, off = (self.drive, list(buckets), self._offs[0])
        else:
            side = self.cache
            locs = [b - self.off for b in buckets]
            off = self._offs[1]
        ns = side.read_run_into(locs, out_vecs, out_ids,
                                pad_value=pad_value)
        for oi, n in zip(out_ids, ns):
            oi[:n] += off
        return ns

    def read_bucket(self, b: int):
        if b < self.off:
            vecs, ids = self.drive.read_bucket(b)
            return vecs, ids + self._offs[0]
        vecs, ids = self.cache.read_bucket(b - self.off)
        return vecs, ids + self._offs[1]

    def read_bucket_into(self, b: int, out_vecs, out_ids,
                         pad_value: float = 0.0) -> int:
        """Prefetcher hot path: delegate to the owning side, offset ids."""
        if b < self.off:
            side, local, off = self.drive, b, self._offs[0]
        else:
            side, local, off = self.cache, b - self.off, self._offs[1]
        n = side.read_bucket_into(local, out_vecs, out_ids,
                                  pad_value=pad_value)
        out_ids[:n] += off
        return n

    def snapshot_stats(self) -> dict:
        return self._live[0].merge(self._live[1]).snapshot()


class CrossJoinExecutor(JoinExecutor):
    """Bipartite execution: intra-bucket self-joins disabled."""

    intra_join = False

    def run(self, graph) -> JoinResult:
        res = super().run(graph)
        pipeline = res.io_stats.get("pipeline")
        res.io_stats = self.store.snapshot_stats()
        if pipeline is not None:
            res.io_stats["pipeline"] = pipeline
        return res
