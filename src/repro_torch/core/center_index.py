"""Center index — nearest-center search as dense distance products.

The paper answers nearest-center queries with an HNSW over the sampled
centers. Here, as in the JAX package, it is a blocked distance product

    d²(q, c) = ‖q‖² − 2 q·cᵀ + ‖c‖²

on the index's device (``torch.matmul`` in full float32: the port never
enables TF32), followed by an argmin or a top-L. These are plain products
outside any kernel, as the JAX package left them to XLA; the fused
``bucket_assign`` kernel serves the build's assignment scan. For very large
center sets a two-level IVF structure bounds the work: centers are grouped
under √B coarse centroids and a query scans the ``nprobe`` nearest cells.

Ties (equal distances, e.g. sub-buckets that share a split center) go to
the lowest center index, as ``jax.lax.top_k`` and ``argmin`` order them.
"""
from __future__ import annotations

import numpy as np
import torch

_QUERY_BLOCK = 4096  # query rows per distance block (bounds (Q, B) memory)


def _d2(queries: torch.Tensor, centers: torch.Tensor,
        center_sq: torch.Tensor) -> torch.Tensor:
    qsq = torch.sum(queries * queries, dim=1, keepdim=True)
    return qsq - 2.0 * (queries @ centers.T) + center_sq[None, :]


def _nearest(queries: torch.Tensor, centers: torch.Tensor,
             center_sq: torch.Tensor):
    d2 = _d2(queries, centers, center_sq)
    idx = torch.argmin(d2, dim=1)   # first minimum: lowest index on ties
    return torch.gather(d2, 1, idx[:, None])[:, 0], idx


def _topk_nearest(queries: torch.Tensor, centers: torch.Tensor,
                  center_sq: torch.Tensor, k: int):
    """k nearest centers per query, ascending, ties by lowest index (a
    stable sort; ``torch.topk`` leaves the order of ties open)."""
    d2 = _d2(queries, centers, center_sq)
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


class BruteForceCenterIndex:
    """Exact blocked-product index — the right answer for ≲64k centers."""

    def __init__(self, centers: np.ndarray, device: torch.device):
        self.centers = np.asarray(centers, np.float32)
        self.device = torch.device(device)
        self._centers_dev = torch.from_numpy(self.centers).to(self.device)
        self._center_sq = torch.sum(self._centers_dev ** 2, dim=1)

    @property
    def num_centers(self) -> int:
        return self.centers.shape[0]

    def _blocks(self, queries: np.ndarray):
        q = np.asarray(queries, np.float32)
        for i0 in range(0, q.shape[0], _QUERY_BLOCK):
            yield torch.from_numpy(q[i0:i0 + _QUERY_BLOCK]).to(self.device)

    def assign(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Nearest center per query → (sq_dists, center_ids)."""
        d2s, ids = [], []
        for qb in self._blocks(queries):
            d2, idx = _nearest(qb, self._centers_dev, self._center_sq)
            d2s.append(d2.cpu().numpy())
            ids.append(idx.cpu().numpy())
        if not d2s:
            return np.zeros(0, np.float32), np.zeros(0, np.int64)
        return np.concatenate(d2s), np.concatenate(ids)

    def search(self, queries: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """k nearest centers per query → (sq_dists (Q,k), ids (Q,k))."""
        k = min(k, self.num_centers)
        d2s, ids = [], []
        for qb in self._blocks(queries):
            d2, idx = _topk_nearest(qb, self._centers_dev, self._center_sq,
                                    k)
            d2s.append(d2.cpu().numpy())
            ids.append(idx.cpu().numpy())
        if not d2s:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int64))
        return np.concatenate(d2s), np.concatenate(ids)


class IVFCenterIndex:
    """Two-level index: coarse k-means-lite over centers, probe-limited scan.

    Build: sample √B coarse centroids from the centers, one Lloyd
    refinement pass, group centers by coarse cell. Query: find the
    ``nprobe`` nearest coarse cells, scan their member centers exactly.
    """

    def __init__(self, centers: np.ndarray, device: torch.device,
                 nprobe: int = 8, seed: int = 0):
        self.centers = np.asarray(centers, np.float32)
        self.device = torch.device(device)
        self.nprobe = nprobe
        self.seed = seed
        B, _ = self.centers.shape
        ncoarse = max(1, int(np.sqrt(B)))
        rng = np.random.default_rng(seed)
        coarse = self.centers[rng.choice(B, size=ncoarse, replace=False)]
        xs = torch.from_numpy(self.centers).to(self.device)

        def cells(coarse_np):
            cj = torch.from_numpy(coarse_np).to(self.device)
            _, a = _nearest(xs, cj, torch.sum(cj ** 2, dim=1))
            return cj, a.cpu().numpy()

        _, assign = cells(coarse)
        for c in range(ncoarse):  # one Lloyd step
            m = assign == c
            if m.any():
                coarse[c] = self.centers[m].mean(axis=0)
        cj, assign = cells(coarse)

        self.coarse = coarse
        self._coarse_dev = cj
        self._coarse_sq = torch.sum(cj ** 2, dim=1)
        # bucket-list layout: members sorted by cell, offsets per cell
        order = np.argsort(assign, kind="stable")
        self._member_ids = order.astype(np.int32)
        self._cell_of = assign
        counts = np.bincount(assign, minlength=ncoarse)
        self._cell_offsets = np.concatenate([[0], np.cumsum(counts)])
        self._centers_sorted_dev = torch.from_numpy(
            self.centers[order]).to(self.device)
        self.ncoarse = ncoarse

    @property
    def num_centers(self) -> int:
        return self.centers.shape[0]

    def _probe_members(self, cells: np.ndarray) -> np.ndarray:
        segs = [np.arange(self._cell_offsets[c], self._cell_offsets[c + 1])
                for c in cells]
        return np.concatenate(segs) if segs else np.zeros(0, np.int64)

    def search(self, queries: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, np.float32)
        nprobe = min(self.nprobe, self.ncoarse)
        qd = torch.from_numpy(queries).to(self.device)
        _, cell_idx = _topk_nearest(qd, self._coarse_dev, self._coarse_sq,
                                    nprobe)
        cell_idx = cell_idx.cpu().numpy()
        out_d = np.full((len(queries), k), np.inf, np.float32)
        out_i = np.zeros((len(queries), k), np.int64)
        for qi in range(len(queries)):
            members = self._probe_members(cell_idx[qi])
            if members.size == 0:
                continue
            sub = self._centers_sorted_dev[torch.from_numpy(members)
                                           .to(self.device)]
            d2 = torch.sum((sub - qd[qi][None, :]) ** 2, dim=1).cpu().numpy()
            kk = min(k, members.size)
            part = np.argpartition(d2, kk - 1)[:kk]
            part = part[np.argsort(d2[part])]
            out_d[qi, :kk] = d2[part]
            out_i[qi, :kk] = self._member_ids[members[part]]
        return out_d, out_i

    def assign(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        d, i = self.search(queries, 1)
        return d[:, 0], i[:, 0]


def make_center_index(centers: np.ndarray, *, device: torch.device,
                      exact_threshold: int = 65536, nprobe: int = 8,
                      seed: int = 0):
    """Brute force up to ``exact_threshold`` centers, IVF above."""
    if centers.shape[0] <= exact_threshold:
        return BruteForceCenterIndex(centers, device)
    return IVFCenterIndex(centers, device, nprobe=nprobe, seed=seed)
