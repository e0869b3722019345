"""Join-size estimation from per-bucket sample sketches.

*Similarity Join Size Estimation using LSH* (Lee/Ng/Shim, PAPERS.md)
shows that a cheap sketch pre-pass predicts per-bucket-pair output
cardinality well enough to drive planning decisions. This module is that
pre-pass for DiskJoin: each bucket carries a small uniform sample of its
member vectors (plus their squared norms — the "norm sketch" half that
turns every distance evaluation into one dot product), and the estimator
answers *how many result pairs will edge (u, v) emit at threshold ε* by
exhaustively verifying the s×s sampled cross pairs and scaling the hit
fraction to the full n_u×n_v pair population.

The estimate is a binomial proportion, so its error bars are calibrated
by construction: ``est_edges`` returns Wilson-score intervals at the
estimator's ``z`` (default 2 ≈ 95%), and the *upper* bound is what the
planner sizes hard capacities from (``compact_pairs`` lane capacity,
``query_verify_compact`` k_cap) — a bound that is allowed to be loose
but must rarely be exceeded, because exceeding it costs an overflow
re-dispatch (a recompile), while looseness only costs output-buffer
bytes.

Sketches are built once (during ``DiskJoinIndex.build``, from the flat
store — no bucketed-store reads) and persisted next to the manifest
(``plan_sketch.npz``); ``open()`` of an index built before sketches
existed rebuilds them lazily from the bucketed store with a one-time
warning. The sketch is ε-independent: one build serves every threshold.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

SKETCH_VERSION = 1
SKETCH_FILE = "plan_sketch.npz"
DEFAULT_SAMPLE_ROWS = 16
DEFAULT_Z = 2.0
_EDGE_CHUNK = 512  # edges estimated per vectorized block (memory bound)
_SCAN_BLOCK_ROWS = 8192  # sequential gather granularity (sample_flat)


@dataclasses.dataclass(frozen=True)
class PairEstimate:
    """Estimated result-pair count for one bucket pair at one ε."""

    est: float       # point estimate (sample hit fraction × population)
    lo: float        # Wilson lower bound at the estimator's z
    hi: float        # Wilson upper bound — what capacities are sized from
    sampled: int     # sample pairs examined
    hits: int        # sample pairs within ε
    population: int  # full pair population the fraction scales to


def _wilson_bounds(k: np.ndarray, m: np.ndarray, z: float
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized Wilson score interval for k successes in m trials.

    Degenerate m == 0 (a 1-row bucket's intra edge) reports [0, 1]: the
    sketch carries no pair evidence, so the bound stays maximally loose.
    """
    m = m.astype(np.float64)
    k = k.astype(np.float64)
    safe = np.maximum(m, 1.0)
    z2 = z * z
    center = (k + z2 / 2.0) / (safe + z2)
    half = (z / (safe + z2)) * np.sqrt(k * (safe - k) / safe + z2 / 4.0)
    lo = np.clip(center - half, 0.0, 1.0)
    hi = np.clip(center + half, 0.0, 1.0)
    empty = m <= 0
    lo[empty] = 0.0
    hi[empty] = 1.0
    return lo, hi


class CardinalityEstimator:
    """Per-bucket sample sketches → per-edge join-size estimates.

    ``samples``: (B, s, d) float32 — up to ``s`` uniformly sampled member
    vectors per bucket, zero-padded past ``rows[b]``; ``rows``: (B,) live
    sample counts; ``sizes``: (B,) true bucket populations.
    """

    def __init__(self, samples: np.ndarray, rows: np.ndarray,
                 sizes: np.ndarray, *, seed: int = 0, z: float = DEFAULT_Z):
        self.samples = np.ascontiguousarray(samples, np.float32)
        self.rows = np.asarray(rows, np.int64)
        self.sizes = np.asarray(sizes, np.int64)
        self.seed = int(seed)
        self.z = float(z)
        if self.samples.ndim != 3:
            raise ValueError(f"samples must be (B, s, d), "
                             f"got {self.samples.shape}")
        if not (len(self.rows) == len(self.sizes)
                == self.samples.shape[0]):
            raise ValueError("samples/rows/sizes bucket counts disagree")
        # norm sketch: ‖x‖² per sample row, so a distance evaluation is
        # one dot product (d² = ‖a‖² − 2a·b + ‖b‖²)
        self._norms = np.einsum("bsd,bsd->bs", self.samples,
                                self.samples).astype(np.float32)

    # -- construction ---------------------------------------------------------
    @classmethod
    def sample_flat(cls, store, assignment: np.ndarray, num_buckets: int,
                    *, sample_rows: int = DEFAULT_SAMPLE_ROWS,
                    seed: int = 0, z: float = DEFAULT_Z
                    ) -> "CardinalityEstimator":
        """Build from the flat dataset + its (final) bucket assignment —
        the build-time path. The ≤ B·s sampled rows are gathered with one
        sequential block scan (a per-row gather would charge a full page
        per ~100-byte row and wreck the join's Fig. 16 read-amplification
        accounting); it rides the same block-granular discipline as
        bucketize's three scans and stops at the last sampled row."""
        assignment = np.asarray(assignment, np.int64)
        sizes = np.bincount(assignment,
                            minlength=num_buckets).astype(np.int64)
        order = np.argsort(assignment, kind="stable")
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        rng = np.random.default_rng(seed)
        rows = np.minimum(sizes, sample_rows).astype(np.int64)
        picks: list[np.ndarray] = []
        for b in range(num_buckets):
            members = order[bounds[b]:bounds[b + 1]]
            if rows[b] == len(members):
                picks.append(members)
            else:
                picks.append(rng.choice(members, size=int(rows[b]),
                                        replace=False))
        flat_ids = np.concatenate(picks) if picks else np.zeros(0, np.int64)
        sorted_ids = np.sort(flat_ids)
        vecs = np.zeros((len(sorted_ids), store.dim), np.float32)
        ptr = 0
        if sorted_ids.size:
            for start, block in store.iter_blocks(_SCAN_BLOCK_ROWS):
                end = start + block.shape[0]
                hi = int(np.searchsorted(sorted_ids, end))
                if hi > ptr:
                    vecs[ptr:hi] = block[sorted_ids[ptr:hi] - start]
                    ptr = hi
                if ptr >= sorted_ids.size:
                    break
        by_id = dict(zip(sorted_ids.tolist(), range(len(sorted_ids))))
        samples = np.zeros((num_buckets, sample_rows, store.dim),
                           np.float32)
        for b in range(num_buckets):
            for i, vid in enumerate(picks[b]):
                samples[b, i] = vecs[by_id[int(vid)]]
        return cls(samples, rows, sizes, seed=seed, z=z)

    @classmethod
    def sample_bucketed(cls, store, sizes: np.ndarray, *,
                        sample_rows: int = DEFAULT_SAMPLE_ROWS,
                        seed: int = 0, z: float = DEFAULT_Z
                        ) -> "CardinalityEstimator":
        """Rebuild from an already-bucketed store (lazy back-compat path
        for indexes built before sketches existed): one read per bucket.
        Emulated SSD latency is suspended for the pass — sketch rebuild is
        index maintenance, not part of any modeled workload."""
        sizes = np.asarray(sizes, np.int64)
        num_buckets = len(sizes)
        rng = np.random.default_rng(seed)
        rows = np.minimum(sizes, sample_rows).astype(np.int64)
        samples = np.zeros((num_buckets, sample_rows, store.dim),
                           np.float32)
        old_latency = getattr(store, "read_latency_s", None)
        if old_latency is not None:
            store.read_latency_s = 0.0
        try:
            for b in range(num_buckets):
                vecs, _ = store.read_bucket(b)
                if rows[b] == vecs.shape[0]:
                    sel = np.arange(int(rows[b]))
                else:
                    sel = rng.choice(vecs.shape[0], size=int(rows[b]),
                                     replace=False)
                samples[b, :rows[b]] = vecs[sel]
        finally:
            if old_latency is not None:
                store.read_latency_s = old_latency
        return cls(samples, rows, sizes, seed=seed, z=z)

    # -- persistence -----------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, version=SKETCH_VERSION, samples=self.samples,
                 rows=self.rows, sizes=self.sizes, seed=self.seed)

    @classmethod
    def load(cls, path: str, *, z: float = DEFAULT_Z
             ) -> "CardinalityEstimator":
        with np.load(path) as f:
            if int(f["version"]) != SKETCH_VERSION:
                raise ValueError(f"{path}: sketch version {int(f['version'])}"
                                 f" != {SKETCH_VERSION}")
            return cls(f["samples"], f["rows"], f["sizes"],
                       seed=int(f["seed"]), z=z)

    @property
    def num_buckets(self) -> int:
        return self.samples.shape[0]

    @property
    def sample_rows(self) -> int:
        return self.samples.shape[1]

    # -- estimation -------------------------------------------------------------
    def est_pairs(self, edge: tuple[int, int], epsilon: float
                  ) -> PairEstimate:
        """Result-pair estimate for one bucket pair (u == v ⇒ the bucket's
        intra self-join, counting unordered pairs)."""
        u, v = int(edge[0]), int(edge[1])
        edges = np.array([[u, v]], np.int64)
        intra = np.array([u == v])
        est, lo, hi, k, m, pop = self._est_edges_full(edges, epsilon, intra)
        return PairEstimate(est=float(est[0]), lo=float(lo[0]),
                            hi=float(hi[0]), sampled=int(m[0]),
                            hits=int(k[0]), population=int(pop[0]))

    def est_edges(self, edges: np.ndarray, epsilon: float,
                  intra: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized ``est_pairs`` over (E, 2) edges → (est, lo, hi).

        ``intra`` marks edges whose two endpoints are the same bucket
        (inferred from u == v when omitted): those count unordered member
        pairs, matching the executor's strictly-upper intra verify.
        """
        est, lo, hi, _, _, _ = self._est_edges_full(edges, epsilon, intra)
        return est, lo, hi

    def _est_edges_full(self, edges: np.ndarray, epsilon: float,
                        intra: np.ndarray | None):
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        E = edges.shape[0]
        if intra is None:
            intra = edges[:, 0] == edges[:, 1]
        intra = np.asarray(intra, bool)
        eps2 = np.float32(float(epsilon) * float(epsilon))
        s = self.sample_rows
        k = np.zeros(E, np.int64)
        for lo_i in range(0, E, _EDGE_CHUNK):
            sl = slice(lo_i, min(lo_i + _EDGE_CHUNK, E))
            u, v = edges[sl, 0], edges[sl, 1]
            su, sv = self.samples[u], self.samples[v]
            d2 = (self._norms[u][:, :, None]
                  - 2.0 * np.einsum("esd,etd->est", su, sv)
                  + self._norms[v][:, None, :])
            m = d2 <= eps2
            r = np.arange(s)
            live = ((r[None, :, None] < self.rows[u][:, None, None])
                    & (r[None, None, :] < self.rows[v][:, None, None]))
            tri = (~intra[sl, None, None]
                   | (r[None, :, None] < r[None, None, :]))
            k[sl] = (m & live & tri).sum((1, 2))
        ru, rv = self.rows[edges[:, 0]], self.rows[edges[:, 1]]
        nu, nv = self.sizes[edges[:, 0]], self.sizes[edges[:, 1]]
        m_pairs = np.where(intra, ru * (ru - 1) // 2, ru * rv)
        pop = np.where(intra, nu * (nu - 1) // 2, nu * nv)
        frac = k / np.maximum(m_pairs, 1)
        est = frac * pop
        lo_p, hi_p = _wilson_bounds(k, m_pairs, self.z)
        return est, lo_p * pop, hi_p * pop, k, m_pairs, pop

    def est_queries(self, Q: np.ndarray, per_q: list[np.ndarray],
                    epsilon: float
                    ) -> tuple[np.ndarray, np.ndarray, dict[int, float]]:
        """ε-range result-size estimates for a query wave.

        ``per_q``: per-query candidate-bucket id lists (the output of
        ``DiskJoinIndex.plan_probes``). Returns (per-query est, per-query
        hi, per-bucket hi) where the per-bucket figure is the upper bound
        on the *total* pairs one bucket's verify emits across every member
        query that probes it — exactly the quantity the device query
        path's ``k_cap`` must bound.
        """
        Q = np.asarray(Q, np.float32)
        eps2 = np.float32(float(epsilon) * float(epsilon))
        n = Q.shape[0]
        est_q = np.zeros(n)
        hi_q = np.zeros(n)
        probe: dict[int, list[int]] = {}
        for qi, ids in enumerate(per_q):
            for b in ids:
                probe.setdefault(int(b), []).append(qi)
        bucket_hi: dict[int, float] = {}
        for b, qis in probe.items():
            sb = self.samples[b][:self.rows[b]]         # (r, d)
            if sb.shape[0] == 0:
                bucket_hi[b] = float(self.sizes[b]) * len(qis)
                continue
            qs = Q[qis]                                  # (k, d)
            d2 = ((qs * qs).sum(1)[:, None]
                  - 2.0 * (qs @ sb.T)
                  + self._norms[b][None, :self.rows[b]])
            hits = (d2 <= eps2).sum(1)
            m = np.full(len(qis), int(self.rows[b]))
            lo_p, hi_p = _wilson_bounds(hits, m, self.z)
            scale = float(self.sizes[b])
            est_q[qis] += hits / m * scale
            hi_q[qis] += hi_p * scale
            bucket_hi[b] = float(hi_p.sum() * scale)
        return est_q, hi_q, bucket_hi
