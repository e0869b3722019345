"""Synthetic vector datasets with controllable neighbor structure.

Clustered Gaussian mixtures mimic embedding-space geometry (local density +
global spread), which is what makes bucketization effective. ``epsilon_for_
avg_neighbors`` calibrates ε so each vector has ~k similar neighbors —
the paper's protocol ("set ε such that each vector has 100 similar vectors
on average").
"""
from __future__ import annotations

import numpy as np


def clustered_vectors(n: int, dim: int, *, clusters: int | None = None,
                      spread: float = 1.0, cluster_std: float = 0.08,
                      cluster_std_range: tuple | None = None,
                      intrinsic_dim: int | None = None,
                      seed: int = 0) -> np.ndarray:
    """Gaussian-mixture embeddings with low intrinsic dimension.

    Real embedding spaces concentrate on low-dimensional manifolds — the
    regime where the paper's geometric pruning has power. We sample the
    mixture in an ``intrinsic_dim``-dimensional latent space (default
    min(dim, 12)) and project through a random orthonormal map, plus small
    ambient noise. Full-rank isotropic Gaussians (``intrinsic_dim=dim``)
    are the adversarial case: nearest-neighbor distances concentrate and
    no geometric filter separates anything.
    """
    rng = np.random.default_rng(seed)
    clusters = clusters or max(4, n // 256)
    idim = intrinsic_dim or min(dim, 12)
    centers = rng.normal(scale=spread, size=(clusters, idim))
    assign = rng.integers(0, clusters, size=n)
    if cluster_std_range is not None:
        # heterogeneous density — dense cores + diffuse regions, the
        # regime real embedding spaces exhibit and where the paper's
        # probabilistic pruning (radius-dependent) has bite
        lo, hi = cluster_std_range
        stds = np.exp(rng.uniform(np.log(lo), np.log(hi), size=clusters))
        per_point_std = stds[assign][:, None]
    else:
        per_point_std = cluster_std
    z = centers[assign] + rng.normal(size=(n, idim)) * per_point_std
    if idim == dim:
        x = z
    else:
        proj = np.linalg.qr(rng.normal(size=(dim, idim)))[0]  # orthonormal
        x = z @ proj.T + rng.normal(scale=cluster_std * 0.1, size=(n, dim))
    return x.astype(np.float32)


def uniform_vectors(n: int, dim: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(n, dim)).astype(np.float32)


def brute_force_pairs(x: np.ndarray, epsilon: float,
                      block: int = 2048) -> np.ndarray:
    """Exact ground-truth ε-pairs (a < b), blocked to bound memory."""
    n = x.shape[0]
    eps2 = epsilon * epsilon
    out = []
    sq = np.sum(x.astype(np.float64) ** 2, axis=1)
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        for j0 in range(i0, n, block):
            j1 = min(n, j0 + block)
            d2 = (sq[i0:i1, None] - 2.0 * x[i0:i1] @ x[j0:j1].T
                  + sq[None, j0:j1])
            rows, cols = np.nonzero(d2 <= eps2)
            rows = rows + i0
            cols = cols + j0
            keep = rows < cols
            if keep.any():
                out.append(np.stack([rows[keep], cols[keep]], axis=1))
    if not out:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(out).astype(np.int64)


def epsilon_for_avg_neighbors(x: np.ndarray, k: int,
                              sample: int = 512, seed: int = 0,
                              block: int = 64) -> float:
    """Calibrate ε so the average #ε-neighbors per vector ≈ k.

    Same value as the JAX package's version, which sorts the full
    (sample, n) distance matrix: here each block of sample rows takes its
    k-th smallest d² with ``np.partition``, so memory stays at
    ``block × n`` float64 and the cost is linear in n (1M rows take
    seconds instead of a minute).
    """
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = rng.choice(n, size=min(sample, n), replace=False)
    x64 = x.astype(np.float64)
    q = x64[idx]
    sq = np.sum(x64 ** 2, axis=1)
    kk = min(k, n - 1)  # k-th neighbor (excl. self)
    kth = []
    for i0 in range(0, q.shape[0], block):
        qb = q[i0:i0 + block]
        d2 = (np.sum(qb * qb, axis=1)[:, None] - 2.0 * qb @ x64.T
              + sq[None, :])
        d2 = np.maximum(d2, 0)
        kth.append(np.partition(d2, kk, axis=1)[:, kk])
    return float(np.sqrt(np.median(np.concatenate(kth))))
