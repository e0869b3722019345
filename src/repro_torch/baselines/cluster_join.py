"""ClusterJoin baseline (Das Sarma et al., VLDB'14) — single-node version.

Pivot-based partitioning with the bisector replication filter: each vector
goes to its nearest pivot's *home* partition, and is additionally replicated
to any partition whose bisector it is within ε/2 of — guaranteeing every
ε-pair co-locates in ≥1 partition (exact join). Verification is all-pairs
within each partition. The paper implements it in-memory for fairness; so do
we. Distance-computation counts grow near-quadratically with N (Fig. 7's
separation vs DiskJoin).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import canonicalize_pairs


def cluster_join(x: np.ndarray, epsilon: float, num_pivots: int | None = None,
                 seed: int = 0, verify_block: int = 4096):
    """Exact SSJ → (pairs (P,2) int64, #distance computations)."""
    n, d = x.shape
    num_pivots = num_pivots or max(2, int(np.sqrt(n) / 2))
    rng = np.random.default_rng(seed)
    pivots = x[rng.choice(n, size=num_pivots, replace=False)].astype(np.float64)
    xf = x.astype(np.float64)

    # distances to pivots (blocked)
    dc = n * num_pivots
    home = np.empty(n, dtype=np.int64)
    members: list[list[int]] = [[] for _ in range(num_pivots)]
    psq = np.sum(pivots ** 2, axis=1)
    for i0 in range(0, n, verify_block):
        i1 = min(n, i0 + verify_block)
        dp = (np.sum(xf[i0:i1] ** 2, axis=1)[:, None]
              - 2.0 * xf[i0:i1] @ pivots.T + psq[None, :])
        dp = np.sqrt(np.maximum(dp, 0))
        h = np.argmin(dp, axis=1)
        home[i0:i1] = h
        # bisector filter: replicate x to partition p if
        # d(x, p) − d(x, home) ≤ 2ε  (⇒ x within ε of the bisector)
        dmin = dp[np.arange(i1 - i0), h]
        repl = dp <= (dmin[:, None] + 2.0 * epsilon)
        for r in range(i1 - i0):
            for p in np.flatnonzero(repl[r]):
                members[p].append(i0 + r)

    eps2 = epsilon * epsilon
    pairs = []
    for p in range(num_pivots):
        ids = np.asarray(members[p], dtype=np.int64)
        m = ids.size
        if m < 2:
            continue
        sub = xf[ids]
        sq = np.sum(sub ** 2, axis=1)
        d2 = sq[:, None] - 2.0 * sub @ sub.T + sq[None, :]
        dc += m * (m - 1) // 2
        rows, cols = np.nonzero(np.triu(d2 <= eps2, k=1))
        if rows.size:
            pairs.append(np.stack([ids[rows], ids[cols]], axis=1))
    out = (canonicalize_pairs(np.concatenate(pairs))
           if pairs else np.zeros((0, 2), np.int64))
    return out, dc
