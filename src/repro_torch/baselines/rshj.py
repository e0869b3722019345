"""RSHJ-style baseline (Yu et al., TKDE'16) — LSH similarity join.

E2LSH-style hash family h(x) = ⌊(a·x + b)/w⌋ composed into K-wide signatures
across T tables; candidate pairs are vectors sharing a signature in any
table; verification is exact. Approximate — recall depends on (K, T, w).

Memory behaviour mirrors the paper's observation: candidate sets blow up
roughly quadratically in dense regions (RSHJ "fails to run at 1M/10M" in
Fig. 7); ``max_candidates`` raises MemoryError beyond the budget to emulate
that failure mode honestly rather than thrash.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from repro_torch.core.types import canonicalize_pairs


def rshj_join(x: np.ndarray, epsilon: float, tables: int = 8, k: int = 4,
              width_mult: float = 2.0, seed: int = 0,
              max_candidates: int | None = 50_000_000):
    """→ (pairs, #distance computations). Raises MemoryError on blow-up."""
    n, d = x.shape
    rng = np.random.default_rng(seed)
    w = width_mult * epsilon
    eps2 = epsilon * epsilon
    xf = x.astype(np.float64)

    cand: set[tuple[int, int]] = set()
    dc = 0
    for t in range(tables):
        a = rng.normal(size=(d, k))
        b = rng.uniform(0, w, size=k)
        sig = np.floor((xf @ a + b) / w).astype(np.int64)
        buckets: defaultdict[bytes, list[int]] = defaultdict(list)
        for i in range(n):
            buckets[sig[i].tobytes()].append(i)
        for ids in buckets.values():
            m = len(ids)
            if m < 2:
                continue
            for ii in range(m):
                for jj in range(ii + 1, m):
                    cand.add((ids[ii], ids[jj]))
            if max_candidates and len(cand) > max_candidates:
                raise MemoryError(
                    f"RSHJ candidate set exceeded {max_candidates} pairs "
                    f"(table {t}/{tables}) — emulating the paper's OOM")
    pairs = []
    for i, j in cand:
        dd = xf[i] - xf[j]
        dc += 1
        if float(dd @ dd) <= eps2:
            pairs.append((i, j))
    out = (canonicalize_pairs(np.asarray(pairs, dtype=np.int64))
           if pairs else np.zeros((0, 2), np.int64))
    return out, dc
