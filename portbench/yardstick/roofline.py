"""The verify operation's least time on one H100, counted from its work.

The count is of the operation, whatever implements it: 2·d operations for
each live row pair verified; each live row of each verified lane read
once (4·d bytes), and each emitted pair or member written once (two int64
ids and a float32 distance). The padded rows, the dense d² and the mask
that today's kernels write never enter it, so a kernel that stops writing
them does not push the share past 100 %.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at a 700 W limit):
the TF32 tensor-core rate, the one ``PERF.md``'s kernel bounds use for the
3×TF32 verify route, and HBM3 bandwidth.
"""
from __future__ import annotations

import numpy as np

PEAK_TF32_FLOP_S = 494.7e12
PEAK_HBM_BYTE_S = 3.35e12
EMIT_BYTES = 8 + 8 + 4     # two int64 ids and a float32 distance


def least_time_s(ops: float, nbytes: float) -> float:
    """The larger of the compute and the memory term."""
    return max(ops / PEAK_TF32_FLOP_S, nbytes / PEAK_HBM_BYTE_S)


def join_work(edges: np.ndarray, sizes: np.ndarray, dim: int,
              pairs_verified: int, pairs_emitted: int) -> tuple[float, float]:
    """(operations, bytes) of one self-join's verify: every bucket pair of
    the graph (``edges``, (E, 2)) and every bucket of two rows or more
    against itself; ``pairs_verified`` live row pairs (the intra lanes'
    upper triangles counted once)."""
    sizes = np.asarray(sizes, np.int64)
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    rows = int(sizes[e[:, 0]].sum() + sizes[e[:, 1]].sum()
               + sizes[sizes >= 2].sum())
    return (2.0 * dim * pairs_verified,
            4.0 * dim * rows + EMIT_BYTES * pairs_emitted)


def query_work(waves: list[list[np.ndarray]], sizes: np.ndarray, dim: int,
               members_emitted: int) -> tuple[float, float]:
    """(operations, bytes) of query waves: each wave is the list of its
    queries' probed buckets; a bucket probed by k queries of one wave is
    one lane of k query rows against its live rows."""
    sizes = np.asarray(sizes, np.int64)
    ops = rows = 0.0
    for probes in waves:
        if not probes:
            continue
        b, k = np.unique(np.concatenate(probes).astype(np.int64),
                         return_counts=True)
        ops += 2.0 * dim * float((k * sizes[b]).sum())
        rows += float(sizes[b].sum() + k.sum())
    return ops, 4.0 * dim * rows + EMIT_BYTES * members_emitted


def share_pct(ops: float, nbytes: float, kernel_s: float) -> float | None:
    """Least time ÷ the kernels' device time, in per cent; None where the
    kernels took no time (nothing to read)."""
    if kernel_s <= 0 or (ops <= 0 and nbytes <= 0):
        return None
    return 100.0 * least_time_s(ops, nbytes) / kernel_s
