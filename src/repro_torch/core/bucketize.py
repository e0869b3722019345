"""Streaming, memory-bounded vector bucketization (paper §5.1).

Three sequential dataset scans, all block-granular (no read amplification):

  1. *Sample*   — stream X, collect the pre-drawn sample ids as centers.
  2. *Assign*   — stream X in blocks; nearest-center search per block via the
                  center index: up to its crossover (65,536 centers) the
                  exact ``bucket_assign`` kernel (its plain version on
                  the CPU), above it the approximate IVF index; record
                  assignment, per-bucket counts and radii (only counters
                  stay in memory).
  3. *Write*    — stream X again, appending each vector to its bucket's
                  buffered extent in the reorganized store (per-bucket
                  write buffers avoid write amplification).

Memory high-water mark: centers (≈1‰–1% of data) + index + block buffer +
per-bucket write buffers — matches the paper's "minimum ≈2% of dataset".

Port of the JAX package's ``core/bucketize.py``: scans 1 and 3, the
oversize split and the radii/compaction are the same numpy code. Only the
unstriped writer is ported (``io_devices > 1`` waits for the striped
store), and the resumable-build and sketch hooks wait for later slices.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.center_index import (BruteForceCenterIndex,
                                           make_center_index)
from repro_torch.core.types import BucketMeta, JoinConfig
from repro_torch.kernels import ops as kops
from repro_torch.store.vector_store import BucketedVectorStore, FlatVectorStore


def sample_centers(store: FlatVectorStore, num_centers: int,
                   seed: int, block_rows: int) -> np.ndarray:
    """Scan 1: random center sample via pre-drawn ids, sequential stream."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(store.num_vectors, size=num_centers,
                             replace=False))
    centers = np.empty((num_centers, store.dim), dtype=np.float32)
    filled = 0
    ptr = 0
    for start, block in store.iter_blocks(block_rows):
        end = start + block.shape[0]
        while ptr < num_centers and ids[ptr] < end:
            centers[filled] = block[ids[ptr] - start]
            filled += 1
            ptr += 1
        if ptr >= num_centers:
            break
    assert filled == num_centers
    return centers


def assign_blocks(store: FlatVectorStore, centers: np.ndarray,
                  block_rows: int, device: torch.device
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Scan 2: nearest-center assignment → (assignment, per-vector d²).

    The center index decides, as in the JAX package: where
    ``make_center_index`` returns the exact brute-force index (up to its
    crossover of 65,536 centers), every block goes through
    ``kops.bucket_assign``, which dispatches by the device: the CUDA
    kernel on the card, its plain version on the CPU. Above the crossover
    the IVF index's ``assign`` serves the blocks, approximate as the
    reference's is (it probes ``nprobe`` cells)."""
    assignment = np.empty(store.num_vectors, dtype=np.int64)
    dist_sq = np.empty(store.num_vectors, dtype=np.float32)
    index = make_center_index(centers, device=device)
    exact = isinstance(index, BruteForceCenterIndex)
    for start, block in store.iter_blocks(block_rows):
        if exact:
            x = torch.from_numpy(block.astype(np.float32)).to(device)
            d2, idx = kops.bucket_assign(x, index._centers_dev)
            d2, idx = d2.cpu().numpy(), idx.cpu().numpy()
        else:
            d2, idx = index.assign(block.astype(np.float32))
        assignment[start:start + block.shape[0]] = idx
        dist_sq[start:start + block.shape[0]] = d2
    return assignment, dist_sq


def split_oversized(assignment: np.ndarray, centers: np.ndarray,
                    max_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Split buckets above ``max_rows`` into sub-buckets sharing the center.

    Bounds the fixed-shape kernel's padding waste under cluster skew.
    Sub-buckets keep the parent's center (the bucket graph links them via
    zero-distance candidate edges, so no pairs are lost).
    """
    sizes = np.bincount(assignment, minlength=centers.shape[0])
    new_centers = []
    remap_base: dict[int, int] = {}
    for b, s in enumerate(sizes):
        remap_base[b] = len(new_centers)
        for _ in range(max(1, -(-int(s) // max_rows))):
            new_centers.append(centers[b])
    new_assignment = np.empty_like(assignment)
    counter = np.zeros(centers.shape[0], dtype=np.int64)
    for i, b in enumerate(assignment):
        sub = counter[b] // max_rows
        counter[b] += 1
        new_assignment[i] = remap_base[int(b)] + sub
    return new_assignment, np.asarray(new_centers, dtype=np.float32)


def write_buckets(store: FlatVectorStore, out_path: str,
                  assignment: np.ndarray, sizes: np.ndarray,
                  centers: np.ndarray, radii: np.ndarray,
                  block_rows: int, layout_order: np.ndarray | None = None):
    """Scan 3: stream X, append to per-bucket buffered extents.

    ``layout_order`` places bucket extents in Gorder/schedule order so
    schedule-adjacent buckets are disk-adjacent (read coalescing).
    """
    writer = BucketedVectorStore.create(
        out_path, store.dim, np.float32, sizes, centers, radii,
        stats=store.stats, layout_order=layout_order)
    for start, block in store.iter_blocks(block_rows):
        blk_assign = assignment[start:start + block.shape[0]]
        # group within the block to batch appends per bucket
        order = np.argsort(blk_assign, kind="stable")
        sorted_assign = blk_assign[order]
        boundaries = np.flatnonzero(np.diff(sorted_assign)) + 1
        for seg in np.split(np.arange(len(order)), boundaries):
            if seg.size == 0:
                continue
            b = int(sorted_assign[seg[0]])
            rows = order[seg]
            writer.append_batch(b, block[rows].astype(np.float32),
                                start + rows)
    return writer.finalize()


def bucketize(store: FlatVectorStore, out_path: str, config: JoinConfig,
              *, device: torch.device, layout_order_fn=None
              ) -> tuple[BucketedVectorStore, BucketMeta, dict]:
    """Full 3-scan bucketization → (bucketed store, metadata, timings).

    ``config`` may be a flat ``JoinConfig`` or a bare ``BuildConfig`` —
    bucketization consumes only build-time parameters (the query-time
    knob ``emulate_read_latency_s`` is read leniently, defaulting off).

    ``layout_order_fn(meta) -> np.ndarray | None``: called once the final
    bucket metadata is known, *before* the write scan — returns the disk
    layout order (typically the join's Gorder node order, see
    ``ordering.compute_node_order``) so the writer can make
    schedule-adjacent buckets disk-adjacent.
    """
    if config.io_devices > 1:
        raise NotImplementedError(
            "io_devices > 1 (striped bucket stores) is not ported yet; see "
            "ROADMAP.md, module queue: striping")
    timings: dict[str, float] = {}
    n_buckets = config.resolve_num_buckets(store.num_vectors)

    t0 = time.perf_counter()
    centers = sample_centers(store, n_buckets, config.seed,
                             config.block_rows)
    timings["sample"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    assignment, dist_sq = assign_blocks(store, centers, config.block_rows,
                                        device)
    timings["assign"] = time.perf_counter() - t0

    max_rows = config.max_bucket_rows
    if max_rows is None:
        avg = max(1, store.num_vectors // n_buckets)
        max_rows = max(config.pad_align,
                       ((2 * avg + config.pad_align - 1)
                        // config.pad_align) * config.pad_align)
    assignment, centers = split_oversized(assignment, centers, max_rows)
    n_buckets = centers.shape[0]

    # per-bucket stats over final (possibly split) buckets
    sizes = np.bincount(assignment, minlength=n_buckets).astype(np.int64)
    radii_sq = np.zeros(n_buckets, dtype=np.float64)
    np.maximum.at(radii_sq, assignment, dist_sq.astype(np.float64))
    radii = np.sqrt(np.maximum(radii_sq, 0.0)).astype(np.float32)

    # drop empty buckets (random sampling can orphan a center)
    nonempty = sizes > 0
    if not nonempty.all():
        remap = -np.ones(n_buckets, dtype=np.int64)
        remap[nonempty] = np.arange(int(nonempty.sum()))
        assignment = remap[assignment]
        centers, sizes, radii = (centers[nonempty], sizes[nonempty],
                                 radii[nonempty])

    meta = BucketMeta(centers=centers, radii=radii, sizes=sizes)

    layout_order = None
    if layout_order_fn is not None:
        t0 = time.perf_counter()
        layout_order = layout_order_fn(meta)
        timings["layout_plan"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    bstore = write_buckets(store, out_path, assignment, sizes, centers,
                           radii, config.block_rows,
                           layout_order=layout_order)
    timings["write"] = time.perf_counter() - t0
    bstore.read_latency_s = getattr(config, "emulate_read_latency_s", 0.0)

    return bstore, meta, timings
