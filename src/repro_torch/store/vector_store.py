"""File-backed vector stores.

``FlatVectorStore`` — row-major (N, d) array on disk, read per-vector or in
sequential blocks. This models the *input* dataset and the baseline access
pattern (per-vector reads suffer read amplification when row bytes < 4 KB).

``BucketedVectorStore`` — DiskJoin's reorganized layout: each bucket's
vectors are contiguous, fetched with one sequential read. Bucket loads are
page-aligned, so amplification ≈ bucket_bytes / page_round(bucket_bytes) → 1
for buckets ≫ 4 KB (paper Fig. 16: amp 1.003–1.004).

Both are np.memmap-backed; every access is accounted in an ``IOStats``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Iterator, Sequence

import numpy as np

from repro_torch.store.io_stats import IOStats, read_timer, write_timer


def check_layout_order(order: np.ndarray, num_buckets: int) -> np.ndarray:
    """Validate a disk-layout permutation (O(B) numpy, no PyObject churn)."""
    order = np.asarray(order, dtype=np.int64)
    if (order.shape != (num_buckets,)
            or not np.array_equal(np.sort(order),
                                  np.arange(num_buckets, dtype=np.int64))):
        raise ValueError("layout_order must be a permutation of bucket ids")
    return order


class FlatVectorStore:
    """(N, d) float32/float16 matrix on disk with per-row and block reads."""

    def __init__(self, path: str, num_vectors: int, dim: int,
                 dtype=np.float32, stats: IOStats | None = None,
                 create: bool = False):
        self.path = path
        self.num_vectors = int(num_vectors)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.row_bytes = self.dim * self.dtype.itemsize
        self.stats = stats if stats is not None else IOStats()
        mode = "w+" if create else "r+"
        self._mm = np.memmap(path, dtype=self.dtype, mode=mode,
                             shape=(self.num_vectors, self.dim))

    # -- construction -------------------------------------------------------
    @classmethod
    def from_array(cls, path: str, data: np.ndarray,
                   stats: IOStats | None = None) -> "FlatVectorStore":
        store = cls(path, data.shape[0], data.shape[1], data.dtype,
                    stats=stats, create=True)
        store._mm[:] = data
        store._mm.flush()
        store.stats.record_write(data.nbytes)
        return store

    # -- reads --------------------------------------------------------------
    def read_vector(self, idx: int) -> np.ndarray:
        """Single-vector random read — page-granular (models SSD behaviour)."""
        with read_timer(self.stats):
            out = np.array(self._mm[idx])
        self.stats.record_read(self.row_bytes)  # page-rounded internally
        return out

    def read_rows(self, idxs: Sequence[int]) -> np.ndarray:
        """Gather of rows; each row is an independent page-granular read."""
        with read_timer(self.stats):
            out = np.array(self._mm[np.asarray(idxs, dtype=np.int64)])
        self.stats.record_reads(len(idxs), self.row_bytes)
        return out

    def read_block(self, start: int, count: int) -> np.ndarray:
        """Sequential block read — amplification amortizes to ~1."""
        with read_timer(self.stats):
            out = np.array(self._mm[start:start + count])
        self.stats.record_read(count * self.row_bytes)
        return out

    def iter_blocks(self, block_rows: int) -> Iterator[tuple[int, np.ndarray]]:
        """Stream the dataset in sequential blocks (one full scan)."""
        for start in range(0, self.num_vectors, block_rows):
            count = min(block_rows, self.num_vectors - start)
            yield start, self.read_block(start, count)

    # -- writes -------------------------------------------------------------
    def write_block(self, start: int, data: np.ndarray) -> None:
        with write_timer(self.stats):
            self._mm[start:start + data.shape[0]] = data
        self.stats.record_write(data.nbytes)

    def flush(self) -> None:
        self._mm.flush()

    @property
    def nbytes(self) -> int:
        return self.num_vectors * self.row_bytes

    def close(self) -> None:
        del self._mm


class BucketedVectorStore:
    """DiskJoin's on-disk layout: buckets stored contiguously.

    Files:
      <path>         — the concatenated vector data
      <path>.meta    — JSON: dim, dtype, bucket offsets/sizes, centers file
      <path>.ids     — int64 original vector ids, same layout as data
      <path>.centers — (B, d) centers;  <path>.radii — (B,) radii
    """

    def __init__(self, path: str, stats: IOStats | None = None,
                 fragment_rows: int | None = None,
                 read_latency_s: float = 0.0):
        """``fragment_rows``: emulate file-system fragmentation (paper
        Fig. 14) — each bucket read is accounted as ⌈size/fragment⌉
        page-rounded extent reads instead of one sequential read.
        ``read_latency_s``: emulate SSD access latency — each bucket read
        sleeps this long (page-cache memmap reads are RAM-speed in this
        container; the latency knob restores the paper's I/O-bound regime
        for the pipeline benchmarks)."""
        self.path = path
        self.stats = stats if stats is not None else IOStats()
        self.fragment_rows = fragment_rows
        self.read_latency_s = read_latency_s
        with open(path + ".meta") as f:
            meta = json.load(f)
        self.dim = int(meta["dim"])
        self.dtype = np.dtype(meta["dtype"])
        self.row_bytes = self.dim * self.dtype.itemsize
        self.bucket_offsets = np.asarray(meta["offsets"], dtype=np.int64)
        self.bucket_sizes = np.asarray(meta["sizes"], dtype=np.int64)
        self.num_buckets = len(self.bucket_sizes)
        self.num_vectors = int(self.bucket_sizes.sum())
        self._mm = np.memmap(path, dtype=self.dtype, mode="r",
                             shape=(self.num_vectors, self.dim))
        self._ids = np.memmap(path + ".ids", dtype=np.int64, mode="r",
                              shape=(self.num_vectors,))
        self.centers = np.load(path + ".centers.npy")
        self.radii = np.load(path + ".radii.npy")

    # -- construction -------------------------------------------------------
    @staticmethod
    def create(path: str, dim: int, dtype, bucket_sizes: np.ndarray,
               centers: np.ndarray, radii: np.ndarray,
               stats: IOStats | None = None,
               layout_order: np.ndarray | None = None) -> "_BucketedWriter":
        """``layout_order``: permutation of bucket ids giving their on-disk
        extent order (Gorder/schedule order ⇒ schedule-adjacent buckets are
        disk-adjacent, enabling coalesced sequential reads). None = id
        order."""
        return _BucketedWriter(path, dim, np.dtype(dtype), bucket_sizes,
                               centers, radii,
                               stats if stats is not None else IOStats(),
                               layout_order=layout_order)

    # -- device surface (uniform with StripedBucketedVectorStore) -----------
    num_devices = 1

    def device_of(self, b: int) -> int:
        return 0

    def contiguous_after(self, a: int, b: int) -> bool:
        """True iff bucket ``b``'s extent starts where ``a``'s ends.

        Under emulated file-system fragmentation nothing is guaranteed
        contiguous, so coalescing is disabled — ``read_run_into`` would
        otherwise charge one sequential read for extents the fragmented
        file cannot physically serve that way.
        """
        if self.fragment_rows:
            return False
        return (int(self.bucket_offsets[b])
                == int(self.bucket_offsets[a]) + int(self.bucket_sizes[a]))

    def layout_keys(self, buckets) -> np.ndarray:
        """Disk-placement sort key per bucket: an *unordered* bucket set
        (e.g. a serving wave's unioned miss set) read in ascending key
        order visits the file in extent order, so disk-adjacent buckets
        become read-adjacent and the prefetcher's batching/coalescing
        applies to ad-hoc sets the same way it does to join schedules."""
        return self.bucket_offsets[np.asarray(buckets, dtype=np.int64)]

    # -- reads --------------------------------------------------------------
    def read_bucket(self, b: int) -> tuple[np.ndarray, np.ndarray]:
        """One sequential read of bucket b → (vectors, original ids)."""
        size = int(self.bucket_sizes[b])
        vecs = np.empty((size, self.dim), self.dtype)
        ids = np.empty(size, np.int64)
        self.read_bucket_into(b, vecs, ids)
        return vecs, ids

    def read_bucket_into(self, b: int, out_vecs: np.ndarray,
                         out_ids: np.ndarray,
                         pad_value: float = 0.0) -> int:
        """Read bucket ``b`` directly into preallocated slabs (no per-read
        allocation — the hot path of the prefetching I/O subsystem).

        ``out_vecs``: (capacity, dim) float32, ``out_ids``: (capacity,)
        int64 with capacity >= bucket size; rows past the bucket are filled
        with ``pad_value`` / -1. Returns the bucket's row count.
        ``read_bucket`` delegates here, so sync and prefetch reads share
        one accounting path.

        One page-aligned sequential read per bucket (vectors dominate; the
        id sidecar is read alongside and accounted at byte granularity) —
        under emulated fragmentation, one read per extent instead.
        """
        off = int(self.bucket_offsets[b])
        size = int(self.bucket_sizes[b])
        with read_timer(self.stats):
            if self.read_latency_s:
                time.sleep(self.read_latency_s)
            out_vecs[:size] = self._mm[off:off + size]
            out_ids[:size] = self._ids[off:off + size]
        out_vecs[size:] = pad_value
        out_ids[size:] = -1
        if self.fragment_rows and size:
            extents = -(-size // self.fragment_rows)
            full, last = extents - 1, size - (extents - 1) * self.fragment_rows
            self.stats.record_reads(full, self.fragment_rows * self.row_bytes)
            self.stats.record_read(last * self.row_bytes)
        else:
            self.stats.record_read(size * self.row_bytes)
        self.stats.record_read(size * 8, page_aligned=False)
        return size

    def read_run_into(self, buckets, out_vecs, out_ids,
                      pad_value: float = 0.0) -> list[int]:
        """Coalesced read: a disk-contiguous run of buckets fetched as ONE
        sequential read, split into per-bucket slabs on completion.

        ``buckets`` must satisfy ``contiguous_after`` pairwise (the
        prefetcher's coalescer guarantees this); the whole run is accounted
        as a single read op and charged one emulated-latency access.
        """
        for a, b in zip(buckets, buckets[1:]):
            if not self.contiguous_after(a, b):
                raise ValueError(f"buckets {a},{b} are not disk-contiguous")
        sizes = [int(self.bucket_sizes[b]) for b in buckets]
        with read_timer(self.stats):
            if self.read_latency_s:
                time.sleep(self.read_latency_s)
            for b, n, ov, oi in zip(buckets, sizes, out_vecs, out_ids):
                off = int(self.bucket_offsets[b])
                ov[:n] = self._mm[off:off + n]
                oi[:n] = self._ids[off:off + n]
                ov[n:] = pad_value
                oi[n:] = -1
        total = sum(sizes)
        self.stats.record_read(total * self.row_bytes)
        self.stats.record_read(total * 8, page_aligned=False)
        return sizes

    def bucket_nbytes(self, b: int) -> int:
        return int(self.bucket_sizes[b]) * self.row_bytes

    @property
    def nbytes(self) -> int:
        return self.num_vectors * self.row_bytes

    def close(self) -> None:
        del self._mm
        del self._ids


class _BucketedWriter:
    """Streaming writer with per-bucket buffers (paper §5.1).

    Vectors are appended to in-memory per-bucket buffers and flushed to their
    reserved disk extent when the buffer fills — avoiding sub-page writes
    (write amplification). Buffer memory is bounded by
    ``buffer_rows_per_bucket × num_buckets × row_bytes``.
    """

    def __init__(self, path, dim, dtype, bucket_sizes, centers, radii, stats,
                 buffer_rows_per_bucket: int = 64,
                 layout_order: np.ndarray | None = None):
        self.path = path
        self.dim = dim
        self.dtype = dtype
        self.stats = stats
        self.bucket_sizes = np.asarray(bucket_sizes, dtype=np.int64)
        if layout_order is None:
            self.bucket_offsets = np.concatenate(
                [[0], np.cumsum(self.bucket_sizes)[:-1]])
        else:
            order = check_layout_order(layout_order, len(self.bucket_sizes))
            ordered = self.bucket_sizes[order]
            csum = np.concatenate([[0], np.cumsum(ordered)[:-1]])
            self.bucket_offsets = np.empty_like(self.bucket_sizes)
            self.bucket_offsets[order] = csum
        self.num_vectors = int(self.bucket_sizes.sum())
        self._mm = np.memmap(path, dtype=dtype, mode="w+",
                             shape=(self.num_vectors, dim))
        self._ids = np.memmap(path + ".ids", dtype=np.int64, mode="w+",
                              shape=(self.num_vectors,))
        self._fill = np.zeros(len(bucket_sizes), dtype=np.int64)
        self._buf_cap = buffer_rows_per_bucket
        self._buf_vecs: dict[int, list[np.ndarray]] = {}
        self._buf_ids: dict[int, list[int]] = {}
        np.save(path + ".centers.npy", centers)
        np.save(path + ".radii.npy", radii)
        self._meta = {
            "dim": dim, "dtype": np.dtype(dtype).name,
            "offsets": self.bucket_offsets.tolist(),
            "sizes": self.bucket_sizes.tolist(),
        }

    def append(self, bucket: int, vec: np.ndarray, vec_id: int) -> None:
        planned = int(self.bucket_sizes[bucket])
        appended = int(self._fill[bucket]) + len(self._buf_vecs.get(bucket, ()))
        if appended >= planned:
            # without this check the flush would silently write past the
            # bucket's reserved extent into its neighbor's rows
            raise ValueError(
                f"bucket {bucket} overflow: layout reserved {planned} rows, "
                f"append #{appended + 1} (vec id {vec_id}) exceeds the extent")
        self._buf_vecs.setdefault(bucket, []).append(np.asarray(vec, self.dtype))
        self._buf_ids.setdefault(bucket, []).append(int(vec_id))
        if len(self._buf_vecs[bucket]) >= self._buf_cap:
            self._flush_bucket(bucket)

    def append_batch(self, bucket: int, vecs: np.ndarray,
                     ids: np.ndarray) -> None:
        for v, i in zip(vecs, ids):
            self.append(bucket, v, i)

    def _flush_bucket(self, b: int) -> None:
        vecs = self._buf_vecs.pop(b, [])
        ids = self._buf_ids.pop(b, [])
        if not vecs:
            return
        arr = np.stack(vecs)
        if int(self._fill[b]) + len(vecs) > int(self.bucket_sizes[b]):
            raise ValueError(
                f"bucket {b} overflow: flushing {len(vecs)} rows at fill "
                f"{int(self._fill[b])} would overrun the reserved extent of "
                f"{int(self.bucket_sizes[b])} rows")
        start = int(self.bucket_offsets[b] + self._fill[b])
        with write_timer(self.stats):
            self._mm[start:start + len(vecs)] = arr
            self._ids[start:start + len(vecs)] = np.asarray(ids)
        self.stats.record_write(arr.nbytes)
        self._fill[b] += len(vecs)

    def finalize(self) -> BucketedVectorStore:
        for b in list(self._buf_vecs.keys()):
            self._flush_bucket(b)
        if not np.array_equal(self._fill, self.bucket_sizes):
            bad = int(np.flatnonzero(self._fill != self.bucket_sizes)[0])
            raise ValueError(
                f"bucket fill mismatch: bucket {bad} appended "
                f"{int(self._fill[bad])} rows vs {int(self.bucket_sizes[bad])}"
                f" planned (totals {int(self._fill.sum())} vs "
                f"{int(self.bucket_sizes.sum())})")
        self._mm.flush()
        self._ids.flush()
        with open(self.path + ".meta", "w") as f:
            json.dump(self._meta, f)
        del self._mm, self._ids
        return BucketedVectorStore(self.path, stats=self.stats)


def dataset_path(root: str, name: str) -> str:
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, name)
