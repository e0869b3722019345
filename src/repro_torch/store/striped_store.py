"""Multi-SSD striped bucketed store (ROADMAP: multi-SSD striping).

One NVMe queue should never be the ceiling when the schedule already knows
every future read: ``StripedBucketedVectorStore`` maps each bucket to one
of D backing files ("devices") so the prefetcher can keep every device's
submission queue full independently. Two placement policies:

  ``phase``  — round-robin over the *disk layout order* (Gorder/schedule
               order when the writer was given one): schedule-consecutive
               misses land on distinct devices, saturating all D queues.
  ``hash``   — bucket id mod D: order-oblivious, uniform by count.

Each device file is itself a ``BucketedVectorStore`` packing its buckets
in layout-rank order, so two rank-adjacent buckets on the same device are
always disk-adjacent — the property the prefetcher's coalescer exploits
(``contiguous_after`` / ``read_run_into``). All devices share one
``IOStats``, so amplification/traffic accounting is unchanged.

Files: ``<path>.meta`` (striping map) + per-device ``<path>.d<k>[.*]``
(standard bucketed-store files over that device's bucket subset) +
top-level ``<path>.centers.npy`` / ``<path>.radii.npy``.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.store.io_stats import IOStats
from repro_torch.store.vector_store import BucketedVectorStore, check_layout_order


def _device_path(path: str, dev: int) -> str:
    return f"{path}.d{dev}"


# phase-striping chunk used when read coalescing is on: runs of this many
# layout-rank-consecutive buckets share a device (coalescible into one
# sequential read) while chunks still round-robin across devices. Half the
# prefetcher's MAX_BATCH, so a typical lookahead window (≥ chunk × D)
# keeps every device busy and still forms multi-bucket runs.
COALESCE_STRIPE_CHUNK = 4


class StripedBucketedVectorStore:
    """Bucketed store striped over D backing files; one read queue each.

    Same read surface as ``BucketedVectorStore`` (``read_bucket``,
    ``read_bucket_into``, ``read_run_into``, stats) plus the device
    surface (``num_devices``, ``device_of``) the per-device prefetcher
    routes on.
    """

    def __init__(self, path: str, stats: IOStats | None = None,
                 read_latency_s: float = 0.0):
        self.path = path
        self.stats = stats if stats is not None else IOStats()
        with open(path + ".meta") as f:
            meta = json.load(f)
        if not meta.get("striped"):
            raise ValueError(f"{path}.meta is not a striped-store meta")
        self.num_devices = int(meta["num_devices"])
        self.stripe_by = meta.get("stripe_by", "phase")
        self._device_of = np.asarray(meta["device_of"], dtype=np.int64)
        self._local_id = np.asarray(meta["local_id"], dtype=np.int64)
        self.devices = [
            BucketedVectorStore(_device_path(path, d), stats=self.stats)
            for d in range(self.num_devices)]
        self.dim = self.devices[0].dim
        self.dtype = self.devices[0].dtype
        self.row_bytes = self.devices[0].row_bytes
        self.bucket_sizes = np.asarray(meta["sizes"], dtype=np.int64)
        self.num_buckets = len(self.bucket_sizes)
        self.num_vectors = int(self.bucket_sizes.sum())
        self.centers = np.load(path + ".centers.npy")
        self.radii = np.load(path + ".radii.npy")
        self.read_latency_s = read_latency_s

    # emulated latency is charged by the device performing the read
    @property
    def read_latency_s(self) -> float:
        return self.devices[0].read_latency_s

    @read_latency_s.setter
    def read_latency_s(self, value: float) -> None:
        for dev in self.devices:
            dev.read_latency_s = value

    # -- construction -------------------------------------------------------
    @staticmethod
    def create(path: str, dim: int, dtype, bucket_sizes: np.ndarray,
               centers: np.ndarray, radii: np.ndarray,
               num_devices: int, stats: IOStats | None = None,
               layout_order: np.ndarray | None = None,
               stripe_by: str = "phase",
               stripe_chunk: int = 1) -> "_StripedWriter":
        """``stripe_chunk`` (phase striping only): consecutive layout
        ranks share a device in runs of this size before rotating —
        chunk 1 maximizes fan-out, larger chunks keep schedule-adjacent
        buckets coalescible on one device."""
        return _StripedWriter(path, dim, np.dtype(dtype),
                              np.asarray(bucket_sizes, dtype=np.int64),
                              centers, radii, int(num_devices),
                              stats if stats is not None else IOStats(),
                              layout_order, stripe_by, int(stripe_chunk))

    # -- device surface ------------------------------------------------------
    def device_of(self, b: int) -> int:
        return int(self._device_of[b])

    def contiguous_after(self, a: int, b: int) -> bool:
        """Disk-adjacent ⇔ same device and adjacent in its file."""
        if self._device_of[a] != self._device_of[b]:
            return False
        dev = self.devices[int(self._device_of[a])]
        return dev.contiguous_after(int(self._local_id[a]),
                                    int(self._local_id[b]))

    def layout_keys(self, buckets) -> np.ndarray:
        """Disk-placement sort key (see ``BucketedVectorStore.layout_keys``).

        Offset-major with the device as tie-break: sorting an unordered
        miss set by this key keeps each device's disk-contiguous buckets
        adjacent (coalescible) while still interleaving devices at extent
        granularity, so one device's backlog never serializes the rest."""
        buckets = np.asarray(buckets, dtype=np.int64)
        devs = self._device_of[buckets]
        keys = np.empty(len(buckets), dtype=np.int64)
        for d in range(self.num_devices):
            m = devs == d
            if m.any():
                local = self._local_id[buckets[m]]
                keys[m] = (self.devices[d].bucket_offsets[local]
                           * self.num_devices + d)
        return keys

    # -- reads ---------------------------------------------------------------
    def read_bucket(self, b: int) -> tuple[np.ndarray, np.ndarray]:
        return self.devices[self.device_of(b)].read_bucket(
            int(self._local_id[b]))

    def read_bucket_into(self, b: int, out_vecs: np.ndarray,
                         out_ids: np.ndarray,
                         pad_value: float = 0.0) -> int:
        return self.devices[self.device_of(b)].read_bucket_into(
            int(self._local_id[b]), out_vecs, out_ids, pad_value=pad_value)

    def read_run_into(self, buckets, out_vecs, out_ids,
                      pad_value: float = 0.0) -> list[int]:
        dev = self.device_of(buckets[0])
        if any(self.device_of(b) != dev for b in buckets[1:]):
            raise ValueError("coalesced run spans devices")
        local = [int(self._local_id[b]) for b in buckets]
        return self.devices[dev].read_run_into(local, out_vecs, out_ids,
                                               pad_value=pad_value)

    # -- sizing / lifecycle --------------------------------------------------
    def bucket_nbytes(self, b: int) -> int:
        return int(self.bucket_sizes[b]) * self.row_bytes

    @property
    def nbytes(self) -> int:
        return self.num_vectors * self.row_bytes

    def device_loads_balanced(self) -> np.ndarray:
        """Bytes resident per device (striping-balance diagnostic)."""
        out = np.zeros(self.num_devices, dtype=np.int64)
        np.add.at(out, self._device_of, self.bucket_sizes * self.row_bytes)
        return out

    def close(self) -> None:
        for dev in self.devices:
            dev.close()


class _StripedWriter:
    """Streaming writer fanned out over per-device ``_BucketedWriter``s.

    Placement is fixed up front from (layout_order, stripe_by); each
    device's writer packs its buckets in layout-rank order, which is what
    makes rank-adjacent same-device buckets disk-contiguous.
    """

    def __init__(self, path, dim, dtype, bucket_sizes, centers, radii,
                 num_devices, stats, layout_order, stripe_by,
                 stripe_chunk: int = 1):
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        if stripe_by not in ("phase", "hash"):
            raise ValueError(f"stripe_by must be 'phase' or 'hash', "
                             f"got {stripe_by!r}")
        self.path = path
        self.stats = stats
        self.bucket_sizes = bucket_sizes
        num_buckets = len(bucket_sizes)
        # an empty device file would be an unmappable 0-row store
        num_devices = min(num_devices, max(1, num_buckets))
        stripe_chunk = max(1, int(stripe_chunk))
        order = (check_layout_order(layout_order, num_buckets)
                 if layout_order is not None
                 else np.arange(num_buckets, dtype=np.int64))
        rank = np.empty(num_buckets, dtype=np.int64)
        rank[order] = np.arange(num_buckets)
        if stripe_by == "phase":
            device_of = (rank // stripe_chunk) % num_devices
        else:
            device_of = np.arange(num_buckets, dtype=np.int64) % num_devices
        # chunking (or few buckets) can leave a device empty, and an empty
        # device file is unmappable — compact device ids onto those in use
        used = np.unique(device_of)
        if len(used) < num_devices:
            remap = np.full(num_devices, -1, dtype=np.int64)
            remap[used] = np.arange(len(used))
            device_of = remap[device_of]
            num_devices = len(used)
        self._device_of = device_of
        # local ids assigned in rank order per device → per-device layout
        # follows the global schedule order
        self._local_id = np.empty(num_buckets, dtype=np.int64)
        self._writers = []
        for d in range(num_devices):
            mine = order[device_of[order] == d]  # device d's buckets, by rank
            self._local_id[mine] = np.arange(len(mine))
            self._writers.append(BucketedVectorStore.create(
                _device_path(path, d), dim, dtype, bucket_sizes[mine],
                centers[mine], radii[mine], stats=stats))
        self._meta = {
            "striped": True, "num_devices": num_devices,
            "stripe_by": stripe_by, "stripe_chunk": stripe_chunk,
            "dim": dim, "dtype": np.dtype(dtype).name,
            "sizes": bucket_sizes.tolist(),
            "device_of": device_of.tolist(),
            "local_id": self._local_id.tolist(),
        }
        np.save(path + ".centers.npy", centers)
        np.save(path + ".radii.npy", radii)

    def append(self, bucket: int, vec: np.ndarray, vec_id: int) -> None:
        try:
            self._writers[int(self._device_of[bucket])].append(
                int(self._local_id[bucket]), vec, vec_id)
        except ValueError as e:
            raise ValueError(f"striped bucket {bucket}: {e}") from e

    def append_batch(self, bucket: int, vecs: np.ndarray,
                     ids: np.ndarray) -> None:
        try:
            self._writers[int(self._device_of[bucket])].append_batch(
                int(self._local_id[bucket]), vecs, ids)
        except ValueError as e:
            raise ValueError(f"striped bucket {bucket}: {e}") from e

    def finalize(self) -> StripedBucketedVectorStore:
        for w in self._writers:
            w.finalize()
        with open(self.path + ".meta", "w") as f:
            json.dump(self._meta, f)
        return StripedBucketedVectorStore(self.path, stats=self.stats)
