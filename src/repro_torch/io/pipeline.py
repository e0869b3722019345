"""Pipeline telemetry: how much disk time the prefetcher actually hid.

``io_wait_s`` is the executor-observed stall (time blocked on a load that
wasn't ready); ``read_s`` is the wall time workers spent inside reads. A
perfect pipeline has io_wait → 0 with read_s unchanged, so

    overlap_efficiency = hidden / read_s,  hidden = max(0, read_s - io_wait)

(1.0 = all I/O behind compute, 0.0 = fully serial — the sync executor by
construction). Queue depth and backpressure counters come from the
prefetcher/pool and size the lookahead/pool knobs.

Multi-device additions (striped stores): per-device load counts and max
in-flight depth (is every device's queue actually kept full?), plus the
batched-submission and coalesced-read counters of the io_uring-style
submission path (how many per-read round trips the batching saved).
"""
from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class PipelineStats:
    io_wait_s: float = 0.0      # executor stall waiting on loads
    compute_s: float = 0.0      # executor time in verify/flush
    read_s: float = 0.0         # worker wall time inside bucket reads
    loads: int = 0              # loads consumed by the executor
    stalls: int = 0             # loads that were not ready when needed
    flush_on_stall: int = 0     # early batch flushes to release pins
    max_queue_depth: int = 0    # max issued-not-consumed loads
    pool_slabs: int = 0
    max_slabs_in_use: int = 0
    blocked_acquires: int = 0   # pool-exhaustion backpressure events
    lookahead: int = 0
    num_devices: int = 1        # submission queues (striped store stripes)
    batched_submissions: int = 0  # submissions carrying > 1 read
    batched_reads: int = 0        # reads that rode in a batched submission
    coalesced_reads: int = 0      # merged sequential reads performed
    coalesced_buckets: int = 0    # buckets served by coalesced reads
    # transient-fault handling (repro.io.retry): a flaky SSD read is
    # retried with capped exponential backoff instead of aborting the join
    io_read_errors: int = 0       # read attempts that raised OSError
    io_retries: int = 0           # re-issued reads (≤ errors; last may fail)
    # serving fast restart (repro.ft): buckets pre-faulted into the warm
    # cache from a residency snapshot by DiskJoinIndex.open(warm_start=True)
    warm_prefaults: int = 0
    residency_snapshots: int = 0  # periodic in-run snapshots submitted
    # online point-query serving (DiskJoinIndex.query — shares this stats
    # object with the batch joins of the same index session)
    queries: int = 0              # point queries answered
    query_reads: int = 0          # bucket reads issued for queries (pooled)
    query_warm_hits: int = 0      # query candidates served from warm slabs
    query_fallback_reads: int = 0  # unpooled reads (pool fully contended)
    # wave-batched serving (repro.serve.QueryScheduler): concurrent
    # queries probing the same bucket in one wave share a single read
    waves: int = 0                   # scheduler waves executed
    shared_probe_reads: int = 0      # distinct buckets probed per wave, summed
    reads_saved_by_sharing: int = 0  # per-query probe refs minus distinct
    deadline_drops: int = 0          # requests expired & dropped (any stage)
    deadline_drops_midwave: int = 0  # subset dropped after the wave's reads
    midwave_skipped_reads: int = 0   # reads skipped: all probers cancelled
    admission_rejects: int = 0       # requests refused by estimate admission
    # cost-based planner (repro.plan): decisions taken per session
    plans: int = 0                   # batch-join plans emitted
    wave_plans: int = 0              # serving-wave plans emitted
    planned_pair_cap: int = 0        # last planned compaction capacity
    # device verify pipeline (repro.compute, compute_mode="device"):
    # slab H2D transfers are bounded by cache residencies, not edge count
    h2d_transfers: int = 0           # host→device transfers issued
    h2d_bytes: int = 0               # bytes moved host→device
    d2h_bytes: int = 0               # result bytes fetched device→host
    h2d_transfers_saved: int = 0     # operand refs served device-resident
    device_slab_hits: int = 0        # lookups hitting the device slab pool
    device_batches: int = 0          # double-buffered kernel dispatches
    device_compact_overflows: int = 0  # batches re-compacted at larger cap
    d2h_overlap_s: float = 0.0       # host work overlapped with the kernel
    device_loads: list = dataclasses.field(default_factory=list)
    device_depth_max: list = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def add(self, field: str, amount) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + amount)

    def observe_depth(self, depth: int) -> None:
        with self._lock:
            self.max_queue_depth = max(self.max_queue_depth, depth)

    # -- per-device telemetry -------------------------------------------------
    def init_devices(self, num_devices: int) -> None:
        with self._lock:
            self.num_devices = int(num_devices)
            self.device_loads = [0] * self.num_devices
            self.device_depth_max = [0] * self.num_devices

    def observe_device_depth(self, dev: int, depth: int) -> None:
        with self._lock:
            self.device_depth_max[dev] = max(self.device_depth_max[dev],
                                             depth)

    def count_device_loads(self, dev: int, n: int) -> None:
        with self._lock:
            self.device_loads[dev] += n

    @property
    def overlap_efficiency(self) -> float:
        if self.read_s <= 0:
            return 1.0
        return max(0.0, self.read_s - self.io_wait_s) / self.read_s

    # configuration/high-water fields: a point-in-time reading, not an
    # accumulating counter — reported as-is by snapshot_since
    GAUGE_FIELDS = frozenset({
        "pool_slabs", "lookahead", "num_devices", "max_queue_depth",
        "max_slabs_in_use", "blocked_acquires", "device_depth_max",
        "planned_pair_cap",
    })

    def snapshot(self) -> dict:
        with self._lock:
            d = {}
            for f in dataclasses.fields(PipelineStats):
                v = getattr(self, f.name)
                d[f.name] = list(v) if isinstance(v, list) else v
        d["overlap_efficiency"] = (
            max(0.0, d["read_s"] - d["io_wait_s"]) / d["read_s"]
            if d["read_s"] > 0 else 1.0)
        return d

    @staticmethod
    def merge(snapshots: list[dict]) -> dict:
        """Aggregate ``snapshot()`` dicts from several sessions (one per
        router shard) into one rollup. Naive summation is wrong for two
        classes of fields: the list-valued per-device telemetry
        (``device_loads``/``device_depth_max``) — shards own *distinct*
        devices, so lists concatenate and ``num_devices`` sums rather
        than zip-adding lists of unequal length — and the gauges, which
        are point-in-time readings where only the max across shards is
        meaningful. Additive counters sum; ``overlap_efficiency`` is
        recomputed from the merged read/wait totals, never averaged.
        """
        out: dict = {}
        for f in dataclasses.fields(PipelineStats):
            k = f.name
            if k in ("device_loads", "device_depth_max"):
                out[k] = [x for s in snapshots for x in s.get(k, [])]
            elif k == "num_devices":
                out[k] = sum(s.get(k, 0) for s in snapshots)
            elif k in PipelineStats.GAUGE_FIELDS:
                out[k] = max((s.get(k, 0) for s in snapshots), default=0)
            else:
                out[k] = sum(s.get(k, 0) for s in snapshots)
        out["overlap_efficiency"] = (
            max(0.0, out["read_s"] - out["io_wait_s"]) / out["read_s"]
            if out["read_s"] > 0 else 1.0)
        return out

    def snapshot_since(self, base: dict) -> dict:
        """Per-run view on a long-lived (session) stats object: additive
        counters are diffed against ``base`` (a prior ``snapshot()``);
        gauges report their current reading. Activity from concurrent
        consumers of the same session (e.g. online queries during a batch
        join) lands in the window it happened in."""
        cur = self.snapshot()
        out = {}
        for k, v in cur.items():
            b = base.get(k)
            if k in self.GAUGE_FIELDS or k == "overlap_efficiency" \
                    or b is None:
                out[k] = v
            elif isinstance(v, list):
                # per-device lists are RESET by init_devices each time a
                # prefetcher attaches, so the current list already is the
                # latest run's telemetry; subtracting a base captured
                # before that reset (e.g. holding the build/layout pass's
                # loads) would undercount whichever devices were busy then
                out[k] = v
            else:
                out[k] = v - b
        out["overlap_efficiency"] = (
            max(0.0, out["read_s"] - out["io_wait_s"]) / out["read_s"]
            if out["read_s"] > 0 else 1.0)
        return out
