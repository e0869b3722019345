"""Core datatypes for the DiskJoin engine (copied from the JAX package;
the manifest format depends on these fields, so they stay identical).

Configuration is split along the build/query boundary of the session API
(``repro_torch.core.index.DiskJoinIndex``):

  * **build-time** parameters (``BuildConfig``, ``BUILD_TIME_FIELDS``)
    shape the on-disk index — bucket count/capacity, padding, striping,
    layout order. They are frozen into the index manifest by
    ``DiskJoinIndex.build`` and can only change via a rebuild.
  * **query-time** parameters (``QueryConfig``, ``QUERY_TIME_FIELDS``)
    shape a single join/query — ε, λ, memory budget, eviction, io_mode,
    prefetch knobs. They may vary per call against one build.

``JoinConfig`` remains the flat union of both (the one-shot API), with
``split_config``/``merge_config`` converting between the two views.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _validate_compute(compute_mode: str, verify_batch: int,
                      plan_mode: str = "off") -> None:
    if compute_mode not in ("host", "device", "auto"):
        raise ValueError(f"compute_mode must be 'host', 'device' or "
                         f"'auto', got {compute_mode!r}")
    if plan_mode not in ("off", "on"):
        raise ValueError(f"plan_mode must be 'off' or 'on', "
                         f"got {plan_mode!r}")
    if compute_mode == "auto" and plan_mode != "on":
        # "auto" is a planner decision, not an engine the executor can
        # instantiate — without a plan there is nothing to resolve it
        raise ValueError("compute_mode='auto' requires plan_mode='on'")
    if verify_batch < 1:
        raise ValueError(f"verify_batch must be >= 1, got {verify_batch}")


def _resolve_num_buckets(num_buckets: Optional[int], num_vectors: int) -> int:
    if num_buckets is not None:
        return max(2, min(num_buckets, num_vectors))
    # paper Fig. 11: best at ~1‰ of dataset size
    return max(2, min(num_vectors // 2, max(16, num_vectors // 1000)))


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Task configuration (paper §3 inputs).

    Attributes:
      epsilon: distance threshold for similar pairs (L2).
      recall_target: λ — expected recall of the approximate result.
      memory_budget_bytes: C — cache memory for resident buckets.
      num_buckets: number of buckets; paper default ≈ 1‰ of N (Fig. 11).
      bucket_capacity: pad buckets to this many rows for fixed-shape kernels
        (TPU adaptation: one compiled kernel, MXU-aligned tiles).
      eviction_policy: "belady" | "lru" | "fifo" | "lfu" (Fig. 17 ablation).
      reorder: task reordering on/off (Fig. 17 ablation).
      order_strategy: "gorder" (paper §4.3) | "spatial" (beyond-paper
        nearest-neighbor center tour — see ordering.spatial_order).
      prune: probabilistic candidate-bucket pruning on/off (Fig. 18 ablation).
      max_candidates: L — nearest centers fetched per bucket before pruning.
      use_pallas: kept so manifests round-trip with the JAX package; the
        port ignores it. Dispatch goes by the tensor's device: a CUDA
        tensor always runs the hand-written kernel, a CPU tensor always
        the plain PyTorch version (``repro_torch.kernels.ops``).
      block_rows: streaming block size (rows) for dataset scans.
      max_bucket_rows: split buckets above this row count into sub-buckets
        sharing the center (bounds kernel padding waste under skew).
      pad_align: bucket row padding alignment (128 = MXU tile; smaller is
        fine for CPU validation runs).
      seed: RNG seed for center sampling.
      io_mode: "sync" (read buckets inline, serial read→verify loop) or
        "prefetch" (repro.io subsystem: schedule-driven background reads
        overlapped with verification; identical result pair set).
      io_lookahead: max bucket loads the prefetcher runs ahead of the
        executor (bounds prefetch staging memory and queue depth).
      io_pool_slabs: slab count of the prefetch buffer pool; None sizes it
        to cache capacity + io_lookahead. Values below cache capacity + 1
        are raised to that floor (pipeline liveness).
      io_threads: background reader threads for prefetch mode — *per
        device* when the store is striped (models per-device queue depth).
      io_devices: number of backing files ("SSDs") the bucketed store is
        striped over; >1 selects ``StripedBucketedVectorStore`` and gives
        the prefetcher one submission queue per device.
      io_stripe_by: "phase" assigns buckets to devices round-robin in disk
        layout (≈ schedule) order — consecutive misses fan out across all
        devices; "hash" assigns bucket id mod devices.
      io_batch_reads: submit adjacent schedule misses that land on the
        same device as one batched request (io_uring-style submission).
      io_coalesce: merge batched reads of disk-contiguous buckets into a
        single sequential read, split into slabs on completion (implies
        batching; also makes the writer lay buckets out in schedule order
        so schedule-adjacent ⇒ disk-adjacent).
      emulate_read_latency_s: per-bucket-read sleep applied to the
        bucketed store — restores the paper's SSD-latency-bound regime on
        page-cached memmaps (benchmarks only; 0 disables).
      io_retries: transient read errors (OSError/IOError) tolerated per
        bucket read before the join aborts — each failed attempt is
        retried after a capped exponential backoff. 0 restores the old
        fail-fast behavior. Counted in ``PipelineStats.io_retries`` /
        ``io_read_errors``.
      io_retry_backoff_s: base backoff before the first retry; doubles
        per attempt, capped at 50× the base.
      compute_mode: "host" stages each verify batch from host slabs and
        extracts pairs from a fetched boolean mask; "device" mirrors the
        cache schedule on the accelerator (``repro_torch.compute``): every
        bucket slab is transferred ONCE per cache residency into a device
        slab pool, dispatch is double-buffered, and the kernel returns
        compacted (row, col, distance) triples. Result pairs/distances
        are byte-identical between the modes.
      verify_batch: edges per batched verify-kernel dispatch (>= 1).
        Larger batches amortize dispatch overhead; smaller ones bound the
        slab pins a pending batch holds.
      emulate_xfer_gb_s: emulated host↔device link bandwidth (GB/s)
        charged against the verify engines' transfer volumes — restores
        the accelerator-attached regime (where staging bytes cost wall
        time) on hosts whose "device" is the same memory, exactly as
        ``emulate_read_latency_s`` restores the SSD regime on page-cached
        memmaps (benchmarks only; 0 disables).
      plan_mode: "off" keeps every sizing knob hand-tuned (legacy);
        "on" derives them from ``repro.plan`` — per-join ``pair_cap``
        and per-region ``verify_batch`` from the cardinality estimate,
        host/device verify routing from the cost model (enables
        ``compute_mode="auto"``), pool split from predicted reuse. The
        planner only sizes and places work: result pairs/distances are
        byte-identical between "off" and "on".
    """

    epsilon: float
    recall_target: float = 0.9
    memory_budget_bytes: int = 64 * 1024 * 1024
    num_buckets: Optional[int] = None
    bucket_capacity: Optional[int] = None
    eviction_policy: str = "belady"
    reorder: bool = True
    order_strategy: str = "gorder"
    prune: bool = True
    max_candidates: int = 64
    use_pallas: bool = False
    block_rows: int = 8192
    max_bucket_rows: Optional[int] = None
    pad_align: int = 128
    seed: int = 0
    io_mode: str = "sync"
    io_lookahead: int = 8
    io_pool_slabs: Optional[int] = None
    io_threads: int = 2
    io_devices: int = 1
    io_stripe_by: str = "phase"
    io_batch_reads: bool = False
    io_coalesce: bool = False
    emulate_read_latency_s: float = 0.0
    io_retries: int = 2
    io_retry_backoff_s: float = 0.005
    compute_mode: str = "host"
    verify_batch: int = 32
    emulate_xfer_gb_s: float = 0.0
    plan_mode: str = "off"

    def __post_init__(self):
        if self.io_mode not in ("sync", "prefetch"):
            raise ValueError(f"io_mode must be 'sync' or 'prefetch', "
                             f"got {self.io_mode!r}")
        if self.io_devices < 1:
            raise ValueError(f"io_devices must be >= 1, got {self.io_devices}")
        if self.io_stripe_by not in ("phase", "hash"):
            raise ValueError(f"io_stripe_by must be 'phase' or 'hash', "
                             f"got {self.io_stripe_by!r}")
        if self.io_retries < 0:
            raise ValueError(f"io_retries must be >= 0, got {self.io_retries}")
        _validate_compute(self.compute_mode, self.verify_batch,
                          self.plan_mode)

    def resolve_num_buckets(self, num_vectors: int) -> int:
        return _resolve_num_buckets(self.num_buckets, num_vectors)


# ---------------------------------------------------------------------------
# build-time / query-time split (session API)
# ---------------------------------------------------------------------------
BUILD_TIME_FIELDS = frozenset({
    "num_buckets", "bucket_capacity", "block_rows", "max_bucket_rows",
    "pad_align", "seed", "io_devices", "io_stripe_by", "io_coalesce",
})
"""Parameters baked into the on-disk index (bucketization + layout +
striping). ``io_coalesce`` is build-time because coalescing relies on the
writer laying extents in schedule order and on chunked phase striping."""

QUERY_TIME_FIELDS = frozenset(
    f.name for f in dataclasses.fields(JoinConfig)) - BUILD_TIME_FIELDS
"""Parameters a single join/query may vary against one build."""


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Build-time parameters: everything that shapes the on-disk index.

    Changing any of these requires ``DiskJoinIndex.build`` to rewrite the
    bucketed store; the session API rejects them as per-query overrides.
    Field semantics match the identically-named ``JoinConfig`` attributes.
    """

    num_buckets: Optional[int] = None
    bucket_capacity: Optional[int] = None
    block_rows: int = 8192
    max_bucket_rows: Optional[int] = None
    pad_align: int = 128
    seed: int = 0
    io_devices: int = 1
    io_stripe_by: str = "phase"
    io_coalesce: bool = False

    def __post_init__(self):
        if self.io_devices < 1:
            raise ValueError(f"io_devices must be >= 1, got {self.io_devices}")
        if self.io_stripe_by not in ("phase", "hash"):
            raise ValueError(f"io_stripe_by must be 'phase' or 'hash', "
                             f"got {self.io_stripe_by!r}")

    def resolve_num_buckets(self, num_vectors: int) -> int:
        return _resolve_num_buckets(self.num_buckets, num_vectors)


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Query-time parameters: everything a call may vary against one build.

    Field semantics match the identically-named ``JoinConfig`` attributes.
    """

    epsilon: float
    recall_target: float = 0.9
    memory_budget_bytes: int = 64 * 1024 * 1024
    eviction_policy: str = "belady"
    reorder: bool = True
    order_strategy: str = "gorder"
    prune: bool = True
    max_candidates: int = 64
    use_pallas: bool = False
    io_mode: str = "sync"
    io_lookahead: int = 8
    io_pool_slabs: Optional[int] = None
    io_threads: int = 2
    io_batch_reads: bool = False
    emulate_read_latency_s: float = 0.0
    io_retries: int = 2
    io_retry_backoff_s: float = 0.005
    compute_mode: str = "host"
    verify_batch: int = 32
    emulate_xfer_gb_s: float = 0.0
    plan_mode: str = "off"

    def __post_init__(self):
        if self.io_mode not in ("sync", "prefetch"):
            raise ValueError(f"io_mode must be 'sync' or 'prefetch', "
                             f"got {self.io_mode!r}")
        if self.io_retries < 0:
            raise ValueError(f"io_retries must be >= 0, got {self.io_retries}")
        _validate_compute(self.compute_mode, self.verify_batch,
                          self.plan_mode)


def split_config(config: JoinConfig) -> tuple[BuildConfig, QueryConfig]:
    """Partition a flat ``JoinConfig`` into its (build, query) halves."""
    d = dataclasses.asdict(config)
    return (BuildConfig(**{k: d[k] for k in BUILD_TIME_FIELDS}),
            QueryConfig(**{k: d[k] for k in QUERY_TIME_FIELDS}))


def merge_config(build: BuildConfig, query: QueryConfig) -> JoinConfig:
    """Recombine the two halves into the flat config the engine consumes."""
    return JoinConfig(**dataclasses.asdict(build),
                      **dataclasses.asdict(query))


@dataclasses.dataclass
class BucketMeta:
    """Per-bucket metadata kept in memory (centers + radii + sizes)."""

    centers: np.ndarray    # (B, d) float32
    radii: np.ndarray      # (B,) float32 — max dist from member to center
    sizes: np.ndarray      # (B,) int64

    @property
    def num_buckets(self) -> int:
        return self.centers.shape[0]


@dataclasses.dataclass
class BucketGraph:
    """Directed bucket dependency graph, edges (i, j) with i < j (paper §3)."""

    num_nodes: int
    edges: np.ndarray            # (E, 2) int64, i < j
    self_edges_implicit: bool = True  # every bucket checks itself

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    def adjacency(self) -> list[list[int]]:
        """Undirected adjacency (orchestration treats G as undirected)."""
        adj: list[list[int]] = [[] for _ in range(self.num_nodes)]
        for i, j in self.edges:
            adj[int(i)].append(int(j))
            adj[int(j)].append(int(i))
        return adj

    def out_neighbors(self) -> list[list[int]]:
        adj: list[list[int]] = [[] for _ in range(self.num_nodes)]
        for i, j in self.edges:
            adj[int(i)].append(int(j))
        return adj


TIMING_KEYS = ("bucketing", "graph", "orchestration", "execute",
               "io_wait", "compute")
"""The documented ``JoinResult.timings`` schema, identical for every join
kind (self, cross, index session). Detail sub-phases appear under
``"<phase>/<sub>"`` keys (e.g. ``bucketing/assign``,
``orchestration/layout_plan``); consumers should treat unknown sub-keys as
additive detail of their parent phase."""


def finalize_timings(exec_timings: dict, graph_s: float,
                     bucketing_s: float = 0.0,
                     bucketing_sub: dict | None = None) -> dict:
    """Shape raw executor timings into the one documented schema.

    ``exec_timings`` is the executor's ``{plan, execute, io_wait, compute}``;
    ``graph_s`` the bucket-graph build time; ``bucketing_s`` the bucketize
    wall time (0 for index-session joins, where bucketization is amortized
    across calls) with ``bucketing_sub`` its per-scan detail. A
    ``layout_plan`` entry in the detail is re-attributed to orchestration —
    the disk-layout pass runs graph build + ordering that the executor then
    reuses, so phase fractions stay comparable across configurations.
    """
    sub = dict(bucketing_sub or {})
    layout_s = sub.pop("layout_plan", 0.0)
    out = dict(exec_timings)
    out["bucketing"] = bucketing_s - layout_s
    for k, v in sub.items():
        out[f"bucketing/{k}"] = v
    out["graph"] = graph_s
    out["orchestration"] = out.pop("plan") + graph_s + layout_s
    if layout_s:
        out["orchestration/layout_plan"] = layout_s
    return out


@dataclasses.dataclass
class JoinResult:
    """Join output + execution telemetry.

    ``timings`` follows the ``TIMING_KEYS`` schema for every join kind
    (self-join, cross-join and the ``DiskJoinIndex`` session calls emit the
    same top-level key set)."""

    pairs: np.ndarray                 # (P, 2) int64 original vector ids, a<b
    distances: np.ndarray             # (P,) float32
    num_distance_computations: int
    num_candidate_pairs: int
    cache_hits: int
    cache_misses: int
    bucket_loads: int
    io_stats: dict
    timings: dict                     # phase -> seconds (TIMING_KEYS schema)
    plan: object = None               # repro.plan.JoinPlan when plan_mode on

    @property
    def cache_hit_rate(self) -> float:
        tot = self.cache_hits + self.cache_misses
        return self.cache_hits / tot if tot else 0.0


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_bucket_capacity(config: JoinConfig, sizes: np.ndarray) -> int:
    """Padded rows per bucket slab (fixed kernel shape), from the layout
    plan. One definition shared by the executor, the distributed join and
    bucketize's disk-layout planner, so they can never disagree."""
    max_size = int(np.max(sizes)) if len(sizes) else 1
    cap = config.bucket_capacity or round_up(max(max_size, 8),
                                             config.pad_align)
    if cap < max_size:
        raise ValueError(f"bucket_capacity {cap} < max bucket {max_size}")
    return cap


def resolve_cache_buckets(config: JoinConfig, capacity_rows: int,
                          dim: int) -> int:
    """Resident bucket slots under the memory budget (≥ 2 for edge pins)."""
    padded_bytes = capacity_rows * dim * 4
    return max(2, int(config.memory_budget_bytes // padded_bytes))


def dedup_pairs(raw: np.ndarray, dists: np.ndarray | None = None
                ) -> tuple[np.ndarray, np.ndarray | None]:
    """Canonicalize (lo, hi), drop self-pairs, deduplicate — id-range safe.

    The fast path packs each pair as ``(lo << 32) | hi``; large ids
    (reachable via cross-join id offsetting at billion scale) break the
    packing — ids ≥ 2^32 collide outright, and ids ≥ 2^31 overflow the
    int64 sign bit under the shift, so the arithmetic unshift returns
    negative ids. Both ranges fall back to a lexicographic ``np.unique``
    over rows. Returns (pairs, dists-at-first-occurrence) with dists None
    iff not supplied.
    """
    if raw.size == 0:
        return (np.zeros((0, 2), np.int64),
                np.zeros(0, np.float32) if dists is not None else None)
    raw = np.asarray(raw, dtype=np.int64)
    lo = np.minimum(raw[:, 0], raw[:, 1])
    hi = np.maximum(raw[:, 0], raw[:, 1])
    if int(lo.min()) >= 0 and int(hi.max()) < (1 << 31):
        keys = (lo << 32) | hi
        uniq, first_idx = np.unique(keys, return_index=True)
        pairs = np.stack([uniq >> 32, uniq & 0xFFFFFFFF], axis=1)
    else:
        stacked = np.stack([lo, hi], axis=1)
        pairs, first_idx = np.unique(stacked, axis=0, return_index=True)
    keep = pairs[:, 0] != pairs[:, 1]
    out_d = dists[first_idx][keep] if dists is not None else None
    return pairs[keep], out_d


def canonicalize_pairs(pairs: np.ndarray) -> np.ndarray:
    """Sort each pair (a<b), drop self-pairs and duplicates."""
    if pairs.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    keep = lo != hi
    stacked = np.stack([lo[keep], hi[keep]], axis=1)
    return np.unique(stacked, axis=0)


def recall(result_pairs: np.ndarray, truth_pairs: np.ndarray) -> float:
    """Standard recall |R ∩ R'| / |R| over canonicalized pair sets."""
    truth = canonicalize_pairs(truth_pairs)
    if truth.shape[0] == 0:
        return 1.0
    got = canonicalize_pairs(result_pairs)
    truth_keys = truth[:, 0].astype(np.int64) << 32 | truth[:, 1].astype(np.int64)
    got_keys = got[:, 0].astype(np.int64) << 32 | got[:, 1].astype(np.int64)
    inter = np.intersect1d(truth_keys, got_keys, assume_unique=True)
    return inter.size / truth_keys.size
