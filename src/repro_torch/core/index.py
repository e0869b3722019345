"""Build-once / query-many DiskJoin session API.

    index = DiskJoinIndex.build(store, config, workdir)   # bucketize ONCE
    r1 = index.self_join(epsilon=0.2)     # graph/schedule only
    r2 = index.self_join(epsilon=0.3)     # reuses bucketing
    ids, dists = index.query(q, epsilon=0.25)   # online point lookup
    ...
    index = DiskJoinIndex.open(workdir)   # reattach later, no rescan

``build`` writes a manifest (build config, layout order, store kind) next
to the bucketed store, so ``open`` reattaches without touching the flat
dataset. The manifest and the bucket store are the JAX package's format
(``diskjoin-index/v1``) byte for byte, so an index built by either package
opens in the other. The instance owns, for its lifetime, the bucketed
store, ONE ``BufferPool`` and ONE ``PipelineStats``: batch joins and point
queries share one telemetry surface, and queries keep recently read
buckets warm in pool slabs.

The online path is split into a plan phase (``plan_probes`` — candidate
buckets from in-memory metadata, no I/O) and an execute phase
(``execute_probes`` — one read per distinct bucket, fanned out to every
member query's verify), so a wave scheduler
(``repro_torch.serve.QueryScheduler``) can union many concurrent
requests' probe sets and pay each hot bucket's read once.

Port of the JAX package's ``core/index.py``. Every session has a
``torch.device``: ``build``/``open`` take ``device=None`` (CUDA) and raise
without CUDA unless given ``device="cpu"``; ``reopen`` keeps the session's
device. Everything the JAX package's session does runs here: striped
stores (``io_devices > 1``), ``io_mode="prefetch"`` for joins and query
waves, the planner (``plan_mode="on"``, ``compute_mode="auto"``) with the
build-time cardinality sketch, cross-joins, resumable builds
(``ft.PhaseLog``), the metrics registry, live observability
(``attach_live``) and residency snapshots (``open(warm_start=True)``,
``residency.json`` in the JAX package's format).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
import warnings
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.compute import next_pow2, query_verify_compact
from repro_torch.core import ordering
from repro_torch.core.bipartite import bipartite_join
from repro_torch.core.bucket_graph import build_bucket_graph
from repro_torch.core.bucketize import bucketize
from repro_torch.core.center_index import make_center_index
from repro_torch.core.executor import PAD_COORD, JoinExecutor
from repro_torch.core.pruning import prune_candidates
from repro_torch.core.types import (BUILD_TIME_FIELDS, QUERY_TIME_FIELDS,
                                    BucketMeta, BuildConfig, JoinConfig,
                                    JoinResult, QueryConfig,
                                    finalize_timings, merge_config,
                                    resolve_bucket_capacity,
                                    resolve_cache_buckets, split_config)
from repro_torch.device import resolve_device, to_device
from repro_torch.ft.atomic import AsyncCommitter, atomic_write_json
from repro_torch.io import BufferPool, PipelineStats, SchedulePrefetcher
from repro_torch.io.retry import read_with_retry
from repro_torch.obs import MetricsRegistry, enable_tracing, get_tracer
from repro_torch.obs.live import LiveObserver, default_serving_slos
from repro_torch.plan import (SKETCH_FILE, CardinalityEstimator, CostModel,
                              Planner)
from repro_torch.store.striped_store import StripedBucketedVectorStore
from repro_torch.store.vector_store import BucketedVectorStore, FlatVectorStore

MANIFEST_NAME = "diskjoin_index.json"
MANIFEST_FORMAT = "diskjoin-index/v1"
# serving fast-restart snapshot: which buckets were warm at close()
RESIDENCY_NAME = "residency.json"
# pool slabs the query warm cache always leaves free (liveness headroom
# for the queries' own transient reads)
_WARM_RESERVE = 2


class DiskJoinIndex:
    """Persistent session over one bucketized dataset. Use ``build``/``open``."""

    def __init__(self, workdir: str, store, meta: BucketMeta,
                 build_config: BuildConfig,
                 query_defaults: QueryConfig | None, *,
                 device: torch.device,
                 build_timings: dict | None = None,
                 build_seconds: float = 0.0):
        self.workdir = workdir
        self.store = store
        self.meta = meta
        self.build_config = build_config
        self.query_defaults = query_defaults
        self.device = device
        self.build_timings = dict(build_timings or {})
        self.build_seconds = float(build_seconds)
        self.stats = PipelineStats()        # ONE lifetime telemetry surface
        # session tracer: None → resolve the current (module-level) tracer
        # at call time, so `with trace_session():` records without
        # re-plumbing; set to a Tracer to pin one
        self.tracer = None
        self.metrics = MetricsRegistry()
        self.metrics.register_provider("pipeline", self.stats.snapshot)
        self.metrics.register_provider("io",
                                       lambda: self.store.stats.snapshot())
        # span drops must be visible without holding the tracer object
        self.metrics.register_provider("tracer", self._tracer_section)
        self.bucket_capacity = resolve_bucket_capacity(build_config,
                                                       meta.sizes)
        self._pool: BufferPool | None = None
        self._pool_lock = threading.Lock()
        self._center_index = None
        self._center_lock = threading.Lock()
        self._graph_cache: dict = {}
        self._order_cache: dict = {}
        # warm point-query cache: bucket -> (pool slot, rows); each entry
        # holds one pool reference
        self._warm: OrderedDict[int, tuple[int, int]] = OrderedDict()
        self._warm_lock = threading.RLock()
        self._joins_active = 0
        # cost-based planning (repro_torch.plan): the sketch-backed
        # estimator is session-lazy; _warm_quota is the PoolPlan's serving
        # share of the slab budget (None = all but the reserve)
        self._estimator: CardinalityEstimator | None = None
        self._estimator_lock = threading.Lock()
        self._sketch_path = os.path.join(workdir, SKETCH_FILE)
        self._warm_quota: int | None = None
        # live observability (repro_torch.obs.live): rollups + SLO monitors
        # + cost recalibration, attached on demand via attach_live()
        self._live: LiveObserver | None = None
        self._live_key: str | None = None
        # periodic residency snapshots: an async writer thread persists
        # residency.json on an interval so a crash mid-serve still
        # restarts warm; never blocks the serve path
        self._residency_committer: AsyncCommitter | None = None
        self._residency_interval = 0.0
        self._residency_next = float("inf")
        self._closed = False

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(cls, store: FlatVectorStore,
              config: JoinConfig | BuildConfig,
              workdir: str | None = None, *,
              layout: str = "auto", resumable: bool = True,
              device=None) -> "DiskJoinIndex":
        """Bucketize + lay out ``store`` once under ``workdir`` and return
        the attached session. ``config`` may be a flat ``JoinConfig`` (its
        query-time half becomes the session's per-call defaults) or a bare
        ``BuildConfig`` (then every query call must pass ``epsilon``).

        ``layout`` chooses the disk extent order used when coalescing or
        striping is on: ``"auto"`` plans the join schedule order for the
        config's default parameters (schedule-adjacent ⇒ disk-adjacent);
        ``"spatial"`` uses the ε-free nearest-neighbor center tour (the
        right choice for an index that mostly serves cross-joins).
        Without coalescing or striping no reordering is needed. The build
        also samples the planner's cardinality sketch from the flat store
        and persists it next to the manifest.

        ``resumable`` (default on) commits per-phase markers under
        ``<workdir>/build_phases`` (``repro_torch.ft.PhaseLog``, the JAX
        package's layout): a build killed mid-way restarts at the last
        finished phase — sample, assign, sketch and layout outputs are
        loaded instead of rescanning the flat store (only the final write
        scan re-runs). A config change invalidates the markers
        (fingerprinted); the log is removed once the manifest commits.

        ``device``: ``None`` (CUDA) or ``"cpu"``; raises without CUDA
        unless ``"cpu"`` is asked for. The assign scan runs on it.
        """
        dev = resolve_device(device)
        if isinstance(config, BuildConfig):
            build_cfg, query_defaults = config, None
        else:
            build_cfg, query_defaults = split_config(config)
        if layout not in ("auto", "spatial"):
            raise ValueError(f"layout must be 'auto' or 'spatial', "
                             f"got {layout!r}")
        workdir = workdir or tempfile.mkdtemp(prefix="diskjoin_index_")
        os.makedirs(workdir, exist_ok=True)
        flog = None
        if resumable:
            from repro_torch.ft.phases import PhaseLog, build_fingerprint
            flog = PhaseLog(
                os.path.join(workdir, "build_phases"),
                build_fingerprint(dataclasses.asdict(build_cfg),
                                  (store.num_vectors, store.dim), layout))

        # disk-layout planning (only when coalescing/striping can use it):
        # the write scan needs the extent order *before* it lays them out
        plan_cache: dict = {}
        layout_fn = None
        if build_cfg.io_coalesce or build_cfg.io_devices > 1:
            if layout == "auto" and query_defaults is not None:
                flat = merge_config(build_cfg, query_defaults)

                def layout_fn(meta):
                    if flog is not None and flog.has("layout"):
                        order = flog.load_arrays("layout")["order"]
                        plan_cache.update(
                            order=order,
                            kind=flog.load_meta("layout").get("kind"))
                        return order
                    graph = build_bucket_graph(meta, flat, device=dev)
                    cap = resolve_bucket_capacity(flat, meta.sizes)
                    cache_buckets = resolve_cache_buckets(flat, cap,
                                                          store.dim)
                    order = ordering.compute_node_order(graph, meta, flat,
                                                        cache_buckets)
                    plan_cache.update(graph=graph, order=order,
                                      cache_buckets=cache_buckets,
                                      kind="schedule")
                    if flog is not None:
                        flog.commit_arrays("layout",
                                           extra={"kind": "schedule"},
                                           order=order)
                    return order
            else:
                def layout_fn(meta):
                    if flog is not None and flog.has("layout"):
                        order = flog.load_arrays("layout")["order"]
                        plan_cache.update(order=order, kind="spatial")
                        return order
                    order = ordering.spatial_order(meta.centers)
                    plan_cache.update(order=order, kind="spatial")
                    if flog is not None:
                        flog.commit_arrays("layout",
                                           extra={"kind": "spatial"},
                                           order=order)
                    return order

        # planner cardinality sketch: sampled from the FLAT store during
        # bucketization (one gather, no bucketed-store reads), persisted
        # next to the manifest so reattached sessions load it for free
        sketch_box: dict = {}

        def sketch_sink(assignment, num_buckets):
            if flog is not None and flog.has("sketch"):
                sketch_box["est"] = CardinalityEstimator.load(
                    os.path.join(flog.path("sketch"), "sketch.npz"))
                return
            est = CardinalityEstimator.sample_flat(
                store, assignment, num_buckets, seed=build_cfg.seed)
            sketch_box["est"] = est
            if flog is not None:
                flog.commit("sketch", lambda tmp: est.save(
                    os.path.join(tmp, "sketch.npz")))

        t0 = time.perf_counter()
        bstore, meta, bt = bucketize(store, os.path.join(workdir, "buckets"),
                                     config, device=dev,
                                     layout_order_fn=layout_fn,
                                     sketch_sink=sketch_sink,
                                     phase_log=flog)
        build_seconds = time.perf_counter() - t0

        index = cls(workdir, bstore, meta, build_cfg, query_defaults,
                    device=dev, build_timings=bt,
                    build_seconds=build_seconds)
        est = sketch_box["est"]
        est.save(index._sketch_path)
        index._estimator = est
        if "graph" in plan_cache and query_defaults is not None:
            # the layout pass already planned the default-config join;
            # seed the session caches so the first self_join reuses it
            # (a resumed layout phase loads only the order — the caches
            # then repopulate lazily)
            flat = merge_config(build_cfg, query_defaults)
            gkey = index._graph_key(flat)
            index._graph_cache[gkey] = plan_cache["graph"]
            index._order_cache[(gkey, flat.order_strategy, flat.reorder,
                                plan_cache["cache_buckets"])] = \
                plan_cache["order"]
        index._write_manifest(plan_cache.get("order"), plan_cache.get("kind"))
        if flog is not None:
            flog.clear()  # manifest committed: the build is done
        return index

    @classmethod
    def open(cls, workdir: str,
             config: JoinConfig | QueryConfig | None = None, *,
             warm_start: bool = False, device=None) -> "DiskJoinIndex":
        """Reattach to an index built earlier in ``workdir`` (by either
        package) — no dataset rescan.

        ``config`` optionally replaces the session's query-time defaults.
        Passing a flat ``JoinConfig`` validates its build-time half against
        the manifest (mismatch raises — the on-disk layout cannot be
        changed by opening it differently).

        ``warm_start=True`` replays the residency snapshot the previous
        session persisted on ``close()`` (by either package: the file is
        the JAX package's ``diskjoin-residency/v1``): the buckets that were
        warm then are pre-faulted into pool slabs now (bounded by the warm
        quota), so the first post-restart query wave hits instead of
        paying cold reads. A missing or stale snapshot degrades to a cold
        open."""
        dev = resolve_device(device)
        path = os.path.join(workdir, MANIFEST_NAME)
        with open(path) as f:
            m = json.load(f)
        if m.get("format") != MANIFEST_FORMAT:
            raise ValueError(f"{path}: not a {MANIFEST_FORMAT} manifest")
        build_cfg = BuildConfig(**m["build"])
        manifest_defaults = (QueryConfig(**m["query_defaults"])
                             if m.get("query_defaults") else None)
        query_defaults = manifest_defaults
        if isinstance(config, JoinConfig):
            got_build, query_defaults = split_config(config)
            if got_build != build_cfg:
                diff = [f.name for f in dataclasses.fields(BuildConfig)
                        if getattr(got_build, f.name)
                        != getattr(build_cfg, f.name)]
                raise ValueError(
                    f"build-time parameters {diff} differ from the on-disk "
                    f"index at {workdir}; rebuild with DiskJoinIndex.build "
                    f"to change them")
        elif isinstance(config, QueryConfig):
            query_defaults = config
        elif config is not None:
            raise TypeError("config must be JoinConfig, QueryConfig or None")
        store_path = os.path.join(workdir, m["store"])
        store = (StripedBucketedVectorStore(store_path) if m["striped"]
                 else BucketedVectorStore(store_path))
        if query_defaults is not None:
            store.read_latency_s = query_defaults.emulate_read_latency_s
        meta = BucketMeta(centers=store.centers, radii=store.radii,
                          sizes=np.asarray(store.bucket_sizes))
        index = cls(workdir, store, meta, build_cfg, query_defaults,
                    device=dev, build_timings=m.get("build_timings"),
                    build_seconds=m.get("build_seconds", 0.0))
        if (m.get("layout_kind") == "schedule"
                and m.get("layout_order") is not None
                and manifest_defaults is not None):
            # the persisted layout IS the schedule order planned for the
            # MANIFEST's defaults — seed the order cache under that key
            flat = merge_config(build_cfg, manifest_defaults)
            gkey = index._graph_key(flat)
            cache_buckets = resolve_cache_buckets(flat,
                                                  index.bucket_capacity,
                                                  store.dim)
            index._order_cache[(gkey, flat.order_strategy, flat.reorder,
                                cache_buckets)] = \
                np.asarray(m["layout_order"], dtype=np.int64)
        if warm_start:
            index._warm_start()
        return index

    def reopen(self, *, warm_start: bool = True) -> "DiskJoinIndex":
        """A fresh session over the same on-disk index — the supervised
        restart path (``serve.replica.ReplicaSupervisor``): re-``open``
        this session's ``workdir`` with its query-time defaults on its
        ``device``, pre-faulting the residency snapshot by default. The
        dead session is untouched (close it separately; it may be
        wedged)."""
        return DiskJoinIndex.open(self.workdir, self.query_defaults,
                                  warm_start=warm_start, device=self.device)

    def _write_manifest(self, layout_order, layout_kind) -> None:
        manifest = {
            "format": MANIFEST_FORMAT,
            "store": "buckets",
            "striped": self.store.__class__ is StripedBucketedVectorStore,
            "dim": int(self.store.dim),
            "num_buckets": int(self.meta.num_buckets),
            "num_vectors": int(self.meta.sizes.sum()),
            "build": dataclasses.asdict(self.build_config),
            "query_defaults": (dataclasses.asdict(self.query_defaults)
                               if self.query_defaults is not None else None),
            "layout_kind": layout_kind,
            "layout_order": (np.asarray(layout_order).tolist()
                             if layout_order is not None else None),
            "build_seconds": self.build_seconds,
            "build_timings": self.build_timings,
            # additive (format stays v1): pre-sketch manifests simply
            # lack the key and get a lazy rebuild on first planner use
            "sketch": (self._sketch_manifest_entry()
                       if self._estimator is not None else None),
        }
        atomic_write_json(os.path.join(self.workdir, MANIFEST_NAME),
                          manifest)

    def _sketch_manifest_entry(self) -> dict:
        return {"file": SKETCH_FILE,
                "sample_rows": int(self._estimator.sample_rows),
                "seed": int(self._estimator.seed)}

    def _note_sketch_in_manifest(self) -> None:
        """Record a lazily-rebuilt sketch in the manifest (read-modify-
        write of the JSON only — nothing else changes)."""
        path = os.path.join(self.workdir, MANIFEST_NAME)
        try:
            with open(path) as f:
                m = json.load(f)
            m["sketch"] = self._sketch_manifest_entry()
            with open(path, "w") as f:
                json.dump(m, f)
        except OSError:
            pass  # read-only workdir: the in-memory sketch still serves

    # -- shape ---------------------------------------------------------------
    @property
    def num_vectors(self) -> int:
        return int(self.meta.sizes.sum())

    @property
    def num_buckets(self) -> int:
        return self.meta.num_buckets

    @property
    def dim(self) -> int:
        return self.store.dim

    def _tracer(self):
        return self.tracer if self.tracer is not None else get_tracer()

    def _tracer_section(self) -> dict:
        """``metrics_snapshot()["tracer"]``: whether tracing is on, how
        many events each thread's ring holds, and — crucially — how many
        were silently dropped to ring wrap-around."""
        tr = self._tracer()
        if not tr.enabled:
            return {"enabled": False}
        out = {"enabled": True}
        out.update(tr.ring_stats())
        return out

    # -- live observability (repro_torch.obs.live) ---------------------------
    @property
    def live(self) -> "LiveObserver | None":
        """The attached live observer, or None (``repro_torch.obs.dash``
        reads this)."""
        return self._live

    def attach_live(self, *, window_s: float = 1.0, windows: int = 60,
                    slos=None, calibrate: bool = True, on_alert=None,
                    tracer=None, residency_interval_s: float | None = None,
                    **observer_kw) -> "LiveObserver":
        """Attach continuous observability to this session: streaming
        rollups of every span/instant/counter the session records, SLO
        burn-rate monitors over them, and live cost-model recalibration
        feeding ``_planner_for``.

        Uses the session tracer; when no tracer is recording, the
        module-level tracer is enabled (and disabled again on
        ``detach_live``/``close`` if still ours). ``slos=None`` watches
        ``default_serving_slos()``; pass ``slos=()`` for rollups only.
        ``residency_interval_s`` additionally turns on periodic in-run
        residency snapshots (``enable_residency_snapshots``)."""
        if self._live is not None:
            raise RuntimeError("live observability is already attached; "
                               "detach_live() first")
        tr = tracer if tracer is not None else self._tracer()
        owns = False
        if not tr.enabled:
            tr = enable_tracing()
            owns = True
        self.tracer = tr  # pin: session spans keep landing in this tracer
        obs = LiveObserver(
            tr, window_s=window_s, windows=windows,
            slos=default_serving_slos() if slos is None else slos,
            pipeline_source=self.stats.snapshot, metrics=self.metrics,
            on_alert=on_alert, calibrate=calibrate, owns_tracing=owns,
            **observer_kw)
        self._live = obs
        self._live_key = self.metrics.register_provider("live",
                                                        obs.section)
        if residency_interval_s is not None:
            self.enable_residency_snapshots(residency_interval_s)
        return obs

    def detach_live(self) -> None:
        """Remove the live observer (sink, provider, owned tracing)."""
        obs, self._live = self._live, None
        if obs is None:
            return
        if self._live_key is not None:
            self.metrics.unregister_provider(self._live_key)
            self._live_key = None
        if self.tracer is obs.tracer and obs.owns_tracing:
            self.tracer = None
        obs.close()

    # -- cost-based planning ---------------------------------------------------
    @property
    def estimator(self) -> CardinalityEstimator:
        """The session's cardinality estimator (``repro_torch.plan``),
        backed by the persisted per-bucket sketch. An index without one
        gets a one-time lazy rebuild from the bucketed store (with a
        warning), re-persisted so the cost is paid once per index."""
        with self._estimator_lock:
            if self._estimator is None:
                if os.path.exists(self._sketch_path):
                    self._estimator = CardinalityEstimator.load(
                        self._sketch_path)
                else:
                    warnings.warn(
                        f"index at {self.workdir} predates planner "
                        f"sketches; rebuilding the cardinality sketch "
                        f"from the bucketed store (one-time, "
                        f"{self.meta.num_buckets} bucket reads)",
                        stacklevel=2)
                    self._estimator = CardinalityEstimator.sample_bucketed(
                        self.store, self.meta.sizes,
                        seed=self.build_config.seed)
                    try:
                        self._estimator.save(self._sketch_path)
                    except OSError:
                        pass  # read-only workdir
                    else:
                        self._note_sketch_in_manifest()
            return self._estimator

    def _planner_for(self, cfg: JoinConfig) -> Planner:
        """A planner bound to this session's estimator and a cost model
        calibrated from the session's telemetry, this call's emulation
        knobs and the session device's static constants. Cheap to build
        per call — the emulated link/latency may differ between calls.

        With ``attach_live()`` active, the observer's rolling
        span-derived constants join the calibration as the ``live``
        provenance tier (measured > live > config > static, the static
        tier being the session device's: the card's ``_CUDA_STATIC`` on
        CUDA): long runs' wave plans re-price from what the hardware is
        doing *now* — the link especially, which no cumulative counter
        measures."""
        live = self._live.live_constants() if self._live is not None \
            else None
        cost = CostModel.from_telemetry(cfg, self.stats.snapshot(),
                                        live=live, device=self.device)
        return Planner(self.estimator, cost, tracer=self._tracer(),
                       metrics=self.metrics, pstats=self.stats)

    # -- config resolution ---------------------------------------------------
    def _resolve(self, overrides: dict) -> JoinConfig:
        """Merge per-call query-time overrides over the session defaults.
        Build-time keys are rejected outright: the on-disk layout cannot
        be changed by a query, only by a rebuild."""
        bad = sorted(set(overrides) & BUILD_TIME_FIELDS)
        if bad:
            raise ValueError(
                f"build-time parameter(s) {bad} are fixed by the on-disk "
                f"index; rebuild with DiskJoinIndex.build to change them")
        unknown = sorted(set(overrides) - QUERY_TIME_FIELDS)
        if unknown:
            raise TypeError(f"unknown query-time parameter(s) {unknown}")
        if self.query_defaults is None:
            if "epsilon" not in overrides:
                raise ValueError(
                    "epsilon is required: the index was built from a bare "
                    "BuildConfig and has no query-time defaults")
            query = QueryConfig(**overrides)
        else:
            query = dataclasses.replace(self.query_defaults, **overrides)
        cfg = merge_config(self.build_config, query)
        self.store.read_latency_s = cfg.emulate_read_latency_s
        return cfg

    # -- per-ε planning caches ------------------------------------------------
    @staticmethod
    def _graph_key(cfg: JoinConfig):
        return (float(cfg.epsilon), float(cfg.recall_target),
                int(cfg.max_candidates), bool(cfg.prune))

    def _graph_for(self, cfg: JoinConfig):
        """Bucket graph for these query params → (graph, seconds, key).
        Repeat calls at the same (ε, λ, L, prune) reuse the cached graph."""
        key = self._graph_key(cfg)
        graph = self._graph_cache.get(key)
        if graph is not None:
            return graph, 0.0, key
        t0 = time.perf_counter()
        graph = build_bucket_graph(self.meta, cfg, device=self.device)
        graph_s = time.perf_counter() - t0
        self._graph_cache[key] = graph
        return graph, graph_s, key

    def _order_for(self, graph, cfg: JoinConfig, cache_buckets: int, gkey):
        key = (gkey, cfg.order_strategy, cfg.reorder, cache_buckets)
        order = self._order_cache.get(key)
        if order is None:
            order = ordering.compute_node_order(graph, self.meta, cfg,
                                                cache_buckets)
            self._order_cache[key] = order
        return order

    # -- session buffer pool --------------------------------------------------
    def _ensure_pool(self, cfg: JoinConfig) -> BufferPool:
        """The session's one BufferPool: sized for a batch join at these
        query params plus warm-cache headroom; created on first use.

        With ``plan_mode="on"`` (and no explicit ``io_pool_slabs``) the
        split between the join working set and the serving warm cache
        comes from the planner's ``PoolPlan``."""
        with self._pool_lock:
            if self._pool is None:
                cap_buckets = min(
                    resolve_cache_buckets(cfg, self.bucket_capacity,
                                          self.store.dim),
                    self.meta.num_buckets or 1)
                if cfg.plan_mode == "on" and cfg.io_pool_slabs is None:
                    pp = self._planner_for(cfg).plan_pool(
                        cfg, cap_buckets, cfg.io_lookahead,
                        self.stats.snapshot(), floor=_WARM_RESERVE)
                    slabs = max(pp.num_slabs,
                                cap_buckets + 1 + pp.warm_quota)
                    self._warm_quota = pp.warm_quota
                else:
                    slabs = cfg.io_pool_slabs
                    if slabs is None:
                        slabs = cap_buckets + cfg.io_lookahead
                    slabs = max(slabs, cap_buckets + 1) + _WARM_RESERVE
                self._pool = BufferPool(slabs, self.bucket_capacity,
                                        self.store.dim)
            return self._pool

    # -- batch joins ----------------------------------------------------------
    def self_join(self, *, attribute_mask: np.ndarray | None = None,
                  **overrides) -> JoinResult:
        """ε-self-join over the built index. Query-time parameters
        (``epsilon=…``, ``io_mode=…``, ``compute_mode=…``,
        ``memory_budget_bytes=…``, …) are per-call overrides;
        bucketization is never repeated."""
        cfg = self._resolve(overrides)
        graph, graph_s, gkey = self._graph_for(cfg)
        pool = (self._ensure_pool(cfg) if cfg.io_mode == "prefetch"
                else None)
        planner = (self._planner_for(cfg) if cfg.plan_mode == "on"
                   else None)
        executor = JoinExecutor(self.store, self.meta, cfg,
                                device=self.device,
                                attribute_mask=attribute_mask,
                                shared_pool=pool, shared_stats=self.stats,
                                tracer=self._tracer(), planner=planner)
        node_order = self._order_for(graph, cfg, executor.cache_buckets,
                                     gkey)
        self._begin_join()
        try:
            result = executor.run(graph, node_order=node_order)
        finally:
            self._end_join()
        result.timings = finalize_timings(result.timings, graph_s)
        return result

    def cross_join(self, other: "DiskJoinIndex", *,
                   reorder_larger: bool = True,
                   attribute_mask: np.ndarray | None = None,
                   **overrides) -> JoinResult:
        """Bipartite ε-join against another index (paper §3 extension),
        verified on this session's device.

        Result ids: this index's vectors keep their ids in
        ``[0, self.num_vectors)``; ``other``'s are offset by
        ``self.num_vectors``. ``attribute_mask`` is a
        ``(self.num_vectors + other.num_vectors,)`` bool array over that
        combined id space — pairs survive only if both endpoints pass.
        ``reorder_larger=True`` streams the larger side in schedule order
        and caches the smaller (the paper's DiskJoin1); False flips it.
        """
        cfg = self._resolve(overrides)
        n_x, n_y = self.num_vectors, other.num_vectors
        if attribute_mask is not None:
            attribute_mask = np.asarray(attribute_mask, dtype=bool)
            if attribute_mask.shape != (n_x + n_y,):
                raise ValueError(
                    f"attribute_mask must cover the combined id space "
                    f"({n_x + n_y},), got {attribute_mask.shape}")
        big_first = n_x >= n_y
        if not reorder_larger:
            big_first = not big_first
        drive, cached = (self, other) if big_first else (other, self)
        drive_is_x = drive is self
        # session pool as for self_join; the executor falls back to a
        # private pool when the combined bucket capacity doesn't fit it
        pool = (self._ensure_pool(cfg) if cfg.io_mode == "prefetch"
                else self._pool)
        self._begin_join()
        try:
            result, graph_s = bipartite_join(
                drive.store, drive.meta, cached.store, cached.meta, cfg,
                device=self.device,
                drive_id_offset=0 if drive_is_x else n_x,
                cache_id_offset=n_x if drive_is_x else 0,
                attribute_mask=attribute_mask,
                shared_pool=pool, shared_stats=self.stats)
        finally:
            self._end_join()
        result.timings = finalize_timings(result.timings, graph_s)
        return result

    def _begin_join(self) -> None:
        # batch joins take the executor's liveness floor on the shared
        # pool; warm query slabs are dropped so they can never starve it
        with self._warm_lock:
            self._joins_active += 1
            self._drop_warm_locked()

    def _end_join(self) -> None:
        with self._warm_lock:
            self._joins_active -= 1

    # -- online point queries -------------------------------------------------
    def _validate_queries(self, Q: np.ndarray) -> np.ndarray:
        """Contiguous (Q, dim) float32, rejecting wrong widths and
        non-finite values up front."""
        Q = np.ascontiguousarray(np.atleast_2d(np.asarray(Q, np.float32)))
        if Q.ndim != 2 or Q.shape[1] != self.dim:
            raise ValueError(
                f"query shape {Q.shape} incompatible with index "
                f"({self.dim}-dimensional vectors expected)")
        if not np.isfinite(Q).all():
            raise ValueError("query contains NaN/Inf values")
        return Q

    def query(self, q: np.ndarray, epsilon: float | None = None,
              **overrides) -> tuple[np.ndarray, np.ndarray]:
        """ε-range lookup for one query vector → (ids, distances)."""
        out = self.query_batch(np.asarray(q, np.float32)[None, :],
                               epsilon, **overrides)
        return out[0]

    def plan_probes(self, Q: np.ndarray, epsilon: float | None = None,
                    **overrides) -> list[np.ndarray]:
        """Plan phase of ``query_batch``: per-query candidate-bucket ids
        (center index + point triangle inequality + Eq. 3 pruning) — no
        disk reads."""
        if epsilon is not None:
            overrides["epsilon"] = epsilon
        cfg = self._resolve(overrides)
        Q = self._validate_queries(Q)
        with self._tracer().span("query.plan", queries=Q.shape[0]):
            return self._candidate_buckets(Q, cfg)

    def execute_probes(self, Q: np.ndarray, per_q: list[np.ndarray],
                       epsilon: float | None = None, cancel=None,
                       **overrides
                       ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Execute phase of ``query_batch``: each *distinct* bucket in the
        union of ``per_q`` is read once (through the session pool and warm
        cache) and fanned out to every member query's verify. Returns one
        (ids, distances) pair per query, unsorted.

        ``cancel(qi) -> bool``: optional mid-execution cancellation probe
        — a cancelled query's verify fan-out is skipped from then on, and
        a bucket whose probing queries are ALL cancelled is not read
        (``midwave_skipped_reads``)."""
        if epsilon is not None:
            overrides["epsilon"] = epsilon
        cfg = self._resolve(overrides)
        Q = self._validate_queries(Q)
        if len(per_q) != Q.shape[0]:
            raise ValueError(f"probe plan covers {len(per_q)} queries, "
                             f"got {Q.shape[0]} query vectors")
        return self._execute_probes(Q, per_q, cfg, cancel=cancel)

    def query_batch(self, Q: np.ndarray, epsilon: float | None = None,
                    **overrides) -> list[tuple[np.ndarray, np.ndarray]]:
        """ε-range lookups for a batch of query vectors → one (ids,
        distances) pair per query, unsorted, exact distances. Both compute
        modes threshold float32 d² against float32 ε², so they agree on
        membership up to the device kernel's float32 accumulation on
        pairs within a few ulps of ε."""
        if epsilon is not None:
            overrides["epsilon"] = epsilon
        cfg = self._resolve(overrides)
        Q = self._validate_queries(Q)
        per_q = self._candidate_buckets(Q, cfg)
        return self._execute_probes(Q, per_q, cfg)

    def _execute_probes(self, Q: np.ndarray, per_q: list[np.ndarray],
                        cfg: JoinConfig, cancel=None
                        ) -> list[tuple[np.ndarray, np.ndarray]]:
        with self._tracer().span(
                "query.execute", queries=Q.shape[0],
                buckets=len({int(b) for ids in per_q for b in ids})):
            return self._execute_probes_inner(Q, per_q, cfg, cancel=cancel)

    def _execute_probes_inner(self, Q: np.ndarray, per_q: list[np.ndarray],
                              cfg: JoinConfig, cancel=None
                              ) -> list[tuple[np.ndarray, np.ndarray]]:
        eps = float(cfg.epsilon)
        # bucket -> probing query rows; each distinct bucket is read once
        probe: dict[int, list[int]] = {}
        for qi, ids in enumerate(per_q):
            for b in ids:
                probe.setdefault(int(b), []).append(qi)

        # wave plan (plan_mode="on"): k_cap for the device query path
        # from the estimate's upper bound, and the host/device resolution
        # for compute_mode="auto"
        wplan = None
        compute = cfg.compute_mode
        if cfg.plan_mode == "on":
            wplan = self._planner_for(cfg).plan_wave(
                Q, per_q, self.meta, cfg, self.bucket_capacity,
                warm=set(self.warm_buckets()))
            if compute == "auto":
                compute = wplan.compute_mode
        elif compute == "auto":  # unreachable via config validation
            compute = "host"

        # mid-execution cancellation: a query found cancelled stays
        # cancelled (deadlines only ever recede into the past)
        dead: set[int] = set()

        def live_rows(b: int) -> list[int]:
            qis = probe[b]
            if cancel is None:
                return qis
            out = []
            for qi in qis:
                if qi in dead:
                    continue
                if cancel(qi):
                    dead.add(qi)
                    continue
                out.append(qi)
            return out

        acc_ids: list[list[np.ndarray]] = [[] for _ in range(Q.shape[0])]
        acc_d: list[list[np.ndarray]] = [[] for _ in range(Q.shape[0])]
        # both query verify paths round d² to float32 and compare against
        # ε² rounded as the device path rounds it (the f64 product cast
        # ONCE to f32). The host accumulates the a² − 2ab + b² expansion
        # in f64 first: in f32 it cancels catastrophically for near-zero
        # distances, and the host path is the accuracy reference.
        eps2 = np.float32(float(eps) * float(eps))

        def verify(b: int, vecs: np.ndarray, ids_: np.ndarray,
                   n: int) -> None:
            qidx = live_rows(b)
            if not qidx:
                return
            live, lids = vecs[:n], ids_[:n]
            qs = Q[qidx].astype(np.float64)
            lv = live.astype(np.float64)
            d2 = ((qs * qs).sum(1)[:, None] - 2.0 * (qs @ lv.T)
                  + (lv * lv).sum(1)[None, :])
            np.maximum(d2, 0.0, out=d2)
            d2 = d2.astype(np.float32)
            mask = d2 <= eps2
            for row, qi in enumerate(qidx):
                m = mask[row]
                if m.any():
                    acc_ids[qi].append(lids[m].astype(np.int64))
                    acc_d[qi].append(np.sqrt(d2[row][m])
                                     .astype(np.float32))

        if compute == "device":
            verify = self._make_device_verify(
                Q, probe, eps, acc_ids, acc_d, live_rows=live_rows,
                k_cap_init=(wplan.k_cap if wplan is not None else None))
        skip = None
        if cancel is not None:
            def skip(b: int) -> bool:
                return not live_rows(b)
        self._read_and_verify(self._sorted_by_layout(list(probe)), cfg,
                              verify, skip=skip)
        self.stats.add("queries", Q.shape[0])
        self._maybe_snapshot_residency()

        out = []
        for qi in range(Q.shape[0]):
            if acc_ids[qi]:
                out.append((np.concatenate(acc_ids[qi]),
                            np.concatenate(acc_d[qi])))
            else:
                out.append((np.zeros(0, np.int64), np.zeros(0, np.float32)))
        return out

    def _make_device_verify(self, Q: np.ndarray, probe: dict, eps: float,
                            acc_ids: list, acc_d: list, live_rows=None,
                            k_cap_init: int | None = None):
        """Device verify for a probe wave (``compute_mode="device"``): the
        wave's query block crosses H2D ONCE, each probed bucket's padded
        slab once, and the verify kernel's E = 1 launch plus the
        compaction hand back (query row, bucket row, distance) triples —
        no per-bucket host distance matrix.

        ``k_cap_init`` seeds the compaction capacity from the wave plan's
        estimate upper bound (``plan_mode="on"``) instead of the fixed
        256; the overflow re-dispatch stays as the fallback."""
        cap = self.bucket_capacity
        dev = self.device
        q_dev = to_device(Q, dev)                       # staged ONCE
        self.stats.add("h2d_transfers", 1)
        self.stats.add("h2d_bytes", int(Q.nbytes))
        state = {"first": True, "k_cap": int(k_cap_init or 256)}

        def verify(b: int, vecs: np.ndarray, ids_: np.ndarray,
                   n: int) -> None:
            rows_alive = (probe[b] if live_rows is None
                          else live_rows(b))
            if not rows_alive:
                return
            if state["first"]:
                state["first"] = False
            else:
                # every verify after the first reuses the staged block a
                # per-bucket staging baseline would re-transfer
                self.stats.add("device_slab_hits", 1)
                self.stats.add("h2d_transfers_saved", 1)
            slab = vecs
            if slab.shape[0] != cap:  # fallback reads come unpadded
                slab = np.concatenate(
                    [slab, np.full((cap - slab.shape[0], slab.shape[1]),
                                   PAD_COORD, np.float32)])
            slab_dev = to_device(np.asarray(slab, np.float32), dev)
            self.stats.add("h2d_transfers", 1)
            self.stats.add("h2d_bytes", int(slab.nbytes))
            qidx = np.asarray(rows_alive, np.int64)
            nq = qidx.size
            idx = np.zeros(next_pow2(nq), np.int64)
            idx[:nq] = qidx
            idx_dev = to_device(idx, dev)
            while True:
                counts, r, c, d = query_verify_compact(
                    q_dev, idx_dev, nq, slab_dev, eps, state["k_cap"])
                k = int(counts.cpu()[0])
                if k <= state["k_cap"]:
                    break
                state["k_cap"] = next_pow2(k)
            if k == 0:
                return
            qrows = r[0, :k].cpu().numpy()
            cols = c[0, :k].cpu().numpy()
            dists = d[0, :k].cpu().numpy()
            lids = ids_[:n]
            for row in np.unique(qrows):
                sel = qrows == row
                qi = int(qidx[row])
                acc_ids[qi].append(lids[cols[sel]].astype(np.int64))
                acc_d[qi].append(dists[sel].astype(np.float32))

        return verify

    def _sorted_by_layout(self, buckets: list[int]) -> list[int]:
        """Order an ad-hoc bucket set by disk placement, so a wave reads
        disk-adjacent buckets adjacently."""
        if len(buckets) < 2 or not hasattr(self.store, "layout_keys"):
            return buckets
        keys = self.store.layout_keys(buckets)
        return [buckets[i] for i in np.argsort(keys, kind="stable")]

    def _candidate_buckets(self, Q: np.ndarray,
                           cfg: JoinConfig) -> list[np.ndarray]:
        """Per-query candidate bucket ids: center search, point triangle
        inequality (‖q − c_b‖ − r_b ≤ ε), then Eq. 3 pruning with the
        query ball radius ε."""
        with self._center_lock:
            if self._center_index is None:
                self._center_index = make_center_index(self.meta.centers,
                                                       device=self.device)
        eps = float(cfg.epsilon)
        L = min(cfg.max_candidates, self.meta.num_buckets)
        d2, cand = self._center_index.search(Q, L)
        dists = np.sqrt(np.maximum(d2, 0.0))
        out = []
        for qi in range(Q.shape[0]):
            ids, dd = cand[qi], dists[qi]
            ok = np.isfinite(dd)
            ids, dd = ids[ok], dd[ok]
            near = dd - self.meta.radii[ids] <= eps
            ids, dd = ids[near], dd[near]
            if cfg.prune and ids.size:
                keep = prune_candidates(dd, eps, self.dim,
                                        cfg.recall_target,
                                        cand_radii=self.meta.radii[ids])
                ids = ids[keep]
            out.append(ids.astype(np.int64))
        return out

    def _read_and_verify(self, buckets: list[int], cfg: JoinConfig,
                         verify, skip=None) -> None:
        """Serve ``verify(b, vecs, ids, rows)`` for every bucket, routing
        reads through the session pool: warm hits pin already-resident
        slabs; misses read into a free slab (or, when the pool is fully
        contended, into a private buffer — counted — instead of
        blocking)."""
        pool = self._ensure_pool(cfg)
        warm_hits = 0
        misses: list[int] = []
        for b in buckets:
            if skip is not None and skip(b):
                continue
            with self._warm_lock:
                ent = self._warm.get(b)
                if ent is not None:
                    slot, rows = ent
                    pool.pin(slot)
                    self._warm.move_to_end(b)
                else:
                    slot = None
            if slot is None:
                misses.append(b)
            else:
                try:
                    verify(b, pool.vecs(slot), pool.ids(slot), rows)
                finally:
                    pool.unpin(slot)
                warm_hits += 1
        if warm_hits:
            self.stats.add("query_warm_hits", warm_hits)
        if not misses:
            return
        if cfg.io_mode == "prefetch" and len(misses) > 1:
            self._read_misses_prefetch(misses, cfg, pool, verify,
                                       skip=skip)
        else:
            self._read_misses_sync(misses, cfg, pool, verify, skip=skip)

    def _read_misses_sync(self, misses: list[int], cfg: JoinConfig,
                          pool: BufferPool, verify, skip=None) -> None:
        tr = self._tracer()
        for b in misses:
            if skip is not None and skip(b):
                # every prober's deadline passed since the wave started
                self.stats.add("midwave_skipped_reads", 1)
                continue
            self._make_room(pool)
            slot = pool.try_acquire()
            if slot is None:
                size = int(self.meta.sizes[b])
                vecs = np.empty((size, self.dim), np.float32)
                ids = np.empty(size, np.int64)
                t0 = time.perf_counter()
                n = read_with_retry(
                    lambda: self.store.read_bucket_into(
                        b, vecs, ids, pad_value=PAD_COORD),
                    retries=cfg.io_retries,
                    backoff_s=cfg.io_retry_backoff_s, stats=self.stats)
                if tr.enabled:
                    tr.complete("io.read", t0, time.perf_counter() - t0,
                                buckets=1, src="query")
                self.stats.add("query_fallback_reads", 1)
                verify(b, vecs, ids, n)
                continue
            t0 = time.perf_counter()
            try:
                n = read_with_retry(
                    lambda: self.store.read_bucket_into(
                        b, pool.vecs(slot), pool.ids(slot),
                        pad_value=PAD_COORD),
                    retries=cfg.io_retries,
                    backoff_s=cfg.io_retry_backoff_s, stats=self.stats)
            except BaseException:
                # a read that fails for good (a killed replica's store)
                # gives its slab back: the JAX package's copy keeps it
                # pinned for the session's life
                pool.unpin(slot)
                raise
            if tr.enabled:
                tr.complete("io.read", t0, time.perf_counter() - t0,
                            buckets=1, src="query")
            self.stats.add("query_reads", 1)
            try:
                verify(b, pool.vecs(slot), pool.ids(slot), n)
            finally:
                self._retain_or_release(b, slot, n, pool)

    def _read_misses_prefetch(self, misses: list[int], cfg: JoinConfig,
                              pool: BufferPool, verify, skip=None) -> None:
        """Batch-friendly path: a schedule prefetcher overlaps the misses'
        reads (per-device queues, batching/coalescing as configured; its
        threads read with numpy only). The prefetcher was told the full
        miss list, so mid-wave cancellation here skips only the verify
        fan-out — the slab still lands (and stays warm for later waves)."""
        pf = SchedulePrefetcher(
            self.store, misses, pool, lookahead=cfg.io_lookahead,
            num_threads=cfg.io_threads, stats=self.stats,
            pad_value=PAD_COORD, batch_reads=cfg.io_batch_reads,
            coalesce=cfg.io_coalesce, close_pool=False,
            tracer=self._tracer(), retries=cfg.io_retries,
            retry_backoff_s=cfg.io_retry_backoff_s)
        try:
            for _ in misses:
                b, slot, n = pf.pop_next()
                self.stats.add("query_reads", 1)
                try:
                    if skip is None or not skip(b):
                        verify(b, pool.vecs(slot), pool.ids(slot), n)
                finally:
                    self._retain_or_release(b, slot, n, pool)
        finally:
            pf.close()

    # -- warm query cache -----------------------------------------------------
    def _retain_or_release(self, b: int, slot: int, rows: int,
                           pool: BufferPool) -> None:
        """Keep a freshly-read slab warm for later queries when no batch
        join runs and headroom remains; else release it. The warm
        capacity is the planner's ``PoolPlan`` share when one sized this
        pool, else all but the reserve."""
        with self._warm_lock:
            cap = (self._warm_quota if self._warm_quota is not None
                   else pool.num_slabs - _WARM_RESERVE)
            if (self._joins_active == 0 and b not in self._warm
                    and len(self._warm) < cap):
                self._warm[b] = (slot, rows)
                return
        pool.unpin(slot)

    def _make_room(self, pool: BufferPool) -> None:
        """Evict warm LRU entries until at least one pool slab is free."""
        with self._warm_lock:
            while self._warm and pool.in_use >= pool.num_slabs - 1:
                _, (slot, _) = self._warm.popitem(last=False)
                pool.unpin(slot)

    def _drop_warm_locked(self) -> None:
        while self._warm:
            _, (slot, _) = self._warm.popitem(last=False)
            self._pool.unpin(slot)

    def drop_warm_cache(self) -> None:
        """Release every warm query slab (benchmark cold-start helper)."""
        with self._warm_lock:
            self._drop_warm_locked()

    def warm_buckets(self) -> list[int]:
        with self._warm_lock:
            return list(self._warm)

    # -- serving fast restart (repro_torch.ft) -------------------------------
    def _residency_ids(self) -> list[int]:
        """Warm bucket ids eligible for the residency snapshot (LRU
        order, oldest first). Slabs a concurrent query still has pinned
        are excluded — their residency is transient, not cache state."""
        with self._warm_lock:
            pool = self._pool
            if pool is None:
                return []
            # warm entries hold exactly one pool reference; a higher
            # refcount means some in-flight verify has it pinned
            return [int(b) for b, (slot, _) in self._warm.items()
                    if pool.refcount(slot) == 1]

    def save_residency_snapshot(self) -> int:
        """Persist the warm cache's bucket ids to ``residency.json`` so
        the next ``open(warm_start=True)`` can pre-fault them. Returns
        the number of bucket ids written (0 on a read-only workdir)."""
        ids = self._residency_ids()
        try:
            atomic_write_json(os.path.join(self.workdir, RESIDENCY_NAME),
                              {"format": "diskjoin-residency/v1",
                               "buckets": ids})
        except OSError:
            return 0  # read-only workdir: restart just comes up cold
        return len(ids)

    def enable_residency_snapshots(self, interval_s: float = 30.0) -> None:
        """Persist ``residency.json`` periodically *during* serving, not
        only at ``close()`` — a crash mid-serve then still restarts warm.
        The snapshot is captured at query-execution boundaries (a cheap
        id-list copy under the warm lock) and written by an
        ``AsyncCommitter`` daemon via ``try_submit``: the serve path
        never blocks on the disk, and a slow write simply defers the
        snapshot to the next boundary."""
        self._residency_interval = float(interval_s)
        if self._residency_committer is None:
            self._residency_committer = AsyncCommitter(
                name="residency-snapshot")
        self._residency_next = time.perf_counter() + \
            self._residency_interval

    def disable_residency_snapshots(self) -> None:
        committer, self._residency_committer = \
            self._residency_committer, None
        self._residency_next = float("inf")
        if committer is not None:
            committer.close()

    def _maybe_snapshot_residency(self) -> bool:
        """Called at query-execution boundaries: submit an async
        residency write when the interval elapsed and the writer is
        idle. Returns whether a snapshot was submitted."""
        if self._residency_committer is None:
            return False
        now = time.perf_counter()
        if now < self._residency_next:
            return False
        self._residency_next = now + self._residency_interval
        ids = self._residency_ids()
        path = os.path.join(self.workdir, RESIDENCY_NAME)

        def write():
            try:
                atomic_write_json(path,
                                  {"format": "diskjoin-residency/v1",
                                   "buckets": ids})
            except OSError:
                pass  # read-only workdir: keep serving

        if not self._residency_committer.try_submit(write):
            return False  # previous write still in flight
        self.stats.add("residency_snapshots", 1)
        return True

    def _warm_start(self) -> None:
        """Replay a persisted residency snapshot: pre-fault its buckets
        into pool slabs (newest-first priority, bounded by the warm
        quota and pool headroom). Counted as ``warm_prefaults``."""
        path = os.path.join(self.workdir, RESIDENCY_NAME)
        if self.query_defaults is None or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                snap = json.load(f)
            buckets = snap["buckets"]
        except (OSError, ValueError, KeyError):
            return  # torn/stale snapshot: cold start, not an error
        cfg = merge_config(self.build_config, self.query_defaults)
        pool = self._ensure_pool(cfg)
        with self._warm_lock:
            cap = (self._warm_quota if self._warm_quota is not None
                   else pool.num_slabs - _WARM_RESERVE)
            # snapshot is LRU order (oldest first): fault the most
            # recently used end first so it survives any truncation
            faulted = 0
            for b in reversed(buckets):
                b = int(b)
                if faulted >= cap:
                    break
                if not (0 <= b < self.meta.num_buckets):
                    continue  # snapshot predates a rebuild
                if b in self._warm:
                    continue
                slot = pool.try_acquire()
                if slot is None:
                    break
                n = read_with_retry(
                    lambda: self.store.read_bucket_into(
                        b, pool.vecs(slot), pool.ids(slot),
                        pad_value=PAD_COORD),
                    retries=cfg.io_retries,
                    backoff_s=cfg.io_retry_backoff_s, stats=self.stats)
                self._warm[b] = (slot, n)
                self._warm.move_to_end(b, last=False)
                faulted += 1
            if faulted:
                self.stats.add("warm_prefaults", faulted)

    # -- telemetry / lifecycle ------------------------------------------------
    def pipeline_snapshot(self) -> dict:
        """The session's single PipelineStats snapshot: batch-join loads
        and online query reads appear in one surface."""
        return self.stats.snapshot()

    def io_snapshot(self) -> dict:
        return self.store.stats.snapshot()

    def metrics_snapshot(self) -> dict:
        """The session's full metrics surface (``repro_torch.obs``): registered
        instruments plus the pipeline/io provider sections — and whatever
        services (scheduler, query service) registered on top."""
        return self.metrics.snapshot()

    def merge_build_timings(self, timings: dict) -> dict:
        """Fold this index's build cost into a result's timings (the
        one-shot ``similarity_self_join`` keeps the "bucketing included"
        schema)."""
        sub = dict(self.build_timings)
        layout_s = sub.pop("layout_plan", 0.0)
        t = dict(timings)
        t["bucketing"] = t.get("bucketing", 0.0) + self.build_seconds \
            - layout_s
        for k, v in sub.items():
            t[f"bucketing/{k}"] = t.get(f"bucketing/{k}", 0.0) + v
        if layout_s:
            t["orchestration"] = t.get("orchestration", 0.0) + layout_s
            t["orchestration/layout_plan"] = \
                t.get("orchestration/layout_plan", 0.0) + layout_s
        return t

    def close(self) -> None:
        """Release the session: warm slabs, pool, store handles. The
        on-disk index remains and can be re-``open``ed."""
        if self._closed:
            return
        self._closed = True
        if self._live is not None:
            try:
                self.detach_live()
            except Exception:
                pass  # observability teardown must not block release
        if self._residency_committer is not None:
            try:
                self.disable_residency_snapshots()
            except Exception:
                pass  # a failed last snapshot is re-raised there; the
                #       close() below still writes a fresh one inline
        with self._warm_lock:
            if self._pool is not None:
                # snapshot BEFORE dropping: the warm set is the restart's
                # pre-fault list
                self.save_residency_snapshot()
                self._drop_warm_locked()
        if self._pool is not None:
            self._pool.close()
        self.store.close()

    def __enter__(self) -> "DiskJoinIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
