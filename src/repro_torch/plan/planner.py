"""Cost-based planner: estimates + cost model → typed, explainable plans.

The planner turns the pile of hand-tuned knobs the execution layers used
to hard-code into derived decisions:

``JoinPlan`` (one per batch join)
    * **pair_cap** — the device engine's per-edge compaction capacity,
      sized from the estimator's calibrated *upper bound* over every
      verify unit (instead of the fixed ``PAIR_CAP_INIT``). Overflow
      re-dispatch survives as a counted fallback for the estimate's
      tail, not the steady state.
    * **verify_batch per schedule region** — dense regions (many
      predicted pairs per edge) flush in small batches to bound the
      result working set; sparse regions batch wide to amortize dispatch.
    * **host/device route per verify unit** — modeled cost of staging +
      cells + readback on each path, using the cache schedule's hit/miss
      outcomes for per-edge transfer freshness.

``WavePlan`` (one per serving wave)
    k_cap for the device query path, host/device choice, and the
    predicted wave seconds the scheduler's estimate-based admission
    compares against request deadlines.

``PoolPlan`` (one per session pool sizing)
    The split of the ``BufferPool`` slab budget between the join working
    set and the serving warm cache, from observed probe reuse.

Every decision is recorded three ways: a ``Decision`` row rendered by
``explain()`` (inputs → choice → reason), a tracer instant
(``plan.join`` / ``plan.wave`` / ``plan.pool``), and counters/gauges on
the session ``PipelineStats``/``MetricsRegistry``. The planner only
sizes and places work — the result pair set is invariant under every
choice it makes (asserted by the planner-on/off byte-parity tests).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.plan.cost_model import CostModel
from repro_torch.plan.estimator import CardinalityEstimator

PAIR_CAP_FLOOR = 64          # never plan below this compaction capacity
PAIR_CAP_MARGIN = 1.5        # headroom multiplier on the estimate hi bound
REGION_UNITS = 32            # verify units per batching region
FLUSH_PAIRS_BUDGET = 1 << 16  # target result pairs in flight per flush
K_CAP_FLOOR = 256            # query-path compaction floor (matches legacy)


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Decision:
    """One explainable planner choice: inputs → choice, with the reason."""

    name: str
    choice: object
    reason: str
    inputs: dict = dataclasses.field(default_factory=dict)

    def render(self) -> str:
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        return f"{self.name:<14} = {self.choice!s:<18} <- {self.reason}" \
               + (f"  [{ins}]" if ins else "")


def _render(title: str, decisions: list[Decision]) -> str:
    return "\n".join([title] + ["  " + d.render() for d in decisions])


@dataclasses.dataclass
class JoinPlan:
    """Planner output for one batch join, consumed by the executor.

    ``unit_params`` holds one (route, verify_batch) per verify unit in
    the exact order the executor enqueues them (touch-intra units
    included for self-joins), so consumption is a single cursor walk.
    """

    epsilon: float
    num_units: int
    est_total: float
    hi_total: float
    pair_cap: int
    compute_mode: str                 # "host" | "device" | "mixed"
    unit_params: list                 # [(route, batch)] in enqueue order
    decisions: list = dataclasses.field(default_factory=list)

    @property
    def mixed(self) -> bool:
        return self.compute_mode == "mixed"

    def explain(self) -> str:
        routes = {}
        for r, _ in self.unit_params:
            routes[r] = routes.get(r, 0) + 1
        head = (f"JoinPlan(eps={self.epsilon:g}, units={self.num_units}, "
                f"est_pairs={self.est_total:.3g} "
                f"[hi {self.hi_total:.3g}], routes={routes})")
        return _render(head, self.decisions)


@dataclasses.dataclass
class WavePlan:
    """Planner output for one serving wave / admission probe."""

    epsilon: float
    num_queries: int
    num_buckets: int
    cold_reads: int
    est_pairs: float
    hi_pairs: float
    k_cap: int
    compute_mode: str                 # resolved: "host" | "device"
    predicted_s: float
    decisions: list = dataclasses.field(default_factory=list)

    def explain(self) -> str:
        head = (f"WavePlan(eps={self.epsilon:g}, "
                f"queries={self.num_queries}, "
                f"buckets={self.num_buckets}, "
                f"cold_reads={self.cold_reads}, "
                f"est_pairs={self.est_pairs:.3g} [hi {self.hi_pairs:.3g}], "
                f"predicted={self.predicted_s * 1e3:.2f} ms)")
        return _render(head, self.decisions)


@dataclasses.dataclass
class PoolPlan:
    """Slab-budget split between join working set and serving warm cache."""

    num_slabs: int
    warm_quota: int
    decisions: list = dataclasses.field(default_factory=list)

    def explain(self) -> str:
        head = (f"PoolPlan(slabs={self.num_slabs}, "
                f"warm_quota={self.warm_quota})")
        return _render(head, self.decisions)


class Planner:
    """Binds a ``CardinalityEstimator`` + ``CostModel`` to one session."""

    def __init__(self, estimator: CardinalityEstimator,
                 cost_model: CostModel, *, tracer=None, metrics=None,
                 pstats=None, pair_cap_margin: float = PAIR_CAP_MARGIN,
                 region_units: int = REGION_UNITS,
                 flush_pairs_budget: int = FLUSH_PAIRS_BUDGET):
        self.estimator = estimator
        self.cost = cost_model
        self.tracer = tracer
        self.metrics = metrics
        self.pstats = pstats
        self.pair_cap_margin = float(pair_cap_margin)
        self.region_units = int(region_units)
        self.flush_pairs_budget = int(flush_pairs_budget)

    # -- shared helpers ----------------------------------------------------------
    def _instant(self, name: str, **args) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, **args)

    def _count(self, stat: str, metric: str) -> None:
        if self.pstats is not None:
            self.pstats.add(stat, 1)
        if self.metrics is not None:
            self.metrics.counter(metric).inc()

    # -- batch-join planning --------------------------------------------------------
    def plan_join(self, tasks, actions, meta, config, bucket_capacity: int,
                  *, intra_join: bool = True) -> JoinPlan:
        """Plan one batch join from the executor's task walk.

        ``tasks``/``actions`` are ``JoinExecutor.plan()``'s edge schedule
        and cache-schedule actions — walking them together replays the
        executor's exact access pattern, so the plan knows both the
        verify-unit order (for cursor-based consumption) and each
        access's hit/miss outcome (for per-edge transfer freshness).
        """
        cap = int(bucket_capacity)
        dim = self.estimator.samples.shape[2]
        sizes = meta.sizes
        units: list[tuple[int, int, bool]] = []   # (u, v, intra)
        fresh: list[int] = []                     # cold accesses per unit
        ai = 0
        for task in tasks:
            if task[0] == "touch":
                b = int(task[1])
                miss = 0 if actions[ai][1] else 1
                ai += 1
                if intra_join and sizes[b] >= 2:
                    units.append((b, b, True))
                    fresh.append(miss)
            else:
                _, u, v = task
                miss = ((0 if actions[ai][1] else 1)
                        + (0 if actions[ai + 1][1] else 1))
                ai += 2
                units.append((int(u), int(v), False))
                fresh.append(miss)
        decisions: list[Decision] = []
        if not units:
            plan = JoinPlan(epsilon=float(config.epsilon), num_units=0,
                            est_total=0.0, hi_total=0.0,
                            pair_cap=PAIR_CAP_FLOOR,
                            compute_mode=(config.compute_mode
                                          if config.compute_mode != "auto"
                                          else "host"),
                            unit_params=[], decisions=decisions)
            self._record_join(plan)
            return plan

        edges = np.array([(u, v) for u, v, _ in units], np.int64)
        intra = np.array([i for _, _, i in units], bool)
        est, _, hi = self.estimator.est_edges(edges, config.epsilon,
                                              intra)
        est_total, hi_total = float(est.sum()), float(hi.sum())

        # --- pair_cap: bound the densest verify unit, with headroom ---
        cap2 = cap * cap
        densest = float(hi.max())
        pair_cap = _next_pow2(int(math.ceil(
            max(PAIR_CAP_FLOOR, densest * self.pair_cap_margin))))
        pair_cap = min(pair_cap, cap2)
        decisions.append(Decision(
            "pair_cap", pair_cap,
            f"densest unit hi {densest:.3g} x margin "
            f"{self.pair_cap_margin:g}, pow2, clamp "
            f"[{PAIR_CAP_FLOOR}, cap^2={cap2}]",
            {"units": len(units), "hi_total": f"{hi_total:.3g}"}))

        # --- verify_batch per schedule region ---
        batches = np.empty(len(units), np.int64)
        region_sizes: list[int] = []
        for lo in range(0, len(units), self.region_units):
            sl = slice(lo, min(lo + self.region_units, len(units)))
            density = float(hi[sl].mean())
            b = int(np.clip(self.flush_pairs_budget
                            / max(1.0, density), 1,
                            config.verify_batch))
            batches[sl] = b
            region_sizes.append(b)
        decisions.append(Decision(
            "verify_batch",
            f"{min(region_sizes)}..{max(region_sizes)}",
            f"flush budget {self.flush_pairs_budget} pairs / region "
            f"density, clamp [1, {config.verify_batch}]",
            {"regions": len(region_sizes)}))

        # --- host/device route per unit ---
        cells = np.where(intra,
                         sizes[edges[:, 0]] * (sizes[edges[:, 0]] - 1) / 2,
                         sizes[edges[:, 0]] * sizes[edges[:, 1]])
        if config.compute_mode in ("host", "device"):
            routes = [config.compute_mode] * len(units)
            decisions.append(Decision(
                "compute", config.compute_mode,
                "pinned by config.compute_mode"))
        else:  # "auto": per-unit modeled cost
            host_s = np.array([
                self.cost.host_edge_s(c, cap, dim, batch=int(b))
                for c, b in zip(cells, batches)])
            dev_s = np.array([
                self.cost.device_edge_s(c, h, cap, dim, fresh_slabs=f,
                                        batch=int(b))
                for c, h, f, b in zip(cells, hi, fresh, batches)])
            routes = ["device" if d < h else "host"
                      for d, h in zip(dev_s, host_s)]
            n_dev = routes.count("device")
            decisions.append(Decision(
                "compute",
                ("device" if n_dev == len(units) else
                 "host" if n_dev == 0 else "mixed"),
                f"modeled host {host_s.sum():.3g}s vs device "
                f"{dev_s.sum():.3g}s per unit ({self.cost.describe()})",
                {"host_units": len(units) - n_dev,
                 "device_units": n_dev}))
        n_dev = routes.count("device")
        mode = ("device" if n_dev == len(units)
                else "host" if n_dev == 0 else "mixed")
        plan = JoinPlan(
            epsilon=float(config.epsilon), num_units=len(units),
            est_total=est_total, hi_total=hi_total, pair_cap=pair_cap,
            compute_mode=mode,
            unit_params=list(zip(routes, (int(b) for b in batches))),
            decisions=decisions)
        self._record_join(plan)
        return plan

    def _record_join(self, plan: JoinPlan) -> None:
        self._count("plans", "plan.joins")
        self._instant("plan.join", units=plan.num_units,
                      pair_cap=plan.pair_cap, compute=plan.compute_mode,
                      est_pairs=round(plan.est_total, 1),
                      hi_pairs=round(plan.hi_total, 1))
        if self.metrics is not None:
            self.metrics.gauge("plan.pair_cap").set(plan.pair_cap)
        if self.pstats is not None:
            with self.pstats._lock:
                self.pstats.planned_pair_cap = plan.pair_cap

    # -- serving-wave planning ---------------------------------------------------------
    def plan_wave(self, Q: np.ndarray, per_q: list, meta, config,
                  bucket_capacity: int, warm: set | None = None
                  ) -> WavePlan:
        """Plan one serving wave (also the admission cost probe).

        ``per_q``: per-query candidate-bucket lists from ``plan_probes``;
        ``warm``: bucket ids already resident in the session pool (their
        reads are free)."""
        warm = warm or set()
        cap = int(bucket_capacity)
        dim = Q.shape[1]
        est_q, hi_q, bucket_hi = self.estimator.est_queries(
            Q, per_q, config.epsilon)
        buckets = sorted(bucket_hi)
        cold = [b for b in buckets if b not in warm]
        decisions: list[Decision] = []
        sizes = meta.sizes
        cells = float(sum(int(sizes[b]) * sum(1 for ids in per_q
                                              if b in set(np.asarray(ids)))
                          for b in buckets))
        densest = max(bucket_hi.values(), default=0.0)
        k_cap = min(_next_pow2(int(math.ceil(
            max(K_CAP_FLOOR, densest * self.pair_cap_margin)))),
            cap * max(1, len(Q)))
        decisions.append(Decision(
            "k_cap", k_cap,
            f"densest bucket hi {densest:.3g} x margin "
            f"{self.pair_cap_margin:g}, pow2, floor {K_CAP_FLOOR}"))
        hi_total = float(hi_q.sum())
        if config.compute_mode in ("host", "device"):
            mode = config.compute_mode
            decisions.append(Decision(
                "compute", mode, "pinned by config.compute_mode"))
            verify_s = (self.cost.host_query_s(cells) if mode == "host"
                        else self.cost.device_query_s(
                            cells, hi_total, len(Q), cap, dim,
                            len(cold)))
        else:
            host_s = self.cost.host_query_s(cells)
            dev_s = self.cost.device_query_s(cells, hi_total, len(Q),
                                             cap, dim, len(cold))
            mode = "device" if dev_s < host_s else "host"
            verify_s = min(host_s, dev_s)
            decisions.append(Decision(
                "compute", mode,
                f"modeled host {host_s:.3g}s vs device {dev_s:.3g}s "
                f"({self.cost.describe()})"))
        read_s = self.cost.read_s(len(cold))
        predicted = read_s + verify_s
        decisions.append(Decision(
            "predicted_s", f"{predicted:.4g}",
            f"reads {len(cold)} x "
            f"{self.cost.read_s_per_bucket * 1e3:.3g} ms + verify "
            f"{verify_s:.3g}s over {cells:.3g} cells"))
        plan = WavePlan(
            epsilon=float(config.epsilon), num_queries=len(Q),
            num_buckets=len(buckets), cold_reads=len(cold),
            est_pairs=float(est_q.sum()), hi_pairs=hi_total,
            k_cap=int(k_cap), compute_mode=mode,
            predicted_s=float(predicted), decisions=decisions)
        self._count("wave_plans", "plan.waves")
        self._instant("plan.wave", queries=len(Q),
                      buckets=len(buckets), cold_reads=len(cold),
                      k_cap=int(k_cap), compute=mode,
                      predicted_ms=round(predicted * 1e3, 3))
        return plan

    # -- pool-budget planning -----------------------------------------------------------
    def plan_pool(self, config, cap_buckets: int, lookahead: int,
                  stats: dict | None, *, floor: int = 2,
                  ceiling: int | None = None) -> PoolPlan:
        """Split the session slab budget between the join working set
        (cache capacity + prefetch lookahead) and the serving warm cache.

        The warm quota is the predicted per-wave bucket reuse: the mean
        distinct buckets probed per wave (or per point query) observed so
        far — keeping that many slabs warm lets the *next* wave's probes
        hit without reads. With no query traffic yet the quota stays at
        the legacy reserve (``floor``)."""
        stats = stats or {}
        waves = stats.get("waves", 0)
        queries = stats.get("queries", 0)
        if waves > 0:
            reuse = stats.get("shared_probe_reads", 0) / waves
            basis = f"{reuse:.2f} distinct buckets/wave over {waves} waves"
        elif queries > 0:
            reuse = ((stats.get("query_reads", 0)
                      + stats.get("query_warm_hits", 0)) / queries)
            basis = f"{reuse:.2f} probes/query over {queries} queries"
        else:
            reuse = float(floor)
            basis = "no query traffic yet (legacy reserve)"
        quota = int(np.clip(math.ceil(reuse), floor,
                            ceiling if ceiling is not None
                            else max(floor, cap_buckets)))
        num_slabs = cap_buckets + lookahead + quota
        decisions = [
            Decision("warm_quota", quota, f"predicted reuse: {basis}"),
            Decision("num_slabs", num_slabs,
                     f"join working set {cap_buckets} + lookahead "
                     f"{lookahead} + warm {quota}"),
        ]
        plan = PoolPlan(num_slabs=num_slabs, warm_quota=quota,
                        decisions=decisions)
        self._instant("plan.pool", num_slabs=num_slabs, warm_quota=quota)
        if self.metrics is not None:
            self.metrics.gauge("plan.warm_quota").set(quota)
        return plan


# -- replica-aware service prediction -----------------------------------------

def predict_replica_service_s(request_s: float, queue_depth: int, *,
                              observed_s: float | None = None) -> float:
    """Predicted time for a NEW request to clear a replica: its own
    service (``request_s`` — a ``WavePlan.predicted_s`` for a
    single-request wave, or an observed per-request EWMA) plus the
    backlog already queued ahead of it, drained at the observed rate
    when one is available.

    This is the scoring function behind ``serve.replica.ReplicaSet``'s
    ``least_loaded`` policy: with equal replicas it reduces to queue
    depth; a replica whose live-calibrated costs have drifted up (a
    browned-out SSD raises its ``read_s_per_bucket``, so its
    ``predicted_s`` rises) is avoided even at equal depth.
    """
    per_request = observed_s if observed_s and observed_s > 0 \
        else float(request_s)
    return float(request_s) + max(0, int(queue_depth)) * per_request
