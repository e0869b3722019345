"""Serving: batched continuous-decode engine + online vector queries
(copies of the JAX package's ``repro.serve`` over the port's
``DiskJoinIndex``; the LM engine is the port's own).

``ServeEngine`` — wave-batched LM decode serving.
``VectorQueryService`` — ε-range point lookups over a ``DiskJoinIndex``
session, sharing the index's BufferPool/prefetcher and PipelineStats with
batch joins (ROADMAP "serving integration").
``QueryScheduler`` — wave-batched request queue with probe-sharing,
per-request deadlines, admission control and queue checkpointing
(ROADMAP "serving hardening"); ``IndexRouter`` fronts multiple index
shards with scatter/gather over health-gated replica sets
(``ReplicaSet``/``HealthTracker``/``ReplicaSupervisor`` in
``serve.replica`` — failover, hedging, supervised restart, degraded-mode
coverage).
"""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.query_service import VectorQueryService
from repro_torch.serve.replica import (DEGRADED, DOWN, HEALTHY, Coverage,
                                       HealthTracker, Replica, ReplicaFuture,
                                       ReplicaSet, ReplicaSupervisor,
                                       ShardStatus, ShardUnavailable)
from repro_torch.serve.router import IndexRouter, RouterFuture
from repro_torch.serve.scheduler import (AdmissionRejected,
                                         DeadlineExceeded, QueryFuture,
                                         QueryScheduler, SchedulerClosed,
                                         SchedulerQueueFull, order_result)

__all__ = ["Request", "ServeEngine", "VectorQueryService",
           "QueryScheduler", "QueryFuture", "IndexRouter", "RouterFuture",
           "AdmissionRejected", "DeadlineExceeded", "SchedulerClosed",
           "SchedulerQueueFull", "order_result",
           "Replica", "ReplicaSet", "ReplicaFuture", "ReplicaSupervisor",
           "HealthTracker", "Coverage", "ShardStatus", "ShardUnavailable",
           "HEALTHY", "DEGRADED", "DOWN"]
