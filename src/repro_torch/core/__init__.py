"""DiskJoin core on PyTorch — the port of the JAX package's ``repro.core``.

Public API:
  DiskJoinIndex                    — build-once / query-many session:
                                     build/open, self_join, cross_join,
                                     online query/query_batch
  JoinConfig, JoinResult           — task configuration / output
  BuildConfig, QueryConfig         — build-time vs query-time split of
                                     JoinConfig (split_config/merge_config)
  similarity_self_join             — one-shot SSJ (deprecated wrapper)
  similarity_cross_join            — one-shot bipartite join (deprecated)
  bucketize / build_bucket_graph   — pipeline stages, individually usable
"""
from repro_torch.core.bucket_graph import (build_bucket_graph,
                                           candidate_pair_count)
from repro_torch.core.bucketize import bucketize
from repro_torch.core.cache import (CacheSchedule, simulate_belady,
                                    simulate_policy)
from repro_torch.core.executor import JoinExecutor
from repro_torch.core.index import DiskJoinIndex
from repro_torch.core.join import similarity_cross_join, similarity_self_join
from repro_torch.core.ordering import edge_schedule, gorder, window_size
from repro_torch.core.pruning import (cap_constant, miss_bound_terms,
                                      prune_candidates)
from repro_torch.core.types import (BUILD_TIME_FIELDS, QUERY_TIME_FIELDS,
                                    TIMING_KEYS, BucketGraph, BucketMeta,
                                    BuildConfig, JoinConfig, JoinResult,
                                    QueryConfig, canonicalize_pairs,
                                    dedup_pairs, finalize_timings,
                                    merge_config, recall, split_config)

__all__ = [
    "BUILD_TIME_FIELDS", "BucketGraph", "BucketMeta", "BuildConfig",
    "CacheSchedule", "DiskJoinIndex", "JoinConfig", "JoinExecutor",
    "JoinResult", "QUERY_TIME_FIELDS", "QueryConfig", "TIMING_KEYS",
    "bucketize", "build_bucket_graph", "candidate_pair_count",
    "canonicalize_pairs", "cap_constant", "dedup_pairs", "edge_schedule",
    "finalize_timings", "gorder", "merge_config", "miss_bound_terms",
    "prune_candidates", "recall", "similarity_cross_join",
    "similarity_self_join",
    "simulate_belady", "simulate_policy", "split_config", "window_size",
]
