"""Device-side verify pipeline: slab pool, verify engines, compaction.

Bucket slabs cross H2D once per cache residency (``DeviceSlabPool``;
from a pinned ``HostSlot`` of the sync cache directly, on the pool's copy
stream), verify batches are dispatched double-buffered on the current
CUDA stream, and the compaction returns (row, col, distance) triples
instead of full (E, cap, cap) masks (``DeviceVerifyEngine``).
``HostVerifyEngine`` is the reference host path; both give byte-identical
results and are selected by ``JoinConfig.compute_mode``.
"""
from repro_torch.compute.engine import (PAIR_CAP_INIT, DeviceVerifyEngine,
                                        HostVerifyEngine, RoutedVerifyEngine,
                                        compact_pairs, device_verify,
                                        make_verify_engine, next_pow2,
                                        query_verify_compact)
from repro_torch.compute.slab_pool import DeviceSlabPool

__all__ = ["DeviceSlabPool", "DeviceVerifyEngine", "HostVerifyEngine",
           "PAIR_CAP_INIT", "RoutedVerifyEngine", "compact_pairs",
           "device_verify", "make_verify_engine", "next_pow2",
           "query_verify_compact"]
