"""Host I/O plumbing copied from the JAX package (numpy and threads only;
no torch call runs here):

  ``buffer_pool``  — fixed pool of pre-padded bucket slabs with pin/unpin
                     refcounting; pending verify batches keep evicted
                     slabs alive through pins.
  ``prefetcher``   — ``SchedulePrefetcher`` walks the precomputed cache
                     schedule ahead of the executor (``io_mode="prefetch"``)
                     with a bounded lookahead, pool backpressure, one
                     submission queue per device of a striped store,
                     batched and coalesced reads. ``PrefetchedBucketCache``
                     is the executor-facing frontend (the sync
                     ``BucketCache``'s surface).
  ``pipeline``     — ``PipelineStats`` counters (io_wait/compute split,
                     overlap, queue depth, per-device loads).
  ``retry``        — bounded retries of transient read errors.
"""
from repro_torch.io.buffer_pool import BufferPool
from repro_torch.io.pipeline import PipelineStats
from repro_torch.io.prefetcher import PrefetchedBucketCache, SchedulePrefetcher

__all__ = ["BufferPool", "PipelineStats", "PrefetchedBucketCache",
           "SchedulePrefetcher"]
