"""Host I/O plumbing copied from the JAX package: the slab ``BufferPool``
the point queries read through, ``PipelineStats`` counters and read
retries. The schedule prefetcher (``io_mode="prefetch"``) waits for a
later slice of the port."""
from repro_torch.io.buffer_pool import BufferPool
from repro_torch.io.pipeline import PipelineStats

__all__ = ["BufferPool", "PipelineStats"]
