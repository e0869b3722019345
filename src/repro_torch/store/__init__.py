"""On-disk vector stores (copied from the JAX package, same file format).
The striped store waits for a later slice of the port."""
from repro_torch.store.io_stats import IOStats
from repro_torch.store.vector_store import BucketedVectorStore, FlatVectorStore

__all__ = ["BucketedVectorStore", "FlatVectorStore", "IOStats"]
