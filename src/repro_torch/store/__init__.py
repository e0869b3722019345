"""On-disk vector stores (copied from the JAX package, same file format):
the flat input store, the bucketed store and the store striped over
several backing files."""
from repro_torch.store.io_stats import IOStats
from repro_torch.store.striped_store import StripedBucketedVectorStore
from repro_torch.store.vector_store import BucketedVectorStore, FlatVectorStore

__all__ = ["BucketedVectorStore", "FlatVectorStore", "IOStats",
           "StripedBucketedVectorStore"]
