"""Baselines the paper compares against (§6.1): numpy copies of the JAX
package's ``repro.baselines``. Nothing of them runs on the card.

- ``diskann_join``  — search-per-vector over a disk-resident proximity
                      graph (DiskANN-style): the paper's Fig. 1 baseline.
- ``cluster_join``  — single-node ClusterJoin (pivot partitioning +
                      bisector replication filter), exact.
- ``rshj``          — LSH-based in-memory join (RSHJ-style), approximate.
"""
from repro_torch.baselines.cluster_join import cluster_join
from repro_torch.baselines.diskann_join import DiskANNIndex, diskann_join
from repro_torch.baselines.rshj import rshj_join

__all__ = ["DiskANNIndex", "cluster_join", "diskann_join", "rshj_join"]
