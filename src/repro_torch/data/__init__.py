"""Synthetic datasets (numpy, seeded) — a copy of the JAX package's."""
from repro_torch.data.synthetic import (brute_force_pairs, clustered_vectors,
                                        epsilon_for_avg_neighbors,
                                        uniform_vectors)

__all__ = ["brute_force_pairs", "clustered_vectors",
           "epsilon_for_avg_neighbors", "uniform_vectors"]
