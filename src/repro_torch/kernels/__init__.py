"""Hand-written CUDA kernels for Hopper (+ their plain PyTorch versions).

- ``pairwise_l2``   — DiskJoin verify step (batched distance + threshold)
- ``bucket_assign`` — bucketization scan 2 (fused nearest center)

``ops`` is the only public entry point; ``ref`` holds the plain versions
a CPU tensor runs. ``_build`` compiles ``csrc/*.cu`` with nvcc at first
launch.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
