"""Durability primitives the port needs (a subset of the JAX package's)."""
from repro_torch.ft.atomic import atomic_write_json

__all__ = ["atomic_write_json"]
