"""Serving: the wave-batched LM decode engine. (The join-side serving of
the JAX package — query service, scheduler, router, replicas — is ROADMAP
module item 5.)"""
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
