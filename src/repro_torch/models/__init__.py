"""The LM substrate on PyTorch: every model family of the JAX package's
``repro.models`` (dense, MoE, SSM, hybrid, VLM and enc-dec), for serving."""
from repro_torch.models.model_api import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
