"""The LM substrate on PyTorch: the decoder-only attention families (dense,
global and local layers) of the JAX package's ``repro.models``."""
from repro_torch.models.model_api import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
