"""DiskJoin on PyTorch and CUDA: the port of the JAX package ``repro``.

Subpackages mirror ``repro`` (``kernels``, ``compute``, ``core``, ``store``,
``io``, ``obs``, ``ft``, ``data``), so each module's counterpart has the same
name. This package imports ``torch`` and ``numpy`` and nothing of ``repro``
or ``jax``; modules it needs from ``repro`` that are plain numpy are kept
here as copies. Entry points take ``device=None`` (CUDA) and raise without
CUDA unless given ``device="cpu"``.
"""
