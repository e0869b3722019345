"""Model API: ``build_model(cfg)`` → ``ModelBundle``, for the decoder-only
attention families. Port of the JAX package's ``models/model_api.py``.

  init(seed=0)                       → params (an ``LM`` on the device)
  init_cache(batch, max_seq)         → decode caches (one dict per layer)
  decode(params, tokens, caches)     → (logits (B, V), caches, updated in
                                        place)
  prefill(params, batch)             → last-token logits (B, V)
  loss(params, batch)                → raises: the training slice
                                        (ROADMAP module item 8)

The reference's functions are pure and jitted; these run eagerly on the
bundle's device (``device=None`` means CUDA). The reference's
``input_specs`` and ``cache_specs`` exist for its dry-run lowering, which is
not ported. Enc-dec (whisper) raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init: Callable
    loss: Callable
    init_cache: Callable
    decode: Callable
    prefill: Callable


def build_model(cfg: ArchConfig, *, device=None) -> ModelBundle:
    if cfg.enc_dec:
        raise NotImplementedError(
            "enc-dec models (models/encdec.py) are not ported to PyTorch "
            "yet (ROADMAP module item 8)")
    return _build_lm(cfg, resolve_device(device))


def _build_lm(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    def init(seed: int = 0):
        return transformer.init_lm(cfg, seed, device)

    def loss(params, batch):
        raise NotImplementedError(
            "the training loss (chunked_xent, train/*) is not ported to "
            "PyTorch yet (ROADMAP module item 8)")

    def init_cache(batch, max_seq):
        return transformer.init_cache(cfg, batch, max_seq, device)

    def decode(params, tokens, caches):
        return transformer.decode_step(params, tokens, caches)

    def prefill(params, batch):
        """Inference prefill: forward over the prompt → last-token logits.
        (The KV cache of a prompt is built by decode steps, as the
        reference's serving engine builds it.)"""
        hidden, _ = transformer.forward(params, batch["tokens"],
                                        patch_embeds=batch.get("patches"))
        return transformer.lm_logits(params, hidden[:, -1:])[:, 0]

    return ModelBundle(cfg, device, init, loss, init_cache, decode, prefill)
