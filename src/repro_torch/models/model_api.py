"""Model API: ``build_model(cfg)`` → ``ModelBundle``, for every family of
the JAX package's ``models/model_api.py``: the decoder-only ones (dense,
MoE, SSM, hybrid, VLM) and enc-dec (whisper).

  init(seed=0)                       → params (an ``LM`` or ``EncDec`` on
                                        the device)
  init_cache(batch, max_seq)         → decode caches (decoder-only: one
                                        dict per layer; enc-dec also takes
                                        ``params=`` and ``enc_out=``)
  decode(params, tokens, caches)     → (logits (B, V), caches, updated in
                                        place)
  prefill(params, batch)             → last-token logits (B, V)
  loss(params, batch)                → raises: training is not ported yet
                                        (ROADMAP §1 item 3)

The reference's functions are pure and jitted; these run eagerly on the
bundle's device (``device=None`` means CUDA). The reference's
``input_specs`` and ``cache_specs`` exist for its dry-run lowering, which is
not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer


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
    device = resolve_device(device)
    if cfg.enc_dec:
        return _build_encdec(cfg, device)
    return _build_lm(cfg, device)


def _loss(params, batch):
    raise NotImplementedError(
        "the training loss (chunked_xent, train/*) is not ported to PyTorch "
        "yet (ROADMAP §1 item 3: training)")


def _build_lm(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    def init(seed: int = 0):
        return transformer.init_lm(cfg, seed, device)

    def init_cache(batch, max_seq):
        return transformer.init_cache(cfg, batch, max_seq, device)

    def decode(params, tokens, caches):
        return transformer.decode_step(params, tokens, caches)

    def prefill(params, batch):
        """Inference prefill: forward over the prompt (VLM: the patches,
        then the tokens) → last-token logits. (The caches of a prompt are
        built by decode steps, as the serving engine builds them.)"""
        hidden, _ = transformer.forward(params, batch["tokens"],
                                        patch_embeds=batch.get("patches"))
        return transformer.lm_logits(params, hidden[:, -1:])[:, 0]

    return ModelBundle(cfg, device, init, _loss, init_cache, decode, prefill)


def _build_encdec(cfg: ArchConfig, device: torch.device) -> ModelBundle:
    def init(seed: int = 0):
        return encdec.init_encdec(cfg, seed, device)

    def init_cache(batch, max_seq, params=None, enc_out=None):
        if params is None:
            raise ValueError("enc-dec cache needs params (cross-attn K/V)")
        return encdec.init_decode_cache(params, batch, max_seq, enc_out)

    def decode(params, tokens, caches):
        return encdec.decode_step(params, tokens, caches)

    def prefill(params, batch):
        """Audio prefill: encode the frames, run the decoder over the
        tokens → last-token logits."""
        enc_out = encdec.encode(params, batch["frames"])
        hidden = encdec.decode_train(params, batch["tokens"], enc_out)
        return encdec.logits(params, hidden[:, -1:])[:, 0]

    return ModelBundle(cfg, device, init, _loss, init_cache, decode, prefill)
