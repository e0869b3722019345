"""The step functions: a port of the JAX package's ``launch/steps.py``.

``make_train_step``: loss → gradients → AdamW update, one call.
``make_serve_step``: one decode step against the caches.
``prepare_cell``: one (arch × shape) cell's step and its arguments on one
card, the counterpart of the reference's ``lower_cell``.

The reference's functions are pure and jitted, with donated buffers; these
run eagerly and update the parameters, the optimizer state and the caches
in place. ``lower_cell`` lowers a cell on an abstract mesh without
allocating; ``prepare_cell`` allocates the cell on the card, since the
census (``launch/census.py``) runs it. The reference's sharding trees
(``batch_shardings``, ``cache_shardings``, ``opt_state_shardings``) place
a cell on a mesh of many chips and wait for the multi-process slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.model_api import ModelBundle, fill_inputs
from repro_torch.train.optimizer import AdamW, AdamWConfig

# the reference's single pod: 16 × 16 chips share a cell's global batch
POD_CHIPS = 256


def make_train_step(bundle: ModelBundle, opt: AdamW):
    """train_step(params, opt_state, batch) → (params, opt_state, metrics):
    the loss and its gradient with respect to every parameter (the
    parameters are set to require grad here: they are built without), then
    ``opt.update``. Metrics: the loss's own ("nll", "aux"), "grad_norm",
    "lr" and "loss", as 0-d tensors or floats, read by the caller."""

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        names, tensors = zip(*params.named_parameters())
        with torch.enable_grad():
            loss, metrics = bundle.loss(params, batch)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        params, opt_state, opt_metrics = opt.update(
            dict(zip(names, grads)), opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_serve_step(bundle: ModelBundle):
    """serve_step(params, caches, tokens) → (logits, caches), under
    ``torch.inference_mode`` (no graph, nothing saved)."""

    def serve_step(params, caches, tokens):
        with torch.inference_mode():
            return bundle.decode(params, tokens, caches)

    return serve_step


def per_card_batch(shape: ShapeSpec) -> int:
    """Sequences one card runs: the reference's 16 × 16 pod's share of a
    chip, ``global_batch // 256``, and one whole sequence where the pod
    gives a chip less than one."""
    return max(1, shape.global_batch // POD_CHIPS)


def _attn_caches(bundle: ModelBundle, caches) -> list[dict]:
    """Every self-attention cache (dicts holding ``kpos``) of ``caches``."""
    layers = caches["self"] if bundle.cfg.enc_dec else caches
    return [c for c in layers if "kpos" in c]


def fill_cache_positions(bundle: ModelBundle, caches, pos: int) -> None:
    """Set the caches as if positions 0 .. pos − 1 had been decoded: each
    attention cache's rolling slots hold the latest position ≡ slot (mod
    its length), and the next write lands at ``pos``. The keys and values
    stay as allocated (zeros): a step's work does not depend on them."""
    for c in _attn_caches(bundle, caches):
        steps = c["kpos"].shape[0]
        slot = torch.arange(steps, dtype=torch.int64)
        last = slot + steps * torch.div(pos - 1 - slot, steps,
                                        rounding_mode="floor")
        c["kpos"].copy_(torch.where(slot < pos, last, -1).to(torch.int32))
    _reset_positions(bundle, caches, pos)


def _reset_positions(bundle: ModelBundle, caches, pos: int) -> None:
    """The next write of every attention cache lands at ``pos``."""
    for c in _attn_caches(bundle, caches):
        c["pos"] = pos
    if bundle.cfg.enc_dec:
        caches["pos"] = pos


def prepare_cell(bundle: ModelBundle, shape: ShapeSpec, *, device=None,
                 generator: torch.Generator):
    """One cell on one card → (step, args, {"kind": ...}): ``step(*args)``
    runs the cell's step once (repeatable).

    The batch is ``per_card_batch`` sequences, filled from ``generator``
    by ``fill_inputs``; the parameters are seeded from it too.

    * ``train``: ``make_train_step`` with a fresh ``AdamW`` (the default
      config) → ``"train_step"``; each call updates the parameters and
      the optimizer state in place.
    * ``prefill``: ``bundle.prefill`` under ``torch.inference_mode`` →
      ``"prefill_step"``.
    * ``decode``: one token against caches of the full ``seq_len``, set by
      ``fill_cache_positions`` as if ``seq_len`` − 1 positions had been
      decoded, so the step attends to the whole cache; each call first
      resets the positions, so every call is that same last step →
      ``"serve_step"``. Enc-dec caches carry zero cross-attention K/V over
      the encoder's frames, as the reference's cache stand-ins do.

    ``device``, where given, must be the bundle's."""
    if device is not None and torch.device(device).type != \
            bundle.device.type:
        raise ValueError(f"bundle lives on {bundle.device}, not {device}")
    cfg = bundle.cfg
    run = dataclasses.replace(shape, global_batch=per_card_batch(shape))
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
    params = bundle.init(seed)
    batch = fill_inputs(bundle.input_specs(run), cfg.vocab, generator,
                        bundle.device)
    if shape.kind == "train":
        opt = AdamW(AdamWConfig())
        return (make_train_step(bundle, opt),
                (params, opt.init(params), batch), {"kind": "train_step"})
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with torch.inference_mode():
                return bundle.prefill(params, batch)
        return prefill_step, (params, batch), {"kind": "prefill_step"}
    b, pos = run.global_batch, run.seq_len - 1
    if cfg.enc_dec:
        caches = bundle.init_cache(b, run.seq_len, params=params)
    else:
        caches = bundle.init_cache(b, run.seq_len)
    fill_cache_positions(bundle, caches, pos)
    serve = make_serve_step(bundle)

    def serve_step(params, caches, tokens):
        _reset_positions(bundle, caches, pos)
        return serve(params, caches, tokens)

    return serve_step, (params, caches, batch["tokens"]), \
        {"kind": "serve_step"}
