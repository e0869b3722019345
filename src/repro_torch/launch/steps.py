"""The step functions: a port of the JAX package's ``launch/steps.py``.

``make_train_step``: loss → gradients → AdamW update, one call.
``make_serve_step``: one decode step against the caches.

The reference's functions are pure and jitted, with donated buffers; these
run eagerly and update the parameters, the optimizer state and the caches
in place. The reference's sharding trees and ``lower_cell`` serve its
dry-run lowering on a mesh and wait for that port (ROADMAP §1).
"""
from __future__ import annotations

import torch

from repro_torch.models.model_api import ModelBundle
from repro_torch.train.optimizer import AdamW


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
