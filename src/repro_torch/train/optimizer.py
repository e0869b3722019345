"""AdamW with float32 moments, global-norm clipping, and a hook for
gradient compression: a port of the JAX package's ``train/optimizer.py``
with its arithmetic (not ``torch.optim.AdamW``'s).

The state mirrors the parameters by name: ``{"mu": {name: float32},
"nu": {name: float32}, "step": int}`` (and ``"error"`` under a gradient
transform). As in the reference: the global-norm clip scales the gradient
before the moments; the step is mhat / (sqrt(nhat) + eps) plus the weight
decay times the parameter; the float32 result is cast to the parameter's
dtype; a parameter without a gradient (the reference's zeros: an untied
``lm_head`` under its loss) still decays. Where the reference returns new
trees, ``update`` writes the parameters and the moments in place, under
``torch.no_grad()``: the optimizer state is the largest thing training
keeps, and a second copy of it would not fit beside the model on one card
at full width. Sharded parameters (``dist.sharding.ShardedParams``) update
their parts; the clip's global norm is then summed over the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup → cosine decay, in float32 as the reference computes
    it (a host float: the schedule needs no device)."""
    step = F32(step)
    warm = np.minimum(step / F32(max(cfg.warmup_steps, 1)), F32(1.0))
    prog = np.clip((step - F32(cfg.warmup_steps))
                   / F32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   F32(0.0), F32(1.0))
    cos = F32(0.5) * (F32(1.0) + np.cos(F32(np.pi) * prog))
    return float(F32(cfg.learning_rate) * warm
                 * (F32(cfg.min_lr_ratio) + F32(1 - cfg.min_lr_ratio) * cos))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (a 0-d tensor
    on the tensors' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tensors))


def named(params) -> dict[str, torch.Tensor]:
    """A model's parameters by name (a dict of tensors stays as it is; a
    ``dist.sharding.ShardedParams`` gives this rank's parts)."""
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


@dataclasses.dataclass
class AdamW:
    cfg: AdamWConfig
    # optional gradient transform (e.g. int8 compression w/ error feedback):
    # (grads by name, error by name) → (grads, new error)
    grad_transform: Optional[Callable[[Any, Any], tuple[Any, Any]]] = None

    def init(self, params) -> dict:
        def zeros():
            return {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in named(params).items()}
        state = {"mu": zeros(), "nu": zeros(), "step": 0}
        if self.grad_transform is not None:
            state["error"] = zeros()
        return state

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params):
        """One step: ``grads`` by parameter name (a missing or None entry is
        a zero gradient) → (params, state, {"grad_norm", "lr"}), the
        parameters and the state updated in place."""
        c = self.cfg
        ps = named(params)
        step = state["step"] + 1
        grads = {n: grads[n] if grads.get(n) is not None
                 else torch.zeros_like(p) for n, p in ps.items()}
        if self.grad_transform is not None:
            grads, state["error"] = self.grad_transform(grads,
                                                        state["error"])
        # sharded parameters: the norm over every part of the mesh
        gnorm = (params.grad_norm(grads) if hasattr(params, "grad_norm")
                 else global_norm(grads.values()))
        scale = torch.clamp_max(c.clip_norm / (gnorm + 1e-9), 1.0)
        lr = lr_schedule(c, step)
        b1t = float(F32(1.0) - F32(c.b1) ** F32(step))
        b2t = float(F32(1.0) - F32(c.b2) ** F32(step))
        for n, p in ps.items():
            g = grads[n].to(torch.float32) * scale
            mu, nu = state["mu"][n], state["nu"][n]
            mu.mul_(c.b1).add_(g * (1 - c.b1))
            nu.mul_(c.b2).add_(g * (1 - c.b2) * g)
            delta = (mu / b1t) / (torch.sqrt(nu / b2t) + c.eps)
            delta = delta + c.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}
