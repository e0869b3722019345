"""Batched serving engine — wave (iteration-level) batching. Port of the JAX
package's ``serve/engine.py``.

Requests are drained in *waves*: up to ``slots`` queued requests with equal
prompt length form a wave (equal lengths share one cache timeline — the
per-layer rolling caches track one absolute position stream). Each wave:

  1. batched prompt fill: one decode step per prompt token, whole wave at
     once (cache build == the serving prefill path);
  2. batched greedy generation until every member hits EOS/max-new-tokens.

One decode step, (slots, 1) tokens, serves prefill and generation. It runs
eagerly under ``torch.inference_mode()``; the host reads the device once
per generated step (the argmax) and once after the prompt fill, as the
reference does. Mixed prompt lengths queue into separate waves. Every
decoder-only family is served (dense, MoE, SSM, hybrid; a VLM takes token
prompts only), each wave on a fresh cache of each layer's kind. Enc-dec
models are served through their bundle (``encode``, then ``decode``), as
in the JAX package, whose engine is decoder-only too.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import build_model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)


class ServeEngine:
    """Wave-batched engine for decoder-only archs. ``params`` is an ``LM``
    on ``device`` (``None`` = CUDA); without one, the weights are made from
    ``seed``."""

    def __init__(self, cfg: ArchConfig, *, slots: int = 4,
                 max_seq: int = 512, params=None, seed: int = 0,
                 device=None):
        if cfg.enc_dec:
            raise ValueError(f"{cfg.name} is enc-dec: serve it through its "
                             f"bundle (encode, then decode)")
        self.cfg = cfg
        self.bundle = build_model(cfg, device=device)
        self.device = self.bundle.device
        self.slots = slots
        self.max_seq = max_seq
        if params is None:
            params = self.bundle.init(seed)
        elif params.device.type != self.device.type:
            raise ValueError(f"params lie on {params.device}, the engine "
                             f"runs on {self.device}")
        self.params = params
        self._decode = self.bundle.decode
        self._queue: deque[Request] = deque()
        self._uid = 0
        self.stats = {"waves": 0, "steps": 0, "requests": 0}

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> int:
        self._uid += 1
        self._queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                                   max_new_tokens, eos_id))
        return self._uid

    def run(self, max_steps: int = 100_000) -> dict[int, list[int]]:
        results: dict[int, list[int]] = {}
        budget = max_steps
        with torch.inference_mode():
            while self._queue and budget > 0:
                wave = self._next_wave()
                budget -= self._run_wave(wave, results, budget)
        return results

    # -- internals -----------------------------------------------------------
    def _next_wave(self) -> list[Request]:
        """Pop up to ``slots`` queued requests sharing the first request's
        prompt length (equal lengths share a cache timeline)."""
        first = self._queue.popleft()
        wave = [first]
        plen = len(first.prompt)
        rest = deque()
        while self._queue and len(wave) < self.slots:
            r = self._queue.popleft()
            if len(r.prompt) == plen:
                wave.append(r)
            else:
                rest.append(r)
        self._queue.extendleft(reversed(rest))
        return wave

    def _argmax(self, logits: torch.Tensor) -> np.ndarray:
        return torch.argmax(logits, dim=-1).cpu().numpy()  # the host read

    def _run_wave(self, wave: list[Request],
                  results: dict[int, list[int]], budget: int) -> int:
        b = self.slots
        plen = len(wave[0].prompt)
        caches = self.bundle.init_cache(b, self.max_seq)
        tokens = np.zeros((b, plen), np.int32)
        for i, req in enumerate(wave):
            tokens[i] = req.prompt
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        steps = 0

        # 1) prompt fill — batched decode over prompt tokens
        logits = None
        for t in range(plen):
            logits, caches = self._decode(self.params, tokens[:, t:t + 1],
                                          caches)
            steps += 1
        nxt = self._argmax(logits)
        for i, req in enumerate(wave):
            req.generated.append(int(nxt[i]))

        # 2) generation — batched greedy until the wave drains
        active = np.ones(b, bool)
        active[len(wave):] = False
        while active.any() and steps < budget:
            cur = np.zeros((b, 1), np.int32)
            for i, req in enumerate(wave):
                cur[i, 0] = req.generated[-1]
            logits, caches = self._decode(self.params, cur, caches)
            steps += 1
            nxt = self._argmax(logits)
            for i, req in enumerate(wave):
                if not active[i]:
                    continue
                req.generated.append(int(nxt[i]))
                done = (len(req.generated) >= req.max_new_tokens
                        or (req.eos_id is not None
                            and nxt[i] == req.eos_id))
                if done:
                    active[i] = False
                    results[req.uid] = req.generated[:req.max_new_tokens]
        for req in wave:  # budget exhaustion still returns partials
            results.setdefault(req.uid, req.generated)
        self.stats["waves"] += 1
        self.stats["steps"] += steps
        self.stats["requests"] += len(wave)
        return steps
