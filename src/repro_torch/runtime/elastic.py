"""Elastic scaling: heartbeat registry + mesh (re)planning (DESIGN §6); a
copy of the JAX package's ``runtime/elastic.py`` (plain Python).

On hardware loss the job must restart on fewer hosts without human input:
  1. ``HeartbeatRegistry`` notices missing heartbeats (federated in real
     deployments; in-process here, same policy),
  2. ``plan_mesh`` picks the largest (pod, data, model) factorization the
     surviving chip count and the architecture's divisibility admit,
  3. the checkpoint layer restores host-complete arrays re-sharded onto the
     new mesh (``restore_latest(..., shardings=new)``) and the data
     pipeline rescales its host slices (pure function of step — no
     coordination needed).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class MeshPlan:
    pod: int
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    def axes(self) -> tuple:
        if self.pod > 1:
            return ((self.pod, self.data, self.model),
                    ("pod", "data", "model"))
        return ((self.data, self.model), ("data", "model"))


def plan_mesh(available_chips: int, *, global_batch: int,
              preferred_model: int = 16, chips_per_pod: int = 256,
              min_model: int = 1) -> Optional[MeshPlan]:
    """Largest usable (pod, data, model) plan under divisibility rules.

    model: largest power of two ≤ preferred_model (TP degree stays MXU
    friendly); data: what's left per pod, must divide global_batch.
    """
    if available_chips < 1:
        return None
    pods = max(1, available_chips // chips_per_pod)
    best: Optional[MeshPlan] = None
    while pods >= 1:
        chips = min(available_chips, pods * chips_per_pod) // pods
        model = 1 << (preferred_model.bit_length() - 1)
        while model >= min_model:
            # largest data ≤ chips/model with batch divisibility — a
            # non-divisor chip count shrinks data rather than failing
            data = chips // model
            while data >= 1 and (global_batch % (data * pods)) != 0:
                data -= 1
            if data >= 1:
                cand = MeshPlan(pod=pods, data=data, model=model)
                if best is None or cand.chips > best.chips:
                    best = cand
            model //= 2
        pods -= 1
    return best


class HeartbeatRegistry:
    """Host liveness by heartbeat timeout."""

    def __init__(self, timeout_s: float = 60.0, clock=time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last: dict[str, float] = {}
        self._chips: dict[str, int] = {}

    def heartbeat(self, host: str, chips: int = 4) -> None:
        self._last[host] = self._clock()
        self._chips[host] = chips

    def live_hosts(self) -> list[str]:
        now = self._clock()
        return [h for h, t in self._last.items()
                if now - t <= self.timeout_s]

    def dead_hosts(self) -> list[str]:
        now = self._clock()
        return [h for h, t in self._last.items() if now - t > self.timeout_s]

    def live_chips(self) -> int:
        return sum(self._chips[h] for h in self.live_hosts())


@dataclasses.dataclass
class ElasticEvent:
    kind: str          # "shrink" | "grow" | "steady"
    old_plan: Optional[MeshPlan]
    new_plan: Optional[MeshPlan]


class ElasticController:
    """Decides when to re-mesh. Shrinks immediately on failure; grows only
    past hysteresis (re-meshing costs a checkpoint restore)."""

    def __init__(self, registry: HeartbeatRegistry, *, global_batch: int,
                 grow_hysteresis: float = 1.25):
        self.registry = registry
        self.global_batch = global_batch
        self.grow_hysteresis = grow_hysteresis
        self.plan: Optional[MeshPlan] = None

    def evaluate(self) -> ElasticEvent:
        chips = self.registry.live_chips()
        new = plan_mesh(chips, global_batch=self.global_batch)
        old = self.plan
        if old is None:
            self.plan = new
            return ElasticEvent("grow" if new else "steady", old, new)
        if new is None or new.chips < old.chips:
            self.plan = new
            return ElasticEvent("shrink", old, new)
        if new.chips >= old.chips * self.grow_hysteresis:
            self.plan = new
            return ElasticEvent("grow", old, new)
        return ElasticEvent("steady", old, old)
