"""Straggler detection & mitigation (DESIGN §6); a copy of the JAX
package's ``runtime/straggler.py`` (numpy only).

``StepTimer`` — per-step EWMA + outlier detection on the training loop.
``HostMonitor`` — fleet view: per-host step-duration EWMAs, quarantine
policy for hosts persistently slower than the fleet median (at pod scale,
one slow host gates every synchronous collective).

For DiskJoin's executor, mitigation is cheap: edge tasks are independent,
so ``rebalance_edges`` moves queued edges from quarantined hosts to healthy
ones (no recompute, no checkpoint restore).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np


class StepTimer:
    def __init__(self, alpha: float = 0.1, outlier_factor: float = 2.5):
        self.alpha = alpha
        self.outlier_factor = outlier_factor
        self.ewma = None
        self.count = 0
        self.outliers = 0
        self._all: list[float] = []

    def record(self, seconds: float) -> bool:
        """Returns True if this step was an outlier (straggle event)."""
        self._all.append(seconds)
        self.count += 1
        if self.ewma is None:
            self.ewma = seconds
            return False
        is_outlier = seconds > self.outlier_factor * self.ewma
        if is_outlier:
            self.outliers += 1
        else:  # outliers don't poison the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return is_outlier

    @property
    def mean_ms(self) -> float:
        return 1000 * float(np.mean(self._all)) if self._all else 0.0

    def report(self) -> dict:
        if not self._all:
            return {}
        arr = np.asarray(self._all)
        return {
            "steps": self.count,
            "mean_ms": 1000 * float(arr.mean()),
            "p50_ms": 1000 * float(np.percentile(arr, 50)),
            "p99_ms": 1000 * float(np.percentile(arr, 99)),
            "outliers": self.outliers,
        }


@dataclasses.dataclass
class HostStats:
    ewma: float = 0.0
    steps: int = 0
    quarantined: bool = False


class HostMonitor:
    """Fleet-level straggler policy: quarantine hosts whose EWMA exceeds
    ``threshold ×`` the fleet median for ``patience`` consecutive checks."""

    def __init__(self, threshold: float = 1.5, patience: int = 3,
                 alpha: float = 0.2):
        self.threshold = threshold
        self.patience = patience
        self.alpha = alpha
        self.hosts: dict[str, HostStats] = defaultdict(HostStats)
        self._strikes: dict[str, int] = defaultdict(int)

    def record(self, host: str, seconds: float) -> None:
        st = self.hosts[host]
        st.ewma = seconds if st.steps == 0 else \
            (1 - self.alpha) * st.ewma + self.alpha * seconds
        st.steps += 1

    def evaluate(self) -> list[str]:
        """Run the policy; returns newly quarantined hosts."""
        active = {h: s for h, s in self.hosts.items() if not s.quarantined}
        if len(active) < 2:
            return []
        median = float(np.median([s.ewma for s in active.values()]))
        newly = []
        for h, s in active.items():
            if s.ewma > self.threshold * median:
                self._strikes[h] += 1
                if self._strikes[h] >= self.patience:
                    s.quarantined = True
                    newly.append(h)
            else:
                self._strikes[h] = 0
        return newly

    def healthy_hosts(self) -> list[str]:
        return [h for h, s in self.hosts.items() if not s.quarantined]


def rebalance_edges(assignment: dict[str, list], quarantined: list[str],
                    healthy: list[str]) -> dict[str, list]:
    """Move pending join-edge tasks off quarantined hosts, round-robin."""
    if not healthy:
        raise RuntimeError("no healthy hosts to rebalance onto")
    out = {h: list(v) for h, v in assignment.items() if h not in quarantined}
    moved = [e for h in quarantined for e in assignment.get(h, [])]
    for i, e in enumerate(moved):
        out.setdefault(healthy[i % len(healthy)], []).append(e)
    return out
