"""Cache management (paper §4.2, Alg. 1) — Belady + baseline policies.

Given the full bucket access sequence S (known offline — this is what makes
Belady legal here), we simulate cache behaviour and emit a *schedule*: for
every access, hit/miss and the victim to evict on miss. The executor replays
the schedule against real storage; the simulator is also used standalone for
the Fig. 17 ablation.

One deviation from the textbook statement of Alg. 1: the executor needs both
endpoints of the in-flight edge resident simultaneously, so eviction skips
*pinned* buckets (the current access's partner). Belady's optimality
argument is unaffected — the pinned bucket is the next access, i.e. the one
with the *smallest* next-access index, which Belady would never pick anyway;
for the baseline policies it is a correctness guard.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict, defaultdict

import numpy as np

INF = np.iinfo(np.int64).max


@dataclasses.dataclass
class CacheSchedule:
    """Replayable cache decisions for an access sequence."""

    hits: int
    misses: int
    loads: int
    actions: list  # per access: (bucket, is_hit, victim_or_None)

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


def _next_access_table(seq: np.ndarray, num_buckets: int):
    """P[b] = list of access indices of bucket b (Alg. 1 lines 4–5)."""
    P: list[list[int]] = [[] for _ in range(num_buckets)]
    for i, b in enumerate(seq):
        P[int(b)].append(i)
    return P


def simulate_belady(seq: np.ndarray, num_buckets: int, capacity: int,
                    pinned_partner: np.ndarray | None = None) -> CacheSchedule:
    """Alg. 1: max-heap over next-access indices, O(|S| log C)."""
    capacity = max(2, int(capacity))
    P = _next_access_table(seq, num_buckets)
    cnt = np.zeros(num_buckets, dtype=np.int64)  # accesses consumed per bucket
    cache: set[int] = set()
    heap: list[tuple[int, int]] = []  # (-next_access, bucket); lazy deletion
    next_key = np.full(num_buckets, -1, dtype=np.int64)

    def push(b: int) -> None:
        k = cnt[b]
        nxt = P[b][k] if k < len(P[b]) else INF
        next_key[b] = nxt
        heapq.heappush(heap, (-nxt, b))

    hits = misses = 0
    actions = []
    for i, b in enumerate(seq):
        b = int(b)
        cnt[b] += 1
        pin = int(pinned_partner[i]) if pinned_partner is not None else -1
        if b in cache:
            hits += 1
            push(b)  # refresh key to the new next access
            actions.append((b, True, None))
            continue
        misses += 1
        victim = None
        if len(cache) >= capacity:
            while True:
                negk, v = heapq.heappop(heap)
                if v in cache and -negk == next_key[v]:
                    if v == pin or v == b:
                        # pinned: re-push and take the next-furthest
                        spill = [(negk, v)]
                        while True:
                            negk2, v2 = heapq.heappop(heap)
                            if v2 in cache and -negk2 == next_key[v2] \
                                    and v2 != pin and v2 != b:
                                victim = v2
                                break
                            elif v2 in cache and -negk2 == next_key[v2]:
                                spill.append((negk2, v2))
                        for item in spill:
                            heapq.heappush(heap, item)
                        break
                    victim = v
                    break
            cache.discard(victim)
        cache.add(b)
        push(b)
        actions.append((b, False, victim))
    return CacheSchedule(hits=hits, misses=misses, loads=misses,
                         actions=actions)


def simulate_policy(seq: np.ndarray, num_buckets: int, capacity: int,
                    policy: str,
                    pinned_partner: np.ndarray | None = None
                    ) -> CacheSchedule:
    """Online policies for the ablation: lru / fifo / lfu."""
    capacity = max(2, int(capacity))
    if policy == "belady":
        return simulate_belady(seq, num_buckets, capacity, pinned_partner)
    lru: OrderedDict[int, None] = OrderedDict()
    load_time: dict[int, int] = {}
    freq: defaultdict[int, int] = defaultdict(int)
    cache: set[int] = set()
    hits = misses = 0
    actions = []
    for i, b in enumerate(seq):
        b = int(b)
        freq[b] += 1
        pin = int(pinned_partner[i]) if pinned_partner is not None else -1
        if b in cache:
            hits += 1
            if policy == "lru":
                lru.move_to_end(b)
            actions.append((b, True, None))
            continue
        misses += 1
        victim = None
        if len(cache) >= capacity:
            candidates = [v for v in cache if v != pin]
            if policy == "lru":
                for v in lru:
                    if v != pin:
                        victim = v
                        break
            elif policy == "fifo":
                victim = min(candidates, key=lambda v: load_time[v])
            elif policy == "lfu":
                victim = min(candidates, key=lambda v: (freq[v], load_time[v]))
            else:
                raise ValueError(f"unknown policy {policy!r}")
            cache.discard(victim)
            lru.pop(victim, None)
        cache.add(b)
        lru[b] = None
        load_time[b] = i
        actions.append((b, False, victim))
    return CacheSchedule(hits=hits, misses=misses, loads=misses,
                         actions=actions)


