"""Fixed slab pool with pin/unpin refcounting (no hot-path allocation).

All bucket I/O lands in one preallocated arena of ``num_slabs`` padded
``(capacity_rows, dim)`` float32 slabs (plus int64 id sidecars). A slab's
lifecycle:

    acquire() ── refcount 1 (cache residency) ──▶ in use
       pin()  ── +1 per pending verify batch reference
       unpin()── -1; at zero the slab returns to the free list

``acquire`` blocks when the pool is exhausted — this is the backpressure
that bounds the prefetcher's memory: it can run at most
(num_slabs - residents) bucket reads ahead of the executor.

Thread model: the prefetch issue thread acquires; worker threads fill the
slab arrays (each slot is owned by exactly one in-flight read); the
executor thread pins/unpins. All bookkeeping is under one condition lock.
"""
from __future__ import annotations

import threading

import numpy as np


class BufferPool:
    def __init__(self, num_slabs: int, capacity_rows: int, dim: int,
                 dtype=np.float32):
        if num_slabs < 1:
            raise ValueError("pool needs at least one slab")
        self.num_slabs = int(num_slabs)
        self.capacity_rows = int(capacity_rows)
        self.dim = int(dim)
        self._vecs = np.empty((num_slabs, capacity_rows, dim), dtype)
        self._ids = np.empty((num_slabs, capacity_rows), np.int64)
        self._refs = [0] * num_slabs
        self._free = list(range(num_slabs - 1, -1, -1))
        self._cond = threading.Condition()
        self._closed = False
        self.max_in_use = 0
        self.acquires = 0
        self.blocked_acquires = 0  # acquires that had to wait (backpressure)

    # -- slab memory ---------------------------------------------------------
    def vecs(self, slot: int) -> np.ndarray:
        return self._vecs[slot]

    def ids(self, slot: int) -> np.ndarray:
        return self._ids[slot]

    @property
    def nbytes(self) -> int:
        return self._vecs.nbytes + self._ids.nbytes

    @property
    def in_use(self) -> int:
        with self._cond:
            return self.num_slabs - len(self._free)

    def refcount(self, slot: int) -> int:
        with self._cond:
            return self._refs[slot]

    # -- lifecycle -----------------------------------------------------------
    def _take_free(self) -> int:
        """Pop a free slab at refcount 1 (caller holds the lock)."""
        slot = self._free.pop()
        self._refs[slot] = 1
        self.max_in_use = max(self.max_in_use,
                              self.num_slabs - len(self._free))
        return slot

    def acquire(self, timeout: float | None = None,
                cancelled=None) -> int:
        """Take a free slab (refcount 1). Blocks while the pool is empty.

        ``acquires`` counts attempts (blocking and non-blocking alike).
        ``cancelled`` (zero-arg callable) supports shared pools that outlive
        any one consumer: a waiter polls it and aborts with ``RuntimeError``
        when it returns True, instead of requiring the whole pool to close.
        """
        with self._cond:
            self.acquires += 1
            if not self._free:
                self.blocked_acquires += 1
            while not self._free and not self._closed:
                if cancelled is not None:
                    if cancelled():
                        raise RuntimeError("buffer pool acquire cancelled")
                    self._cond.wait(timeout=0.05)
                elif not self._cond.wait(timeout=timeout):
                    raise TimeoutError("buffer pool exhausted "
                                       f"({self.num_slabs} slabs, all pinned)")
            if self._closed:
                raise RuntimeError("buffer pool closed")
            return self._take_free()

    def try_acquire(self) -> int | None:
        """Non-blocking acquire: a free slab (refcount 1) or None.

        The batched-submission path uses this for every slab after a
        group's first — extending a batch must never block while holding
        already-acquired slabs (liveness), so exhaustion simply caps the
        batch size instead of waiting.
        """
        with self._cond:
            self.acquires += 1
            if self._closed or not self._free:
                return None
            return self._take_free()

    def pin(self, slot: int) -> None:
        """Add a reference; only legal on a live (already-acquired) slab."""
        with self._cond:
            if self._refs[slot] <= 0:
                raise RuntimeError(f"pin on free slab {slot}")
            self._refs[slot] += 1

    def unpin(self, slot: int) -> None:
        """Drop a reference; at zero the slab becomes reusable."""
        with self._cond:
            if self._refs[slot] <= 0:
                raise RuntimeError(f"unpin under-run on slab {slot}")
            self._refs[slot] -= 1
            if self._refs[slot] == 0:
                self._free.append(slot)
                self._cond.notify_all()

    def kick(self) -> None:
        """Wake blocked acquirers so they re-check their ``cancelled``
        callback — used when a consumer of a *shared* pool shuts down
        without closing the pool for everyone else."""
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        """Unblock any waiter; further acquires fail."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
