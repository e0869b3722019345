"""Device-resident bucket slab pool: one H2D transfer per cache residency.

The host cache already guarantees each bucket is *read* once per cache
residency; this pool extends the same discipline one hop down the
pipeline: each bucket slab crosses H2D ONCE per residency, and every edge
that touches the bucket while it stays resident verifies against the
already-resident device tensor instead of re-staging the slab. Eviction
mirrors the host cache schedule (the executor forwards its scheduled
``evict`` calls), so device memory tracks the same Belady-bounded working
set the host budget allows; a re-load after eviction is a new residency
and pays one new transfer.

The transfer is queued at first touch (``repro_torch.device.to_device``:
pinned staging copy, ``non_blocking`` copy on the current stream), so it
never blocks the host behind the batch in flight. Its host side is traced
as an ``h2d.stage`` span (args ``bucket``, ``bytes``); a hit records
nothing. Lifetime: every consumer runs on that same stream, so dropping
the pool's reference at eviction is safe — the caching allocator reuses
the memory only for work queued after the batches that read it. A copy on
a side stream would need ``record_stream`` or an event wait; this pool
uses none.

Counters match the JAX package's pool event for event: ``h2d_transfers``
and ``h2d_bytes`` at each first touch, ``device_slab_hits`` and
``h2d_transfers_saved`` at each later reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.obs import NOOP_SPAN


class DeviceSlabPool:
    """bucket id → device-resident (capacity, dim) float32 tensor."""

    def __init__(self, device: torch.device, stats=None, on_transfer=None,
                 tracer=None):
        self.device = device
        self._slabs: dict[int, torch.Tensor] = {}
        self.stats = stats
        self.tracer = tracer
        self.on_transfer = on_transfer  # e.g. emulated-link charge (bytes)
        self.transfers = 0       # H2D slab transfers (== residencies used)
        self.hits = 0            # operand lookups served pool-resident
        self.h2d_bytes = 0

    def __contains__(self, b: int) -> bool:
        return b in self._slabs

    @property
    def resident(self) -> int:
        return len(self._slabs)

    def operand(self, b: int, host_vecs: np.ndarray) -> torch.Tensor:
        """Device tensor for bucket ``b``: the resident one, or — on this
        residency's first touch — a fresh copy of ``host_vecs`` (the
        bucket's full padded slab, only read on a miss)."""
        dev = self._slabs.get(b)
        if dev is not None:
            self.hits += 1
            if self.stats is not None:
                self.stats.add("device_slab_hits", 1)
                self.stats.add("h2d_transfers_saved", 1)
            return dev
        host = np.asarray(host_vecs, np.float32)
        with (self.tracer.span("h2d.stage", bucket=b, bytes=int(host.nbytes))
              if self.tracer is not None else NOOP_SPAN):
            dev = to_device(host, self.device)
        self._slabs[b] = dev
        self.transfers += 1
        self.h2d_bytes += int(host.nbytes)
        if self.stats is not None:
            self.stats.add("h2d_transfers", 1)
            self.stats.add("h2d_bytes", int(host.nbytes))
        if self.on_transfer is not None:
            self.on_transfer(int(host.nbytes))
        return dev

    def evict(self, b: int) -> None:
        """Mirror a host-cache eviction; the next residency transfers
        afresh."""
        self._slabs.pop(b, None)

    def clear(self) -> None:
        self._slabs.clear()
