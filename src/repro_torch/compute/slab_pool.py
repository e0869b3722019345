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

A first touch takes one of two paths, chosen by what the slab lies in:

* direct: the slab lies in a pinned ``HostSlot`` (the sync ``BucketCache``
  of a CUDA join). One ``non_blocking`` copy goes straight from the slot
  into a fresh device tensor, on a copy stream the pool owns; an event
  recorded after it becomes the slot's ``copy_done`` guard (the cache
  refills the slot only once it has passed), and the current stream waits
  on that event on the device before anything reads the slab. The copy
  sits on its own stream because on the current stream it would queue
  behind the batch in flight, and a slot refilled before that batch ends
  would block the host on the kernels. The device tensor is allocated on
  the copy stream and ``record_stream``-ed on the current one, so the
  caching allocator never hands its block out again while a queued kernel
  reads it.
* staged: any other slab (the prefetch ``BufferPool``, the superstep
  join's cache, the CPU) goes through ``repro_torch.device.to_device``: a
  pinned staging copy and a ``non_blocking`` copy on the current stream.
  Every consumer runs on that same stream, so dropping the pool's
  reference at eviction is safe.

The host side of a first touch is traced as an ``h2d.stage`` span (args
``bucket``, ``bytes``, ``direct``); a hit records nothing.

Counters match the JAX package's pool event for event: ``h2d_transfers``
and ``h2d_bytes`` at each first touch, ``device_slab_hits`` and
``h2d_transfers_saved`` at each later reference; ``h2d_direct`` and
``h2d_staged`` split the first touches by path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.obs import NOOP_SPAN


class HostSlot:
    """One slot of a host cache's slab arena: a padded (capacity, dim)
    float32 slab (``host``, a tensor; ``vecs``, its numpy view) and its
    int64 id sidecar. ``pinned`` says the slab lies in page-locked memory,
    which the device pool copies from directly; ``copy_done`` is the event
    the pool records after each such copy (None before the first: one
    event a slot serves, since a slot is copied again only after a refill,
    which waits for the last copy). ``refs`` counts the residency and each
    pending verify batch's checkout; ``live`` the rows its cache last wrote
    (those past it hold pad rows)."""

    __slots__ = ("host", "vecs", "ids", "pinned", "refs", "copy_done",
                 "live")

    def __init__(self, host: torch.Tensor, ids: np.ndarray, pinned: bool):
        self.host = host
        self.vecs = host.numpy()
        self.ids = ids
        self.pinned = pinned
        self.refs = 0
        self.copy_done = None
        self.live = 0


class DeviceSlabPool:
    """bucket id → device-resident (capacity, dim) float32 tensor."""

    def __init__(self, device: torch.device, stats=None, on_transfer=None,
                 tracer=None):
        self.device = device
        self._slabs: dict[int, torch.Tensor] = {}
        self.stats = stats
        self.tracer = tracer
        self.on_transfer = on_transfer  # e.g. emulated-link charge (bytes)
        self._copy_stream = None  # made at the first direct copy
        self.transfers = 0       # H2D slab transfers (== residencies used)
        self.direct = 0          # ... of which copied from a pinned slot
        self.hits = 0            # operand lookups served pool-resident
        self.h2d_bytes = 0

    def __contains__(self, b: int) -> bool:
        return b in self._slabs

    @property
    def resident(self) -> int:
        return len(self._slabs)

    def operand(self, b: int, host_vecs: np.ndarray,
                slot=None) -> torch.Tensor:
        """Device tensor for bucket ``b``: the resident one, or — on this
        residency's first touch — a fresh copy of ``host_vecs`` (the
        bucket's full padded slab, only read on a miss). ``slot``: the
        cache entry's slot handle; a pinned ``HostSlot`` holding
        ``host_vecs`` takes the direct copy."""
        dev = self._slabs.get(b)
        if dev is not None:
            self.hits += 1
            if self.stats is not None:
                self.stats.add("device_slab_hits", 1)
                self.stats.add("h2d_transfers_saved", 1)
            return dev
        direct = isinstance(slot, HostSlot) and slot.pinned
        host = np.asarray(host_vecs, np.float32)
        nbytes = int(host.nbytes)
        with (self.tracer.span("h2d.stage", bucket=b, bytes=nbytes,
                               direct=int(direct))
              if self.tracer is not None else NOOP_SPAN):
            dev = (self._copy_from_slot(slot) if direct
                   else to_device(host, self.device))
        self._slabs[b] = dev
        self.transfers += 1
        self.direct += direct
        self.h2d_bytes += nbytes
        if self.stats is not None:
            self.stats.add("h2d_transfers", 1)
            self.stats.add("h2d_direct" if direct else "h2d_staged", 1)
            self.stats.add("h2d_bytes", nbytes)
        if self.on_transfer is not None:
            self.on_transfer(nbytes)
        return dev

    def _copy_from_slot(self, slot: HostSlot) -> torch.Tensor:
        # set_stream and one reused event a slot, not the stream context
        # manager and a fresh event: half the host time of a first touch
        # (~50 against ~110 µs, an H100's host)
        compute = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        if slot.copy_done is None:
            slot.copy_done = torch.cuda.Event()
        torch.cuda.set_stream(self._copy_stream)
        try:
            dev = slot.host.to(self.device, non_blocking=True)
            slot.copy_done.record(self._copy_stream)
        finally:
            torch.cuda.set_stream(compute)
        compute.wait_event(slot.copy_done)
        dev.record_stream(compute)
        return dev

    def evict(self, b: int) -> None:
        """Mirror a host-cache eviction; the next residency transfers
        afresh."""
        self._slabs.pop(b, None)

    def clear(self) -> None:
        self._slabs.clear()
