"""Device/host/SSD cost model calibrated from pipeline telemetry.

Every planner decision reduces to comparing a handful of linear cost
terms: seconds per bucket read, seconds per byte across the host↔device
link, and seconds per candidate *cell* (one d² evaluation + threshold
test) on each verify path. This module owns those coefficients and where
they came from.

Calibration sources, in priority order (recorded per-coefficient in
``provenance`` so ``JoinPlan.explain()`` can say *why* a number was
believed):

1. **measured** — a live ``PipelineStats`` snapshot from the same index
   session: ``read_s / loads`` is the observed per-bucket read latency,
   ``h2d_bytes`` over transfer counts sanity-checks the link model.
2. **config** — the emulation knobs (``emulate_read_latency_s``,
   ``emulate_xfer_gb_s``) when set: the workload *will* pay these, so
   they beat any static default.
3. **static** — built-in fallbacks for a cold session with no telemetry,
   one set per device type (``CostModel.for_device``). On the CPU they are
   the JAX package's: host and device memory are one, so the static link
   bandwidth is 0 ("free") and the port's CPU plans equal the JAX
   package's decision for decision. On CUDA they are the card's own,
   measured by ``chip_smoke.py``'s ``[io]`` phase on an H100 (the
   provenance string names the card and its power limit): pinned-copy
   rates both ways and the per-cell and per-flush costs of both verify
   engines.

The host/device per-cell rates are static by design: the host path
evaluates d² and extracts pairs with NumPy at roughly kernel speed but
pays a full cap×cap mask + d² readback per edge, while the device path
fuses verify+compact (paying a small per-cell compaction overhead and a
larger fixed dispatch cost) and reads back only ``pairs × 12 B``. With a
free link the host path's simplicity wins; once the link is slow (real
PCIe, or ``emulate_xfer_gb_s``), shipping cap²·5 B of mask+d² per edge
loses badly to the device path's compacted readback — which is exactly
the flip the planner's host/device routing decision captures.
"""
from __future__ import annotations

import dataclasses

_STATIC_READ_S = 2e-4          # per-bucket read on a warm NVMe
_STATIC_HOST_CELL_NS = 1.0     # host verify+extract, per candidate cell
_STATIC_DEVICE_CELL_NS = 1.3   # fused verify+compact, per candidate cell
_STATIC_HOST_DISPATCH_S = 2e-5   # per host flush (python + BLAS entry)
_STATIC_DEVICE_DISPATCH_S = 3e-4  # per device dispatch (program call + sync)
_MASK_D2_BYTES = 5             # host readback per cell: bool mask + f32 d2
_PAIR_BYTES = 12               # device readback per pair: 2×i32 ids + f32 d

# CUDA statics, from chip_smoke.py's [io] calibration at the verify shape
# (32, 2048, 2048, 128). h2d: a pinned batch-sized copy (the host engine's
# staging); d2h: the host engine's d²/mask fetch into pageable memory. The
# per-cell costs are what is left of a measured flush once the model's
# link and dispatch terms are taken out, so the model reproduces the
# measured flush at that shape; the dispatch costs are flushes of one
# 64-row lane.
_CUDA_CALIBRATION = "static(NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py [io])"
_CUDA_STATIC = dict(
    h2d_gb_s=52.06,            # pinned, 32 MB (1 MB: 28.86)
    d2h_gb_s=2.230,            # pageable, 671 MB (pinned 1 MB: 31.44)
    host_cell_ns=3.143,        # flush 724.3 ms at the verify shape
    device_cell_ns=0.02901,    # flush 7.709 ms at the verify shape
    host_dispatch_s=2.555e-4,
    device_dispatch_s=9.936e-4,
)


@dataclasses.dataclass
class CostModel:
    """Linear cost coefficients + the provenance of each."""

    read_s_per_bucket: float = _STATIC_READ_S
    h2d_gb_s: float = 0.0          # 0 ⇒ free link (unified memory)
    d2h_gb_s: float = 0.0
    host_cell_ns: float = _STATIC_HOST_CELL_NS
    device_cell_ns: float = _STATIC_DEVICE_CELL_NS
    host_dispatch_s: float = _STATIC_HOST_DISPATCH_S
    device_dispatch_s: float = _STATIC_DEVICE_DISPATCH_S
    provenance: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def for_device(cls, device=None) -> "CostModel":
        """The static tier for ``device``: the JAX package's constants on
        the CPU (or with no device), the card's measured ones on CUDA."""
        dev_type = getattr(device, "type", device)
        if dev_type != "cuda":
            return cls(provenance={"read_s_per_bucket": "static",
                                   "link": "static(free)",
                                   "host_cell_ns": "static",
                                   "device_cell_ns": "static"})
        return cls(**_CUDA_STATIC, provenance={
            "read_s_per_bucket": "static", "link": _CUDA_CALIBRATION,
            "host_cell_ns": _CUDA_CALIBRATION,
            "device_cell_ns": _CUDA_CALIBRATION})

    @classmethod
    def from_telemetry(cls, config=None, pipeline: dict | None = None,
                       live: dict | None = None, *,
                       device=None) -> "CostModel":
        """Calibrate from a ``PipelineStats.snapshot()`` dict, the
        rolling span-derived constants of a ``repro_torch.obs.live``
        ``LiveCalibrator`` (its ``constants()`` dict, or the calibrator
        itself), and/or the session config's emulation knobs; static
        fallbacks otherwise.

        Per-coefficient priority is **measured > live > config >
        static**: a batch pipeline's own cumulative counters stay
        authoritative where they exist (per-bucket read), the live tier's
        windowed medians cover everything the counters can't see or that
        drifted since plan time (the link, a mid-run latency shift on a
        session passing windowed rather than cumulative telemetry), the
        emulation knobs predict what the workload *will* pay, and the
        static defaults catch a cold session. ``device`` picks the
        static tier (``for_device``): the JAX package's on the CPU, the
        card's on CUDA."""
        m = cls.for_device(device)
        prov = dict(m.provenance)
        if live is not None and hasattr(live, "constants"):
            live = live.constants()
        live = live or {}

        def live_tag(entry: dict) -> str:
            return (f"live({entry.get('samples', '?')} spans/"
                    f"{entry.get('windows', '?')} windows)")

        emu_read = float(getattr(config, "emulate_read_latency_s", 0.0)
                         or 0.0) if config is not None else 0.0
        live_read = live.get("read_s_per_bucket")
        if pipeline and pipeline.get("loads", 0) > 0 \
                and pipeline.get("read_s", 0.0) > 0.0:
            m.read_s_per_bucket = (pipeline["read_s"]
                                   / pipeline["loads"])
            prov["read_s_per_bucket"] = (
                f"measured({pipeline['loads']} loads)")
        elif live_read and live_read.get("value", 0.0) > 0.0:
            m.read_s_per_bucket = float(live_read["value"])
            prov["read_s_per_bucket"] = live_tag(live_read)
        elif emu_read > 0.0:
            m.read_s_per_bucket = emu_read
            prov["read_s_per_bucket"] = "config(emulate_read_latency_s)"
        emu_xfer = float(getattr(config, "emulate_xfer_gb_s", 0.0)
                         or 0.0) if config is not None else 0.0
        live_link = live.get("h2d_gb_s")
        if live_link and live_link.get("value", 0.0) > 0.0:
            # no counter measures the link, so live IS its top tier
            m.h2d_gb_s = m.d2h_gb_s = float(live_link["value"])
            prov["link"] = live_tag(live_link)
        elif emu_xfer > 0.0:
            m.h2d_gb_s = m.d2h_gb_s = emu_xfer
            prov["link"] = "config(emulate_xfer_gb_s)"
        m.provenance = prov
        return m

    # -- primitive terms --------------------------------------------------------
    def xfer_s(self, nbytes: float, gb_s: float) -> float:
        return nbytes / (gb_s * 1e9) if gb_s > 0.0 else 0.0

    def read_s(self, n_buckets: int) -> float:
        return n_buckets * self.read_s_per_bucket

    # -- per-edge verify costs ---------------------------------------------------
    def host_edge_s(self, cells: float, cap: int, dim: int,
                    batch: int = 1) -> float:
        """One (u, v) edge on the host path: stage both slabs across the
        link, evaluate ``cells`` candidates, read back the full cap×cap
        mask + d² block, amortizing one dispatch over ``batch`` edges."""
        stage = self.xfer_s(2 * cap * dim * 4, self.h2d_gb_s)
        fetch = self.xfer_s(cap * cap * _MASK_D2_BYTES, self.d2h_gb_s)
        return (stage + cells * self.host_cell_ns * 1e-9 + fetch
                + self.host_dispatch_s / max(1, batch))

    def device_edge_s(self, cells: float, pairs_hi: float, cap: int,
                      dim: int, fresh_slabs: float = 0.0,
                      batch: int = 1) -> float:
        """One (u, v) edge on the device path: H2D only for slabs not yet
        device-resident (``fresh_slabs``, fractional when amortized),
        fused verify+compact over ``cells``, compacted ``pairs_hi × 12 B``
        readback, one dispatch amortized over ``batch`` edges."""
        h2d = self.xfer_s(fresh_slabs * cap * dim * 4, self.h2d_gb_s)
        d2h = self.xfer_s(pairs_hi * _PAIR_BYTES + 4, self.d2h_gb_s)
        return (h2d + cells * self.device_cell_ns * 1e-9 + d2h
                + self.device_dispatch_s / max(1, batch))

    # -- query-wave costs ---------------------------------------------------------
    def host_query_s(self, cells: float) -> float:
        return (cells * self.host_cell_ns * 1e-9
                + self.host_dispatch_s)

    def device_query_s(self, cells: float, pairs_hi: float, nq: int,
                       cap: int, dim: int, fresh_slabs: int) -> float:
        h2d = self.xfer_s((fresh_slabs * cap + nq) * dim * 4,
                          self.h2d_gb_s)
        d2h = self.xfer_s(pairs_hi * _PAIR_BYTES + 4, self.d2h_gb_s)
        return (h2d + cells * self.device_cell_ns * 1e-9 + d2h
                + self.device_dispatch_s)

    def describe(self) -> str:
        link = (f"{self.h2d_gb_s:g} GB/s"
                if self.h2d_gb_s > 0 else "free")
        if self.d2h_gb_s != self.h2d_gb_s:
            link = f"h2d {link}, d2h {self.d2h_gb_s:g} GB/s"
        cells = (f"host={self.host_cell_ns:g} ns/cell, "
                 f"device={self.device_cell_ns:g} ns/cell")
        if self.provenance.get("host_cell_ns", "static") != "static":
            cells += (f", dispatch host {self.host_dispatch_s * 1e3:g} ms, "
                      f"device {self.device_dispatch_s * 1e3:g} ms "
                      f"[{self.provenance['host_cell_ns']}]")
        return (f"read={self.read_s_per_bucket * 1e3:.3f} ms/bucket "
                f"[{self.provenance.get('read_s_per_bucket', '?')}], "
                f"link={link} [{self.provenance.get('link', '?')}], "
                + cells)
