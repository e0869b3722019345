"""Verify engines: the executor's batched pair-verification backends.

Both engines replay the same edge stream and produce byte-identical
(pairs, distances) — they differ only in where operands live and where
pair extraction happens (``JoinConfig.compute_mode``):

``HostVerifyEngine`` ("host")
    Stages each batch's operand slabs into a pinned host buffer, makes ONE
    kernel launch (``kernels.ops.verify_pairs_batch``), fetches the full
    (E, cap, cap) d2/mask and extracts pairs with numpy. Padded batch
    lanes are sliced away per edge; partial flushes launch at the next
    power-of-two lane count.

``DeviceVerifyEngine`` ("device")
    Operands come from a ``DeviceSlabPool`` that mirrors the host cache
    schedule — each bucket slab crosses H2D once per cache residency, and
    every further edge reference is a ``device_slab_hit``. Dispatch is
    double-buffered: batch k is queued (stack → kernel → compaction) on
    the current CUDA stream with no host synchronisation, and its results
    are fetched only at the head of flush k+1, so the whole enqueue/walk
    of batch k+1 overlaps batch k's kernels (``d2h_overlap_s``). The
    compaction (``compact_pairs``) returns (row, col, distance) triples,
    so the host never sees an (E, cap, cap) mask.

Distance parity: both modes take d² from the same kernel launch shape and
apply an IEEE float32 sqrt (numpy on the host, ``ieee_sqrt`` on the
device) — bitwise identical. Pair order parity: the compaction walks the
mask in row-major flat order, exactly ``np.nonzero``'s order.

Nothing between a dispatch and its collect may synchronise with the
device: no ``.item()``, ``.cpu()``, ``torch.nonzero``, boolean-mask
indexing or pageable H2D copy on the dispatch path.

The compaction capacity (pairs per edge) adapts: a batch whose densest
edge overflows it is re-compacted from its still-resident d2/mask at the
next power of two, and the larger capacity sticks for later batches.

Tracing: the device engine's dispatch and collect are ``verify.dispatch``
and ``verify.collect`` spans. Inside a collect, ``device.sync`` covers the
first fetch, which waits for the batch's kernels (and an overflow's
re-compaction), and ``verify.emit`` the other fetches and the per-edge id
mapping.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.compute.slab_pool import DeviceSlabPool
from repro_torch.device import to_device
from repro_torch.kernels import ops as kops
from repro_torch.obs import get_tracer

PAIR_CAP_INIT = 1024  # initial per-edge compaction capacity (pairs)


def next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. On CUDA that is
    ``torch.sqrt``; on the CPU ``torch.sqrt`` takes a vectorised path for
    large tensors that is off by one ulp on some values, so the CPU path
    takes numpy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def compact_pairs(d2: torch.Tensor, mask: torch.Tensor, na: torch.Tensor,
                  nb: torch.Tensor, intra: torch.Tensor, k_cap: int):
    """Pair compaction on the operands' device: mask → prefix sum →
    binary search → gather.

    d2/mask: (E, M, N); na/nb: (E,) int32 live-row counts (0 kills a
    padded batch lane); intra: (E,) bool — keep strictly-upper pairs only
    (self-join bucket-vs-itself edges). Returns (counts (E,) int32,
    rows (E, k_cap) int32, cols (E, k_cap) int32, dists (E, k_cap) f32);
    entries past an edge's count are zeros, pairs past ``k_cap`` are
    dropped (the caller detects counts > k_cap and re-compacts larger).
    Runs without synchronising the host.

    The prefix sum runs over the whole batch flattened to one dimension:
    PyTorch scans a 1-D CUDA tensor with a device-wide scan, but scans the
    rows of an (E, M·N) tensor with one thread block for up to 32 rows,
    which cost ~6.5 ms a batch at (32, 2048, 2048) on an H100 — five times
    the verify kernel (``chip_smoke.py --profile``).
    """
    E, M, N = d2.shape
    MN = M * N
    dev = d2.device
    rows = torch.arange(M, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    live = ((rows[None] < na[:, None, None])
            & (cols[None] < nb[:, None, None]))
    tri = (~intra)[:, None, None] | (rows < cols)[None]
    idt = torch.int32 if E * MN < 2 ** 31 else torch.int64
    cs = torch.cumsum((mask & live & tri).reshape(-1), 0, dtype=idt)
    ends = cs.view(E, MN)[:, -1]
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    # the j-th pair of lane e sits where the running count first reaches
    # (pairs before lane e) + j: row-major flat order == np.nonzero order
    ks = torch.arange(1, k_cap + 1, dtype=idt, device=dev)
    order = torch.searchsorted(cs, ((ends - counts)[:, None] + ks[None, :])
                               .reshape(-1), side="left").view(E, k_cap)
    valid = ks[None, :] <= counts[:, None]
    order = torch.where(
        valid, order - torch.arange(E, device=dev)[:, None] * MN, 0)
    out_r = torch.where(valid, (order // N).to(torch.int32), 0)
    out_c = torch.where(valid, (order % N).to(torch.int32), 0)
    out_d2 = torch.where(valid, torch.gather(d2.reshape(E, MN), 1, order),
                         0.0)
    return counts.to(torch.int32), out_r, out_c, ieee_sqrt(out_d2)


def device_verify(na, nb, intra, slabs_u: list, slabs_v: list, *,
                  eps: float, k_cap: int):
    """Stack → verify kernel → compaction for one batch, all queued on the
    current stream. Returns the compacted outputs and the batch's d2/mask,
    which stay resident for a re-compaction after an overflow."""
    u = torch.stack(slabs_u)
    v = torch.stack(slabs_v)
    d2, mask = kops.verify_pairs_batch(u, v, eps)
    return compact_pairs(d2, mask, na, nb, intra, k_cap), d2, mask


def query_verify_compact(q_block: torch.Tensor, qidx: torch.Tensor, nq: int,
                         slab: torch.Tensor, eps: float, k_cap: int):
    """Online point-query verify (``DiskJoinIndex.execute_probes``,
    ``compute_mode="device"``): the wave's query block is staged on the
    device ONCE and each probed bucket's verify gathers its member rows
    from it. ``qidx`` is pow2-padded; ``nq`` live entries — padded rows
    repeat query 0 and are masked out by the row count. Returns compacted
    (counts (1,), q-rows, cols, distances) against the (capacity, dim)
    bucket slab. On CUDA the distances come from the verify kernel's E = 1
    launch (``ops.pairwise_l2_threshold``)."""
    qs = torch.index_select(q_block, 0, qidx)            # (Qp, d)
    d2, mask = kops.pairwise_l2_threshold(qs, slab, eps)  # (Qp, cap)
    dev = slab.device
    na = torch.full((1,), int(nq), dtype=torch.int32, device=dev)
    nb = torch.full((1,), slab.shape[0], dtype=torch.int32, device=dev)
    intra = torch.zeros(1, dtype=torch.bool, device=dev)
    return compact_pairs(d2[None], mask[None], na, nb, intra, k_cap)


class _EngineBase:
    """Shared bookkeeping: edge accounting and result accumulation."""

    def __init__(self, cache, *, epsilon: float, capacity_rows: int,
                 dim: int, verify_batch: int, device: torch.device,
                 attribute_mask: np.ndarray | None = None, pstats=None,
                 xfer_gb_s: float = 0.0, tracer=None):
        self.cache = cache
        self.eps = float(epsilon)
        self.cap = int(capacity_rows)
        self.dim = int(dim)
        self.verify_batch = max(1, int(verify_batch))
        self.device = torch.device(device)
        self.attribute_mask = attribute_mask
        self.pstats = pstats
        self.tracer = tracer if tracer is not None else get_tracer()
        self.xfer_gb_s = float(xfer_gb_s)
        self.dc = 0              # distance computations (live pairs)
        self.compute_s = 0.0     # engine wall time in stage/dispatch/extract
        self.pairs_out: list[np.ndarray] = []
        self.dists_out: list[np.ndarray] = []

    def _count_dc(self, na: int, nb: int, intra: bool) -> None:
        self.dc += na * (na - 1) // 2 if intra else na * nb

    def _stat(self, field: str, amount) -> None:
        if self.pstats is not None:
            self.pstats.add(field, amount)

    def _charge_link(self, nbytes: int) -> None:
        """Emulated host↔device link cost (``emulate_xfer_gb_s``), traced
        as a ``link.xfer`` span with a bytes arg."""
        if self.xfer_gb_s > 0 and nbytes > 0:
            t0 = time.perf_counter()
            time.sleep(nbytes / (self.xfer_gb_s * 1e9))
            if self.tracer.enabled:
                self.tracer.complete("link.xfer", t0,
                                     time.perf_counter() - t0,
                                     bytes=int(nbytes))

    def results(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        return self.pairs_out, self.dists_out

    def evict(self, b: int) -> None:  # device engine overrides
        pass

    def set_verify_batch(self, n: int) -> None:
        """Planner hook: retune the flush threshold between enqueues."""
        self.verify_batch = max(1, int(n))

    def set_route(self, route: str) -> None:
        """Planner hook: a single-mode engine ignores routing (the routed
        wrapper overrides)."""

    @property
    def pending(self) -> bool:
        raise NotImplementedError


class HostVerifyEngine(_EngineBase):
    """Host staging + full-mask fetch (the reference compute path)."""

    def __init__(self, cache, **kw):
        super().__init__(cache, **kw)
        # pinned staging (CUDA): the H2D copy can run asynchronously, and
        # the buffer is rewritten only after the flush's d2/mask fetch has
        # synchronised the stream past that copy
        pin = self.device.type == "cuda"
        shape = (self.verify_batch, self.cap, self.dim)
        self._u = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
        self._v = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
        self._un = self._u.numpy()
        self._vn = self._v.numpy()
        self._batch: list[tuple] = []  # (entry_a, entry_b, intra)

    def set_verify_batch(self, n: int) -> None:
        # the staging buffers were sized at construction: a larger plan
        # batch clamps to the allocation rather than reallocating
        self.verify_batch = max(1, min(int(n), self._u.shape[0]))

    @property
    def pending(self) -> bool:
        return bool(self._batch)

    def enqueue(self, bu: int, bv: int, intra: bool) -> None:
        self._batch.append((self.cache.checkout(bu),
                            self.cache.checkout(bv), intra))
        if len(self._batch) >= self.verify_batch:
            self.flush()

    def flush(self) -> None:
        if not self._batch:
            return
        with self.tracer.span("verify.flush", edges=len(self._batch)):
            self._flush()

    def _flush(self) -> None:
        t0 = time.perf_counter()
        E = len(self._batch)
        # partial flushes launch at the next pow2 lane count; lanes past E
        # hold stale staging content and are sliced away below
        B = min(self._u.shape[0], next_pow2(E))
        for i, (ea, eb, _) in enumerate(self._batch):
            self._un[i] = ea[0]
            self._vn[i] = eb[0]
        u = self._u[:B].to(self.device, non_blocking=True)
        v = self._v[:B].to(self.device, non_blocking=True)
        staged = 2 * B * self.cap * self.dim * 4
        self._stat("h2d_transfers", 2)
        self._stat("h2d_bytes", staged)
        self._charge_link(staged)
        d2, mask = kops.verify_pairs_batch(u, v, self.eps)
        d2 = d2.cpu().numpy()
        masks = mask.cpu().numpy()
        self._stat("d2h_bytes", d2.nbytes + masks.nbytes)
        self._charge_link(d2.nbytes + masks.nbytes)
        attr = self.attribute_mask
        for i, (ea, eb, intra) in enumerate(self._batch):
            na, nb = ea[2], eb[2]
            m = masks[i][:na, :nb]
            if intra:
                m = np.triu(m, k=1)
            self._count_dc(na, nb, intra)
            if attr is not None:
                m = m & attr[ea[1][:na]][:, None] & attr[eb[1][:nb]][None, :]
            rows, cols = np.nonzero(m)
            if rows.size:
                d = np.sqrt(d2[i][rows, cols])
                self.pairs_out.append(
                    np.stack([ea[1][rows], eb[1][cols]],
                             axis=1).astype(np.int64))
                self.dists_out.append(d.astype(np.float32))
        for ea, eb, _ in self._batch:  # drop the batch's slab pins
            self.cache.release(ea)
            self.cache.release(eb)
        self._batch.clear()
        self.compute_s += time.perf_counter() - t0

    def finish(self) -> None:
        self.flush()

    def abort(self) -> None:
        for ea, eb, _ in self._batch:
            self.cache.release(ea)
            self.cache.release(eb)
        self._batch.clear()


class DeviceVerifyEngine(_EngineBase):
    """Device-resident operands + double-buffered compacted dispatch."""

    def __init__(self, cache, **kw):
        pair_cap = kw.pop("pair_cap", None)
        super().__init__(cache, **kw)
        # slab transfers accrue emulated-link debt paid in one sleep per
        # flush (hundreds of tiny sleeps would each round up to timer slack)
        self._link_debt = 0
        self.pool = DeviceSlabPool(self.device, self.pstats,
                                   on_transfer=self._defer_link_charge,
                                   tracer=self.tracer)
        self._batch: list[tuple] = []
        self._inflight: tuple | None = None
        # ~8 pairs per slab row: overflow re-compaction stays rare while
        # the compacted D2H stays ≪ the full mask
        cap2 = self.cap * self.cap
        self.pair_cap = min(
            next_pow2(pair_cap or max(PAIR_CAP_INIT, 8 * self.cap)), cap2)

    @property
    def pending(self) -> bool:
        # only a staged (undispatched) batch counts: in-flight batches
        # hold no host pins
        return bool(self._batch)

    def evict(self, b: int) -> None:
        self.pool.evict(b)

    def enqueue(self, bu: int, bv: int, intra: bool) -> None:
        ea = self.cache.checkout(bu)
        eb = self.cache.checkout(bv)
        try:
            da = self.pool.operand(bu, ea[0], ea[3])
            db = self.pool.operand(bv, eb[0], eb[3])
            # id sidecars live in recyclable cache slots: copy the live
            # rows so the pins can drop now (the operands are device copies)
            meta = (np.array(ea[1][:ea[2]]), ea[2],
                    np.array(eb[1][:eb[2]]), eb[2], intra)
        finally:
            self.cache.release(ea)
            self.cache.release(eb)
        self._batch.append((da, db, meta))
        if len(self._batch) >= self.verify_batch:
            self.flush()

    def flush(self) -> None:
        """Collect the in-flight batch, then dispatch the staged one."""
        if not self._batch:
            return
        if self._link_debt:
            # pay accrued transfer debt while the previous batch's kernels
            # are still in flight (the modeled DMA overlaps compute)
            self._charge_link(self._link_debt)
            self._link_debt = 0
        self._collect()        # previous batch; waits for its kernels
        self._dispatch()

    def _dispatch(self) -> None:
        span = self.tracer.span("verify.dispatch", edges=len(self._batch))
        span.__enter__()
        t0 = time.perf_counter()
        E = len(self._batch)
        # pow2 of the actual batch, never below it: the threshold may have
        # been retuned below the pending E
        B = next_pow2(E)
        us = [da for da, _, _ in self._batch]
        vs = [db for _, db, _ in self._batch]
        us += [us[0]] * (B - E)
        vs += [vs[0]] * (B - E)
        # na = nb = 0 masks the pad lanes out inside the compaction
        na = np.zeros(B, np.int32)
        nb = np.zeros(B, np.int32)
        intra = np.zeros(B, bool)
        metas = []
        for i, (_, _, (ids_a, n_a, ids_b, n_b, is_intra)) \
                in enumerate(self._batch):
            na[i], nb[i], intra[i] = n_a, n_b, is_intra
            metas.append((ids_a, ids_b))
            self._count_dc(n_a, n_b, is_intra)
        lanes = (to_device(na, self.device), to_device(nb, self.device),
                 to_device(intra, self.device))
        k_cap = self.pair_cap
        out, d2, mask = device_verify(*lanes, us, vs, eps=self.eps,
                                      k_cap=k_cap)
        self._batch.clear()
        self._stat("device_batches", 1)
        self._inflight = (out, d2, mask, lanes, metas, k_cap,
                          time.perf_counter())
        self.compute_s += time.perf_counter() - t0
        span.__exit__(None, None, None)

    def _defer_link_charge(self, nbytes: int) -> None:
        self._link_debt += nbytes

    def _collect(self) -> None:
        if self._inflight is None:
            return
        out, d2, mask, lanes, metas, k_cap, t_dispatch = self._inflight
        self._inflight = None
        span = self.tracer.span("verify.collect")
        span.__enter__()
        t0 = time.perf_counter()
        # host time since dispatch ran concurrently with the kernels
        self._stat("d2h_overlap_s", max(0.0, t0 - t_dispatch))
        # the first fetch waits for the batch's kernels
        with self.tracer.span("device.sync", edges=len(metas)):
            counts = out[0].cpu().numpy()
            top = int(counts.max()) if counts.size else 0
            if top > k_cap:
                # capacity overflow: the output was sized too small, not
                # wrong — re-compact at the next pow2, which sticks
                k_cap = min(next_pow2(top), self.cap * self.cap)
                self.pair_cap = max(self.pair_cap, k_cap)
                self._stat("device_compact_overflows", 1)
                self.tracer.instant("verify.overflow", top=top,
                                    k_cap=k_cap)
                out = compact_pairs(d2, mask, *lanes, k_cap)
                counts = out[0].cpu().numpy()
        del d2, mask
        emit = self.tracer.span("verify.emit")
        emit.__enter__()
        if self.tracer.enabled:
            emit.set(pairs=int(counts.sum()))
        rows = out[1].cpu().numpy()
        cols = out[2].cpu().numpy()
        dists = out[3].cpu().numpy()
        fetched = counts.nbytes + rows.nbytes + cols.nbytes + dists.nbytes
        self._stat("d2h_bytes", fetched)
        self._charge_link(fetched)
        attr = self.attribute_mask
        for i, (ids_a, ids_b) in enumerate(metas):
            k = int(counts[i])
            if k == 0:
                continue
            pa = ids_a[rows[i, :k]]
            pb = ids_b[cols[i, :k]]
            d = dists[i, :k]
            if attr is not None:
                keep = attr[pa] & attr[pb]
                pa, pb, d = pa[keep], pb[keep], d[keep]
                if pa.size == 0:
                    continue
            self.pairs_out.append(np.stack([pa, pb], axis=1)
                                  .astype(np.int64))
            self.dists_out.append(d.astype(np.float32))
        emit.__exit__(None, None, None)
        self.compute_s += time.perf_counter() - t0
        span.__exit__(None, None, None)

    def finish(self) -> None:
        self.flush()
        self._collect()

    def abort(self) -> None:
        self._batch.clear()
        self._inflight = None
        self.pool.clear()


class RoutedVerifyEngine:
    """Mixed host/device routing under one engine surface: one engine of
    each kind, every enqueue forwarded to the route chosen by
    ``set_route``. Evictions reach both (the device pool mirrors the host
    cache schedule even for buckets whose edges ran host-side), and the
    results concatenate — both paths take d² from the same kernel and an
    IEEE f32 sqrt, so the executor's ``dedup_pairs`` stays
    order-insensitive."""

    def __init__(self, host: HostVerifyEngine, device: DeviceVerifyEngine):
        self.host = host
        self.device = device
        self._target = host

    def set_route(self, route: str) -> None:
        self._target = self.device if route == "device" else self.host

    def set_verify_batch(self, n: int) -> None:
        self._target.set_verify_batch(n)

    def enqueue(self, bu: int, bv: int, intra: bool) -> None:
        self._target.enqueue(bu, bv, intra)

    def flush(self) -> None:
        self.host.flush()
        self.device.flush()

    def finish(self) -> None:
        self.host.finish()
        self.device.finish()

    def abort(self) -> None:
        self.host.abort()
        self.device.abort()

    def evict(self, b: int) -> None:
        self.host.evict(b)
        self.device.evict(b)

    @property
    def pending(self) -> bool:
        return self.host.pending or self.device.pending

    @property
    def dc(self) -> int:
        return self.host.dc + self.device.dc

    @property
    def compute_s(self) -> float:
        return self.host.compute_s + self.device.compute_s

    def results(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        hp, hd = self.host.results()
        dp, dd = self.device.results()
        return hp + dp, hd + dd


def make_verify_engine(config, cache, capacity_rows: int, dim: int,
                       device: torch.device, attribute_mask=None,
                       pstats=None, tracer=None, plan=None):
    """Engine per ``JoinConfig.compute_mode`` ("host" | "device"), or per
    a plan's resolved routing when one is supplied: the plan's
    ``pair_cap`` seeds the device compaction capacity, and a "mixed" plan
    gets a ``RoutedVerifyEngine`` wrapping one engine of each kind."""
    kw = dict(epsilon=float(config.epsilon), capacity_rows=capacity_rows,
              dim=dim, verify_batch=int(config.verify_batch), device=device,
              attribute_mask=attribute_mask, pstats=pstats,
              tracer=tracer, xfer_gb_s=float(config.emulate_xfer_gb_s))
    mode = plan.compute_mode if plan is not None else config.compute_mode
    pair_cap = plan.pair_cap if plan is not None else None
    if mode == "mixed":
        return RoutedVerifyEngine(
            HostVerifyEngine(cache, **kw),
            DeviceVerifyEngine(cache, pair_cap=pair_cap, **kw))
    if mode == "device":
        return DeviceVerifyEngine(cache, pair_cap=pair_cap, **kw)
    return HostVerifyEngine(cache, **kw)
