"""Superstep ("distributed") DiskJoin execution on one card (DESIGN §5).

Port of the JAX package's ``core/distributed.py``. The plan is the same:
the Gorder node order is cut into windows of at most ``cache_buckets``
buckets, each edge runs in the first window holding both endpoints, and
the host keeps a slab cache trimmed to the upcoming window, so consecutive
windows reuse their shared buckets. On this port:

  SSD            → the host-side bucketed store
  DRAM cache     → the host cache of padded slabs (keep-set eviction); in
                   ``compute_mode="device"`` mirrored on the card by a
                   ``DeviceSlabPool`` (one H2D copy a residency)
  edge tasks     → a superstep's edges, dispatched in edge order in chunks
                   of ``config.verify_batch`` lanes
  verify kernel  → ``kernels.ops.verify_pairs_batch``: on the card the
                   hand-written kernel (the ``tc`` route,
                   ``pairwise_l2_sm90.cu``, where d % 4 == 0), on the CPU
                   its plain version

A lane's d² depends only on its two slabs and their orientation, never on
the chunk it is launched in, and both modes take square roots as the
single-box engines do, so the pairs and distances are those of the
single-box ``JoinExecutor``, byte for byte. Window w's chunks are queued on
the current stream before window w+1's disk reads, and the host waits
only when it reads w's results.

Under a mesh (``launch.mesh.Mesh`` with a ``data`` axis, one process per
rank), every rank plans the same supersteps, and each superstep's edges are
padded to a multiple of the ``data`` group, as the reference pads them
(host mode repeats edge 0; device mode adds lanes with no live rows), and
cut into contiguous slices, one a rank. Each rank verifies its slice with
the same kernel and compaction, drops what its padded lanes gave, and the
compacted (pair, distance) rows are all-gathered in rank order: their
concatenation is the one-card emission stream, so the pairs and distances
are one card's, byte for byte. Rank 0 alone writes checkpoints, after the
gather; every rank resumes from them.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.compute import DeviceSlabPool, device_verify, next_pow2
from repro_torch.core import ordering
from repro_torch.core.executor import PAD_COORD
from repro_torch.core.types import (BucketGraph, BucketMeta, JoinConfig,
                                    dedup_pairs, resolve_bucket_capacity,
                                    resolve_cache_buckets)
from repro_torch.device import resolve_device, to_device
from repro_torch.io.retry import read_with_retry
from repro_torch.kernels import ops as kops
from repro_torch.obs import get_tracer


def _lanes(slab, idx: np.ndarray) -> torch.Tensor:
    return torch.stack([slab[int(i)] for i in idx])


def verify_edges(slab, edges: np.ndarray, eps: float):
    """slab: the window's (W, cap, d) slabs, a tensor or a sequence of W
    (cap, d) tensors on one device; edges: (E, 2) host indices into it.

    One verify launch → (counts (E,), mask (E, cap, cap) bool,
    d2 (E, cap, cap) float32), left on the slabs' device; the squared
    distances ride along so the host emits pair distances without
    recomputing them."""
    d2, mask = kops.verify_pairs_batch(_lanes(slab, edges[:, 0]),
                                       _lanes(slab, edges[:, 1]), eps)
    return mask.sum(dim=(1, 2)), mask, d2


def verify_edges_compact(slab, edges: np.ndarray, na: torch.Tensor,
                         nb: torch.Tensor, intra: torch.Tensor, eps: float,
                         k_cap: int):
    """Compacted variant (``compute_mode="device"``): one verify launch,
    then ``compute.compact_pairs`` on the slabs' device → (counts (E,),
    rows, cols, dists (E, k_cap)), so the host never fetches a mask.
    ``na``/``nb`` carry the live-row counts; ``intra`` keeps the strictly
    upper pairs of a bucket-vs-itself lane. Queued without a host sync."""
    out, _, _ = device_verify(na, nb, intra,
                              [slab[int(a)] for a in edges[:, 0]],
                              [slab[int(b)] for b in edges[:, 1]],
                              eps=eps, k_cap=k_cap)
    return out


@dataclasses.dataclass
class Superstep:
    bucket_ids: np.ndarray   # (W,) global bucket ids in this window
    edges_local: np.ndarray  # (E, 2) int32 indices into bucket_ids
    edges_global: np.ndarray  # (E, 2) original bucket ids


def plan_supersteps(graph: BucketGraph, config: JoinConfig,
                    cache_buckets: int,
                    meta: BucketMeta) -> list[Superstep]:
    """Gorder → windows of ≤cache_buckets buckets covering all edges.

    Each edge lands in the first window containing both endpoints; the
    window advances greedily along the node order (self-pairs implicit —
    every bucket appears in ≥1 window). The order comes from
    ``ordering.compute_node_order`` (shared with the single-box executor,
    incl. the spatial strategy).
    """
    node_order = ordering.compute_node_order(graph, meta, config,
                                             cache_buckets)
    tasks, _, _ = ordering.edge_schedule(graph, node_order)

    steps: list[Superstep] = []
    cur_buckets: list[int] = []
    cur_edges: list[tuple[int, int]] = []
    seen: dict[int, int] = {}

    def flush():
        nonlocal cur_buckets, cur_edges, seen
        if not cur_buckets:
            return
        bids = np.asarray(cur_buckets, dtype=np.int64)
        eg = (np.asarray(cur_edges, dtype=np.int64)
              if cur_edges else np.zeros((0, 2), np.int64))
        el = np.stack([[seen[int(a)] for a, _ in cur_edges],
                       [seen[int(b)] for _, b in cur_edges]], axis=1
                      ).astype(np.int32) if cur_edges else \
            np.zeros((0, 2), np.int32)
        steps.append(Superstep(bids, el, eg))
        cur_buckets, cur_edges, seen = [], [], {}

    cap = max(2, cache_buckets)
    for t in tasks:
        need = [t[1]] if t[0] == "touch" else [t[1], t[2]]
        new = [b for b in need if int(b) not in seen]
        if len(cur_buckets) + len(new) > cap:
            flush()
            new = need
        for b in need:
            b = int(b)
            if b not in seen:
                seen[b] = len(cur_buckets)
                cur_buckets.append(b)
        if t[0] == "touch":
            cur_edges.append((int(t[1]), int(t[1])))  # self edge
        else:
            cur_edges.append((int(t[1]), int(t[2])))
    flush()
    return steps


class DistributedJoin:
    """Superstep-wise execution of a planned join.

    ``device``: ``None`` (CUDA; raises without it) or ``"cpu"`` (the
    kernels' plain versions). ``mesh``: a ``launch.mesh.Mesh`` with a
    ``data`` axis, over which each superstep's edges are cut (the rank then
    computes on ``mesh.device``). The host keeps a slab cache trimmed to
    the upcoming window, so consecutive supersteps reuse their loads.
    """

    def __init__(self, store, meta: BucketMeta, config: JoinConfig,
                 mesh=None, *, device=None):
        if mesh is not None and "data" not in mesh.shape:
            raise ValueError("DistributedJoin's mesh needs a 'data' axis")
        self.store = store
        self.meta = meta
        self.config = config
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        self.rank_edges = 0     # real edges this rank verified
        self.cap = resolve_bucket_capacity(config, meta.sizes)
        self.cache_buckets = resolve_cache_buckets(config, self.cap,
                                                   store.dim)
        self._host_cache: dict[int, tuple] = {}
        self._staged: dict[int, tuple] = {}  # prefetched, not yet fetched
        self.loads = 0
        self.hits = 0
        self.prefetched = 0  # window w+1 loads issued under w's verify
        # compute_mode="device": per-bucket device slabs persist across
        # supersteps (evicted on the host keep-set), so consecutive
        # windows transfer only their *new* buckets
        self._dev_pool = (DeviceSlabPool(self.device)
                          if config.compute_mode == "device" else None)
        self._pair_cap = min(next_pow2(max(1024, 8 * self.cap)),
                             self.cap * self.cap)
        self._pinned: dict[torch.dtype, torch.Tensor] = {}
        self.eps = float(config.epsilon)

    def _read_padded(self, b: int) -> tuple[np.ndarray, np.ndarray, int]:
        vecs, ids = read_with_retry(
            lambda: self.store.read_bucket(b),
            retries=self.config.io_retries,
            backoff_s=self.config.io_retry_backoff_s)
        n = vecs.shape[0]
        pad = self.cap - n
        if pad > 0:
            vecs = np.concatenate(
                [vecs, np.full((pad, vecs.shape[1]), PAD_COORD, vecs.dtype)])
        return (vecs.astype(np.float32), ids, n)

    def _fetch(self, b: int) -> tuple[np.ndarray, np.ndarray, int]:
        if b in self._host_cache:
            self.hits += 1
            return self._host_cache[b]
        entry = self._staged.pop(b, None)
        if entry is None:            # not prefetched: load now
            entry = self._read_padded(b)
            self.loads += 1          # prefetched loads were counted at issue
        self._host_cache[b] = entry
        return entry

    def _evict_to(self, keep: set[int]) -> None:
        # host cache follows the superstep plan: keep only upcoming window
        # + LRU slack up to capacity (Belady degenerate form: the plan IS
        # the future, and the next window is the nearest future access)
        if len(self._host_cache) <= self.cache_buckets:
            return
        for b in list(self._host_cache.keys()):
            if b not in keep and len(self._host_cache) > self.cache_buckets:
                del self._host_cache[b]
                if self._dev_pool is not None:
                    self._dev_pool.evict(b)  # device mirrors host residency

    def _prefetch_window(self, step: Superstep) -> None:
        """While window w's verify runs on the card, pull window w+1's
        missing buckets from disk. They land in a *staging* dict, not the
        host cache: staged entries must not add eviction pressure before
        window w's keep-set trim runs, or gap-retained buckets would be
        pushed out early and re-read. ``_fetch`` merges staged entries in
        when w+1 begins."""
        with get_tracer().span("dist.prefetch",
                               buckets=len(step.bucket_ids)):
            for b in step.bucket_ids:
                b = int(b)
                if b not in self._host_cache and b not in self._staged:
                    self._staged[b] = self._read_padded(b)
                    self.loads += 1
                    self.prefetched += 1

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """A device result as numpy. From the card it is copied into a
        pinned buffer kept across chunks (a pageable copy runs several
        times slower); the array aliases that buffer, so it is read before
        the next chunk's copy."""
        if t.device.type == "cpu":
            return t.numpy()
        buf = self._pinned.get(t.dtype)
        if buf is None or buf.numel() < t.numel():
            buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
            self._pinned[t.dtype] = buf
        out = buf[:t.numel()].view(t.shape)
        out.copy_(t)
        return out.numpy()

    # -- host mode: fetch each chunk's d2 and mask ---------------------------
    def _dispatch_host(self, slab, edges, entries, real):
        return verify_edges(slab, edges, self.eps)

    def _extract_host(self, handle, slab, edges, entries, real):
        mask, d2 = self._to_host(handle[1]), self._to_host(handle[2])
        pairs, dists = [], []
        for ei, (a, b) in enumerate(edges[:real]):
            na, nb = entries[a][2], entries[b][2]
            m = mask[ei][:na, :nb]
            if a == b:
                m = np.triu(m, k=1)
            rows, cols = np.nonzero(m)
            if rows.size:
                ida, idb = entries[a][1], entries[b][1]
                pairs.append(np.stack([ida[rows], idb[cols]], axis=1)
                             .astype(np.int64))
                # numpy's IEEE float32 sqrt, as HostVerifyEngine takes it
                dists.append(np.sqrt(d2[ei][rows, cols]).astype(np.float32))
        return pairs, dists

    # -- device mode: compacted (row, col, distance) triples -----------------
    def _dispatch_compact(self, slab, edges, entries, real):
        rowc = np.array([e[2] for e in entries], np.int32)
        na, nb = rowc[edges[:, 0]], rowc[edges[:, 1]]
        na[real:] = nb[real:] = 0    # padding lanes: no live rows
        lanes = (to_device(na, self.device), to_device(nb, self.device),
                 to_device(edges[:, 0] == edges[:, 1], self.device))
        k_cap = self._pair_cap
        return verify_edges_compact(slab, edges, *lanes, self.eps,
                                    k_cap), lanes, k_cap

    def _extract_compact(self, handle, slab, edges, entries, real):
        """Read a chunk's compacted pairs (+ distances); on per-edge
        capacity overflow re-dispatch the chunk at the next pow2 (sticky
        for later chunks)."""
        out, lanes, k_cap = handle
        counts = out[0].cpu().numpy()
        top = int(counts.max())
        if top > k_cap:
            # chunks in flight were queued at the cap of their dispatch:
            # the sticky cap only grows
            self._pair_cap = max(self._pair_cap,
                                 min(next_pow2(top), self.cap * self.cap))
            out = verify_edges_compact(slab, edges, *lanes, self.eps,
                                       self._pair_cap)
            counts = out[0].cpu().numpy()
        # only the first ``top`` columns hold pairs: fetch no more
        rows_c, cols_c, dist_c = (o[:, :top].cpu().numpy() for o in out[1:])
        res, res_d = [], []
        for ei, (a, b) in enumerate(edges[:real]):
            k = int(counts[ei])
            if k:
                ida, idb = entries[a][1], entries[b][1]
                res.append(np.stack([ida[rows_c[ei, :k]],
                                     idb[cols_c[ei, :k]]], axis=1)
                           .astype(np.int64))
                res_d.append(dist_c[ei, :k].astype(np.float32))
        return res, res_d

    def fingerprint(self) -> str:
        """Session digest guarding checkpoint compatibility: config +
        bucket layout + store extent (the JAX package's dict, so equal
        sessions of either package give the same digest). A checkpoint
        written under a different digest must not be resumed into this
        run."""
        from repro_torch.ft.atomic import fingerprint as _fp
        return _fp({"config": dataclasses.asdict(self.config),
                    "sizes": self.meta.sizes.tolist(),
                    "num_buckets": int(self.meta.num_buckets),
                    "dim": int(self.store.dim)})

    def _verify_step(self, si: int, steps: list[Superstep],
                     entries: list) -> tuple[list, list]:
        """One superstep's verify, in chunks of ``verify_batch`` edges in
        edge order. Device mode queues every chunk before the host reads
        any; host mode keeps one chunk's (E, cap, cap) d2 and mask on the
        card at a time. Window w+1's reads run after the first dispatch."""
        step = steps[si]
        edges, real = self._my_edges(step.edges_local)
        self.rank_edges += real
        if self._dev_pool is not None:
            # the per-bucket slabs this rank's lanes read, resident on the
            # device (one transfer per host residency)
            used = set(edges.reshape(-1).tolist())
            slab = [self._dev_pool.operand(int(b), e[0]) if wi in used
                    else None for wi, (b, e) in
                    enumerate(zip(step.bucket_ids, entries))]
            issue, collect = self._dispatch_compact, self._extract_compact
        else:
            slab = to_device(np.stack([e[0] for e in entries]), self.device)
            issue, collect = self._dispatch_host, self._extract_host
        vb = max(1, int(self.config.verify_batch))
        starts = range(0, edges.shape[0], vb)
        # (lanes, real lanes among them): padding lanes are verified and
        # their results dropped
        chunks = [(edges[i:i + vb], min(max(real - i, 0), vb))
                  for i in starts]
        ahead = len(chunks) if self._dev_pool is not None else 1
        inflight = collections.deque(issue(slab, c, entries, r)
                                     for c, r in chunks[:ahead])
        if si + 1 < len(steps):
            self._prefetch_window(steps[si + 1])
        step_pairs, step_dists = [], []
        for k, (c, r) in enumerate(chunks):
            p, d = collect(inflight.popleft(), slab, c, entries, r)
            step_pairs.extend(p)
            step_dists.extend(d)
            if k + ahead < len(chunks):
                c2, r2 = chunks[k + ahead]
                inflight.append(issue(slab, c2, entries, r2))
        if self.mesh is not None:
            step_pairs, step_dists = self._gather_rows(step_pairs,
                                                       step_dists)
        return step_pairs, step_dists

    def _my_edges(self, edges: np.ndarray) -> tuple[np.ndarray, int]:
        """(this rank's lanes, how many of them are real edges): all of
        them on one card; under a mesh, slice i of the edges padded to a
        multiple of the ``data`` group (host mode repeats edge 0, device
        mode pads with edge (0, 0), whose lanes carry no live rows)."""
        if self.mesh is None:
            return edges, edges.shape[0]
        n, i = self.mesh.axis_size("data"), self.mesh.axis_index("data")
        E = edges.shape[0]
        per = -(-E // n)
        pad = (np.zeros((per * n - E, 2), edges.dtype)
               if self._dev_pool is not None
               else np.repeat(edges[:1], per * n - E, axis=0))
        lanes = np.concatenate([edges, pad])[i * per:(i + 1) * per]
        return lanes, min(max(E - i * per, 0), per)

    def _gather_rows(self, pairs: list, dists: list) -> tuple[list, list]:
        """Every rank's compacted rows of a superstep, in rank order along
        ``data`` (the order of the edges they came from): one gather of
        (id, id, distance bits) rows, each an int64 triple."""
        rows = np.zeros((sum(len(q) for q in pairs), 3), np.int64)
        if pairs:
            rows[:, :2] = np.concatenate(pairs)
            rows[:, 2] = np.concatenate(dists).view(np.int32)
        parts = self.mesh.all_gather_list(
            torch.from_numpy(rows).to(self.mesh.device), "data")
        parts = [t.cpu().numpy() for t in parts if t.shape[0]]
        return ([r[:, :2].copy() for r in parts],
                [r[:, 2].astype(np.int32).view(np.float32) for r in parts])

    def run(self, graph: BucketGraph, *, checkpointer=None,
            resume_from=None, fault=None):
        """Execute the planned join → (pairs, info).

        ``checkpointer``: a ``repro_torch.ft.JoinCheckpointer`` recording
        superstep progress (the raw emission stream) without ever
        blocking the verify pipeline. ``resume_from``: a checkpoint
        directory path or a ``ResumeState`` — committed supersteps are
        replayed from the spill files and execution restarts at the
        cursor; the final pairs+distances are byte-identical to an
        uninterrupted run. ``fault``: a ``repro_torch.ft.FaultInjector``
        consulted at each superstep boundary (tests and the smoke run).
        """
        steps = plan_supersteps(graph, self.config, self.cache_buckets,
                                meta=self.meta)
        if self.mesh is not None and self.mesh.rank != 0:
            checkpointer = None      # rank 0 writes, after the gather
        pairs_out, dists_out = [], []
        start_si = 0
        restore_s = 0.0
        fp = (self.fingerprint()
              if checkpointer is not None or resume_from is not None
              else None)
        if resume_from is not None:
            from repro_torch.ft import JoinCheckpointer
            rs = resume_from
            if isinstance(rs, str):
                rs = JoinCheckpointer.restore(rs, fingerprint=fp)
            if rs is not None:
                # the committed raw stream, in emission order — replayed
                # verbatim so the final dedup sees the same concatenation
                # an uninterrupted run would
                pairs_out.extend(rs.pairs)
                dists_out.extend(rs.dists)
                start_si = rs.superstep + 1
                restore_s = rs.restore_s
        if checkpointer is not None:
            checkpointer.begin(fp, start_si)

        dc = 0
        tracer = get_tracer()
        for si, step in enumerate(steps):
            if si < start_si:
                continue  # committed by the restored checkpoint chain
            if fault is not None:
                fault.superstep(si)
            edges = step.edges_local
            if edges.shape[0] == 0:
                # defensive: planner always pairs buckets w/ edges — but
                # the checkpoint cursor must advance through empty steps
                if checkpointer is not None:
                    checkpointer.step_done(si, [], [])
                continue
            with tracer.span("dist.superstep", step=si,
                             buckets=len(step.bucket_ids),
                             edges=int(edges.shape[0])):
                entries = [self._fetch(int(b)) for b in step.bucket_ids]
                step_pairs, step_dists = self._verify_step(si, steps,
                                                           entries)
                dc += sum(
                    (entries[a][2] * entries[b][2]) if a != b
                    else entries[a][2] * (entries[a][2] - 1) // 2
                    for a, b in edges)
                pairs_out.extend(step_pairs)
                dists_out.extend(step_dists)
                if checkpointer is not None:
                    checkpointer.step_done(si, step_pairs, step_dists)
                # keep-set is the *upcoming* window: evicting on the
                # finished window's set discards exactly the slabs
                # superstep w+1 reuses, while keeping the finished window
                # would park dead slabs above the memory budget
                nxt = steps[si + 1] if si + 1 < len(steps) else step
                self._evict_to(set(int(b) for b in nxt.bucket_ids))

        if checkpointer is not None:
            checkpointer.finish()

        watermark = sum(len(p) for p in pairs_out)
        if pairs_out:
            pairs, dists = dedup_pairs(np.concatenate(pairs_out),
                                       np.concatenate(dists_out))
        else:
            pairs = np.zeros((0, 2), np.int64)
            dists = np.zeros(0, np.float32)
        info = {"supersteps": len(steps), "host_loads": self.loads,
                "host_hits": self.hits, "prefetched_buckets": self.prefetched,
                "distance_computations": dc, "dists": dists,
                "watermark_rows": watermark}
        if resume_from is not None:
            info["resumed_at"] = start_si
            info["restore_s"] = restore_s
        if checkpointer is not None:
            info["ckpt"] = dict(checkpointer.stats)
        if self._dev_pool is not None:
            info["h2d_transfers"] = self._dev_pool.transfers
            info["device_slab_hits"] = self._dev_pool.hits
            info["h2d_bytes"] = self._dev_pool.h2d_bytes
        if self.mesh is not None:
            # per rank along the mesh: real edges verified, bucket loads
            mine = torch.tensor([[self.rank_edges, self.loads]],
                                dtype=torch.int64, device=self.device)
            per = self.mesh.all_gather(mine, self.mesh.axis_names).cpu()
            info["rank_edges"] = per[:, 0].tolist()
            info["rank_loads"] = per[:, 1].tolist()
        return pairs, info
