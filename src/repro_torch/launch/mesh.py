"""Meshes over ``torch.distributed`` processes: a port of the JAX package's
``launch/mesh.py`` (DESIGN §5), one process per rank.

The reference's mesh is a grid of devices in one program; here it is a grid
of processes. ``Mesh.shape`` maps axis names to sizes, as the reference's
does, so its call sites (``mesh.shape["data"]``) carry across unchanged.
Rank r sits at the row-major coordinates of r over the axes (the last axis
varies fastest, as ``jax.make_mesh`` lays devices out). The mesh holds one
process group per axis and per axis tuple the sharding rules name (the
``"batch"`` rule's ``("pod", "data")``), makes one for any other tuple of
axes at its first collective, and wraps the collectives the port uses,
over named axes.

**Transport.** NCCL moves CUDA tensors where they are. Under gloo, tensors
travel through host memory: a CUDA tensor is copied to the host, exchanged
and copied back. Which of the two a mesh takes follows from the backend of
its process group and is fixed when the mesh is built (``Mesh.transport``,
printed by ``describe``). Under gloo, bfloat16 moves as its 16 bits in a
float16 container (gloo copies them untouched; it has no bfloat16), and
every reduction runs in float32. A collective over the ranks of an axis of
size 1 is the identity, with no process group; over every axis it runs in
the default group, at world size 1 too.

Process groups come from ``torchrun``'s environment (``init_distributed()``)
or from an explicit rank, world size and rendezvous (``init_distributed(
rank, world, init_method=...)``); ``spawn`` starts a world of processes on
this host (gloo over the loopback device), with a deadline. The backend is always
the caller's choice.

**The fake world** (``init_fake_world``): the dry-run (``launch/dryrun.py``)
runs one rank of a 256- or 512-rank mesh on one card, in a process group of
torch's ``"fake"`` backend, in which no other rank exists. Under it the
mesh moves nothing: every collective's output is made from this rank's own
part (a sum is its input, a gather repeats it), so its values are finite
and its shapes, launches, FLOPs, bytes and memory are real, while its
values are not. A fake mesh keeps tensors where they are, as NCCL does.

**The tally.** Inside ``with mesh.tallying() as tally:``, every collective
the mesh issues over more than one rank, under any backend, appends an
entry to ``tally``: its kind (the post-SPMD HLO's name for it), the axes,
the group size, the payload bytes, the dtype and whether the group lies
inside one node. Outside such a scope (training, the join) a collective
records nothing. It is the counterpart of the
collective ops of the reference's compiled program, and
``launch/collectives.py::collective_bytes`` prices it. A reduce onto one
rank counts as a reduce-scatter and a broadcast as an all-gather (the ring
traffic of each is bytes × (n−1)/n); a send as a collective-permute.

``make_production_mesh`` is a function, so importing this module touches no
process group. Single pod: (16, 16) = 256 ranks, ("data", "model");
multi-pod: (2, 16, 16) = 512 ranks with an outer "pod" axis of pure data
parallelism.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

# axis tuples that get a process group of their own beside the single axes
# (the "batch" rule shards over pod and data jointly); others get one at
# first use
JOINT_AXES = (("pod", "data"),)
FAKE = "fake"
# ranks of one node (a DGX H100's eight cards): a collective's group lies
# inside a node when its ranks lie in one block of this many consecutive
# ranks; an assumption of the deployment, as the roofline's link rates are
NODE_RANKS = 8
# the HLO name of each dtype a collective carries
_HLO_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float32: "f32", torch.float64: "f64",
               torch.int64: "s64", torch.int32: "s32", torch.int8: "s8",
               torch.uint8: "u8", torch.bool: "pred"}


def init_distributed(rank: Optional[int] = None, world: Optional[int] = None,
                     *, backend: str, init_method: Optional[str] = None,
                     timeout_s: float = 300.0) -> None:
    """Join the default process group. Without ``rank`` and ``world``, from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); raises if it is absent."""
    if rank is None or world is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no distributed environment ({', '.join(missing)} unset): "
                "launch under torchrun, e.g. `torchrun --nproc-per-node 2 "
                "-m repro_torch.launch.train ...`, or pass rank, world and "
                "init_method")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _fake_process_group(store, rank, size, timeout):
    from torch._C._distributed_c10d import FakeProcessGroup
    make = getattr(FakeProcessGroup, "_create_internal", None)
    return make(rank, size) if make is not None else \
        FakeProcessGroup(rank, size)


def init_fake_world(world: int, rank: int = 0) -> None:
    """Join a process group of torch's ``"fake"`` backend as ``rank`` of
    ``world``: no other process exists and no collective moves data (the
    dry-run's one rank of a production mesh; module docstring). The backend
    is registered here, as torch's own test helper registers it."""
    if FAKE not in getattr(dist.Backend, "_plugins", {}):
        dist.Backend.register_backend(FAKE, _fake_process_group,
                                      devices=["cpu", "cuda"])
    dist.init_process_group(FAKE, rank=rank, world_size=world,
                            store=dist.HashStore())


def _ordered_groups(shape: dict, axes: tuple) -> list[list[int]]:
    """Every group of ranks that varies along ``axes`` with the other axes
    fixed, each group's ranks in row-major order over ``axes``."""
    names = list(shape)
    sizes = [shape[a] for a in names]
    fixed = [a for a in names if a not in axes]
    groups = []
    for other in _coords_iter([shape[a] for a in fixed]):
        ranks = []
        for mine in _coords_iter([shape[a] for a in axes]):
            coord = dict(zip(fixed, other))
            coord.update(zip(axes, mine))
            ranks.append(_ravel([coord[a] for a in names], sizes))
        groups.append(ranks)
    return groups


def _coords_iter(sizes: list[int]):
    for flat in range(math.prod(sizes)):
        yield _unravel(flat, sizes)


def _unravel(flat: int, sizes: list[int]) -> list[int]:
    out = []
    for s in reversed(sizes):
        out.append(flat % s)
        flat //= s
    return out[::-1]


def _ravel(coord: list[int], sizes: list[int]) -> int:
    flat = 0
    for c, s in zip(coord, sizes):
        flat = flat * s + c
    return flat


class Mesh:
    """A named grid over the ranks of the default process group.

    ``device``: where this rank computes (``None``: its CUDA card; ``"cpu"``:
    the plain path). ``shape``: ``{axis: size}`` in order, its product the
    world size."""

    def __init__(self, shape: dict, *, device=None):
        from repro_torch.device import resolve_device
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs a process group: "
                               "init_distributed() first")
        self.shape = {str(a): int(n) for a, n in shape.items()}
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} holds {self.size} ranks; "
                             f"the world has {world}")
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names, _unravel(
            self.rank, list(self.shape.values()))))
        self.device = resolve_device(device)
        self.backend = str(dist.get_backend())
        self.fake = self.backend == FAKE
        self.transport = ("device" if self.backend in ("nccl", FAKE)
                          else "host")
        self.tally: Optional[list[dict]] = None   # None: not recording
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl mesh computes on CUDA")
        self._groups: dict[tuple, tuple] = {}
        keys = [(a,) for a in self.axis_names]
        keys += [self._order(j) for j in JOINT_AXES]
        for key in keys:
            if len(key) > 0 and key not in self._groups:
                self._make_groups(key)
        self._groups[self.axis_names] = (dist.group.WORLD,
                                         list(range(world)))

    def _make_groups(self, axes: tuple) -> None:
        # every rank creates every group of the partition, in one order
        for ranks in _ordered_groups(self.shape, axes):
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if self.rank in ranks:
                self._groups[axes] = (group, ranks)

    def describe(self) -> str:
        via = ("device tensors" if self.transport == "device"
               else "host copies")
        return (f"mesh {self.shape} on {self.device.type}: backend "
                f"{self.backend}, transport {via}; rank {self.rank} at "
                f"{self.coords}")

    # -- axes --------------------------------------------------------------
    def _order(self, axes) -> tuple:
        """``axes`` (a name or names) that the mesh has, in mesh order."""
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in self.axis_names if a in axes)

    def _axes(self, axes) -> tuple:
        """``axes`` in mesh order, with a process group over them: one made
        at first use for a tuple outside ``JOINT_AXES`` (every rank reaches
        it in the same order, as SPMD code does)."""
        axes = self._order(axes)
        if axes and axes not in self._groups:
            self._make_groups(axes)
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major index along ``axes``."""
        axes = self._axes(axes)
        return _ravel([self.coords[a] for a in axes],
                      [self.shape[a] for a in axes])

    def group_ranks(self, axes) -> list[int]:
        axes = self._axes(axes)
        return self._groups[axes][1] if axes else [self.rank]

    def _group(self, axes):
        """The process group over ``axes``; None for a group of this rank
        alone that has none (a collective over it is the identity). The
        group over every axis is the default group, at world size 1 too."""
        return self._groups[axes][0] if axes else None

    # -- the tally ---------------------------------------------------------
    @contextlib.contextmanager
    def tallying(self):
        """Record the collectives issued inside the scope: yields the list
        their entries are appended to."""
        prev, self.tally = self.tally, []
        try:
            yield self.tally
        finally:
            self.tally = prev

    def _count(self, kind: str, axes: tuple, t: torch.Tensor,
               copies: int = 1) -> None:
        """An entry for a collective whose payload is ``copies`` times
        ``t``'s bytes, where a tally is recording."""
        if self.tally is None:
            return
        ranks = self.group_ranks(axes) if axes else [self.rank]
        self.tally.append({
            "kind": kind, "axes": list(axes), "n": len(ranks),
            "bytes": copies * t.numel() * t.element_size(),
            "dtype": _HLO_DTYPES.get(t.dtype, "f32"),
            "intra_node": len({r // NODE_RANKS for r in ranks}) == 1})

    # -- transport ---------------------------------------------------------
    def _wire(self, t: torch.Tensor, reduce: bool = False) -> torch.Tensor:
        """``t`` as the backend moves it: on the host under gloo; bfloat16
        as its bits in a float16 container, or as float32 for a
        reduction."""
        if self.transport == "host":
            t = t.detach().to("cpu")
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32) if reduce else t.view(torch.float16)
            elif reduce and t.dtype == torch.float16:
                t = t.to(torch.float32)
        return t.contiguous()

    def _back(self, w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if w.dtype == torch.float16 and like.dtype == torch.bfloat16:
            w = w.view(torch.bfloat16)
        return w.to(device=like.device, dtype=like.dtype)

    # -- collectives over named axes -----------------------------------------
    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """Sum (or max) of ``t`` over the ranks of ``axes``; a new tensor."""
        axes = self._axes(axes)
        if self._group(axes) is None:
            return t.clone()
        self._count("all-reduce", axes, t)
        if self.fake:
            return t.clone()
        w = self._wire(t, reduce=True).clone()
        dist.all_reduce(w, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self._group(axes))
        return self._back(w, t)

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in
        their order along ``axes``."""
        axes = self._axes(axes)
        n = self.axis_size(axes)
        if self._group(axes) is None:
            return t.clone()
        self._count("all-gather", axes, t, n)
        if self.fake:   # every part this rank's own
            return torch.cat([t] * n, dim=dim)
        w = self._wire(t.movedim(dim, 0))
        if self.transport == "host":   # gloo: the list form
            parts = [torch.empty_like(w) for _ in range(n)]
            dist.all_gather(parts, w, group=self._group(axes))
            out = torch.cat(parts)
        else:
            out = w.new_empty((n * w.shape[0],) + tuple(w.shape[1:]))
            dist.all_gather_into_tensor(out, w, group=self._group(axes))
        return self._back(out, t).movedim(0, dim)

    def all_gather_list(self, t: torch.Tensor, axes) -> list[torch.Tensor]:
        """The ranks' ``t`` (sizes along dim 0 may differ), in their order
        along ``axes``."""
        axes = self._axes(axes)
        if self._group(axes) is None:
            return [t.clone()]
        sizes = self.all_gather(torch.tensor([t.shape[0]], dtype=torch.int64,
                                             device=t.device), axes)
        sizes = [int(s) for s in sizes.tolist()]
        pad = max(sizes) - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        full = self.all_gather(t, axes)
        step = max(sizes)
        return [full[i * step:i * step + s] for i, s in enumerate(sizes)]

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int = 0
                       ) -> torch.Tensor:
        """Sum over the ranks of ``axes``, then this rank's equal chunk of
        ``dim``."""
        axes = self._axes(axes)
        n = self.axis_size(axes)
        if self._group(axes) is None:
            return t.clone()
        self._count("reduce-scatter", axes, t)
        if self.fake:
            return t.chunk(n, dim)[self.axis_index(axes)].clone()
        w = self._wire(t.movedim(dim, 0), reduce=True)
        if self.transport == "host":   # gloo: a sum, then this rank's part
            w = w.clone()
            dist.all_reduce(w, group=self._group(axes))
            out = w.chunk(n)[self.axis_index(axes)]
        else:
            out = w.new_empty((w.shape[0] // n,) + tuple(w.shape[1:]))
            dist.reduce_scatter_tensor(out, w, group=self._group(axes))
        return self._back(out, t).movedim(0, dim)

    def reduce(self, t: torch.Tensor, axes, dst: int) -> torch.Tensor:
        """Sum over the ranks of ``axes`` onto the one at index ``dst``
        along them (the others' result is undefined)."""
        axes = self._axes(axes)
        if self._group(axes) is None:
            return t.clone()
        self._count("reduce-scatter", axes, t)
        if self.fake:
            return t.clone()
        w = self._wire(t, reduce=True).clone()
        dist.reduce(w, dst=self.group_ranks(axes)[dst],
                    group=self._group(axes))
        return self._back(w, t)

    def broadcast(self, t: torch.Tensor, axes, src: int) -> torch.Tensor:
        """The tensor of the rank at index ``src`` along ``axes``; the
        others pass a buffer of its shape and dtype."""
        axes = self._axes(axes)
        if self._group(axes) is None:
            return t
        self._count("all-gather", axes, t)
        if self.fake:   # the rank's own buffer, made finite
            return t if self.axis_index(axes) == src else torch.zeros_like(t)
        w = self._wire(t).clone()
        dist.broadcast(w, src=self.group_ranks(axes)[src],
                       group=self._group(axes))
        return self._back(w, t)

    def all_to_all(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Dim 0 cut into equal blocks, block j sent to the j-th rank along
        ``axes``; the received blocks in rank order."""
        axes = self._axes(axes)
        if self._group(axes) is None:
            return t.clone()
        self._count("all-to-all", axes, t)
        if self.fake:
            return t.clone()
        w = self._wire(t)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self._group(axes))
        return self._back(out, t)

    def send(self, t: torch.Tensor, axes, dst: int) -> None:
        """To the rank at index ``dst`` along ``axes`` (its ``recv`` must
        be posted)."""
        self._count("collective-permute", self._axes(axes), t)
        if not self.fake:
            dist.send(self._wire(t), dst=self.group_ranks(axes)[dst])

    def recv(self, like: torch.Tensor, axes, src: int) -> torch.Tensor:
        """From the rank at index ``src`` along ``axes``, into a tensor of
        ``like``'s shape, dtype and device."""
        if self.fake:
            return torch.zeros_like(like)
        w = self._wire(torch.empty_like(like))
        dist.recv(w, src=self.group_ranks(axes)[src])
        return self._back(w, like)

    def barrier(self) -> None:
        if not self.fake:
            dist.barrier()


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``; the world must hold exactly that many ranks."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    need = math.prod(shape.values())
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(f"the production mesh {shape} needs {need} "
                           f"ranks; the world has {world}")
    return Mesh(shape, device=device)


def make_local_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
                    *, device=None) -> Mesh:
    """(n // model_axis, model_axis) ("data", "model") over the world's
    ``n`` ranks (tests, examples, ``launch/train.py``)."""
    n = n_devices or dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into model axis "
                         f"{model_axis}")
    return Mesh({"data": n // model_axis, "model": model_axis},
                device=device)


def validate_mesh(mesh: Mesh) -> dict:
    return {"axes": dict(mesh.shape), "devices": int(mesh.size),
            "platform": "gpu" if mesh.device.type == "cuda" else "cpu"}


# ---------------------------------------------------------------------------
# spawning a world of processes on this host
# ---------------------------------------------------------------------------
def _child(rank: int, world: int, backend: str, rdzv: str, timeout_s: float,
           fn: Callable, args: tuple, out_dir: str) -> None:
    path = os.path.join(out_dir, f"rank{rank}")
    # every rank is on this host: gloo connects over the loopback device,
    # not the interface the host's name resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        init_distributed(rank, world, backend=backend,
                         init_method=f"file://{rdzv}", timeout_s=timeout_s)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(path + ".tmp", "wb") as f:
            pickle.dump(("ok", result), f)
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(path + ".tmp", "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        os.replace(path + ".tmp", path)
        raise


def spawn(fn: Callable, world: int, *, backend: str, deadline_s: float,
          args: Sequence = ()) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes, each in
    one process group (``backend``, a ``file://`` rendezvous in a temporary
    directory) → their results by rank. ``fn`` must be importable by name
    (a module-level function). Raises if a rank fails, with its traceback,
    or when ``deadline_s`` passes; either way every child is killed first.

    The ranks fork from multiprocessing's fork server, a process that
    touches no device. A caller that will spawn from a process grown large
    (the forking of which takes seconds) starts the server early, with the
    modules the ranks import preloaded, so a rank starts in well under a
    second: ``multiprocessing.set_forkserver_preload([...])``, then
    ``multiprocessing.forkserver.ensure_running()``."""
    ctx = multiprocessing.get_context("forkserver")
    tmp = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    procs = []
    try:
        rdzv = os.path.join(tmp, "rendezvous")
        for rank in range(world):
            p = ctx.Process(target=_child, daemon=True, args=(
                rank, world, backend, rdzv, deadline_s, fn, tuple(args),
                tmp))
            p.start()
            procs.append(p)
        end = time.monotonic() + deadline_s
        results: dict[int, tuple] = {}
        while len(results) < world:
            for rank in range(world):
                path = os.path.join(tmp, f"rank{rank}")
                if rank not in results and os.path.exists(path):
                    with open(path, "rb") as f:
                        results[rank] = pickle.load(f)
                    if results[rank][0] == "error":
                        raise RuntimeError(f"rank {rank} of {world} failed:"
                                           f"\n{results[rank][1]}")
            dead = [r for r, p in enumerate(procs) if r not in results
                    and not p.is_alive() and not os.path.exists(
                        os.path.join(tmp, f"rank{r}"))]
            if dead:
                raise RuntimeError(f"rank {dead[0]} of {world} exited with "
                                   f"code {procs[dead[0]].exitcode}")
            if time.monotonic() > end:
                raise TimeoutError(f"{world} ranks passed their "
                                   f"{deadline_s:.0f} s deadline")
            time.sleep(0.02)
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
        return [results[r][1] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def stop_fork_server() -> None:
    """Stop multiprocessing's fork server and its resource tracker, which
    ``spawn`` starts and which otherwise outlive their caller by a moment;
    a program that must leave no process behind calls this last."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
