"""Census of one executed step: the counterpart of the JAX package's
``launch/hlo_cost.py::analyze_hlo`` and ``hlo_analysis.summarize_cost``.

The reference walks the compiled HLO of a step; PyTorch has no compiled
artifact, so this counts the step as it runs, under a
``TorchDispatchMode``:

* **FLOPs** from ``torch.utils.flop_counter``'s registered formulas (the
  matrix products and convolutions, 2 × output × contraction, as XLA
  counts dots), with ``FlopCounterMode``'s handling: an op without a
  formula is decomposed where it can be, and metadata queries pass;
* **bytes** as the operand and result bytes of every aten op that writes
  (an in-place op's written operand counts as read and as written). In
  eager mode every op is its own kernel, which is what ``hlo_cost``
  counts at fusion boundaries. Views, reshapes and other metadata ops
  count nothing, and neither does an allocation that writes nothing
  (``empty``);
* **the hand-written kernels**, which launch through ``ctypes`` and which
  no dispatch-level counter sees: while the census runs,
  ``kernels.ops.COST_HOOK`` adds ``roofline.kernel_cost``'s FLOPs and
  bytes at every launch, under the kernel's counter name. The FLOPs it
  adds are the kernel's plain version's count on the CPU
  (``plain_flops``: the dense products, as XLA counts the reference's),
  so the same step counts the same FLOPs on the card as on the CPU.

Both are totalled by op name and by dtype (a kernel on a 3×TF32 route
counts its products under ``"tf32x3"``). Beside the dense count,
``work_flops`` (and ``work_flops_by_dtype``) counts what the step must
compute: an attention kernel's products over the (query, key) pairs its
mask lets through (``roofline.attention_counts``), every other op as in
the dense count. The roofline prices its compute term from the work
count. One card has no collectives: ``collective_traffic_bytes`` is 0.

    with OpCost() as census:
        step(*args)
    census.summary()   # {"flops", "flops_by_dtype", "bytes", ...}
"""
from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops
from repro_torch.launch.roofline import attention_counts, kernel_cost

aten = torch.ops.aten

# metadata queries: FlopCounterMode's own list, passed through uncounted
_QUERIES = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
            aten.is_contiguous.memory_format,
            aten.is_strides_like_format.default,
            aten.is_non_overlapping_and_dense.default, aten.size.default,
            aten.sym_size.default, aten.stride.default,
            aten.sym_stride.default, aten.storage_offset.default,
            aten.sym_storage_offset.default, aten.numel.default,
            aten.sym_numel.default, aten.dim.default,
            torch.ops.prim.layout.default}
# ops that move no bytes although their schema does not mark them a view:
# copy-free reshapes, and allocations that write nothing
_NO_BYTES = {aten._unsafe_view.default, aten._reshape_alias.default,
             aten.lift_fresh.default, aten.empty.memory_format,
             aten.empty_strided.default, aten.empty_like.default,
             aten.new_empty.default, aten.new_empty_strided.default,
             aten.resize_.default, aten.set_.source_Storage,
             aten.set_.source_Storage_storage_offset,
             aten._local_scalar_dense.default}


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class OpCost(TorchDispatchMode):
    """Counts the FLOPs and bytes of everything run inside it (module
    docstring). One census at a time: two do not nest."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.flops_by_dtype: collections.Counter = collections.Counter()
        self.work_flops_by_dtype: collections.Counter = \
            collections.Counter()
        self.bytes_by_dtype: collections.Counter = collections.Counter()
        self.by_op: dict = {}
        self.kernels: dict = {}
        self._prev_hook = None
        self._depth = 0

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        # the mode re-enters itself to count a decomposition: only the
        # outermost entry sets the launch hook, and its exit clears it
        if self._depth == 0:
            self._prev_hook = ops.COST_HOOK
            ops.COST_HOOK = self._kernel
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            ops.COST_HOOK = self._prev_hook
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        if func not in flop_registry and func is not \
                torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        flops = 0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        moved = 0
        if not (func.is_view or func in _NO_BYTES):
            moved = _nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out))
        if not (flops or moved):
            return
        outs = _tensors(out) or _tensors(args)
        dtype = ops.dtype_name(outs[0].dtype) if outs else "none"
        self._add(str(packet).removeprefix("aten."), dtype, flops, moved)

    def _add(self, name: str, dtype: str, flops, moved,
             work=None) -> None:
        """Count one op or launch; ``work``, where it is less than
        ``flops``, is the part of it the step must compute."""
        self.flops += flops
        self.bytes += moved
        if flops:
            self.flops_by_dtype[dtype] += flops
            self.work_flops_by_dtype[dtype] += flops if work is None \
                else work
        if moved:
            self.bytes_by_dtype[dtype] += moved
        rec = self.by_op.setdefault(name, {"count": 0, "flops": 0,
                                           "bytes": 0})
        rec["count"] += 1
        rec["flops"] += flops
        rec["bytes"] += moved

    # -- the launch sites ----------------------------------------------------
    def _kernel(self, counter: str, kernel: str, shape, dtype: str,
                route: str, mask: dict | None = None) -> None:
        """``ops.COST_HOOK``: one launch of a hand-written kernel; ``mask``
        the attention call's ``causal``, ``window``, ``q_offset`` and
        ``kv_positions``."""
        counts = {}
        if mask is not None:
            pos = mask["kv_positions"]
            if pos is not None:
                with _disable_current_modes():   # a copy, not the step's
                    pos = pos.cpu().numpy()
            counts = attention_counts(
                shape[1], shape[2], causal=mask["causal"],
                window=mask["window"], q_offset=mask["q_offset"],
                positions=pos)
        cost = kernel_cost(kernel, shape, dtype, route, **counts)
        ((cls, work),) = cost["flops"].items()
        flops, moved = int(cost["plain_flops"]), int(cost["bytes"])
        self._add(counter, cls, flops, moved, int(work))
        rec = self.kernels.setdefault(counter, {"launches": 0, "flops": 0,
                                                "work_flops": 0, "bytes": 0,
                                                "routes": {}})
        rec["launches"] += 1
        rec["flops"] += flops
        rec["work_flops"] += int(work)
        rec["bytes"] += moved
        rec["routes"][route] = rec["routes"].get(route, 0) + 1

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "work_flops": sum(self.work_flops_by_dtype.values()),
            "work_flops_by_dtype": dict(self.work_flops_by_dtype),
            "bytes": self.bytes,
            "bytes_by_dtype": dict(self.bytes_by_dtype),
            "by_op": {k: dict(v) for k, v in sorted(
                self.by_op.items(), key=lambda kv: -kv[1]["flops"])},
            "kernels": {k: dict(v, routes=dict(v["routes"]))
                        for k, v in self.kernels.items()},
            "collective_traffic_bytes": 0,
        }

