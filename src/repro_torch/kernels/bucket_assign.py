"""Launch of the fused nearest-center CUDA kernels, which replace the JAX
package's Pallas ``bucket_assign``. Two routes, chosen per call by
``launch_plan`` from the operand shapes alone:

* ``"tc"`` — rows 16-byte aligned (d % 4 == 0: the whole main path):
  ``csrc/bucket_assign_sm90.cu``, split-precision (3×TF32) ``wgmma`` on
  the tensor cores fed by TMA (the verify kernel's main loop), over a grid
  of (row tiles, center splits), each keeping a row's best two and its
  third least d²; a second pass recomputes in the ``simt`` route's float32
  arithmetic each row's best two and every other candidate that could
  come within reach of the winner (``csrc/l2_sm90.cuh``'s band), and
  rescans a split's centers where the ones it dropped could: the argmin
  and its d² are the ``simt`` route's bytes on every row, however many
  centers tie;
* ``"simt"`` — the rest: ``csrc/bucket_assign.cu`` on the CUDA cores.

There is no fallback between routes: a refused launch raises. Callers go
through ``ops``, which checks inputs, dispatches by device and counts
launches."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
# the tensor-core route shares the verify kernel's main loop, and with it
# the row alignment, the tile shapes and the copy of unaligned views
from repro_torch.kernels.pairwise_l2 import (SMALL_ROWS, TC_ALIGN, aligned,
                                             recheck_counter)

TARGET_BLOCKS = 2 * 132   # two blocks on each of an H100's 132 SMs
ROUTE_COUNTERS = {"tc": "assign_tc", "simt": "assign_simt"}


@dataclass(frozen=True)
class LaunchPlan:
    """How one assign launch runs: its route and, for the tensor-core
    route, the rows of a block (= the columns of a center tile), 128 or
    64, and the number of center ranges each row tile is split into."""
    route: str
    block_m: int = 128
    splits: int = 1


def launch_plan(m: int, b: int, d: int) -> LaunchPlan:
    """The route, tile and split count for (m, d) rows × (b, d) centers; a
    pure function of the shapes. The splits bring the grid to about
    ``TARGET_BLOCKS`` blocks where the centers allow, in ranges of equal
    numbers of center tiles but the last (a split never changes a
    result)."""
    if d % TC_ALIGN:
        return LaunchPlan("simt")
    block_m = SMALL_ROWS if m <= SMALL_ROWS else 128
    row_tiles = -(-m // block_m)
    center_tiles = -(-b // block_m)
    splits = max(1, min(center_tiles, TARGET_BLOCKS // row_tiles))
    per = -(-center_tiles // splits)
    return LaunchPlan("tc", block_m, -(-center_tiles // per))


def bucket_assign(x: torch.Tensor, centers: torch.Tensor, plan: LaunchPlan):
    """(M, d) × (B, d) float32 contiguous CUDA tensors →
    (min_d2 (M,) float32, argmin (M,) int32), launched on the current
    stream by ``plan``'s route."""
    if not (x.is_contiguous() and centers.is_contiguous()):
        raise ValueError("the assign kernels read contiguous operands")
    m, d = x.shape
    b = centers.shape[0]
    mind2 = torch.empty(m, dtype=torch.float32, device=x.device)
    idx = torch.empty(m, dtype=torch.int32, device=x.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.route == "tc":
        x, centers = aligned(x), aligned(centers)
        # each row's best two (d², index) of each split and its third d²,
        # as 64-bit keys
        cand = torch.empty((m, plan.splits, 3), dtype=torch.int64,
                           device=x.device)
        rc = lib.bucket_assign_sm90_launch(
            x.data_ptr(), centers.data_ptr(), cand.data_ptr(),
            mind2.data_ptr(), idx.data_ptr(), m, b, d, plan.block_m,
            plan.splits, recheck_counter(x.device, 1), x.device.index,
            stream)
    else:
        rc = lib.bucket_assign_launch(
            x.data_ptr(), centers.data_ptr(), mind2.data_ptr(),
            idx.data_ptr(), m, b, d, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"bucket_assign {plan.route} kernel launch failed "
                           f"(cudaError {rc}) at M={m} B={b} d={d}")
    return mind2, idx
