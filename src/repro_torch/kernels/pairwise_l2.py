"""Launch of the batched pairwise squared-L2 + threshold CUDA kernels, which
replace the JAX package's Pallas ``pairwise_l2_threshold_batched`` and, as
their E = 1 launch, ``pairwise_l2_threshold``. Two routes, chosen per call
by ``launch_plan`` from the operand shapes alone (never from E):

* ``"tc"`` — rows 16-byte aligned (d % 4 == 0: the whole main path):
  ``csrc/pairwise_l2_sm90.cu``, split-precision (3×TF32) ``wgmma`` on the
  tensor cores fed by TMA, in 128 × 128 output tiles, or 64 × 64 where
  M ≤ 64 (the point queries' tile). It gives the ``simt`` route's mask on
  every pair: an output whose d² lies within a band of ε² derived from the
  arithmetic (``csrc/l2_sm90.cuh``: κ(d)·2⁻²³·(‖a‖² + ‖b‖²)) is recomputed
  in the ``simt`` route's float32 arithmetic, and its d² and mask are
  ``simt``'s bytes. Elsewhere d² is the tensor cores' own (within the band
  of ``simt``'s). Pairs whose squared norms sum to 2¹⁰⁰ or more (the
  callers' pad rows, 1e15 in every coordinate) are not recomputed;
* ``"simt"`` — the rest: ``csrc/pairwise_l2.cu`` on the CUDA cores.

There is no fallback between routes: a refused launch raises. Callers go
through ``ops``, which checks inputs, dispatches by device and counts
launches. ``counting_rechecks`` tallies, on the card, the pairs the
``tc`` route recomputed and the rows the assign kernel rescanned."""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import _build

TC_ALIGN = 4        # d % 4 == 0: TMA reads the rows at 16-byte strides
SMALL_ROWS = 64     # M at or below which the tensor-core route takes 64-row
ROUTE_COUNTERS = {"tc": "verify_tc", "simt": "verify_simt"}
# the tensor-core kernels' re-check tallies while ``counting_rechecks`` is
# on: a (2,) int64 tensor on one card, [0] verify's recomputed pairs, [1]
# assign's rescanned rows; None (the kernels get a null pointer) otherwise
RECHECKS: torch.Tensor | None = None


@contextlib.contextmanager
def counting_rechecks(device):
    """Tally the ``tc`` routes' re-checks on ``device`` inside the block:
    yields the (2,) int64 counts, which the kernels add to on the device
    (read them after the block; nothing here synchronises). Launches on
    another device are not counted."""
    global RECHECKS
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    RECHECKS = counts
    try:
        yield counts
    finally:
        RECHECKS = None


def recheck_counter(device: torch.device, which: int) -> int:
    """The device address of tally ``which`` for a launch on ``device``,
    or 0 (none)."""
    counts = RECHECKS
    if counts is None or counts.device != device:
        return 0
    return counts.data_ptr() + 8 * which


def band_scale(d: int) -> float:
    """κ(d)·2⁻²³ of the re-check band, ``csrc/l2_sm90.cuh::band_scale``:
    a pair's ``tc`` and ``simt`` d² differ by at most
    ``band_scale(d) * (|a|² + |b|²) + 2⁻¹⁰⁰``."""
    nk = np.float32(-(-d // 32))
    return float((np.float32(112.0) + (np.float32(d) + nk)
                  * np.float32(33.0 / 64.0)) * np.float32(2.0 ** -23))


@dataclass(frozen=True)
class LaunchPlan:
    """How one verify launch runs: its route and, for the tensor-core
    route, the output rows (= columns) of a block, 128 or 64."""
    route: str
    block_m: int = 128


def launch_plan(m: int, n: int, d: int) -> LaunchPlan:
    """The route and tile for (E, m, d) × (E, n, d) operands; a pure
    function of the shapes (E plays no part, so a lane's bytes never
    depend on the batch it was launched in)."""
    del n  # every route masks ragged columns itself
    if d % TC_ALIGN == 0:
        return LaunchPlan("tc", SMALL_ROWS if m <= SMALL_ROWS else 128)
    return LaunchPlan("simt")


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself, or a fresh copy where its base address is not 16-byte
    aligned (a view into a larger tensor)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def pairwise_l2_threshold_batched(a: torch.Tensor, b: torch.Tensor,
                                  eps2: float, plan: LaunchPlan):
    """(E, M, d) × (E, N, d) float32 contiguous CUDA tensors →
    (d2 (E, M, N) float32, mask (E, M, N) int8), launched on the current
    stream by ``plan``'s route. ``eps2`` is passed to the kernel as a
    float32."""
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the verify kernels read contiguous operands")
    e, m, d = a.shape
    n = b.shape[1]
    d2 = torch.empty((e, m, n), dtype=torch.float32, device=a.device)
    mask = torch.empty((e, m, n), dtype=torch.int8, device=a.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if plan.route == "tc":
        a, b = aligned(a), aligned(b)
        rc = lib.pairwise_l2_sm90_launch(
            a.data_ptr(), b.data_ptr(), d2.data_ptr(), mask.data_ptr(),
            e, m, n, d, eps2, plan.block_m, recheck_counter(a.device, 0),
            a.device.index, stream)
    else:
        rc = lib.pairwise_l2_threshold_launch(
            a.data_ptr(), b.data_ptr(), d2.data_ptr(), mask.data_ptr(),
            e, m, n, d, eps2, a.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_l2_threshold {plan.route} kernel launch "
                           f"failed (cudaError {rc}) at E={e} M={m} N={n} "
                           f"d={d}")
    return d2, mask
