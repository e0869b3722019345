"""GPipe pipeline parallelism over a ``stage`` mesh axis: a port of the JAX
package's ``dist/pipeline.py`` (DESIGN §5), one process a stage.

The layer stack is split into S contiguous stages; M microbatches move
through them tick by tick. At tick t every stage runs at once: stage s
computes microbatch (t − s) if it is in flight, then sends its activation
to stage s + 1 (a point-to-point send, where the reference's ``ppermute``
rotates). After T = M + S − 1 ticks every microbatch has crossed every
stage; the bubble fraction (S − 1)/T is the idle-tick share of the
schedule. The last stage's outputs reach every rank by a sum over the
stages, the others adding zeros, as the reference's ``psum`` does. The
forward pass only: nothing here is differentiated.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh


def make_pp_mesh(num_stages: int, *, device=None) -> Mesh:
    """1-D mesh whose only axis is ``stage`` (one rank a stage)."""
    return Mesh({"stage": num_stages}, device=device)


def split_stages(params: torch.Tensor, num_stages: int) -> torch.Tensor:
    """(L, ...) stacked per-layer params -> (S, L/S, ...) stage blocks."""
    L = params.shape[0]
    if L % num_stages:
        raise ValueError(f"{L} layers not divisible into {num_stages} stages")
    return params.reshape((num_stages, L // num_stages) + params.shape[1:])


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """GPipe idle fraction: (S-1) / (M + S - 1)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def _block(stage_params, s: int):
    """Stage s's block of (S, ...) params (a tensor or a dict of them)."""
    if isinstance(stage_params, dict):
        return {k: _block(v, s) for k, v in stage_params.items()}
    return stage_params[s]


def gpipe_forward(stage_fn, mesh: Mesh, num_microbatches: int,
                  axis_name: str = "stage"):
    """Build fwd(stage_params, x) running ``stage_fn`` as a GPipe pipeline.

    ``stage_fn(block_params, x)`` applies one stage's layer block to one
    microbatch. ``stage_params``: (S, ...) tensors (or a dict of them) from
    ``split_stages``, the same on every rank; this rank runs block
    ``mesh.axis_index(axis_name)``. ``x``: (M, mb, ...) microbatches, the
    same on every rank. Returns the (M, mb, ...) outputs on every rank,
    those of applying all stages in order.
    """
    S = mesh.shape[axis_name]
    M = num_microbatches

    def run(stage_params, x):
        s = mesh.axis_index(axis_name)
        block = _block(stage_params, s)
        outputs = torch.zeros_like(x)
        carry = torch.zeros_like(x[0])
        with torch.no_grad():
            for t in range(M + S - 1):
                # stage 0 injects microbatch t (clamped; ticks t >= M feed
                # a dummy whose results never reach the last stage in time)
                inp = x[min(t, M - 1)] if s == 0 else carry
                out = stage_fn(block, inp)
                j = t - (S - 1)
                if j >= 0 and s == S - 1:
                    outputs[j] = out
                # stage s → s + 1; even stages send first, odd receive
                # first, so no pair of blocking calls waits on the other
                if s % 2 == 0:
                    if s + 1 < S:
                        mesh.send(out, axis_name, s + 1)
                    if s > 0:
                        carry = mesh.recv(carry, axis_name, s - 1)
                else:
                    carry = mesh.recv(carry, axis_name, s - 1)
                    if s + 1 < S:
                        mesh.send(out, axis_name, s + 1)
            # only the last stage holds real outputs; the sum replicates them
            return mesh.all_reduce(outputs, axis_name)

    return run
