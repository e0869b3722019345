"""Training loop with checkpoint/restart and straggler telemetry: a port of
the JAX package's ``train/train_loop.py`` on one card.

As in the reference: the parameters come from ``bundle.init(seed)``, the
batches from ``TokenPipeline`` (step t's batch is a function of (seed, t));
after step t with t > 0 and t % checkpoint_every == 0 the parameters, the
optimizer state and the pipeline cursor are saved as step t + 1, and a
restart restores the newest checkpoint and runs on from its step. Steps are
timed by ``runtime.straggler.StepTimer`` (host clock around the step and
the read of its loss, which waits for the card).

``mesh`` (a ``launch.mesh.Mesh``, one process a rank, each calling
``train``) is the reference's sharded run: the parameters are held as
``dist.sharding.ShardedParams`` (``fsdp`` also spreads them over ``data``),
each step runs this rank's rows of the global batch with each block's
compute split over the ``model`` axis (``dist.tensor_parallel``), and the
losses are one card's to the rounding of the split sums. A checkpoint holds full arrays: the ranks gather them leaf by
leaf, and rank 0 alone copies them to the host and writes; a restart cuts
them to the current mesh (``restore_latest(..., shardings=...)``), whatever
mesh wrote them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.dist import sharding as shd
from repro_torch.models import build_model
from repro_torch.runtime.straggler import StepTimer
from repro_torch.train.optimizer import AdamW, AdamWConfig


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def _state(params, opt_state) -> dict:
    return {"params": dict(params.named_parameters()), "opt": opt_state}


def _full_state(store, opt_state, keep: bool) -> Optional[dict]:
    """The state with full tensors on the host, on the rank that ``keep``s
    it; None on the others. Collective: every rank takes part in each
    leaf's gather, one leaf at a time, and only the keeper copies it to
    the host, so the host holds the full state once."""
    def host(parts):
        out = {}
        for n, t in parts.items():
            full = store.full({n: t})[n]
            if keep:
                out[n] = full.cpu()
        return out
    opt = {k: host(v) if isinstance(v, dict) else v
           for k, v in opt_state.items()}
    params = host(dict(store.named_parameters()))
    return {"params": params, "opt": opt} if keep else None


@torch.no_grad()
def _load(params, opt_state: dict, tree: dict) -> None:
    """Copy a restored tree into the live parameters and optimizer state."""
    for name, p in params.named_parameters():
        p.copy_(tree["params"][name])
    for key in ("mu", "nu", "error"):
        for name, t in opt_state.get(key, {}).items():
            t.copy_(tree["opt"][key][name])
    opt_state["step"] = int(tree["opt"]["step"])


def train(cfg: ArchConfig, tcfg: TrainConfig, *, device=None, mesh=None,
          fsdp: bool = False, grad_transform=None,
          on_step: Optional[Callable[[int, dict], None]] = None) -> dict:
    """Train a model end to end on ``device`` (None: CUDA), or on ``mesh``
    (its device). Returns the reference's final metrics."""
    from repro_torch.launch.steps import (  # lazy: cycle
        make_train_step, opt_state_shardings)
    if mesh is not None:
        device = mesh.device
    bundle = build_model(cfg, device=device)
    opt = AdamW(tcfg.optimizer, grad_transform=grad_transform)
    step_fn = make_train_step(bundle, opt, mesh)

    pipeline = TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=tcfg.seq_len,
        global_batch=tcfg.global_batch, seed=tcfg.seed))

    params = bundle.init(tcfg.seed)
    shardings = None
    if mesh is not None:
        shd.set_mesh(mesh)
        params = shd.ShardedParams(params, mesh, fsdp=fsdp,
                                   batch_rows=tcfg.global_batch)
    opt_state = opt.init(params)
    if mesh is not None:
        shardings = {"params": params.shardings,
                     "opt": opt_state_shardings(mesh, opt_state,
                                                params.shardings)}
    start_step = 0

    manager = None
    writer = mesh is None or mesh.rank == 0
    if tcfg.checkpoint_dir:
        manager = CheckpointManager(tcfg.checkpoint_dir) if writer else None
        restored = restore_latest(tcfg.checkpoint_dir,
                                  _state(params, opt_state),
                                  shardings=shardings)
        if restored is not None:
            start_step, tree, extra = restored
            _load(params, opt_state, tree)
            if "pipeline" in extra:
                pipeline.restore(extra["pipeline"])

    timer = StepTimer()
    losses = []
    try:
        for step in range(start_step, tcfg.steps):
            batch = {k: torch.as_tensor(v, device=bundle.device)
                     for k, v in pipeline.batch_at(step).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            timer.record(time.perf_counter() - t0)
            losses.append(loss)
            if on_step is not None:
                on_step(step, {k: float(v) for k, v in metrics.items()})
            if step % tcfg.log_every == 0 and writer:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({timer.mean_ms:.0f} ms/step)")
            if (tcfg.checkpoint_dir and step
                    and step % tcfg.checkpoint_every == 0):
                pipeline.step = step + 1
                state = (_state(params, opt_state) if mesh is None
                         else _full_state(params, opt_state, writer))
                if manager:
                    manager.save(step + 1, state,
                                 extra={"pipeline": pipeline.state()})
    finally:
        if manager:
            manager.close()
        shd.set_mesh(None)
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "loss_history": losses,
        "mean_step_ms": timer.mean_ms,
        "straggler_report": timer.report(),
    }
