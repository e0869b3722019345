"""Training loop with checkpoint/restart and straggler telemetry: a port of
the JAX package's ``train/train_loop.py`` on one card.

As in the reference: the parameters come from ``bundle.init(seed)``, the
batches from ``TokenPipeline`` (step t's batch is a function of (seed, t));
after step t with t > 0 and t % checkpoint_every == 0 the parameters, the
optimizer state and the pipeline cursor are saved as step t + 1, and a
restart restores the newest checkpoint and runs on from its step. Steps are
timed by ``runtime.straggler.StepTimer`` (host clock around the step and
the read of its loss, which waits for the card). ``mesh`` is the
reference's sharded run and needs more than one card: it raises (ROADMAP
§1 item 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
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
          grad_transform=None,
          on_step: Optional[Callable[[int, dict], None]] = None) -> dict:
    """Train a model end to end on ``device`` (None: CUDA). Returns the
    reference's final metrics."""
    from repro_torch.launch.steps import make_train_step  # lazy: cycle
    if mesh is not None:
        raise NotImplementedError(
            "train(mesh=...) shards over several cards; the port runs on "
            "one (ROADMAP §1 item 1: multi-card)")
    bundle = build_model(cfg, device=device)
    opt = AdamW(tcfg.optimizer, grad_transform=grad_transform)
    step_fn = make_train_step(bundle, opt)

    pipeline = TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=tcfg.seq_len,
        global_batch=tcfg.global_batch, seed=tcfg.seed))

    params = bundle.init(tcfg.seed)
    opt_state = opt.init(params)
    start_step = 0

    manager = None
    if tcfg.checkpoint_dir:
        manager = CheckpointManager(tcfg.checkpoint_dir)
        restored = restore_latest(tcfg.checkpoint_dir,
                                  _state(params, opt_state))
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
            if step % tcfg.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({timer.mean_ms:.0f} ms/step)")
            if manager and step and step % tcfg.checkpoint_every == 0:
                pipeline.step = step + 1
                manager.save(step + 1, _state(params, opt_state),
                             extra={"pipeline": pipeline.state()})
    finally:
        if manager:
            manager.close()
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "loss_history": losses,
        "mean_step_ms": timer.mean_ms,
        "straggler_report": timer.report(),
    }
