"""The ``join`` runner: each step opens a new ``DiskJoinIndex`` session
over the built index and self-joins it (graph, node order and schedule
planned again, as a new process would), steps back to back. The window
closes when the first step ends at or after ``--seconds``.

Parameters (the traffic file): ``overrides``, query-time ``JoinConfig``
fields passed to ``self_join`` (``io_mode``, ``plan_mode``, ...), so that
a join cell under other settings is a data file. Set-up runs one join.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.obs import get_tracer

from portbench.yardstick import compare
from portbench.yardstick.data import seed_rng
from portbench.yardstick.roofline import join_work


class Mix:
    def __init__(self, mix: dict, ctx):
        """``ctx``: the run (``harness.Run``): its vectors, seed, device
        and index."""
        self.ctx = ctx
        self.overrides = dict(mix.get("overrides", {}))
        self.steps: list[dict] = []
        self.outputs: list[tuple[np.ndarray, np.ndarray]] = []
        self.edges = None

    def _join(self, keep: bool) -> None:
        tr = get_tracer()
        t0 = time.perf_counter()
        with tr.span("bench.step"):
            with tr.span("bench.open"):
                idx = self.ctx.open_index()
            with tr.span("bench.self_join"):
                res = idx.self_join(**self.overrides)
                if self.ctx.device.type == "cuda":
                    torch.cuda.synchronize(self.ctx.device)
            if keep and self.ctx.trace and self.edges is None:
                cfg = idx._resolve(self.overrides)
                self.edges = idx._graph_for(cfg)[0].edges
            with tr.span("bench.close"):
                idx.close()
        wall = time.perf_counter() - t0
        if keep:
            self.steps.append(dict(
                wall_s=wall, timings=dict(res.timings),
                bucket_loads=int(res.bucket_loads),
                pairs_verified=int(res.num_distance_computations),
                pairs_emitted=int(res.pairs.shape[0]),
                digest=compare.digest(res.pairs, res.distances)))
            self.outputs.append((res.pairs, res.distances))

    def warm(self) -> None:
        self._join(keep=False)

    def window(self, t0: float, seconds: float) -> float:
        while True:
            self._join(keep=True)
            t = time.perf_counter()
            if t - t0 >= seconds:
                return t - t0

    def after_window(self) -> None:
        pass

    def work(self, run) -> tuple[float, float] | None:
        """Verify's (operations, bytes) over the window's joins."""
        if self.edges is None:
            return None
        ops = nbytes = 0.0
        for s in self.steps:
            o, b = join_work(self.edges, run.sizes, run.dim,
                             s["pairs_verified"], s["pairs_emitted"])
            ops, nbytes = ops + o, nbytes + b
        return ops, nbytes

    def close(self) -> None:
        pass

    def attempted_failed(self) -> tuple[int, int]:
        return len(self.steps), 0

    def summary(self) -> str:
        return "join steps (wall s, execute s): " + " ".join(
            f"{s['wall_s']:.3f}/{s['timings']['execute']:.3f}"
            for s in self.steps)

    def numbers(self, x, eps, seed, device) -> dict:
        """The numbers compared: one join of the window, drawn from the
        seed, against the reference; the others by their bytes."""
        k = int(seed_rng(seed, 2).integers(len(self.outputs)))
        pairs, dists = self.outputs[k]
        out = compare.join_numbers(x, eps, pairs, dists, device)
        out["joins_differ"] = sum(s["digest"] != self.steps[k]["digest"]
                                  for s in self.steps)
        return out
