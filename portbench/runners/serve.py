"""The ``serve`` runner: ``clients`` closed-loop clients, each with one
ε-range query at a time in flight through one ``QueryScheduler``, driven
from one thread. New queries are sent until ``--seconds`` have passed;
the ones in flight then are waited for.

Parameters (the traffic file): ``clients``; ``scheduler``, the
scheduler's keyword arguments (wave size, wait, queue, sharing, and any
query-time ``JoinConfig`` field); ``stream``, ``QueryStream``'s
parameters; ``warm_queries``, queries run in set-up; ``check_queries``,
the sample of the window's answers compared with the reference.
"""
from __future__ import annotations

import queue
import time

import numpy as np

from repro_torch.serve.scheduler import QueryScheduler

from portbench.yardstick import compare
from portbench.yardstick.data import QueryStream, seed_rng
from portbench.yardstick.roofline import query_work

LATE_S = 60.0      # how long answers due in the window are waited for


class Mix:
    def __init__(self, mix: dict, ctx):
        """``ctx``: the run (``harness.Run``): its vectors, seed, device
        and index."""
        self.ctx = ctx
        self.clients = int(mix["clients"])
        self.warm_queries = int(mix.get("warm_queries", 0))
        self.sample = int(mix.get("check_queries", 2000))
        self.index = ctx.open_index()
        self.sched = QueryScheduler(self.index, **mix["scheduler"])
        self.stream = QueryStream(ctx.base, ctx.seed,
                                  anchor_seed=ctx.data_seed,
                                  **mix.get("stream", {}))
        # [query, t_submit, t_done, answer, error, request id]
        self.sent: list[list] = []
        self.accepted = 0          # the scheduler's request ids count these
        self.done: queue.SimpleQueue = queue.SimpleQueue()
        self.window_from = 0       # index of the window's first query
        self.t_close = 0.0
        self.pipe0 = self.pipe1 = None

    def _submit(self) -> None:
        q, _ = self.stream.next()
        k = len(self.sent)
        rec = [q, time.perf_counter(), None, None, None, None]
        self.sent.append(rec)
        try:
            fut = self.sched.submit(q)
        except Exception as e:          # refused: counts as failed
            rec[2], rec[4] = time.perf_counter(), e
            self.done.put(k)
            return
        self.accepted += 1
        rec[5] = self.accepted
        fut.add_done_callback(
            lambda f, k=k: self._finish(k, f, time.perf_counter()))

    def _finish(self, k: int, fut, t: float) -> None:
        rec = self.sent[k]
        rec[2] = t
        err = fut.exception()
        if err is None:
            rec[3] = fut.result()
        else:
            rec[4] = err
        self.done.put(k)

    def _loop(self, until: float, stop_after: int | None = None) -> None:
        """Closed loop: ``clients`` queries in flight, a new one for each
        answer until ``until`` (or ``stop_after`` answers); then the ones
        in flight are waited for, at most ``LATE_S`` past ``until``."""
        for _ in range(self.clients):
            self._submit()
        outstanding, answered = self.clients, 0
        while outstanding:
            wait = until + LATE_S - time.perf_counter()
            if wait <= 0:
                return
            try:
                self.done.get(timeout=wait)
            except queue.Empty:
                return
            outstanding -= 1
            answered += 1
            more = (answered + outstanding < stop_after
                    if stop_after is not None
                    else time.perf_counter() < until)
            if more:
                self._submit()
                outstanding += 1

    def warm(self) -> None:
        if self.warm_queries:
            self._loop(time.perf_counter() + LATE_S, self.warm_queries)

    def window(self, t0: float, seconds: float) -> float:
        self.window_from = len(self.sent)
        self.pipe0 = self.index.pipeline_snapshot()
        self.t_close = t0 + seconds
        self._loop(self.t_close)
        return seconds

    def after_window(self) -> None:
        self.pipe1 = self.index.pipeline_snapshot()

    @property
    def window_queries(self) -> list[list]:
        return self.sent[self.window_from:]

    def answered(self) -> list[list]:
        return [r for r in self.window_queries if r[3] is not None]

    def answered_in_window(self) -> int:
        return sum(r[3] is not None and r[2] <= self.t_close
                   for r in self.window_queries)

    def latencies_s(self) -> np.ndarray:
        return np.asarray([r[2] - r[1] for r in self.answered()])

    def reads(self) -> int:
        return sum(self.pipe1[k] - self.pipe0[k]
                   for k in ("query_reads", "query_fallback_reads"))

    def waves(self, events: list[dict]) -> list[list[int]]:
        """Each wave's answered window queries (positions in
        ``answered()``), from the scheduler's ``serve.request`` ends: its
        request ids count the submissions it accepted, from 1."""
        pos = {r[5]: i for i, r in enumerate(self.answered())}
        waves: dict[int, list[int]] = {}
        for e in events:
            if e.get("name") == "serve.request" and e.get("ph") == "e":
                i = pos.get(e.get("id"))
                wave = (e.get("args") or {}).get("wave")
                if i is not None and wave is not None:
                    waves.setdefault(wave, []).append(i)
        return list(waves.values())

    def work(self, run) -> tuple[float, float] | None:
        """Verify's (operations, bytes) over the window's waves: each
        answered query's probes planned again (no reads), grouped by the
        wave that served it."""
        rows = self.answered()
        if not rows:
            return None
        probes = self.index.plan_probes(np.stack([r[0] for r in rows]))
        waves = [[probes[j] for j in w] for w in self.waves(run.events)]
        members = sum(r[3][0].size for r in rows)
        return query_work(waves, run.sizes, run.dim, members)

    def close(self) -> None:
        self.sched.close()
        self.index.close()

    def attempted_failed(self) -> tuple[int, int]:
        w = self.window_queries
        return len(w), sum(r[3] is None for r in w)

    def summary(self) -> str:
        t = np.asarray([r[2] for r in self.answered()]) - (
            self.t_close - self.ctx.window_s)
        per = np.histogram(t, bins=np.arange(0, self.ctx.window_s + 5, 5))[0]
        return f"answers in each 5 s of the window: {per.tolist()}"

    def numbers(self, x, eps, seed, device) -> dict:
        """The numbers compared: a sample, drawn from the seed, of the
        window's answers against the reference; the window's queries
        that raised or never came back."""
        rows = self.answered()
        rng = seed_rng(seed, 2)
        pick = np.sort(rng.choice(len(rows), min(self.sample, len(rows)),
                                  replace=False)) if rows else []
        Q = (np.stack([rows[i][0] for i in pick]) if len(pick)
             else np.zeros((0, x.shape[1]), np.float32))
        out = compare.query_numbers(x, eps, Q, [rows[i][3] for i in pick],
                                    device)
        out["unanswered"] = self.attempted_failed()[1]
        return out
