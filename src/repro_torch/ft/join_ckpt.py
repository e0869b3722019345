"""Async atomic checkpointing of ``DistributedJoin`` progress: a copy of the
JAX package's ``ft/join_ckpt.py`` (numpy only). The on-disk format is the
JAX package's, so a chain written by either package restores in the other.

Checkpoint format (one committed dir per covered superstep):

    <dir>/ckpt_000042/
        pairs.npy       — (R, 2) int64 raw pairs emitted since the
                          previous checkpoint (the *delta*, not a full
                          dump — spills stay O(new work))
        dists.npy       — (R,) float32 distances, row-aligned with pairs
        state.json      — {"superstep": 42, "prev": 37,
                           "watermark_rows": <raw rows ≤ this ckpt>,
                           "fingerprint": "<session config digest>"}
    <dir>/ckpt_000057.tmp/   — torn write from a crash; ignored by
                               restore, reaped on open

Restore walks the committed chain in superstep order, refuses a chain
whose fingerprint mismatches the session (resuming a different config /
dataset into this run would emit garbage), and returns the raw emission
stream up to the watermark. ``DistributedJoin.run(resume_from=…)`` then
re-executes only supersteps past the cursor; because the raw stream is
replayed byte-for-byte and dedup runs over the concatenation exactly as
an uninterrupted run would, the final pairs+distances are byte-identical
and no pair is emitted twice across the watermark.

Saves ride ``AsyncCommitter``'s daemon thread; ``step_done`` uses the
non-blocking ``try_submit`` so a slow disk defers a checkpoint to the
next superstep boundary instead of stalling the verify queued on the
card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time

import numpy as np

from repro_torch.ft.atomic import (AsyncCommitter, atomic_commit_dir,
                                   reap_tmp)
from repro_torch.obs import get_tracer

_CKPT_RE = re.compile(r"ckpt_(\d+)")


@dataclasses.dataclass
class ResumeState:
    """Committed progress handed to ``DistributedJoin.run(resume_from=…)``."""
    superstep: int            # last superstep covered; resume at +1
    pairs: list               # raw per-checkpoint (R,2) int64 deltas, in order
    dists: list               # matching (R,) float32 deltas
    watermark_rows: int       # total raw rows restored
    restore_s: float = 0.0


def _list_committed(directory: str) -> list[tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = _CKPT_RE.fullmatch(d)
        if m and os.path.exists(os.path.join(directory, d, "state.json")):
            out.append((int(m.group(1)), os.path.join(directory, d)))
    return sorted(out)


class JoinCheckpointer:
    """Checkpoints join progress every ``every`` supersteps.

    Usage (what ``DistributedJoin.run`` does internally)::

        ckpt = JoinCheckpointer(dir, every=4)
        ckpt.begin(fp)                      # reaps .tmp, clears stale chains
        for si, step in enumerate(steps):
            ...verify...
            ckpt.step_done(si, pairs, dists)   # never blocks
        ckpt.finish()                       # final blocking save + drain
        ckpt.close()
    """

    def __init__(self, directory: str, *, every: int = 1,
                 async_save: bool = True):
        self.directory = directory
        self.every = max(1, int(every))
        os.makedirs(directory, exist_ok=True)
        reap_tmp(directory)
        self._committer = AsyncCommitter(name="join-ckpt") if async_save \
            else None
        self._fingerprint: str | None = None
        # pending: rows emitted since the last *submitted* checkpoint
        self._pend_pairs: list[np.ndarray] = []
        self._pend_dists: list[np.ndarray] = []
        self._pend_rows = 0
        self._last_committed = -1   # superstep of last submitted ckpt
        self._last_step = -1        # highest superstep seen by step_done
        self._rows_total = 0        # watermark incl. pending
        self.stats = {"saves": 0, "save_s": 0.0, "saved_rows": 0,
                      "deferred": 0}

    # -- write side --------------------------------------------------------

    def begin(self, fingerprint: str, start_superstep: int = 0) -> None:
        """Arm for a run. A fresh run (``start_superstep == 0``) wipes any
        committed chain — stale state from an older config must not be
        concatenated into this run. A resumed run keeps the chain and
        continues appending past the cursor."""
        self._fingerprint = fingerprint
        if start_superstep == 0:
            for _, path in _list_committed(self.directory):
                shutil.rmtree(path, ignore_errors=True)
            self._last_committed = -1
            self._rows_total = 0
        else:
            self._last_committed = start_superstep - 1
            committed = _list_committed(self.directory)
            if committed:
                with open(os.path.join(committed[-1][1], "state.json")) as f:
                    self._rows_total = json.load(f)["watermark_rows"]
        self._last_step = self._last_committed

    def step_done(self, superstep: int, pairs, dists) -> None:
        """Record one superstep's raw emissions (possibly empty — the
        cursor must advance through pair-free steps too) and checkpoint
        at ``every``-step boundaries without blocking."""
        for p, d in zip(pairs, dists):
            if len(p):
                self._pend_pairs.append(np.asarray(p, np.int64))
                self._pend_dists.append(np.asarray(d, np.float32))
                self._pend_rows += len(p)
                self._rows_total += len(p)
        self._last_step = max(self._last_step, int(superstep))
        if (superstep - self._last_committed) >= self.every:
            self._commit(superstep, block=False)

    def finish(self) -> None:
        """Flush everything: blocking final save + drain the writer."""
        if self._last_step > self._last_committed or self._pend_rows:
            self._commit(max(self._last_step, self._last_committed + 1),
                         block=True)
        if self._committer is not None:
            self._committer.drain()

    def close(self) -> None:
        if self._committer is not None:
            self._committer.close()

    def _commit(self, superstep: int, *, block: bool) -> None:
        if self._fingerprint is None:
            raise RuntimeError("JoinCheckpointer.begin() not called")
        if superstep <= self._last_committed:
            return
        pairs = (np.concatenate(self._pend_pairs)
                 if self._pend_pairs else np.zeros((0, 2), np.int64))
        dists = (np.concatenate(self._pend_dists)
                 if self._pend_dists else np.zeros((0,), np.float32))
        state = {"superstep": int(superstep),
                 "prev": int(self._last_committed),
                 "watermark_rows": int(self._rows_total),
                 "fingerprint": self._fingerprint}

        def _write() -> None:
            t0 = time.perf_counter()
            with get_tracer().span("ft.save", superstep=int(superstep),
                                   rows=int(pairs.shape[0])):
                def fill(tmp: str) -> None:
                    np.save(os.path.join(tmp, "pairs.npy"), pairs)
                    np.save(os.path.join(tmp, "dists.npy"), dists)
                    with open(os.path.join(tmp, "state.json"), "w") as f:
                        json.dump(state, f)
                atomic_commit_dir(self.directory,
                                  f"ckpt_{superstep:06d}", fill)
            self.stats["saves"] += 1
            self.stats["save_s"] += time.perf_counter() - t0
            self.stats["saved_rows"] += int(pairs.shape[0])

        if self._committer is None:
            _write()
        elif block:
            self._committer.submit(_write)
        elif not self._committer.try_submit(_write):
            # writer busy: keep pending, retry at the next boundary —
            # the verify pipeline never waits on disk
            self.stats["deferred"] += 1
            return
        self._pend_pairs, self._pend_dists = [], []
        self._pend_rows = 0
        self._last_committed = int(superstep)

    # -- read side ---------------------------------------------------------

    @staticmethod
    def restore(directory: str, *, fingerprint: str) -> ResumeState | None:
        """Load the committed chain → ``ResumeState``, or None when no
        checkpoint exists. Torn ``.tmp`` dirs are reaped; a fingerprint
        mismatch raises — resuming foreign state is never silent."""
        t0 = time.perf_counter()
        with get_tracer().span("ft.restore"):
            reap_tmp(directory)
            committed = _list_committed(directory)
            if not committed:
                return None
            pairs, dists = [], []
            prev = -1
            cursor = -1
            watermark = 0
            for step, path in committed:
                with open(os.path.join(path, "state.json")) as f:
                    state = json.load(f)
                if state.get("fingerprint") != fingerprint:
                    raise ValueError(
                        f"checkpoint {path} was written for config "
                        f"fingerprint {state.get('fingerprint')!r} but this "
                        f"session is {fingerprint!r} — refusing to resume; "
                        "delete the checkpoint directory to start fresh")
                if state["prev"] != prev:
                    # hole in the chain (manual deletion): use the valid
                    # prefix rather than resuming past missing rows
                    break
                p = np.load(os.path.join(path, "pairs.npy"))
                d = np.load(os.path.join(path, "dists.npy"))
                if len(p):
                    pairs.append(np.asarray(p, np.int64))
                    dists.append(np.asarray(d, np.float32))
                prev = step
                cursor = step
                watermark = state["watermark_rows"]
            if cursor < 0:
                return None
        return ResumeState(superstep=cursor, pairs=pairs, dists=dists,
                           watermark_rows=watermark,
                           restore_s=time.perf_counter() - t0)
