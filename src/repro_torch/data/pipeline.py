"""Deterministic, resumable, sharded data pipeline: a numpy copy of the JAX
package's ``data/pipeline.py`` (its batches are byte-identical).

A ``TokenPipeline`` yields fixed-shape token batches from an (emulated)
corpus with three production properties:

  * **determinism** — batch t is a pure function of (seed, step), so every
    host computes its own shard with zero coordination;
  * **resumability** — the cursor is one integer (`step`), checkpointed in
    the manifest; restore → identical stream continuation;
  * **sharding** — each host materializes only its
    ``global_batch / num_hosts`` slice.

The dedup stage (``repro_torch.data.dedup``) plugs in as a document filter
built from DiskJoin output — the paper's flagship application.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    drop_ids: Optional[np.ndarray] = None   # dedup-dropped document ids
    docs_per_batch_element: int = 1


class TokenPipeline:
    """Synthetic-corpus pipeline with deterministic per-step RNG.

    Documents are id-addressed; a document's tokens are a pure function of
    its id. ``drop_ids`` (from semantic dedup) are skipped by remapping to
    their survivor representative — mirroring how a real pipeline consumes
    the DiskJoin output.
    """

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide among hosts")
        self.local_batch = cfg.global_batch // cfg.num_hosts
        self._drop_lookup = (set(int(i) for i in cfg.drop_ids)
                             if cfg.drop_ids is not None else set())
        self.step = 0

    # -- determinism core ----------------------------------------------------
    def _doc_ids_for_step(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, step))
        ids = rng.integers(0, 2 ** 31 - 1,
                           size=(self.cfg.global_batch,))
        lo = self.cfg.host_id * self.local_batch
        return ids[lo:lo + self.local_batch]

    def _doc_tokens(self, doc_id: int) -> np.ndarray:
        if doc_id in self._drop_lookup:
            doc_id = doc_id // 2  # deterministic survivor remap
        rng = np.random.default_rng((doc_id, 7))
        return rng.integers(0, self.cfg.vocab,
                            size=(self.cfg.seq_len,), dtype=np.int32)

    # -- public API -----------------------------------------------------------
    def batch_at(self, step: int) -> dict:
        ids = self._doc_ids_for_step(step)
        tokens = np.stack([self._doc_tokens(int(i)) for i in ids])
        return {"tokens": tokens, "labels": tokens.copy()}

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b

    # -- checkpoint integration ------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed,
                "host_id": self.cfg.host_id}

    def restore(self, state: dict) -> None:
        if state.get("seed") != self.cfg.seed:
            raise ValueError("pipeline seed mismatch on restore")
        self.step = int(state["step"])
