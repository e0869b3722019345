"""The benchmark's inputs, made from ``--seed``: vectors, ε and queries.

Frozen copies, so that a change to the program cannot move the yardstick:

- ``clustered_vectors`` is ``repro_torch.data.synthetic.clustered_vectors``
  line for line (NumPy, so a seed gives the same bytes on every machine);
- ``epsilon_for_avg_neighbors`` computes what the program's version of the
  same name computes (the median over 512 sampled rows of the distance to
  the k-th neighbour, in float64), in PyTorch on the run's device, so that
  the 100,000 × 960 calibration takes a fraction of a second on the card;
- ``QueryStream`` is ``chip_smoke.py``'s ``fig22_requests`` (after
  ``benchmarks/fig22_scheduler.py``): 70 % of queries near one of 16 hot
  anchors, 30 % roaming, N(0, 0.01) noise, drawn in fixed-size chunks so
  that the k-th query of a seed is the same however many a run takes.

A seed changes the order of the work, not its amount: the vectors and
the hot anchors come from the configuration's ``data_seed``, ε from those
vectors, and the run's seed permutes the rows and draws the queries.
"""
from __future__ import annotations

import numpy as np
import torch

STREAM_CHUNK = 4096


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent NumPy generator per (run seed, purpose)."""
    return np.random.default_rng([int(seed), int(stream)])


def clustered_vectors(n: int, dim: int, *, clusters: int | None = None,
                      spread: float = 1.0, cluster_std: float = 0.08,
                      cluster_std_range: tuple | None = None,
                      intrinsic_dim: int | None = None,
                      seed=0) -> np.ndarray:
    """Gaussian-mixture embeddings with low intrinsic dimension: the
    mixture is sampled in an ``intrinsic_dim``-dimensional latent space
    (default min(dim, 12)), projected through a random orthonormal map,
    plus small ambient noise."""
    rng = np.random.default_rng(seed)
    clusters = clusters or max(4, n // 256)
    idim = intrinsic_dim or min(dim, 12)
    centers = rng.normal(scale=spread, size=(clusters, idim))
    assign = rng.integers(0, clusters, size=n)
    if cluster_std_range is not None:
        lo, hi = cluster_std_range
        stds = np.exp(rng.uniform(np.log(lo), np.log(hi), size=clusters))
        per_point_std = stds[assign][:, None]
    else:
        per_point_std = cluster_std
    z = centers[assign] + rng.normal(size=(n, idim)) * per_point_std
    if idim == dim:
        x = z
    else:
        proj = np.linalg.qr(rng.normal(size=(dim, idim)))[0]  # orthonormal
        x = z @ proj.T + rng.normal(scale=cluster_std * 0.1, size=(n, dim))
    return x.astype(np.float32)


def epsilon_for_avg_neighbors(x: np.ndarray, k: int, *, sample: int = 512,
                              seed: int = 0, block: int = 64,
                              device="cpu") -> float:
    """ε such that the average number of ε-neighbours is about ``k``: the
    median, over ``sample`` rows drawn with ``seed``, of the distance to
    the k-th nearest other row, in float64 on ``device``."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = rng.choice(n, size=min(sample, n), replace=False)
    x64 = torch.from_numpy(x).to(device).double()
    sq = (x64 * x64).sum(1)
    q = x64[torch.from_numpy(idx).to(device)]
    kk = min(k, n - 1)  # the k-th neighbour, the row itself excluded
    kth = []
    for i0 in range(0, q.shape[0], block):
        qb = q[i0:i0 + block]
        d2 = (qb * qb).sum(1)[:, None] - 2.0 * (qb @ x64.T) + sq[None, :]
        d2 = d2.clamp_min(0)
        kth.append(torch.kthvalue(d2, kk + 1, dim=1).values)
    return float(np.sqrt(np.median(torch.cat(kth).cpu().numpy())))


def make_vectors(cfg: dict, seed: int, device="cpu"):
    """(the configuration's vectors, ε, the run's row order): the vectors
    from ``data_seed``, ε calibrated on them, the order from ``seed``."""
    base = clustered_vectors(int(cfg["n"]), int(cfg["dim"]),
                             seed=[int(cfg["data_seed"]), 0],
                             cluster_std=float(cfg["dataset"]["cluster_std"]))
    eps = epsilon_for_avg_neighbors(base, int(cfg["avg_neighbors"]),
                                    device=device)
    perm = seed_rng(seed, 0).permutation(base.shape[0])
    return base, eps, perm


class QueryStream:
    """fig22's request stream over ``x``, in chunks of ``STREAM_CHUNK``:
    ``hot_share`` of the queries near one of ``hot_anchors`` rows chosen
    with ``anchor_seed``, the rest near a row drawn uniformly, plus
    N(0, ``noise``). ``group`` of a query is its anchor, or -1."""

    def __init__(self, x: np.ndarray, seed: int, *, anchor_seed: int = 0,
                 hot_anchors: int = 16, hot_share: float = 0.7,
                 noise: float = 0.01):
        self.x = x
        self.hot_share = float(hot_share)
        self.noise = float(noise)
        self.rng = seed_rng(seed, 1)
        self.anchors = (x[seed_rng(anchor_seed, 3).choice(
            x.shape[0], hot_anchors, replace=False)]
            if hot_anchors else None)
        self.buf = np.zeros((0, x.shape[1]), np.float32)
        self.groups = np.zeros(0, np.int64)
        self.taken = 0

    def _chunk(self) -> tuple[np.ndarray, np.ndarray]:
        rng, n = self.rng, STREAM_CHUNK
        if self.anchors is None:
            q = self.x[rng.choice(self.x.shape[0], n)]
            group = np.full(n, -1)
        else:
            which = rng.integers(0, len(self.anchors), n)
            roam = self.x[rng.choice(self.x.shape[0], n)]
            pick = rng.random(n) < self.hot_share
            q = np.where(pick[:, None], self.anchors[which], roam)
            group = np.where(pick, which, -1)
        return ((q + rng.normal(scale=self.noise, size=q.shape)
                 ).astype(np.float32), group)

    def next(self) -> tuple[np.ndarray, int]:
        """The next query, (dim,) float32, and its group."""
        if self.taken == self.buf.shape[0]:
            (self.buf, self.groups), self.taken = self._chunk(), 0
        k = self.taken
        self.taken += 1
        return self.buf[k], int(self.groups[k])
