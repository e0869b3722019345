"""Probabilistic candidate-bucket pruning (paper §5.2, Eq. 3 / Alg. 3).

For bucket b with ε-neighborhood ball B(c_b, r) (r = r_b + ε), pruning
candidate bucket b_i can only miss neighbors lying in the spherical cap cut
off by the Voronoi bisector between c_b and c_{b_i}. Under a uniform-density
assumption the missed fraction of the j furthest candidates is bounded by

    β(j) ≤ μ · Σ_{i=l−j}^{l} arccos(min(x_i, 1)),
    μ   = π^{−1/2} · Γ((d−1)/2) / Γ(d/2),
    x_i = db_i / r,   db_i = ‖c_b − c_{b_i}‖ / 2.

Buckets are pruned furthest-first while the running bound stays ≤ 1 − λ.
x_i ≥ 1 ⇒ the bisector does not cut the ball ⇒ zero contribution (such
buckets are also prunable outright by geometry — but they were admitted by
the triangle-inequality prefilter because radii overestimate extents, so the
probabilistic rule subsumes them for free).
"""
from __future__ import annotations

import math

import numpy as np


def cap_constant(dim: int) -> float:
    """μ = π^{-1/2} Γ((d−1)/2)/Γ(d/2) — via lgamma for numerical stability."""
    if dim < 2:
        raise ValueError("dimension must be ≥ 2")
    return math.exp(
        math.lgamma((dim - 1) / 2.0) - math.lgamma(dim / 2.0)
    ) / math.sqrt(math.pi)


def miss_bound_terms(center_dists: np.ndarray, radius: float,
                     dim: int,
                     cand_radii: np.ndarray | None = None) -> np.ndarray:
    """Per-candidate miss-probability terms μ·arccos(clip(x_i)).

    Self-join (``cand_radii=None``): the paper's Voronoi-bisector cut,
    x_i = (‖c_b − c_{b_i}‖/2)/r — sound because nearest-center assignment
    confines bucket b_i to its Voronoi cell.

    Cross-join (``cand_radii`` given): the bisector argument fails (the
    other dataset is assigned among *its own* centers), so we use the ball
    cap that contains B(c_{b_i}, r_i) ∩ B(c_b, r): any point within r_i of
    c_{b_i} projects ≥ ‖c_b − c_{b_i}‖ − r_i along the center axis, giving
    the cut x_i = (‖c_b − c_{b_i}‖ − r_i)/r. Exact geometry, no Voronoi
    assumption.

    Args:
      center_dists: (L,) distances ‖c_b − c_{b_i}‖ to candidate centers.
      radius: r = r_b + ε, the ε-neighborhood ball radius of bucket b.
      dim: vector dimension d.
      cand_radii: (L,) candidate-bucket radii (cross-join mode).
    """
    if radius <= 0:
        return np.zeros_like(center_dists, dtype=np.float64)
    d = np.asarray(center_dists, np.float64)
    if cand_radii is None:
        cut = d / 2.0
    else:
        cut = d - np.asarray(cand_radii, np.float64)
    x = np.clip(cut / float(radius), -1.0, 1.0)
    return cap_constant(dim) * np.arccos(x)


def prune_candidates(center_dists: np.ndarray, radius: float, dim: int,
                     recall_target: float,
                     cand_radii: np.ndarray | None = None) -> np.ndarray:
    """Alg. 3: keep-mask over candidates, pruning furthest-first.

    Sorts candidates by distance descending, accumulates the bound terms, and
    prunes while the partial sum stays within the error budget 1 − λ.

    Returns a boolean keep mask aligned with ``center_dists``.
    """
    l = len(center_dists)
    keep = np.ones(l, dtype=bool)
    if l == 0:
        return keep
    budget = max(0.0, 1.0 - float(recall_target))
    terms = miss_bound_terms(center_dists, radius, dim, cand_radii)
    order = np.argsort(-np.asarray(center_dists))  # furthest first
    acc = 0.0
    for idx in order:
        t = float(terms[idx])
        if acc + t <= budget:
            acc += t
            keep[idx] = False
        else:
            break  # Alg. 3 stops at the first candidate exceeding the budget
    return keep


def split_error_budget(recall_target: float, num_buckets: int,
                       per_bucket: bool = True) -> float:
    """DiskJoin applies the budget per bucket (Alg. 3 operates bucket-wise);
    expected recall is then ≥ λ by linearity over the per-bucket misses."""
    del num_buckets, per_bucket
    return recall_target
