"""The comparison that decides ``correct``.

The numbers compared, for a join (every pair the compared join emitted,
against the float64 reference over the whole dataset) and for queries
(each sampled query's answer against the float64 reference's members):

- ``malformed``: answers that break the output's form: a pair not i < j,
  an id out of range, a pair or member twice, a distance not finite or
  negative, an answer not in (distance, id) order. Limit 0.
- ``outside``: emitted pairs or members whose float64 d² lies above ε² by
  more than the float32 band (below). Limit 0.
- ``d2_err``: the largest |d_emitted² − d²_float64| over emitted pairs,
  as a share of ‖a‖² + ‖b‖², the scale of a float32 d²'s rounding.
- ``recall``: the share of the pairs or members the reference finds
  inside ε² by more than the band that were emitted. Its limit is the
  configuration's ``recall_target`` (the paper's λ). Every pair or
  member counts as itself.
- ``unanswered`` (queries): requests of the window that raised or never
  came back. ``joins_differ`` (joins): joins of the window whose output
  bytes differ from the compared join's. Limit 0 each.

The band is where float32 arithmetic may decide either way: a float32 d²
of d terms is within (2d + 8)·2⁻²³·(‖a‖² + ‖b‖²) of float64's, and ε² in
float32 within 2⁻²⁴ of its own size.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import reference


def band(dim: int, norms2: torch.Tensor, eps2: float) -> torch.Tensor:
    return (2 * dim + 8) * 2.0 ** -23 * norms2 + 4 * 2.0 ** -24 * eps2


def digest(*arrays: np.ndarray) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _emitted(x, i, j, dist, eps2, dim):
    """(outside, d2_err) of emitted pairs (i, j) with float32 distances."""
    if i.numel() == 0:
        return 0, 0.0
    d64 = reference.pair_d2(x, i, j)
    norms = (x[i].double() ** 2).sum(1) + (x[j].double() ** 2).sum(1)
    w = band(dim, norms, eps2)
    outside = int((d64 > eps2 + w).sum().item())
    d_em = torch.as_tensor(dist, device=x.device).double()
    err = ((d_em * d_em - d64).abs() / norms.clamp_min(1e-300)).max()
    return outside, float(err.item())


def join_numbers(x_np: np.ndarray, eps: float, pairs: np.ndarray,
                 dists: np.ndarray, device) -> dict:
    """``malformed``, ``outside``, ``d2_err`` and ``recall`` of one join's
    output against the float64 reference join of ``x_np``."""
    n, dim = x_np.shape
    eps2 = float(eps) * float(eps)
    p = np.asarray(pairs)
    d = np.asarray(dists)
    if p.ndim != 2 or p.shape[1] != 2 or d.shape != (p.shape[0],):
        return dict(malformed=max(1, p.size), outside=0, d2_err=0.0,
                    recall=0.0)
    bad = ((p[:, 0] >= p[:, 1]) | (p[:, 0] < 0) | (p[:, 1] >= n)
           | ~np.isfinite(d) | (d < 0))
    good = p[~bad]
    keys = good[:, 0] * n + good[:, 1]
    malformed = int(bad.sum()) + int(keys.size - np.unique(keys).size)
    x = torch.from_numpy(x_np).to(device)
    i = torch.from_numpy(good[:, 0]).to(device)
    j = torch.from_numpy(good[:, 1]).to(device)
    outside, err = _emitted(x, i, j, d[~bad], eps2, dim)
    tp, td2 = reference.join(x, eps, "float64")
    norms = (x.double() ** 2).sum(1)
    inside = td2 <= eps2 - band(dim, norms[tp[:, 0]] + norms[tp[:, 1]], eps2)
    truth = (tp[inside, 0] * n + tp[inside, 1])
    found = torch.isin(truth, torch.from_numpy(keys).to(device))
    recall = float(found.double().mean().item()) if truth.numel() else 1.0
    return dict(malformed=malformed, outside=outside, d2_err=err,
                recall=recall)


def query_numbers(x_np: np.ndarray, eps: float, Q: np.ndarray,
                  answers: list, device) -> dict:
    """``malformed``, ``outside``, ``d2_err`` and ``recall`` of answers
    [(ids, distances)] to the queries ``Q`` against the float64
    reference's members."""
    n, dim = x_np.shape
    eps2 = float(eps) * float(eps)
    malformed = 0
    qi, ids, dist = [], [], []
    for k, (a_ids, a_d) in enumerate(answers):
        a_ids, a_d = np.asarray(a_ids), np.asarray(a_d)
        bad = ((a_ids < 0) | (a_ids >= n) | ~np.isfinite(a_d) | (a_d < 0)
               if a_ids.shape == a_d.shape and a_ids.ndim == 1 else None)
        if bad is None:
            malformed += 1
            continue
        order = np.lexsort((a_ids, a_d))
        if (np.unique(a_ids).size != a_ids.size
                or not np.array_equal(order, np.arange(a_ids.size))):
            malformed += 1
        malformed += int(bad.sum())
        qi.append(np.full(int((~bad).sum()), k))
        ids.append(a_ids[~bad])
        dist.append(a_d[~bad])
    x = torch.from_numpy(x_np).to(device)
    Qd = torch.from_numpy(np.ascontiguousarray(Q)).to(device)
    qi = np.concatenate(qi) if qi else np.zeros(0, np.int64)
    ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    dist = np.concatenate(dist) if dist else np.zeros(0, np.float32)
    outside, err = 0, 0.0
    if ids.size:
        qt = torch.from_numpy(qi).to(device)
        jt = torch.from_numpy(ids).to(device)
        dq = Qd[qt].double() - x[jt].double()
        d64 = (dq * dq).sum(1)
        norms = (Qd[qt].double() ** 2).sum(1) + (x[jt].double() ** 2).sum(1)
        w = band(dim, norms, eps2)
        outside = int((d64 > eps2 + w).sum().item())
        d_em = torch.from_numpy(dist).to(device).double()
        err = float(((d_em * d_em - d64).abs()
                     / norms.clamp_min(1e-300)).max().item())
    truth = reference.members(x, Qd, eps, "float64")
    xn = (x.double() ** 2).sum(1).cpu().numpy()
    qn = (Qd.double() ** 2).sum(1).cpu().numpy()
    got = set(zip(qi.tolist(), ids.tolist()))
    total = hit = 0
    for k, (t_ids, t_d2) in enumerate(truth):
        w = ((2 * dim + 8) * 2.0 ** -23 * (qn[k] + xn[t_ids])
             + 4 * 2.0 ** -24 * eps2)
        inside = t_ids[t_d2 <= eps2 - w]
        total += inside.size
        hit += sum((k, int(v)) in got for v in inside)
    recall = hit / total if total else 1.0
    return dict(malformed=malformed, outside=outside, d2_err=err,
                recall=recall)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit → (all within, checks). ``limits``
    maps a name to {"max": v} or {"min": v}; a number without a limit is
    a fault of the benchmark, not of the run."""
    checks, ok = {}, True
    for name, value in numbers.items():
        lim = limits[name]
        if "max" in lim:
            good = value <= lim["max"]
            checks[name] = {"value": value, "limit": lim["max"],
                            "need": "<="}
        else:
            good = value >= lim["min"]
            checks[name] = {"value": value, "limit": lim["min"],
                            "need": ">="}
        ok = ok and bool(good)
    return ok, checks
