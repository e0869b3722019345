"""The design of the tensor-core assign kernel (``csrc/bucket_assign_sm90.cu``)
checked on the CPU before the card: its two passes, emulated in torch
(3×TF32 d² with per-chunk partials truncated toward zero, the best two per
center split, their merge, and the float32 re-check of the winners),
against the JAX package's Pallas ``bucket_assign`` in interpret mode; and
the route function ``kernels/bucket_assign.py::launch_plan`` with the
dispatch around it. The kernel itself is held against its plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import inspect
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import clustered_vectors  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import bucket_assign as assign  # noqa: E402
from tc_emulation import (F32_ORDER_GAP, fma_dot,  # noqa: E402
                          tc_emulation, three_way_ties)

D2_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py's d² tolerance


def _best2(v: torch.Tensor, i: torch.Tensor):
    """The best two (d², index) of each row, ties to the lower index."""
    order = torch.argsort(i, dim=1, stable=True)
    v, i = v.gather(1, order), i.gather(1, order)
    order = torch.argsort(v, dim=1, stable=True)[:, :2]
    return v.gather(1, order), i.gather(1, order)


def tc_assign_emulation(x: torch.Tensor, c: torch.Tensor, splits: int,
                        block: int):
    """The kernel's two passes on (M, D) × (B, D) float32 → (mind2, idx,
    first): pass 1's tensor-core d² (``tc_emulation``), the best two of
    each of ``splits`` contiguous ranges of ``block``-wide center tiles,
    merged by tensor-core d²; pass 2 recomputes the best two as float32
    FMA chains in k order and keeps the lower, ties to the lower index.
    ``first``: pass 1's own winner, before the re-check."""
    tc = tc_emulation(x[None], c[None], 0.0)[0][0]
    m, b = tc.shape
    tiles = -(-b // block)
    per = -(-tiles // splits)
    cols = torch.arange(b).expand(m, b)
    cand = [_best2(tc[:, lo:lo + per * block], cols[:, lo:lo + per * block])
            for lo in range(0, b, per * block)]
    v, i = _best2(torch.cat([v for v, _ in cand], 1),
                  torch.cat([i for _, i in cand], 1))
    if b == 1:
        v, i = v.expand(m, 2), i.expand(m, 2)
    nx = fma_dot(x, x)
    d2 = torch.stack([torch.clamp_min(
        (nx + fma_dot(c[i[:, k]], c[i[:, k]])) - 2.0 * fma_dot(x, c[i[:, k]]),
        0.0) for k in (0, 1)], 1)
    second = (d2[:, 1] < d2[:, 0]) | ((d2[:, 1] == d2[:, 0])
                                      & (i[:, 1] < i[:, 0]))
    k = second.long()[:, None]
    return d2.gather(1, k)[:, 0], i.gather(1, k)[:, 0], i[:, 0]


def f32_assign(x: torch.Tensor, c: torch.Tensor):
    """The CUDA-core kernel's function: every d² as float32 FMA chains in k
    order, the lowest index of the minimum."""
    nx, nc = fma_dot(x, x), fma_dot(c, c)
    dots = torch.stack([fma_dot(x, cj.expand_as(x)) for cj in c], 1)
    d2 = torch.clamp_min((nx[:, None] + nc[None]) - 2.0 * dots, 0.0)
    idx = torch.argmin(d2, dim=1)
    return d2.gather(1, idx[:, None])[:, 0], idx


def _data(kind: str, m: int, b: int, d: int, seed: int):
    """(x (m, d), centers (b, d)) float32 of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "randn":
        return (rng.normal(size=(m, d)).astype(np.float32),
                rng.normal(size=(b, d)).astype(np.float32))
    if kind == "clustered":  # centers sampled from the data, as scan 1 does
        x = clustered_vectors(m + b, d, seed=seed)
        return x[:m], x[m:]
    if kind == "exact_ties":
        # duplicated centers (split sub-buckets share theirs), rows that are
        # centers, and coordinates 0..3: every d² is an exact integer in
        # any order, so distances tie exactly and often
        c = rng.integers(0, 4, size=(b - b // 3, d)).astype(np.float32)
        c = np.concatenate([c, c[: b // 3]])
        x = rng.integers(0, 4, size=(m, d)).astype(np.float32)
        x[: m // 4] = c[rng.integers(0, b, size=m // 4)]
        return x, c
    # near_ties: pairs of centers 0.1 apart, each row near a pair's
    # bisecting plane, its two d² apart by 2e-9 .. 2e-2 (log-uniform)
    pairs = b // 2
    base = rng.normal(size=(pairs, d))
    unit = rng.normal(size=(pairs, d))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    c = np.concatenate([base, base + 0.1 * unit,
                        rng.normal(size=(b - 2 * pairs, d))])
    p = rng.integers(0, pairs, size=m)
    w = rng.normal(size=(m, d))
    w -= (w * unit[p]).sum(1, keepdims=True) * unit[p]
    w *= 0.03 / np.linalg.norm(w, axis=1, keepdims=True)
    tau = (np.exp(rng.uniform(np.log(1e-8), np.log(1e-1), size=m))
           * rng.choice([-1.0, 1.0], size=m))
    x = base[p] + 0.05 * unit[p] + w + tau[:, None] * unit[p]
    return x.astype(np.float32), c.astype(np.float32)


def _jax_assign(x: np.ndarray, c: np.ndarray):
    """The JAX package's Pallas kernel, padded by its ``ops`` wrapper and
    run in interpret mode on the CPU."""
    d2, idx = jops.bucket_assign(x, c, use_pallas=True)
    return np.asarray(d2), np.asarray(idx)


@pytest.mark.parametrize("kind", ["randn", "clustered", "exact_ties"])
@pytest.mark.parametrize("m,b,d", [(100, 37, 96), (70, 300, 32),
                                   (130, 129, 4)])
def test_tc_assign_arithmetic_matches_jax_pallas(kind, m, b, d):
    """Argmin equal to the JAX kernel's and d² within tolerance, at every
    split count the grid could take; the result never depends on it."""
    x, c = _data(kind, m, b, d, seed=m + b + d)
    d2_want, idx_want = _jax_assign(x, c)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    block = assign.launch_plan(m, b, d).block_m
    tiles = -(-b // block)
    first = None
    for splits in sorted({1, 2, 3, tiles}):
        d2, idx, _ = tc_assign_emulation(xt, ct, min(splits, tiles), block)
        assert np.array_equal(idx.numpy(), idx_want)
        np.testing.assert_allclose(d2.numpy(), d2_want, **D2_TOL)
        if first is None:
            first = (d2, idx)
        assert torch.equal(d2, first[0]) and torch.equal(idx, first[1])
    if kind == "exact_ties":  # every product and sum is exact
        assert np.array_equal(first[0].numpy(), d2_want)


@pytest.mark.parametrize("m,b,d", [(100, 37, 96), (64, 200, 128)])
def test_tc_assign_decides_near_ties_in_float32(m, b, d):
    """On near-ties the tensor cores' own winner often differs from float32
    FMAs'; the re-check makes the result that of the CUDA-core kernel's
    arithmetic, byte for byte, at every split count. Against the JAX
    kernel (another float32 order) the argmin agrees wherever the nearest
    two centers' exact d² are apart by more than float32 rounding can
    bridge, and d² is within tolerance everywhere."""
    x, c = _data("near_ties", m, b, d, seed=m + b)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    d2_f32, idx_f32 = f32_assign(xt, ct)
    block = assign.launch_plan(m, b, d).block_m
    tiles = -(-b // block)
    for splits in sorted({1, 2, tiles}):
        d2, idx, first = tc_assign_emulation(xt, ct, min(splits, tiles),
                                             block)
        assert torch.equal(idx, idx_f32) and torch.equal(d2, d2_f32)
    assert (first != idx).sum() >= 5  # the re-check changed the answer
    d2_want, idx_want = _jax_assign(x, c)
    np.testing.assert_allclose(d2.numpy(), d2_want, **D2_TOL)
    x64 = x.astype(np.float64)
    exact = np.sort(((x64[:, None] - c[None]) ** 2).sum(-1), axis=1)
    apart = exact[:, 1] - exact[:, 0] > F32_ORDER_GAP * (x64 ** 2).sum(1)
    assert np.array_equal(idx.numpy()[apart], idx_want[apart])
    assert m // 5 <= apart.sum() <= m - m // 5  # both kinds of rows occur


@pytest.mark.parametrize("m,d,seed", [(64, 128, 1), (48, 96, 2)])
def test_tc_assign_three_way_near_ties(m, d, seed):
    """ROADMAP §3 fault 2: where a row's three nearest centers lie within
    the tensor cores' error of each other, the float32 exact winner (the
    CUDA-core route's, ``simt``) can fall third in pass 1's ranking, and
    the re-check of the best two then cannot restore it. How many rows
    lose it here is recorded in ROADMAP §3, not held: it is a property of
    the emulation's rounding, which the card's need not share. What
    holds: the result differs from ``simt``'s only on rows whose ``simt``
    winner left pass 1's best two; each such row's three nearest exact d²
    lie within float32 rounding of each other (the ``F32_ORDER_GAP``
    band, where two float32 orders also disagree), and d² is within the
    kernels' tolerance everywhere."""
    x, c = three_way_ties(m, d, seed)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    d2_f32, idx_f32 = f32_assign(xt, ct)
    block = assign.launch_plan(m, c.shape[0], d).block_m
    d2, idx, _ = tc_assign_emulation(xt, ct, 1, block)
    tc = tc_emulation(xt[None], ct[None], 0.0)[0][0]
    _, best2 = _best2(tc, torch.arange(tc.shape[1]).expand_as(tc))
    kept = (best2 == idx_f32[:, None]).any(1)
    lost = (idx != idx_f32).numpy()
    assert np.array_equal(lost, ~kept.numpy())
    np.testing.assert_allclose(d2.numpy(), d2_f32.numpy(), **D2_TOL)
    x64 = x.astype(np.float64)
    exact = np.sort(((x64[:, None] - c[None]) ** 2).sum(-1), axis=1)
    spread3 = exact[:, 2] - exact[:, 0]
    assert (spread3[lost] <= F32_ORDER_GAP * (x64[lost] ** 2).sum(1)).all()


def test_tc_assign_single_center():
    x, c = _data("randn", 9, 1, 8, seed=1)
    d2, idx, _ = tc_assign_emulation(torch.from_numpy(x),
                                     torch.from_numpy(c), 1, 64)
    d2_want, idx_want = _jax_assign(x, c)
    assert idx.tolist() == idx_want.tolist() == [0] * 9
    np.testing.assert_allclose(d2.numpy(), d2_want, **D2_TOL)


@pytest.mark.parametrize("m,b,d,route,block_m,splits", [
    (8192, 1000, 128, "tc", 128, 4),      # a scan block of the smoke build
    (8192, 65536, 128, "tc", 128, 4),     # at the center-index crossover
    (1_000_000, 1000, 128, "tc", 128, 1),
    (300, 1000, 128, "tc", 128, 8),       # 3 row tiles: 88 -> 8 of 8 tiles
    (300, 20000, 128, "tc", 128, 79),     # 157 tiles: 88 -> 2 per -> 79
    (64, 1000, 96, "tc", 64, 16),
    (1, 1, 4, "tc", 64, 1),
    (100, 37, 96, "tc", 128, 1),
    (200, 150, 33, "simt", 128, 1),
    (5, 3, 2, "simt", 128, 1),
])
def test_launch_plan(m, b, d, route, block_m, splits):
    plan = assign.launch_plan(m, b, d)
    assert (plan.route, plan.block_m, plan.splits) == (route, block_m,
                                                       splits)
    assert plan.route in assign.ROUTE_COUNTERS
    if plan.route == "tc":  # every split takes the same number of tiles
        tiles = -(-b // block_m)
        per = -(-tiles // splits)
        assert (splits - 1) * per < tiles <= splits * per


@pytest.mark.parametrize("m,b,d", [(8192, 1000, 128), (100, 37, 97),
                                   (64, 70000, 128), (129, 129, 8)])
def test_launch_plan_is_pure_and_never_tc_unaligned(m, b, d):
    """The plan is a function of (M, B, d) alone: the same call gives the
    same plan; the tensor-core route only for d % 4 == 0."""
    assert list(inspect.signature(assign.launch_plan).parameters) == \
        ["m", "b", "d"]
    plans = {assign.launch_plan(m, b, d) for _ in range(3)}
    assert len(plans) == 1
    assert (plans.pop().route == "tc") == (d % 4 == 0)
    for dd in (d + 1, d + 2, d + 3):
        if dd % 4:
            assert assign.launch_plan(m, b, dd).route == "simt"


def test_launches_count_under_their_route(monkeypatch):
    plans = []
    monkeypatch.setattr(assign, "bucket_assign",
                        lambda x, c, plan: plans.append(plan))
    ops.reset_launches()
    for d in (128, 33, 96):
        ops._launch_assign(torch.zeros(100, d), torch.zeros(40, d))
    assert [p.route for p in plans] == ["tc", "simt", "tc"]
    assert ops.LAUNCHES["bucket_assign"] == 3
    assert ops.LAUNCHES["assign_tc"] == 2
    assert ops.LAUNCHES["assign_simt"] == 1
    ops.reset_launches()


@pytest.mark.parametrize("route", ["tc", "simt"])
def test_refused_launch_raises(monkeypatch, route):
    """No fallback: a launch the library refuses raises, whatever the
    route."""
    lib = SimpleNamespace(bucket_assign_sm90_launch=lambda *a: 1,
                          bucket_assign_launch=lambda *a: 1)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(assign.torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    x = torch.zeros(8, 16)
    with pytest.raises(RuntimeError, match=f"{route} kernel launch failed"):
        assign.bucket_assign(x, x, assign.LaunchPlan(route))
