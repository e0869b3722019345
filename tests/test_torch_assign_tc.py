"""The design of the tensor-core assign kernel (``csrc/bucket_assign_sm90.cu``)
checked on the CPU before the card: its two passes, emulated in torch
(3×TF32 d² with per-chunk partials truncated toward zero, the best two per
center split, their merge, the float32 re-check of the winners, the bound
on every other center and the rescan where it cannot rule them out),
against the JAX package's Pallas ``bucket_assign`` in interpret mode and
against the CUDA-core route's arithmetic, whose index and d² it must give
on every row however many centers tie; and the route function
``kernels/bucket_assign.py::launch_plan`` with the dispatch around it. The
kernel itself is held against its plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import inspect
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import clustered_vectors  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import bucket_assign as assign  # noqa: E402
from repro_torch.kernels.pairwise_l2 import band_scale  # noqa: E402
from tc_emulation import (F32_ORDER_GAP, fma_dot,  # noqa: E402
                          four_way_ties, simt_emulation, tc_emulation,
                          three_way_ties)

D2_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py's d² tolerance


def _best(v: torch.Tensor, i: torch.Tensor, k: int = 2):
    """The best k (d², index) of each row, ties to the lower index."""
    order = torch.argsort(i, dim=1, stable=True)
    v, i = v.gather(1, order), i.gather(1, order)
    order = torch.argsort(v, dim=1, stable=True)[:, :k]
    return v.gather(1, order), i.gather(1, order)


def simt_floor(ku: float, nx: torch.Tensor, t: torch.Tensor):
    """``csrc/l2_sm90.cuh::simt_floor``: the least CUDA-core d² of any
    center whose tensor-core d² is at least t (float64 here; the bound's
    slack covers the kernel's float32 evaluation)."""
    nx, t = nx.double(), t.double()
    w = 2.0 * nx + 2.0 * torch.sqrt(nx * t) + t
    return t - (1.125 * ku * w + 2.0 ** -99)


def tc_assign_emulation(x: torch.Tensor, c: torch.Tensor, splits: int,
                        block: int):
    """The kernel's two passes on (M, D) × (B, D) float32 → (mind2, idx,
    first, rescanned): pass 1's tensor-core d² (``tc_emulation`` without
    the verify re-check) and the best two of each of ``splits`` contiguous
    ranges of ``block``-wide center tiles; pass 2 recomputes as float32
    FMA chains in k order the best two candidates and every other one
    whose ``simt_floor`` does not lie above the winner, the least (d²,
    index) winning, and rescans (``f32_assign``) the rows where a split's second
    candidate's floor does not lie above it. ``first``: pass 1's own
    winner, before the re-check; ``rescanned``: the rows pass 2
    rescanned."""
    tc = tc_emulation(x[None], c[None], 0.0, recheck=False)[0][0]
    m, b = tc.shape
    tiles = -(-b // block)
    per = -(-tiles // splits)
    cols = torch.arange(b).expand(m, b)
    cand, thirds = [], []
    for lo in range(0, b, per * block):
        v, i = _best(tc[:, lo:lo + per * block], cols[:, lo:lo + per * block],
                     3)
        if v.shape[1] < 3:  # under three centers: empty slots
            pad = 3 - v.shape[1]
            v = torch.cat([v, torch.full((m, pad), float("inf"))], 1)
            i = torch.cat([i, torch.full((m, pad), -1)], 1)
        cand.append((v[:, :2], i[:, :2]))
        thirds.append(v[:, 2].double())
    cv = torch.cat([v for v, _ in cand], 1).double()
    ci = torch.cat([i for _, i in cand], 1)
    ku = band_scale(x.shape[1])
    nx = fma_dot(x, x)
    simt = simt_emulation(x[None], c[None], 0.0)[0][0]
    _, two = _best(cv, ci)
    two = torch.where(two >= 0, two, two[:, :1])  # an empty second: the first
    first = two[:, 0]
    v2 = simt.gather(1, two).double()
    k2 = ((v2[:, 1] < v2[:, 0]) | ((v2[:, 1] == v2[:, 0])
                                   & (two[:, 1] < two[:, 0]))).long()
    key = torch.stack([v2.gather(1, k2[:, None])[:, 0],
                       two.gather(1, k2[:, None])[:, 0].double()], 1)
    for k in range(ci.shape[1]):                  # others within reach
        reach = ((ci[:, k] >= 0) & (ci[:, k] != two[:, 0])
                 & (ci[:, k] != two[:, 1])
                 & (simt_floor(ku, nx, cv[:, k]) <= key[:, 0]))
        j = ci[:, k].clamp_min(0)
        vk = simt.gather(1, j[:, None])[:, 0].double()
        better = reach & ((vk < key[:, 0])
                          | ((vk == key[:, 0]) & (j.double() < key[:, 1])))
        key = torch.where(better[:, None], torch.stack([vk, j.double()], 1),
                          key)
    dropped = torch.stack(thirds, 1).min(1).values  # what the splits dropped
    rescanned = simt_floor(ku, nx, dropped) <= key[:, 0]
    full_d2, full_idx = f32_assign(x, c)
    mind2 = torch.where(rescanned, full_d2, key[:, 0].float())
    idx = torch.where(rescanned, full_idx, key[:, 1].long())
    return mind2, idx, first, rescanned


def f32_assign(x: torch.Tensor, c: torch.Tensor):
    """The CUDA-core kernel's function: every d² as float32 FMA chains in k
    order (``simt_emulation``), the lowest index of the minimum."""
    d2 = simt_emulation(x[None], c[None], 0.0)[0][0]
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
        d2, idx, _, _ = tc_assign_emulation(xt, ct, min(splits, tiles),
                                            block)
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
        d2, idx, first, _ = tc_assign_emulation(xt, ct, min(splits, tiles),
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
    """Where a row's three nearest centers lie within the tensor cores'
    error of each other, the float32 exact winner (the CUDA-core route's,
    ``simt``) can fall third in pass 1's ranking, where a re-check of the
    best two alone loses it (this data does that on some rows). The bound
    on the other centers sends those rows to the rescan, and the index
    and d² are ``simt``'s on every row."""
    _assert_simt_on_ties(*three_way_ties(m, d, seed))


@pytest.mark.parametrize("m,d,seed", [(64, 128, 3), (48, 96, 4)])
def test_tc_assign_four_way_near_ties(m, d, seed):
    """As the three-way case, with four centers within the tensor cores'
    error of each other: keeping the best three would lose rows here."""
    _assert_simt_on_ties(*four_way_ties(m, d, seed))


def _assert_simt_on_ties(x: np.ndarray, c: np.ndarray):
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    d2_f32, idx_f32 = f32_assign(xt, ct)
    block = assign.launch_plan(x.shape[0], c.shape[0], x.shape[1]).block_m
    tiles = -(-c.shape[0] // block)
    for splits in sorted({1, 2, tiles}):
        d2, idx, _, rescanned = tc_assign_emulation(
            xt, ct, min(splits, tiles), block)
        assert torch.equal(idx, idx_f32) and torch.equal(d2, d2_f32)
    tc = tc_emulation(xt[None], ct[None], 0.0, recheck=False)[0][0]
    _, best2 = _best(tc, torch.arange(tc.shape[1]).expand_as(tc))
    lost = ~(best2 == idx_f32[:, None]).any(1)
    assert lost.any()                 # the best two alone would lose these
    assert rescanned.any()            # ... and the bound sent rows on


def test_tc_assign_rescans_few_rows_of_clustered_data():
    """On data like the build's (200 centers drawn from a clustered set of
    20,000, 512 other rows of it) the bound settles nearly every row with
    the recomputed candidates: the rescan stays rare, and the result is
    the CUDA-core route's."""
    x = clustered_vectors(20_000, 128, seed=5)
    pick = np.random.default_rng(5).choice(20_000, 712, replace=False)
    xt, ct = torch.from_numpy(x[pick[:512]]), torch.from_numpy(x[pick[512:]])
    d2, idx, _, rescanned = tc_assign_emulation(xt, ct, 2, 128)
    d2_f32, idx_f32 = f32_assign(xt, ct)
    assert torch.equal(idx, idx_f32) and torch.equal(d2, d2_f32)
    assert rescanned.sum() <= 512 // 100


def test_tc_assign_single_center():
    x, c = _data("randn", 9, 1, 8, seed=1)
    d2, idx, _, _ = tc_assign_emulation(torch.from_numpy(x),
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


def test_strided_operands_are_refused():
    """The kernel reads its operands' memory row after row: a strided view
    (a transposed array from numpy, say) raises instead of being read as
    other rows."""
    x = torch.zeros(16, 8).t()
    with pytest.raises(ValueError, match="contiguous"):
        assign.bucket_assign(x, x.contiguous(), assign.LaunchPlan("tc"))
