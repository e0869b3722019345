"""The design of the tensor-core verify kernel (``csrc/pairwise_l2_sm90.cu``)
checked on the CPU before the card: its 3×TF32 arithmetic and the
CUDA-core kernel's, emulated in torch, against the JAX package's Pallas
``pairwise_l2_threshold_batched`` in interpret mode, at
``tests/test_kernels.py``'s d² tolerance; the band that bounds the two
routes' difference, and the re-check inside it that gives the CUDA-core
route's mask on every pair; and the route function
``kernels/pairwise_l2.py::launch_plan`` with the dispatch around it. The
kernel itself is held against its plain version and the CUDA-core route on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import inspect
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.executor import PAD_COORD  # noqa: E402
from repro.data import (clustered_vectors,  # noqa: E402
                        epsilon_for_avg_neighbors)
from repro.kernels.pairwise_l2 import (  # noqa: E402
    pairwise_l2_threshold_batched)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import pairwise_l2 as verify  # noqa: E402
from tc_emulation import (band, near_eps_lanes,  # noqa: E402
                          round_toward_zero, simt_emulation, tc_emulation,
                          tf32_rna)

D2_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py's d² tolerance
MASK_BAND = 1e-2                     # mask may differ only this close to ε²


def _jax_verify(a: np.ndarray, b: np.ndarray, eps2: float):
    d2, mask = pairwise_l2_threshold_batched(a, b, eps2, interpret=True)
    return np.asarray(d2), np.asarray(mask).astype(bool)


def _check(d2, mask, d2_want, mask_want, eps2):
    np.testing.assert_allclose(d2, d2_want, **D2_TOL)
    dis = mask != mask_want
    if dis.any():
        assert np.abs(d2_want[dis] - eps2).max() < MASK_BAND


def _data(kind: str, e: int, m: int, n: int, d: int, seed: int):
    """(a (e, m, d), b (e, n, d), ε²) float32 of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":  # both sides from one dataset, ε for ~20 pairs
        x = clustered_vectors(e * (m + n), d, seed=seed)
        eps2 = float(np.float32(epsilon_for_avg_neighbors(x, 20) ** 2))
        return x[:e * m].reshape(e, m, d), x[e * m:].reshape(e, n, d), eps2
    if kind == "randn":
        a, b = (rng.normal(size=(e, r, d)).astype(np.float32) for r in (m, n))
    else:  # SIFT's scale: integer coordinates 0..255
        a, b = (rng.integers(0, 256, size=(e, r, d)).astype(np.float32)
                for r in (m, n))
    # ε² near the median d² of the batch: about half of the pairs pass
    d2 = ((a[:, :, None].astype(np.float64) - b[:, None]) ** 2).sum(-1)
    return a, b, float(np.float32(np.median(d2)))


@pytest.mark.parametrize("kind", ["randn", "clustered", "sift_ints"])
@pytest.mark.parametrize("e,m,n,d", [(2, 128, 128, 128), (1, 256, 128, 96),
                                     (3, 128, 256, 32)])
def test_tc_arithmetic_matches_jax_pallas(kind, e, m, n, d):
    a, b, eps2 = _data(kind, e, m, n, d, seed=m + n + d)
    d2, mask = tc_emulation(torch.from_numpy(a), torch.from_numpy(b), eps2)
    d2_want, mask_want = _jax_verify(a, b, eps2)
    _check(d2.numpy(), mask.numpy(), d2_want, mask_want, eps2)
    assert mask_want.any()
    if kind == "sift_ints":  # integer data: every product and sum is exact
        assert np.array_equal(d2.numpy(), d2_want)


@pytest.mark.parametrize("kind", ["randn", "clustered", "sift_ints"])
def test_simt_arithmetic_matches_jax_pallas(kind):
    """The CUDA-core route's arithmetic, whose d² the tensor-core route
    takes inside the band, held to the JAX kernel as the ``tc`` one is."""
    a, b, eps2 = _data(kind, 2, 64, 96, 96, seed=7)
    d2, mask = simt_emulation(torch.from_numpy(a), torch.from_numpy(b), eps2)
    d2_want, mask_want = _jax_verify(a, b, eps2)
    _check(d2.numpy(), mask.numpy(), d2_want, mask_want, eps2)
    if kind == "sift_ints":  # integer data: every product and sum is exact
        assert np.array_equal(d2.numpy(), d2_want)


def _band_data(kind: str, d: int, seed: int):
    """(a (1, 32, d), b (1, 40, d)) float32 of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        x = clustered_vectors(72, d, seed=seed)
        return x[None, :32], x[None, 32:]
    a = rng.normal(size=(1, 32, d))
    if kind == "large_norm":    # |x|² ~ 1e8 d, neighbours 1e2 apart
        a = 1e4 + 10.0 * a
        b = a[:, rng.integers(0, 32, size=40)] + rng.normal(size=(1, 40, d))
    elif kind == "near_dup":    # copies moved by 1e-4 in each coordinate
        b = a[:, rng.integers(0, 32, size=40)] \
            + 1e-4 * rng.normal(size=(1, 40, d))
    else:
        b = rng.normal(size=(1, 40, d))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("kind", ["randn", "clustered", "large_norm",
                                  "near_dup"])
@pytest.mark.parametrize("d", [4, 96, 128, 960])
def test_band_bounds_tc_against_simt(kind, d):
    """The band derived in ``csrc/l2_sm90.cuh`` holds with a margin of 2:
    the emulated tensor-core d² and the CUDA-core d² of every pair differ
    by at most half of it (and do differ, so the bound is not idle)."""
    a, b = (torch.from_numpy(t) for t in _band_data(kind, d, seed=d))
    t, _ = tc_emulation(a, b, 0.0, recheck=False)
    s, _ = simt_emulation(a, b, 0.0)
    w = band(a, b)
    assert (w > 0).all()
    ratio = ((t.double() - s.double()).abs() / w).max().item()
    assert ratio <= 0.5, ratio
    assert (t != s).any()


@pytest.mark.parametrize("d", [4, 96, 128, 960])
def test_recheck_gives_simt_mask_on_near_eps_lanes(d):
    """The ε test near the boundary, emulated: on lanes with pairs at
    float64 d² = ε²(1 ± τ), τ 1e-9 .. 1e-5, the tensor cores' own mask differs
    from the CUDA-core route's; with the re-check it is the CUDA-core
    route's on every pair, and every pair inside the band carries the
    CUDA-core route's d² bytes."""
    a, b, eps2 = (near_eps_lanes(2, 48, 40, d, seed=d))
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    raw, raw_mask = tc_emulation(a, b, eps2, recheck=False)
    d2, mask = tc_emulation(a, b, eps2)
    s, s_mask = simt_emulation(a, b, eps2)
    inside = (raw.double() - eps2).abs() <= band(a, b)
    assert (raw_mask != s_mask).any()       # the lanes reach the fault
    assert torch.equal(mask, s_mask)
    assert inside.sum() >= 40 and torch.equal(d2[inside], s[inside])
    assert torch.equal(d2[~inside], raw[~inside])


def test_tc_arithmetic_keeps_pad_rows_outside_eps():
    """Slabs padded at PAD_COORD (1e15), as the executor pads a bucket to
    its capacity: real × real matches JAX, and every pad × real distance
    stays astronomically far outside ε in both."""
    e, m, d, live_a, live_b = 2, 128, 128, 100, 77
    x = clustered_vectors(e * m * 2, d, seed=3).reshape(2, e, m, d)
    a, b = x[0].copy(), x[1].copy()
    a[:, live_a:] = PAD_COORD
    b[:, live_b:] = PAD_COORD
    eps2 = float(np.float32(epsilon_for_avg_neighbors(
        x.reshape(-1, d), 20) ** 2))
    d2, mask = tc_emulation(torch.from_numpy(a), torch.from_numpy(b), eps2)
    d2, mask = d2.numpy(), mask.numpy()
    d2_want, mask_want = _jax_verify(a, b, eps2)
    real = (slice(None), slice(0, live_a), slice(0, live_b))
    _check(d2[real], mask[real], d2_want[real], mask_want[real], eps2)
    for pad in ((slice(None), slice(live_a, None), slice(0, live_b)),
                (slice(None), slice(0, live_a), slice(live_b, None))):
        assert (d2[pad] > 1e29).all() and (d2_want[pad] > 1e29).all()
        assert not mask[pad].any() and not mask_want[pad].any()
        np.testing.assert_allclose(d2[pad], d2_want[pad], rtol=1e-4)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                    # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2,    # tie: away from zero
                      -(one + ulp / 2),
                      one + ulp / 2 - 2.0 ** -23,   # just below the tie
                      one + 3 * ulp / 2,            # tie from an odd ulp
                      2.0 - 2.0 ** -23,             # carries into 2
                      1e15, 0.0, 255.0],
                     dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 2.0,
            float(np.float32(1e15)), 0.0, 255.0]
    got = tf32_rna(x)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert got[:5].tolist() == want[:5]
    assert got[6:].tolist() == want[6:]
    assert abs(got[5].item() - want[5]) <= 2.0 ** -11 * want[5]


def test_round_toward_zero():
    tiny = 2.0 ** -30
    x = torch.tensor([1 + tiny, -(1 + tiny), 1 - tiny, 3.0, 0.0, 1e30],
                     dtype=torch.float64)
    got = round_toward_zero(x).tolist()
    below_one = float(np.nextafter(np.float32(1), np.float32(0)))
    assert got[:5] == [1.0, -1.0, below_one, 3.0, 0.0]
    assert abs(got[5]) <= 1e30


@pytest.mark.parametrize("m,n,d,route,block_m", [
    (2048, 2048, 128, "tc", 128),   # the batched verify of the main path
    (64, 2048, 128, "tc", 64),      # the point queries' tile
    (65, 2048, 128, "tc", 128),
    (1, 1, 4, "tc", 64),
    (300, 129, 960, "tc", 128),
    (200, 150, 33, "simt", 128),
    (64, 300, 130, "simt", 128),
    (5, 5, 2, "simt", 128),
])
def test_launch_plan(m, n, d, route, block_m):
    plan = verify.launch_plan(m, n, d)
    assert (plan.route, plan.block_m) == (route, block_m)
    assert plan.route in verify.ROUTE_COUNTERS


def test_launch_plan_never_sees_e(monkeypatch):
    """The route and tile come from (M, N, d) alone: the E = 1 launch and
    every lane count of a batched launch take the same plan, so a lane's
    bytes never depend on E; each launch counts under its route."""
    assert list(inspect.signature(verify.launch_plan).parameters) == \
        ["m", "n", "d"]
    plans = []
    monkeypatch.setattr(verify, "pairwise_l2_threshold_batched",
                        lambda a, b, eps2, plan: plans.append(plan))
    ops.reset_launches()
    for e in (1, 2, 32):
        for m, d in ((64, 128), (2048, 128), (100, 33)):
            ops._launch_verify(torch.zeros(e, m, d), torch.zeros(e, 50, d),
                               1.0, "verify_pairs_batch")
    assert plans[0:3] == plans[3:6] == plans[6:9]
    assert [p.route for p in plans[:3]] == ["tc", "tc", "simt"]
    assert ops.LAUNCHES["verify_tc"] == 6 and ops.LAUNCHES["verify_simt"] == 3
    assert ops.LAUNCHES["verify_pairs_batch"] == 9
    ops.reset_launches()


@pytest.mark.parametrize("route", ["tc", "simt"])
def test_refused_launch_raises(monkeypatch, route):
    """No fallback: a launch the library refuses raises, whatever the
    route, and nothing is counted."""
    lib = SimpleNamespace(pairwise_l2_sm90_launch=lambda *a: 1,
                          pairwise_l2_threshold_launch=lambda *a: 1)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(verify.torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    a = torch.zeros(1, 8, 16)
    with pytest.raises(RuntimeError, match=f"{route} kernel launch failed"):
        verify.pairwise_l2_threshold_batched(a, a, 1.0,
                                             verify.LaunchPlan(route))


def test_strided_operands_are_refused():
    """The kernel reads its operands' memory row after row: a strided view
    raises instead of being read as other rows."""
    a = torch.zeros(1, 16, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        verify.pairwise_l2_threshold_batched(a, a.contiguous(), 1.0,
                                             verify.LaunchPlan("tc"))
