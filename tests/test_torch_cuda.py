"""The port on the card: each CUDA kernel against its plain PyTorch version
at ragged shapes, the join's host and device modes through the kernels,
and the LM's decode, prefill and serving through the flash kernel. Every
test here needs a CUDA device and skips without one; run them on the card
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of the JAX package, so it runs where only
PyTorch is installed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig, recall  # noqa: E402
from repro_torch.data import (brute_force_pairs,  # noqa: E402
                              clustered_vectors, epsilon_for_avg_neighbors)
from repro_torch.kernels import bucket_assign as assign  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import pairwise_l2 as verify  # noqa: E402
from repro_torch.models import build_model, encdec  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402

pytestmark = pytest.mark.cuda
D2_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py's d² tolerance
JOIN_KERNELS = ("pairwise_l2_threshold", "verify_pairs_batch",
                "bucket_assign")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _check_mask(mk, mr, d2r, eps):
    dis = (mk != mr).cpu().numpy()
    if dis.any():
        assert np.abs(d2r.cpu().numpy()[dis] - eps * eps).max() < 1e-2


@pytest.mark.parametrize("e,m,n,d", [(1, 128, 128, 128), (3, 200, 150, 96),
                                     (2, 64, 300, 33), (1, 1, 1, 8),
                                     (1, 130, 2, 130), (1, 37, 500, 960)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_verify_kernel_matches_plain(cuda, e, m, n, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(e * 1000 + m)
    u = torch.randn(e, m, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(e, n, d, device=cuda, generator=g).to(dtype)
    eps = float(np.sqrt(2.0 * d))
    ops.reset_launches()
    d2k, mk = ops.verify_pairs_batch(u, v, eps)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["verify_pairs_batch"] == 1
    _assert_verify_routes(verify.launch_plan(m, n, d).route, 1)
    d2r, mr = ref.pairwise_l2_threshold(u, v, ops.eps2_f32(eps))
    np.testing.assert_allclose(d2k.cpu().numpy(), d2r.cpu().numpy(),
                               **D2_TOL)
    _check_mask(mk, mr, d2r, eps)
    # the E = 1 launch gives the batched lane's bytes
    d2one, _ = ops.pairwise_l2_threshold(u[-1], v[-1], eps)
    assert torch.equal(d2one, d2k[-1])


def _assert_verify_routes(route: str, n: int) -> None:
    for r, counter in verify.ROUTE_COUNTERS.items():
        assert ops.LAUNCHES[counter] == (n if r == route else 0), \
            ops.LAUNCHES


def _verify_inputs(cuda, e, m, n, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    u = torch.randn(e, m, d, device=cuda, generator=g)
    v = torch.randn(e, n, d, device=cuda, generator=g)
    return u, v, float(np.sqrt(2.0 * d))  # about half of the pairs pass


def _check_verify(d2k, mk, u, v, eps):
    torch.cuda.synchronize()
    d2r, mr = ref.pairwise_l2_threshold(u, v, ops.eps2_f32(eps))
    np.testing.assert_allclose(d2k.cpu().numpy(), d2r.cpu().numpy(),
                               **D2_TOL)
    _check_mask(mk.view(torch.bool), mr, d2r, eps)


@pytest.mark.parametrize("m,n", [(200, 150), (64, 300), (1, 1), (65, 63),
                                 (130, 2), (37, 500), (300, 129)])
@pytest.mark.parametrize("d", [4, 16, 96, 128, 960])
def test_verify_tc_route_matches_plain(cuda, m, n, d):
    """The tensor-core kernel at ragged M, N (and depth past the last
    32-float chunk) through ``ops``, then at both tile shapes: the bytes of
    an output never depend on the tile it landed in."""
    u, v, eps = _verify_inputs(cuda, 2, m, n, d, seed=m * 7 + n + d)
    ops.reset_launches()
    d2k, mk = ops.verify_pairs_batch(u, v, eps)
    _assert_verify_routes("tc", 1)
    _check_verify(d2k, mk, u, v, eps)
    eps2 = ops.eps2_f32(eps)
    for block_m in (64, 128):
        d2t, mt = verify.pairwise_l2_threshold_batched(
            u, v, eps2, verify.LaunchPlan("tc", block_m))
        assert torch.equal(d2t, d2k) and torch.equal(mt.view(torch.bool), mk)


@pytest.mark.parametrize("m,n,d", [(200, 150, 33), (64, 300, 130),
                                   (1, 1, 7), (130, 2, 2), (37, 500, 959)])
def test_verify_simt_route_matches_plain(cuda, m, n, d):
    u, v, eps = _verify_inputs(cuda, 2, m, n, d, seed=m + n + d)
    ops.reset_launches()
    d2k, mk = ops.verify_pairs_batch(u, v, eps)
    _assert_verify_routes("simt", 1)
    _check_verify(d2k, mk, u, v, eps)


@pytest.mark.parametrize("m,n,d", [(2048, 2048, 128), (64, 2048, 128),
                                   (100, 70, 33), (50, 90, 130)])
def test_verify_lane_bytes_independent_of_e(cuda, m, n, d):
    """Lane 0 of an E = 32 launch, lane 31 of it and the E = 1 launch of
    each lane's operands give the same bytes, on either route (host- and
    device-mode byte parity rests on it)."""
    u, v, eps = _verify_inputs(cuda, 32, m, n, d, seed=m + d)
    d2k, mk = ops.verify_pairs_batch(u, v, eps)
    for lane in (0, 31):
        d2one, mone = ops.pairwise_l2_threshold(u[lane], v[lane], eps)
        assert torch.equal(d2one, d2k[lane])
        assert torch.equal(mone, mk[lane])


def test_verify_tc_route_takes_unaligned_views(cuda):
    """TMA needs 16-byte aligned bases: a view 4 bytes into its storage is
    copied first, and the result is that of the aligned copy."""
    g = torch.Generator(device=cuda).manual_seed(9)
    big = torch.randn(1 + 2 * 70 * 16, device=cuda, generator=g)
    u = big[1:].view(2, 70, 16)
    assert u.data_ptr() % 16 != 0
    ops.reset_launches()
    d2k, mk = ops.verify_pairs_batch(u, u, 4.0)
    _assert_verify_routes("tc", 1)
    d2c, mc = ops.verify_pairs_batch(u.clone(), u.clone(), 4.0)
    assert torch.equal(d2k, d2c) and torch.equal(mk, mc)
    _check_verify(d2k, mk, u, u, 4.0)


def test_verify_pad_rows_stay_outside_eps(cuda):
    """Rows padded at 1e15 (the executor's PAD_COORD): every pad x real
    distance is huge and outside eps on the tensor-core route."""
    u, v, eps = _verify_inputs(cuda, 2, 128, 128, 128, seed=5)
    u[:, 100:] = 1e15
    v[:, 90:] = 1e15
    ops.reset_launches()
    d2k, mk = ops.verify_pairs_batch(u, v, eps)
    _assert_verify_routes("tc", 1)
    torch.cuda.synchronize()
    for pad in (d2k[:, 100:, :90], d2k[:, :100, 90:]):
        assert (pad > 1e29).all()
    assert not mk[:, 100:, :90].any() and not mk[:, :100, 90:].any()
    _check_verify(d2k[:, :100, :90], mk[:, :100, :90], u[:, :100],
                  v[:, :90], eps)


def _lanes_of(kind: str, d: int):
    """(a, b, ε) on the card: ``near_eps_lanes`` (pairs at float64
    d² = ε²(1 ± τ), τ 1e-9 .. 1e-5), or normal rows with ε² at the median
    d², where about 1e-4 of the pairs fall in the re-check band."""
    from tc_emulation import near_eps_lanes
    if kind == "near_eps":
        a, b, eps2 = near_eps_lanes(4, 256, 192, d, seed=d)
        return (torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(),
                float(np.sqrt(eps2)))
    u, v, _ = _verify_inputs(torch.device("cuda"), 4, 256, 192, d, seed=d)
    return u, v, float(np.sqrt(2.0 * d))


@pytest.mark.parametrize("kind,d", [("near_eps", 4), ("near_eps", 96),
                                    ("near_eps", 128), ("near_eps", 960),
                                    ("randn", 128)])
def test_verify_tc_gives_simt_mask(cuda, kind, d):
    """The tensor-core route decides as the CUDA-core one: its mask bytes
    are the CUDA-core route's on every pair; its d² lies within the band
    of theirs everywhere and is their bytes wherever their d² lies within
    half the band of ε² (every such pair is inside the band); the
    recomputed pairs are counted."""
    from tc_emulation import band
    u, v, eps = _lanes_of(kind, d)
    eps2 = ops.eps2_f32(eps)
    with verify.counting_rechecks(cuda) as counts:
        d2t, mt = ops.verify_pairs_batch(u, v, eps)
    d2s, ms = verify.pairwise_l2_threshold_batched(
        u, v, eps2, verify.LaunchPlan("simt"))
    torch.cuda.synchronize()
    assert torch.equal(mt.view(torch.int8), ms)
    w = band(u.cpu(), v.cpu()).to(cuda)
    assert ((d2t.double() - d2s.double()).abs() <= w).all()
    sure = (d2s.double() - eps2).abs() <= w / 2
    assert sure.any() and torch.equal(d2t[sure], d2s[sure])
    assert counts[0].item() >= int(sure.sum().item())
    assert counts[1].item() == 0


def test_recheck_instant_is_the_kernels_tally(cuda, tmp_path, monkeypatch):
    """A traced device join at d 960 records one ``verify.rechecks``
    instant whose ``pairs`` are the outputs the ``tc`` route recomputed, as
    ``counting_rechecks`` tallies the same join; untraced it records
    nothing and its kernels get a null tally pointer. The rows are
    ``near_eps_lanes``' near-ε pairs, so the band holds hundreds."""
    from tc_emulation import near_eps_lanes

    from repro_torch.obs import trace_session
    a, b, eps2 = near_eps_lanes(4, 256, 192, 960, seed=31)
    x = np.concatenate([a.reshape(-1, 960), b.reshape(-1, 960)])
    cfg = JoinConfig(epsilon=float(np.sqrt(eps2)), num_buckets=2,
                     pad_align=128, memory_budget_bytes=x.nbytes)
    store = FlatVectorStore.from_array(str(tmp_path / "x.bin"), x)
    pointers = []
    real = verify.recheck_counter
    monkeypatch.setattr(verify, "recheck_counter",
                        lambda dev, which: pointers.append(
                            real(dev, which)) or pointers[-1])
    with DiskJoinIndex.build(store, cfg, str(tmp_path / "i")) as index:
        pointers.clear()
        with trace_session() as tr:
            traced = index.self_join(compute_mode="device")
        marks = [e for e in tr.events()
                 if e["ph"] == "i" and e["name"] == "verify.rechecks"]
        assert pointers and all(p != 0 for p in pointers)
        pointers.clear()
        with verify.counting_rechecks(cuda) as counts:
            index.self_join(compute_mode="device")
        torch.cuda.synchronize()
        tally = int(counts[0].item())
        pointers.clear()
        plain = index.self_join(compute_mode="device")
    assert pointers and all(p == 0 for p in pointers)
    assert verify.RECHECKS is None
    assert len(marks) == 1 and tally > 0
    assert marks[0]["args"] == {"pairs": tally}
    assert np.array_equal(plain.pairs, traced.pairs)
    print(f"d 960: {tally} outputs of the join recomputed")


@pytest.mark.parametrize("d", [96, 128])
def test_simt_kernel_is_the_fma_chain(cuda, d):
    """The CUDA-core kernel's d² bytes are ``simt_emulation``'s: norms and
    dot products as FMA chains in k order and one rounding each for the
    sum of the norms and the difference, whatever nvcc does with
    ``na + nb - 2.0f * acc`` (the doubling is exact, so a contracted FMA
    gives the same float). The tensor-core route's re-check computes this
    function."""
    from tc_emulation import near_eps_lanes, simt_emulation
    a, b, eps2 = near_eps_lanes(1, 64, 48, d, seed=3)
    got, _ = verify.pairwise_l2_threshold_batched(
        torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(), eps2,
        verify.LaunchPlan("simt"))
    want, _ = simt_emulation(torch.from_numpy(a), torch.from_numpy(b), eps2)
    assert torch.equal(got.cpu(), want)


def _assert_assign_routes(route: str, n: int) -> None:
    for r, counter in assign.ROUTE_COUNTERS.items():
        assert ops.LAUNCHES[counter] == (n if r == route else 0), \
            ops.LAUNCHES


def _assign(route: str, x, c):
    """``route``'s kernel on (M, d) x (B, d): through ``ops`` (counted under
    its route) where ``launch_plan`` gives that route, else directly."""
    if assign.launch_plan(x.shape[0], c.shape[0], x.shape[1]).route == route:
        return ops.bucket_assign(x, c)
    return assign.bucket_assign(x.contiguous(), c.contiguous(),
                                assign.LaunchPlan(route))


@pytest.mark.parametrize("route", ["tc", "simt"])
@pytest.mark.parametrize("m,b,d", [(128, 128, 64), (100, 37, 96),
                                   (256, 130, 128), (5, 3, 16),
                                   (8192, 1000, 128), (8192, 65536, 128)])
def test_assign_kernel_matches_plain(cuda, route, m, b, d):
    g = torch.Generator(device=cuda).manual_seed(m + b)
    x = torch.randn(m, d, device=cuda, generator=g)
    c = torch.randn(b, d, device=cuda, generator=g)
    ops.reset_launches()
    dk, ik = _assign(route, x, c)
    torch.cuda.synchronize()
    _assert_assign_routes("tc", 1 if route == "tc" else 0)
    dr, ir = ref.bucket_assign(x, c)
    assert torch.equal(ik, ir)
    np.testing.assert_allclose(dk.cpu().numpy(), dr.cpu().numpy(), **D2_TOL)
    del dr, ir
    # ties (duplicated centers) go to the lowest index
    _, it = _assign(route, c[:7], torch.cat([c, c]))
    assert it.tolist() == list(range(min(7, b)))


@pytest.mark.parametrize("m,b,d", [(100, 37, 97), (64, 300, 130),
                                   (1, 1, 7), (300, 129, 2)])
def test_assign_simt_route_matches_plain(cuda, m, b, d):
    g = torch.Generator(device=cuda).manual_seed(m + b + d)
    x = torch.randn(m, d, device=cuda, generator=g)
    c = torch.randn(b, d, device=cuda, generator=g)
    ops.reset_launches()
    dk, ik = ops.bucket_assign(x, c)
    _assert_assign_routes("simt", 1)
    dr, ir = ref.bucket_assign(x, c)
    assert torch.equal(ik, ir)
    np.testing.assert_allclose(dk.cpu().numpy(), dr.cpu().numpy(), **D2_TOL)


@pytest.mark.parametrize("m,b,d", [(128, 128, 64), (100, 37, 96),
                                   (256, 130, 128), (1, 1, 4), (64, 1000, 96),
                                   (8192, 1000, 128)])
def test_assign_tc_route_gives_simt_bytes(cuda, m, b, d):
    """The tensor-core route decides in float32 FMAs: its (mind2, idx) are
    the CUDA-core kernel's, byte for byte, at every split count."""
    g = torch.Generator(device=cuda).manual_seed(m * 3 + b)
    x = torch.randn(m, d, device=cuda, generator=g)
    c = torch.randn(b, d, device=cuda, generator=g)
    ds, is_ = assign.bucket_assign(x, c, assign.LaunchPlan("simt"))
    plan = assign.launch_plan(m, b, d)
    tiles = -(-b // plan.block_m)
    for splits in sorted({1, 2, plan.splits, tiles}):
        dt, it = assign.bucket_assign(
            x, c, assign.LaunchPlan("tc", plan.block_m, min(splits, tiles)))
        assert torch.equal(it, is_) and torch.equal(dt, ds)


def _near_tie_centers(cuda, seed):
    """(rows, centers): 300 centers, then each again (exact duplicates:
    split sub-buckets share theirs) and each moved by 3 ulps in every
    coordinate; the rows are 64 of the centers themselves and 192 points
    near a center, each of whose near-ties is a pair."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    base = torch.randn(300, 128, device=cuda, generator=g)
    moved = base
    for _ in range(3):
        moved = torch.nextafter(moved, torch.full_like(moved, float("inf")))
    near = base[torch.randint(0, 300, (192,), device=cuda, generator=g)]
    near = near + 1e-3 * torch.randn(near.shape, device=cuda, generator=g)
    return torch.cat([base[:64], near]), base, moved


@pytest.mark.parametrize("route", ["tc", "simt"])
def test_assign_near_ties(cuda, route):
    """Duplicated centers: the lowest index wins, as in the plain version.
    Centers moved by a few ulps: the tensor-core route gives the CUDA-core
    kernel's bytes, and a row that is a center gets that center (float32
    FMAs give it d² = 0 exactly)."""
    x, base, moved = _near_tie_centers(cuda, seed=11)
    dups = torch.cat([base, base])
    ops.reset_launches()
    dk, ik = _assign(route, x, dups)
    dr, ir = ref.bucket_assign(x, dups)
    _assert_assign_routes("tc", 1 if route == "tc" else 0)
    assert torch.equal(ik, ir)
    assert ik[:64].tolist() == list(range(64))
    np.testing.assert_allclose(dk.cpu().numpy(), dr.cpu().numpy(), **D2_TOL)
    pairs = torch.cat([base, moved])
    dk, ik = _assign(route, x, pairs)
    ds, is_ = assign.bucket_assign(x, pairs, assign.LaunchPlan("simt"))
    assert torch.equal(ik, is_) and torch.equal(dk, ds)
    assert ik[:64].tolist() == list(range(64))
    assert (dk[:64] == 0).all()


def test_assign_tc_route_takes_unaligned_views(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    big = torch.randn(1 + 200 * 16, device=cuda, generator=g)
    x = big[1:].view(200, 16)
    assert x.data_ptr() % 16 != 0
    ops.reset_launches()
    dk, ik = ops.bucket_assign(x, x[:50])
    _assert_assign_routes("tc", 1)
    dc, ic = ops.bucket_assign(x.clone(), x[:50].clone())
    assert torch.equal(dk, dc) and torch.equal(ik, ic)


def test_operands_on_two_devices_raise(cuda):
    """No silent copy or fallback when operands lie on different devices."""
    with pytest.raises(ValueError):
        ops.verify_pairs_batch(torch.zeros(2, 4, 8, device=cuda),
                               torch.zeros(2, 4, 8), 1.0)


def test_slice_byte_parity_and_launches(cuda, tmp_path):
    x = clustered_vectors(4000, 32, seed=5)
    eps = epsilon_for_avg_neighbors(x, 10)
    cfg = JoinConfig(epsilon=eps, pad_align=64, num_buckets=24,
                     memory_budget_bytes=1 << 20)
    store = FlatVectorStore.from_array(str(tmp_path / "x.bin"), x)
    ops.reset_launches()
    with DiskJoinIndex.build(store, cfg, str(tmp_path / "i")) as index:
        h = index.self_join()
        d = index.self_join(compute_mode="device")
        qh = index.query_batch(x[:20])
        qd = index.query_batch(x[:20], compute_mode="device")
    assert all(ops.LAUNCHES[k] > 0 for k in JOIN_KERNELS), ops.LAUNCHES
    assert ops.LAUNCHES["flash_attention"] == 0
    # every verify and assign launch of the slice ran on the tensor cores
    assert ops.LAUNCHES["assign_simt"] == 0
    assert ops.LAUNCHES["assign_tc"] == ops.LAUNCHES["bucket_assign"]
    assert ops.LAUNCHES["verify_simt"] == 0
    assert ops.LAUNCHES["verify_tc"] == (
        ops.LAUNCHES["verify_pairs_batch"]
        + ops.LAUNCHES["pairwise_l2_threshold"])
    assert np.array_equal(h.pairs, d.pairs)
    assert np.array_equal(h.distances, d.distances)
    # every first touch of the sync device join DMAs from a pinned slot
    pipe = d.io_stats["pipeline"]
    assert pipe["h2d_direct"] == pipe["h2d_transfers"] > 0
    assert pipe["h2d_staged"] == 0
    assert recall(d.pairs, brute_force_pairs(x, eps)) >= 0.9
    for qi, ((a, _), (b, _)) in enumerate(zip(qh, qd)):
        assert qi in set(a.tolist())
        for v in set(a.tolist()) ^ set(b.tolist()):
            d2 = ((x[v].astype(np.float64) - x[qi]) ** 2).sum()
            assert abs(d2 - eps * eps) <= 1e-4


def _assert_tc_verify_only():
    verify_launches = (ops.LAUNCHES["verify_pairs_batch"]
                       + ops.LAUNCHES["pairwise_l2_threshold"])
    assert verify_launches > 0
    assert ops.LAUNCHES["verify_simt"] == 0
    assert ops.LAUNCHES["verify_tc"] == verify_launches, ops.LAUNCHES


def _small_index(tmp_path, name, **kw):
    x = clustered_vectors(4000, 32, seed=5)
    eps = epsilon_for_avg_neighbors(x, 10)
    cfg = JoinConfig(epsilon=eps, pad_align=64, num_buckets=24,
                     memory_budget_bytes=1 << 20, **kw)
    store = FlatVectorStore.from_array(str(tmp_path / f"{name}.bin"), x)
    return x, eps, DiskJoinIndex.build(store, cfg, str(tmp_path / name))


def _identical(a, b):
    assert np.array_equal(a.pairs, b.pairs)
    assert np.array_equal(a.distances, b.distances)


def test_prefetch_matches_sync_on_card(cuda, tmp_path):
    """Prefetch I/O with emulated read latency (the prefetcher runs
    ahead): host and device modes give the sync host join's bytes, every
    verify launch on the tensor-core route."""
    x, eps, index = _small_index(tmp_path, "i", emulate_read_latency_s=2e-4)
    with index:
        ref_ = index.self_join()
        ops.reset_launches()
        for mode in ("host", "device"):
            r = index.self_join(io_mode="prefetch", compute_mode=mode)
            _identical(ref_, r)
            pipe = r.io_stats["pipeline"]
            assert pipe["loads"] == r.bucket_loads
            # the prefetch pool's slabs are staged, never DMA'd directly
            assert pipe["h2d_direct"] == 0
            if mode == "device":
                assert pipe["h2d_staged"] == pipe["h2d_transfers"] > 0
        _assert_tc_verify_only()
        Q = x[:30] + np.float32(1e-3)
        q_sync = index.query_batch(Q)
        index.drop_warm_cache()
        q_pre = index.query_batch(Q, io_mode="prefetch", plan_mode="on",
                                  compute_mode="device")
        for qi, ((a, _), (b, _)) in enumerate(zip(q_sync, q_pre)):
            assert qi in set(b.tolist())
            for v in set(a.tolist()) ^ set(b.tolist()):
                d2 = ((x[v].astype(np.float64) - Q[qi]) ** 2).sum()
                assert abs(d2 - eps * eps) <= 1e-4


def test_auto_mixed_plan_matches_host_on_card(cuda, tmp_path, monkeypatch):
    """compute_mode="auto" with a plan that mixes the engines on the card.
    The card's own constants send every unit to the device engine at any
    emulated link rate (its cost a cell is a hundredth of the host
    engine's), so the plan is priced with the CPU's static tier, where an
    emulated 30 GB/s link splits it. The mixed join (prefetch, a cache of
    a few buckets and slow reads, so the routed engine's stall flush runs)
    gives the host join's bytes, every verify launch on the tensor-core
    route, and returns every pin."""
    from repro_torch.plan import CostModel
    cpu_tier = CostModel.for_device("cpu")
    monkeypatch.setattr(CostModel, "for_device", classmethod(
        lambda cls, device=None: dataclasses.replace(
            cpu_tier, provenance=dict(cpu_tier.provenance))))
    x, eps, index = _small_index(tmp_path, "i")
    slow = dict(memory_budget_bytes=1 << 17, emulate_read_latency_s=5e-3)
    with index:
        host = index.self_join(**slow)
        ops.reset_launches()
        r = index.self_join(plan_mode="on", compute_mode="auto",
                            emulate_xfer_gb_s=30.0, io_mode="prefetch",
                            **slow)
        _assert_tc_verify_only()
        assert r.plan.compute_mode == "mixed"
        assert r.io_stats["pipeline"]["flush_on_stall"] > 0
        _identical(host, r)
        assert index._pool.in_use == 0


def test_striped_build_and_join_on_card(cuda, tmp_path):
    _, _, plain = _small_index(tmp_path, "p")
    ops.reset_launches()
    _, _, striped = _small_index(tmp_path, "s", io_devices=4,
                                 io_batch_reads=True, io_coalesce=True)
    with plain, striped:
        assert striped.store.num_devices == 4
        assert ops.LAUNCHES["assign_tc"] == ops.LAUNCHES["bucket_assign"] > 0
        base = plain.self_join()
        for kw in (dict(), dict(io_mode="prefetch", compute_mode="device")):
            _identical(base, striped.self_join(**kw))
        r = plain.cross_join(striped, io_mode="prefetch",
                             compute_mode="device")
        assert r.pairs.shape[0] > 0
        _identical(r, plain.cross_join(striped))


def test_two_replica_schedulers_count_every_verify_launch(cuda, tmp_path,
                                                         monkeypatch):
    """Two replicas of one small index, each with its own scheduler and
    drain thread, serve at once from four submitters on one card: the E = 1
    verify tile's launch count equals the verify calls made (the locked
    counters lose nothing), every launch takes the tensor-core route, both
    replicas give the same answers, and each pool ends with only its warm
    pins."""
    import threading

    from repro_torch.serve import QueryScheduler
    x, eps, built = _small_index(tmp_path, "i")
    built.close()
    calls = {"n": 0}
    lock = threading.Lock()
    inner = ops.pairwise_l2_threshold

    def counted(a, b, e):
        with lock:
            calls["n"] += 1
        return inner(a, b, e)

    monkeypatch.setattr(ops, "pairwise_l2_threshold", counted)
    replicas = [DiskJoinIndex.open(str(tmp_path / "i")) for _ in range(2)]
    rng = np.random.default_rng(3)
    Q = (x[rng.choice(x.shape[0], 256)]
         + rng.normal(scale=1e-3, size=(256, x.shape[1]))).astype(np.float32)
    scheds = [QueryScheduler(r, wave_size=16, max_wait_s=0.002,
                             compute_mode="device", max_queue=4096)
              for r in replicas]
    out = [[None] * len(Q) for _ in scheds]
    ops.reset_launches()

    def submit(k):
        for si, sched in enumerate(scheds):
            futs = [(i, sched.submit(Q[i])) for i in range(k, len(Q), 4)]
            for i, f in futs:
                out[si][i] = f.result(timeout=120)

    threads = [threading.Thread(target=submit, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for sched in scheds:
        sched.close()
    assert not any(t.is_alive() for t in threads)
    launches = ops.launches_snapshot()
    assert calls["n"] > 0
    assert launches["pairwise_l2_threshold"] == calls["n"]
    _assert_tc_verify_only()
    for a, b in zip(*out):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    for r in replicas:
        assert r.device.type == "cuda" and r.device.index is not None
        assert r._pool.in_use == len(r.warm_buckets())
        r.close()


def test_three_way_assign_ties_differ_only_in_float32_band(cuda):
    """Near-ties on the card: rows whose three nearest
    centers lie within the tensor cores' error
    (``test_torch_assign_tc.py``'s data). The ``tc`` route's index and
    mind2 are ``simt``'s bytes on every row (so they differ nowhere, in
    the float32 band or out of it); the rows the bound could not settle
    were rescanned and counted."""
    from tc_emulation import three_way_ties
    _assert_tc_assign_is_simt(cuda, *three_way_ties(64, 128, 1))


def test_four_way_assign_ties_give_simt_bytes(cuda):
    """As the three-way case, with four centers a row within the tensor
    cores' error of each other."""
    from tc_emulation import four_way_ties
    _assert_tc_assign_is_simt(cuda, *four_way_ties(64, 128, 3))


def _assert_tc_assign_is_simt(cuda, x: np.ndarray, c: np.ndarray):
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    plan = assign.launch_plan(xt.shape[0], ct.shape[0], ct.shape[1])
    assert plan.route == "tc"
    d2s, is_ = assign.bucket_assign(xt, ct, assign.LaunchPlan("simt"))
    tiles = -(-ct.shape[0] // plan.block_m)
    for splits in sorted({1, 2, plan.splits, tiles}):
        with verify.counting_rechecks(cuda) as counts:
            d2t, it = assign.bucket_assign(xt, ct, assign.LaunchPlan(
                "tc", plan.block_m, min(splits, tiles)))
        torch.cuda.synchronize()
        assert torch.equal(it, is_) and torch.equal(d2t, d2s)
        assert counts[1].item() > 0 and counts[0].item() == 0
        print(f"splits {splits}: {counts[1].item()} of {len(x)} rows "
              f"rescanned")


def test_resumed_build_on_card_is_byte_identical(cuda, tmp_path,
                                                 monkeypatch):
    """A build killed after its assign scan (the write scan raises)
    resumes on the card without rescanning and leaves an uninterrupted
    build's bucket files, byte for byte; the assign scan launched the
    kernel only in the first attempt."""
    import os
    import sys

    from repro_torch.ft import InjectedKill
    bz = sys.modules["repro_torch.core.bucketize"]
    x = clustered_vectors(4000, 32, seed=5)
    eps = epsilon_for_avg_neighbors(x, 10)
    cfg = JoinConfig(epsilon=eps, pad_align=64, num_buckets=24,
                     memory_budget_bytes=1 << 20)
    store = FlatVectorStore.from_array(str(tmp_path / "x.bin"), x)
    orig = bz.write_buckets

    def killed(*a, **k):
        monkeypatch.setattr(bz, "write_buckets", orig)
        raise InjectedKill("kill during write scan")

    monkeypatch.setattr(bz, "write_buckets", killed)
    with pytest.raises(InjectedKill):
        DiskJoinIndex.build(store, cfg, str(tmp_path / "r"))
    ops.reset_launches()
    resumed = DiskJoinIndex.build(store, cfg, str(tmp_path / "r"))
    assert ops.LAUNCHES["bucket_assign"] == 0
    assert resumed.build_timings["assign"] == 0.0
    fresh = DiskJoinIndex.build(store, cfg, str(tmp_path / "f"))
    assert ops.LAUNCHES["assign_tc"] == ops.LAUNCHES["bucket_assign"] > 0
    with resumed, fresh:
        for name in sorted(os.listdir(tmp_path / "f")):
            path = tmp_path / "f" / name
            if name.startswith("buckets") and path.is_file():
                assert path.read_bytes() == \
                    (tmp_path / "r" / name).read_bytes(), name
        _identical(resumed.self_join(compute_mode="device"),
                   fresh.self_join(compute_mode="device"))


def test_slot_refilled_under_a_long_kernel_keeps_the_device_slab(cuda,
                                                                  tmp_path):
    """Two buckets first-touched from their pinned slots, then evicted and
    a slot refilled at once while a long kernel queue runs: the refill
    waits for a slot's copy, not for the kernels, and the device slabs hold
    the bytes the slots held at the first touch."""
    from repro_torch.compute import DeviceSlabPool
    from repro_torch.core.executor import BucketCache
    from repro_torch.core.types import resolve_bucket_capacity
    from repro_torch.io import PipelineStats
    _, _, index = _small_index(tmp_path, "i")
    with index:
        cap = resolve_bucket_capacity(index._resolve({}), index.meta.sizes)
        stats = PipelineStats()
        cache = BucketCache(index.store, index.meta.sizes, cap,
                            stats=stats, slots=2, pin=True)
        pool = DeviceSlabPool(cuda, stats)
        for b in (0, 1):
            cache.load(b)
        host = [cache.get(b)[0].copy() for b in (0, 1)]
        big = torch.randn(4096, 4096, device=cuda)
        for _ in range(64):
            big = big @ big / 64
        kernels_done = torch.cuda.Event()
        kernels_done.record()
        devs, slots = [], []
        for b in (0, 1):
            entry = cache.checkout(b)
            devs.append(pool.operand(b, entry[0], entry[3]))
            slots.append(entry[3])
            cache.release(entry)
        for b in (0, 1):
            cache.evict(b)
            pool.evict(b)
        cache.load(2)
        assert not kernels_done.query(), "the refill waited on the kernels"
        assert cache.get(2)[3] in slots and cache.slot_grows == 0
        torch.cuda.synchronize()
        for dev, h in zip(devs, host):
            assert np.array_equal(dev.cpu().numpy(), h)
        vecs, ids = index.store.read_bucket(2)
        assert np.array_equal(cache.get(2)[0][:len(ids)], vecs)
        assert (stats.h2d_direct, stats.h2d_staged) == (2, 0)


SUPERSTEP_BUDGET = dict(memory_budget_bytes=1 << 17)  # a few buckets a window


def _superstep_join(index, **kw):
    from repro_torch.core.distributed import DistributedJoin
    cfg = index._resolve(dict(SUPERSTEP_BUDGET, **kw))
    graph, _, _ = index._graph_for(cfg)
    return DistributedJoin(index.store, index.meta, cfg), graph


@pytest.mark.parametrize("mode", ["host", "device"])
def test_superstep_join_is_the_single_box_join_on_card(cuda, tmp_path,
                                                       mode):
    """The superstep join on the card gives the single-box join's bytes
    (pairs and distances) over many windows, and every verify launch takes
    the tensor-core route."""
    _, _, index = _small_index(tmp_path, "i")
    with index:
        single = index.self_join(compute_mode=mode, **SUPERSTEP_BUDGET)
        dj, graph = _superstep_join(index, compute_mode=mode)
        ops.reset_launches()
        pairs, info = dj.run(graph)
        _assert_tc_verify_only()
        assert ops.LAUNCHES["pairwise_l2_threshold"] == 0
        assert info["supersteps"] > 3
        assert np.array_equal(pairs, single.pairs)
        assert np.array_equal(info["dists"], single.distances)
        if mode == "device":
            assert 0 < info["h2d_transfers"] <= info["host_loads"]
            assert info["device_slab_hits"] > 0
            assert dj._dev_pool.direct == 0   # its cache is not pinned


def test_superstep_kill_and_resume_on_card(cuda, tmp_path):
    """A device-mode superstep join killed at 60% of its supersteps and
    resumed from its checkpoints gives the uninterrupted run's bytes and
    raw-row watermark."""
    from repro_torch.ft import (FaultInjector, InjectedKill,
                                JoinCheckpointer)
    _, _, index = _small_index(tmp_path, "i")
    with index:
        dj, graph = _superstep_join(index, compute_mode="device")
        base_pairs, base = dj.run(graph)
        kill_at = max(1, int(base["supersteps"] * 0.6))
        ckdir = str(tmp_path / "ck")
        ck = JoinCheckpointer(ckdir)
        with pytest.raises(InjectedKill):
            dj.run(graph, checkpointer=ck,
                   fault=FaultInjector(kill_at_superstep=kill_at))
        ck.finish()
        ops.reset_launches()
        pairs, info = dj.run(graph, checkpointer=JoinCheckpointer(ckdir),
                             resume_from=ckdir)
        _assert_tc_verify_only()
        assert 0 < info["resumed_at"] <= kill_at
        assert np.array_equal(pairs, base_pairs)
        assert np.array_equal(info["dists"], base["dists"])
        assert info["watermark_rows"] == base["watermark_rows"]


def test_center_index_above_crossover_matches_cpu(cuda):
    """Scan 2 above the reference's crossover goes through the IVF index:
    its assign on the card equals the CPU's at 8,192 rows × 65,537
    centers, except on float32 ties (two centers whose float64 d² lie
    within 2^-20 |x|² of each other)."""
    from repro_torch.core.center_index import IVFCenterIndex, \
        make_center_index
    data = clustered_vectors(8192 + 65_537, 128, seed=11)
    x, centers = data[:8192], data[8192:]
    on_card = make_center_index(centers, device=cuda)
    on_cpu = make_center_index(centers, device=torch.device("cpu"))
    assert isinstance(on_card, IVFCenterIndex)
    d_card, i_card = on_card.assign(x)
    d_cpu, i_cpu = on_cpu.assign(x)
    same = i_card == i_cpu
    np.testing.assert_allclose(d_card[same], d_cpu[same], **D2_TOL)
    x64, c64 = x[~same].astype(np.float64), centers.astype(np.float64)
    gap = (((x64 - c64[i_card[~same]]) ** 2).sum(1)
           - ((x64 - c64[i_cpu[~same]]) ** 2).sum(1))
    assert (np.abs(gap) <= 2.0 ** -20 * (x64 * x64).sum(1)).all(), \
        f"{int((~same).sum())} rows differ"


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
# kernel vs plain version: float32 as tests/test_kernels.py:60; bf16 in
# chip_smoke.py's ATTN_TOL form, 4e-3 * (1 + |want|): one bf16 rounding of
# outputs up to ~2 in magnitude
FLASH_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
             torch.bfloat16: dict(rtol=4e-3, atol=4e-3)}


def _rolling(steps: int, written: int) -> torch.Tensor:
    kpos = torch.full((steps,), -1, dtype=torch.int32)
    for p in range(written):
        kpos[p % steps] = p
    return kpos


# (sq, t, causal, window, q_offset, rolling cache positions written)
FLASH_CASES = {
    "prefill_ragged": (130, 130, True, 0, 0, None),
    "prefill_ragged_97": (97, 97, True, 0, 0, None),
    "full": (70, 200, False, 0, 0, None),
    "window": (150, 150, True, 32, 0, None),
    "offset": (33, 103, True, 0, 70, None),
    "decode_empty_slots": (1, 200, True, 0, 37, 38),
    "decode_wrapped": (1, 64, True, 0, 100, 101),
    "decode_wrapped_window": (1, 64, True, 32, 100, 101),
    "decode_ragged_t": (2, 100, True, 0, 98, None),
    "chunk_on_cache": (5, 96, True, 0, 20, 25),
    "chunk40_rolling": (40, 64, True, 0, 50, 90),
    "chunk40_rolling_window": (40, 64, True, 24, 50, 90),
}


def _flash_inputs(cuda, case, g, dtype, d, hkv=3):
    sq, t, causal, window, q_offset, written = FLASH_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(sq * 1000 + t + g + d)
    b = 2
    q = torch.randn(b, sq, hkv * g, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(b, t, hkv, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(b, t, hkv, d, device=cuda, generator=gen).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if written is not None:
        kw["kv_positions"] = _rolling(t, written).to(cuda)
    return q, k, v, kw


def _check_flash(out, q, k, v, kw):
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == q.dtype
    want = ref.gqa_attention(q, k, v, **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **FLASH_TOL[q.dtype])


def _route(q, k) -> str:
    b, sq, h, d = q.shape
    return flash.launch_plan(b, sq, k.shape[1], h, k.shape[2], d,
                             q.dtype).route


def _assert_one_launch(route: str) -> None:
    assert ops.LAUNCHES["flash_attention"] == 1
    for r, counter in flash.ROUTE_COUNTERS.items():
        assert ops.LAUNCHES[counter] == int(r == route), ops.LAUNCHES


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_kernel_matches_plain(cuda, case, g, dtype, d):
    q, k, v, kw = _flash_inputs(cuda, case, g, dtype, d)
    ops.reset_launches()
    out = ops.gqa_attention(q, k, v, **kw)
    _assert_one_launch(_route(q, k))
    _check_flash(out, q, k, v, kw)


def _forced(q, k, v, kw, plan):
    pos = kw.get("kv_positions")
    return flash.flash_attention(
        q, k, v, causal=kw["causal"], window=kw["window"],
        q_offset=kw["q_offset"], scale=q.shape[-1] ** -0.5,
        kv_positions=None if pos is None else pos.to(torch.int32), plan=plan)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("g", [1, 2, 3, 4, 6, 10])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_tc_route_matches_plain(cuda, case, g, d, dtype):
    """Every case through the tensor-core kernel of its dtype (tc for
    bf16, tc32 for float32), whatever route launch_plan would pick for it
    (decode shapes included); g = 3, 6 and 10 do not divide the block's
    rows, so Q takes the plain-load path. float32 is also held to the
    CUDA-core kernel on the same inputs, within the same limit."""
    q, k, v, kw = _flash_inputs(cuda, case, g, dtype, d)
    out = _forced(q, k, v, kw, flash.LaunchPlan(*flash.TC_ROUTES[dtype]))
    _check_flash(out, q, k, v, kw)
    if dtype == torch.float32:
        simt = _forced(q, k, v, kw, flash.LaunchPlan("simt", 4))
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.cpu().numpy(), simt.cpu().numpy(),
                                   **FLASH_TOL[torch.float32])


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_tc32_is_deterministic(cuda, d):
    """float32 prefill at D 64/128/256 takes tc32; two calls give the same
    bits."""
    q, k, v, kw = _flash_inputs(cuda, "prefill_ragged", 2, torch.float32, d)
    assert _route(q, k) == "tc32"
    ops.reset_launches()
    a = ops.gqa_attention(q, k, v, **kw)
    b = ops.gqa_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_prefill_tc32"] == 2
    assert torch.equal(a, b)


SPLIT_CASES = [(c, g) for c in sorted(FLASH_CASES) for g in (1, 2, 4, 8)
               if FLASH_CASES[c][0] * g <= flash.DECODE_MAX_ROWS]


@pytest.mark.parametrize("case,g", SPLIT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_split_route_matches_plain(cuda, case, g, dtype, d):
    q, k, v, kw = _flash_inputs(cuda, case, g, dtype, d, hkv=2)
    ops.reset_launches()
    out = ops.gqa_attention(q, k, v, **kw)
    _assert_one_launch("split")
    _check_flash(out, q, k, v, kw)


@pytest.mark.parametrize("sq,g", [(16, 1), (8, 2), (17, 1), (9, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_route_boundary(cuda, sq, g, dtype):
    """Sq·g = 16 splits KV; 17 takes the prefill kernel of its dtype (at D
    128 the tensor-core one: tc in bf16, tc32 in float32)."""
    gen = torch.Generator(device=cuda).manual_seed(sq * g)
    q = torch.randn(2, sq, 2 * g, 128, device=cuda, generator=gen).to(dtype)
    k = torch.randn(2, 80, 2, 128, device=cuda, generator=gen).to(dtype)
    v = torch.randn(2, 80, 2, 128, device=cuda, generator=gen).to(dtype)
    kw = dict(causal=True, q_offset=80 - sq)
    ops.reset_launches()
    out = ops.gqa_attention(q, k, v, **kw)
    want_route = ("split" if sq * g <= 16 else
                  "tc" if dtype == torch.bfloat16 else "tc32")
    assert _route(q, k) == want_route
    _assert_one_launch(want_route)
    _check_flash(out, q, k, v, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_split_with_only_empty_slots(cuda, dtype):
    """A 64-key split whose slots are all -1 (and a ragged last split)
    loads no K/V and leaves the result unchanged."""
    t = 200
    kpos = torch.arange(t, dtype=torch.int32)
    kpos[64:128] = -1
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(3, 1, 4, 64, device=cuda, generator=gen).to(dtype)
    k = torch.randn(3, t, 2, 64, device=cuda, generator=gen).to(dtype)
    v = torch.randn(3, t, 2, 64, device=cuda, generator=gen).to(dtype)
    kw = dict(causal=True, q_offset=t - 1, kv_positions=kpos.to(cuda))
    ops.reset_launches()
    out = ops.gqa_attention(q, k, v, **kw)
    _assert_one_launch("split")
    _check_flash(out, q, k, v, kw)
    # the empty split's K/V never reach the result: poison them
    k[:, 64:128] = float("nan")
    v[:, 64:128] = float("nan")
    again = ops.gqa_attention(q, k, v, **kw)
    assert torch.equal(again, out)


# a decode cache split over ranks by its rows: (T, positions written,
# window); the slices past the written positions, or outside the window,
# see no key
SEQ_SHARD_CASES = {"full": (512, 512, 0), "half_written": (512, 300, 0),
                   "window": (512, 512, 64), "rolling": (256, 700, 0)}


@pytest.mark.parametrize("case", sorted(SEQ_SHARD_CASES))
@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_slices_merged_equal_one_launch(cuda, case, n, dtype):
    """A decode cache cut into n slices of rows: each slice through the
    split route with its log-sum-exp, then the merge launch, equals one
    launch over the whole cache within the decode tolerance, slices that
    see no key included (their lse is -inf); each slice's lse equals the
    plain version's."""
    t, written, window = SEQ_SHARD_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(t + n + written)
    b, h, hkv, d = 3, 16, 8, 128
    q = torch.randn(b, 1, h, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(b, t, hkv, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(b, t, hkv, d, device=cuda, generator=gen).to(dtype)
    kpos = _rolling(t, written).to(cuda)
    kw = dict(causal=True, window=window, q_offset=written - 1)
    whole = ops.gqa_attention(q, k, v, kv_positions=kpos, **kw)
    outs, lses = [], []
    for k_, v_, p_ in zip(k.chunk(n, 1), v.chunk(n, 1), kpos.chunk(n)):
        ops.reset_launches()
        o, lse = ops.gqa_attention_lse(q, k_, v_, kv_positions=p_, **kw)
        _assert_one_launch("split")
        want_o, want_lse = ref.gqa_attention_lse(q, k_, v_,
                                                 kv_positions=p_, **kw)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
        fin = ~torch.isinf(want_lse)
        np.testing.assert_allclose(lse[fin].cpu().numpy(),
                                   want_lse[fin].cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)
        outs.append(o)
        lses.append(lse)
    empty = {"window": n >= 2, "half_written": n >= 4}.get(case, False)
    assert any(torch.isinf(x).all().item() for x in lses) == empty
    ops.reset_launches()
    merged = ops.decode_merge(torch.stack(outs), torch.stack(lses), dtype,
                              hkv)
    assert ops.LAUNCHES["flash_decode_merge"] == 1
    torch.cuda.synchronize()
    assert merged.dtype == dtype and merged.shape == whole.shape
    np.testing.assert_allclose(merged.float().cpu().numpy(),
                               whole.float().cpu().numpy(),
                               **FLASH_TOL[dtype])
    plain = ref.decode_merge(torch.stack(outs).cpu(),
                             torch.stack(lses).cpu())
    np.testing.assert_allclose(merged.float().cpu().numpy(),
                               plain.numpy(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("d", [16, 64, 256])
def test_flash_kernel_head_dims(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(1, 80, 4, d, device=cuda, generator=gen)
    k = torch.randn(1, 80, 2, d, device=cuda, generator=gen)
    out = ops.gqa_attention(q, k, k, causal=True)
    want = ref.gqa_attention(q, k, k, causal=True)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               **FLASH_TOL[torch.float32])


@pytest.mark.parametrize("sq,t,causal", [(128, 128, True), (64, 200, True),
                                         (100, 37, False)])
def test_flash_attention_bhsd_layout(cuda, sq, t, causal):
    """``ops.flash_attention``'s (B, H, S, D) layout is read through
    transposed strides; causal S < T is tril(k=T−S)."""
    gen = torch.Generator(device=cuda).manual_seed(sq + t)
    q = torch.randn(2, 4, sq, 64, device=cuda, generator=gen)
    k = torch.randn(2, 4, t, 64, device=cuda, generator=gen)
    v = torch.randn(2, 4, t, 64, device=cuda, generator=gen)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ref.attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               **FLASH_TOL[torch.float32])


@pytest.mark.parametrize("sq,t,causal", [(128, 128, True), (64, 200, True),
                                         (100, 37, False)])
def test_flash_attention_bhsd_layout_bf16(cuda, sq, t, causal):
    """The tensor-core route reads the (B, H, S, D) layout's transposed
    strides through its TMA maps, with no copy."""
    gen = torch.Generator(device=cuda).manual_seed(sq + t)
    q, k, v = (torch.randn(2, 4, n, 64, device=cuda, generator=gen)
               .to(torch.bfloat16) for n in (sq, t, t))
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal)
    _assert_one_launch("tc")
    want = ref.attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **FLASH_TOL[torch.bfloat16])


def test_flash_kernel_unaligned_strides(cuda):
    """Strides the kernel cannot read 4 at a time are copied first."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    big = torch.randn(2, 40, 4, 34, device=cuda, generator=gen)
    q = big[..., :32]                   # row stride 34: not a multiple of 4
    k = big[:, :, :2, 2:]               # base address off by 2 elements
    out = ops.gqa_attention(q, k, k, causal=True)
    want = ref.gqa_attention(q, k, k, causal=True)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               **FLASH_TOL[torch.float32])


def test_flash_tc32_unaligned_strides(cuda):
    """Operands the float32 tensor-core routes cannot read through TMA (a
    row stride not a multiple of 4 elements, a base address off by 2) are
    copied to dense first, forward and backward: the result is the one of
    the dense copies, bit for bit, and within the limits of the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    big = torch.randn(2, 70, 4, 66, device=cuda, generator=gen)
    q = big[..., :64]                   # row stride 66
    k = big[:, :, :2, 2:]               # base address off by 2 elements
    v = big[:, :, 2:, 1:65]
    kw = dict(causal=True)
    assert _route(q, k) == "tc32" and _bwd_route(q, k) == "tc32"
    ops.reset_launches()
    out = ops.gqa_attention(q, k, v, **kw)
    dense = [x.contiguous() for x in (q, k, v)]
    again = ops.gqa_attention(*dense, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_prefill_tc32"] == 2
    assert torch.equal(out, again)
    _check_flash(out, q, k, v, kw)
    dout = torch.randn(out.shape, device=cuda, generator=gen)
    got = ops.gqa_attention_bwd(q, k, v, out, dout, **kw)
    want = ops.gqa_attention_bwd(*dense, out, dout, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_bwd_tc32"] == 2
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    _check_bwd(got, q, k, v, out, dout, dict(kw, window=0, q_offset=0))


def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 4, 2, 40, device=cuda)  # head dim not a multiple of 16
    with pytest.raises(ValueError):
        ops.gqa_attention(q, q, q, causal=True)
    q = torch.zeros(1, 4, 2, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.gqa_attention(q, q, q, causal=True)


def test_full_width_two_layer_decode_and_prefill_launches(cuda):
    """qwen3-0.6b at full width, cut to 2 layers, bf16: every attention
    layer of a decode step and of a prefill launches the kernel once."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2)
    bundle = build_model(cfg)
    params = bundle.init(0)
    caches = bundle.init_cache(4, 64)
    tok = torch.randint(0, cfg.vocab, (4, 1), device=cuda)
    ops.reset_launches()
    with torch.inference_mode():
        logits, caches = bundle.decode(params, tok, caches)
        assert ops.LAUNCHES["flash_attention"] == 2
        assert ops.LAUNCHES["flash_decode_split"] == 2
        pre = bundle.prefill(params, {"tokens": tok.repeat(1, 40)})
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 4
    assert ops.LAUNCHES["flash_prefill_tc"] == 2
    assert ops.LAUNCHES["flash_simt"] == 0
    assert logits.shape == pre.shape == (4, cfg.vocab)
    assert torch.isfinite(logits).all() and torch.isfinite(pre).all()
    assert caches[0]["pos"] == 1 and caches[0]["kpos"][0].item() == 0


def test_full_width_float32_decode_matches_forward(cuda):
    """Decode step by step reproduces the teacher-forced forward
    (tests/test_models.py's tolerance), 2 layers at full width, float32."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              param_dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init(1)
    tok = torch.randint(0, cfg.vocab, (2, 24), device=cuda)
    with torch.inference_mode():
        hidden, _ = transformer.forward(params, tok)
        tf = transformer.lm_logits(params, hidden)
        caches = bundle.init_cache(2, 32)
        steps = [bundle.decode(params, tok[:, i:i + 1], caches)[0]
                 for i in range(24)]
    np.testing.assert_allclose(torch.stack(steps, 1).cpu().numpy(),
                               tf.cpu().numpy(), rtol=2e-2, atol=2e-3)


def test_serve_engine_on_card_matches_cpu(cuda):
    """The smoke config served on the card (the flash kernel) and on the
    CPU (its plain version) with the same weights gives the same tokens,
    where the CPU's top-2 logits are well apart."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    on_card = build_model(cfg).init(4)
    on_cpu = build_model(cfg, device="cpu").init(4)
    on_cpu.load_state_dict({k: v.cpu()
                            for k, v in on_card.state_dict().items()})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (6, 11, 6, 11)]
    results, gaps = {}, []
    for name, params, device in (("cpu", on_cpu, "cpu"),
                                 ("cuda", on_card, None)):
        eng = ServeEngine(cfg, slots=2, max_seq=32, params=params,
                          device=device)
        if name == "cpu":
            inner = eng._decode

            def decode(p, t, c, inner=inner):
                logits, c = inner(p, t, c)
                top2 = torch.sort(logits, -1).values[:, -2:]
                gaps.append((top2[:, 1] - top2[:, 0]).min().item())
                return logits, c
            eng._decode = decode
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        ops.reset_launches()
        results[name] = eng.run()
        if name == "cuda":
            assert ops.LAUNCHES["flash_attention"] == \
                cfg.n_layers * eng.stats["steps"]
    assert min(gaps) > 1e-3
    assert results["cuda"] == results["cpu"]


FAMILIES = ["olmoe-1b-7b", "deepseek-moe-16b", "mamba2-1.3b",
            "recurrentgemma-2b", "internvl2-26b", "whisper-small"]


def _family_batch(cfg, rng) -> dict:
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 20))}
    if cfg.family == "vlm":
        enc = cfg.encoder
        batch["patches"] = rng.normal(size=(2, enc.n_patches,
                                            enc.frontend_dim))
    if cfg.enc_dec:
        batch["frames"] = rng.normal(size=(2, cfg.encoder.n_frames,
                                           cfg.d_model))
    return {k: torch.from_numpy(v.astype(np.float32 if v.dtype.kind == "f"
                                         else np.int64))
            for k, v in batch.items()}


def _prefill_and_decode(bundle, params, batch, steps=3):
    """The bundle's prefill logits, then ``steps`` decode steps' logits
    from fresh caches (enc-dec: over the encoded frames)."""
    dev = bundle.device
    batch = {k: v.to(dev) for k, v in batch.items()}
    pre = bundle.prefill(params, batch)
    if bundle.cfg.enc_dec:
        caches = bundle.init_cache(2, 32, params=params,
                                   enc_out=encdec.encode(params,
                                                         batch["frames"]))
    else:
        caches = bundle.init_cache(2, 32)
    tok = batch["tokens"]
    dec = [bundle.decode(params, tok[:, i:i + 1], caches)[0]
           for i in range(steps)]
    return pre, torch.stack(dec, 1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """Each family's smoke config (float32) on the card, through the flash
    kernel, against the port's CPU plain path on the same weights: a
    prefill (VLM with patches, whisper over frames) and three decode
    steps, within 1e-3; every attention call launches the kernel."""
    cfg = smoke_config(get_config(arch))
    card, cpu = build_model(cfg), build_model(cfg, device="cpu")
    on_card = card.init(5)
    on_cpu = cpu.init(5)
    on_cpu.load_state_dict({k: v.cpu()
                            for k, v in on_card.state_dict().items()})
    batch = _family_batch(cfg, np.random.default_rng(7))
    ops.reset_launches()
    with torch.inference_mode():
        got = _prefill_and_decode(card, on_card, batch)
        want = _prefill_and_decode(cpu, on_cpu, batch)
    torch.cuda.synchronize()
    if cfg.enc_dec:  # encoder layers a call, self + cross a decoder layer
        calls = 2 * cfg.encoder.n_layers + cfg.n_layers * (2 + 2 * 3)
    else:
        calls = sum(k in transformer.ATTN_KINDS
                    for k in transformer.layer_kinds(cfg)) * (1 + 3)
    assert ops.LAUNCHES["flash_attention"] == calls
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# flash attention backward (csrc/flash_backward_sm90.cu for bf16 and
# csrc/flash_backward_sm90_f32.cu for float32 at D 64, 128 and 256,
# csrc/flash_backward.cu otherwise)
# ---------------------------------------------------------------------------
# Three limits a gradient, each must hold. (1) max |kernel − plain| ≤ tol ·
# max |plain|: bf16 one rounding of each output in the kernel and in the
# plain version (2^-8 relative) with room for float32 sums taken in another
# order; float32 the sums' order alone. (2) Element by element, |Δ| ≤
# atol · max |plain| + rtol · |plain|: a bf16 output may round one ulp
# (≤ 2^-7 relative) away from the plain one, but no more, so a small
# element (a late key's dK or dV) is held to its own size. (3) ‖Δ‖ ≤
# norm · ‖plain‖ (chip_smoke.py's rows read ≤ 2.8e-4 in bf16 on the
# tensor-core route, ≤ 7.3e-5 on the CUDA-core one, and ≤ 1.3e-6 in
# float32 on an H100 80GB HBM3, and are held to the same limits).
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
BWD_ELEM_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-3, 1e-2)}
BWD_NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _bwd_inputs(cuda, case, g, dtype, d, hkv=3):
    q, k, v, kw = _flash_inputs(cuda, case, g, dtype, d, hkv)
    gen = torch.Generator(device=cuda).manual_seed(g * 7 + d)
    out = ref.gqa_attention(q, k, v, **kw)
    dout = torch.randn(out.shape, device=cuda, generator=gen).to(dtype)
    return q, k, v, out, dout, kw


def _bwd_route(q, k) -> str:
    b, sq, h, d = q.shape
    return flash.bwd_launch_plan(b, sq, k.shape[1], h, k.shape[2], d,
                                 q.dtype).route


def _assert_one_bwd(route: str) -> None:
    assert ops.LAUNCHES["flash_attention_bwd"] == 1
    for r, counter in flash.BWD_ROUTE_COUNTERS.items():
        assert ops.LAUNCHES[counter] == int(r == route), ops.LAUNCHES


def _check_bwd(got, q, k, v, out, dout, kw, want=None):
    """``got`` against ``want`` (default: the plain backward) under the
    three limits."""
    torch.cuda.synchronize()
    if want is None:
        want = ref.gqa_attention_bwd(q, k, v, out, dout, **kw)
    atol, rtol = BWD_ELEM_TOL[q.dtype]
    for name, x, w, like in zip("qkv", got, want, (q, k, v)):
        assert x.shape == like.shape and x.dtype == like.dtype, name
        assert torch.isfinite(x).all(), name
        x, w = x.float(), w.float()
        diff, top = (x - w).abs(), w.abs().max().item()
        err = diff.max().item()
        assert err <= BWD_TOL[q.dtype] * top, (name, err)
        over = diff > atol * top + rtol * w.abs()
        assert not over.any(), (name, int(over.sum()), diff[over].max())
        norm = (x - w).norm().item() / max(w.norm().item(), 1e-30)
        assert norm <= BWD_NORM_TOL[q.dtype], (name, norm)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("g", [1, 2, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_kernel_matches_plain(cuda, case, g, dtype, d):
    """Every mask kind (causal, non-causal cross Sq ≠ T, window, offset,
    rolling cache positions with empty slots), g 1 to 10, D 64 to 256:
    one counted call on its route, the tensor-core kernel of its dtype (D
    64, 128 and 256 all take it: tc for bf16, tc32 for float32)."""
    q, k, v, out, dout, kw = _bwd_inputs(cuda, case, g, dtype, d)
    ops.reset_launches()
    got = ops.gqa_attention_bwd(q, k, v, out, dout, **kw)
    _assert_one_bwd("tc" if dtype == torch.bfloat16 else "tc32")
    assert ops.LAUNCHES["flash_attention"] == 0
    _check_bwd(got, q, k, v, out, dout, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_rows_with_no_visible_key(cuda, dtype):
    """Rows whose keys are all masked (cache slots not yet written, or at
    positions after the query) get the reference's uniform P: dV shares
    dO / T, dQ and dK get nothing from them."""
    q, k, v, out, dout, kw = _bwd_inputs(cuda, "decode_empty_slots", 2,
                                         dtype, 64)
    kw = dict(kw, q_offset=0,
              kv_positions=torch.tensor([-1, 5, 9] * 66 + [-1, 7],
                                        dtype=torch.int32, device=cuda))
    q = q.repeat(1, 3, 1, 1)   # rows at positions 0, 1, 2: none sees a key
    out = ref.gqa_attention(q, k, v, **kw)
    dout = dout.repeat(1, 3, 1, 1)
    ops.reset_launches()
    got = ops.gqa_attention_bwd(q, k, v, out, dout, **kw)
    _assert_one_bwd("tc" if dtype == torch.bfloat16 else "tc32")
    _check_bwd(got, q, k, v, out, dout, kw)
    assert got[0].abs().max().item() == 0.0
    assert got[2].abs().max().item() > 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_is_deterministic(cuda, dtype):
    """No atomics: two identical calls give the same bits (tc in bf16,
    tc32 in float32)."""
    q, k, v, out, dout, kw = _bwd_inputs(cuda, "prefill_ragged", 10,
                                         dtype, 128)
    route = flash.TC_ROUTES[dtype][0]
    assert _bwd_route(q, k) == route
    ops.reset_launches()
    a = ops.gqa_attention_bwd(q, k, v, out, dout, **kw)
    b = ops.gqa_attention_bwd(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[flash.BWD_ROUTE_COUNTERS[route]] == 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("d,window", [(256, 100), (128, 0), (64, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_split_is_deterministic(cuda, d, window, dtype):
    """One KV head at B 1 (recurrentgemma's kind, g 10): the dK/dV row walk
    is split and its float32 parts summed in a fixed order, so two calls
    give the same bits, and the gradients hold the plain version's limits;
    the tc32 route splits as tc does."""
    b, s, hkv, g = 1, 300, 1, 10
    plan = flash.bwd_launch_plan(b, s, s, hkv * g, hkv, d, dtype)
    route = flash.TC_ROUTES[dtype][0]
    assert plan.route == route and plan.n_split > 1
    gen = torch.Generator(device=cuda).manual_seed(d + window)
    q = torch.randn(b, s, hkv * g, d, device=cuda, generator=gen)
    k, v = (torch.randn(b, s, hkv, d, device=cuda, generator=gen)
            for _ in range(2))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(causal=True, window=window, q_offset=0)
    out = ref.gqa_attention(q, k, v, **kw)
    dout = torch.randn(out.shape, device=cuda, generator=gen).to(dtype)
    ops.reset_launches()
    first = ops.gqa_attention_bwd(q, k, v, out, dout, **kw)
    again = ops.gqa_attention_bwd(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[flash.BWD_ROUTE_COUNTERS[route]] == 2
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    _check_bwd(first, q, k, v, out, dout, kw)


@pytest.mark.parametrize("case", ["prefill_ragged", "window", "full",
                                  "chunk40_rolling_window",
                                  "decode_empty_slots"])
@pytest.mark.parametrize("g", [1, 2, 10])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_tc_matches_simt(cuda, case, g, d, dtype):
    """The tensor-core route of each dtype (tc, tc32) against the CUDA-core
    one on the same inputs, each route forced by its plan, held to each
    other under the dtype's three limits."""
    q, k, v, out, dout, kw = _bwd_inputs(cuda, case, g, dtype, d)
    b, sq, h, _ = q.shape
    tc = flash.bwd_launch_plan(b, sq, k.shape[1], h, k.shape[2], d, dtype)
    assert tc.route == flash.TC_ROUTES[dtype][0]
    simt = flash.BwdLaunchPlan("simt", 4, 1, tc.stats_shape, tc.delta_shape)
    pos = kw.get("kv_positions")
    args = dict(causal=kw["causal"], window=kw["window"],
                q_offset=kw["q_offset"], scale=d ** -0.5,
                kv_positions=None if pos is None else pos.to(torch.int32))
    got = flash.flash_attention_bwd(q, k, v, out, dout, plan=tc, **args)
    want = flash.flash_attention_bwd(q, k, v, out, dout, plan=simt, **args)
    _check_bwd(got, q, k, v, out, dout, kw, want=want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_uses_both_kernels(cuda, dtype):
    """Under autograd the forward launches its route once and the backward
    the backward kernel once; the gradients are the plain backward's. Under
    inference_mode nothing is saved and no backward exists."""
    q, k, v, _, dout, kw = _bwd_inputs(cuda, "window", 2, dtype, 128)
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    ops.reset_launches()
    out = ops.gqa_attention(q, k, v, **kw)
    assert out.requires_grad
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert ops.LAUNCHES["flash_attention"] == 1
    _assert_one_bwd("tc" if dtype == torch.bfloat16 else "tc32")
    _check_bwd(grads, q.detach(), k.detach(), v.detach(), out.detach(),
               dout, kw)
    with torch.inference_mode():
        served = ops.gqa_attention(q, k, v, **kw)
    assert not served.requires_grad
    assert torch.equal(served, out.detach())
    assert ops.LAUNCHES["flash_attention"] == 2


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------
def test_train_step_launches_and_matches_cpu(cuda):
    """One train step of the smoke config (float32) on the card and on the
    CPU from the same weights: with remat, each attention layer launches
    the forward twice (the forward and its recomputation) and the backward
    kernel once; the loss, every gradient and every parameter after the
    AdamW step agree with the CPU's plain path."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import AdamW, AdamWConfig

    class RecordingAdamW(AdamW):
        """AdamW that keeps a copy of the gradients it is handed."""

        def update(self, grads, state, params):
            self.grads = {n: None if g is None else g.detach().cpu().clone()
                          for n, g in grads.items()}
            return super().update(grads, state, params)

    cfg = smoke_config(get_config("qwen3-0.6b"))
    tok = torch.randint(0, cfg.vocab, (2, 40))
    weights = build_model(cfg).init(3).state_dict()
    out = {}
    for device in ("cuda", "cpu"):
        bundle = build_model(cfg, device=device)
        params = bundle.init(3)
        params.load_state_dict({k: v.to(device) for k, v in weights.items()})
        opt = RecordingAdamW(AdamWConfig(learning_rate=1e-3, warmup_steps=1))
        step = make_train_step(bundle, opt)
        batch = {"tokens": tok.to(device), "labels": tok.to(device)}
        ops.reset_launches()
        params, state, met = step(params, opt.init(params), batch)
        out[device] = (params, met, ops.launches_snapshot(), opt.grads)
    launches = out["cuda"][2]
    assert launches["flash_attention"] == 2 * cfg.n_layers
    assert launches["flash_attention_bwd"] == cfg.n_layers
    assert launches["flash_bwd_simt"] == cfg.n_layers   # float32
    assert out["cpu"][2]["flash_attention_bwd"] == 0
    np.testing.assert_allclose(float(out["cuda"][1]["loss"]),
                               float(out["cpu"][1]["loss"]), rtol=1e-5)
    # every gradient within ‖Δ‖ ≤ 1e-4 ‖g_cpu‖: this is what holds the
    # backward kernel (and the rest of the backward) to the CPU's
    card_grads, cpu_grads = out["cuda"][3], out["cpu"][3]
    assert sorted(card_grads) == sorted(cpu_grads)
    for name, want in cpu_grads.items():
        got = card_grads[name]
        assert (got is None) == (want is None), name
        if want is None:
            continue
        assert torch.isfinite(got).all(), name
        rel = (got - want).norm().item() / max(want.norm().item(), 1e-30)
        assert rel <= 1e-4, (name, rel)
    # a sanity check of the update only: Adam's first step moves each
    # element by about lr·sign(g), so where float32 noise flips the sign of
    # a near-zero gradient the two differ by up to 2·lr, and nowhere by more
    card = dict(out["cuda"][0].named_parameters())
    for name, p in out["cpu"][0].named_parameters():
        np.testing.assert_allclose(card[name].detach().cpu().numpy(),
                                   p.detach().numpy(), rtol=0,
                                   atol=2.01e-3, err_msg=name)


def test_serving_launches_unchanged_after_training(cuda):
    """A model whose parameters require grad (after a train step) serves
    under inference_mode exactly as before: the same forward launches, no
    backward launch, no graph."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2)
    bundle = build_model(cfg)
    params = bundle.init(0).requires_grad_(True)
    tok = torch.randint(0, cfg.vocab, (4, 40), device=cuda)
    ops.reset_launches()
    with torch.inference_mode():
        pre = bundle.prefill(params, {"tokens": tok})
        caches = bundle.init_cache(4, 64)
        logits, _ = bundle.decode(params, tok[:, :1], caches)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_prefill_tc"] == 2
    assert ops.LAUNCHES["flash_decode_split"] == 2
    assert ops.LAUNCHES["flash_attention_bwd"] == 0
    assert pre.grad_fn is None and logits.grad_fn is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_op_cost_counts_the_kernels_at_their_launch_sites(cuda, dtype):
    """``launch.op_cost.OpCost`` sees each hand-written kernel only through
    ``ops.COST_HOOK``: one flash forward, one flash backward and one verify
    call count one launch each, with ``roofline.kernel_cost``'s FLOPs (the
    plain version's count), work FLOPs (the causal mask's pairs) and
    bytes, under the kernel's route; the hook is gone after the census."""
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.launch.roofline import attention_counts, kernel_cost
    b, s, h, hkv, d = 2, 96, 4, 2, 64
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(b, s, hkv, d, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    u, w = (torch.randn(3, 64, 32, device=cuda, generator=g)
            for _ in range(2))
    q.requires_grad_(True)
    name = ops.dtype_name(dtype)
    shape = (b, s, s, h, hkv, d)
    counts = attention_counts(s, s, causal=True)
    with OpCost() as oc:
        with torch.enable_grad():
            out = ops.gqa_attention(q, k, v, causal=True)
            torch.autograd.grad(out.float().sum(), (q,))
        ops.verify_pairs_batch(u, w, 1.0)
        torch.cuda.synchronize()
    assert ops.COST_HOOK is None
    kernels = oc.summary()["kernels"]
    assert set(kernels) == {"flash_attention", "flash_attention_bwd",
                            "verify_pairs_batch"}
    route = flash.launch_plan(b, s, s, h, hkv, d, dtype).route
    bwd_route = flash.bwd_launch_plan(b, s, s, h, hkv, d, dtype).route
    for kname, cost, r in (
            ("flash_attention", kernel_cost("flash_attention", shape, name,
                                            route, **counts), route),
            ("flash_attention_bwd", kernel_cost("flash_attention_bwd", shape,
                                                name, bwd_route, **counts),
             bwd_route),
            ("verify_pairs_batch", kernel_cost("verify", (3, 64, 64, 32)),
             verify.launch_plan(64, 64, 32).route)):
        (work,) = cost["flops"].values()
        assert kernels[kname] == {"launches": 1,
                                  "flops": cost["plain_flops"],
                                  "work_flops": int(work),
                                  "bytes": int(cost["bytes"]),
                                  "routes": {r: 1}}
    assert kernels["flash_attention"]["work_flops"] < \
        kernels["flash_attention"]["flops"]
    # the same calls on the CPU count the same FLOPs through the plain
    # versions
    qc, kc, vc = (x.detach().cpu() for x in (q, k, v))
    qc.requires_grad_(True)
    with OpCost() as cpu:
        with torch.enable_grad():
            out = ops.gqa_attention(qc, kc, vc, causal=True)
            torch.autograd.grad(out.float().sum(), (qc,))
        ops.verify_pairs_batch(u.cpu(), w.cpu(), 1.0)
    assert oc.summary()["flops"] == cpu.summary()["flops"]
