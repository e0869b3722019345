"""The port on the card: each CUDA kernel against its plain PyTorch version
at ragged shapes, and the slice's host and device modes through the
kernels. Every test here needs a CUDA device and skips without one; run
them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of the JAX package, so it runs where only
PyTorch is installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DiskJoinIndex, JoinConfig, recall  # noqa: E402
from repro_torch.data import (brute_force_pairs,  # noqa: E402
                              clustered_vectors, epsilon_for_avg_neighbors)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402

pytestmark = pytest.mark.cuda
D2_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py's d² tolerance


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
    d2r, mr = ref.pairwise_l2_threshold(u, v, ops.eps2_f32(eps))
    np.testing.assert_allclose(d2k.cpu().numpy(), d2r.cpu().numpy(),
                               **D2_TOL)
    _check_mask(mk, mr, d2r, eps)
    # the E = 1 launch gives the batched lane's bytes
    d2one, _ = ops.pairwise_l2_threshold(u[-1], v[-1], eps)
    assert torch.equal(d2one, d2k[-1])


@pytest.mark.parametrize("m,b,d", [(128, 128, 64), (100, 37, 96),
                                   (256, 130, 128), (5, 3, 16),
                                   (8192, 1000, 128)])
def test_assign_kernel_matches_plain(cuda, m, b, d):
    g = torch.Generator(device=cuda).manual_seed(m + b)
    x = torch.randn(m, d, device=cuda, generator=g)
    c = torch.randn(b, d, device=cuda, generator=g)
    dk, ik = ops.bucket_assign(x, c)
    dr, ir = ref.bucket_assign(x, c)
    assert torch.equal(ik, ir)
    np.testing.assert_allclose(dk.cpu().numpy(), dr.cpu().numpy(), **D2_TOL)
    # ties (duplicated centers) go to the lowest index
    _, it = ops.bucket_assign(c[:7], torch.cat([c, c]))
    assert it.tolist() == list(range(min(7, b)))


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
    assert all(v > 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
    assert np.array_equal(h.pairs, d.pairs)
    assert np.array_equal(h.distances, d.distances)
    assert recall(d.pairs, brute_force_pairs(x, eps)) >= 0.9
    for qi, ((a, _), (b, _)) in enumerate(zip(qh, qd)):
        assert qi in set(a.tolist())
        for v in set(a.tolist()) ^ set(b.tolist()):
            d2 = ((x[v].astype(np.float64) - x[qi]) ** 2).sum()
            assert abs(d2 - eps * eps) <= 1e-4
