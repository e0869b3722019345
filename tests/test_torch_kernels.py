"""The port's kernel wrappers (``repro_torch.kernels.ops``) against the JAX
package's: Pallas in interpret mode (``use_pallas=True``) and the jnp
reference, on the same numpy inputs, with ``tests/test_kernels.py``'s
shapes, dtypes and tolerances. On the CPU the port runs the kernels' plain
versions; the CUDA kernels themselves are held against those on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

D2_TOL = dict(rtol=1e-4, atol=1e-3)  # test_kernels.py's d² tolerance


def _rng(*key):
    return np.random.default_rng(list(key))


def _check_mask(mask, mask_ref, d2_ref, eps):
    # threshold disagreement only possible within float tolerance of eps²
    dis = np.asarray(mask) != np.asarray(mask_ref)
    if dis.any():
        assert np.abs(np.asarray(d2_ref)[dis] - eps * eps).max() < 1e-2


@pytest.mark.parametrize("m,n,d", [(128, 128, 128), (256, 128, 128),
                                   (200, 150, 96), (64, 300, 33),
                                   (1, 1, 8), (130, 2, 130)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_pairwise_l2_matches_jax(m, n, d, dtype):
    rng = _rng(m, n, d, np.dtype(dtype).itemsize)
    a = rng.normal(size=(m, d)).astype(dtype)
    b = rng.normal(size=(n, d)).astype(dtype)
    eps = 1.5
    d2t, mt = tops.pairwise_l2_threshold(torch.from_numpy(a),
                                         torch.from_numpy(b), eps)
    assert d2t.dtype == torch.float32 and mt.dtype == torch.bool
    assert tuple(d2t.shape) == (m, n)
    for use_pallas in (False, True):
        d2j, mj = jops.pairwise_l2_threshold(a, b, eps,
                                             use_pallas=use_pallas)
        np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), **D2_TOL)
        _check_mask(mt.numpy(), mj, d2j, eps)


@pytest.mark.parametrize("e,m,d", [(2, 128, 128), (3, 200, 96),
                                   (1, 64, 33), (4, 130, 16)])
def test_verify_pairs_batch_matches_jax(e, m, d):
    rng = _rng(e, m, d)
    u = rng.normal(size=(e, m, d)).astype(np.float32)
    v = rng.normal(size=(e, m, d)).astype(np.float32)
    eps = float(np.sqrt(2.0 * d))  # about half of the pairs pass
    d2t, mt = tops.verify_pairs_batch(torch.from_numpy(u),
                                      torch.from_numpy(v), eps)
    assert tuple(d2t.shape) == (e, m, m) and mt.dtype == torch.bool
    for use_pallas in (False, True):
        d2j, mj = jops.verify_pairs_batch(u, v, eps, use_pallas=use_pallas)
        np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), **D2_TOL)
        _check_mask(mt.numpy(), mj, d2j, eps)


@pytest.mark.parametrize("m,b,d", [(128, 128, 64), (100, 37, 96),
                                   (256, 130, 128), (5, 3, 16)])
def test_bucket_assign_matches_jax(m, b, d):
    rng = _rng(m, b, d)
    x = rng.normal(size=(m, d)).astype(np.float32)
    c = rng.normal(size=(b, d)).astype(np.float32)
    dt, it = tops.bucket_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert it.dtype == torch.int32 and dt.dtype == torch.float32
    for use_pallas in (False, True):
        dj, ij = jops.bucket_assign(x, c, use_pallas=use_pallas)
        assert np.array_equal(it.numpy(), np.asarray(ij))  # argmin exact
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **D2_TOL)


def test_bucket_assign_ties_go_to_lowest_index():
    c = _rng(7).normal(size=(5, 8)).astype(np.float32)
    centers = np.concatenate([c, c, c])          # every center three times
    _, idx = tops.bucket_assign(torch.from_numpy(c), torch.from_numpy(centers))
    assert idx.tolist() == [0, 1, 2, 3, 4]


def test_cpu_calls_never_count_launches():
    tops.reset_launches()
    x = torch.from_numpy(_rng(1).normal(size=(9, 8)).astype(np.float32))
    tops.pairwise_l2_threshold(x, x, 1.0)
    tops.verify_pairs_batch(x[None], x[None], 1.0)
    tops.bucket_assign(x, x[:3])
    assert all(v == 0 for v in tops.LAUNCHES.values())


def test_eps2_is_f32_rounding_of_f64_product():
    # for this ε, rounding ε to float32 before squaring gives another ε²:
    # the kernels must use the JAX programs' rounding (f64 product, once)
    eps = 1.3102272059107631
    f32_square = np.float32(np.float32(eps) * np.float32(eps))
    assert tops.eps2_f32(eps) == float(np.float32(eps * eps))
    assert tops.eps2_f32(eps) != float(f32_square)


def test_extract_pairs_matches_jax():
    rng = _rng(11)
    d2 = rng.random((6, 5)).astype(np.float32)
    mask = d2 <= 0.4
    ids_a, ids_b = np.arange(10, 16), np.arange(20, 25)
    for upper in (False, True):
        pt, dt = tops.extract_pairs(d2, mask, ids_a, ids_b,
                                    upper_triangle=upper)
        pj, dj = jops.extract_pairs(d2, mask, ids_a, ids_b,
                                    upper_triangle=upper)
        assert np.array_equal(pt, pj) and np.array_equal(dt, dj)


@pytest.mark.parametrize("call,args,exc", [
    ("pairwise_l2_threshold", ((4, 8), (3, 7)), ValueError),   # widths
    ("pairwise_l2_threshold", ((4, 8, 1), (3, 8)), ValueError),  # rank
    ("verify_pairs_batch", ((2, 4, 8), (3, 4, 8)), ValueError),  # lanes
    ("bucket_assign", ((4, 8), (0, 8)), ValueError),           # no centers
])
def test_wrappers_reject_bad_shapes(call, args, exc):
    ts = [torch.zeros(s) for s in args]
    with pytest.raises(exc):
        getattr(tops, call)(*ts, *((1.0,) if call != "bucket_assign" else ()))


def test_wrappers_reject_non_tensors_and_int_dtypes():
    with pytest.raises(TypeError):
        tops.bucket_assign(np.zeros((2, 4), np.float32), torch.zeros(2, 4))
    with pytest.raises(TypeError):
        tops.pairwise_l2_threshold(torch.zeros(2, 4, dtype=torch.int32),
                                   torch.zeros(2, 4), 1.0)


def test_build_targets_sm90a_without_fast_math():
    flags = _build.ARCH_FLAGS + _build.COMPILE_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)


def test_ref_matches_f64_numpy():
    rng = _rng(3)
    a = rng.normal(size=(33, 20)).astype(np.float32)
    b = rng.normal(size=(17, 20)).astype(np.float32)
    d2 = ref.pairwise_l2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    exact = ((a[:, None, :].astype(np.float64) - b[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d2, exact, **D2_TOL)
