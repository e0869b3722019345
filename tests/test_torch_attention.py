"""The port's attention entry points against the JAX package's, on the
same numpy inputs, on the CPU (where the port runs the flash kernel's
plain versions; the CUDA kernel itself is held against those on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``):

* ``ops.flash_attention`` against JAX ``ops.flash_attention(use_pallas=
  True)`` (the Pallas kernel in interpret mode, and its offset-causal
  route to ``ref``) at ``tests/test_kernels.py``'s shapes and tolerance;
* ``ref.attention`` against JAX ``ref.attention``, causal S ≠ T included;
* ``ops.gqa_attention`` against JAX ``gqa_scores_chunked`` — the region
  the model runs — over GQA ratios, query lengths, windows, query offsets
  and rolling cache positions with empty (−1) slots.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.layers import gqa_scores_chunked  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

FLASH_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_kernels.py:60
REF_TOL = dict(rtol=1e-5, atol=1e-5)    # float32, same math, other order


def _rng(*key):
    return np.random.default_rng(list(key))


@pytest.mark.parametrize("b,h,sq,skv,hd", [
    (1, 2, 128, 128, 64), (2, 4, 256, 256, 64),
    (1, 1, 128, 384, 32), (2, 2, 384, 128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_pallas(b, h, sq, skv, hd, causal):
    rng = _rng(b, h, sq, skv, hd)
    q, k, v = (rng.normal(size=(b, h, n, hd)).astype(np.float32)
               for n in (sq, skv, skv))
    out = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               use_pallas=True)
    assert out.shape == (b, h, sq, hd) and out.dtype == torch.float32
    want = jops.flash_attention(q, k, v, causal=causal, use_pallas=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FLASH_TOL)
    assert tops.LAUNCHES["flash_attention"] == 0  # CPU calls never count


@pytest.mark.parametrize("sq,skv", [(16, 16), (5, 23), (1, 40), (24, 8)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_ref_attention_matches_jax(sq, skv, causal, dtype):
    rng = _rng(sq, skv, int(causal))
    q, k, v = (rng.normal(size=(2, 3, n, 32)).astype(np.float32)
               for n in (sq, skv, skv))
    scale = 0.3
    want = jref.attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                          causal=causal, scale=scale)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = tref.attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                         causal=causal, scale=scale)
    assert got.dtype == tdt
    tol = REF_TOL if dtype == np.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _rolling_positions(steps: int, written: int) -> np.ndarray:
    """kpos of a rolling cache of ``steps`` slots after positions
    0..written-1 were written at p % steps (−1: slot never written)."""
    kpos = np.full(steps, -1, np.int32)
    for p in range(written):
        kpos[p % steps] = p
    return kpos


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("sq", [1, 17, 128])
@pytest.mark.parametrize("layout,window", [
    ("self", 0), ("full", 0), ("offset", 32), ("rolling", 32),
    ("unfilled", 0)])
def test_gqa_attention_matches_gqa_scores_chunked(g, sq, layout, window):
    hkv, d = 2, 32
    kw = dict(causal=layout != "full", window=window)
    if layout in ("self", "full"):
        t = sq
    elif layout == "offset":           # chunked prefill against a prefix
        t = sq + 24
        kw["q_offset"] = 24
    elif layout == "rolling":          # a cache that has wrapped around
        t = 48 if sq <= 48 else 160
        kw["q_offset"] = t + 9
        kw["kv_positions"] = _rolling_positions(t, t + 9 + sq)
    else:                              # a cache with empty slots
        t = 200
        kw["q_offset"] = 5
        kw["kv_positions"] = _rolling_positions(t, 5 + sq)
    rng = _rng(g, sq, window, len(layout))
    q = rng.normal(size=(2, sq, hkv * g, d)).astype(np.float32)
    k = rng.normal(size=(2, t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(2, t, hkv, d)).astype(np.float32)
    jkw = dict(kw)
    tkw = dict(kw)
    if "kv_positions" in kw:
        jkw["kv_positions"] = jnp.asarray(kw["kv_positions"])
        tkw["kv_positions"] = torch.from_numpy(kw["kv_positions"])
    pos = jkw.pop("kv_positions", None)
    want = jax.jit(lambda q, k, v, pos: gqa_scores_chunked(
        q, k, v, kv_positions=pos, **jkw))(q, k, v, pos)
    got = tops.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **tkw)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF_TOL)


def test_gqa_attention_rejects_mismatched_heads():
    q = torch.zeros(1, 4, 6, 32)
    k = torch.zeros(1, 4, 4, 32)  # 6 query heads over 4 KV heads
    with pytest.raises(ValueError):
        tops.gqa_attention(q, k, k, causal=True)
    with pytest.raises(ValueError):
        tops.gqa_attention(q, k[:, :, :3], k[:, :, :3], causal=True,
                           kv_positions=torch.zeros(5, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the CUDA route plan and the tensor-core route's arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,dtype,route,n_splits", [
    ((4, 1, 512, 16, 8, 128), torch.bfloat16, "split", 8),   # qwen3 decode
    ((4, 1, 512, 16, 8, 128), torch.float32, "split", 8),
    ((4, 2048, 2048, 16, 8, 128), torch.bfloat16, "tc", 0),  # qwen3 prefill
    ((4, 2048, 2048, 16, 8, 128), torch.float32, "tc32", 0),
    ((1, 16, 100, 4, 4, 64), torch.bfloat16, "split", 2),    # Sq·g = 16
    ((1, 17, 100, 4, 4, 64), torch.bfloat16, "tc", 0),       # Sq·g = 17
    ((1, 17, 100, 4, 4, 64), torch.float32, "tc32", 0),
    ((1, 8, 100, 4, 2, 128), torch.bfloat16, "split", 2),
    ((1, 9, 100, 4, 2, 128), torch.bfloat16, "tc", 0),
    ((2, 40, 64, 12, 2, 256), torch.bfloat16, "tc", 0),      # g = 6
    ((2, 40, 64, 12, 2, 32), torch.bfloat16, "simt", 0),     # D not 64/128/256
    ((2, 40, 64, 12, 2, 32), torch.float32, "simt", 0),
    ((2, 1, 64, 8, 1, 128), torch.bfloat16, "split", 1),
    ((2, 1, 65, 8, 1, 128), torch.bfloat16, "split", 2),
    ((2, 2, 4096, 16, 2, 96), torch.float32, "split", 64),
])
def test_launch_plan(shape, dtype, route, n_splits):
    b, sq, t, h, hkv, d = shape
    plan = tflash.launch_plan(b, sq, t, h, hkv, d, dtype)
    assert plan.route == route
    assert plan.n_splits == n_splits
    if route == "split":
        rows = sq * (h // hkv)
        assert plan.ml_shape == (b, hkv, n_splits, rows, 2)
        assert plan.acc_shape == (b, hkv, n_splits, rows, d)
        assert (n_splits - 1) * tflash.SPLIT_KEYS < t \
            <= n_splits * tflash.SPLIT_KEYS
        assert plan.align * dtype.itemsize == 16   # 16-byte loads
    else:
        assert plan.ml_shape == plan.acc_shape == ()
        assert plan.align == (8 if route == "tc" else 4)
    assert tflash.launch_plan(b, sq, t, h, hkv, d, dtype) == plan


def _tc_prefill_emulation(q, k, v, *, bn: int = 64):
    """The tensor-core prefill route's arithmetic, causal from position 0,
    in plain PyTorch: rows r = s·g + h % g, 64-key tiles, scores from bf16
    operands summed in float32, an online softmax in base 2, P split into
    P_hi = bf16(P) and P_lo = bf16(P − P_hi), each multiplied by bf16 V
    with float32 sums, l from the float32 P; → float32 (B, S, H, D)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    rows = s * g
    qg = q.reshape(b, s, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, rows, d)
    kk, vv = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    qpos = torch.arange(rows) // g
    m = torch.full((b, hkv, rows), -1e30)
    l = torch.zeros((b, hkv, rows))
    o = torch.zeros((b, hkv, rows, d))
    scale_log2 = d ** -0.5 * 1.4426950408889634
    for c0 in range(0, t, bn):
        cols = torch.arange(c0, min(c0 + bn, t))
        sc = (qg @ kk[:, :, cols].transpose(-1, -2)) * scale_log2
        sc = torch.where(qpos[:, None] >= cols[None, :], sc, -1e30)
        mx = torch.maximum(m, sc.amax(-1))
        corr = torch.exp2(m - mx)
        p = torch.exp2(sc - mx[..., None])
        l = l * corr + p.sum(-1)
        m = mx
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        o = o * corr[..., None] + hi @ vv[:, :, cols] + lo @ vv[:, :, cols]
    o = o / l.clamp_min(1e-30)[..., None]
    return o.reshape(b, hkv, s, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, s, h, d)


def test_tc_prefill_arithmetic_matches_gqa_scores_chunked():
    """The precision design of flash_prefill_sm90.cu, checked on the CPU
    before the card: at D 128, g 2, causal S 256, its arithmetic on bf16
    inputs stays within the float32 limit (2e-4 · (1 + |want|)) of JAX's
    float32 ``gqa_scores_chunked`` before the output is rounded, and
    within the bf16 limit (4e-3 · (1 + |want|)) after."""
    rng = _rng(13, 256)
    b, s, hkv, g, d = 2, 256, 2, 2, 128
    q, k, v = (torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               .to(torch.bfloat16).float()
               for shp in ((b, s, hkv * g, d), (b, s, hkv, d),
                           (b, s, hkv, d)))
    want = np.asarray(jax.jit(lambda q, k, v: gqa_scores_chunked(
        q, k, v, causal=True))(q.numpy(), k.numpy(), v.numpy()))
    got = _tc_prefill_emulation(q, k, v)
    limit = 1.0 + np.abs(want)
    assert (np.abs(got.numpy() - want) <= 2e-4 * limit).all()
    got16 = got.to(torch.bfloat16).float().numpy()
    assert (np.abs(got16 - want) <= 4e-3 * limit).all()
