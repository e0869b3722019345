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
