"""The tensor-core attention backward's arithmetic (``csrc/
flash_backward_sm90.cu``, the ``tc`` route of ``bwd_launch_plan``), checked
on the CPU before the card: a plain PyTorch emulation of what the kernel
computes (bf16 products exact, summed in float32 a 16-deep k-step at a
time; P and dS split into two bf16 halves; each output rounded once to
bf16) held against the port's plain backward under the card's three
limits and against ``jax.vjp`` of the JAX package's attention, over every
mask kind and g 1, 2 and 10; a record of how far one bf16 P and dS would
land from those limits; and the route plan. The kernel itself is held
against its plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import gqa_scores_chunked  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# the card's three limits on a bf16 gradient (tests/test_torch_cuda.py):
# max |Δ| ≤ 2e-2·max|ref|; |Δ| ≤ 1e-3·max|ref| + 1e-2·|ref| element by
# element; ‖Δ‖ ≤ 1e-3·‖ref‖
BWD_TOL, BWD_ELEM_TOL, BWD_NORM_TOL = 2e-2, (1e-3, 1e-2), 1e-3
# the float32 limits of the same three (the card's float32 rows), which the
# split's float32 result must meet against JAX before it is rounded
F32_TOL, F32_ELEM_TOL, F32_NORM_TOL = 2e-4, (2e-5, 1e-4), 1e-5
LOG2E = 1.4426950408889634


def _rolling_positions(steps: int, written: int) -> np.ndarray:
    kpos = np.full(steps, -1, np.int32)
    for p in range(written):
        kpos[p % steps] = p
    return kpos


# name → (sq, t, causal, window, q_offset, kv_positions or None)
CASES = {
    "causal": (40, 40, True, 0, 0, None),
    "window": (48, 48, True, 9, 0, None),
    "noncausal": (33, 33, False, 0, 0, None),
    "cross": (21, 70, False, 0, 0, None),
    "offset": (17, 60, True, 0, 43, None),
    "rolling": (12, 32, True, 16, 50, _rolling_positions(32, 62)),
    "empty_slots": (9, 80, True, 0, 5, _rolling_positions(80, 14)),
    "no_visible_key": (6, 24, True, 0, 0,
                       np.array([-1, 7, 11] * 8, np.int32)),
}


def _inputs(case, g, hkv=2, d=64, b=2):
    """bf16 q, k, v, dO and the plain forward's bf16 output, from numpy."""
    sq, t, causal, window, q_offset, pos = CASES[case]
    rng = np.random.default_rng([sq, t, g, d])
    q, dout = (rng.normal(size=(b, sq, hkv * g, d)) for _ in range(2))
    k, v = (rng.normal(size=(b, t, hkv, d)) for _ in range(2))
    q, k, v, dout = (torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16) for x in (q, k, v, dout))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_positions=None if pos is None else torch.from_numpy(pos))
    out = ref.gqa_attention(q, k, v, **kw)
    return q, k, v, out, dout, kw


def _mm16(a, b, a_lo=None):
    """a (..., M, K) @ b (..., K, N) as the tensor cores take bf16
    operands: each 16-deep k-step's products are exact, their sum is
    rounded once to float32 and added to a float32 accumulator, k-steps in
    order. With ``a_lo`` (the lo half of a split operand) each k-step adds
    a's product, then a_lo's."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 16):
        bk = b[..., k0:k0 + 16, :].double()
        for x in (a, a_lo) if a_lo is not None else (a,):
            acc = acc + (x[..., k0:k0 + 16].double() @ bk).float()
    return acc


def _halves(x, split: bool):
    """hi = bf16(x) and lo = bf16(x − hi), as float32 (lo = 0 unsplit)."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return hi, (lo if split else torch.zeros_like(lo))


def _tc_bwd_emulation(q, k, v, out, dout, *, causal, window=0, q_offset=0,
                      kv_positions=None, split=True):
    """What ``flash_backward_sm90.cu`` computes, in plain PyTorch on the
    CPU: rows packed r = s·g + h % g; scores in base 2 (scale·log2 e in
    float32) with the −1e30 fill; each row's max m and sum l; δ = dO·O in
    float32; P = exp2(x − m)·(1/l); dS = P(dP − δ) where a key is seen;
    dV = Pᵀ dO, dK = scale·dSᵀ Q, dQ = scale·dS K with P and dS split into
    bf16 halves (``split``) or rounded to one bf16; a row that sees no key
    (P = 1/l on every key) adds its dV share in float32 instead. → the
    float32 (dq, dk, dv) before rounding."""
    b, sq, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g, rows = h // hkv, sq * (h // hkv)

    def pack(x):
        return x.float().reshape(b, sq, hkv, g, d).permute(
            0, 2, 1, 3, 4).reshape(b, hkv, rows, d)

    qp, dop, op = pack(q), pack(dout), pack(out)
    kp, vp = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    pos = torch.arange(t) if kv_positions is None else kv_positions
    mask = ref.gqa_mask(sq, pos, causal=causal, window=window,
                        q_offset=q_offset).repeat_interleave(g, dim=0)
    scale = d ** -0.5
    scale_log2 = float(np.float32(scale * LOG2E))
    x = torch.where(mask, _mm16(qp, kp.transpose(-1, -2)) * scale_log2,
                    torch.tensor(-1e30))
    m = x.amax(-1, keepdim=True)
    il = 1.0 / torch.exp2(x - m).sum(-1, keepdim=True).clamp_min(1e-30)
    delta = (dop * op).sum(-1, keepdim=True)
    p = torch.exp2(x - m) * il
    dp = _mm16(dop, vp.transpose(-1, -2))
    ds = torch.where(mask, p * (dp - delta), torch.tensor(0.0))
    none_seen = ~mask.any(-1, keepdim=True)
    ph, pl = _halves(torch.where(none_seen, 0.0, p), split)
    dh, dl = _halves(ds, split)
    dv = _mm16(ph.transpose(-1, -2), dop, pl.transpose(-1, -2)) + (
        torch.where(none_seen, p, 0.0).transpose(-1, -2) @ dop)
    dk = _mm16(dh.transpose(-1, -2), qp, dl.transpose(-1, -2)) * scale
    dq = _mm16(dh, kp, dl) * scale
    dq = dq.reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, d)
    return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _shares(got, want, tol, elem_tol, norm_tol):
    """Each limit's worst reading over the three gradients, as a share of
    the limit (≤ 1 holds)."""
    atol, rtol = elem_tol
    worst = [0.0, 0.0, 0.0]
    for x, w in zip(got, want):
        x, w = x.float(), w.float()
        diff, top = (x - w).abs(), w.abs().max().item()
        shares = (diff.max().item() / max(tol * top, 1e-30),
                  (diff / (atol * top + rtol * w.abs()).clamp_min(1e-30)
                   ).max().item(),
                  diff.norm().item() / max(w.norm().item(), 1e-30)
                  / norm_tol)
        worst = [max(a, s) for a, s in zip(worst, shares)]
    return worst


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("g", [1, 2, 10])
def test_tc_bwd_arithmetic_matches_plain(case, g):
    """The emulation, each gradient rounded once to bf16, against the
    plain backward in bf16 under the card's three limits; a row with no
    visible key gets the uniform P (dV = dO / T, dQ = 0)."""
    q, k, v, out, dout, kw = _inputs(case, g)
    got = [x.to(torch.bfloat16) for x in _tc_bwd_emulation(
        q, k, v, out, dout, **kw)]
    want = ref.gqa_attention_bwd(q, k, v, out, dout, **kw)
    for x, w in zip(got, want):
        assert x.shape == w.shape and torch.isfinite(x.float()).all()
    shares = _shares(got, want, BWD_TOL, BWD_ELEM_TOL, BWD_NORM_TOL)
    assert max(shares) <= 1.0, shares
    if case == "no_visible_key":
        assert got[0].float().abs().max().item() == 0.0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("g", [1, 2, 10])
def test_tc_bwd_arithmetic_matches_jax_vjp(case, g):
    """The emulation's float32 result (before rounding) against
    ``jax.vjp`` of the JAX package's attention region on the same bf16
    values in float32 (the emulation given JAX's float32 output for O),
    under the float32 limits: with P and dS split, the bf16 operands cost
    the gradients no more than float32 sums in another order; rounded to
    bf16 it meets the bf16 limits against JAX's gradients rounded once."""
    q, k, v, _, dout, kw = _inputs(case, g, hkv=1, d=64, b=1)
    pos = kw.pop("kv_positions")
    jpos = None if pos is None else jnp.asarray(pos.numpy())

    @jax.jit
    def vjp(a, b, c, do):
        out, back = jax.vjp(lambda a, b, c: gqa_scores_chunked(
            a, b, c, kv_positions=jpos, **kw), a, b, c)
        return out, back(do)

    out, want = vjp(*(jnp.asarray(x.float().numpy())
                      for x in (q, k, v, dout)))
    want = [torch.from_numpy(np.asarray(w)) for w in want]
    got = _tc_bwd_emulation(q, k, v, torch.from_numpy(np.asarray(out)),
                            dout, kv_positions=pos, **kw)
    shares = _shares(got, want, F32_TOL, F32_ELEM_TOL, F32_NORM_TOL)
    assert max(shares) <= 1.0, shares
    shares = _shares([x.to(torch.bfloat16) for x in got],
                     [w.to(torch.bfloat16) for w in want], BWD_TOL,
                     BWD_ELEM_TOL, BWD_NORM_TOL)
    assert max(shares) <= 1.0, shares


@pytest.mark.parametrize("product", [None, "dv", "dk", "dq"])
def test_one_bf16_p_and_ds_miss_the_limits(product):
    """Why P and dS are split: at (512, 512), g 2, D 128, causal (qwen3's
    widths, cut in length), the split arithmetic reads at most half of any
    limit, while one bf16 P and dS (``product`` None: in all three
    products; else the lo half dropped from that product alone) lands past
    the element-wise and norm limits (CPU readings: every lo half
    dropped, 2.15 and 2.64 of them; dV's alone, 2.57 of the norm limit;
    dK's, 2.60; dQ's, 2.64). So no product may drop its lo half."""
    rng = np.random.default_rng([512, 512, 2, 128])
    q, dout = (rng.normal(size=(1, 512, 2, 128)) for _ in range(2))
    k, v = (rng.normal(size=(1, 512, 1, 128)) for _ in range(2))
    q, k, v, dout = (torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16) for x in (q, k, v, dout))
    kw = dict(causal=True, window=0, q_offset=0)
    out = ref.gqa_attention(q, k, v, **kw)
    want = ref.gqa_attention_bwd(q, k, v, out, dout, **kw)
    split = _tc_bwd_emulation(q, k, v, out, dout, **kw)
    lone = _tc_bwd_emulation(q, k, v, out, dout, split=False, **kw)
    assert max(_shares([x.to(torch.bfloat16) for x in split], want, BWD_TOL,
                       BWD_ELEM_TOL, BWD_NORM_TOL)) <= 0.5
    if product is not None:   # (dq, dk, dv): lone only where named
        lone = [x if "d" + n == product else y
                for n, x, y in zip("qkv", lone, split)]
    single = _shares([x.to(torch.bfloat16) for x in lone], want, BWD_TOL,
                     BWD_ELEM_TOL, BWD_NORM_TOL)
    assert single[2] > 2.0, single   # past the norm limit, twice over


@pytest.mark.parametrize("shape,dtype,route,n_split", [
    ((4, 2048, 2048, 16, 8, 128), torch.bfloat16, "tc", 1),    # qwen3 train
    ((4, 2048, 2048, 16, 8, 128), torch.float32, "tc32", 1),
    ((1, 64, 64, 12, 12, 32), torch.float32, "simt", 1),       # D 32
    ((1, 512, 512, 10, 1, 256), torch.bfloat16, "tc", 17),     # recurrentgemma
    ((1, 512, 512, 16, 16, 128), torch.bfloat16, "tc", 2),     # olmoe
    ((1, 1500, 1500, 12, 12, 64), torch.bfloat16, "tc", 1),    # whisper enc
    ((1, 64, 1500, 12, 12, 64), torch.bfloat16, "tc", 1),      # whisper cross
    ((1, 64, 64, 12, 12, 64), torch.bfloat16, "tc", 1),        # one row tile
    ((1, 64, 64, 12, 12, 32), torch.bfloat16, "simt", 1),      # D not 64/128/256
    ((1, 64, 64, 12, 12, 96), torch.bfloat16, "simt", 1),
    ((1, 300, 300, 10, 1, 256), torch.bfloat16, "tc", 27),
    ((1, 4096, 64, 4, 1, 64), torch.bfloat16, "tc", 132),      # one key block
    ((1, 300, 300, 10, 1, 128), torch.bfloat16, "tc", 27),
    ((1, 1, 512, 8, 1, 128), torch.bfloat16, "tc", 1),         # one row
])
def test_bwd_launch_plan(shape, dtype, route, n_split):
    """The route by dtype and D (float32 at D 64/128/256 on tc32); the
    split count: 1 where the dK/dV grid (a block a 64-key tile) already
    has SM_COUNT blocks, else the fewest parts that reach it (at Hkv 1 and
    B 1 too), never more parts than 64-row tiles; the scratch shapes."""
    b, sq, t, h, hkv, d = shape
    plan = flash.bwd_launch_plan(b, sq, t, h, hkv, d, dtype)
    assert (plan.route, plan.n_split) == (route, n_split)
    rows = sq * (h // hkv)
    assert plan.stats_shape == (b, hkv, rows, 2)
    assert plan.delta_shape == (b, hkv, rows)
    assert plan.align == (8 if route == "tc" else 4)
    blocks = b * hkv * -(-t // flash.BWD_TILE)
    if n_split > 1:
        assert plan.part_shape == (n_split, b, t, hkv, d)
        assert blocks * n_split >= flash.SM_COUNT or \
            n_split == -(-rows // flash.BWD_TILE)
        assert blocks * (n_split - 1) < flash.SM_COUNT
    else:
        assert plan.part_shape == ()
    assert flash.bwd_launch_plan(b, sq, t, h, hkv, d, dtype) == plan


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 96)])
def test_tc_backward_refuses_what_it_cannot_take(dtype, d):
    """A plan forced onto the tc route raises before any launch for a dtype
    or head dim its kernel was not built for."""
    q = torch.zeros(1, 4, 2, d, dtype=dtype)
    k = torch.zeros(1, 4, 1, d, dtype=dtype)
    plan = flash.bwd_launch_plan(1, 4, 4, 2, 1, 128, torch.bfloat16)
    with pytest.raises(ValueError):
        flash.flash_attention_bwd(q, k, k, q, q, causal=True, window=0,
                                  q_offset=0, scale=1.0, kv_positions=None,
                                  plan=plan)
