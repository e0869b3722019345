"""The float32 tensor-core attention kernels' arithmetic (``csrc/
flash_prefill_sm90_f32.cu`` and ``csrc/flash_backward_sm90_f32.cu``, the
``tc32`` routes), checked on the CPU before the card: a plain PyTorch
emulation of what each computes (every float32 operand split into two TF32
halves, three products a k step, sums of at most 32 deep taken in fresh
partials that the tensor cores round toward zero, ``tests/tc_emulation.py``)
held against the port's plain versions and the JAX package's attention
(``gqa_scores_chunked``, its output and ``jax.vjp``) under the card's
float32 limits, over every mask kind, g 1 to 10 and D 64 to 256; a record
that one accumulator over a long walk misses a limit the partial sums
hold; and the route plans. The kernels themselves are held against their
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import gqa_scores_chunked  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from tc_emulation import tc3_matmul  # noqa: E402

# the forward's float32 limit, tests/test_kernels.py:60 (allclose: |Δ| ≤
# atol + rtol·|ref|), and the backward's three (tests/test_torch_cuda.py):
# max |Δ| ≤ 2e-4·max|ref|; |Δ| ≤ 2e-5·max|ref| + 1e-4·|ref| element by
# element; ‖Δ‖ ≤ 1e-5·‖ref‖
FLASH_TOL = dict(rtol=2e-4, atol=2e-4)
F32_TOL, F32_ELEM_TOL, F32_NORM_TOL = 2e-4, (2e-5, 1e-4), 1e-5
LOG2E = 1.4426950408889634
KEY_TILE = 32      # keys a tile of the forward (kBN)


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


def _inputs(case, g, d, hkv=2, b=2):
    """float32 q, k, v, dO from numpy, and the mask arguments."""
    sq, t, causal, window, q_offset, pos = CASES[case]
    rng = np.random.default_rng([sq, t, g, d])
    q, dout = (rng.normal(size=(b, sq, hkv * g, d)) for _ in range(2))
    k, v = (rng.normal(size=(b, t, hkv, d)) for _ in range(2))
    q, k, v, dout = (torch.from_numpy(x.astype(np.float32))
                     for x in (q, k, v, dout))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_positions=None if pos is None else torch.from_numpy(pos))
    return q, k, v, dout, kw


def _packed(q, k, kw):
    """Rows packed r = s·g + h % g: (pack, unpack, mask (rows, T), g)."""
    b, sq, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g, rows = h // hkv, sq * (h // hkv)

    def pack(x):
        return x.float().reshape(b, sq, hkv, g, d).permute(
            0, 2, 1, 3, 4).reshape(b, hkv, rows, d)

    def unpack(x):
        return x.reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4).reshape(
            b, sq, h, d)

    pos = torch.arange(t) if kw["kv_positions"] is None \
        else kw["kv_positions"]
    mask = ref.gqa_mask(sq, pos, causal=kw["causal"], window=kw["window"],
                        q_offset=kw["q_offset"]).repeat_interleave(g, dim=0)
    return pack, unpack, mask


def _scores(qp, kp, mask, d):
    """x = S·scale·log2 e with the −1e30 fill: S = Q Kᵀ in 32-deep
    chunks over D."""
    scale_log2 = float(np.float32(d ** -0.5 * LOG2E))
    s = tc3_matmul(qp, kp.transpose(-1, -2))
    return torch.where(mask, s * scale_log2, torch.tensor(-1e30))


def _tc32_forward(q, k, v, **kw):
    """What ``flash_prefill_sm90_f32.cu`` computes, in plain PyTorch: S in
    chunks over D; per key tile of 32, the online softmax in base 2 and
    Oᵀ = α·Oᵀ + Vᵀ Pᵀ (one fresh chunk, a fused multiply-add); o = Oᵀ /
    max(l, 1e-30)."""
    pack, unpack, mask = _packed(q, k, kw)
    qp = pack(q)
    kp, vp = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    x = _scores(qp, kp, mask, q.shape[-1])
    m = torch.full(x.shape[:-1], -1e30)
    l = torch.zeros(x.shape[:-1])
    ot = torch.zeros(vp.shape[:2] + (vp.shape[-1], x.shape[-2]))
    for c0 in range(0, x.shape[-1], KEY_TILE):
        xt = x[..., c0:c0 + KEY_TILE]
        mx = torch.maximum(m, xt.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(xt - mx[..., None])
        l = l * alpha + p.sum(-1)
        part = tc3_matmul(vp[..., c0:c0 + KEY_TILE, :].transpose(-1, -2),
                          p.transpose(-1, -2))
        ot = (alpha[..., None, :].double() * ot.double()
              + part.double()).float()
        m = mx
    o = ot / l.clamp_min(1e-30)[..., None, :]
    return unpack(o.transpose(-1, -2))


def _tc32_backward(q, k, v, out, dout, *, one_accumulator=False, **kw):
    """What ``flash_backward_sm90_f32.cu`` computes, in plain PyTorch: S
    and dP in chunks over D; each row's max m and sum l; δ = dO·O; P =
    exp2(x − m)·(1/l); dS = P(dP − δ) where a key is seen; dVᵀ = dOᵀ P and
    dKᵀ = scale·Qᵀ dS in chunks of the row walk's step (32 rows, 16 at D
    256), dQᵀ = scale·Kᵀ dSᵀ in chunks of its key tile (32 keys, 16 at D
    256); a row that sees no key adds its dV share (P = 1/l) in float32
    and takes no part in the products. ``one_accumulator``: dV, dK and dQ
    each in one accumulator over its whole walk instead. → (dq, dk, dv)."""
    pack, unpack, mask = _packed(q, k, kw)
    d = q.shape[-1]
    qp, dop, op = pack(q), pack(dout), pack(out)
    kp, vp = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    x = _scores(qp, kp, mask, d)
    m = x.amax(-1, keepdim=True)
    il = 1.0 / torch.exp2(x - m).sum(-1, keepdim=True).clamp_min(1e-30)
    delta = (dop * op).sum(-1, keepdim=True)
    p = torch.exp2(x - m) * il
    dp = tc3_matmul(dop, vp.transpose(-1, -2))
    ds = torch.where(mask, p * (dp - delta), torch.tensor(0.0))
    none_seen = ~mask.any(-1, keepdim=True)
    walk = 16 if d == 256 else 32
    rows_chunk = x.shape[-2] if one_accumulator else walk
    keys_chunk = x.shape[-1] if one_accumulator else walk
    scale = d ** -0.5
    dv = tc3_matmul(dop.transpose(-1, -2), torch.where(none_seen, 0.0, p),
                    rows_chunk) + dop.transpose(-1, -2) @ torch.where(
                        none_seen, p, 0.0)
    dk = tc3_matmul(qp.transpose(-1, -2), ds, rows_chunk) * scale
    dq = tc3_matmul(kp.transpose(-1, -2), ds.transpose(-1, -2),
                    keys_chunk) * scale
    return (unpack(dq.transpose(-1, -2)), dk.transpose(-1, -2).permute(
        0, 2, 1, 3), dv.transpose(-1, -2).permute(0, 2, 1, 3))


def _shares(got, want):
    """Each of the three backward limits' worst reading over the three
    gradients, as a share of the limit (≤ 1 holds)."""
    atol, rtol = F32_ELEM_TOL
    worst = [0.0, 0.0, 0.0]
    for x, w in zip(got, want):
        x, w = x.float(), w.float()
        diff, top = (x - w).abs(), w.abs().max().item()
        shares = (diff.max().item() / max(F32_TOL * top, 1e-30),
                  (diff / (atol * top + rtol * w.abs()).clamp_min(1e-30)
                   ).max().item(),
                  diff.norm().item() / max(w.norm().item(), 1e-30)
                  / F32_NORM_TOL)
        worst = [max(a, s) for a, s in zip(worst, shares)]
    return worst


def _jax_attention(q, k, v, dout, kw):
    """The JAX package's attention region and its ``jax.vjp`` on the same
    float32 values → (out, (dq, dk, dv)) as torch tensors."""
    kw = dict(kw)
    pos = kw.pop("kv_positions")
    jpos = None if pos is None else jnp.asarray(pos.numpy())

    @jax.jit
    def vjp(a, b, c, do):
        out, back = jax.vjp(lambda a, b, c: gqa_scores_chunked(
            a, b, c, kv_positions=jpos, **kw), a, b, c)
        return out, back(do)

    out, grads = vjp(*(jnp.asarray(x.numpy()) for x in (q, k, v, dout)))
    return (torch.from_numpy(np.array(out)),
            [torch.from_numpy(np.array(w)) for w in grads])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("g", [1, 2, 6, 10])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_tc32_forward_arithmetic_matches_plain(case, g, d):
    """The forward's emulation against the plain version within the float32
    limit (rtol = atol = 2e-4); rows that see no key are outside the
    forward's contract and are left out."""
    q, k, v, _, kw = _inputs(case, g, d)
    got = _tc32_forward(q, k, v, **kw)
    want = ref.gqa_attention(q, k, v, **kw)
    _, unpack, mask = _packed(q, k, kw)
    seen = unpack(mask.any(-1)[None, None, :, None].expand(
        q.shape[0], k.shape[2], -1, q.shape[-1]).float()) > 0
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got[seen].numpy(), want[seen].numpy(),
                               **FLASH_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("g", [1, 6])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_tc32_forward_arithmetic_matches_jax(case, g, d):
    """The forward's emulation against the JAX package's attention region
    on the same numpy inputs, within the float32 limit, where a row sees a
    key."""
    q, k, v, dout, kw = _inputs(case, g, d, hkv=1, b=1)
    want, _ = _jax_attention(q, k, v, dout, kw)
    got = _tc32_forward(q, k, v, **kw)
    _, unpack, mask = _packed(q, k, kw)
    seen = unpack(mask.any(-1)[None, None, :, None].expand(
        1, 1, -1, d).float()) > 0
    np.testing.assert_allclose(got[seen].numpy(), want[seen].numpy(),
                               **FLASH_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("g", [1, 2, 6, 10])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_tc32_bwd_arithmetic_matches_plain(case, g, d):
    """The backward's emulation against the plain backward under the three
    float32 limits; a row with no visible key gets the uniform P (dV =
    dO / T, dQ = 0)."""
    q, k, v, dout, kw = _inputs(case, g, d)
    out = ref.gqa_attention(q, k, v, **kw)
    got = _tc32_backward(q, k, v, out, dout, **kw)
    want = ref.gqa_attention_bwd(q, k, v, out, dout, **kw)
    for x, w in zip(got, want):
        assert x.shape == w.shape and torch.isfinite(x).all()
    shares = _shares(got, want)
    assert max(shares) <= 1.0, shares
    if case == "no_visible_key":
        assert got[0].abs().max().item() == 0.0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("g", [1, 6])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_tc32_bwd_arithmetic_matches_jax_vjp(case, g, d):
    """The backward's emulation (given JAX's output for O) against
    ``jax.vjp`` of the JAX package's attention region on the same float32
    values, under the three float32 limits."""
    q, k, v, dout, kw = _inputs(case, g, d, hkv=1, b=1)
    out, want = _jax_attention(q, k, v, dout, kw)
    got = _tc32_backward(q, k, v, out, dout, **kw)
    shares = _shares(got, want)
    assert max(shares) <= 1.0, shares


def test_one_accumulator_misses_a_limit():
    """Why dV, dK and dQ take a fresh partial a step of their walk: at
    (1, 1024, 1024), g 4, one KV head, D 128, causal (4,096 packed rows
    for dK and dV to walk), the chunked sums read 0.068 of the norm limit
    against the plain backward, while one accumulator over each whole
    walk, whose every step the tensor cores round toward zero, reads 1.95
    of it (dV; dK 1.85, dQ over 1,024 keys 0.13; CPU readings)."""
    rng = np.random.default_rng([1024, 4, 128])
    q, dout = (torch.from_numpy(rng.normal(size=(1, 1024, 4, 128)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(1, 1024, 1, 128)).astype(
        np.float32)) for _ in range(2))
    kw = dict(causal=True, window=0, q_offset=0, kv_positions=None)
    out = ref.gqa_attention(q, k, v, **kw)
    want = ref.gqa_attention_bwd(q, k, v, out, dout, **kw)
    chunked = _shares(_tc32_backward(q, k, v, out, dout, **kw), want)
    single = _shares(_tc32_backward(q, k, v, out, dout,
                                    one_accumulator=True, **kw), want)
    assert max(chunked) <= 0.5, chunked
    assert single[2] > 1.5, single   # past the norm limit


@pytest.mark.parametrize("shape,route", [
    ((4, 2048, 2048, 16, 8, 128), "tc32"),     # qwen3 float32
    ((8, 256, 256, 10, 5, 64), "tc32"),        # the 100M example
    ((1, 512, 512, 10, 1, 256), "tc32"),       # recurrentgemma
    ((1, 9, 9, 2, 1, 64), "tc32"),             # Sq·g 18 > 16
    ((1, 8, 8, 2, 1, 128), "split"),           # Sq·g 16: decode
    ((1, 1, 512, 8, 1, 128), "split"),
    ((1, 64, 64, 12, 12, 32), "simt"),         # smoke configs' D 32
    ((1, 64, 64, 12, 12, 96), "simt"),
])
def test_tc32_launch_plan(shape, route):
    """float32 prefill at D 64, 128 and 256 takes the tc32 kernel, 16-byte
    aligned strides (4 elements); decode splits KV; other head dims stay on
    the CUDA cores."""
    b, sq, t, h, hkv, d = shape
    plan = flash.launch_plan(b, sq, t, h, hkv, d, torch.float32)
    assert plan.route == route
    if route == "tc32":
        assert plan.align == 4
        assert flash.ROUTE_COUNTERS["tc32"] == "flash_prefill_tc32"


@pytest.mark.parametrize("shape,route,n_split", [
    ((4, 2048, 2048, 16, 8, 128), "tc32", 1),
    ((8, 256, 256, 10, 5, 64), "tc32", 1),
    ((1, 512, 512, 10, 1, 256), "tc32", 17),
    ((1, 300, 300, 10, 1, 128), "tc32", 27),
    ((1, 64, 64, 12, 12, 32), "simt", 1),
    ((1, 64, 64, 12, 12, 96), "simt", 1),
])
def test_tc32_bwd_launch_plan(shape, route, n_split):
    """The float32 backward at D 64, 128 and 256 takes tc32, its dK/dV row
    walk split as the bf16 route's is; other head dims take simt."""
    b, sq, t, h, hkv, d = shape
    plan = flash.bwd_launch_plan(b, sq, t, h, hkv, d, torch.float32)
    assert (plan.route, plan.n_split, plan.align) == (route, n_split, 4)
    bf16 = flash.bwd_launch_plan(b, sq, t, h, hkv, d, torch.bfloat16)
    assert (plan.n_split, plan.part_shape) == (bf16.n_split,
                                               bf16.part_shape)
    assert flash.BWD_ROUTE_COUNTERS["tc32"] == "flash_bwd_tc32"


@pytest.mark.parametrize("dtype,d,route", [(torch.bfloat16, 128, "tc32"),
                                           (torch.float32, 96, "tc32"),
                                           (torch.float32, 128, "tc")])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_tc32_refuses_what_it_cannot_take(dtype, d, route, direction):
    """A plan forced onto a tensor-core route raises before any launch for
    a dtype or head dim its kernel was not built for, forward and
    backward."""
    q = torch.zeros(1, 4, 2, d, dtype=dtype)
    k = torch.zeros(1, 4, 1, d, dtype=dtype)
    kw = dict(causal=True, window=0, q_offset=0, scale=1.0,
              kv_positions=None)
    with pytest.raises(ValueError):
        if direction == "forward":
            flash.flash_attention(q, k, k, plan=flash.LaunchPlan(route, 4),
                                  **kw)
        else:
            flash.flash_attention_bwd(
                q, k, k, q, q, plan=flash.BwdLaunchPlan(
                    route, 4, 1, (1, 1, 8, 2), (1, 1, 8)), **kw)
