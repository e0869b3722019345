"""Gradients of the port against the JAX package's, on the CPU: the
chunked cross-entropy, the plain attention backward (the backward kernel's
plain version, ``ref.gqa_attention_bwd``) against ``jax.vjp`` of
``gqa_scores_chunked`` and against torch autograd of ``ref.gqa_attention``,
and remat on and off (the other mixers' gradients:
tests/test_torch_grad_mixers.py). Inputs are made with numpy from a seed
and handed to both packages; everything runs in float32. The
backward kernel itself is held against its plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model_api as jmodel_api  # noqa: E402
from repro.models.layers import gqa_scores_chunked  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import (build_model, model_api,  # noqa: E402
                                transformer)

# float32 against float32: sums in another order
TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk", [(13, 4), (12, 4), (9, 2048), (1, 3)])
def test_chunked_xent_value_and_grads_match(s, chunk):
    """Ragged S (padding with label −1 to a multiple of ``chunk``), labels
    −1 inside, chunk above S; the mean over valid labels and its gradients
    with respect to the hidden states and the table."""
    rng = np.random.default_rng(s * 10 + chunk)
    h = rng.normal(size=(2, s, 16)).astype(np.float32)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    labels = rng.integers(0, 40, (2, s)).astype(np.int32)
    labels[0, ::3] = -1
    want, (gh, gt) = jax.value_and_grad(
        lambda a, b: jmodel_api.chunked_xent(a, b, jnp.asarray(labels),
                                             chunk), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(table))
    th, tt = _t(h).requires_grad_(), _t(table).requires_grad_()
    got = model_api.chunked_xent(th, tt, _t(labels).long(), chunk)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), **TOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), **TOL)


def test_chunked_xent_all_labels_invalid_is_zero():
    h = torch.ones(1, 5, 8, requires_grad=True)
    loss = model_api.chunked_xent(h, torch.ones(7, 8),
                                  torch.full((1, 5), -1), 2)
    loss.backward()
    assert loss.item() == 0.0 and h.grad.abs().max().item() == 0.0


# ---------------------------------------------------------------------------
# attention backward: the plain version against jax.vjp and torch autograd
# ---------------------------------------------------------------------------
def _rolling_positions(steps: int, written: int) -> np.ndarray:
    kpos = np.full(steps, -1, np.int32)
    for p in range(written):
        kpos[p % steps] = p
    return kpos


# name → (sq, t, causal, window, q_offset, kv_positions or None)
BWD_CASES = {
    "causal": (19, 19, True, 0, 0, None),
    "window": (24, 24, True, 5, 0, None),
    "noncausal": (13, 13, False, 0, 0, None),
    "cross": (7, 30, False, 0, 0, None),
    "offset": (9, 25, True, 0, 16, None),
    "rolling": (6, 16, True, 8, 30, _rolling_positions(16, 36)),
    "empty_slots": (5, 40, True, 0, 3, _rolling_positions(40, 8)),
    "no_visible_key": (4, 12, True, 0, 0,
                       np.array([-1, 5, 9] * 4, np.int32)),
}


def _bwd_inputs(case, g, hkv=2, d=16):
    sq, t, causal, window, q_offset, pos = BWD_CASES[case]
    rng = np.random.default_rng(sq * 100 + t + g)
    q = rng.normal(size=(2, sq, hkv * g, d)).astype(np.float32)
    k = rng.normal(size=(2, t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(2, t, hkv, d)).astype(np.float32)
    dout = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    return q, k, v, dout, kw, pos


@pytest.mark.parametrize("case", sorted(BWD_CASES))
@pytest.mark.parametrize("g", [1, 2, 10])
def test_gqa_attention_bwd_matches_jax_vjp(case, g):
    """dq, dk, dv of the plain backward against ``jax.vjp`` of the
    reference's attention region, for every mask kind and g ∈ {1, 2, 10}
    (a row with no visible key: the reference's uniform softmax)."""
    q, k, v, dout, kw, pos = _bwd_inputs(case, g)
    jpos = None if pos is None else jnp.asarray(pos)

    @jax.jit
    def fwd_bwd(a, b, c, do):
        out, vjp = jax.vjp(lambda a, b, c: gqa_scores_chunked(
            a, b, c, kv_positions=jpos, **kw), a, b, c)
        return out, vjp(do)

    out, want = fwd_bwd(*map(jnp.asarray, (q, k, v, dout)))
    got = ref.gqa_attention_bwd(
        _t(q), _t(k), _t(v), _t(np.asarray(out)), _t(dout),
        kv_positions=None if pos is None else _t(pos), **kw)
    for x, w in zip(got, want):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
@pytest.mark.parametrize("g", [1, 10])
def test_gqa_attention_bwd_matches_torch_autograd(case, g):
    """The explicit formulas against torch autograd of the plain forward;
    and ``ops.gqa_attention`` under autograd on the CPU runs exactly the
    plain backward (its autograd Function), counting no launch."""
    q, k, v, dout, kw, pos = _bwd_inputs(case, g)
    kw["kv_positions"] = None if pos is None else _t(pos)
    qkv = [_t(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.gqa_attention(*qkv, **kw), qkv,
                               _t(dout))
    out = ref.gqa_attention(*(x.detach() for x in qkv), **kw)
    got = ref.gqa_attention_bwd(*(x.detach() for x in qkv), out, _t(dout),
                                **kw)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), w.numpy(), **TOL)
    ops.reset_launches()
    through = torch.autograd.grad(ops.gqa_attention(*qkv, **kw), qkv,
                                  _t(dout))
    for x, w in zip(through, got):
        assert torch.equal(x, w)
    assert ops.launches_snapshot()["flash_attention_bwd"] == 0


def test_gqa_attention_bwd_bf16_rounds_once():
    """bf16 operands: the float32 arithmetic of the float32 path on the
    bf16 values, each gradient rounded once to bf16."""
    q, k, v, dout, kw, _ = _bwd_inputs("causal", 2)
    bf = [_t(x).to(torch.bfloat16) for x in (q, k, v, dout)]
    out = ref.gqa_attention(*bf[:3], **kw)
    got = ref.gqa_attention_bwd(*bf[:3], out, bf[3], **kw)
    want = ref.gqa_attention_bwd(*(x.float() for x in bf[:3]), out.float(),
                                 bf[3].float(), **kw)
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, w.to(torch.bfloat16))


def test_inference_mode_saves_nothing():
    """Serving (no grad) calls the forward directly: the output has no
    graph and equals the autograd path's."""
    q, k, v, _, kw, _ = _bwd_inputs("causal", 2)
    qkv = [_t(x).requires_grad_() for x in (q, k, v)]
    trained = ops.gqa_attention(*qkv, **kw)
    assert trained.grad_fn is not None
    with torch.inference_mode():
        served = ops.gqa_attention(*qkv, **kw)
    assert served.grad_fn is None and torch.equal(served, trained.detach())


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b",
                                  "recurrentgemma-2b"])
def test_remat_on_and_off_give_equal_gradients(arch):
    """Per-block recomputation in backward changes no value: the loss and
    every gradient are the same bits with remat on and off."""
    cfg = smoke_config(get_config(arch))
    model = build_model(cfg, device="cpu").init(3).requires_grad_(True)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 24)))
    out = {}
    for remat in (True, False):
        hidden, aux = transformer.forward(model, tok, remat=remat)
        loss = model_api.chunked_xent(hidden[:, :-1], model.embed,
                                      tok[:, 1:]) + aux
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        out[remat] = (loss.detach(), grads)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert (a is None and b is None) or torch.equal(a, b)
