"""Gradients of the port's other mixers against the JAX package's, on the
CPU: the numerical risks of training them (SSD's overflowing exponents,
MoE's accumulating scatter into the expert slabs and its sorted routing,
RG-LRU's sqrt(1 − a²) near a → 1), each against ``jax.grad``. Inputs are
made with numpy from a seed and handed to both packages; float32."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import moe, rglru, ssm  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_close(got, want, rel):
    """‖got − want‖ ≤ rel · ‖want‖, and got finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= rel * max(np.linalg.norm(want),
                                                   1e-30)


def _jax_recurrence(x, a, B, C):
    """The SSM the chunked scan computes, as the plain recurrence h_t =
    a_t h_{t−1} + x_t B_tᵀ, y_t = h_t C_t (decays clamped to 1e-20, as
    the chunked scan clamps them before the log): its gradient forms no
    overflowing exponent."""
    a = jnp.maximum(a, 1e-20)

    def step(h, xs):
        xt, at, bt, ct = xs
        h = h * at[..., None, None] + xt[..., None] * bt[..., None, :]
        return h, jnp.einsum("bhpn,bhn->bhp", h, ct)

    b, _, h, p = x.shape
    h0 = jnp.zeros((b, h, p, B.shape[-1]), jnp.float32)
    _, ys = jax.lax.scan(step, h0, tuple(jnp.moveaxis(t, 1, 0)
                                         for t in (x, a, B, C)))
    return jnp.moveaxis(ys, 0, 1)


@pytest.mark.parametrize("decay", ["mild", "strong"])
def test_ssd_grads_match_and_stay_finite(decay):
    """Gradients of the chunked SSD scan (chunk 8, S = 16) with respect to
    x, the decays, B and C against ``jax.grad`` of the plain recurrence
    (and, with mild decays, of the reference's ``_ssd_chunked``). "strong"
    decays of 1e-25 make the masked upper triangle's exponents overflow:
    the port sets them to −inf before the exp and its gradients stay
    finite; the reference masks after the exp, and its gradient is NaN
    there (a property of the reference, ROADMAP §3)."""
    rng = np.random.default_rng(25)
    b, s, h, p, n = 2, 16, 3, 4, 5
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    B = rng.normal(size=(b, s, h, n)).astype(np.float32)
    C = rng.normal(size=(b, s, h, n)).astype(np.float32)
    a = np.exp(-np.log1p(np.exp(rng.normal(size=(b, s, h))))
               ).astype(np.float32)
    if decay == "strong":
        a[:, ::3] = 1e-25
    w = rng.normal(size=(b, s, h, p)).astype(np.float32)
    ins = [_t(t).requires_grad_() for t in (x, a, B, C)]
    (ssm.ssd_chunked(*ins, 8) * _t(w)).sum().backward()
    jins = tuple(map(jnp.asarray, (x, a, B, C)))
    want = jax.jit(jax.grad(lambda *t: jnp.sum(_jax_recurrence(*t) * w),
                            argnums=(0, 1, 2, 3)))(*jins)
    chunked = jax.jit(jax.grad(
        lambda *t: jnp.sum(jssm._ssd_chunked(*t, 8) * w),
        argnums=(0, 1, 2, 3)))(*jins)
    for t, wj, cj in zip(ins, want, chunked):
        _assert_close(t.grad.numpy(), wj, 1e-4)
        if decay == "mild":
            _assert_close(t.grad.numpy(), cj, 1e-4)
    if decay == "strong":
        assert not np.isfinite(np.asarray(chunked[1])).all()


def _moe_pair(arch, seed, capacity_factor):
    jcfg = jsmoke_config(jget_config(arch))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = smoke_config(get_config(arch))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    jp = jax.tree_util.tree_map(
        np.array, jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    port = moe.MoE(torch.Generator().manual_seed(0), cfg, "cpu")
    with torch.no_grad():
        for name, prm in port.named_parameters():
            leaf = jp["moe"]
            for part in name.split("."):
                leaf = leaf[part]
            prm.copy_(_t(leaf))
    return jcfg, jp, port.requires_grad_(True)


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
@pytest.mark.parametrize("capacity_factor", [0.25, 1.25])
def test_moe_grads_match_with_drops(arch, capacity_factor):
    """The MoE block's gradients (tokens, router, experts, shared experts)
    through the accumulating scatter into the expert slabs, the gather
    back and the stable-sort routing, with capacity overflow (0.25) and
    without: against ``jax.grad`` of ``moe_ffn`` (output and aux loss)."""
    jcfg, jp, port = _moe_pair(arch, 6, capacity_factor)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        y, aux = jmoe.moe_ffn(params, jcfg, xx)
        return jnp.sum(y * w) + 10.0 * aux

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    y, aux = port(tx)
    (torch.sum(y * _t(w)) + 10.0 * aux).backward()
    _assert_close(tx.grad.numpy(), gx, 1e-5)
    for name, prm in port.named_parameters():
        _assert_close(prm.grad.numpy(), _leaf(gp["moe"], name), 1e-5)


def test_rglru_grads_near_a_equal_one():
    """The RG-LRU block's gradients against ``jax.grad`` of
    ``rglru_block``, with half the channels' Λ in [−30, −25], where a
    rounds to 1 in float32 (1 − a² is clamped to 1e-12: beta = 1e-6 and no
    gradient through the clamp), and half in [−6, −3] (1 − a² ≈ 0.01 to
    0.1). Between the two (a within a few float32 ulps of 1) the gradient
    of sqrt(1 − a²) is set by the rounding of a itself, in either package,
    and no tolerance holds the two to each other there."""
    jcfg = jsmoke_config(jget_config("recurrentgemma-2b"))
    cfg = smoke_config(get_config("recurrentgemma-2b"))
    jp = jax.tree_util.tree_map(
        np.array, jrglru.init_rglru(jax.random.PRNGKey(2), jcfg))["rglru"]
    half = jp["a_param"].shape[0] // 2
    jp["a_param"] = np.concatenate([
        np.linspace(-30.0, -25.0, half),
        np.linspace(-6.0, -3.0, jp["a_param"].shape[0] - half),
    ]).astype(np.float32)
    jp["rec_gate_w"] = np.full_like(jp["rec_gate_w"], 0.5)
    port = rglru.RGLRU(torch.Generator().manual_seed(0), cfg, "cpu")
    with torch.no_grad():
        for name, prm in port.named_parameters():
            prm.copy_(_t(jp[name]))
    port.requires_grad_(True)
    rng = np.random.default_rng(12)
    u = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=u.shape).astype(np.float32)
    gp, gu = jax.jit(jax.grad(lambda params, uu: jnp.sum(
        jrglru.rglru_block({"rglru": params}, jcfg, uu)[0] * w),
        argnums=(0, 1)))(jp, jnp.asarray(u))
    tu = _t(u).requires_grad_()
    torch.sum(port(tu) * _t(w)).backward()
    _assert_close(tu.grad.numpy(), gu, 1e-4)
    for name, prm in port.named_parameters():
        _assert_close(prm.grad.numpy(), gp[name], 1e-4)
