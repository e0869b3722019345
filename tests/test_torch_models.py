"""The port's model families beyond dense attention (``repro_torch.models``:
MoE, Mamba-2 SSD, the RG-LRU hybrid, the VLM frontend and enc-dec) against
the JAX package's, on the CPU. Each family's smoke config runs in float32
through both packages, with the reference's parameters carried across by
``convert.params_from_jax``, at tests/test_torch_lm.py's tolerance (rtol
1e-4, atol 1e-4) unless a test states another. The port's attention runs
the flash kernel's plain version here; the kernel is held against it on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import build_model, encdec, transformer  # noqa: E402
from repro_torch.models import moe, rglru, ssm  # noqa: E402
from repro_torch.models.convert import (cache_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
DECODER_ONLY = ["olmoe-1b-7b", "deepseek-moe-16b", "mamba2-1.3b",
                "recurrentgemma-2b", "internvl2-26b"]
ALL = DECODER_ONLY + ["whisper-small"]
MOE = ["olmoe-1b-7b", "deepseek-moe-16b"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_MODELS: dict = {}


def _model(arch):
    """(jcfg, cfg, JAX bundle, JAX params, port model, port bundle), made
    once per arch."""
    if arch not in _MODELS:
        jcfg = jsmoke_config(jget_config(arch))
        cfg = smoke_config(get_config(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        jm = jbuild_model(jcfg)
        jparams = jm.init(jax.random.PRNGKey(0))
        model = params_from_jax(_np_tree(jparams), cfg, device="cpu")
        _MODELS[arch] = (jcfg, cfg, jm, jparams, model,
                         build_model(cfg, device="cpu"))
    return _MODELS[arch]


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _patches(cfg, b, seed):
    enc = cfg.encoder
    return np.random.default_rng(seed).normal(
        size=(b, enc.n_patches, enc.frontend_dim or cfg.d_model)
    ).astype(np.float32)


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_forward_hidden_and_aux_match(arch):
    """Hidden states over (B, S) = (2, 12) tokens (VLM: 16 patches
    prepended) and the summed switch aux loss (0 without MoE)."""
    jcfg, cfg, _, jparams, model, _ = _model(arch)
    tok = _tokens(cfg, 2, 12, 1)
    patches = _patches(cfg, 2, 2) if cfg.family == "vlm" else None
    hj, aj = jtransformer.forward(
        jparams, jcfg, jnp.asarray(tok), remat=False,
        patch_embeds=None if patches is None else jnp.asarray(patches))
    ht, at = transformer.forward(model, tok, patch_embeds=patches)
    n = 12 + (0 if patches is None else cfg.encoder.n_patches)
    assert ht.shape == (2, n, cfg.d_model)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5, atol=1e-8)
    assert (float(at) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ALL)
def test_prefill_logits_match(arch):
    """The bundle's prefill: VLM with patches, enc-dec over frames."""
    jcfg, cfg, jm, jparams, model, bundle = _model(arch)
    tok = _tokens(cfg, 2, 10, 3)
    batch = {"tokens": tok}
    if cfg.family == "vlm":
        batch["patches"] = _patches(cfg, 2, 4)
    if cfg.enc_dec:
        batch["frames"] = _frames(cfg, 2, 5)
    pj = jm.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    pt = bundle.prefill(model, batch)
    assert pt.shape == (2, cfg.vocab)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)


def _compare_layer_cache(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key == "pos":
            assert got[key] == w
        elif key == "kpos":
            assert torch.equal(got[key], w)
        else:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("arch", ALL)
def test_decode_logits_and_caches_match(arch):
    """12 decode steps from fresh caches: logits within 1e-4 at every step,
    then every cache (attention k/v, kpos and pos; SSM and RG-LRU state and
    conv; enc-dec self and cross K/V) within 1e-4. recurrentgemma's first
    layer is an RG-LRU, whose cache has no position."""
    jcfg, cfg, jm, jparams, model, bundle = _model(arch)
    tok = _tokens(cfg, 2, 12, 6)
    if cfg.enc_dec:
        frames = _frames(cfg, 2, 7)
        jc = jm.init_cache(2, 20, params=jparams, enc_out=jencdec.encode(
            jparams, jcfg, jnp.asarray(frames)))
        tc = bundle.init_cache(2, 20, params=model,
                               enc_out=encdec.encode(model, frames))
    else:
        jc, tc = jm.init_cache(2, 20), bundle.init_cache(2, 20)
    jdecode = jax.jit(jm.decode)
    for t in range(12):
        lj, jc = jdecode(jparams, jnp.asarray(tok[:, t:t + 1]), jc)
        lt, tc = bundle.decode(model, tok[:, t:t + 1], tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    want = cache_from_jax(_np_tree(jc), cfg)
    if cfg.enc_dec:
        assert tc["pos"] == want["pos"] == 12
        for got, w in zip(tc["self"], want["self"], strict=True):
            _compare_layer_cache(got, w)
        for key in ("cross_k", "cross_v"):
            for got, w in zip(tc[key], want[key], strict=True):
                np.testing.assert_allclose(got.numpy(), w.numpy(), **TOL)
        return
    assert len(want) == len(tc) == cfg.n_layers
    for got, w in zip(tc, want):
        _compare_layer_cache(got, w)
    assert transformer.cache_pos(tc) == (
        12 if any("pos" in c for c in tc) else 0)


def _record_gaps(engine, gaps):
    inner = engine._decode

    def decode(params, tokens, caches):
        logits, caches = inner(params, tokens, caches)
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        return logits, caches
    engine._decode = decode


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_serve_engine_tokens_match(arch):
    """Two waves of mixed prompt lengths through both engines give the same
    greedy tokens, a fresh cache of each layer's kind per wave. Greedy
    argmax is only comparable where the top-2 logits differ by more than
    the two frameworks' float32 error, so that is asserted first."""
    jcfg, cfg, _, jparams, model, _ = _model(arch)
    prompts = [_tokens(cfg, 1, n, 20 + i)[0]
               for i, n in enumerate((5, 8, 5, 8))]
    out, gaps = {}, []
    for name, eng in (
            ("jax", JServeEngine(jcfg, slots=2, max_seq=32,
                                 params=jparams)),
            ("torch", ServeEngine(cfg, slots=2, max_seq=32, params=model,
                                  device="cpu"))):
        if name == "jax":
            _record_gaps(eng, gaps)
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        out[name] = (eng.run(), eng.stats)
    (rj, sj), (rt, st) = out["jax"], out["torch"]
    assert min(gaps) > 1e-3, min(gaps)
    assert rt == rj and sorted(rt) == [1, 2, 3, 4]
    assert st == sj == {"waves": 2, "steps": 4 + 5 + 4 + 8, "requests": 4}


def test_encdec_engine_raises():
    """The engine is decoder-only, as the JAX package's is: whisper is
    served through its bundle."""
    with pytest.raises(ValueError, match="enc-dec"):
        ServeEngine(smoke_config(get_config("whisper-small")), device="cpu")


# ---------------------------------------------------------------------------
# MoE routing: capacity drops and ties
# ---------------------------------------------------------------------------
def _moe_pair(arch, seed, capacity_factor=None, tie=None):
    """The reference's MoE params (from ``init_moe``) and the port's
    ``MoE`` holding the same values, for a smoke config with
    ``capacity_factor`` overridden; ``tie=(i, j)`` copies router column i
    into column j."""
    jcfg = jsmoke_config(jget_config(arch))
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
    cfg = smoke_config(get_config(arch))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=jcfg.moe.capacity_factor))
    jp = jax.tree_util.tree_map(
        np.array, jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))  # writable
    if tie is not None:
        jp["moe"]["router"][:, tie[1]] = jp["moe"]["router"][:, tie[0]]
    port = moe.MoE(torch.Generator().manual_seed(0), cfg, "cpu")
    with torch.no_grad():
        for name, p in port.named_parameters():
            leaf = jp["moe"]
            for part in name.split("."):
                leaf = leaf[part]
            p.copy_(torch.from_numpy(np.array(leaf)))
    return jcfg, cfg, jp, port


def _reference_keep(expert_idx: np.ndarray, cap: int) -> np.ndarray:
    """Which (token, k) assignments fit: the j-th assignment of an expert
    in (token, k) order sits at position j."""
    eid = expert_idx.reshape(-1)
    seen: dict = {}
    pos = np.empty_like(eid)
    for j, e in enumerate(eid):
        pos[j] = seen.get(int(e), 0)
        seen[int(e)] = pos[j] + 1
    return pos < cap


@pytest.mark.parametrize("arch", MOE)
def test_moe_capacity_overflow_drops_the_same_set(arch):
    """capacity_factor 0.25 over 48 tokens: capacity is the floor of 8
    slots, so some experts overflow. The port drops exactly the
    assignments the reference's rank-by-sort drops, and its output (with
    dropped tokens' zero payloads) is the reference's."""
    jcfg, cfg, jp, port = _moe_pair(arch, 3, capacity_factor=0.25)
    x = np.random.default_rng(8).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32)
    yj, auxj = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    yt, auxt = port(torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(48, -1))
                           @ jp["moe"]["router"], axis=-1)
    _, jidx = jax.lax.top_k(probs, cfg.moe.top_k)
    cap = moe.capacity(cfg.moe, 48)
    assert cap == 8
    want = _reference_keep(np.asarray(jidx), cap)
    *_, tidx, _, keep, tcap = moe.route(
        torch.from_numpy(x.reshape(48, -1)) @ port.router, cfg.moe)
    assert tcap == cap
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < int((~keep).sum()) < keep.numel()


@pytest.mark.parametrize("arch", MOE)
def test_moe_router_ties_pick_the_lower_index(arch):
    """Router column 1 duplicated into column 5: the two experts' probs are
    equal on every token, and wherever the tie straddles the top-k edge the
    port keeps expert 1, as ``lax.top_k`` does."""
    jcfg, cfg, jp, port = _moe_pair(arch, 4, tie=(1, 5))
    k = cfg.moe.top_k
    x = np.random.default_rng(9).normal(
        size=(4, 32, cfg.d_model)).astype(np.float32)
    xf = torch.from_numpy(x.reshape(128, -1))
    probs, _, tidx, *_ = moe.route(xf @ port.router, cfg.moe)
    assert torch.equal(probs[:, 1], probs[:, 5])
    _, jidx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x.reshape(128, -1)) @ jp["moe"]["router"], axis=-1), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    # the tie holds the k-th and (k+1)-th places on some tokens: 1 in, 5 out
    ranked = torch.sort(probs, dim=-1, descending=True).values
    edge = (probs[:, 1] == ranked[:, k - 1]) & (probs[:, 1] == ranked[:, k])
    assert edge.any()
    assert (tidx[edge] == 1).any(-1).all()
    assert not (tidx[edge] == 5).any()
    yj, _ = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    yt, _ = port(torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_moe_capacity_formula():
    """``max(8, min(int(cf · T · k / E), T))`` in Python floats."""
    m = get_config("olmoe-1b-7b").moe
    assert [moe.capacity(m, t) for t in (1, 4, 51, 60, 2048)] == \
        [8, 8, 8, 9, 320]
    m = dataclasses.replace(m, capacity_factor=1.1, num_experts=2, top_k=1)
    assert [moe.capacity(m, t) for t in (3, 10, 100)] == [8, 8, 55]


# ---------------------------------------------------------------------------
# SSD and RG-LRU scans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [12, 16])
@pytest.mark.parametrize("decay", ["mild", "strong"])
def test_ssd_chunked_prefill_matches(seq, decay):
    """The chunked SSD scan with chunk 8 at S = 12 (a ragged tail, padded
    with decay 1) and S = 16. "strong" decays (a ≈ 1e-25, clamped to 1e-20
    before the log) make the masked upper triangle's exponents overflow;
    the port never forms inf there and stays finite."""
    rng = np.random.default_rng(seq)
    b, h, p, n = 2, 3, 4, 5
    x = rng.normal(size=(b, seq, h, p)).astype(np.float32)
    B = rng.normal(size=(b, seq, h, n)).astype(np.float32)
    C = rng.normal(size=(b, seq, h, n)).astype(np.float32)
    a = np.exp(-np.log1p(np.exp(rng.normal(size=(b, seq, h))))
               ).astype(np.float32)
    if decay == "strong":
        a[:, ::3] = 1e-25
    want = jssm._ssd_chunked(*map(jnp.asarray, (x, a, B, C)), 8)
    got = ssm.ssd_chunked(*map(torch.from_numpy, (x, a, B, C)), 8)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssm_block_prefill_matches_at_ragged_length():
    """The whole SSM block (projection, conv, decay, SSD, D·x, gate) at
    S = 12 over chunk 8."""
    jcfg, cfg, _, jparams, model, _ = _model("mamba2-1.3b")
    u = np.random.default_rng(2).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda t: t[0], jparams["groups"][0][0])
    want, _ = jssm.ssm_block(lp, jcfg, jnp.asarray(u))
    got = model.layers[0].ssm(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rglru_scan_matches_associative_scan():
    """The log-depth scan at S = 64 against ``lax.associative_scan`` of the
    same combine: the two trees round differently, so rtol 1e-5, atol
    1e-6."""
    rng = np.random.default_rng(64)
    a = rng.uniform(0.5, 1.0, size=(2, 64, 48)).astype(np.float32)
    v = rng.normal(size=(2, 64, 48)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(v)), axis=1)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_rglru_block_prefill_matches_at_64():
    """The whole RG-LRU block (gates, conv, scan, output gate) at S = 64."""
    jcfg, cfg, _, jparams, model, _ = _model("recurrentgemma-2b")
    u = np.random.default_rng(3).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda t: t[0], jparams["groups"][0][0])
    want, _ = jrglru.rglru_block(lp, jcfg, jnp.asarray(u))
    got = model.layers[0].rglru(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# enc-dec and VLM
# ---------------------------------------------------------------------------
def test_encdec_encode_and_decode_train_match():
    """Encoder states over the stub frames (bidirectional self-attention,
    learned positions) and the teacher-forced decoder's hidden states
    (causal self-attention, cross-attention to the encoder)."""
    jcfg, cfg, _, jparams, model, _ = _model("whisper-small")
    frames = _frames(cfg, 2, 11)
    tok = _tokens(cfg, 2, 9, 12)
    ej = jencdec.encode(jparams, jcfg, jnp.asarray(frames))
    et = encdec.encode(model, frames)
    assert et.shape == (2, cfg.encoder.n_frames, cfg.d_model)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), **TOL)
    hj = jencdec.decode_train(jparams, jcfg, jnp.asarray(tok), ej)
    ht = encdec.decode_train(model, tok, et)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)


def test_encdec_cache_without_params_raises():
    bundle = build_model(smoke_config(get_config("whisper-small")),
                         device="cpu")
    with pytest.raises(ValueError, match="needs params"):
        bundle.init_cache(2, 16)


def test_vlm_prefill_with_patches_reads_the_patches():
    """The VLM's prefill projects and prepends the patches: it matches the
    reference, and other patches give other logits."""
    jcfg, cfg, jm, jparams, model, bundle = _model("internvl2-26b")
    tok = _tokens(cfg, 1, 6, 13)
    logits = []
    for seed in (14, 15):
        patches = _patches(cfg, 1, seed)
        pj = jm.prefill(jparams, {"tokens": jnp.asarray(tok),
                                  "patches": jnp.asarray(patches)})
        pt = bundle.prefill(model, {"tokens": tok, "patches": patches})
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
        logits.append(pt)
    assert not torch.allclose(logits[0], logits[1])
