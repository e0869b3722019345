"""The port's LM serving path (``repro_torch.models``, ``repro_torch.serve``)
against the JAX package's, on the CPU, with the reference's parameters
carried across by ``convert.params_from_jax``: qwen3-0.6b's smoke config
(same structure — GQA, qk_norm, RoPE θ 1e6, tied embeddings — at small
widths) in float32. The port's attention runs the flash kernel's plain
version here; the kernel is held against it on the card."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import build_model, layers, transformer  # noqa: E402
from repro_torch.models.convert import (cache_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen3-0.6b"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def lm():
    jcfg = jsmoke_config(jget_config(ARCH))
    cfg = smoke_config(get_config(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, jparams=jparams, model=model,
                bundle=build_model(cfg, device="cpu"))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def test_configs_are_copies():
    assert ARCH in list_archs() and len(list_archs()) == 10
    for name in list_archs():
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(jget_config(name)))


@pytest.mark.parametrize("mode", ["full", "half", "none"])
def test_rope_and_rmsnorm_match(mode):
    """Interleaved even/odd RoPE pairs (not rotate_half), and RMSNorm's
    (1 + scale)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = (np.arange(7) + 1000)[None, :]
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, mode)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    scale = rng.normal(size=32).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-6)
    got = layers.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_and_prefill_match(lm):
    tok = _tokens(lm["cfg"], 2, 24, 1)
    hj, _ = jtransformer.forward(lm["jparams"], lm["jcfg"], jnp.asarray(tok),
                                 remat=False)
    ht, aux = transformer.forward(lm["model"], tok)
    assert aux == 0.0 and ht.shape == (2, 24, lm["cfg"].d_model)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    pj = lm["jm"].prefill(lm["jparams"], {"tokens": jnp.asarray(tok)})
    pt = lm["bundle"].prefill(lm["model"], {"tokens": tok})
    assert pt.shape == (2, lm["cfg"].vocab)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)


def test_decode_steps_and_caches_match(lm):
    """12 decode steps from empty caches: logits within 1e-4, and the
    caches the same (k/v within 1e-5, kpos and pos equal)."""
    tok = _tokens(lm["cfg"], 2, 12, 2)
    jdecode = jax.jit(lm["jm"].decode)
    jc = lm["jm"].init_cache(2, 20)
    tc = lm["bundle"].init_cache(2, 20)
    for t in range(12):
        lj, jc = jdecode(lm["jparams"], jnp.asarray(tok[:, t:t + 1]), jc)
        lt, tc = lm["bundle"].decode(lm["model"], tok[:, t:t + 1], tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    want = cache_from_jax(_np_tree(jc), lm["cfg"])
    assert len(want) == len(tc) == lm["cfg"].n_layers
    for w, c in zip(want, tc):
        assert w["pos"] == c["pos"] == 12
        assert torch.equal(w["kpos"], c["kpos"])
        for key in ("k", "v"):
            np.testing.assert_allclose(c[key].numpy(), w[key].numpy(),
                                       rtol=1e-5, atol=1e-5)


def _record_gaps(engine, gaps, to_np):
    inner = engine._decode

    def decode(params, tokens, caches):
        logits, caches = inner(params, tokens, caches)
        top2 = np.sort(to_np(logits), axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        return logits, caches
    engine._decode = decode


def test_serve_engine_tokens_match(lm):
    """Two waves of mixed prompt lengths through both engines give the same
    tokens. Greedy argmax is only comparable where the top-2 logits differ
    by more than the two frameworks' float32 error, so that is asserted
    first, at every step."""
    cfg = lm["cfg"]
    prompts = [_tokens(cfg, 1, n, 10 + i)[0]
               for i, n in enumerate((5, 9, 5, 9))]
    engines = {}
    gaps = []
    for name, eng in (
            ("jax", JServeEngine(lm["jcfg"], slots=2, max_seq=32,
                                 params=lm["jparams"])),
            ("torch", ServeEngine(cfg, slots=2, max_seq=32,
                                  params=lm["model"], device="cpu"))):
        if name == "jax":
            _record_gaps(eng, gaps, np.asarray)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        engines[name] = (eng.run(), eng.stats)
    (rj, sj), (rt, st) = engines["jax"], engines["torch"]
    assert min(gaps) > 1e-3, min(gaps)
    assert rt == rj and sorted(rt) == [1, 2, 3, 4]
    assert all(len(toks) == 6 for toks in rt.values())
    assert st == sj == {"waves": 2, "steps": 5 + 5 + 9 + 5, "requests": 4}


def test_not_ported_families_raise():
    """Every family builds, serves and trains: its loss is finite on a
    small batch. Training over a mesh is ported; a mesh needs a process
    group, and built without one it raises."""
    from repro_torch.train import TrainConfig, train
    rng = np.random.default_rng(0)
    for name in list_archs():
        cfg = smoke_config(get_config(name))
        bundle = build_model(cfg, device="cpu")
        tok = rng.integers(0, cfg.vocab, (1, 6))
        batch = {"tokens": tok, "labels": tok}
        if cfg.family == "vlm":
            batch["patches"] = rng.normal(size=(1, cfg.encoder.n_patches,
                                                cfg.encoder.frontend_dim))
        if cfg.enc_dec:
            batch["frames"] = rng.normal(size=(1, cfg.encoder.n_frames,
                                               cfg.d_model))
        loss, _ = bundle.loss(bundle.init(0), batch)
        assert np.isfinite(loss.item()), name
    from repro_torch.launch.mesh import Mesh
    with pytest.raises(RuntimeError, match="process group"):
        train(smoke_config(get_config("qwen3-0.6b")), TrainConfig(),
              device="cpu", mesh=Mesh({"data": 1}, device="cpu"))


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        build_model(smoke_config(get_config(ARCH)))


@pytest.mark.parametrize("arch,steps", [("gemma3-4b", 40),
                                        ("chatglm3-6b", 6),
                                        ("mistral-nemo-12b", 6)])
def test_other_attention_archs_decode_match(arch, steps):
    """The other attention-only archs: gemma3's local layers keep a rolling
    32-slot window cache that wraps within 40 steps; chatglm3 rotates half
    of each head (rope_mode "half")."""
    jcfg = jsmoke_config(jget_config(arch))
    cfg = smoke_config(get_config(arch))
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    model = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    bundle = build_model(cfg, device="cpu")
    tok = _tokens(cfg, 2, steps, 3)
    jdecode = jax.jit(jm.decode)
    jc, tc = jm.init_cache(2, 64), bundle.init_cache(2, 64)
    for t in range(steps):
        lj, jc = jdecode(jparams, jnp.asarray(tok[:, t:t + 1]), jc)
        lt, tc = bundle.decode(model, tok[:, t:t + 1], tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    hj, _ = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                 remat=False)
    ht, _ = transformer.forward(model, tok)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
