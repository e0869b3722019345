"""The compute split over the ``model`` axis (``dist.tensor_parallel``) on
gloo ranks on the CPU, against one process of the port and the JAX
package on one device.

Families: qwen3 (its KV heads do not divide a model axis of 4), gemma3
(local and global layers), olmoe (the MoE path without all-to-all: experts
over ``model``), mamba2 (SSD heads), recurrentgemma (RG-LRU width, local
attention) and whisper (enc-dec), at their smoke configs widened where a
split needs it: olmoe and whisper to 4 heads, so that their heads split 4
ways. olmoe keeps its capacity factor: its ranks rank their assignments
together into the whole batch's slab, so they drop what one process
drops. Meshes: (1, 2), (1, 4) and (2, 2) ("data", "model"); one world of 2
ranks and one of 4 are spawned for the file.

Tolerances (float32, sums in another order): the loss within 1e-5
relative of one process's and of the reference's; each gathered gradient
‖Δ‖ ≤ 1e-4‖g‖; the parameters after one AdamW step within 1e-3·lr where
the gradient is above the floor of ``tests/test_torch_train_families.py``
(1e-4 of the tensor's largest, and 100·eps of Adam's eps), each within
2·lr and at most 1 in 1,000 past 1e-3·lr below it; the prefill logits and
two decode steps against caches split over their rows within
5e-5·(1 + |ref|), which is float32's noise at these depths
(``LOGITS_TOL``). Every rank's attention runs at H/m heads where m
divides H, and at H where it does not.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks as R  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import AdamW, AdamWConfig  # noqa: E402

DEADLINE_S = 300
LR = 1e-3
MAX_SEQ = 32
ARCHS = ("qwen3-0.6b", "gemma3-4b", "olmoe-1b-7b", "mamba2-1.3b",
         "recurrentgemma-2b", "whisper-small")
WIDEN = {"olmoe-1b-7b": dict(n_heads=4, n_kv_heads=4),
         "whisper-small": dict(n_heads=4, n_kv_heads=4)}
SHAPES = {2: {"1x2": {"data": 1, "model": 2}},
          4: {"1x4": {"data": 1, "model": 4},
              "2x2": {"data": 2, "model": 2}}}
MESHES = [(w, n) for w, names in SHAPES.items() for n in names]
OPT_EPS = AdamWConfig().eps
# float32 logits of a split forward against one process's: splitting the
# MLP's one sum into two halves in one process alone moves gemma3's smoke
# logits (8 layers) by up to 1.67e-5·(1 + |ref|), and qwen3's at 8 layers
# by 1.45e-5; the split runs reach 2.5e-5 (gemma3, whisper at model 4)
LOGITS_TOL = 5e-5


def _cfg(smoke, get, arch):
    return dataclasses.replace(smoke(get(arch)), **WIDEN.get(arch, {}))


def _batch(cfg, seed: int) -> dict:
    """Tokens (2, 16) as labels too; enc-dec frames."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": tok, "labels": tok.copy()}
    if cfg.enc_dec:
        batch["frames"] = rng.normal(size=(2, cfg.encoder.n_frames,
                                           cfg.d_model)).astype(np.float32)
    return batch


class _Recording(AdamW):
    def update(self, grads, state, params):
        self.grads = grads
        return super().update(grads, state, params)


def _one_process(cfg, np_params, batch) -> dict:
    """The port's step, prefill and decode in one process."""
    from repro_torch.configs import get_config, smoke_config
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        _cfg(smoke_config, get_config, cfg.name))
    bundle = build_model(cfg, device="cpu")
    full = {k: torch.as_tensor(v) for k, v in batch.items()}
    model = params_from_jax(np_params, cfg, device="cpu")
    opt = _Recording(AdamWConfig(learning_rate=LR, warmup_steps=1,
                                 total_steps=10))
    model, _, met = make_train_step(bundle, opt)(model, opt.init(model),
                                                 full)
    out = dict(loss=float(met["loss"]), gnorm=float(met["grad_norm"]),
               grads={k: v.numpy() for k, v in opt.grads.items()
                      if v is not None},
               params={k: v.detach().numpy()
                       for k, v in model.named_parameters()})
    model = params_from_jax(np_params, cfg, device="cpu")
    with torch.no_grad():
        out["prefill"] = bundle.prefill(model, full).numpy()
        rows = full["tokens"].shape[0]
        if cfg.enc_dec:
            cache = bundle.init_cache(rows, MAX_SEQ, params=model,
                                      enc_out=encdec.encode(model,
                                                            full["frames"]))
        else:
            cache = bundle.init_cache(rows, MAX_SEQ)
        out["decode"] = [bundle.decode(model, full["tokens"][:, t:t + 1],
                                       cache)[0].numpy() for t in range(2)]
    return out


@pytest.fixture(scope="module")
def world():
    """Both worlds' results, spawned together while the references are
    computed here."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs import get_config, smoke_config
    cases, jax_cases = [], []
    for i, arch in enumerate(ARCHS):
        jbundle = jbuild_model(_cfg(jsmoke_config, jget_config, arch))
        cfg = _cfg(smoke_config, get_config, arch)
        np_params = jax.tree_util.tree_map(
            np.asarray, jbundle.init(jax.random.PRNGKey(i)))
        cases.append((arch, cfg, np_params, _batch(cfg, i), MAX_SEQ))
        jax_cases.append(jbundle)
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        futures = {w: pool.submit(spawn, R.tensor_parallel, w,
                                  backend="gloo", deadline_s=DEADLINE_S,
                                  args=(cases, shapes, LR))
                   for w, shapes in SHAPES.items()}
        refs = {}
        for (arch, cfg, np_params, batch, _), jbundle in zip(cases,
                                                             jax_cases):
            jloss, _ = jbundle.loss(
                jax.tree_util.tree_map(jnp.asarray, np_params),
                {k: jnp.asarray(v) for k, v in batch.items()})
            refs[arch] = dict(_one_process(cfg, np_params, batch),
                              jax_loss=float(jloss), cfg=cfg)
        out = {w: f.result() for w, f in futures.items()}
    out["refs"] = refs
    return out


def _runs(world, arch, w, name):
    return [r[(arch, name)] for r in world[w]], world["refs"][arch]


@pytest.mark.parametrize("mesh", MESHES, ids=[n for _, n in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_is_one_process_and_reference(world, arch, mesh):
    runs, ref = _runs(world, arch, *mesh)
    for run in runs:
        assert abs(run["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        assert abs(run["loss"] - ref["jax_loss"]) <= \
            1e-5 * abs(ref["jax_loss"])
        # a parameter the loss does not read (an untied head) has no
        # gradient in one process and a zero one from the store
        assert set(ref["grads"]) <= set(run["grads"])
        for n in set(run["grads"]) - set(ref["grads"]):
            assert not run["grads"][n].any(), n
        for n, g in ref["grads"].items():
            assert np.linalg.norm(run["grads"][n] - g) <= \
                1e-4 * np.linalg.norm(g), n
        scale = min(1.0, 1.0 / ref["gnorm"])
        noisy = total = 0
        for n, want in ref["params"].items():
            diff = np.abs(run["params"][n] - want)
            ga = np.abs(ref["grads"].get(n, np.zeros_like(want)))
            big = (ga >= 1e-4 * ga.max()) & (ga * scale >= 100 * OPT_EPS)
            assert diff.max() <= 2.01 * LR, n
            assert not big.any() or diff[big].max() <= 1e-3 * LR, n
            noisy += int((diff > 1e-3 * LR).sum())
            total += diff.size
        assert noisy <= total // 1000, (noisy, total)


@pytest.mark.parametrize("mesh", MESHES, ids=[n for _, n in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_and_sequence_sharded_decode(world, arch, mesh):
    runs, ref = _runs(world, arch, *mesh)
    for run in runs:
        for got, want in zip([run["prefill"]] + run["decode"],
                             [ref["prefill"]] + ref["decode"]):
            assert np.all(np.abs(got - want) <= LOGITS_TOL * (1 + np.abs(want)))


@pytest.mark.parametrize("mesh", MESHES, ids=[n for _, n in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_attention_runs_at_local_heads(world, arch, mesh):
    w, name = mesh
    m = {"1x2": 2, "1x4": 4, "2x2": 2}[name]
    cfg = world["refs"][arch]["cfg"]
    runs, _ = _runs(world, arch, w, name)
    want = [] if arch == "mamba2-1.3b" else \
        [cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads]
    for run in runs:
        assert run["heads"] == (want, want), (run["heads"], want)


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("written,window", [(512, 0), (300, 0), (512, 64)])
def test_plain_decode_slices_merged_equal_whole(n, written, window):
    """The plain versions of the sequence-sharded decode: n slices' outputs
    and log-sum-exps (``ref.gqa_attention_lse``) merged by
    ``ref.decode_merge`` equal ``ref.gqa_attention`` over the whole cache,
    slices that see no key included."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(n + written)
    t, b, h, hkv, d = 512, 2, 8, 4, 32
    q = torch.randn(b, 1, h, d, generator=g)
    k = torch.randn(b, t, hkv, d, generator=g)
    v = torch.randn(b, t, hkv, d, generator=g)
    kpos = torch.full((t,), -1, dtype=torch.int32)
    kpos[:written] = torch.arange(written, dtype=torch.int32)
    kw = dict(causal=True, window=window, q_offset=written - 1)
    whole = ref.gqa_attention(q, k, v, kv_positions=kpos, **kw)
    parts = [ref.gqa_attention_lse(q, k_, v_, kv_positions=p_, **kw)
             for k_, v_, p_ in zip(k.chunk(n, 1), v.chunk(n, 1),
                                   kpos.chunk(n))]
    merged = ref.decode_merge(torch.stack([o for o, _ in parts]),
                              torch.stack([x for _, x in parts]))
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
