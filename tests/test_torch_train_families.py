"""Training of every model family against the JAX package, on the CPU: for
each of the ten archs at ``smoke_config`` (float32), the port's
``bundle.loss`` and its gradient with respect to every parameter against
``jax.value_and_grad`` of the reference's ``bundle.loss``, and one
``make_train_step`` (loss, gradients, AdamW) against the reference's. The
reference's parameters are carried across by ``convert.params_from_jax``
and its gradients mapped to the port's names through the same leaf naming.
The port's attention runs its plain forward and backward here.

Tolerances (float32, sums in another order): the loss within rtol 1e-5;
each gradient ‖Δ‖ ≤ 1e-4 ‖g‖; parameters after the step |Δ| ≤ 1e-3·lr,
except where the reference's gradient is below 1e-4 of its leaf's largest
|g|: Adam's first step moves a parameter by about lr·sign(g) whatever |g|
is, so a sign that float32 noise flips there moves it by 2·lr. The same
holds where the clipped gradient |g|·scale is within 100·eps of Adam's
eps: the step is g / (|g| + eps) there, and a float32 difference of a few
percent in a small element of g (the gradient test holds norms, not small
elements) moves it by more than 1e-3·lr. Those elements are counted and
printed, every one stays within 2·lr, and their count is held to 0.1% of
the parameters, not hidden."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.train import AdamW as JAdamW  # noqa: E402
from repro.train import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (_named_leaves,  # noqa: E402
                                        params_from_jax, reference_leaves)
from repro_torch.train import AdamW, AdamWConfig  # noqa: E402

ARCHS = list_archs()
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
LR = 1e-3            # the schedule's value at step 1 (warmup 1)
NOISE_FLOOR = 1e-4   # of a reference leaf's largest |g|
OPT_EPS = AdamWConfig().eps


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed: int) -> dict:
    """Tokens (2, 12) as labels too; VLM patches, enc-dec frames."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    batch = {"tokens": tok, "labels": tok.copy()}
    if cfg.family == "vlm":
        enc = cfg.encoder
        batch["patches"] = rng.normal(size=(2, enc.n_patches,
                                            enc.frontend_dim or cfg.d_model)
                                      ).astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = rng.normal(size=(2, cfg.encoder.n_frames,
                                           cfg.d_model)).astype(np.float32)
    return batch


_CASES: dict = {}


def _case(arch):
    """(cfg, JAX bundle, JAX params, batch, the reference's loss, metrics
    and gradients), made once per arch."""
    if arch not in _CASES:
        jcfg = jsmoke_config(jget_config(arch))
        cfg = smoke_config(get_config(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        jm = jbuild_model(jcfg)
        jparams = jm.init(jax.random.PRNGKey(0))
        batch = _batch(cfg, 17)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            jm.loss, has_aux=True))(jparams, jb)
        _CASES[arch] = (cfg, jm, jparams, batch, float(loss),
                        {k: float(v) for k, v in metrics.items()},
                        _np_tree(grads))
    return _CASES[arch]


def _port(cfg, jparams):
    return params_from_jax(_np_tree(jparams), cfg, device="cpu")


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch):
    """The loss (and its nll and aux parts) and every parameter's gradient.
    An untied ``lm_head`` gets none in either package: the reference's
    loss reads the embedding table for the logits (ROADMAP §3)."""
    cfg, _, jparams, batch, jloss, jmetrics, jgrads = _case(arch)
    model = _port(cfg, jparams).requires_grad_(True)
    bundle = build_model(cfg, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = bundle.loss(model, tbatch)
    assert sorted(metrics) == sorted(jmetrics)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), jmetrics[k], rtol=1e-5,
                                   atol=1e-7)
    names, tensors = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, tensors,
                                                allow_unused=True)))
    checked = 0
    for name, want in _named_leaves(jgrads, cfg):
        got = grads[name]
        if got is None:   # unused: the reference's gradient is zeros
            assert name == "lm_head" and not cfg.tie_embeddings
            assert not np.asarray(want).any()
            continue
        assert torch.isfinite(got).all(), name
        assert _rel(got.numpy(), want) <= 1e-4, (name, _rel(got.numpy(),
                                                             want))
        checked += 1
    assert checked >= len(names) - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches(arch):
    """One ``make_train_step`` from the same weights and batch: the loss,
    grad norm and lr, and every parameter after the AdamW update."""
    cfg, jm, jparams, batch, jloss, _, jgrads = _case(arch)
    # the reference's train step is value_and_grad, then AdamW.update
    # (launch/steps.py:27-35); its first call is taken once, in _case
    jopt = JAdamW(JAdamWConfig(**OPT))
    jnew, jstate, jmet = jax.jit(jopt.update)(jgrads, jopt.init(jparams),
                                              jparams)
    model = _port(cfg, jparams)
    opt = AdamW(AdamWConfig(**OPT))
    step = make_train_step(build_model(cfg, device="cpu"), opt)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model, state, met = step(model, opt.init(model), tbatch)
    assert state["step"] == int(jstate["step"]) == 1
    np.testing.assert_allclose(float(met["loss"]), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    assert met["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert met["lr"] == pytest.approx(LR)
    params = dict(model.named_parameters())
    grads = dict(_named_leaves(jgrads, cfg))
    floor = {name: NOISE_FLOOR * np.abs(g).max() for name, g in grads.items()}
    near_eps = 100 * OPT_EPS / min(1.0, 1.0 / float(jmet["grad_norm"]))
    noisy = {}
    for name, want in _named_leaves(_np_tree(jnew), cfg):
        got = params[name].detach().numpy()
        g = np.abs(grads[name])
        big = (g >= _leaf_floor(name, grads, cfg, floor)) & (g >= near_eps)
        diff = np.abs(got - np.asarray(want))
        assert diff[big].max(initial=0.0) <= 1e-3 * LR, (name,
                                                         diff[big].max())
        # below the floor: sign flips of near-zero gradients, at most 2 lr
        assert diff.max() <= 2.0 * LR * 1.01, name
        n = int((diff > 1e-3 * LR).sum())
        if n:
            noisy[name] = (n, diff.size)
    total = sum(p.numel() for p in params.values())
    print(f"{arch}: elements past 1e-3·lr below the gradient floor: "
          f"{sum(n for n, _ in noisy.values())} of {total} {noisy}")
    assert sum(n for n, _ in noisy.values()) <= total // 1000, noisy


def _leaf_floor(name, grads, cfg, floor):
    """NOISE_FLOOR of the largest |g| of the reference leaf ``name`` came
    from (a decoder-only layer's leaf is stacked over its group's
    layers)."""
    for group in reference_leaves(cfg, list(grads)):
        if name in group:
            return max(floor[n] for n in group)
    raise KeyError(name)
