"""The port's training substrate against the JAX package's, on the CPU:
the token pipeline (byte-equal batches), the learning-rate schedule and
AdamW (the reference's arithmetic), the int8 gradient compressor (one
scale per reference leaf over the port's per-layer tensors), checkpoints
(the reference's six cases, on named tensors), the training loop's
checkpoint/restart (resumed losses equal to the uninterrupted run's, to
the bit) and the CLI. Inputs are made with numpy from a seed and handed to
both packages."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.data.pipeline import PipelineConfig as JPipelineConfig  # noqa
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.train import AdamW as JAdamW  # noqa: E402
from repro.train import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import lr_schedule as jlr_schedule  # noqa: E402
from repro.train import make_int8_compressor as jcompressor  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, cleanup,  # noqa
                                   list_checkpoints, restore_latest,
                                   save_checkpoint)
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline  # noqa
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.convert import (_named_leaves,  # noqa: E402
                                        reference_leaves)
from repro_torch.train import (AdamW, AdamWConfig, TrainConfig,  # noqa
                               lr_schedule, make_int8_compressor, train)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(vocab=100, seq_len=8, global_batch=4, seed=3),
    dict(vocab=151936, seq_len=64, global_batch=6, seed=0),
    dict(vocab=50, seq_len=4, global_batch=8, seed=1, num_hosts=2,
         host_id=1),
    dict(vocab=500, seq_len=16, global_batch=4, seed=2,
         drop_ids=np.arange(0, 2 ** 31 - 1, 7919)),
])
def test_pipeline_batches_byte_equal(kw):
    """Batch t is the reference's, byte for byte (tokens and labels, dtype
    and shape), for t in 0..5, with host sharding and dedup drops."""
    ours, theirs = TokenPipeline(PipelineConfig(**kw)), \
        JTokenPipeline(JPipelineConfig(**kw))
    for step in range(6):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


def test_pipeline_resume_and_seed_check():
    """The reference's pipeline tests: a restored cursor continues the
    stream; hosts partition the batch; a seed mismatch is refused."""
    cfg = PipelineConfig(vocab=100, seq_len=8, global_batch=4, seed=3)
    p1 = TokenPipeline(cfg)
    first = [next(iter(p1)) for _ in range(4)][-1]
    p2 = TokenPipeline(cfg)
    p2.restore(p1.state())
    np.testing.assert_array_equal(p1.batch_at(3)["tokens"],
                                  first["tokens"])
    assert p2.step == 4 and p2.state() == p1.state()
    shards = [TokenPipeline(PipelineConfig(vocab=50, seq_len=4,
                                           global_batch=8, seed=1,
                                           num_hosts=2, host_id=h))
              for h in (0, 1)]
    full = TokenPipeline(PipelineConfig(vocab=50, seq_len=4, global_batch=8,
                                        seed=1))
    np.testing.assert_array_equal(
        full.batch_at(0)["tokens"],
        np.concatenate([s.batch_at(0)["tokens"] for s in shards]))
    with pytest.raises(ValueError):
        p2.restore({"step": 0, "seed": 999})


# ---------------------------------------------------------------------------
# learning rate and AdamW
# ---------------------------------------------------------------------------
SCHEDULES = [AdamWConfig(), AdamWConfig(warmup_steps=0, total_steps=100),
             AdamWConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10),
             AdamWConfig(warmup_steps=7, total_steps=7)]


@pytest.mark.parametrize("cfg", SCHEDULES)
def test_lr_schedule_matches(cfg):
    jcfg = JAdamWConfig(**dataclasses.asdict(cfg))
    for step in [0, 1, 2, 5, 7, 50, 99, 100, 101, 5000, 10_000, 20_000]:
        want = float(jlr_schedule(jcfg, jnp.asarray(step, jnp.int32)))
        assert lr_schedule(cfg, step) == pytest.approx(want, rel=1e-6,
                                                       abs=1e-12)


def _jstep(opt, params, state, grads):
    return opt.update({k: jnp.asarray(v) for k, v in grads.items()}, state,
                      params)


def test_adamw_quadratic_steps_match():
    """The reference's quadratic case (lr 0.1, no decay, 60 steps): the
    port's parameters after every step are the reference's to float32
    rounding, and the loss falls below 0.3 as there."""
    cfg = dict(learning_rate=0.1, weight_decay=0.0, warmup_steps=0,
               total_steps=100)
    jopt, opt = JAdamW(JAdamWConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    jp = {"w": jnp.asarray([3.0, -2.0])}
    js = jopt.init(jp)
    tp = {"w": torch.tensor([3.0, -2.0])}
    ts = opt.init(tp)
    for _ in range(60):
        jp, js, jm = _jstep(jopt, jp, js, {"w": 2 * np.asarray(jp["w"])})
        tp, ts, tm = opt.update({"w": 2 * tp["w"]}, ts, tp)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert ts["step"] == int(js["step"]) == 60
    assert float((tp["w"] ** 2).sum()) < 0.3
    for k in ("mu", "nu"):
        np.testing.assert_allclose(ts[k]["w"].numpy(), np.asarray(js[k]["w"]),
                                   rtol=1e-5, atol=1e-7)


def test_adamw_clipping_and_decay_match():
    """A huge gradient is clipped to norm 1 before the moments (the
    reference's clipping case); weight decay, a bf16 parameter and a
    parameter with no gradient (a zero gradient: it still decays) follow
    the reference's arithmetic."""
    cfg = dict(learning_rate=1.0, clip_norm=1.0, weight_decay=0.1,
               warmup_steps=0)
    jopt, opt = JAdamW(JAdamWConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    rng = np.random.default_rng(5)
    w = rng.normal(size=3).astype(np.float32)
    b = rng.normal(size=(4, 2)).astype(np.float32)
    u = rng.normal(size=5).astype(np.float32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16),
          "unused": jnp.asarray(u)}
    tp = {"w": torch.from_numpy(w.copy()),
          "b": torch.from_numpy(b).to(torch.bfloat16),
          "unused": torch.from_numpy(u.copy())}
    js, ts = jopt.init(jp), opt.init(tp)
    for big in (1e9, 3.0):
        g = {"w": np.full(3, big, np.float32),
             "b": rng.normal(size=(4, 2)).astype(np.float32)}
        jg = {"w": jnp.asarray(g["w"]),
              "b": jnp.asarray(g["b"], jnp.bfloat16),
              "unused": jnp.zeros(5)}
        jp, js, jm = jopt.update(jg, js, jp)
        tg = {"w": torch.from_numpy(g["w"]),
              "b": torch.from_numpy(g["b"]).to(torch.bfloat16)}
        tp, ts, tm = opt.update(tg, ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for k in ("w", "unused"):
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
        assert tp["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp["b"].float().numpy(), np.asarray(jp["b"], np.float32))
    assert float(tm["grad_norm"]) > 1.0
    assert np.abs(tp["w"].numpy() - w).max() < 10.0
    assert not np.array_equal(tp["unused"].numpy(), u)   # decayed


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------
def _stacked_model_grads(arch: str, n_layers: int, seed: int):
    """Random gradients and error state shaped like the reference's params
    of ``arch``'s smoke config at ``n_layers`` (leaves stacked over each
    group's layers), and the same values by the port's per-layer names."""
    jcfg = dataclasses.replace(jsmoke_config(jget_config(arch)),
                               n_layers=n_layers)
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              n_layers=n_layers)
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    # leaves of very different magnitudes: the scale per leaf matters
    grads = treedef.unflatten([
        (rng.normal(size=l.shape) * 10.0 ** rng.integers(-4, 2)
         ).astype(np.float32) for l in leaves])
    error = treedef.unflatten([
        (rng.normal(size=l.shape) * 1e-3).astype(np.float32)
        for l in leaves])
    port = {n: torch.from_numpy(np.array(v))
            for n, v in _named_leaves(grads, cfg)}
    perr = {n: torch.from_numpy(np.array(v))
            for n, v in _named_leaves(error, cfg)}
    return cfg, grads, error, port, perr


@pytest.mark.parametrize("arch,n_layers", [
    ("qwen3-0.6b", 3), ("recurrentgemma-2b", 8), ("deepseek-moe-16b", 4)])
def test_int8_compressor_matches_per_reference_leaf(arch, n_layers):
    """On a stacked model's gradients (smoke widths; qwen3's 3 layers in one
    group, recurrentgemma's pattern twice and a remainder, deepseek's dense
    first layer as a group of its own beside 3 MoE layers), the port's
    compressor, which groups its per-layer tensors by the reference leaf
    they came from, gives the reference's dequantized gradients and new
    error, bit for bit; with a scale per port tensor it would not."""
    cfg, grads, error, port, perr = _stacked_model_grads(arch, n_layers, 1)
    jdeq, jerr = jcompressor()(grads, error)
    deq, err = make_int8_compressor(cfg)(port, perr)
    for (name, want), (_, werr) in zip(_named_leaves(jdeq, cfg),
                                       _named_leaves(jerr, cfg)):
        assert torch.equal(deq[name], torch.from_numpy(np.array(want))), name
        assert torch.equal(err[name], torch.from_numpy(np.array(werr))), name
    groups = reference_leaves(cfg, list(port))
    assert max(len(g) for g in groups) > 1       # stacked leaves exist
    assert sorted(sum(groups, [])) == sorted(port)
    solo, _ = make_int8_compressor()(port, perr)
    assert any(not torch.equal(solo[n], deq[n]) for n in port)


def test_int8_compression_error_feedback():
    """The reference's case: the quantization residual is carried, so the
    mean of applied gradients converges to the true gradient."""
    tf = make_int8_compressor()
    g = {"w": torch.tensor([1e-4, 0.5, -0.3])}
    err = {"w": torch.zeros(3)}
    applied = torch.zeros(3)
    for _ in range(50):
        deq, err = tf(g, err)
        applied = applied + deq["w"]
    np.testing.assert_allclose((applied / 50).numpy(), g["w"].numpy(),
                               atol=2e-3)


# ---------------------------------------------------------------------------
# checkpoint: the reference's six cases on named tensors
# ---------------------------------------------------------------------------
def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(2, dtype=torch.bfloat16)},
            "step": 7}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree, extra={"note": "x"})
    step, restored, extra = restore_latest(str(tmp_path), tree)
    assert step == 5 and extra["note"] == "x"
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert restored["step"] == 7 and isinstance(restored["step"], int)
    with open(os.path.join(list_checkpoints(str(tmp_path))[-1][1],
                           "manifest.json")) as f:
        manifest = f.read()
    assert '"names": ["a", "b.c", "step"]' in manifest


def test_checkpoint_bfloat16_preserved(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    _, restored, _ = restore_latest(str(tmp_path), tree)
    assert restored["b"]["c"].dtype == torch.bfloat16
    path = os.path.join(list_checkpoints(str(tmp_path))[-1][1],
                        "arr_00001.npy")
    assert np.load(path).dtype == np.uint16   # the reference's container


def test_checkpoint_latest_wins_and_cleanup(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, tree)
    cleanup(str(tmp_path), keep=2)
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [4, 5]
    assert restore_latest(str(tmp_path), tree)[0] == 5


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError):
        restore_latest(str(tmp_path), {"only": torch.zeros(1)})
    renamed = _tree()
    renamed["z"] = renamed.pop("a")     # same count, another name
    with pytest.raises(ValueError):
        restore_latest(str(tmp_path), renamed)


def test_checkpoint_async_manager(tmp_path):
    """Saves go through the async writer; the snapshot is taken at save
    time, so an in-place update after ``save`` never reaches the file."""
    m = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = _tree()
    for s in (10, 20):
        m.save(s, tree)
        tree["a"].add_(1.0)
    m.close()
    step, restored, _ = restore_latest(str(tmp_path), tree)
    assert step == 20
    assert torch.equal(restored["a"], tree["a"] - 1.0)


def test_checkpoint_crash_tmp_ignored(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(str(tmp_path / "step_000000099.tmp"))  # simulated crash
    assert restore_latest(str(tmp_path), tree)[0] == 1


# ---------------------------------------------------------------------------
# the training loop: checkpoint, restart, resume
# ---------------------------------------------------------------------------
def _tcfg(ckpt, steps=6, every=3):
    return TrainConfig(steps=steps, log_every=100, checkpoint_every=every,
                       checkpoint_dir=None if ckpt is None else str(ckpt),
                       global_batch=2, seq_len=16,
                       optimizer=AdamWConfig(learning_rate=1e-3,
                                             warmup_steps=1,
                                             total_steps=steps))


CFG = smoke_config(get_config("qwen3-0.6b"))


def test_train_loop_checkpoint_restart(tmp_path):
    """The reference's test: 6 steps, checkpoint every 3; a restart resumes
    from step 4 (saved after step 3) and runs fewer steps."""
    out1 = train(CFG, _tcfg(tmp_path), device="cpu")
    assert np.isfinite(out1["final_loss"])
    assert len(out1["loss_history"]) == 6
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [4]
    out2 = train(CFG, _tcfg(tmp_path), device="cpu")
    assert len(out2["loss_history"]) < len(out1["loss_history"])
    assert set(out1) == {"final_loss", "loss_history", "mean_step_ms",
                         "straggler_report"}


class _Kill(Exception):
    pass


@pytest.mark.parametrize("compress", [False, True])
def test_killed_run_resumes_with_the_same_losses(tmp_path, compress):
    """6 steps with a checkpoint every 2; the same run killed by an
    exception from ``on_step`` at step 4, then resumed by calling ``train``
    again: the resumed steps' losses are the uninterrupted run's, to the
    bit (parameters, AdamW state, step counter, error feedback and the
    pipeline cursor all restored)."""
    kw = dict(device="cpu")
    if compress:
        kw["grad_transform"] = make_int8_compressor(CFG)
    whole = train(CFG, _tcfg(tmp_path / "whole", every=2), **kw)

    def kill(step, metrics):
        assert np.isfinite(metrics["loss"]) and metrics["lr"] > 0
        if step == 4:
            raise _Kill()

    with pytest.raises(_Kill):
        train(CFG, _tcfg(tmp_path / "killed", every=2), on_step=kill, **kw)
    assert [s for s, _ in list_checkpoints(str(tmp_path / "killed"))] == [3]
    resumed = train(CFG, _tcfg(tmp_path / "killed", every=2), **kw)
    assert resumed["loss_history"] == whole["loss_history"][3:]


def test_train_mesh_raises():
    """``train(mesh=...)`` raises no more: on a one-rank gloo mesh (a
    spawned process) it gives the one-process losses."""
    from repro_torch.launch.mesh import spawn
    from torch_dist_ranks import train_one_rank
    losses = spawn(train_one_rank, 1, backend="gloo", deadline_s=120,
                   args=(_tcfg(None, steps=3),))[0]
    want = train(CFG, _tcfg(None, steps=3), device="cpu")["loss_history"]
    np.testing.assert_allclose(losses, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_smoke_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch qwen3-0.6b --smoke
    --device cpu`` with a checkpoint directory and int8 compression."""
    train_cli.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                    "--steps", "4", "--ckpt", str(tmp_path),
                    "--compress-grads", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "done: final_loss=" in out and "step     0 loss" in out
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [3]
    # a sharded run is launched under torchrun; without it, it says so
    with pytest.raises(RuntimeError, match="torchrun"):
        train_cli.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                        "cpu", "--model-axis", "2"])
