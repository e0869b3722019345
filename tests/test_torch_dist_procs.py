"""The port's mesh paths in several processes (gloo, on the CPU) against
one process and against the JAX package: the superstep join sharded over
ranks, sharded training and its checkpoints, GPipe, and the expert-parallel
all-to-all MoE. Two worlds are spawned for the whole file (2 and 4 ranks,
one thread each, under a deadline, by ``repro_torch.launch.mesh.spawn``);
the rank functions are in ``tests/torch_dist_ranks.py``, which imports no
JAX, so each test reads its share of one run. The oracles are the JAX
package's own (``tests/test_multidevice.py``, ``tests/test_moe_a2a.py``)
and, port against port, byte equality or the stated tolerances."""
import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks as R  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.core import build_bucket_graph as jbuild_graph  # noqa: E402
from repro.core import bucketize as jbucketize  # noqa: E402
from repro.core import recall as jrecall  # noqa: E402
from repro.core.distributed import DistributedJoin as JDist  # noqa: E402
from repro.data import brute_force_pairs  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro.train.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.checkpoint import restore_latest  # noqa: E402
from repro_torch.core import BucketGraph, BucketMeta  # noqa: E402
from repro_torch.core import JoinConfig  # noqa: E402
from repro_torch.core.distributed import (DistributedJoin,  # noqa: E402
                                          plan_supersteps)
from repro_torch.data import clustered_vectors  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.store.vector_store import BucketedVectorStore  # noqa: E402
from repro_torch.train import (AdamW, AdamWConfig,  # noqa: E402
                               make_int8_compressor)
from torch_parity import assert_same_pairs  # noqa: E402

DEADLINE_S = 300
# tests/test_multidevice.py's join: 16 buckets, 2 MiB, ε 0.3
JOIN_CFG = dict(epsilon=0.3, recall_target=0.95, pad_align=64,
                memory_budget_bytes=2 << 20, num_buckets=16)
# tests/test_ft.py's checkpoint configuration: many supersteps, so a kill
# lands between commits
FT_CFG = dict(JOIN_CFG, memory_budget_bytes=128 << 10, num_buckets=24)
MODES = ("host", "device")
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_LR = 1e-3
TRAIN_RUNS = {  # (mesh, fsdp, int8)
    "4x1": ({"data": 4, "model": 1}, False, False),
    "2x2": ({"data": 2, "model": 2}, False, False),
    "2x2-fsdp": ({"data": 2, "model": 2}, True, False),
    "2x2-fsdp-int8": ({"data": 2, "model": 2}, True, True)}
RESUME_STEPS, RESUME_KILL = 6, 4
GPIPE = dict(S=4, L=8, M=4, mb=2, dim=16)   # tests/test_multidevice.py's
MOE_SHAPES = ({"data": 1, "model": 4}, {"data": 2, "model": 2})
MOE_CASES = {"olmoe-1b-7b": (0, 1, (4, 8)),     # (params key, x key, x)
             "deepseek-moe-16b": (2, 3, (2, 8))}   # tests/test_moe_a2a.py


def _store(tmp, x, cfg):
    """Bucketize with the JAX package; both packages read the files."""
    os.makedirs(tmp, exist_ok=True)
    jstore = JFlat.from_array(os.path.join(tmp, "x.bin"), x)
    jcfg = JJoinConfig(**cfg)
    jbs, jmeta, _ = jbucketize(jstore, os.path.join(tmp, "bk"), jcfg)
    jgraph = jbuild_graph(jmeta, jcfg)
    meta = {"centers": jmeta.centers, "radii": jmeta.radii,
            "sizes": jmeta.sizes}
    return (jbs, jmeta, jgraph), (os.path.join(tmp, "bk"), meta,
                                  np.asarray(jgraph.edges))


def _one_process_join(port, cfg, mode, **run_kw):
    bk, meta, edges = port
    graph = BucketGraph(num_nodes=len(meta["sizes"]), edges=edges)
    return DistributedJoin(BucketedVectorStore(bk), BucketMeta(**meta),
                           JoinConfig(compute_mode=mode, **cfg),
                           device="cpu").run(graph, **run_kw)


def _jax_params(arch, key=0):
    cfg = jsmoke_config(jget_config(arch))
    params = jbuild_model(cfg).init(jax.random.PRNGKey(key))
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _tokens(vocab):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                         vocab))


def _moe_inputs(arch):
    kp, kx, shape = MOE_CASES[arch]
    cfg = jsmoke_config(jget_config(arch))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    params = jmoe.init_moe(jax.random.PRNGKey(kp), cfg)
    x = jax.random.normal(jax.random.PRNGKey(kx), shape + (cfg.d_model,),
                          jnp.float32)
    return cfg, params, x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both spawned worlds' results, with what they are compared with."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    x = clustered_vectors(3000, 32, seed=4)
    stores = {"join": _store(os.path.join(tmp, "join"), x, JOIN_CFG),
              "ft": _store(os.path.join(tmp, "ft"), x, FT_CFG)}

    def job(tag, shape, mode, **kw):
        bk, meta, edges = stores[tag][1]
        cfg = JOIN_CFG if tag == "join" else FT_CFG
        return dict(bucket_dir=bk, meta=meta, edges=edges, cfg=cfg,
                    shape=shape, mode=mode, **kw)

    ft_steps = _one_process_join(stores["ft"][1], FT_CFG,
                                 "device")[1]["supersteps"]
    kill_at = max(1, int(ft_steps * 0.6))
    tasks2 = {"join": ("join", (
        [job("join", {"data": 2}, m) for m in MODES]
        + [job("ft", {"data": 2}, "device", kill_at=kill_at,
               ckdir=os.path.join(tmp, "ck"))],)),
              "collectives": ("collectives", ()),
              "full_state": ("full_state", (TRAIN_ARCH,))}
    _, np_params = _jax_params(TRAIN_ARCH)
    tokens = np.array(_tokens(np_params["embed"]["table"].shape[0]))
    rng = np.random.default_rng(0)
    g = GPIPE
    w = rng.normal(scale=0.3, size=(g["L"], g["dim"], g["dim"])).astype(
        np.float32)
    xg = rng.normal(size=(g["M"], g["mb"], g["dim"])).astype(np.float32)
    tasks4 = {
        "join": ("join", ([job("join", {"data": 4}, m) for m in MODES]
                          + [job("join", {"data": 2, "model": 2}, "host")],
                          )),
        "train": ("train_step", (TRAIN_ARCH, np_params, tokens, TRAIN_LR, [
            dict(shape=s, fsdp=f, int8=i)
            for s, f, i in TRAIN_RUNS.values()])),
        "resume": ("train_resume", (TRAIN_ARCH, os.path.join(tmp, "train"),
                                    RESUME_STEPS, RESUME_KILL,
                                    {"data": 2, "model": 2}, TRAIN_LR)),
        "gpipe": ("gpipe", (w, xg)),
    }
    for arch in MOE_CASES:
        _, params, xm = _moe_inputs(arch)
        tasks4[f"moe:{arch}"] = ("moe_a2a", (
            arch, jax.tree_util.tree_map(np.asarray, params["moe"]),
            np.asarray(xm), 8.0, MOE_SHAPES))
    out = {"tmp": tmp, "stores": stores, "x": x, "kill_at": kill_at,
           "np_params": np_params, "tokens": tokens, "w": w, "xg": xg}
    out[2] = spawn(R.suite, 2, backend="gloo", deadline_s=DEADLINE_S,
                   args=(tasks2,))
    out[4] = spawn(R.suite, 4, backend="gloo", deadline_s=DEADLINE_S,
                   args=(tasks4,))
    return out


# ---------------------------------------------------------------------------
# the superstep join sharded over ranks
# ---------------------------------------------------------------------------
def _assert_bytes(got, pairs, dists):
    assert got[0].dtype == pairs.dtype and got[1].dtype == dists.dtype
    assert np.array_equal(got[0], pairs)
    assert np.array_equal(got[1], dists)


@pytest.mark.parametrize("ranks,index,mode", [
    (2, 0, "host"), (2, 1, "device"), (4, 0, "host"), (4, 1, "device"),
    (4, 2, "host")])
def test_sharded_join_is_one_process_bytes(world, ranks, index, mode):
    port = world["stores"]["join"][1]
    pairs, info = _one_process_join(port, JOIN_CFG, mode)
    bk, meta, edges = port
    dj = DistributedJoin(BucketedVectorStore(bk), BucketMeta(**meta),
                         JoinConfig(**JOIN_CFG), device="cpu")
    total = sum(len(s.edges_local) for s in plan_supersteps(
        BucketGraph(num_nodes=len(meta["sizes"]), edges=edges),
        JoinConfig(**JOIN_CFG), dj.cache_buckets, meta=dj.meta))
    model = 1 if index < 2 else 2
    for rank_out in world[ranks]:   # every rank returns the whole result
        got = rank_out["join"][index]
        _assert_bytes(got, pairs, info["dists"])
        assert got[2]["watermark_rows"] == info["watermark_rows"]
        # the data ranks split the edges; model ranks repeat their slice
        per_rank = got[2]["rank_edges"]
        assert len(per_rank) == ranks
        assert sum(per_rank[::model]) == total
        assert per_rank == [per_rank[r - r % model] for r in range(ranks)]


@pytest.mark.parametrize("mode", MODES)
def test_sharded_join_matches_reference_and_recall(world, mode):
    """Against the reference's ``DistributedJoin(mesh=None)``: the
    port-vs-JAX pair contract (the same pairs but on the ε boundary, the
    distances allclose: the two packages' float32 d² differ in their last
    bits), and the reference's recall oracle against brute force."""
    (jbs, jmeta, jgraph), _ = world["stores"]["join"]
    jpairs, jinfo = JDist(jbs, jmeta, JJoinConfig(
        compute_mode=mode, **JOIN_CFG)).run(jgraph)
    for ranks in (2, 4):
        got = world[ranks][0]["join"][MODES.index(mode)]
        assert_same_pairs(world["x"], JOIN_CFG["epsilon"],
                          types.SimpleNamespace(pairs=got[0],
                                                distances=got[1]),
                          types.SimpleNamespace(pairs=np.asarray(jpairs),
                                                distances=np.asarray(
                                                    jinfo["dists"])))
        truth = brute_force_pairs(world["x"], JOIN_CFG["epsilon"])
        assert jrecall(got[0], truth) >= 0.9


def test_sharded_join_killed_and_resumed(world):
    pairs, info = _one_process_join(world["stores"]["ft"][1], FT_CFG,
                                    "device")
    assert info["supersteps"] > 3
    for rank_out in world[2]:
        got = rank_out["join"][2]
        _assert_bytes(got, pairs, info["dists"])
        assert 0 < got[2]["resumed_at"] <= world["kill_at"]
        assert got[2]["watermark_rows"] == info["watermark_rows"]


# ---------------------------------------------------------------------------
# sharded training
# ---------------------------------------------------------------------------
class _Recording(AdamW):
    """AdamW that keeps the gradients it was given."""

    def update(self, grads, state, params):
        self.grads = {n: g.detach().numpy() for n, g in grads.items()
                      if g is not None}
        return super().update(grads, state, params)


@pytest.fixture(scope="module")
def one_process_steps(world):
    out = {}
    for int8 in (False, True):
        cfg, bundle, model = R._lm(TRAIN_ARCH, world["np_params"])
        opt = _Recording(AdamWConfig(learning_rate=TRAIN_LR),
                         grad_transform=make_int8_compressor(cfg) if int8
                         else None)
        t = torch.as_tensor(world["tokens"])
        model, _, m = make_train_step(bundle, opt)(
            model, opt.init(model), {"tokens": t, "labels": t})
        out[int8] = (float(m["loss"]), float(m["grad_norm"]),
                     {n: p.detach().numpy()
                      for n, p in model.named_parameters()}, opt.grads)
    return out


def _int8_ties(grads: dict) -> dict:
    """{name: the elements whose gradient lies within 1e-3 of a level of a
    rounding boundary of the int8 compressor} (one scale per reference
    leaf, max |g| / 127; the first step carries no error)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.convert import reference_leaves
    out = {}
    cfg = smoke_config(get_config(TRAIN_ARCH))
    for group in reference_leaves(cfg, list(grads)):
        level = max(np.abs(grads[n]).max() for n in group) / 127.0
        for n in group:
            f = np.abs(grads[n]) / level
            out[n] = np.abs(f - np.floor(f) - 0.5) < 1e-3
    return out


def _assert_adam_step(params, want, grads, gnorm, int8):
    """``[train]``'s parameter rule (``tests/test_torch_train_families.py``):
    within 1e-3·lr where the one-process gradient is above the floor (1e-4
    of the tensor's largest, and 100·eps of Adam's eps after the clip);
    below it within 2·lr, at most 1 in 1,000 past 1e-3·lr. A sum in
    another order moves a near-zero gradient's sign, and Adam's first step
    turns that sign into ±lr; under the int8 compressor a gradient at a
    rounding boundary between two levels is below the floor too (Adam's
    first step then moves by ±lr or 0)."""
    scale = min(1.0, 1.0 / gnorm)
    eps = AdamWConfig().eps
    ties = _int8_ties(grads) if int8 else {}
    noisy = total = 0
    for n, w in want.items():
        diff = np.abs(params[n] - w)
        ga = np.abs(grads.get(n, np.zeros_like(w)))
        big = (ga >= 1e-4 * ga.max()) & (ga * scale >= 100 * eps)
        if n in ties:
            big &= ~ties[n]
        assert diff.max() <= 2.01 * TRAIN_LR, n
        assert not big.any() or diff[big].max() <= 1e-3 * TRAIN_LR, n
        noisy += int((diff > 1e-3 * TRAIN_LR).sum())
        total += diff.size
    assert noisy <= total // 1000, (noisy, total)


def test_reference_single_device_loss(world, one_process_steps):
    cfg, _ = _jax_params(TRAIN_ARCH)
    m = jbuild_model(cfg)
    params = m.init(jax.random.PRNGKey(0))
    opt = JAdamW(JAdamWConfig(learning_rate=TRAIN_LR))
    t = jnp.asarray(world["tokens"])
    _, _, metrics = jax.jit(jmake_step(m, opt))(params, opt.init(params),
                                                {"tokens": t, "labels": t})
    ref = float(metrics["loss"])
    for rank_out in world[4]:
        for loss, *_ in rank_out["train"]:
            assert abs(loss - ref) < 1e-2, (loss, ref)


@pytest.mark.parametrize("run", sorted(TRAIN_RUNS))
def test_sharded_step_is_one_process_step(world, one_process_steps, run):
    shape, fsdp, int8 = TRAIN_RUNS[run]
    loss1, gnorm1, params1, grads1 = one_process_steps[int8]
    i = list(TRAIN_RUNS).index(run)
    sizes = []
    for rank_out in world[4]:
        loss, gnorm, params, held = rank_out["train"][i]
        assert abs(loss - loss1) <= 1e-5 * abs(loss1)
        assert abs(gnorm - gnorm1) <= 1e-5 * abs(gnorm1)
        assert set(params) == set(params1)
        _assert_adam_step(params, params1, grads1, gnorm1, int8)
        sizes.append(held)
    # parameters held a rank shrink by the axes their specs name
    full = sum(p.size for p in params1.values())
    assert all(h < full for h in sizes) if shape["model"] > 1 or fsdp \
        else all(h == full for h in sizes)


def test_resharding_restore_and_resume(world):
    full, seen, resumed, step, tensors, _ = world[4][0]["resume"]
    # killed after step RESUME_KILL: the newest checkpoint was saved after
    # step 2 (as step 3); the resumed run repeats steps 3..5 bit for bit
    assert seen == full[:RESUME_KILL + 1]
    assert resumed == full[RESUME_KILL - 1:]
    ckdir = os.path.join(world["tmp"], "train", "a")
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import _state
    model = build_model(smoke_config(get_config(TRAIN_ARCH)),
                        device="cpu").init(0)
    got = restore_latest(ckdir, _state(model, AdamW(AdamWConfig()).init(
        model)))
    assert got[0] == step == RESUME_STEPS - 1
    flat = dict(_flat(got[1]))
    for n, t in tensors.items():   # (4, 1) restore == one process's
        assert np.array_equal(flat[n].numpy(), t), n


def test_training_records_no_collectives(world):
    """``train(mesh)``'s steps, each issuing hundreds of collectives, leave
    the mesh's tally off: a collective is recorded only inside
    ``Mesh.tallying``, which the dry-run opens around one step."""
    for rank_out in world[4]:
        assert rank_out["resume"][-1] is None


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def test_checkpoint_state_is_kept_by_rank_zero_alone(world):
    """A mesh checkpoint's full state: every rank gathers each leaf, rank 0
    alone keeps it, on the host, equal to the one-process state."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model
    kept = [r["full_state"] for r in world[2]]
    assert kept[1] is None and kept[0]
    model = build_model(smoke_config(get_config(TRAIN_ARCH)),
                        device="cpu").init(0)
    want = {f"params.{n}": p.detach().numpy()
            for n, p in model.named_parameters()}
    for key in ("mu", "nu"):
        want.update({f"opt.{key}.{n}": np.zeros(p.shape, np.float32)
                     for n, p in model.named_parameters()})
    assert sorted(kept[0]) == sorted(want)
    for n, (where, t) in kept[0].items():
        assert where == "cpu" and t.dtype == want[n].dtype, n
        assert np.array_equal(t, want[n]), n


# ---------------------------------------------------------------------------
# the collectives of a mesh
# ---------------------------------------------------------------------------
def _check_collectives(results):
    """Each rank's collectives over its one-rank "model" axis (no group:
    the identity) and over every axis (the default group) against what
    the ranks' inputs give."""
    ts = [r[0] for r in results]
    world = len(ts)
    total = np.sum(ts, axis=0)
    for rank, (t, groups, out) in enumerate(results):
        model, every = sorted(out, key=len)
        assert groups == {model: False, every: True}
        for name, got in out[model].items():
            want = t[:rank + 1] if name == "all_gather_list" else t
            assert np.array_equal(got, want), (name, model)
        got, rows = out[every], len(t) // world
        assert np.array_equal(got["all_reduce"], total)
        assert np.array_equal(got["max"], np.max(ts, axis=0))
        assert np.array_equal(got["all_gather"], np.concatenate(ts, 1))
        assert np.array_equal(got["all_gather_list"], np.concatenate(
            [u[:r + 1] for r, u in enumerate(ts)]))
        assert np.array_equal(got["reduce_scatter"],
                              total[rank * rows:(rank + 1) * rows])
        if rank == 0:
            assert np.array_equal(got["reduce"], total)
        assert np.array_equal(got["broadcast"], ts[0])
        assert np.array_equal(got["all_to_all"], np.concatenate(
            [u[rank * rows:(rank + 1) * rows] for u in ts]))


def test_collectives_over_axes_and_every_axis(world):
    _check_collectives([r["collectives"] for r in world[2]])


def test_collectives_at_world_size_one():
    """At world size 1 a collective over every axis still runs, in the
    default group (gloo here; NCCL on the card)."""
    _check_collectives(spawn(R.collectives, 1, backend="gloo",
                             deadline_s=DEADLINE_S))


# ---------------------------------------------------------------------------
# GPipe and the all-to-all MoE
# ---------------------------------------------------------------------------
def test_gpipe_matches_sequential(world):
    from repro_torch.dist.pipeline import bubble_fraction
    w, x = world["w"], world["xg"]
    y = jnp.asarray(x)
    for i in range(GPIPE["L"]):
        y = jnp.tanh(y @ jnp.asarray(w[i]))
    for rank_out in world[4]:
        np.testing.assert_allclose(rank_out["gpipe"], np.asarray(y),
                                   rtol=1e-5, atol=1e-5)
    assert 0 < bubble_fraction(GPIPE["S"], GPIPE["M"]) < 1


@pytest.mark.parametrize("arch", sorted(MOE_CASES))
@pytest.mark.parametrize("shape", [0, 1])
def test_a2a_moe_matches_reference_and_one_process(world, arch, shape):
    cfg, params, x = _moe_inputs(arch)
    y_ref, _ = jmoe.moe_ffn(params, cfg, x)
    for rank_out in world[4]:   # every rank of a model group: the same y
        y, aux, grads = rank_out[f"moe:{arch}"][shape]
        assert float(np.max(np.abs(np.asarray(y_ref) - y))) < 2e-4
        assert np.isfinite(aux)
    # the port's one-process MoE on the same weights
    moe = MoE(torch.Generator().manual_seed(0), _port_cfg(arch), "cpu")
    with torch.no_grad():
        for name, p in moe.named_parameters():
            leaf = params["moe"]
            for k in name.split("."):
                leaf = leaf[k]
            p.copy_(torch.as_tensor(np.asarray(leaf)))
    moe.requires_grad_(True)
    y1, _ = moe(torch.as_tensor(np.asarray(x)))
    names, ps = zip(*moe.named_parameters())
    g1 = torch.autograd.grad((y1 ** 2).sum(), ps)
    for n, g in zip(names, g1):
        g = g.numpy()
        assert np.isfinite(grads[n]).all() and np.abs(grads[n]).sum() > 0
        assert np.linalg.norm(grads[n] - g) <= 1e-4 * np.linalg.norm(g), n


def _port_cfg(arch):
    from repro_torch.configs import get_config, smoke_config
    cfg = smoke_config(get_config(arch))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
