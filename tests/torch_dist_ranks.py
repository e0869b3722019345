"""Rank functions for the multi-process tests of the port
(``tests/test_torch_dist_procs.py``): each runs in a process of its own,
started by ``repro_torch.launch.mesh.spawn`` under gloo on the CPU, and
imports the port only (no JAX), so a rank starts fast. Every function
takes ``(rank, world, ...)`` and returns picklable results."""
import numpy as np
import torch

from repro_torch.launch.mesh import Mesh


def _join_once(store, meta, graph, cfg_kw, mesh, mode, **run_kw):
    from repro_torch.core import JoinConfig
    from repro_torch.core.distributed import DistributedJoin
    pairs, info = DistributedJoin(store, meta, JoinConfig(
        compute_mode=mode, **cfg_kw), mesh).run(graph, **run_kw)
    keep = ("supersteps", "rank_edges", "rank_loads", "watermark_rows",
            "resumed_at")
    return pairs, info["dists"], {k: info[k] for k in keep if k in info}


def join(rank, world, jobs):
    """``DistributedJoin(mesh)`` for each job → a list of (pairs, dists,
    info) per job. A job: the bucketed store (``bucket_dir``, ``meta``
    arrays, graph ``edges``), ``cfg`` (JoinConfig keywords), the mesh
    ``shape``, the compute ``mode``; with ``kill_at``, the run is killed at
    that superstep (rank 0 checkpointing into ``ckdir``) and resumed."""
    from repro_torch.core import BucketGraph, BucketMeta
    from repro_torch.ft import FaultInjector, InjectedKill, JoinCheckpointer
    from repro_torch.store.vector_store import BucketedVectorStore
    out = []
    for job in jobs:
        store = BucketedVectorStore(job["bucket_dir"])
        meta = BucketMeta(**job["meta"])
        graph = BucketGraph(num_nodes=len(job["meta"]["sizes"]),
                            edges=job["edges"])
        mesh = Mesh(job["shape"], device="cpu")
        args = (store, meta, graph, job["cfg"], mesh, job["mode"])
        if "kill_at" not in job:
            out.append(_join_once(*args))
            continue
        ck = JoinCheckpointer(job["ckdir"]) if rank == 0 else None
        try:
            _join_once(*args, checkpointer=ck, fault=FaultInjector(
                kill_at_superstep=job["kill_at"]))
            raise AssertionError("the kill did not fire")
        except InjectedKill:
            pass
        if ck is not None:
            ck.finish()   # flush the async writer before the resume
        mesh.barrier()
        ck = JoinCheckpointer(job["ckdir"]) if rank == 0 else None
        out.append(_join_once(*args, checkpointer=ck,
                              resume_from=job["ckdir"]))
    return out


def _lm(arch: str, np_params, smoke: bool = True):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_jax
    cfg = get_config(arch)
    cfg = smoke_config(cfg) if smoke else cfg
    bundle = build_model(cfg, device="cpu")
    return cfg, bundle, params_from_jax(np_params, cfg, device="cpu")


def train_step(rank, world, arch, np_params, tokens, lr, runs):
    """One sharded step per run (``shape``, ``fsdp``, ``int8``) from the
    same weights on the global batch ``tokens`` → per run (loss,
    grad_norm, every parameter gathered after the step), each on the
    compute split over ``model`` that ``train(mesh)`` runs."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import AdamW, AdamWConfig, make_int8_compressor
    out = []
    for run in runs:
        cfg, bundle, model = _lm(arch, np_params)
        mesh = Mesh(run["shape"], device="cpu")
        shd.set_mesh(mesh)
        try:
            store = shd.ShardedParams(model, mesh, fsdp=run["fsdp"])
            opt = AdamW(AdamWConfig(learning_rate=lr),
                        grad_transform=make_int8_compressor(cfg)
                        if run["int8"] else None)
            step = make_train_step(bundle, opt, mesh)
            t = torch.as_tensor(tokens)
            store, state, metrics = step(store, opt.init(store),
                                         {"tokens": t, "labels": t})
            full = store.full(dict(store.named_parameters()))
        finally:
            shd.set_mesh(None)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    {n: v.detach().numpy() for n, v in full.items()},
                    sum(p.numel() for p in store.parts.values())))
    return out


class _Killed(RuntimeError):
    pass


def train_resume(rank, world, arch, ckdir, steps, kill_at, shape, lr):
    """``train(mesh)`` with checkpoints: uninterrupted into ``ckdir/a``;
    killed after step ``kill_at`` and resumed into ``ckdir/b``; then
    ``ckdir/a``'s newest checkpoint restored onto a (world, 1) mesh →
    (losses, losses before the kill, resumed losses, the restored step,
    the (world, 1) restore's full tensors by leaf name, the training
    mesh's tally after all its steps)."""
    import os
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.checkpoint import restore_latest
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.steps import opt_state_shardings
    from repro_torch.models import build_model
    from repro_torch.train import AdamW, AdamWConfig, TrainConfig, train
    from repro_torch.train.train_loop import _load, _state
    cfg = smoke_config(get_config(arch))
    opt_cfg = AdamWConfig(learning_rate=lr, warmup_steps=1,
                          total_steps=steps)

    def tcfg(sub):
        return TrainConfig(steps=steps, log_every=10 ** 6,
                           checkpoint_every=2,
                           checkpoint_dir=os.path.join(ckdir, sub),
                           global_batch=8, seq_len=16, optimizer=opt_cfg)

    mesh = Mesh(shape, device="cpu")
    full = train(cfg, tcfg("a"), mesh=mesh, fsdp=True)["loss_history"]
    seen = []

    def kill(step, metrics):
        seen.append(metrics["loss"])
        if step == kill_at:
            raise _Killed(step)

    try:
        train(cfg, tcfg("b"), mesh=mesh, fsdp=True, on_step=kill)
    except _Killed:
        pass
    mesh.barrier()     # rank 0's checkpoint writer has drained
    resumed = train(cfg, tcfg("b"), mesh=mesh, fsdp=True)["loss_history"]

    flat = Mesh({"data": world, "model": 1}, device="cpu")
    store = shd.ShardedParams(build_model(cfg, device="cpu").init(0), flat)
    opt = AdamW(opt_cfg)
    state = opt.init(store)
    step, tree, _ = restore_latest(
        os.path.join(ckdir, "a"), _state(store, state),
        shardings={"params": store.shardings,
                   "opt": opt_state_shardings(flat, state,
                                              store.shardings)})
    _load(store, state, tree)
    tensors = {f"params.{n}": t for n, t in
               store.full(dict(store.named_parameters())).items()}
    for key in ("mu", "nu"):
        tensors.update({f"opt.{key}.{n}": t for n, t in
                        store.full(state[key]).items()})
    return (full, seen, resumed, step,
            {n: t.numpy() for n, t in tensors.items()}, mesh.tally)


def gpipe(rank, world, w, x):
    """The reference test's pipeline: ``tanh(x @ w_i)`` layers over
    ``world`` stages → the (M, mb, dim) outputs."""
    from repro_torch.dist.pipeline import (gpipe_forward, make_pp_mesh,
                                           split_stages)
    mesh = make_pp_mesh(world, device="cpu")

    def stage_fn(params, h):
        for i in range(params.shape[0]):
            h = torch.tanh(h @ params[i])
        return h

    fwd = gpipe_forward(stage_fn, mesh, x.shape[0])
    return fwd(split_stages(torch.as_tensor(w), world),
               torch.as_tensor(x)).numpy()


def moe_a2a(rank, world, arch, np_moe, x, capacity_factor, shapes):
    """One MoE layer (the reference's parameters) under the all-to-all
    dispatch, per mesh shape: this rank's rows of ``x`` → (y of the whole
    batch, aux, the gradients of sum(y²) summed over the data axis)."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models.convert import to_torch
    from repro_torch.models.moe import MoE
    cfg = smoke_config(get_config(arch))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    moe = MoE(torch.Generator().manual_seed(0), cfg, "cpu")
    with torch.no_grad():
        for name, p in moe.named_parameters():
            leaf = np_moe
            for k in name.split("."):
                leaf = leaf[k]
            p.copy_(to_torch(leaf))
    moe.requires_grad_(True)
    out = []
    for shape in shapes:
        mesh = Mesh(shape, device="cpu")
        shd.set_mesh(mesh)
        try:
            n, i = mesh.axis_size("data"), mesh.axis_index("data")
            xl = torch.as_tensor(x).chunk(n)[i]
            with shd.axis_rules(moe_a2a=True):
                y, aux = moe(xl)
            names, params = zip(*moe.named_parameters())
            grads = torch.autograd.grad((y ** 2).sum(), params)
            grads = [mesh.all_reduce(g, "data") for g in grads]
            y = mesh.all_gather(y.detach(), "data")
        finally:
            shd.set_mesh(None)
        out.append((y.numpy(), float(aux.detach()),
                    {k: g.numpy() for k, g in zip(names, grads)}))
    return out


def collectives(rank, world):
    """Each collective of a (world, 1) mesh over its "model" axis (one rank,
    no process group) and over every axis (the default group, at world size
    1 too) → (this rank's input, whether each has a group, {axes: {name:
    result}})."""
    torch.set_num_threads(1)
    mesh = Mesh({"data": world, "model": 1}, device="cpu")
    t = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 100 * rank
    groups = {axes: mesh._group(axes) is not None
              for axes in (("model",), mesh.axis_names)}
    out = {}
    for axes in groups:
        out[axes] = {
            "all_reduce": mesh.all_reduce(t, axes),
            "max": mesh.all_reduce(t, axes, op="max"),
            "all_gather": mesh.all_gather(t, axes, dim=1),
            "all_gather_list": torch.cat(mesh.all_gather_list(
                t[:rank + 1], axes)),
            "reduce_scatter": mesh.reduce_scatter(t, axes),
            "reduce": mesh.reduce(t, axes, 0),
            "broadcast": mesh.broadcast(t.clone(), axes, 0),
            "all_to_all": mesh.all_to_all(t, axes)}
        out[axes] = {k: v.numpy() for k, v in out[axes].items()}
    return t.numpy(), groups, out


def full_state(rank, world, arch):
    """The training state of ``arch``'s smoke config on a (world, 1) mesh
    under fsdp, gathered as a checkpoint gathers it, rank 0 keeping it →
    None on the other ranks, else {leaf name: full array}."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models import build_model
    from repro_torch.train import AdamW, AdamWConfig
    from repro_torch.train.train_loop import _full_state
    mesh = Mesh({"data": world, "model": 1}, device="cpu")
    store = shd.ShardedParams(build_model(smoke_config(get_config(arch)),
                                          device="cpu").init(0), mesh,
                              fsdp=True)
    state = _full_state(store, AdamW(AdamWConfig()).init(store), rank == 0)
    if state is None:
        return None
    flat = {f"params.{n}": t for n, t in state["params"].items()}
    for key in ("mu", "nu"):
        flat.update({f"opt.{key}.{n}": t
                     for n, t in state["opt"][key].items()})
    return {n: (t.device.type, t.numpy()) for n, t in flat.items()}


def suite(rank, world, tasks):
    """Several rank functions in one world: {name: (function name, args)}
    → {name: result}, in the order given. One thread a rank, so that
    the ranks do not starve the suite's other workers."""
    torch.set_num_threads(1)
    torch.manual_seed(0)
    return {name: globals()[fn](rank, world, *args)
            for name, (fn, args) in tasks.items()}


def train_one_rank(rank, world, tcfg):
    """qwen3-0.6b's smoke config trained by ``train(mesh)`` on a
    (world, 1) mesh → its losses (one thread a rank)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.train import train
    torch.set_num_threads(1)
    mesh = Mesh({"data": world, "model": 1}, device="cpu")
    return train(smoke_config(get_config("qwen3-0.6b")), tcfg,
                 mesh=mesh)["loss_history"]


def tensor_parallel(rank, world, cases, shapes, lr):
    """The compute split over ``model`` (``dist.tensor_parallel``) for each
    case (an arch's widened smoke config and the reference's weights
    carried across) on each mesh shape: one ``make_train_step`` (loss,
    the gradients gathered, the parameters gathered after the step), the
    prefill logits, and two decode steps against caches split over their
    rows (``cache_seq`` over ``model``), with the logits of every rank's
    rows gathered; and the head counts the attention ran at (training and
    prefill). → {(arch, mesh name): result}."""
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.steps import make_train_step, seq_shard_of
    from repro_torch.models import build_model
    from repro_torch.models import encdec
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train import AdamW, AdamWConfig

    heads = []
    plain = kops.gqa_attention

    def counting(q, *a, **kw):
        heads.append(int(q.shape[2]))
        return plain(q, *a, **kw)

    class Recording(AdamW):
        def update(self, grads, state, params):
            self.grads = grads
            return super().update(grads, state, params)

    kops.gqa_attention = counting
    out = {}
    try:
        for name, shape in shapes.items():
            mesh = Mesh(shape, device="cpu")
            for arch, cfg, np_params, batch, max_seq in cases:
                bundle = build_model(cfg, device="cpu")
                full = {k: torch.as_tensor(v) for k, v in batch.items()}
                shd.set_mesh(mesh)
                try:
                    store = shd.ShardedParams(
                        params_from_jax(np_params, cfg, device="cpu"), mesh,
                        batch_rows=full["tokens"].shape[0])
                    opt = Recording(AdamWConfig(learning_rate=lr,
                                                warmup_steps=1,
                                                total_steps=10))
                    heads.clear()
                    store, _, met = make_train_step(bundle, opt, mesh)(
                        store, opt.init(store), full)
                    train_heads = sorted(set(heads))
                    grads = store.full(opt.grads)
                    params = store.full(dict(store.named_parameters()))
                    axes = store.batch_axes
                    n, i = mesh.axis_size(axes), mesh.axis_index(axes)
                    local = {k: v.chunk(n, 0)[i] for k, v in full.items()}
                    with torch.no_grad():
                        # the prefill and decode from the weights before the
                        # step
                        store = shd.ShardedParams(
                            params_from_jax(np_params, cfg, device="cpu"),
                            mesh, batch_rows=full["tokens"].shape[0])
                        heads.clear()
                        logits = store.call(bundle.prefill, local)
                        prefill_heads = sorted(set(heads))
                        steps = []
                        with shd.axis_rules(cache_seq=("model",)):
                            def caches(model):
                                shards = (lambda t: seq_shard_of(mesh, t))
                                rows = local["tokens"].shape[0]
                                if cfg.enc_dec:
                                    enc = encdec.encode(model,
                                                        local["frames"])
                                    return bundle.init_cache(
                                        rows, max_seq, params=model,
                                        enc_out=enc, seq_shards=shards)
                                return bundle.init_cache(rows, max_seq,
                                                         seq_shards=shards)
                            cache = store.call(caches)
                            for t in range(2):
                                tok = local["tokens"][:, t:t + 1]
                                steps.append(mesh.all_gather(store.call(
                                    bundle.decode, tok, cache)[0], axes))
                        logits = mesh.all_gather(logits, axes)
                finally:
                    shd.set_mesh(None)
                out[(arch, name)] = dict(
                    loss=float(met["loss"]),
                    grads={k: v.detach().numpy() for k, v in grads.items()},
                    params={k: v.detach().numpy() for k, v in params.items()},
                    prefill=logits.numpy(),
                    decode=[s.numpy() for s in steps],
                    heads=(train_heads, prefill_heads))
    finally:
        kops.gqa_attention = plain
    return out


# the dry-run's shapes cut for the CPU: the kinds, the global batches and
# the decode caches' split over ranks kept, the sequences short
DRYRUN_SEQ = {"train_4k": 16, "prefill_32k": 32, "decode_32k": 64,
              "long_500k": 256}


def dryrun_suite(ops_dir, runs):
    """``launch.dryrun`` at smoke widths in this process's fake worlds, on
    the CPU: each run (arch, shape, multi_pod, keywords) → its record,
    with ``expected_params_bytes``, the sum of the parts ``param_shardings``
    gives the rank on that mesh; then the join superstep on both meshes,
    and the tally of one send → (records, join records, send tally)."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_config, smoke_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun, dryrun_join
    from repro_torch.launch.census import tree_bytes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    torch.set_num_threads(2)

    def config(arch):
        cfg = smoke_config(get_config(arch))
        if cfg.moe is not None:   # experts that divide the model axis
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, num_experts=16))
        return cfg

    dryrun.get_config = config
    dryrun.SHAPES = {k: dataclasses.replace(v, seq_len=DRYRUN_SEQ[k])
                     for k, v in SHAPES.items()}
    recs = []
    for arch, shape, mp, kw in runs:
        rec = dryrun.run_cell(arch, shape, mp, device="cpu",
                              ops_dir=ops_dir, **kw)
        if rec["status"] == "ok":
            mesh = make_production_mesh(multi_pod=mp, device="cpu")
            model = build_model(config(arch), device="cpu").init(0)
            with shd.axis_rules(**dryrun.extra_rules(
                    **{k: v for k, v in kw.items()
                       if k in ("capacity_data", "dp_over_model",
                                "moe_replicated_dispatch", "moe_a2a")})):
                specs = shd.param_shardings(model, mesh,
                                            fsdp=kw.get("fsdp", False))
            rec["expected_params_bytes"] = sum(
                tree_bytes(specs[n].shard(p.data))
                for n, p in model.named_parameters())
        recs.append(rec)
    joins = [dryrun_join.run(1024, 16, 32, 8, mp, device="cpu")
             for mp in (False, True)]
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    with mesh.tallying() as tally:
        mesh.send(torch.zeros(3, 5), "pod", 1)
    return recs, joins, tally
