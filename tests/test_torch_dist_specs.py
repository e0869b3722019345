"""The port's sharding rules and trees against the JAX package's, without
processes: ``dist.sharding.param_shardings`` (from the reference leaves'
names and stacked shapes), ``logical_spec``, ``launch.steps``'
``batch_shardings``, ``cache_shardings`` and ``opt_state_shardings``, each
spec entry equal to the reference's ``PartitionSpec`` entry. The resolvers
read only ``mesh.shape``, so a stub mesh serves on the port's side and an
``AbstractMesh`` on the reference's."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro.train.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (_layer_slices,  # noqa: E402
                                        reference_layout)
from repro_torch.train import AdamW, AdamWConfig  # noqa: E402

ARCHS = list_archs()
MESHES = {  # the issue's meshes, and the two production ones
    "4x2": {"data": 4, "model": 2},
    "2x4x2": {"pod": 2, "data": 4, "model": 2},
    "8": {"data": 8},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def _stub(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _abstract(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


_MODELS = {}


def _pair(arch):
    """(the reference's smoke parameter leaves {path: shape}, the port's
    smoke model on the CPU), built once per arch."""
    if arch not in _MODELS:
        cfg = jsmoke_config(jget_config(arch))
        shapes = jax.eval_shape(jbuild_model(cfg).init,
                                jax.random.PRNGKey(0))
        ref = {"/".join(jshd._key_str(k) for k in path): tuple(leaf.shape)
               for path, leaf in
               jax.tree_util.tree_flatten_with_path(shapes)[0]}
        model = build_model(smoke_config(get_config(arch)),
                            device="cpu").init(0)
        _MODELS[arch] = (ref, model)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_layout_names_every_reference_leaf(arch):
    ref, model = _pair(arch)
    layout = reference_layout(model)
    assert {p: s for p, s, _ in layout.values()} == ref
    assert set(layout) == {n for n, _ in model.named_parameters()}
    for name, (_, shape, stack) in layout.items():
        own = tuple(model.get_parameter(name).shape)
        assert shape == (own if stack is None else (stack[1],) + own)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_reference(arch, mesh, fsdp):
    ref, model = _pair(arch)
    stub = _stub(MESHES[mesh])
    mine = shd.param_shardings(model, stub, fsdp=fsdp)
    layout = reference_layout(model)
    for name, (path, shape, _) in layout.items():
        want = tuple(jshd._param_spec(stub, path, ref[path], fsdp=fsdp))
        assert mine[name].spec == want, (name, path)


def test_fsdp_shards_embedding_over_model_and_data():
    """The reference's FSDP oracle (tests/test_multidevice.py)."""
    _, model = _pair("chatglm3-6b")
    spec = shd.param_shardings(model, _stub(MESHES["4x2"]),
                               fsdp=True)["embed"].spec
    assert "model" in spec and "data" in spec, spec


LOGICAL_CASES = [
    ((8, 16, 64), ("batch", "seq", "embed"), {}),
    ((8, 16, 4, 32), ("batch", None, "heads", None), {}),
    ((6, 16, 4, 32), ("batch", None, "kv_heads", None), {}),
    ((8, 512), ("batch", "vocab"), {}),
    ((8, 64, 2, 32), ("batch", "cache_seq", "kv_heads", None),
     {"cache_seq": ("model",)}),
    ((1, 64, 2, 32), ("batch", "cache_seq", "kv_heads", None),
     {"cache_seq": ("data", "model")}),
    ((16, 8, 128), ("experts", "capacity", "embed"), {}),
    ((8, 16), ("batch", None), {"batch": "data"}),
    ((8, 16), ("batch",), {"batch": None}),
    ((4, 6), ("mlp", "heads"), {}),
]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", range(len(LOGICAL_CASES)))
def test_logical_spec_equals_reference(mesh, case):
    shape, axes, rules = LOGICAL_CASES[case]
    with jshd.axis_rules(**rules), shd.axis_rules(**rules):
        want = jshd.logical_spec(_abstract(MESHES[mesh]), shape, *axes).spec
        got = shd.logical_spec(_stub(MESHES[mesh]), shape, *axes).spec
    assert got == tuple(want)


def test_rules_and_flags_as_reference():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    for v in (None, False, True, "model", ("pod", "data")):
        assert shd._tuplize(v) == jshd._tuplize(v)
    assert not shd.has_rule("moe_a2a")
    with shd.axis_rules(moe_a2a=True):
        assert shd.has_rule("moe_a2a")
    assert not shd.has_rule("moe_a2a")
    x = torch.ones(2, 3)
    assert shd.shard(x, "batch", None) is x


TREE_SHAPES = [ShapeSpec("t", 32, 8, "train"), ShapeSpec("p", 32, 8,
                                                         "prefill"),
               ShapeSpec("d", 32, 8, "decode"), ShapeSpec("d1", 32, 1,
                                                          "decode")]


@pytest.mark.parametrize("mesh", ["4x2", "2x4x2", "8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_equal_reference(arch, mesh):
    jb = jbuild_model(jsmoke_config(jget_config(arch)))
    tb = build_model(smoke_config(get_config(arch)), device="cpu")
    for shape in TREE_SHAPES:
        want = jsteps.batch_shardings(_abstract(MESHES[mesh]),
                                      jb.input_specs(shape))
        got = steps.batch_shardings(_stub(MESHES[mesh]),
                                    tb.input_specs(shape))
        assert set(got) == set(want)
        for k in want:
            assert got[k].spec == tuple(want[k].spec), (shape, k)


@pytest.mark.parametrize("mesh", ["4x2", "2x4x2", "8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_equal_reference(arch, mesh):
    jcfg = jsmoke_config(jget_config(arch))
    jb = jbuild_model(jcfg)
    cfg = smoke_config(get_config(arch))
    tb = build_model(cfg, device="cpu")
    b, s = 8, 32
    for rules in ({"cache_seq": ("model",)}, {}):
        with jshd.axis_rules(**rules), shd.axis_rules(**rules):
            if cfg.enc_dec:
                jcache = jsteps._cache_shapes(jb, ShapeSpec("d", s, b,
                                                            "decode"))
                params = tb.init(0)
                caches = tb.init_cache(b, s, params=params)
            else:
                jcache = jax.eval_shape(lambda: jb.init_cache(b, s))
                caches = tb.init_cache(b, s)
            want = jsteps.cache_shardings(_abstract(MESHES[mesh]), jcache)
            got = steps.cache_shardings(_stub(MESHES[mesh]), caches)
        if cfg.enc_dec:
            pairs = [(got["self"][i][k], want["self"][i][k])
                     for i in range(len(got["self"]))
                     for k in got["self"][i]]
            pairs += [(got[k][i], want[k][i]) for k in ("cross_k",
                                                          "cross_v")
                      for i in range(len(got[k]))]
            pairs.append((got["pos"], want["pos"]))
        else:
            pairs = []
            for li, leaves, _ in _layer_slices(cfg, want):
                for k, spec in leaves.items():
                    # the reference's stacked layer dim leads, replicated
                    assert spec.spec[0] is None or k == "pos"
                    ref = tuple(spec.spec)[1:] if k != "pos" else ()
                    pairs.append((got[li][k], types.SimpleNamespace(
                        spec=ref)))
        assert pairs
        for g, w in pairs:
            assert g.spec == tuple(w.spec)


@pytest.mark.parametrize("compress", [False, True])
def test_opt_state_shardings_mirror_params(compress):
    _, model = _pair("qwen3-0.6b")
    stub = _stub(MESHES["4x2"])
    ps = shd.param_shardings(model, stub, fsdp=True)
    opt = AdamW(AdamWConfig(), grad_transform=(lambda g, e: (g, e))
                if compress else None)
    state = opt.init(model)
    got = steps.opt_state_shardings(stub, state, ps)
    assert set(got) == set(state)
    assert got["mu"] == ps and got["nu"] == ps
    assert got["step"].spec == ()
    # the reference's tree has the same keys
    jstate = jax.eval_shape(JAdamW(JAdamWConfig()).init, {"w": np.zeros(2)})
    assert set(got) - {"error"} == set(jstate)


def test_stack_entry_places_a_layer_on_its_owner():
    """A stacked leaf sharded over its layer axis: layer r of R lives whole
    on the ranks whose coordinate along that axis is r // (R / n)."""
    stub = _stub({"data": 2, "model": 2})
    stub.coords = {"data": 1, "model": 0}
    stub.axis_size = lambda axes: int(np.prod([stub.shape[a]
                                               for a in axes]))
    stub.axis_index = lambda axes: stub.coords[axes[0]]
    for pos in range(4):
        s = shd.NamedSharding(stub, ("model", "data", None), (pos, 4))
        assert s.owner() == (("model",), pos // 2)
        assert s.holds() == (pos // 2 == 0)
        assert s.dims == ("data", None)
        full = torch.arange(24.).reshape(4, 6)
        part = s.shard(full)
        if s.holds():
            assert torch.equal(part, full[2:])
        else:
            assert part.numel() == 0


def test_mesh_groups_are_row_major():
    shape = {"pod": 2, "data": 2, "model": 2}
    assert tmesh._ordered_groups(shape, ("model",)) == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    assert tmesh._ordered_groups(shape, ("data",)) == [
        [0, 2], [1, 3], [4, 6], [5, 7]]
    assert tmesh._ordered_groups(shape, ("pod", "data")) == [
        [0, 2, 4, 6], [1, 3, 5, 7]]
    assert tmesh._unravel(5, [2, 2, 2]) == [1, 0, 1]


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="256"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512"):
        tmesh.make_production_mesh(multi_pod=True)


def test_launcher_model_axis_needs_torchrun(monkeypatch):
    from repro_torch.launch import train as launch_train
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                           "cpu", "--model-axis", "2", "--steps", "1"])
