"""The dry-run of the production meshes on the CPU (``launch/dryrun.py``,
``launch/dryrun_join.py``, ``launch/collectives.py``): rank 0 of 16×16 and
2×16×16 in torch's fake process-group backend, in a child process of its
own (a process holds one default group), at smoke widths (MoE experts
widened to 16, so that they divide the model axis) and short sequences
(``torch_dist_ranks.DRYRUN_SEQ``; the global batches kept).

* Every (arch × shape) cell on both meshes is ``ok`` or skipped, and the
  skipped set is the reference's design matrix (``tests/test_launch.py``:
  the seven ``long_500k`` cells of full-attention archs).
* Each record's parameter-part bytes are the sum of the parts
  ``param_shardings`` gives the rank, and its tokens and chips are the
  reference's.
* The join superstep runs on both meshes, E / world edges a rank.
* ``collective_bytes`` of a tally equals the reference's
  ``hlo_analysis.collective_bytes`` of the same collectives written as HLO
  lines, kind by kind, but for a reduce-scatter, which the reference's
  parser prices from its scattered output, n times lower.
* Each flag changes what it should: ``--moe-a2a`` puts all-to-alls in the
  tally; ``--dp-over-model`` leaves no reduction over ``model`` alone;
  ``--fsdp`` adds gathers over ``data``; ``--capacity-data`` shares the
  MoE slab over ``pod`` alone instead of (pod, data);
  ``--moe-replicated-dispatch`` and ``--decode-unroll`` change nothing.
"""
import collections
import gzip
import json
import multiprocessing
import os

import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks as R  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import shape_applicable as japplicable  # noqa: E402
from repro.launch.hlo_analysis import collective_bytes as jcoll  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch.collectives import collective_bytes  # noqa: E402

MESHES = ("16x16", "2x16x16")
FLAG_RUNS = [("olmoe-1b-7b", "train_4k", False, {"moe_a2a": True}),
             ("qwen3-0.6b", "train_4k", False, {"dp_over_model": True}),
             ("qwen3-0.6b", "train_4k", True, {"fsdp": True}),
             ("olmoe-1b-7b", "train_4k", True, {"capacity_data": True}),
             ("olmoe-1b-7b", "decode_32k", True,
              {"moe_replicated_dispatch": True, "decode_unroll": True})]


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    ops_dir = str(tmp_path_factory.mktemp("dryrun_ops"))
    runs = [(a, s, mp, {}) for mp in (False, True) for a in ARCHS
            for s in SHAPES] + FLAG_RUNS
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        recs, joins, send = pool.apply(R.dryrun_suite, (ops_dir, runs))
    base = {(r["arch"], r["shape"], r["mesh"]): r for r in recs
            if r["tag"] == "baseline"}
    flagged = {r["tag"]: r for r in recs if r["tag"] != "baseline"}
    return {"base": base, "flagged": flagged, "joins": joins,
            "send": send, "ops_dir": ops_dir}


def _tally(dry, rec) -> list:
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec['tag']}"
    with gzip.open(os.path.join(dry["ops_dir"], name + ".json.gz"),
                   "rt") as f:
        return json.load(f)["tally"]


@pytest.mark.parametrize("mesh", MESHES)
def test_every_cell_ok_or_design_skip(dry, mesh):
    recs = [r for (a, s, m), r in dry["base"].items() if m == mesh]
    assert len(recs) == len(ARCHS) * len(SHAPES) == 40
    assert all(r["status"] in ("ok", "skipped") for r in recs), [
        (r["arch"], r["shape"], r.get("error")) for r in recs
        if r["status"] not in ("ok", "skipped")]
    skipped = {(r["arch"], r["shape"]) for r in recs
               if r["status"] == "skipped"}
    expected = {(a, "long_500k") for a in
                ("mistral-nemo-12b", "qwen3-0.6b", "chatglm3-6b",
                 "deepseek-moe-16b", "olmoe-1b-7b", "internvl2-26b",
                 "whisper-small")}
    assert skipped == expected
    # the reference's own applicability rule gives the same matrix
    assert skipped == {(a, s) for a in JARCHS for s in JSHAPES
                       if not japplicable(jget_config(a), JSHAPES[s])[0]}


@pytest.mark.parametrize("mesh", MESHES)
def test_records_hold_the_ranks_parts(dry, mesh):
    chips = 256 if mesh == "16x16" else 512
    for (arch, shape, m), r in dry["base"].items():
        if m != mesh or r["status"] != "ok":
            continue
        spec = SHAPES[shape]
        assert r["memory"]["params_bytes"] == r["expected_params_bytes"]
        assert r["chips"] == chips
        assert r["tokens"] == (spec.global_batch if spec.kind == "decode"
                               else spec.global_batch * R.DRYRUN_SEQ[shape])
        assert (r["memory"]["cache_bytes"] > 0) == (spec.kind == "decode")
        assert (r["memory"]["opt_bytes"] > 0) == (spec.kind == "train")
        assert r["op_cost"]["flops"] > 0 and r["step_s"] > 0
        assert r["collectives"]["total_traffic_bytes"] == \
            r["op_cost"]["collective_traffic_bytes"]
        assert r["roofline"]["collective_s"] == r["collective_s"]


@pytest.mark.parametrize("i", [0, 1])
def test_join_superstep_on_both_meshes(dry, i):
    rec = dry["joins"][i]
    world = 256 if i == 0 else 512
    assert rec["status"] == "ok" and rec["chips"] == world
    assert rec["rank_edges"] == 1024 // world
    assert rec["op_cost"]["kernels"] == {}   # the CPU runs the plain verify
    assert rec["collectives"]["total_traffic_bytes"] == 0
    # rank 0's edges are the first E / world of the superstep
    from repro_torch.core.distributed import verify_edges
    from repro_torch.launch.census_join import EPS, make_superstep
    slab, eidx = make_superstep(1024, 16, 32, 8, device="cpu")
    per = 1024 // world
    assert rec["pairs"] == int(verify_edges(slab, eidx[:per],
                                            EPS)[0].sum())


_ELEM_BYTES = {"bf16": 2, "f16": 2, "f32": 4, "s64": 8, "s32": 4, "s8": 1,
               "u8": 1, "pred": 1, "f64": 8}


def _hlo_line(i: int, e: dict, world: int) -> str:
    """One tally entry as a post-SPMD HLO line: its result type and its
    group size in ``replica_groups``. A reduce-scatter's result is its
    scattered output, 1/n of the input the entry holds."""
    size = _ELEM_BYTES[e["dtype"]]
    assert e["bytes"] % size == 0
    elems = e["bytes"] // size
    if e["kind"] == "reduce-scatter":
        assert elems % e["n"] == 0
        elems //= e["n"]
    return (f"  %op.{i} = {e['dtype']}[{elems}]{{0}} {e['kind']}(%p.{i}), "
            f"replica_groups=[{world // e['n']},{e['n']}]<=[{world}]")


def test_collective_bytes_matches_reference_parser(dry):
    """The same traffic as the reference's parser kind by kind, but for a
    reduce-scatter: the parser reads an op's bytes from its result type,
    which for a reduce-scatter is the scattered output, so it prices the
    op n times lower than the traffic model both modules state (input
    bytes × (n−1)/n), which ``collective_bytes`` follows; that factor is
    asserted op by op."""
    tallies = []
    for (arch, shape, mesh), r in sorted(dry["base"].items()):
        if r["status"] == "ok" and arch in ("qwen3-0.6b", "olmoe-1b-7b",
                                            "whisper-small"):
            tallies.append((_tally(dry, r), r["chips"]))
    for r in dry["flagged"].values():
        tallies.append((_tally(dry, r), r["chips"]))
    tallies.append((dry["send"], 512))
    kinds = set()
    for tally, world in tallies:
        ours = collective_bytes(tally, world)
        lines = [_hlo_line(i, e, world) for i, e in enumerate(tally)]
        ref = jcoll("\n".join(lines), world)
        for kind, rec in ref.items():
            if isinstance(rec, dict) and kind != "reduce-scatter":
                assert ours[kind] == rec, kind
            if isinstance(rec, dict) and rec["count"]:
                kinds.add(kind)
        assert ours["reduce-scatter"]["count"] == \
            ref["reduce-scatter"]["count"]
        for e, line in zip(tally, lines):
            if e["kind"] != "reduce-scatter":
                continue
            one = collective_bytes([e], world)["reduce-scatter"]
            theirs = jcoll(line, world)["reduce-scatter"]
            assert theirs["bytes"] * e["n"] == one["bytes"]
            assert 0 <= one["traffic_bytes"] - theirs["traffic_bytes"] \
                * e["n"] < e["n"]
    assert kinds == {"all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute"}


def test_flag_moe_a2a_puts_all_to_alls_in_the_tally(dry):
    a2a = _tally(dry, dry["flagged"]["baseline+moe_a2a"])
    base = _tally(dry, dry["base"][("olmoe-1b-7b", "train_4k", "16x16")])
    assert any(e["kind"] == "all-to-all" for e in a2a)
    assert not any(e["kind"] == "all-to-all" for e in base)


def test_flag_dp_over_model_removes_model_reductions(dry):
    dp = _tally(dry, dry["flagged"]["baseline+dp_over_model"])
    base = _tally(dry, dry["base"][("qwen3-0.6b", "train_4k", "16x16")])
    assert any(e["kind"] == "all-reduce" and e["axes"] == ["model"]
               for e in base)
    assert not any(e["kind"] == "all-reduce" and e["axes"] == ["model"]
                   for e in dp)
    assert dry["flagged"]["baseline+dp_over_model"]["batch_axes"] == \
        ["data", "model"]


def test_flag_fsdp_adds_gathers_over_data(dry):
    fsdp = _tally(dry, dry["flagged"]["fsdp"])
    base = _tally(dry, dry["base"][("qwen3-0.6b", "train_4k", "2x16x16")])
    assert any(e["kind"] == "all-gather" and e["axes"] == ["data"]
               for e in fsdp)
    assert not any(e["kind"] == "all-gather" and e["axes"] == ["data"]
                   for e in base)
    assert dry["flagged"]["fsdp"]["memory"]["params_bytes"] < \
        dry["base"][("qwen3-0.6b", "train_4k", "2x16x16")]["memory"][
            "params_bytes"]


def test_flag_capacity_data_cuts_the_slab_over_data(dry):
    """The baseline's slab is the reference's, replicated over the batch
    axes: each MoE layer gathers its expert ids (s64) over (pod, data)
    and sums its slab over them, forward, in remat's recompute and
    backward. ``--capacity-data`` cuts the capacity over ``data``: on
    2×16×16 those ops run over ``pod`` alone, on a slab of fewer slots,
    and nothing else changes."""
    rec = dry["flagged"]["baseline+capacity_data"]
    base = dry["base"][("olmoe-1b-7b", "train_4k", "2x16x16")]
    assert rec["status"] == base["status"] == "ok"
    assert rec["flags"]["capacity_data"]
    tb, tf = _tally(dry, base), _tally(dry, rec)

    def ops(tally, axes):
        return collections.Counter((e["kind"], e["dtype"]) for e in tally
                                   if e["axes"] == axes)
    moved = ops(tb, ["pod", "data"]) - ops(tf, ["pod", "data"])
    assert moved == ops(tf, ["pod"]) and not ops(tb, ["pod"])
    assert moved[("all-gather", "s64")] > 0
    assert any(kind == "all-reduce" for kind, _ in moved)

    def summed(tally, axes):
        return sum(e["bytes"] for e in tally if e["kind"] == "all-reduce"
                   and e["axes"] == axes)
    slab_base = summed(tb, ["pod", "data"]) - summed(tf, ["pod", "data"])
    assert slab_base > summed(tf, ["pod"]) > 0
    assert rec["op_cost"]["flops"] < base["op_cost"]["flops"]


def test_recorded_flags_change_no_dataflow(dry):
    """``--moe-replicated-dispatch`` and ``--decode-unroll`` are recorded
    (tag and ``flags``) and change nothing: the first installs an empty
    rule in the reference too, and the port's layer loop is the same
    under the second."""
    rec = dry["flagged"]["baseline+decode_unroll+moe_replicated_dispatch"]
    base = dry["base"][("olmoe-1b-7b", "decode_32k", "2x16x16")]
    assert rec["flags"]["decode_unroll"] and \
        rec["flags"]["moe_replicated_dispatch"]
    assert _tally(dry, rec) == _tally(dry, base)
