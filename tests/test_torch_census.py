"""The census of one card (``repro_torch.launch``: ``roofline``,
``op_cost``, ``steps.prepare_cell``, ``census``, ``census_join``) against
the JAX package's dry-run on the CPU: the model-FLOP formula and the
pass-through of skipped and partial records, the H100 roofline terms, the
op census's counting rules, the FLOPs of the smoke configs' steps against
``hlo_cost.analyze_hlo`` of the reference's compiled steps, the design
skips, the per-card batch, the static memory reckoning, whole records on
the CPU, the join superstep against the reference's ``verify_edges``, and
the results file. No kernel and no card."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core.distributed import verify_edges as jverify_edges  # noqa
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.launch.steps import lower_cell  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, get_config,  # noqa: E402
                                 smoke_config)
from repro_torch.core.distributed import verify_edges  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import census, census_join, roofline  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402
from repro_torch.launch.steps import (per_card_batch,  # noqa: E402
                                      prepare_cell)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402

# tests/test_launch.py's design matrix: the reference's skipped cells
DESIGN_SKIPS = {(a, "long_500k") for a in
                ("mistral-nemo-12b", "qwen3-0.6b", "chatglm3-6b",
                 "deepseek-moe-16b", "olmoe-1b-7b", "internvl2-26b",
                 "whisper-small")}
STATIC_TRAIN_SKIPS = {"deepseek-moe-16b", "internvl2-26b",
                      "mistral-nemo-12b"}
SMOKE_B, SMOKE_S = 2, 64     # the smoke steps' (B, S)


def _records():
    """Census-style records of every kind the roofline reads: ok train /
    prefill / decode and a join superstep, a skip, a partial ok (no
    cost), an error."""
    cost = {"flops": 4.0e12, "bytes": 2.0e10,
            "flops_by_dtype": {"bfloat16": 4.0e12},
            "work_flops": 4.0e12, "work_flops_by_dtype": {"bfloat16": 4.0e12},
            "collective_traffic_bytes": 0}
    base = dict(mesh="1", tag="baseline", chips=1, status="ok")
    return [
        dict(base, arch="qwen3-0.6b", shape="train_4k", step="train_step",
             active_params=596049920, tokens=4096, op_cost=cost,
             hlo_cost=cost, live_bytes=6e9, step_s=0.5, fits_card=True),
        dict(base, arch="qwen3-0.6b", shape="prefill_32k",
             step="prefill_step", active_params=596049920, tokens=32768,
             op_cost=cost, hlo_cost=cost, live_bytes=1.2e9, step_s=0.9,
             fits_card=True),
        dict(base, arch="qwen3-0.6b", shape="decode_32k", step="serve_step",
             active_params=596049920, tokens=1, op_cost=cost, hlo_cost=cost,
             live_bytes=5e9, step_s=0.04, fits_card=True),
        dict(base, arch="diskjoin-verify", shape="E4096_cap1024_d128",
             step="join_superstep", params=512 * 1024 * 128,
             active_params=512 * 1024 * 128, tokens=4096, op_cost=cost,
             hlo_cost=cost, live_bytes=2.7e8, step_s=0.02, fits_card=True),
        dict(arch="qwen3-0.6b", shape="long_500k", mesh="1", tag="baseline",
             status="skipped", reason="pure full-attention arch"),
        dict(arch="gemma3-4b", shape="train_4k", mesh="1", tag="baseline",
             status="ok", step="train_step", active_params=1, tokens=1,
             chips=1),
        dict(arch="olmoe-1b-7b", shape="train_4k", mesh="1", tag="baseline",
             status="error", error="OutOfMemoryError: CUDA out of memory",
             chips=1),
    ]


@pytest.mark.parametrize("i", range(4))
def test_model_flops_equal_the_reference(i):
    rec = _records()[i]
    assert roofline.model_flops_per_device(rec) == \
        jroofline.model_flops_per_device(rec)


def test_join_record_keeps_the_reference_convention():
    """2·W·cap·d·E for a superstep, not the verify's 2·E·cap²·d."""
    rec = _records()[3]
    assert roofline.model_flops_per_device(rec) == 2.0 * 512 * 1024 * 128 \
        * 4096


def test_pass_through_equals_the_reference(tmp_path):
    """Skipped records pass through as the reference's ``analyze`` passes
    them; partial and failed ones are left out by both."""
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(_records()))
    ours = [r for r in roofline.analyze(str(path)) if "dominant" not in r]
    theirs = [r for r in jroofline.analyze(str(path))
              if "dominant" not in r]
    assert ours == theirs and len(ours) == 1
    assert len(roofline.analyze(str(path))) == 5


def test_roofline_terms_are_the_h100s():
    """Hand-computed terms: bf16 at 989 TFLOP/s, float32 at 67, 3×TF32 as
    three TF32 products at 494.7, each over the work count (a masked
    attention's dense count is not priced); bytes plus the live-argument
    pass at 3.35 TB/s; no collective term. The useful ratio is over the
    dense count, the reference's; mfu only for train and prefill steps."""
    rec = dict(_records()[0])
    rec["op_cost"] = {"flops": 5e12, "bytes": 1e10,
                      "flops_by_dtype": {"bfloat16": 3e12, "float32": 1e12,
                                         "tf32x3": 1e12},
                      "work_flops": 3e12,
                      "work_flops_by_dtype": {"bfloat16": 1e12,
                                              "float32": 1e12,
                                              "tf32x3": 1e12}}
    t = roofline.roofline_terms(rec)
    compute = 1e12 / 989e12 + 1e12 / 67e12 + 3e12 / 494.7e12
    memory = (1e10 + 6e9) / 3.35e12
    model = 6.0 * 596049920 * 4096
    assert t["compute_s"] == pytest.approx(compute, rel=1e-12)
    assert t["memory_s"] == pytest.approx(memory, rel=1e-12)
    assert t["collective_s"] == 0.0
    assert t["dominant"] == "compute"
    assert t["step_time_lb_s"] == pytest.approx(compute, rel=1e-12)
    assert t["hlo_flops_per_dev"] == 5e12
    assert t["useful_flops_ratio"] == pytest.approx(model / 5e12)
    assert t["roofline_fraction"] == pytest.approx(model / 989e12 / compute)
    assert t["mfu"] == pytest.approx(model / (0.5 * 989e12))
    assert t["fits_card"] is True and "fits_hbm_16g" not in t
    pre = roofline.roofline_terms(_records()[1])
    assert pre["mfu"] == pytest.approx(2.0 * 596049920 * 32768
                                       / (0.9 * 989e12))
    join = roofline.roofline_terms(_records()[3])
    assert "mfu" not in join and "bw_share" not in join
    dec = roofline.roofline_terms(_records()[2])
    assert dec["bw_floor_s"] == pytest.approx(5e9 / 3.35e12)
    assert dec["bw_share"] == pytest.approx(5e9 / 3.35e12 / 0.04)
    assert "mfu" not in dec
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "step_time_lb_s", "model_flops_per_dev",
                "hlo_flops_per_dev", "useful_flops_ratio",
                "roofline_fraction", "bw_floor_s", "bw_fraction"):
        assert key in dec
    assert roofline.to_markdown([t, dec]).count("\n") == 4


def test_op_cost_counts_a_product_and_no_view():
    m, k, n = 24, 40, 8
    a, b = torch.randn(m, k), torch.randn(k, n)
    with OpCost() as oc:
        a @ b
        a.view(k, m).t().reshape(m, k)[:, :3]
    s = oc.summary()
    assert s["flops"] == 2 * m * n * k
    assert s["bytes"] == (m * k + k * n + m * n) * 4
    assert s["by_op"] == {"mm": {"count": 1, "flops": 2 * m * n * k,
                                 "bytes": (m * k + k * n + m * n) * 4}}
    assert s["collective_traffic_bytes"] == 0 and s["kernels"] == {}


def test_op_cost_splits_dtypes():
    a = torch.randn(16, 32)
    b16 = a.to(torch.bfloat16)
    with OpCost() as oc:
        a @ a.T
        b16 @ b16.T
    s = oc.summary()
    assert s["flops_by_dtype"] == {"float32": 2 * 16 * 16 * 32,
                                   "bfloat16": 2 * 16 * 16 * 32}
    assert s["bytes_by_dtype"] == {"float32": (2 * 16 * 32 + 16 * 16) * 4,
                                   "bfloat16": (2 * 16 * 32 + 16 * 16) * 2}


def test_op_cost_sets_the_launch_hook_only_inside(monkeypatch):
    """``ops.COST_HOOK`` is set while the census runs, re-entries for a
    decomposition included, and cleared after it."""
    seen = []
    x = torch.randn(3, 4, requires_grad=True)
    with OpCost() as oc:
        seen.append(ops.COST_HOOK)
        torch.nn.functional.linear(x, torch.randn(5, 4)).sum().backward()
        seen.append(ops.COST_HOOK)
    assert seen == [oc._kernel, oc._kernel] and ops.COST_HOOK is None
    oc._kernel("flash_attention", "flash_attention", (1, 2, 2, 1, 1, 16),
               "bfloat16", "tc")
    k = oc.summary()["kernels"]["flash_attention"]
    assert k == {"launches": 1, "flops": 4 * 2 * 2 * 16,
                 "work_flops": 4 * 2 * 2 * 16,
                 "bytes": 2 * (2 * 2 * 16 + 2 * 2 * 16),
                 "routes": {"tc": 1}}


@pytest.mark.parametrize("causal,window,q_offset,rolling", [
    (True, 0, 0, False), (True, 0, 5, False), (False, 0, 0, False),
    (True, 3, 2, False), (False, 4, 6, False), (True, 4, 9, True),
    (True, 0, 9, True)])
def test_attention_counts_equal_the_mask(causal, window, q_offset, rolling):
    """``roofline.attention_counts`` counts what ``ref.gqa_mask`` lets
    through: the pairs, and the keys some query sees; rolling caches with
    empty slots (−1) and positions out of order included."""
    sq, t = 4, 10
    pos = (torch.tensor([8, 9, -1, 3, 4, 5, 6, 7, -1, 2]) if rolling
           else torch.arange(t))
    mask = ref.gqa_mask(sq, pos, causal=causal, window=window,
                        q_offset=q_offset)
    got = roofline.attention_counts(
        sq, t, causal=causal, window=window, q_offset=q_offset,
        positions=pos.numpy() if rolling else None)
    assert got == {"visible": int(mask.sum()),
                   "keys": int(mask.any(0).sum()),
                   "pos_bytes": 4 * t if rolling else 0}


def test_attention_counts_equal_the_mask_on_random_caches():
    """The same on 200 seeded random calls: rolling caches with empty
    slots, windows, offsets, causal or not, Sq up to 12, T up to 40."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        sq, t = int(rng.integers(1, 13)), int(rng.integers(1, 41))
        causal, window = bool(rng.integers(2)), int(rng.integers(0, 9))
        q_offset = int(rng.integers(0, 50))
        pos = rng.permutation(np.arange(t) + int(rng.integers(0, 30)))
        pos[rng.random(t) < 0.2] = -1
        mask = ref.gqa_mask(sq, torch.from_numpy(pos), causal=causal,
                            window=window, q_offset=q_offset)
        got = roofline.attention_counts(sq, t, causal=causal, window=window,
                                        q_offset=q_offset, positions=pos)
        assert (got["visible"], got["keys"]) == \
            (int(mask.sum()), int(mask.any(0).sum()))


def test_op_cost_prices_a_masked_kernel_by_its_work():
    """A causal launch counts its dense products (the plain version's) in
    ``flops`` and only the pairs its mask lets through in ``work_flops``;
    reading the positions to the host is not counted."""
    b, sq, t, h, hkv, d = 2, 6, 10, 4, 2, 16
    pos = torch.tensor([8, 9, -1, 3, 4, 5, 6, 7, -1, 2])
    mask = dict(causal=True, window=0, q_offset=4, kv_positions=pos)
    with OpCost() as oc:
        ops.COST_HOOK("flash_attention", "flash_attention",
                      (b, sq, t, h, hkv, d), "bfloat16", "tc", mask)
    s = oc.summary()
    visible = int(ref.gqa_mask(sq, pos, causal=True, window=0,
                               q_offset=4).sum())
    assert visible < sq * t
    assert s["flops"] == s["flops_by_dtype"]["bfloat16"] == \
        4 * b * h * d * sq * t
    assert s["work_flops"] == s["work_flops_by_dtype"]["bfloat16"] == \
        4 * b * h * d * visible
    assert list(s["by_op"]) == ["flash_attention"]
    assert s["kernels"]["flash_attention"]["work_flops"] == s["work_flops"]


def test_op_cost_counts_every_loop_trip():
    """The eager analogue of tests/test_launch.py::test_nested_scan: a
    Python loop of 15 products counts 15 products."""
    x, w = torch.randn(4, 8), torch.randn(8, 8)
    with OpCost() as one:
        x @ w
    with OpCost() as loop:
        for _ in range(3):
            for _ in range(5):
                x = x @ w
    assert loop.summary()["flops"] == 15 * one.summary()["flops"] == \
        15 * 2 * 4 * 8 * 8


# ---------------------------------------------------------------------------
# the hand-written kernels' cost: kernel_cost's plain_flops is what the plain
# version counts on the CPU
# ---------------------------------------------------------------------------
def _counted(fn) -> int:
    with OpCost() as oc:
        fn()
    return oc.summary()["flops"]


@pytest.mark.parametrize("shape", [(2, 12, 12, 4, 2, 16), (1, 1, 40, 6, 3, 32),
                                   (3, 5, 9, 2, 1, 16)])
def test_kernel_cost_equals_the_plain_versions_count(shape):
    b, sq, t, h, hkv, d = shape
    g = torch.Generator().manual_seed(sum(shape))
    q = torch.randn(b, sq, h, d, generator=g)
    k, v = (torch.randn(b, t, hkv, d, generator=g) for _ in range(2))
    kw = dict(causal=True, q_offset=t - sq)
    out = ref.gqa_attention(q, k, v, **kw)
    assert _counted(lambda: ref.gqa_attention(q, k, v, **kw)) == \
        roofline.kernel_cost("flash_attention", shape)["plain_flops"]
    assert _counted(lambda: ref.gqa_attention_bwd(q, k, v, out, out, **kw)) \
        == roofline.kernel_cost("flash_attention_bwd", shape)["plain_flops"]
    e, m, n, dd = b, sq, t, d
    u, w = torch.randn(e, m, dd), torch.randn(e, n, dd)
    assert _counted(lambda: ref.pairwise_l2_threshold(u, w, 1.0)) == \
        roofline.kernel_cost("verify", (e, m, n, dd))["plain_flops"]
    assert _counted(lambda: ref.bucket_assign(u[0], w[0])) == \
        roofline.kernel_cost("bucket_assign", (m, n, dd))["plain_flops"]


def test_kernel_cost_classes_and_bound():
    bf = roofline.kernel_cost("flash_attention", (1, 8, 8, 2, 1, 64),
                              "bfloat16", "split")
    assert set(bf["flops"]) == {"bfloat16"}
    f32 = roofline.kernel_cost("flash_attention", (1, 8, 8, 2, 1, 64),
                               "float32", "tc32")
    assert set(f32["flops"]) == {"tf32x3"}
    assert set(roofline.kernel_cost("verify", (2, 8, 8, 4), route="simt")
               ["flops"]) == {"float32"}
    c = roofline.kernel_cost("verify", (4096, 1024, 1024, 128))
    ms, by = roofline.kernel_bound(c)
    t_ops = 3 * 2.0 * 4096 * 1024 * 1024 * 128 / 494.7e12
    assert by == "bytes" and c["bytes"] / 3.35e12 > t_ops
    assert ms == c["bytes"] / 3.35e12 * 1e3
    # the operations side, each class at its own rate, to the bit
    (f,) = bf["flops"].values()
    assert roofline.kernel_bound(dict(bf, bytes=0.0)) == \
        (f / 989e12 * 1e3, "operations")
    (f,) = f32["flops"].values()
    assert roofline.kernel_bound(dict(f32, bytes=0.0)) == \
        (3.0 * f / 494.7e12 * 1e3, "operations")
    masked = roofline.kernel_cost("flash_attention", (1, 4, 4, 2, 1, 16),
                                  visible=10, keys=4)
    assert masked["flops"]["tf32x3"] == 4.0 * 2 * 16 * 10
    assert masked["plain_flops"] == 4 * 2 * 16 * 16


# ---------------------------------------------------------------------------
# the smoke configs' steps against the reference's compiled steps
# ---------------------------------------------------------------------------
def _reference_flops(arch: str, shape_name: str) -> float:
    cfg = jsmoke_config(jget_config(arch))
    shape = dataclasses.replace(JSHAPES[shape_name], seq_len=SMOKE_S,
                                global_batch=SMOKE_B)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh:
        lowered, _ = lower_cell(jbuild_model(cfg), shape, mesh)
        text = lowered.compile().as_text()
    return analyze_hlo(text)["flops"]


def _port_census(arch: str, shape_name: str) -> dict:
    """The port's step at (B 2, S 64) on the CPU under ``OpCost``
    (``global_batch`` 2 × 256: the per-card rule gives 2 sequences)."""
    cfg = smoke_config(get_config(arch))
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=SMOKE_S,
                                global_batch=SMOKE_B * 256)
    step, args, _ = prepare_cell(build_model(cfg, device="cpu"), shape,
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    with OpCost() as oc:
        step(*args)
    assert ops.COST_HOOK is None    # gone after the census, decompositions
    return oc.summary()             # and all


FLOP_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "mamba2-1.3b")


@pytest.mark.parametrize("arch", FLOP_ARCHS)
@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_forward_flops_equal_analyze_hlo(arch, shape_name):
    assert _port_census(arch, shape_name)["flops"] == \
        _reference_flops(arch, shape_name)


def train_excess(arch: str) -> dict:
    """The train step's FLOPs beyond the reference's, by cause, at (B, S):

    * ``chunked_xent``'s checkpoint recomputes each loss chunk's float32
      logits product in the backward pass (one ``mm`` of (B·S', d) ×
      (d, V), S' = S − 1); the reference's ``lax.scan`` keeps the chunk's
      residuals instead;
    * ``ref.gqa_attention_bwd`` (the flash kernel's plain backward, what
      ``_GQAAttention`` runs) recomputes S = Q·Kᵀ from q and k (a
      ``bmm``, 2·B·H·S²·D) and forms δ = rowsum(dO∘O) as an einsum
      (a ``bmm``, 2·B·S·H·D) a layer, where autodiff of the reference's
      attention keeps P;
    * less: the reference's SSD einsums take the decays ``tail`` and
      ``inner`` as third operands, so their gradients are products (two
      contractions of 2·B·S·H·N a layer); the port scales B and C by
      them first, and autograd forms those gradients by ``mul`` and
      ``sum``, which count no FLOPs."""
    cfg = smoke_config(get_config(arch))
    b, s = SMOKE_B, SMOKE_S
    out = {"mm: loss chunk logits recomputed":
           2 * b * (s - 1) * cfg.d_model * cfg.vocab}
    kinds = layer_kinds(cfg)
    n_attn = sum(k in ("global", "local") for k in kinds)
    if n_attn:
        h, d = cfg.n_heads, cfg.head_dim
        out["bmm: attention backward recomputes S"] = \
            n_attn * 2 * b * h * s * s * d
        out["bmm: attention backward's delta"] = n_attn * 2 * b * s * h * d
    n_ssm = sum(k == "ssm" for k in kinds)
    if n_ssm:
        d_inner = cfg.ssm.expand * cfg.d_model
        heads = d_inner // cfg.ssm.head_dim
        out["less: SSD decay gradients as mul + sum"] = \
            -n_ssm * 2 * 2 * b * s * heads * cfg.ssm.state_dim
    return out


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_train_flops_within_ten_percent_with_the_excess_named(arch):
    port = _port_census(arch, "train_4k")
    want = _reference_flops(arch, "train_4k")
    assert 1.00 <= port["flops"] / want <= 1.10
    excess = train_excess(arch)
    assert port["flops"] - sum(excess.values()) == want
    # the named products are the ops that carry them
    assert port["by_op"]["mm"]["flops"] >= \
        excess["mm: loss chunk logits recomputed"]
    if "bmm: attention backward recomputes S" in excess:
        assert port["by_op"]["bmm"]["flops"] >= \
            excess["bmm: attention backward recomputes S"]


# ---------------------------------------------------------------------------
# the census's cells
# ---------------------------------------------------------------------------
class _Applicable(Exception):
    pass


def test_design_skips_equal_the_reference(monkeypatch):
    """``run_cell`` skips exactly the reference's design matrix, before it
    touches a device (the cells past it reach ``resolve_device``)."""
    def applicable(device):
        raise _Applicable

    monkeypatch.setattr(census, "resolve_device", applicable)
    skips = set()
    for arch in ARCHS:
        for shape in SHAPES:
            try:
                rec = census.run_cell(arch, shape)
            except _Applicable:
                continue
            assert rec["status"] == "skipped" and rec["mesh"] == "1"
            skips.add((arch, shape))
    assert skips == DESIGN_SKIPS
    from repro.configs import shape_applicable as jshape_applicable
    assert {(a, s) for a in ARCHS for s in SHAPES
            if not jshape_applicable(jget_config(a), JSHAPES[s])[0]} \
        == DESIGN_SKIPS


@pytest.mark.parametrize("global_batch,want", [(256, 1), (32, 1), (128, 1),
                                               (1, 1), (512, 2), (1024, 4),
                                               (300, 1)])
def test_per_card_batch(global_batch, want):
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=global_batch)
    assert per_card_batch(shape) == want


def test_static_reckoning_skips_the_big_train_cells(monkeypatch):
    """12 B a bf16 parameter for training; the three largest archs exceed
    one 80 GB card before any activation. Nothing is built for them."""
    monkeypatch.setattr(census, "build_model", None)
    skipped = set()
    for arch in ARCHS:
        st = census.static_bytes(get_config(arch), SHAPES["train_4k"])
        if st["total"] > census.NOMINAL_CARD_BYTES:
            skipped.add(arch)
            rec = census.run_cell(arch, "train_4k", device="cpu")
            assert rec["status"] == "skipped"
            assert rec["reason"].startswith("exceeds one card:")
    assert skipped == STATIC_TRAIN_SKIPS
    ds = census.static_bytes(get_config("deepseek-moe-16b"),
                             SHAPES["train_4k"])
    assert ds["total"] == 12 * get_config("deepseek-moe-16b").param_count()


def test_cache_bytes_match_the_allocated_caches():
    cfg = smoke_config(get_config("gemma3-4b"))
    bundle = build_model(cfg, device="cpu")
    caches = bundle.init_cache(1, 96)
    assert census.cache_bytes(cfg, 1, 96) == census.tree_bytes(caches)
    wcfg = smoke_config(get_config("whisper-small"))
    wb = build_model(wcfg, device="cpu")
    wc = wb.init_cache(1, 40, params=wb.init(0))
    assert census.cache_bytes(wcfg, 1, 40) == census.tree_bytes(wc)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_the_reference(arch):
    jb = jbuild_model(jget_config(arch))
    pb = build_model(get_config(arch), device="cpu")
    for name in SHAPES:
        ours = pb.input_specs(SHAPES[name])
        theirs = jb.input_specs(JSHAPES[name])
        assert list(ours) == list(theirs)
        for k, (shape, dtype) in ours.items():
            assert shape == theirs[k].shape
            assert str(dtype).removeprefix("torch.") == \
                jnp.dtype(theirs[k].dtype).name


def test_decode_cell_repeats_the_last_step():
    """The decode cell's cache holds seq_len − 1 positions; every call is
    that same step, so two calls give the same logits."""
    cfg = smoke_config(get_config("gemma3-4b"))
    shape = dataclasses.replace(SHAPES["long_500k"], seq_len=80)
    bundle = build_model(cfg, device="cpu")
    step, args, info = prepare_cell(bundle, shape, device="cpu",
                                    generator=torch.Generator().manual_seed(1))
    assert info == {"kind": "serve_step"}
    first = step(*args)[0].clone()
    caches = args[1]
    for c, kind in zip(caches, layer_kinds(cfg)):
        n = c["kpos"].shape[0]
        assert n == (min(80, cfg.window) if kind == "local" else 80)
        assert int(c["kpos"].max()) == 79 and int(c["kpos"].min()) >= 0
    assert torch.equal(step(*args)[0], first)


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "prefill_32k"),
    ("qwen3-0.6b", "decode_32k"), ("whisper-small", "decode_32k"),
    ("internvl2-26b", "prefill_32k")])
def test_run_cell_on_the_cpu_gives_a_whole_record(arch, shape_name,
                                                  monkeypatch):
    cfg = smoke_config(get_config(arch))
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=32,
                                global_batch=2)
    monkeypatch.setattr(census, "get_config", lambda a: cfg)
    monkeypatch.setattr(census, "SHAPES", {shape_name: shape})
    monkeypatch.setattr(census, "TIMED_STEPS", 2)
    rec = census.run_cell(arch, shape_name, device="cpu")
    for key in ("arch", "shape", "mesh", "tag", "chips", "status", "step",
                "params", "active_params", "tokens", "pod_batch",
                "per_card_batch", "card", "power_limit", "card_bytes",
                "static_bytes", "live_bytes", "op_cost", "step_s",
                "step_times_s", "device_s", "top_kernels", "peak_bytes",
                "fits_card", "elapsed_s", "roofline"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["mesh"] == "1" and rec["chips"] == 1
    assert rec["pod_batch"] == 2 and rec["per_card_batch"] == 1
    assert rec["tokens"] == (1 if shape.kind == "decode" else 32)
    r = rec["roofline"]
    assert r["hlo_flops_per_dev"] == rec["op_cost"]["flops"] > 0
    # no kernel on the CPU: the work count is the dense one
    assert rec["op_cost"]["work_flops"] == rec["op_cost"]["flops"]
    assert ("mfu" in r) == (shape.kind != "decode")
    assert rec["step_s"] > 0 and len(rec["step_times_s"]) == 2
    assert census.record_line(rec).startswith(f"[census] {arch}")


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        census.run_cell("qwen3-0.6b", "decode_32k")
    with pytest.raises(RuntimeError, match="CUDA"):
        census_join.run(8, 8, 8, 4)


# ---------------------------------------------------------------------------
# the join superstep
# ---------------------------------------------------------------------------
def test_join_superstep_counts_equal_the_reference():
    e, cap, d, w = 48, 24, 16, 6
    slab, eidx = census_join.make_superstep(e, cap, d, w, device="cpu")
    counts, mask, d2 = verify_edges(slab, eidx, census_join.EPS)
    jc, jm, _ = jverify_edges(jnp.asarray(slab.numpy()), jnp.asarray(eidx),
                              census_join.EPS ** 2)
    assert np.array_equal(np.asarray(jc), counts.numpy())
    assert np.array_equal(np.asarray(jm), mask.numpy())
    assert counts.sum() > 0 and (counts == 0).any()


def test_join_census_counts_the_verify_work(monkeypatch):
    e, cap, d, w = 32, 16, 8, 4
    monkeypatch.setattr(census, "TIMED_STEPS", 1)
    rec = census_join.run(e, cap, d, w, device="cpu")
    assert rec["status"] == "ok" and rec["step"] == "join_superstep"
    assert rec["op_cost"]["by_op"]["bmm"]["flops"] == 2 * e * cap * cap * d
    assert rec["op_cost"]["flops"] == 2 * e * cap * cap * d
    assert rec["active_params"] == w * cap * d and rec["tokens"] == e
    assert 0 < rec["pairs"] < e * cap * cap
    assert rec["roofline"]["model_flops_per_dev"] == 2.0 * w * cap * d * e
    assert "mfu" not in rec["roofline"] and rec["steps_run"] == 4


# ---------------------------------------------------------------------------
# the results file
# ---------------------------------------------------------------------------
def test_append_result_and_resume(tmp_path, monkeypatch):
    path = str(tmp_path / "out" / "census.json")
    rec = dict(arch="a", shape="s", mesh="1", tag="baseline",
               status="error", error="x")
    census.append_result(rec, path)
    census.append_result(dict(rec, status="ok"), path)
    rows = census.load_results(path)
    assert rows == [dict(rec, status="ok")]
    assert not os.path.exists(path + ".tmp")
    # every cell already ok or skipped: --resume runs none of them
    for arch in ARCHS:
        for shape in SHAPES:
            census.append_result(dict(arch=arch, shape=shape, mesh="1",
                                      tag="baseline", status="skipped",
                                      reason="r"), path)

    def must_not_run(*a, **k):
        raise AssertionError("a recorded cell ran again")

    monkeypatch.setattr(census, "run_cell", must_not_run)
    census.main(["--all", "--resume", "--out", path])
    assert len(census.load_results(path)) == 41
    # a failed cell is recorded, and the sweep goes on
    monkeypatch.setattr(census, "run_cell", lambda *a, **k: (_ for _ in ())
                        .throw(torch.OutOfMemoryError("CUDA out of memory")))
    census.main(["--arch", "a", "--shape", "s", "--out", path])
    (err,) = [r for r in census.load_results(path) if r["arch"] == "a"]
    assert err["status"] == "error" and "out of memory" in err["error"]
