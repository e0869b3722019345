"""The yardstick on the CPU: frozen generators, the plain reference, the
roofline's counts, the reduction of a traced window, the import check."""
import numpy as np
import pytest
import torch

from portbench.yardstick import compare, data, imports, reference, roofline
from portbench.yardstick import trace as tr


def test_clustered_vectors_digest_is_frozen():
    x = data.clustered_vectors(2000, 32, seed=[7, 0])
    assert x.dtype == np.float32 and x.shape == (2000, 32)
    assert compare.digest(x) == "ec9adbeb2e064382"


def test_clustered_vectors_is_the_programs_generator():
    from repro_torch.data.synthetic import clustered_vectors
    for n, d in ((1000, 16), (600, 12)):
        np.testing.assert_array_equal(
            data.clustered_vectors(n, d, seed=[3, 0]),
            clustered_vectors(n, d, seed=[3, 0]))


def test_query_stream_digest_is_frozen_and_chunk_invariant():
    x = data.clustered_vectors(2000, 32, seed=[7, 0])
    s = data.QueryStream(x, 7)
    drawn = [s.next() for _ in range(5000)]
    q = np.stack([v for v, _ in drawn])
    assert compare.digest(q, np.array([g for _, g in drawn])) == "bd097e4abdbbbf40"
    s2 = data.QueryStream(x, 7)
    assert np.array_equal(np.stack([s2.next()[0] for _ in range(100)]),
                          q[:100])


def test_query_stream_mix():
    x = data.clustered_vectors(3000, 16, seed=[1, 0])
    s = data.QueryStream(x, 1, hot_anchors=16, hot_share=0.7, noise=0.0)
    drawn = [s.next() for _ in range(4096)]
    q = np.stack([v for v, _ in drawn])
    g = np.array([k for _, k in drawn])
    hot = (q[:, None, :] == s.anchors[None]).all(-1)
    assert 0.65 < (g >= 0).mean() < 0.75
    assert (hot[g >= 0].argmax(1) == g[g >= 0]).all()
    # the anchors come from the anchor seed, the rest from the run's seed
    s2 = data.QueryStream(x, 2, hot_anchors=16)
    assert np.array_equal(s2.anchors, s.anchors)


def test_a_seed_orders_the_work_without_changing_it():
    cfg = {"n": 1500, "dim": 16, "data_seed": 0, "avg_neighbors": 10,
           "dataset": {"cluster_std": 0.08}}
    b1, e1, p1 = data.make_vectors(cfg, 11)
    b2, e2, p2 = data.make_vectors(cfg, 12)
    assert np.array_equal(b1, b2) and e1 == e2
    assert not np.array_equal(p1, p2)
    assert np.array_equal(np.sort(p1), np.arange(1500))


def test_epsilon_matches_the_programs_calibration():
    from repro_torch.data.synthetic import epsilon_for_avg_neighbors
    x = data.clustered_vectors(2000, 32, seed=[7, 0])
    assert data.epsilon_for_avg_neighbors(x, 10) == pytest.approx(
        epsilon_for_avg_neighbors(x, 10), rel=1e-12)


def _naive_pairs(x, eps):
    x64 = x.astype(np.float64)
    d2 = ((x64[:, None] - x64[None]) ** 2).sum(-1)
    i, j = np.nonzero(np.triu(d2 <= eps * eps, 1))
    return set(zip(i.tolist(), j.tolist())), d2


def test_reference_join_is_brute_force():
    x = data.clustered_vectors(700, 8, seed=[2, 0])
    eps = data.epsilon_for_avg_neighbors(x, 5)
    want, d2 = _naive_pairs(x, eps)
    pairs, got_d2 = reference.join(torch.from_numpy(x), eps, block=128)
    got = set(map(tuple, pairs.numpy().tolist()))
    assert got == want and len(want) > 100
    np.testing.assert_allclose(got_d2.numpy(),
                               d2[pairs[:, 0], pairs[:, 1]], rtol=1e-9,
                               atol=1e-12)


def test_reference_members_are_brute_force():
    x = data.clustered_vectors(500, 8, seed=[4, 0])
    eps = data.epsilon_for_avg_neighbors(x, 5)
    Q = x[:40] + 0.01
    out = reference.members(torch.from_numpy(x), torch.from_numpy(Q), eps,
                            block=16)
    d2 = ((Q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    for k, (ids, dd) in enumerate(out):
        np.testing.assert_array_equal(ids, np.nonzero(d2[k] <= eps * eps)[0])
        np.testing.assert_allclose(dd, d2[k, ids], rtol=1e-9, atol=1e-12)


def test_tf32_rounding():
    v = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12,
                      -(1.0 + 2 ** -11)], dtype=torch.float32)
    got = reference.to_tf32(v).tolist()
    assert got == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                   -(1.0 + 2 ** -10)]


def test_join_numbers_hold_the_reference_and_fail_the_control():
    x = data.clustered_vectors(1500, 32, seed=[5, 0])
    eps = data.epsilon_for_avg_neighbors(x, 10)
    p, d2 = reference.join(torch.from_numpy(x), eps, "float64")
    d = d2.sqrt().float().numpy()
    good = compare.join_numbers(x, eps, p.numpy(), d, "cpu")
    assert good["malformed"] == 0 and good["outside"] == 0
    assert good["recall"] == 1.0 and good["d2_err"] < 1e-6
    cp, cd2 = reference.join(torch.from_numpy(x), eps, "tf32")
    ctl = compare.join_numbers(x, eps, cp.numpy(),
                               cd2.sqrt().float().numpy(), "cpu")
    assert ctl["d2_err"] > 100 * good["d2_err"]
    # malformed: a pair twice, reversed, out of range
    bad = np.concatenate([p.numpy(), p.numpy()[:1], [[5, 3], [0, 10 ** 6]]])
    badd = np.concatenate([d, d[:1], [0.1, 0.1]]).astype(np.float32)
    assert compare.join_numbers(x, eps, bad, badd, "cpu")["malformed"] == 3


def test_judge():
    ok, checks = compare.judge({"recall": 0.95, "outside": 0},
                               {"recall": {"min": 0.9},
                                "outside": {"max": 0}})
    assert ok and checks["recall"] == {"value": 0.95, "limit": 0.9,
                                       "need": ">="}
    ok, _ = compare.judge({"recall": 0.85}, {"recall": {"min": 0.9}})
    assert not ok


def test_roofline_counts():
    sizes = np.array([10, 20, 1, 5])
    edges = np.array([[0, 1], [1, 3]])
    ops, nbytes = roofline.join_work(edges, sizes, 4, pairs_verified=300,
                                     pairs_emitted=7)
    assert ops == 2 * 4 * 300
    # lanes: (10 + 20) + (20 + 5) rows, intra lanes 10 + 20 + 5 rows
    assert nbytes == 4 * 4 * (30 + 25 + 35) + 20 * 7
    waves = [[np.array([0, 1]), np.array([1])], [np.array([3])]]
    ops, nbytes = roofline.query_work(waves, sizes, 4, members_emitted=2)
    assert ops == 2 * 4 * (10 + 2 * 20 + 5)
    assert nbytes == 4 * 4 * ((10 + 20 + 3) + (5 + 1)) + 20 * 2
    t = roofline.least_time_s(ops, nbytes)
    assert t == max(ops / roofline.PEAK_TF32_FLOP_S,
                    nbytes / roofline.PEAK_HBM_BYTE_S)
    assert roofline.share_pct(ops, nbytes, 0.0) is None
    assert roofline.share_pct(ops, nbytes, 2 * t) == pytest.approx(50.0)


def test_trace_reduction_on_a_synthetic_window():
    window = (0, 1000)
    dev = [("k1", -50, 100), ("k2", 50, 200), ("copy", 400, 500),
           ("k1", 900, 1200)]
    spans = [("outer", 0, 1000), ("gorder", 200, 400), ("dedup", 600, 800)]
    out = tr.reduce(dev, spans, window)
    # busy: [0, 200) ∪ [400, 500) ∪ [900, 1000)
    assert out["busy_s"] == pytest.approx(400e-9)
    assert out["window_s"] == pytest.approx(1000e-9)
    idle = dict(out["idle_gaps"])
    # gaps [200, 400) and [500, 900), labelled at their midpoints
    assert idle == {"gorder": pytest.approx(200e-9),
                    "dedup": pytest.approx(400e-9)}
    idle = dict(tr.reduce(dev, spans[:2], window)["idle_gaps"])
    assert idle == {"gorder": pytest.approx(200e-9),
                    "outer": pytest.approx(400e-9)}
    ops = dict(out["device_ops"])
    assert ops["k1"] == pytest.approx(200e-9)
    assert tr.reduce([], [], window)["idle_gaps"] == [[tr.NO_SPAN, 1e-6]]


def test_work_counts_by_the_span_that_launched_it():
    window = (0, 1000)
    # (name, start, end, correlation): the device runs each late
    dev = [("verify", 150, 300, 1), ("and", 300, 420, 2),
           ("Memcpy HtoD (Pinned -> Device)", 100, 140, 3),
           ("Memcpy DtoH (Device -> Pinned)", 420, 440, 4),
           ("other", 500, 600, 5), ("scan", 950, 1100, 6),
           ("unmatched", 0, 50, 7)]
    launches = {1: 110, 2: 120, 3: 105, 4: 130, 5: 260, 6: 700}
    spans = [("verify.dispatch", 100, 140), ("verify.flush", 90, 200),
             ("verify.collect", 690, 710), ("join.run", 0, 1000)]
    within = [s for s in spans if s[0].startswith(("verify.",))]
    # verify 150 + and 120 + scan 50 inside the window; copies, the
    # launch outside the spans and the unmatched event left out
    assert tr.launched_within(dev, launches, within, window) == \
        pytest.approx(320e-9)
    # a span open from 0 to 1000 takes in the launch at 260 too
    assert tr.launched_within(dev, launches, spans[3:], window) == \
        pytest.approx(420e-9)
    assert tr.launched_within(dev, launches, [], window) == 0.0


def test_import_check_compares_whole_top_level_names():
    names = ["repro_torch", "repro_torch.core.index", "numpy", "jaxtyping",
             "reprolib"]
    assert imports.forbidden_modules(names) == []
    assert imports.forbidden_modules(names + ["repro", "repro.core",
                                              "jax.numpy", "jaxlib",
                                              "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1] / "yardstick"
    for f in root.glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            assert not imports.forbidden_modules(mods), (f, mods)
            assert all(m.split(".")[0] != "repro_torch" for m in mods), (
                f, mods)
