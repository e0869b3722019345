"""Whole runs of each cell on the CPU at a small size (the port's plain
CPU path): the run is correct; with the timed path broken underneath,
and with the control in the program's place, it is not."""
import numpy as np
import pytest
import torch

from portbench import harness, readings
from portbench.yardstick import compare, data

from repro_torch.core.index import DiskJoinIndex

SMALL = {"n": 3000, "dim": 32, "data_seed": 0,
         "join": {"num_buckets": 8, "memory_divisor": 10,
                  "recall_target": 0.9, "pad_align": 32,
                  "compute_mode": "device"}}
CELLS = ("sift128-join", "sift128-serve")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload, trace=False, seed=2 ** 31 + 12345):
    return harness.run_cell(workload, seed, 0.5, trace, device="cpu",
                            config_overrides=SMALL, log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_a_small_run_is_correct(workload, trace):
    out = run(workload, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    bench = harness.load_benchmark()
    want = {m["name"] for m in harness.metric_names(bench, workload, trace)}
    got = set(out["metrics"])
    # on the CPU nothing runs on a device: the roofline finds nothing
    assert got == {m for m in want if "roofline" not in m}
    if trace:
        assert out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _wrap(monkeypatch, name, after):
    orig = getattr(DiskJoinIndex, name)

    def broken(self, *a, **k):
        return after(orig(self, *a, **k))

    monkeypatch.setattr(DiskJoinIndex, name, broken)


def _half_pairs(res):
    res.pairs, res.distances = res.pairs[::2], res.distances[::2]
    return res


def _moved_pair(res):
    p = res.pairs.copy()
    n = int(p.max()) + 1
    p[len(p) // 2, 1] = (p[len(p) // 2, 1] + n // 2) % n
    res.pairs = p
    return res


def _half_answers(answers):
    return [a if k % 2 else (a[0][:0], a[1][:0])
            for k, a in enumerate(answers)]


def _moved_member(answers):
    out = list(answers)
    for k, (ids, d) in enumerate(out):
        if ids.size:
            ids = ids.copy()
            ids[0] = (ids[0] + 1500) % 3000
            out[k] = (ids, d)
            break
    return out


def _hot_anchors():
    spec = harness.cell_spec(harness.load_benchmark(), "sift128-serve")
    base, _, _ = data.make_vectors({**spec["config"], **SMALL}, 0)
    return data.QueryStream(base, 0, anchor_seed=SMALL["data_seed"],
                            **spec["traffic"]["stream"]).anchors


@pytest.mark.parametrize("name, fault, workload", [
    ("self_join", _half_pairs, "sift128-join"),
    ("self_join", _moved_pair, "sift128-join"),
    ("execute_probes", _half_answers, "sift128-serve"),
    ("execute_probes", _moved_member, "sift128-serve"),
], ids=["join-half-left-out", "join-answer-altered",
        "serve-half-left-out", "serve-answer-altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault,
                                            workload):
    _wrap(monkeypatch, name, fault)
    out = run(workload)
    assert not out["correct"], out["checks"]


def test_hot_queries_answered_empty_are_not_correct(monkeypatch):
    """The queries near the hot anchors share their probes: a wave that
    answers none of them (and every roaming query right) fails recall."""
    anchors = _hot_anchors()
    orig = DiskJoinIndex.execute_probes
    hot_seen = []

    def broken(self, Q, per_q, *a, **k):
        out = orig(self, Q, per_q, *a, **k)
        d = ((np.asarray(Q)[:, None] - anchors[None]) ** 2).sum(-1).min(1)
        hot = d < 0.2 ** 2
        hot_seen.append(int(hot.sum()))
        return [(ids[:0], dd[:0]) if h else (ids, dd)
                for h, (ids, dd) in zip(hot, out)]

    monkeypatch.setattr(DiskJoinIndex, "execute_probes", broken)
    out = run("sift128-serve")
    assert sum(hot_seen) > 0
    assert not out["correct"], out["checks"]
    assert out["checks"]["recall"]["value"] < 0.5


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    spec = harness.cell_spec(harness.load_benchmark(), workload)
    spec["config"] = {**spec["config"], **SMALL}
    spec["traffic"] = {**spec["traffic"], "check_queries": 300}
    numbers = readings.control_numbers(spec, 99, torch.device("cpu"))
    ok, checks = compare.judge(numbers, spec["limits"])
    assert not ok, checks
    assert numbers["d2_err"] > spec["limits"]["d2_err"]["max"]


def test_the_join_compared_is_drawn_from_the_seed():
    from portbench.yardstick.data import seed_rng
    picks = {int(seed_rng(s, 2).integers(5)) for s in range(40)}
    assert picks == set(range(5))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_small_traced_run_on_the_card_is_correct(card, workload):
    out = harness.run_cell(workload, 7, 0.5, True, device=card,
                           config_overrides={**SMALL, "dim": 128},
                           log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
