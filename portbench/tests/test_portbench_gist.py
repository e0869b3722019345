"""The GIST-960 deployment (``gist960-100k``) and its cell
(``gist960-join``): found by name, cut only in n, and a small run of the
cell at the full 960-d width on the CPU, through the port's device-mode
join with prefetch I/O, against the float64 reference."""
import json
from pathlib import Path

import pytest
import torch

from portbench import harness
from repro_torch.core.index import DiskJoinIndex

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "gist960-join"
# 2,000 rows at the published width; 6 buckets, as 1 per mille would
# leave two. (At 1,500 rows this data's one join reads recall 0.860:
# the paper's expected-recall bound, which assumes uniform density in all
# 960 dimensions, prunes more than it should over 12-d clusters at so
# few rows a bucket; other data seeds read 0.915-0.991 there.)
SMALL = {"n": 2000, "data_seed": 0,
         "join": {"num_buckets": 6, "memory_divisor": 10,
                  "recall_target": 0.9, "pad_align": 128,
                  "compute_mode": "device"}}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_cell_and_its_configuration_are_found_by_name():
    spec = harness.cell_spec(BENCH, CELL)
    cfg = spec["config"]
    assert spec["cell"]["config"] == cfg["name"] == "gist960-100k"
    assert spec["cell"]["chips"] == 1
    assert spec["traffic"]["kind"] == "join"
    assert spec["traffic"]["overrides"] == {"io_mode": "prefetch"}
    assert cfg["published"]["dim"] == cfg["dim"] == 960
    assert cfg["published"]["n"] == 1_000_000 and cfg["n"] == 100_000
    assert cfg["join"]["num_buckets"] == cfg["n"] // 1000
    entry = {c["name"]: c for c in BENCH["configs"]}[cfg["name"]]
    assert entry["reduced"] == ["n"] == list(cfg["reduced"])
    assert set(spec["limits"]) == set(harness.cell_spec(
        BENCH, "sift128-join")["limits"])
    assert spec["limits"]["d2_err"]["max"] < 3e-5


def test_the_cell_reports_the_join_metrics():
    e2e = {m["name"] for m in harness.metric_names(BENCH, CELL, False)}
    assert e2e == {"join_s", "setup_s"}
    per = {m["name"] for m in harness.metric_names(BENCH, CELL, True)}
    sift = {m["name"] for m in harness.metric_names(BENCH, "sift128-join",
                                                    True)}
    assert per == sift
    assert {"verify_recheck_share.join", "h2d_link_roofline.join"} <= per
    for name in per:
        assert callable(harness.reader(name))


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_at_960_dims_is_correct(trace, monkeypatch):
    modes = []
    real = DiskJoinIndex.self_join

    def self_join(index, **kw):
        modes.append(index._resolve(kw).io_mode)
        return real(index, **kw)

    monkeypatch.setattr(DiskJoinIndex, "self_join", self_join)
    out = harness.run_cell(CELL, 2 ** 31 + 777, 0.3, trace, device="cpu",
                           config_overrides=SMALL, log=lambda m: None)
    # the warm join and the window's, each through the prefetcher
    assert len(modes) >= 2 and set(modes) == {"prefetch"}
    checks = out["checks"]
    assert out["correct"], checks
    assert checks["outside"]["value"] == 0
    assert checks["recall"]["value"] >= 0.9
    assert checks["d2_err"]["value"] < 3e-5
    assert checks["joins_differ"]["value"] == 0
    want = {m["name"] for m in harness.metric_names(BENCH, CELL, trace)}
    # on the CPU nothing runs on a device: the rooflines find nothing
    assert set(out["metrics"]) == {m for m in want if "roofline" not in m}
    if trace:
        # the CPU path recomputes nothing in a band
        assert out["metrics"]["verify_recheck_share.join"]["value"] == 0.0
