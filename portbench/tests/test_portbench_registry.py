"""BENCHMARK.json against the benchmark's contract, and everything it
names found by name: configurations, traffic mixes, limits, readers."""
import json
import math
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for e in BENCH[group]:
            extra = set(e) - keys
            assert extra <= ({"workloads"} if group in (
                "end_to_end", "per_layer") else set()), (e["name"], extra)
            assert keys <= set(e), e["name"]
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
                assert e["source"] in SOURCES


def test_cells_and_configs():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key != "dim"
        assert cfg["published"]["dim"] == cfg["dim"]


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.metric_names(BENCH, w["name"],
                                                       False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = harness.metric_names(BENCH, w["name"], True)
        assert per and all(m["moves"] in e2e for m in per)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1
    layers = {}
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["source"] == "device_trace"
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_everything_a_cell_names_is_found_by_name(workload):
    spec = harness.cell_spec(BENCH, workload)
    assert hasattr(harness.runner(spec["traffic"]["kind"]), "window")
    assert spec["limits"]["recall"]["min"] == spec["config"]["join"][
        "recall_target"]
    for lim in spec["limits"].values():
        (k, v), = lim.items()
        assert k in ("min", "max") and math.isfinite(v)
    for per_layer in (False, True):
        for m in harness.metric_names(BENCH, workload, per_layer):
            assert callable(harness.reader(m["name"]))


def test_paths_hold_only_allowed_file_names():
    for p in (ROOT / "portbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_a_reader_without_a_file_of_its_own_is_its_base_names():
    def file_of(name):
        return Path(harness.reader(name).__code__.co_filename).name
    assert file_of("device_idle.join") == "device_idle.py"
    assert file_of("device_idle.serve") == "device_idle.py"
    assert file_of("verify_roofline.serve") == "verify_roofline.serve.py"
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.join")
