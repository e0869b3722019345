"""One run of one cell: inputs from the seed, the index built, the cell's
traffic warmed up, a measured window, the check against the reference,
and the result line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, its traffic mix (``portbench/traffic/<mix>.json``,
whose ``kind`` names its runner, ``portbench/runners/<kind>.py``, a class
``Mix``), the limits of its comparison (``portbench/limits/<cell>.json``)
and each metric's reader (``portbench/metrics/<metric>.py``, or for a
metric ``<name>.<cells>`` without a file of its own ``<name>.py``: a
function ``read(run)`` that returns a number or None where it finds
nothing to read).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.index import DiskJoinIndex
from repro_torch.core.types import JoinConfig
from repro_torch.obs import trace_session
from repro_torch.store.vector_store import FlatVectorStore

from .yardstick import compare, data, imports
from .yardstick import trace as trace_mod

PB = Path(__file__).resolve().parent
ROOT = PB.parent
RING = 1 << 21            # tracer events a thread keeps in a traced run
MARK = "portbench.window"


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry with its configuration, traffic and limits."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return dict(cell=cell, config=_json(root / cfg["file"]),
                traffic=_json(PB / "traffic" / f"{cell['traffic']}.json"),
                limits=_json(PB / "limits" / f"{workload}.json"))


def metric_names(bench: dict, workload: str, per_layer: bool) -> list[dict]:
    """The end-to-end or the per-layer metrics a cell reports: those that
    list it, and end-to-end ones that list no cells."""
    group = bench["per_layer" if per_layer else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def _load(kind: str, name: str, path: Path):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The metric's ``read``: ``metrics/<name>.py``, else the file of the
    name's part before its first dot (one reader for ``x.join`` and
    ``x.serve``)."""
    path = PB / "metrics" / f"{name}.py"
    if not path.exists():
        path = PB / "metrics" / f"{name.split('.')[0]}.py"
    return _load("metric", name, path).read


def runner(kind: str):
    """The traffic runner ``runners/<kind>.py``'s class ``Mix``."""
    return _load("runner", kind, PB / "runners" / f"{kind}.py").Mix


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""
    workload: str
    seed: int
    device: torch.device
    trace: bool
    t_start: float = 0.0         # the process's start, on perf_counter
    x: np.ndarray = None
    base: np.ndarray = None      # the vectors in the configuration's order
    data_seed: int = 0
    eps: float = 0.0
    index_dir: str = ""
    setup_s: float = 0.0
    window_s: float = 0.0
    mix: object = None           # the traffic runner, after its window
    events: list = dataclasses.field(default_factory=list)  # tracer's
    device_trace: dict | None = None   # trace.reduce's result
    # traced runs, on the profiler's clock: device operations (name,
    # start, end, correlation), {correlation: launch}, tracer spans
    # (name, start, end) and the window (start, end)
    device_events: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    prof_spans: list = dataclasses.field(default_factory=list)
    prof_window: tuple = (0, 0)
    work: tuple | None = None          # verify's (operations, bytes)
    sizes: np.ndarray | None = None    # live rows of each bucket

    @property
    def dim(self) -> int:
        return int(self.x.shape[1])

    def open_index(self) -> DiskJoinIndex:
        return DiskJoinIndex.open(self.index_dir, device=self.device)

    def spans(self, name: str) -> list[dict]:
        return [e for e in self.events
                if e.get("ph") == "X" and e.get("name") == name]


def join_config(cfg: dict, x: np.ndarray, eps: float) -> JoinConfig:
    j = cfg["join"]
    return JoinConfig(
        epsilon=eps, num_buckets=int(j["num_buckets"]),
        memory_budget_bytes=x.nbytes // int(j["memory_divisor"]),
        recall_target=float(j["recall_target"]),
        pad_align=int(j["pad_align"]), compute_mode=j["compute_mode"])


def make_inputs(cfg: dict, seed: int, device):
    """(the indexed vectors: the configuration's, in the seed's order; ε;
    the configuration's vectors, which the query stream draws from)."""
    base, eps, perm = data.make_vectors(cfg, seed, device)
    return base[perm], eps, base


class _Profiler:
    """torch.profiler over the window, with a marker that ties the tracer's
    clock (``time.perf_counter``) to the profiler's."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.mark_perf = 0.0

    def __enter__(self):
        from torch.profiler import record_function
        self.prof.__enter__()
        with record_function(MARK):
            self.mark_perf = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def events(self):
        """(device events (name, start, end, correlation), the runtime
        calls that queued them {correlation: start}, ns offset from
        perf_counter to the profiler)."""
        res = self.prof.profiler.kineto_results
        dev, launches, offset = [], {}, None
        for e in res.events():
            name = e.name()
            if name == MARK and offset is None:
                offset = e.start_ns() - self.mark_perf * 1e9
            elif ("CUDA" in str(e.device_type())
                  and not e.is_user_annotation()):
                dev.append((name, e.start_ns(),
                            e.start_ns() + e.duration_ns(),
                            e.correlation_id()))
            elif name.startswith("cu") and e.correlation_id():
                launches[e.correlation_id()] = e.start_ns()
        return dev, launches, offset


def flush_to_disk(path: str) -> None:
    """Write the run's files through to the disk in set-up, so that their
    write-back does not land in the measured window."""
    for d, _, files in os.walk(path):
        for f in files:
            fd = os.open(os.path.join(d, f), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                    device)))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             bench: dict | None = None, config_overrides: dict | None = None,
             log=None) -> dict:
    """Run ``workload`` once; returns the result line's object. ``device``
    "cpu" runs the port's plain CPU path (the tests' small runs);
    ``config_overrides`` replaces top-level keys of the configuration
    (sizes, for those runs)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    bench = bench or load_benchmark()
    spec = cell_spec(bench, workload)
    cfg = {**spec["config"], **(config_overrides or {})}
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    run = Run(workload=workload, seed=int(seed), device=dev,
              trace=bool(trace), t_start=t_start)
    tmp = tempfile.mkdtemp(prefix="portbench_")
    phases = {"start": t_start, "imports": time.perf_counter()}
    try:
        run.x, run.eps, run.base = make_inputs(cfg, seed, dev)
        phases["inputs"] = time.perf_counter()
        run.data_seed = int(cfg["data_seed"])
        store = FlatVectorStore.from_array(os.path.join(tmp, "x.bin"),
                                           run.x)
        run.index_dir = os.path.join(tmp, "index")
        built = DiskJoinIndex.build(store, join_config(cfg, run.x, run.eps),
                                    run.index_dir, device=dev)
        run.sizes = np.asarray(built.meta.sizes, np.int64)
        built.close()
        store.close()
        phases["build"] = time.perf_counter()
        flush_to_disk(tmp)
        phases["fsync"] = time.perf_counter()
        mix = runner(spec["traffic"]["kind"])(spec["traffic"], run)
        run.mix = mix
        phases["open"] = time.perf_counter()
        mix.warm()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phases["warm"] = time.perf_counter()
        _window(run, mix, seconds)
        mix.after_window()
        info = device_info(dev)
        if trace:
            run.work = mix.work(run)
        mix.close()
        numbers = mix.numbers(run.x, run.eps, run.seed, dev)
        ok, checks = compare.judge(numbers, spec["limits"])
        attempted, failed = mix.attempted_failed()
        names = metric_names(bench, workload, per_layer=trace)
        metrics = {}
        for m in names:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if trace and run.device_trace is not None:
            info["busy_s"] = run.device_trace["busy_s"]
            info["window_s"] = run.device_trace["window_s"]
        info["power_limit"] = power_limit() if dev.type == "cuda" else ""
        out = {"correct": bool(ok) and failed == 0,
               "attempted": int(attempted), "failed": int(failed),
               "metrics": metrics, "device": info}
        if trace and run.device_trace is not None:
            out["breakdown"] = {
                "device_ops": run.device_trace["device_ops"],
                "idle_gaps": run.device_trace["idle_gaps"]}
        out["checks"] = checks
        log(mix.summary())
        marks = list(phases.items())
        log("set-up s: " + " ".join(
            f"{b}={t1 - t0:.3f}" for (_, t0), (b, t1)
            in zip(marks, marks[1:])))
        for name, c in checks.items():
            log(f"check {name} {c['value']!r} {c['need']} {c['limit']!r}")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _window(run: Run, mix, seconds: float) -> None:
    """The measured window; in a traced run under the program's tracer
    and torch.profiler, reduced afterwards."""
    if not run.trace:
        t0 = time.perf_counter()
        run.setup_s = t0 - run.t_start
        run.window_s = mix.window(t0, seconds)
        return
    prof = _Profiler(run.device)
    with trace_session(ring_capacity=RING) as tr:
        with prof:
            t0 = time.perf_counter()
            run.setup_s = t0 - run.t_start
            with tr.span("bench.window"):
                run.window_s = mix.window(t0, seconds)
            t1 = t0 + run.window_s
    run.events = tr.events()
    win = [e for e in run.events if e["name"] == "bench.window"][0]
    epoch = t0 - win["ts"] / 1e6      # the tracer's clock, in perf_counter
    for e in run.events:
        e["t0"] = epoch + e["ts"] / 1e6
        e["t1"] = e["t0"] + e.get("dur", 0.0) / 1e6
    dev_events, launches, offset = prof.events()
    if offset is None:
        return
    spans = [(e["name"], e["t0"] * 1e9 + offset, e["t1"] * 1e9 + offset)
             for e in run.events if e["ph"] == "X"
             and e["name"] != "bench.window"]
    window = (t0 * 1e9 + offset, t1 * 1e9 + offset)
    run.device_trace = trace_mod.reduce(
        [ev[:3] for ev in dev_events], spans, window)
    run.device_events, run.launches = dev_events, launches
    run.prof_spans, run.prof_window = spans, window


def no_jax(log) -> bool:
    bad = imports.forbidden_modules(list(sys.modules))
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
    return not bad
