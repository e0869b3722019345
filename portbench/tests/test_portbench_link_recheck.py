"""The readers of ``verify_recheck_share.join`` and
``h2d_link_roofline.join`` on synthetic runs: what each counts, and None
where the run recorded nothing for it to read."""
import types

import numpy as np
import pytest
import torch

from portbench import harness

RECHECK = "verify_recheck_share.join"
LINK = "h2d_link_roofline.join"
PEAK = 32e9 * 16 * 128 / 130 / 8


def X(name, ts, dur, tid=1, **args):
    e = {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur),
         "tid": tid, "pid": 1}
    if args:
        e["args"] = args
    return e


def instant(name, ts, **args):
    return {"name": name, "ph": "i", "ts": float(ts), "tid": 1, "pid": 1,
            "args": args}


def _run(events, steps=None, device_events=(), launches=None,
         window_ts=1000.0, prof_start=5_000_000, traced=True, sizes=None):
    """A run whose tracer window span starts at ``window_ts`` µs and
    whose profiler window starts at ``prof_start`` ns; its spans put on
    the profiler's clock as the harness puts them."""
    run = harness.Run(workload="w", seed=0, device=torch.device("cpu"),
                      trace=True)
    run.events = [X("bench.window", window_ts, 10_000)] + list(events)
    run.mix = types.SimpleNamespace(steps=steps) if steps is not None \
        else types.SimpleNamespace()
    run.sizes = None if sizes is None else np.asarray(sizes, np.int64)
    if traced:
        run.device_trace = {"busy_s": 0.0, "window_s": 0.01}
        run.device_events = list(device_events)
        run.launches = dict(launches or {})
        run.prof_window = (prof_start, prof_start + 10_000_000)
        run.prof_spans = [
            (e["name"], _ns(e["ts"], window_ts, prof_start),
             _ns(e["ts"] + e["dur"], window_ts, prof_start))
            for e in run.events
            if e["ph"] == "X" and e["name"] != "bench.window"]
    return run


def read(name, run):
    return harness.reader(name)(run)


def test_recheck_share_sums_the_instants_over_the_outputs_computed():
    """Two joins over buckets of 3, 1, 2 and 0 rows: each join's lanes
    compute its live pairs and, for the buckets of 3 and 2 rows, the
    lower triangle and diagonal of their squares, 6 + 3 outputs."""
    events = [instant("verify.rechecks", 2000, pairs=30),
              instant("verify.rechecks", 5000, pairs=10),
              instant("verify.overflow", 3000, top=9, k_cap=8),
              X("verify.rechecks", 6000, 5, pairs=1000)]   # not an instant
    run = _run(events, steps=[{"pairs_verified": 1500},
                              {"pairs_verified": 500}], sizes=[3, 1, 2, 0])
    assert read(RECHECK, run) == pytest.approx(100.0 * 40 / (2000 + 2 * 9))


@pytest.mark.parametrize("case", ["no_instant", "no_join", "no_pairs",
                                  "no_sizes"])
def test_recheck_share_is_none_with_nothing_to_read(case):
    mark = [instant("verify.rechecks", 2000, pairs=3)]
    run = {"no_instant": _run([X("verify.collect", 0, 5)],
                              steps=[{"pairs_verified": 10}], sizes=[4]),
           "no_join": _run(mark, sizes=[4]),
           "no_pairs": _run(mark, steps=[{"pairs_verified": 0}],
                            sizes=[1, 1, 0]),
           "no_sizes": _run(mark, steps=[{"pairs_verified": 10}])}[case]
    assert read(RECHECK, run) is None


def _ns(ts_us, window_ts=1000.0, prof_start=5_000_000):
    """A tracer time on the profiler's clock, as the reader maps it."""
    return prof_start + (ts_us - window_ts) * 1e3


def test_a_copy_at_the_link_peak_reads_100():
    nbytes = 63_000_000
    dur_ns = nbytes / PEAK * 1e9
    copy = ("Memcpy HtoD (Pinned -> Device)", 9e6, 9e6 + dur_ns, 7)
    run = _run([X("h2d.stage", 2000, 100, bytes=nbytes)],
               device_events=[copy], launches={7: _ns(2050)})
    assert read(LINK, run) == pytest.approx(100.0)


def test_link_share_counts_only_copies_launched_inside_the_stage():
    spans = [X("h2d.stage", 2000, 100, bytes=4_000_000),
             X("io.wait", 2500, 400, bucket=1),            # another span
             X("h2d.stage", 3000, 100, bytes=8_000_000),
             X("h2d.stage", 4000, 100, bytes=1_000_000)]   # no copy
    dev = [("Memcpy HtoD (Pinned -> Device)", 1e7, 1e7 + 100_000, 1),
           ("Memcpy HtoD (Pinned -> Device)", 2e7, 2e7 + 200_000, 2),
           # launched outside every stage span
           ("Memcpy HtoD (Pinned -> Device)", 3e7, 3e7 + 900_000, 3),
           # a kernel and a copy back, launched inside a stage span
           ("pairwise_l2_tc_kernel", 4e7, 4e7 + 500_000, 4),
           ("Memcpy DtoH (Device -> Pageable)", 5e7, 5e7 + 500_000, 5),
           # a copy whose launch the profiler did not record
           ("Memcpy HtoD (Pinned -> Device)", 6e7, 6e7 + 700_000, 6)]
    launches = {1: _ns(2010), 2: _ns(3099), 3: _ns(3500), 4: _ns(2020),
                5: _ns(3010)}
    run = _run(spans, device_events=dev, launches=launches)
    want = 100.0 * 12_000_000 / 300e-6 / PEAK
    assert read(LINK, run) == pytest.approx(want)


@pytest.mark.parametrize("case", ["untraced", "no_stage", "no_copy",
                                  "copy_outside"])
def test_link_share_is_none_with_nothing_to_read(case):
    stage = [X("h2d.stage", 2000, 100, bytes=4_000_000)]
    copy = [("Memcpy HtoD (Pinned -> Device)", 1e7, 1e7 + 100_000, 1)]
    run = {"untraced": _run(stage, traced=False),
           "no_stage": _run([X("io.wait", 2000, 100, bucket=3)],
                            device_events=copy, launches={1: _ns(2010)}),
           "no_copy": _run(stage),
           "copy_outside": _run(stage, device_events=copy,
                                launches={1: _ns(2200)})}[case]
    assert read(LINK, run) is None
