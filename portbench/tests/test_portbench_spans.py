"""The span readers (``metrics/join_*_s.py``, ``metrics/query_*_share
.serve.py``, ``spantime.py``) on synthetic tracer events: per-join means,
the walk's self time with nested, overlapping and foreign spans, and the
serve shares; None where the run recorded nothing to read."""
import types

import pytest
import torch

from portbench import harness
from portbench.spantime import self_us

JOIN_SPANS = {"join_order_s": "join.order", "join_dedup_s": "join.dedup",
              "join_stage_s": "h2d.stage", "join_sync_s": "device.sync"}
SERVE_SPANS = {"query_stage_share.serve": "h2d.stage",
               "query_sync_share.serve": "device.sync",
               "query_emit_share.serve": "query.emit"}


def X(name, ts, dur, tid=1):
    return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur),
            "tid": tid, "pid": 1}


def _run(events, steps=None):
    run = harness.Run(workload="w", seed=0, device=torch.device("cpu"),
                      trace=True)
    run.events = events
    run.mix = types.SimpleNamespace(steps=steps) if steps is not None \
        else types.SimpleNamespace()
    return run


def read(name, run):
    return harness.reader(name)(run)


WALK = [
    X("bench.self_join", 50, 5000),          # encloses both walks
    X("join.run", 100, 1000),
    X("io.wait", 200, 100),                   # 200-300
    X("verify.collect", 400, 300),            # 400-700
    X("device.sync", 450, 50),                # nested in the collect
    X("verify.emit", 500, 190),
    X("h2d.stage", 650, 150),                 # overlaps the collect: -800
    X("io.wait", 1050, 150),                  # cut at the walk's end, 1100
    {"name": "verify.overflow", "ph": "i", "ts": 300.0, "tid": 1,
     "pid": 1},
    X("io.read", 100, 1000, tid=2),           # another thread
    X("join.run", 3000, 500),                 # no children
    X("join.run", 6000, 400, tid=3),          # an enclosing span that
    X("bench.step", 6000, 900, tid=3),        # began at the same time
]


def test_walk_self_time_subtracts_children_on_its_thread_only():
    # first walk: 1000 - (100 + 400 + 50) = 450 µs; second: 500 µs; the
    # third: 400 µs, its same-start parent not a child
    assert self_us(WALK, "join.run") == pytest.approx([450.0, 500.0, 400.0])
    run = _run(WALK, steps=[{}, {}, {}])
    assert read("join_walk_self_s", run) == pytest.approx(1350e-6 / 3)


def test_walk_self_time_is_none_without_a_walk_or_a_join():
    assert read("join_walk_self_s", _run([X("io.wait", 0, 5)],
                                         steps=[{}])) is None
    assert read("join_walk_self_s", _run(WALK)) is None


@pytest.mark.parametrize("metric", sorted(JOIN_SPANS))
def test_join_span_means_a_join(metric):
    span = JOIN_SPANS[metric]
    events = [X(span, 0, 300), X(span, 1000, 500, tid=2),
              X("join.run", 0, 2000), X("other", 0, 7000)]
    assert read(metric, _run(events, steps=[{}, {}])) == \
        pytest.approx(400e-6)
    assert read(metric, _run(events, steps=[{}] * 4)) == \
        pytest.approx(200e-6)


@pytest.mark.parametrize("metric", sorted(JOIN_SPANS))
def test_join_span_means_are_none_with_nothing_to_read(metric):
    span = JOIN_SPANS[metric]
    # the parent program: staging only as an instant, no such span
    instant = [{"name": span, "ph": "i", "ts": 0.0, "tid": 1, "pid": 1},
               X("join.run", 0, 2000)]
    assert read(metric, _run(instant, steps=[{}])) is None
    # a serve run: no joins
    assert read(metric, _run([X(span, 0, 300)])) is None


def test_serve_shares_add_up_with_the_plan_share():
    events = [X("serve.wave", 0, 1000, tid=7),
              X("serve.wave", 2000, 1000, tid=7),
              X("query.plan", 10, 100, tid=7),
              X("query.execute", 120, 800, tid=7),
              X("h2d.stage", 130, 200, tid=7),
              X("query.launch", 330, 40, tid=7),
              X("device.sync", 370, 500, tid=7),
              X("query.emit", 870, 100, tid=7),
              X("io.read", 0, 9000, tid=8)]
    run = _run(events)
    got = {m: read(m, run) for m in SERVE_SPANS}
    assert got == pytest.approx({"query_stage_share.serve": 10.0,
                                 "query_sync_share.serve": 25.0,
                                 "query_emit_share.serve": 5.0})
    plan = read("query_plan_share.serve", run)
    assert plan == pytest.approx(5.0)
    assert sum(got.values()) + plan <= 100.0


@pytest.mark.parametrize("metric", sorted(SERVE_SPANS))
def test_serve_shares_are_none_with_nothing_to_read(metric):
    span = SERVE_SPANS[metric]
    assert read(metric, _run([X(span, 0, 100)])) is None
    assert read(metric, _run([X("serve.wave", 0, 100)])) is None
