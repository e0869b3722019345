"""query_plan_share: the time in ``query.plan`` spans (``plan_probes``:
center search, triangle inequality, pruning) over the time in
``serve.wave`` spans, in per cent."""
from portbench.readers import span_seconds


def read(run):
    waves = span_seconds(run, "serve.wave")
    return 100.0 * span_seconds(run, "query.plan") / waves if waves else None
