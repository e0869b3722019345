"""repro_torch.obs — span tracing, Perfetto export, session metrics and
live observability (copies of the JAX package's ``repro.obs``; the span
names and the metrics layout are the same). The two-line "observe your
join" recipe::

    from repro_torch.obs import trace_session
    with trace_session() as tracer:
        index.self_join(epsilon=eps)
    tracer.export("join.trace.json")      # open in ui.perfetto.dev
    print(tracer.analysis().summary())
"""
from repro_torch.obs.tracer import (
    NOOP_SPAN,
    Tracer,
    disable_tracing,
    enable_tracing,
    get_tracer,
    trace_session,
)
from repro_torch.obs.export import (
    TraceAnalysis,
    export_chrome_trace,
    validate_chrome_trace,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    log_bounds,
)
from repro_torch.obs.live import (
    Alert,
    LiveCalibrator,
    LiveObserver,
    RollupWindow,
    Slo,
    SloMonitor,
    TimeSeries,
    default_serving_slos,
    merge_live_sections,
)
from repro_torch.obs.webhook import WebhookSink

__all__ = [
    "NOOP_SPAN",
    "Tracer",
    "get_tracer",
    "enable_tracing",
    "disable_tracing",
    "trace_session",
    "TraceAnalysis",
    "export_chrome_trace",
    "validate_chrome_trace",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "log_bounds",
    "TimeSeries",
    "RollupWindow",
    "Slo",
    "SloMonitor",
    "Alert",
    "LiveCalibrator",
    "LiveObserver",
    "default_serving_slos",
    "merge_live_sections",
    "WebhookSink",
]
