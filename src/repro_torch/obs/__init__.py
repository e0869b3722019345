"""Span tracing (a copy of the JAX package's tracer; export and live
observability wait for a later slice of the port)."""
from repro_torch.obs.tracer import (NOOP_SPAN, Tracer, disable_tracing,
                                    enable_tracing, get_tracer,
                                    trace_session)

__all__ = ["NOOP_SPAN", "Tracer", "disable_tracing", "enable_tracing",
           "get_tracer", "trace_session"]
