"""Tracing for the port's serving stack: the span tracer and its
Chrome-trace export.

Usage::

    from repro_torch import obs
    tr = obs.install(obs.Tracer())       # enable (None to disable)
    ...
    spans = [e for e in tr.events() if e.name == "decode.tick"]
    obs.write_chrome_trace("trace.json", tr)
"""
from repro_torch.obs.export import (chrome_trace, load_trace, validate_trace,
                                    write_chrome_trace)
from repro_torch.obs.tracer import (NULL_TRACER, MetricsRegistry,
                                    NullTracer, TraceEvent, Tracer,
                                    get_tracer, install, traced)

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "TraceEvent",
           "MetricsRegistry", "install",
           "get_tracer", "traced", "chrome_trace", "write_chrome_trace",
           "load_trace", "validate_trace"]
