"""Tracing for the port's serving stack: the span tracer only.

Usage::

    from repro_torch import obs
    tr = obs.install(obs.Tracer())       # enable (None to disable)
    ...
    spans = [e for e in tr.events() if e.name == "decode.tick"]
"""
from repro_torch.obs.tracer import (NULL_TRACER, NullTracer, TraceEvent,
                                    Tracer, get_tracer, install, traced)

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "TraceEvent", "install",
           "get_tracer", "traced"]
