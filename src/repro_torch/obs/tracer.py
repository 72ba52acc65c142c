"""Span tracer for the serving stack (DESIGN.md §9).

The port's own copy of the parts of ``repro.obs.tracer`` the one-card
serving path uses (it imports nothing of the JAX package), so the serving
engine's spans and instants stay where they are.  Counters, metrics, thread
lanes and the Chrome-trace exporter are not ported yet.

One process-global :class:`Tracer` (installed via :func:`install`) collects
decode-tick and prefill spans and request lifecycle instants into a bounded
ring buffer.  Disabled by default: the global is :data:`NULL_TRACER`, whose
methods return immediately, and :func:`traced` short-circuits on an
identity check.  ``deque.append`` is atomic under the GIL, so recording
needs no lock.  Timestamps are seconds of ``time.perf_counter``.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from typing import Any, Callable, List, Optional, Union


class TraceEvent:
    """One recorded event: ``ph`` ``"X"`` is a complete span
    (``t0``..``t1``), ``"i"`` an instant (``t0``)."""

    __slots__ = ("name", "cat", "ph", "t0", "t1", "args")

    def __init__(self, name: str, cat: str, ph: str, t0: float, t1: float,
                 args: Optional[dict]):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.t0 = t0
        self.t1 = t1
        self.args = args

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class _Span:
    """Context manager emitted by :meth:`Tracer.span`."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tr.complete(self._name, self._t0, time.perf_counter(),
                          cat=self._cat, args=self._args)
        return False


class Tracer:
    """Collecting tracer; events beyond ``capacity`` evict the oldest, so a
    serve loop can run traced indefinitely."""

    enabled = True

    def __init__(self, *, capacity: int = 65536):
        self._events: deque = deque(maxlen=capacity)

    def complete(self, name: str, t0: float, t1: float, *, cat: str = "",
                 args: Optional[dict] = None) -> None:
        """Record an already-measured span."""
        self._events.append(TraceEvent(name, cat, "X", t0, t1, args))

    def span(self, name: str, *, cat: str = "",
             args: Optional[dict] = None) -> _Span:
        """``with tracer.span("decode.tick", cat="serve"): ...``"""
        return _Span(self, name, cat, args)

    def instant(self, name: str, *, cat: str = "",
                args: Optional[dict] = None) -> None:
        t = time.perf_counter()
        self._events.append(TraceEvent(name, cat, "i", t, t, args))

    def events(self) -> List[TraceEvent]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled fast path: every method returns immediately."""

    enabled = False

    def complete(self, *a: Any, **k: Any) -> None:
        pass

    def span(self, *a: Any, **k: Any) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, *a: Any, **k: Any) -> None:
        pass

    def events(self) -> List[TraceEvent]:
        return []

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()
_active: Union[Tracer, NullTracer] = NULL_TRACER


def install(tracer: Optional[Tracer]) -> Union[Tracer, NullTracer]:
    """Install the process-global tracer (``None`` disables tracing)."""
    global _active
    _active = tracer if tracer is not None else NULL_TRACER
    return _active


def get_tracer() -> Union[Tracer, NullTracer]:
    return _active


def traced(name: str, cat: str = "") -> Callable:
    """Decorator form of :meth:`Tracer.span` with a disabled-path
    short-circuit: one global read + identity check per call."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            tr = _active
            if tr is NULL_TRACER:
                return fn(*args, **kwargs)
            with tr.span(name, cat=cat):
                return fn(*args, **kwargs)
        return wrapper
    return deco
