"""Span tracer for the serving stack (DESIGN.md §9).

The port's own copy of ``repro.obs.tracer`` (it imports nothing of the
JAX package), so the serving engine's spans, instants and counters stay
where they are, and each tracer's ``metrics`` aggregates counters and
gauges (``MetricsRegistry``); the Chrome-trace exporter is
``obs/export.py``.

One process-global :class:`Tracer` (installed via :func:`install`) collects
decode-tick and prefill spans, request lifecycle instants and counter
samples into a bounded ring buffer.  Disabled by default: the global is :data:`NULL_TRACER`, whose
methods return immediately, and :func:`traced` short-circuits on an
identity check.  ``deque.append`` is atomic under the GIL, so recording
needs no lock: ``TransferEngine`` worker threads and the serve loop record
into one buffer.  Every event has a lane (``tid``): the recording thread's
ident (its name captured at first sighting, so the ``hmm-transfer-*``
workers are told apart), or a named lane such as ``"scale"`` for the
scaling task's phase spans.  Timestamps are seconds of
``time.perf_counter``, bar an instant given its own ``t`` (the
``FleetDriver``'s decisions, in driver seconds).
"""
from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Union

Lane = Union[int, str]


class TraceEvent:
    """One recorded event: ``ph`` ``"X"`` is a complete span
    (``t0``..``t1``), ``"i"`` an instant (``t0``); ``tid`` its lane."""

    __slots__ = ("name", "cat", "ph", "t0", "t1", "tid", "args")

    def __init__(self, name: str, cat: str, ph: str, t0: float, t1: float,
                 tid: Lane, args: Optional[dict]):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
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


class MetricsRegistry:
    """Thread-safe counters and gauges, independent of the event buffer
    (aggregates survive ring-buffer eviction)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}


class Tracer:
    """Collecting tracer; events beyond ``capacity`` evict the oldest, so a
    serve loop can run traced indefinitely."""

    enabled = True

    def __init__(self, *, capacity: int = 65536):
        self._events: deque = deque(maxlen=capacity)
        self._thread_names: Dict[int, str] = {}
        self._name_lock = threading.Lock()
        self.metrics = MetricsRegistry()

    def now(self) -> float:
        return time.perf_counter()

    def _resolve_tid(self, tid: Optional[Lane]) -> Lane:
        if tid is not None:
            return tid
        ident = threading.get_ident()
        if ident not in self._thread_names:
            with self._name_lock:
                self._thread_names.setdefault(
                    ident, threading.current_thread().name)
        return ident

    def complete(self, name: str, t0: float, t1: float, *, cat: str = "",
                 args: Optional[dict] = None,
                 tid: Optional[Lane] = None) -> None:
        """Record an already-measured span, on ``tid``'s lane (default:
        the calling thread's)."""
        self._events.append(TraceEvent(name, cat, "X", t0, t1,
                                       self._resolve_tid(tid), args))

    def span(self, name: str, *, cat: str = "",
             args: Optional[dict] = None) -> _Span:
        """``with tracer.span("decode.tick", cat="serve"): ...``"""
        return _Span(self, name, cat, args)

    def instant(self, name: str, *, cat: str = "",
                args: Optional[dict] = None, t: Optional[float] = None,
                tid: Optional[Lane] = None) -> None:
        if t is None:
            t = time.perf_counter()
        self._events.append(TraceEvent(name, cat, "i", t, t,
                                       self._resolve_tid(tid), args))

    def counter(self, name: str, value: float, *, cat: str = "",
                tid: Optional[Lane] = None) -> None:
        """Record a counter sample ``value`` (phase ``"C"``, the value in
        ``args``), such as the routing histogram's top expert share."""
        t = time.perf_counter()
        self._events.append(TraceEvent(name, cat, "C", t, t,
                                       self._resolve_tid(tid),
                                       {"value": value}))

    def events(self) -> List[TraceEvent]:
        return list(self._events)

    def thread_names(self) -> Dict[int, str]:
        """Thread ident -> name of every thread that recorded an event."""
        with self._name_lock:
            return dict(self._thread_names)

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
    metrics = None  # no aggregation when disabled

    def now(self) -> float:
        return time.perf_counter()

    def complete(self, *a: Any, **k: Any) -> None:
        pass

    def span(self, *a: Any, **k: Any) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, *a: Any, **k: Any) -> None:
        pass

    def counter(self, *a: Any, **k: Any) -> None:
        pass

    def events(self) -> List[TraceEvent]:
        return []

    def thread_names(self) -> Dict[int, str]:
        return {}

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
