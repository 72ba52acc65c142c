"""Chrome-trace export — the port's own copy of ``repro.obs.export``.

Turns a :class:`~repro_torch.obs.tracer.Tracer`'s events into the Trace
Event Format that ``chrome://tracing`` and Perfetto read::

    {"traceEvents": [{"name", "cat", "ph", "ts", "dur", "pid", "tid",
                      "args"}, ...],
     "displayTimeUnit": "ms"}

Timestamps are microseconds after the earliest event.  Lanes: an integer
``tid`` is a thread ident (named from the tracer's thread names, so the
``hmm-transfer-*`` workers get rows of their own); a string lane
(``"scale"``, ``"fleet"``) gets a small negative tid and a ``thread_name``
record.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Union

from repro_torch.obs.tracer import NullTracer, Tracer

PID = 1


def chrome_trace(tracer: Union[Tracer, NullTracer],
                 extra_metadata: Optional[dict] = None) -> dict:
    """The tracer's events as a Chrome-trace document."""
    events = tracer.events()
    t_base = min((e.t0 for e in events), default=0.0)
    lane_ids: Dict[str, int] = {}
    out: List[dict] = [{"ph": "M", "name": "process_name", "pid": PID,
                        "tid": 0, "args": {"name": "repro_torch"}}]

    def lane(tid) -> int:
        if isinstance(tid, str):
            if tid not in lane_ids:
                # negative: named lanes sort ahead of thread rows and never
                # collide with an ident
                lane_ids[tid] = -(len(lane_ids) + 1)
                out.append({"ph": "M", "name": "thread_name", "pid": PID,
                            "tid": lane_ids[tid], "args": {"name": tid}})
            return lane_ids[tid]
        return tid

    for ident, name in tracer.thread_names().items():
        out.append({"ph": "M", "name": "thread_name", "pid": PID,
                    "tid": ident, "args": {"name": name}})
    for e in events:
        rec = {"name": e.name, "cat": e.cat or "default", "ph": e.ph,
               "ts": (e.t0 - t_base) * 1e6, "pid": PID, "tid": lane(e.tid)}
        if e.ph == "X":
            rec["dur"] = max(e.t1 - e.t0, 0.0) * 1e6
        elif e.ph == "i":
            rec["s"] = "t"          # a thread-scoped instant
        if e.args:
            rec["args"] = dict(e.args)
        out.append(rec)
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if extra_metadata:
        doc["metadata"] = dict(extra_metadata)
    return doc


def write_chrome_trace(path: str, tracer: Union[Tracer, NullTracer],
                       extra_metadata: Optional[dict] = None) -> dict:
    """Write ``chrome_trace(tracer)`` to ``path`` as JSON; returns it."""
    doc = chrome_trace(tracer, extra_metadata)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc


def load_trace(path: str) -> dict:
    """Read an exported trace and check its schema (raises if malformed)."""
    with open(path) as fh:
        doc = json.load(fh)
    validate_trace(doc)
    return doc


def validate_trace(doc: dict) -> None:
    """The Trace Event Format's minimal schema: every record has ``ph``,
    ``pid`` and ``tid``; spans, instants and counters a ``ts`` and a
    ``name``; a span a ``dur`` >= 0.  Raises ``ValueError``."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a Chrome-trace document")
    for rec in doc["traceEvents"]:
        if not {"ph", "pid", "tid"} <= rec.keys():
            raise ValueError(f"record without ph, pid or tid: {rec}")
        if rec["ph"] in ("X", "i", "C") and not {"ts", "name"} <= rec.keys():
            raise ValueError(f"event without ts or name: {rec}")
        if rec["ph"] == "X" and not rec.get("dur", -1) >= 0:
            raise ValueError(f"span without a dur >= 0: {rec}")
