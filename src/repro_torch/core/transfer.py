"""Background transfer engine — the port of ``repro.core.transfer``, the
async half of the HMM.

``HMM.begin_scale`` with ``staging="overlap"`` emits its per-leaf staging
work as independent :class:`TransferOp` s, and a scale-down's live KV
migration emits one op per block pair; they run on this bounded thread pool
while the serving thread keeps running decode ticks.  Staging only reads
the live weights (a pool bank's migrated-in pages land in pages the active
table leaves free) and a migration copy writes only reserved blocks, so
ticks concurrent with in-flight ops race with nothing.
``TransferSession.cancel`` is the abort barrier: pending ops never start,
running ops are joined — after it returns no worker touches the caller's
state.

On the card each worker thread owns one side ``torch.cuda.Stream`` (per
CUDA device an op names; created with the engine, for the ``devices`` it
is given, so no stream is created while a staging runs), and an op with
``devices`` runs under it while the serving thread issues its steps on the
default stream:

* **ordering** — the session's ``after`` events, recorded on the
  submitting thread's current (default) stream, are waited on by the side
  stream before the op's first copy: a copy then reads what the last
  decode step (or the boot) wrote;
* **landed, not enqueued** — a worker returns from ``fn`` as soon as its
  copies are enqueued, so the op records an event on each side stream
  after its last copy and waits for it in the worker thread
  (``Event.synchronize``, which is not a stream or device sync and so does
  not trip ``torch.cuda.set_sync_debug_mode``).  ``op.seconds``,
  ``t_done``, ``TransferSession.finished`` and ``last_done_t`` therefore
  describe copies that have landed: a commit never frees a shard a side
  stream still reads, and the first step after a migration never reads a
  row not yet written.

On CPU tensors an op (no ``devices``) runs ``fn`` in the worker thread with
no stream: dispatch by device, not a fallback.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as _futures_wait
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch import obs


def cuda_devices(devices: Iterable) -> Tuple[torch.device, ...]:
    """The distinct CUDA devices among ``devices`` (index made explicit),
    in first-seen order; empty for CPU devices."""
    out: List[torch.device] = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            continue
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d not in out:
            out.append(d)
    return tuple(out)


def ready_events(devices: Iterable[torch.device]
                 ) -> Dict[torch.device, "torch.cuda.Event"]:
    """An event recorded now on each CUDA device's current stream: what a
    side stream waits on before it reads what that stream wrote."""
    out = {}
    for d in cuda_devices(devices):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        out[d] = ev
    return out


@dataclasses.dataclass
class TransferOp:
    """One independent unit of transfer work.  ``fn`` reads only inputs
    captured at creation time and returns its result.  ``devices``: the
    CUDA devices ``fn`` copies on (empty: CPU work, no stream)."""
    index: int
    label: str
    fn: Callable[[], Any]
    devices: Tuple[torch.device, ...] = ()
    state: str = "pending"      # pending | running | done | failed | cancelled
    result: Any = None
    error: Optional[BaseException] = None
    seconds: float = 0.0        # start to landed (0 if never ran)
    t_done: float = 0.0         # perf_counter() when the copies had landed
    # device -> the completed event of the op's side stream there (the
    # default stream waits on it before it reads the op's results)
    events: Dict[torch.device, Any] = dataclasses.field(default_factory=dict)


class TransferSession:
    """A submitted batch of ops, polled, joined or cancelled as a unit;
    ``after`` maps a CUDA device to the event its side streams wait on."""

    def __init__(self, ops: List[TransferOp],
                 after: Optional[Dict[torch.device, Any]] = None):
        self.ops = ops
        self.after = dict(after or {})
        self.futures: List[Future] = []
        self.cancelled = threading.Event()

    def finished(self) -> bool:
        """Non-blocking: True once every op has landed (or was cancelled)."""
        return all(f.done() for f in self.futures)

    def remaining(self) -> int:
        return sum(1 for f in self.futures if not f.done())

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until every op has finished (at most ``timeout`` s);
        returns ``finished()``."""
        _futures_wait(self.futures, timeout=timeout)
        return self.finished()

    def cancel(self) -> None:
        """Cancel-or-join barrier: ops that have not started never will;
        ops already running are joined (their copies landed).  On return no
        worker thread holds a reference into the caller's state."""
        self.cancelled.set()
        for f in self.futures:
            f.cancel()
        _futures_wait(self.futures)
        for op, f in zip(self.ops, self.futures):
            if f.cancelled():
                op.state = "cancelled"

    def failed_ops(self) -> List[TransferOp]:
        return [op for op in self.ops if op.state == "failed"]

    @property
    def op_seconds(self) -> float:
        """Sum of the executed ops' times — the serial-equivalent transfer
        work (a cancelled op did none)."""
        return sum(op.seconds for op in self.ops
                   if op.state in ("done", "failed"))

    @property
    def last_done_t(self) -> float:
        return max((op.t_done for op in self.ops if op.t_done), default=0.0)


class TransferEngine:
    """Bounded worker pool issuing transfer ops off the serving thread.
    One per HMM, kept across scale events; ``max_workers`` bounds the
    copies' contention with the serving hot path.  ``devices``: the CUDA
    devices whose side streams (one per worker) are created here."""

    def __init__(self, max_workers: int = 4, devices: Iterable = ()):
        self.max_workers = max(1, int(max_workers))
        self._pool = ThreadPoolExecutor(max_workers=self.max_workers,
                                        thread_name_prefix="hmm-transfer")
        self._local = threading.local()     # a worker's side streams
        devs = cuda_devices(devices)
        # each worker thread takes one set on its first op
        self._free: "queue.SimpleQueue[Dict]" = queue.SimpleQueue()
        for _ in range(self.max_workers if devs else 0):
            self._free.put({d: torch.cuda.Stream(device=d) for d in devs})

    def submit(self, ops: List[TransferOp],
               after: Optional[Dict[torch.device, Any]] = None
               ) -> TransferSession:
        session = TransferSession(ops, after)
        session.futures = [self._pool.submit(self._run, session, op)
                           for op in ops]
        return session

    def _side_stream(self, device: torch.device):
        streams = getattr(self._local, "streams", None)
        if streams is None:
            try:
                streams = self._free.get_nowait()
            except queue.Empty:
                streams = {}
            self._local.streams = streams
        if device not in streams:
            streams[device] = torch.cuda.Stream(device=device)
        return streams[device]

    def _run_on_side_streams(self, session: TransferSession,
                             op: TransferOp) -> Any:
        """``fn`` under this worker's side streams, after the session's
        ``after`` events; returns once its copies have landed."""
        streams = [self._side_stream(d) for d in op.devices]
        events = {}
        try:
            with contextlib.ExitStack() as stack:
                for d, s in zip(op.devices, streams):
                    stack.enter_context(torch.cuda.stream(s))
                    if d in session.after:
                        s.wait_event(session.after[d])
                try:
                    return op.fn()
                finally:
                    # also after a failure: what fn enqueued must land
                    # before an abort unwinds the state it touches
                    for d, s in zip(op.devices, streams):
                        ev = torch.cuda.Event()
                        ev.record(s)
                        events[d] = ev
        finally:
            for ev in events.values():
                ev.synchronize()    # the copies have landed
            op.events = events

    def _run(self, session: TransferSession, op: TransferOp) -> None:
        if session.cancelled.is_set():
            # skipped: no span, no timing
            op.state = "cancelled"
            return
        op.state = "running"
        t0 = time.perf_counter()
        try:
            op.result = (self._run_on_side_streams(session, op)
                         if op.devices else op.fn())
            op.state = "done"
        except Exception as e:  # surfaced through failed_ops
            op.error = e
            op.state = "failed"
        finally:
            op.t_done = time.perf_counter()
            op.seconds = op.t_done - t0
            # on the worker thread's lane ("hmm-transfer-*")
            obs.get_tracer().complete(op.label, t0, op.t_done,
                                      cat="transfer",
                                      args={"state": op.state,
                                            "index": op.index})

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
