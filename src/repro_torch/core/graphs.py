"""The IMM's compile: an instance's steps captured as CUDA graphs, the
port's counterpart of the reference's AOT-compiled executables
(``repro.core.imm``, ``repro.serving.engine.compile_step_functions``).

``StepGraphs`` captures one configuration's steps over its bound tensors:

* the decode step (``decode``: ``_decode_fn`` or ``_paged_decode_fn``), one
  graph for every replica and TP rank, issued in the order the eager step
  issues them;
* with routing telemetry, its twin ``decode_routed`` beside it, over the
  same static input: its output holds the routing counts behind the
  tokens, so the engine's one read of the tokens brings them back too;
* with chunked prefill, the chunk step (``chunk_prefill_{C}``, paged or
  dense KV), one graph per replica;
* with monolithic prefill, each given bucket's prefill (``prefill_{S}``),
  one graph per bucket and replica.  A chunked engine never runs its
  prefill buckets, so none is captured there.

A graph reads one static int32 device buffer: the decode's tokens,
lengths, active mask and, paged, its block tables [B, MB] (ids local to
each replica's pool slice); the chunk's tokens [1, C], start, length and,
paged, its block table [1, MB] and chunk ids [C/bs], dense, its slot's row
(local to its replica's slice); a prefill's tokens [1, S], length and,
paged, its block ids [S/bs], dense, its row (one buffer a bucket, which its
replicas' graphs share).  ``decode``, ``chunk`` and ``prefill`` fill it
from a reused pinned host buffer (an event orders a fill after the copy of
the one before) and replay on the current (default) stream, so the events
that staging and migration record there order after the step as they do
after an eager one.  Every graph of a server captures into the server's
one memory pool, where they share their intermediates; so a graph's
output is read before another graph of the pool replays: the engine
copies the decode's tokens to the host at once, and reads a final chunk's
or a prefill's token at once.

Capture runs on the IMM's capture stream (neither the default stream nor
a TransferEngine stream) in ``thread_local`` mode: the TransferEngine's
workers go on copying and waiting on their events while the serving
thread captures a scale's target.  Capture launches nothing.  The first
capture on a capture stream, at boot, follows one eager warm-up of each
step on that stream, with every slot inactive, every chunk and prefill
block id the ``NB`` sentinel (no pool row is written) and every dense
chunk and prefill on row 0 of each replica's slice (no request is live
yet; the prefill or chunks that admit a slot rewrite its row): it loads
the kernels and creates the stream's split workspaces and cuBLAS
workspace while no request is live.  A scale's target is captured with no warm-up: its steps
issue the same kernels, which have run on that stream, and its tensors
may still be in flight.  A capture never grows the split counters and
workspaces (``_build.capturing``): a target with more slots than any set
before it finds them too small, so they are grown, counters zeroed on the
default stream, and that step is captured again over them.  A set is
captured step by step (``capture(limit)``), so a scale can spread it over
its staging's polls; it replays only once every step is captured.

``Binding`` records the tensors a set was captured over: every parameter
and cache tensor (each ``ShardedTensor`` shard) by identity and
``data_ptr``.  A graph holds raw addresses, so the IMM replays a set only
over exactly those tensors.  After a scale up and back down the
configuration's key is the same but its tensors are new allocations, and
the set is captured afresh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref
from functools import partial
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import (ShardedTensor,
                                              tree_leaves_with_path)
from repro_torch.kernels import _build


def _tensors(tree) -> List[torch.Tensor]:
    out = []
    for _, leaf in tree_leaves_with_path(tree):
        out.extend(leaf.shards.values() if isinstance(leaf, ShardedTensor)
                   else [leaf])
    return out


class Binding:
    """The parameter and cache tensors a step set was built over."""

    def __init__(self, params, cache):
        ts = _tensors(params) + _tensors(cache)
        self._refs = [weakref.ref(t) for t in ts]
        self.ptrs = tuple(t.data_ptr() for t in ts)

    def tensors(self) -> List[Optional[torch.Tensor]]:
        """The recorded tensors, None for each one that was freed."""
        return [r() for r in self._refs]

    def matches(self, params, cache) -> bool:
        """True if ``params`` and ``cache`` hold exactly the recorded
        tensors, each still at its recorded address."""
        ts = _tensors(params) + _tensors(cache)
        return (len(ts) == len(self._refs)
                and all(r() is t for r, t in zip(self._refs, ts))
                and tuple(t.data_ptr() for t in ts) == self.ptrs)


@dataclasses.dataclass
class CapturedStep:
    """A captured graph, its static output, and the kernel launches each
    replay makes (wrapper -> count)."""
    graph: Any
    out: torch.Tensor
    launches: Dict

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        return self.out


@contextlib.contextmanager
def _no_collection() -> Iterator[None]:
    """Python's cyclic garbage collector off inside the block: a
    collection during a capture could destroy an unreachable graph of an
    earlier set (its ``cudaGraphExecDestroy`` is not permitted on a
    capturing thread), which invalidates the capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def capture(fn: Callable[[], torch.Tensor], stream, pool) -> CapturedStep:
    """Capture ``fn()`` on ``stream`` into the memory pool ``pool``; a
    failed capture raises.  Where the capture found the stream's split
    counters or workspaces too small, they are grown outside it and the
    step is captured again over them.  No garbage collection runs during
    a capture (``_no_collection``)."""
    discarded = None
    for _ in range(2):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream), _build.capturing() as tally, \
                _no_collection():
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    g.capture_end()   # leaves the stream out of capture
                except RuntimeError:
                    pass              # the capture was invalidated
                raise
            g.capture_end()
        if not tally.short:
            return CapturedStep(g, out, tally.launches)
        # it read scratch buffers: never replayed, but kept until the next
        # capture holds the pool (a pool whose every graph is gone cannot
        # be captured into again)
        discarded, out = g, None
        _build.reserve(tally.short)
    raise RuntimeError("a capture still found its split buffers too small "
                       "after growing them")


class _StaticInput:
    """An int32 device buffer a graph reads, filled from a pinned host
    buffer by an asynchronous copy on the current stream."""

    def __init__(self, n: int, device):
        self.dev = torch.zeros(n, dtype=torch.int32, device=device)
        self.host = torch.zeros(n, dtype=torch.int32).pin_memory()
        self._np = self.host.numpy()
        self._copied = torch.cuda.Event()
        self._copied.record()

    def fill(self, *parts) -> None:
        self._copied.synchronize()        # the last fill's copy has landed
        o = 0
        for a in parts:
            a = np.asarray(a).ravel()
            self._np[o:o + a.size] = a
            o += a.size
        self.dev.copy_(self.host, non_blocking=True)
        self._copied.record()


class StepGraphs:
    """One configuration's decode step, per-replica chunk steps and
    per-replica prefill buckets over ``params`` and ``cache``, captured by
    ``capture``.  ``slots`` = every replica's slots; ``nb`` = a replica's
    pool blocks (the local ``NB`` sentinel); ``chunk`` = the chunk length
    (0: no chunk steps); ``buckets`` = the prefill buckets to capture."""

    def __init__(self, compiled, params, cache, *, slots: int, max_len: int,
                 paged: bool, block_size: int, nb: int, chunk: int,
                 buckets, replicas: int, device, stream, pool,
                 warmup: bool):
        B = slots
        MB = max_len // block_size if paged else 0
        self._dec = _StaticInput(3 * B + B * MB, device)
        d = self._dec.dev

        def decode_body(step):
            args = [d[:B], d[B:2 * B], d[2 * B:3 * B] != 0]
            if paged:
                args.append(d[3 * B:].view(B, MB))
            return step(params, cache, *args)[0]

        decodes = [k for k in ("decode", "decode_routed") if k in compiled]
        bodies = [partial(decode_body, compiled[k]) for k in decodes]
        self._routed = len(decodes) - 1      # the routed twin's index

        def placed(n):
            """The entries that place a chunk or prefill of ``n`` tokens:
            its block ids (paged) or its slot's row (dense)."""
            return n // block_size if paged else 1
        if chunk:
            C = chunk
            step = compiled[f"chunk_prefill_{C}"]
            self._chk = _StaticInput(C + 2 + MB + placed(C), device)
            c = self._chk.dev

            def chunk_body(r):
                tail = ([c[C + 2:C + 2 + MB].view(1, MB), c[C + 2 + MB:]]
                        if paged else [c[C + 2:]])
                return step(params, cache, c[:C].view(1, C), c[C:C + 1],
                            c[C + 1:C + 2], *tail, replica=r)[0]
            bodies += [partial(chunk_body, r) for r in range(replicas)]
        # bucket -> (its static input, the index of replica 0's graph)
        self._pre: Dict[int, tuple] = {}

        def prefill_body(step, p, S, r):
            return step(params, cache, p[:S].view(1, S), p[S:S + 1],
                        p[S + 1:], replica=r)[0]
        for S in buckets:
            inp = _StaticInput(S + 1 + placed(S), device)
            self._pre[S] = (inp, len(bodies))
            bodies += [partial(prefill_body, compiled[f"prefill_{S}"],
                               inp.dev, S, r) for r in range(replicas)]
        # the idle inputs: every slot inactive on the NB sentinel; a chunk
        # and a prefill of one token, on the NB sentinel (paged) or on row
        # 0 (dense)
        self._dec.fill(np.zeros(3 * B, np.int32), np.full(B * MB, nb))
        idle = np.full(MB + chunk // block_size, nb) if paged else [0]
        if chunk:
            self._chk.fill(np.zeros(C + 1, np.int32), [1], idle)
        for S, (inp, _) in self._pre.items():
            inp.fill(np.zeros(S, np.int32), [1],
                     np.full(S // block_size, nb) if paged else [0])
        if warmup:
            main = torch.cuda.current_stream(device)
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                for body in bodies:
                    body()
            main.wait_stream(stream)
        self._bodies, self._stream, self._pool = bodies, stream, pool
        self._graphs: List[CapturedStep] = []

    @property
    def pending(self) -> int:
        """The steps not captured yet."""
        return len(self._bodies) - len(self._graphs)

    def capture(self, limit: Optional[int] = None) -> None:
        """Capture the next ``limit`` pending steps (None: all): the decode
        steps first, then the chunk steps, then the prefill buckets."""
        todo = self._bodies[len(self._graphs):]
        for body in todo[:limit]:
            self._graphs.append(capture(body, self._stream, self._pool))

    def _graph(self, i: int) -> CapturedStep:
        if self.pending:
            raise RuntimeError(f"{self.pending} step(s) of this set are "
                               f"not captured yet")
        return self._graphs[i]

    def decode(self, tokens, lengths, active, block_tables=None
               ) -> torch.Tensor:
        """Replay the decode step on host arrays; returns the next tokens
        [B] (the graph's output: read it before another replay)."""
        return self._replay_decode(0, tokens, lengths, active, block_tables)

    def decode_routed(self, tokens, lengths, active, block_tables=None
                      ) -> torch.Tensor:
        """Replay the decode step's routing twin (captured only where the
        steps have one): the next tokens [B] followed by the routing
        counts [L_moe * E]."""
        if not self._routed:
            raise RuntimeError("this step set has no decode_routed graph")
        return self._replay_decode(self._routed, tokens, lengths, active,
                                   block_tables)

    def _replay_decode(self, i, tokens, lengths, active, block_tables):
        self._dec.fill(tokens, lengths, active,
                       () if block_tables is None else block_tables)
        return self._graph(i).replay()

    def chunk(self, replica: int, tokens, start: int, length: int,
              *where) -> torch.Tensor:
        """Replay replica ``replica``'s chunk step on host arrays
        (``where``: the block table and chunk ids, paged, or the slot's
        local row, dense); returns the token at the chunk's last valid
        position, [1] (the graph's output: read it before another
        replay)."""
        self._chk.fill(tokens, [start, length], *where)
        return self._graph(1 + self._routed + replica).replay()

    def has_prefill(self, bucket: int) -> bool:
        """True if the set holds graphs of prefill bucket ``bucket``."""
        return bucket in self._pre

    def prefill(self, replica: int, tokens, length: int, where
                ) -> torch.Tensor:
        """Replay replica ``replica``'s prefill of ``tokens`` [1, S] (S a
        captured bucket) on host arrays (``where``: the block ids, paged,
        or the slot's local row, dense); returns the token at position
        ``length - 1``, [1] (the graph's output: read it before another
        replay)."""
        inp, i = self._pre[np.shape(tokens)[-1]]
        inp.fill(tokens, [length], where)
        return self._graph(i + replica).replay()
