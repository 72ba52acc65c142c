"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled on first use into its
own shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o csrc/build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and flags, so an edited source
never loads a stale library.  ``build()`` starts one ``nvcc`` per source,
all at once.  The build directory lies inside the package and is listed in
``.gitignore``.  Nothing here runs at import time: this module imports on
machines without ``nvcc`` or a card, and only a CUDA tensor reaches it.

Each wrapper counts its launches through ``count_launch``.  While a CUDA
graph is captured on the calling thread (``capturing``), nothing is
launched: the count goes to the capture's tally instead, and the graph adds
the tally to the wrappers' counts at each replay, when the kernels run.
Nor does a capture grow the split counters or workspaces: a zero fill
captured into a graph would run only at its replays, so a capture that
finds them too small records the sizes it needs (``Tally.short``) and
gets scratch; the caller grows them with ``reserve`` and captures again.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Iterator, List, Sequence

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("paged_attention", "paged_decode", "moe_gmm", "flash_attention",
           "flash_attention_bwd", "kv_write", "mla_decode", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: (device index, stream) -> the int32 split counters of that stream's
#: launches, zero between launches
_counters: Dict[tuple, torch.Tensor] = {}
#: (device index, stream) -> the f32 split workspace of that stream's
#: launches
_workspaces: Dict[tuple, torch.Tensor] = {}
#: counters and workspaces a larger one replaced: a captured CUDA graph
#: may still name them, so they are never freed
_retired: List[torch.Tensor] = []
#: the ``Tally`` of the CUDA graph being captured on this thread
_tally: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_launch_tally", default=None)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the "
                           "port's CUDA kernels cannot be built here")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source in ``names`` whose library is missing, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: {"seconds": wall time, "log": nvcc's -Xptxas -v report}}`` for
    the sources compiled by this call; raises with nvcc's output on a
    failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)        # atomic: concurrent builders agree
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if missing, with
    ``argtypes`` set from ``signatures`` ({function: [ctypes types]}; every
    pointer and the stream a ``c_void_p``) and ``restype`` ``c_int``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


class Tally:
    """What the wrappers did during a capture: the launches each replay
    will make (wrapper -> count), and the split buffers found too small
    ((device, stream) -> [counters, workspace values] needed)."""

    def __init__(self):
        self.launches: Dict = {}
        self.short: Dict[tuple, List[int]] = {}


def _split_buffer(table: Dict[tuple, torch.Tensor], slot: int,
                  dev: torch.device, stream: int, n: int,
                  dtype) -> torch.Tensor:
    key = (dev.index, stream)
    buf = table.get(key)
    if buf is not None and buf.numel() >= n:
        return buf
    tally = _tally.get()
    if tally is not None:
        # capturing: no buffer that outlives this graph is made here
        need = tally.short.setdefault((dev, stream), [0, 0])
        need[slot] = max(need[slot], n)
        return torch.empty(n, dtype=dtype, device=dev)
    if buf is not None:
        _retired.append(buf)
    buf = table[key] = torch.zeros(n, dtype=dtype, device=dev)
    return buf


def split_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``dev`` for the split-merging kernels
    launched on ``stream``: the last block of each group of splits counts
    on them and resets its counter to zero, so every launch leaves them
    zero and one buffer per (device, stream) serves every launch there
    (launches on one stream never overlap) without a memset.  During a
    capture a buffer too small is not grown (see ``Tally``)."""
    return _split_buffer(_counters, 0, dev, stream, n, torch.int32)


def split_workspace(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` f32 values on ``dev`` where the split-merging kernels
    launched on ``stream`` store each split's partial sums.  A launch
    writes every split it reads before its last block reads them, so one
    buffer per (device, stream), grown when a launch needs more, serves
    every launch there; launches on one stream never overlap.  During a
    capture a buffer too small is not grown (see ``Tally``)."""
    return _split_buffer(_workspaces, 1, dev, stream, n, torch.float32)


def reserve(short: Dict[tuple, List[int]]) -> None:
    """Grow the split counters and workspaces to a capture's ``short``
    sizes, outside any capture: the counters are zeroed on the calling
    thread's current stream, where the graphs replay."""
    for (dev, stream), (n_counters, n_ws) in short.items():
        split_counters(dev, stream, n_counters)
        split_workspace(dev, stream, n_ws)


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: on ``wrapper.launches``, or,
    while a CUDA graph is captured on this thread, on the capture's
    tally."""
    tally = _tally.get()
    if tally is None:
        wrapper.launches += 1
    else:
        tally.launches[wrapper] = tally.launches.get(wrapper, 0) + 1


@contextlib.contextmanager
def capturing() -> Iterator[Tally]:
    """Inside the block the wrappers count into the yielded ``Tally``
    instead of their own counts, and leave the split buffers as they are:
    a graph's capture, which launches nothing."""
    tally = Tally()
    token = _tally.set(tally)
    try:
        yield tally
    finally:
        _tally.reset(token)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
