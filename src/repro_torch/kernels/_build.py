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
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Sequence

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("paged_attention", "paged_decode", "moe_gmm", "flash_attention",
           "kv_write", "mla_decode", "ssd_scan")
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


def split_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``dev`` for the split-merging kernels
    launched on ``stream``: the last block of each group of splits counts
    on them and resets its counter to zero, so every launch leaves them
    zero and one buffer per (device, stream) serves every launch there
    (launches on one stream never overlap) without a memset."""
    key = (dev.index, stream)
    done = _counters.get(key)
    if done is None or done.numel() < n:
        done = _counters[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return done


def split_workspace(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` f32 values on ``dev`` where the split-merging kernels
    launched on ``stream`` store each split's partial sums.  A launch
    writes every split it reads before its last block reads them, so one
    buffer per (device, stream), grown when a launch needs more, serves
    every launch there; launches on one stream never overlap."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < n:
        ws = _workspaces[key] = torch.empty(n, dtype=torch.float32,
                                            device=dev)
    return ws


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
