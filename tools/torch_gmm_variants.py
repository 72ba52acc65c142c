#!/usr/bin/env python3
"""Time blockings and designs of the port's paged expert GMMs on one card.

Builds variants of ``src/repro_torch/csrc/moe_gmm.cu`` (its constants or a
piece of its code replaced, ``VARIANTS``) and one CUDA-core GEMV with
16-byte loads written here (``GEMV_CU``, decode's C = 1 only), each into
its own library with the port's ``nvcc`` flags, all builds at once, and
times each against the others through ctypes at the serving path's shapes
(qwen3-30b-a3b's banks at decode, C = 1, and at a chunk step, C = 10;
deepseek-v2-lite-16b's at a 1,024-token prefill, C = 120), bf16 x over
bf16 and int8 pages.  Every variant's output is held against the plain
version (``kernels/ref.py``) first.  Times: CUDA events, each launch after
an L2 flush (``chip_smoke.Timer``), the variants in turns, forward then
backward, the median of both passes.  Run from the repository root on a
machine with an H100 and ``nvcc``::

    python3 tools/torch_gmm_variants.py [--json PATH] [--only a,b]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

SOURCE = os.path.join(ROOT, "src/repro_torch/csrc/moe_gmm.cu")
OUT_DIR = os.path.join(ROOT, "src/repro_torch/csrc/build/variants")

_STAGES = ("static constexpr int STAGES = NT >= 16 || sizeof(W) == 1 ? 3 : "
           "4;")
# int8 pages converted to a bf16 tile in shared memory once per k-tile (all
# threads, one more barrier), then read as bf16 pages are
_SMEM_I8 = [
    ("  static constexpr int BYTES = STAGES * STAGE;",
     "  static constexpr int CVT_ROW = FT * 2 + 16;\n"
     "  static constexpr int CVT = std::is_same<W, int8_t>::value ? "
     "KT * CVT_ROW : 0;\n"
     "  static constexpr int BYTES = STAGES * STAGE + CVT;"),
    ("    const unsigned char* xs = ws + R::W_TILE;\n#pragma unroll\n"
     "    for (int ks = 0;",
     "    const unsigned char* xs = ws + R::W_TILE;\n"
     "    if constexpr (QUANT) {\n"
     "      unsigned char* cvt = smem + R::STAGES * R::STAGE;\n"
     "      for (int p = tid; p < KT * FT / 4; p += MMA_THREADS) {\n"
     "        const int r = p / (FT / 4), q = p % (FT / 4);\n"
     "        const uint32_t w = *reinterpret_cast<const uint32_t*>(\n"
     "            ws + r * R::W_ROW + q * 4);\n"
     "        uint32_t ev, od;\n"
     "        i8x4_bf16(__byte_perm(w, 0, 0x3120), ev, od);\n"
     "        *reinterpret_cast<uint2*>(cvt + r * R::CVT_ROW + q * 8) =\n"
     "            make_uint2(ev, od);\n"
     "      }\n"
     "      __syncthreads();\n"
     "      ws = cvt;\n"
     "    }\n"
     "#pragma unroll\n    for (int ks = 0;"),
    ("    const unsigned char* ws = smem + (kt % R::STAGES) * R::STAGE;",
     "    const unsigned char* ws = smem + (kt % R::STAGES) * R::STAGE;\n"
     "    const int w_row = QUANT ? R::CVT_ROW : R::W_ROW;"),
    ("      const unsigned char* arow = ws + (ks * 16 + a_row) * R::W_ROW "
     "+ a_col;\n      if constexpr (QUANT) {",
     "      const unsigned char* arow = ws + (ks * 16 + a_row) * w_row + "
     "a_col;\n      if constexpr (false) {"),
    ("  const int a_col = QUANT ? warp * 32 + ((lane >> 3) & 1) * 16\n"
     "                          : (warp * 32 + ((lane >> 3) & 1) * 8) * 2;",
     "  const int a_col = (warp * 32 + ((lane >> 3) & 1) * 8) * 2;"),
    ("        const int col = QUANT ? warp * 32 + half * 16 + 2 * g + m\n"
     "                              : warp * 32 + m * 16 + half * 8 + g;",
     "        const int col = warp * 32 + m * 16 + half * 8 + g;"),
]
# int8 converted by two bit masks and one bf16x2 add per pair (a byte
# v = l - 128 s is bf16(128 + l) + bf16(-128 - 128 s)): 7 instructions for
# 4 bytes, not 11
_ADD_I8 = [(
    "  const uint32_t u = w ^ 0x80808080u;\n  float x[4];\n#pragma unroll\n"
    "  for (int j = 0; j < 4; ++j)\n"
    "    x[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -\n"
    "           8388736.f;\n"
    "  even = __byte_perm(__float_as_uint(x[0]), __float_as_uint(x[2]), "
    "0x7632u);\n"
    "  odd = __byte_perm(__float_as_uint(x[1]), __float_as_uint(x[3]), "
    "0x7632u);",
    "  uint32_t lo = (w & 0x007F007Fu) | 0x43004300u, "
    "hi = (w & 0x00800080u) | 0xC300C300u;\n"
    "  asm(\"add.rn.bf16x2 %0, %1, %2;\" : \"=r\"(even) : \"r\"(lo), "
    "\"r\"(hi));\n"
    "  lo = ((w >> 8) & 0x007F007Fu) | 0x43004300u;\n"
    "  hi = ((w >> 8) & 0x00800080u) | 0xC300C300u;\n"
    "  asm(\"add.rn.bf16x2 %0, %1, %2;\" : \"=r\"(odd) : \"r\"(lo), "
    "\"r\"(hi));")]
VARIANTS = {
    "base": [],
    "i8_bf16x2_add": _ADD_I8,
    "stages4": [(_STAGES, "static constexpr int STAGES = NT >= 16 ? 3 : 4;")],
    "stages2": [(_STAGES, "static constexpr int STAGES = 2;")],
    "stages3": [(_STAGES, "static constexpr int STAGES = 3;")],
    "stages5": [(_STAGES, "static constexpr int STAGES = NT >= 16 ? 3 : 5;")],
    "ft256": [("constexpr int FT = 128; ", "constexpr int FT = 256; ")],
    "ft256_stages3": [("constexpr int FT = 128; ", "constexpr int FT = 256; "),
                      (_STAGES, "static constexpr int STAGES = 3;")],
    "kt128_stages3": [("constexpr int KT = 64; ", "constexpr int KT = 128; "),
                      (_STAGES, "static constexpr int STAGES = 3;")],
    "i8_in_smem": _SMEM_I8,
}

# CUDA cores, 16-byte loads, C = 1: a block of 8 warps over 128 columns,
# each lane 16 bytes of a row (8 bf16 or 16 int8 columns), the lanes of a
# warp over 32 * 16 / (128 * size) rows at a time, each warp its own
# eighth of the page's rows with 4 loads in flight; partial sums over rows
# by shuffles, over warps in warp order through shared memory.
GEMV_CU = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int COLS = 128, WARPS = 8;
template <typename W>
__global__ void __launch_bounds__(32 * WARPS) gemv(
    const int32_t* __restrict__ table, const __nv_bfloat16* __restrict__ x,
    const W* __restrict__ pool, const float* __restrict__ scales,
    __nv_bfloat16* __restrict__ out, int D, int F, int P) {
  constexpr int VALS = 16 / sizeof(W);
  constexpr int LANES_ROW = COLS / VALS;       // 16 (bf16) or 8 (int8)
  constexpr int ROWS_LOAD = 32 / LANES_ROW;    // 2 or 4
  __shared__ float xs[4096];
  __shared__ float part[WARPS][COLS];
  const int e = blockIdx.y, f0 = blockIdx.x * COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int page = min(max(table[e], 0), P - 1);
  const W* wp = pool + (size_t)page * D * F;
  for (int d = threadIdx.x; d < D; d += 32 * WARPS)
    xs[d] = __bfloat162float(x[(size_t)e * D + d]);
  __syncthreads();
  const int sub = lane / LANES_ROW, col = (lane % LANES_ROW) * VALS;
  const int rpw = (D + WARPS - 1) / WARPS;
  const int r0 = warp * rpw, r1 = min(r0 + rpw, D);
  float acc[VALS];
#pragma unroll
  for (int j = 0; j < VALS; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int d = r0 + sub; d < r1; d += ROWS_LOAD) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        wp + (size_t)d * F + f0 + col));
    const float xv = xs[d];
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(W) == 2) {
        acc[2 * k] = fmaf(xv, __uint_as_float(u[k] << 16), acc[2 * k]);
        acc[2 * k + 1] =
            fmaf(xv, __uint_as_float(u[k] & 0xffff0000u), acc[2 * k + 1]);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[4 * k + b] = fmaf(
              xv, (float)(int8_t)(u[k] >> (8 * b)), acc[4 * k + b]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VALS; ++j)
    for (int o = LANES_ROW; o < 32; o *= 2)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  if (sub == 0)
#pragma unroll
    for (int j = 0; j < VALS; ++j) part[warp][col + j] = acc[j];
  __syncthreads();
  if (threadIdx.x < COLS) {
    float s = 0.f;
    for (int k = 0; k < WARPS; ++k) s += part[k][threadIdx.x];
    if (scales) s *= scales[page];
    out[(size_t)e * F + f0 + threadIdx.x] = __float2bfloat16(s);
  }
}
}  // namespace
extern "C" {
int paged_gmm_launch(int dtype, const void* t, const void* x, const void* p,
                     void* o, int E, int C, int D, int F, int P, int inst,
                     void* s) {
  if (dtype != 1 || C != 1 || F % COLS || D > 4096) return 1;
  gemv<__nv_bfloat16><<<dim3(F / COLS, E), 32 * WARPS, 0,
                        (cudaStream_t)s>>>(
      (const int32_t*)t, (const __nv_bfloat16*)x, (const __nv_bfloat16*)p,
      nullptr, (__nv_bfloat16*)o, D, F, P);
  return (int)cudaGetLastError();
}
int quant_paged_gmm_launch(int dtype, const void* t, const void* x,
                           const void* p, const void* sc, void* o, int E,
                           int C, int D, int F, int P, int inst, void* s) {
  if (dtype != 1 || C != 1 || F % COLS || D > 4096) return 1;
  gemv<int8_t><<<dim3(F / COLS, E), 32 * WARPS, 0, (cudaStream_t)s>>>(
      (const int32_t*)t, (const __nv_bfloat16*)x, (const int8_t*)p,
      (const float*)sc, (__nv_bfloat16*)o, D, F, P);
  return (int)cudaGetLastError();
}
}
"""

# (label, pages, bank shape (E, D, F), C)
CASES = [
    ("qwen3 wi C=1", "bf16", (128, 2048, 768), 1),
    ("qwen3 wo C=1", "bf16", (128, 768, 2048), 1),
    ("qwen3 wi C=10", "bf16", (128, 2048, 768), 10),
    ("qwen3 wo C=10", "bf16", (128, 768, 2048), 10),
    ("qwen3 wi C=1", "int8", (128, 2048, 768), 1),
    ("qwen3 wo C=1", "int8", (128, 768, 2048), 1),
    ("qwen3 wi C=10", "int8", (128, 2048, 768), 10),
    ("qwen3 wo C=10", "int8", (128, 768, 2048), 10),
    ("deepseek wi C=120", "bf16", (64, 2048, 1408), 120),
]


def _variant_source(name):
    with open(SOURCE) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} found "
                             f"{src.count(old)} times in moe_gmm.cu")
        src = src.replace(old, new)
    return src


def build(names):
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import _SIGNATURES
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src = GEMV_CU if name == "gemv16" else _variant_source(name)
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT_DIR, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        print(f"built {name}", flush=True)
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json")
    ap.add_argument("--only", help="comma-separated variants (default all, "
                                   "and gemv16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_gmm_variants.py: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from chip_smoke import TOL, Timer
    from repro_torch.device import resolve_device
    from repro_torch.kernels import moe_gmm, ref
    resolve_device("cuda")
    names = (args.only.split(",") if args.only
             else list(VARIANTS) + ["gemv16"])
    libs = build(names)
    timer = Timer()
    gen = torch.Generator().manual_seed(0)
    results = []
    for label, pages, (E, D, F), C in CASES:
        quant = pages == "int8"
        P = 2 * E
        table = torch.randperm(P, generator=gen)[:E].to(torch.int32).cuda()
        x = torch.randn(E, C, D, generator=gen).to(torch.bfloat16).cuda()
        if quant:
            pool = torch.randint(-127, 128, (P, D, F), generator=gen,
                                 dtype=torch.int8).cuda()
            scales = ((0.3 + 2.7 * torch.rand(P, generator=gen))
                      / (127 * math.sqrt(D))).cuda()
            want = ref.quant_paged_gmm_ref(table, pool, scales, x)
        else:
            pool = (torch.randn(P, D, F, generator=gen)
                    / math.sqrt(D)).to(torch.bfloat16).cuda()
            scales = None
            want = ref.paged_gmm_ref(table, pool, x)
        out = torch.empty(E, C, F, dtype=torch.bfloat16, device="cuda")
        inst = moe_gmm.INSTANCES[moe_gmm.gmm_instance(
            x.dtype, pool.dtype, D, F, x.data_ptr(), pool.data_ptr())]
        stream = torch.cuda.current_stream().cuda_stream

        def launcher(lib):
            if quant:
                return lambda: lib.quant_paged_gmm_launch(
                    1, table.data_ptr(), x.data_ptr(), pool.data_ptr(),
                    scales.data_ptr(), out.data_ptr(), E, C, D, F, P, inst,
                    stream)
            return lambda: lib.paged_gmm_launch(
                1, table.data_ptr(), x.data_ptr(), pool.data_ptr(),
                out.data_ptr(), E, C, D, F, P, inst, stream)

        live = [n for n in names if not (n == "gemv16" and C != 1)]
        for n in live:
            out.zero_()
            rc = launcher(libs[n])()
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"{n} {label} {pages}: launch returned {rc}")
            torch.testing.assert_close(out.float(), want.float(),
                                       **TOL[torch.bfloat16])
        times = {n: [] for n in live}
        for order in (live, live[::-1]):
            for n in order:
                times[n].append(timer(launcher(libs[n])))
        row = {"case": label, "pages": pages,
               "ms": {n: statistics.median(t) for n, t in times.items()}}
        results.append(row)
        print(f"{label} {pages}: " + ", ".join(
            f"{n} {ms:.4f}" for n, ms in row["ms"].items()), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "results": results}, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
