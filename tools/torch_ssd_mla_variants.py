#!/usr/bin/env python3
"""Time designs of the port's SSD scan and MLA decode kernels on one card.

Builds variants of ``src/repro_torch/csrc/ssd_scan.cu`` and
``src/repro_torch/csrc/mla_decode.cu`` (a constant or a piece of code
replaced, ``SSD_VARIANTS`` and ``MLA_VARIANTS``), each into its own library
with the port's ``nvcc`` flags, all builds at once, and times their bf16
tensor-core instances against each other through ctypes at the serving
path's shapes: the SSD scan of mamba2-1.3b's and zamba2-2.7b's 1,024-token
prefill, and deepseek-v2-lite-16b's decode over the latent cache at the
serving lengths (and at 2,048 tokens a sequence).  Every variant's output
is held against the plain version (``kernels/ref.py``) first.  Times: CUDA
events, each launch after an L2 flush (``chip_smoke.Timer``), the variants
in turns, forward then backward, the median of both passes.  Run from the
repository root on a machine with an H100 and ``nvcc``::

    python3 tools/torch_ssd_mla_variants.py [--json PATH] [--only a,b]
                                            [--profile]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

CSRC = os.path.join(ROOT, "src/repro_torch/csrc")
OUT_DIR = os.path.join(CSRC, "build/variants")

# C.B^T once per (sequence, chunk) into an f32 workspace [B, nc, Qp, Qp]
# by a kernel of its own (a warp per 16 rows, B and C read from L2), the
# output blocks reading their S tiles from it instead of recomputing them
# on the tensor cores (and staging no B rows)
_CB_KERNEL = r"""
__global__ void __launch_bounds__(32) ssd_cb_kernel(
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    float* __restrict__ ws_cb, int S, int N, int Q) {
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int Qp = pad16(Q), r0 = c * Q, qv = min(Q, S - r0);
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  const int iw = blockIdx.x * 16, KSN = pad16(N) / 16;
  uint32_t cf[MMA_N / 16][4];
  const bool ok0 = iw + gid < qv, ok1 = iw + gid + 8 < qv;
  const bf16* c0 = Cm + ((size_t)b * S + r0 + iw + gid) * N + 2 * tig;
#pragma unroll
  for (int ks = 0; ks < MMA_N / 16; ++ks) {
    const bool lo_k = 16 * ks < N, hi_k = 16 * ks + 8 < N;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(c0 + 16 * ks);
    const uint32_t* p1 =
        reinterpret_cast<const uint32_t*>(c0 + 8 * (size_t)N + 16 * ks);
    cf[ks][0] = ok0 && lo_k ? p0[0] : 0u;
    cf[ks][1] = ok1 && lo_k ? p1[0] : 0u;
    cf[ks][2] = ok0 && hi_k ? p0[4] : 0u;
    cf[ks][3] = ok1 && hi_k ? p1[4] : 0u;
  }
  float* out = ws_cb + (((size_t)b * nc + c) * Qp + iw + gid) * Qp + 2 * tig;
  for (int j0 = 0; j0 <= iw; j0 += 16) {
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = j0 + 8 * q + gid;
      const bool okj = j < qv;
      const bf16* brow = Bm + ((size_t)b * S + r0 + j) * N + 2 * tig;
#pragma unroll
      for (int ks = 0; ks < MMA_N / 16; ++ks) {
        if (ks < KSN) {
          const uint32_t b0 = okj && 16 * ks < N ?
              *reinterpret_cast<const uint32_t*>(brow + 16 * ks) : 0u;
          const uint32_t b1 = okj && 16 * ks + 8 < N ?
              *reinterpret_cast<const uint32_t*>(brow + 16 * ks + 8) : 0u;
          mma_bf16(s[q], cf[ks], b0, b1);
        }
      }
      *reinterpret_cast<float2*>(out + j0 + 8 * q) =
          make_float2(s[q][0], s[q][1]);
      *reinterpret_cast<float2*>(out + 8 * (size_t)Qp + j0 + 8 * q) =
          make_float2(s[q][2], s[q][3]);
    }
  }
}

size_t state_smem_bytes(int N, int P, int Q) {"""
_CB_WORKSPACE = [
    ("    const double* __restrict__ ws_acs, const uint4* __restrict__ ws_h,\n"
     "    float* __restrict__ y, int S, int H, int P, int N, int Q, int nc) {",
     "    const double* __restrict__ ws_acs, const uint4* __restrict__ ws_h,\n"
     "    float* __restrict__ y, int S, int H, int P, int N, int Q, int nc,\n"
     "    const float* __restrict__ ws_cb) {"),
    ("      stage(bs, SB, b_src + (size_t)t * JT * N, N, N, 0, JT, "
     "jend - t * JT,\n            OUT_THREADS);\n", ""),
    ("      const bf16* brow = bs + (kj * 16 + (lane & 7) + "
     "((lane >> 4) << 3)) *\n"
     "                                  SB + ((lane >> 3) & 1) * 8;\n"
     "#pragma unroll\n"
     "      for (int ks = 0; ks < MMA_N / 16; ++ks) {\n"
     "        if (ks < KSN) {\n"
     "          uint32_t r[4];\n"
     "          ldmatrix_x4(r, brow + ks * 16);\n"
     "          mma_bf16(s[0], cf[ks], r[0], r[1]);\n"
     "          mma_bf16(s[1], cf[ks], r[2], r[3]);\n"
     "        }\n"
     "      }\n",
     "      const float* cb = ws_cb + (((size_t)b * nc + c) * Qp + iw + gid) "
     "* Qp +\n                        j0 + 2 * tig;\n"
     "#pragma unroll\n"
     "      for (int q = 0; q < 2; ++q) {\n"
     "        const float2 u = __ldcg(reinterpret_cast<const float2*>(\n"
     "            cb + 8 * q));\n"
     "        const float2 v = __ldcg(reinterpret_cast<const float2*>(\n"
     "            cb + 8 * (size_t)Qp + 8 * q));\n"
     "        s[q][0] = u.x; s[q][1] = u.y; s[q][2] = v.x; s[q][3] = v.y;\n"
     "      }\n"),
    ("\nsize_t state_smem_bytes(int N, int P, int Q) {", "\n" + _CB_KERNEL),
    ("  float* ws_decay = reinterpret_cast<float*>(ws_acs + bhc * pad16(Q));",
     "  float* ws_decay = reinterpret_cast<float*>(ws_acs + bhc * pad16(Q));\n"
     "  float* ws_cb = ws_decay + ((bhc + 3) & ~(size_t)3);"),
    ("  ssd_chunk_out_kernel<<<dim3(nc * H, B, (pad16(Q) + TI - 1) / TI),",
     "  ssd_cb_kernel<<<dim3(pad16(Q) / 16, nc, B), 32, 0, stream>>>(\n"
     "      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), "
     "ws_cb, S,\n      N, Q);\n"
     "  ssd_chunk_out_kernel<<<dim3(nc * H, B, (pad16(Q) + TI - 1) / TI),"),
    ("      ws_acs, ws_h, static_cast<float*>(y), S, H, P, N, Q, nc);",
     "      ws_acs, ws_h, static_cast<float*>(y), S, H, P, N, Q, nc, ws_cb);"),
]
_JT = "constexpr int JT = 64; "
_STAGES = "constexpr int STAGES = 2;"
_TI = "constexpr int TI = 64; "
# S = C B_j^T summed in two chains (even and odd k-steps), halving the
# chain of dependent products a 16-row tile of S waits on
_SSD_CHAINS2 = [
    ("      float s[2][4];\n", "      float s[2][4], s2[2][4];\n"),
    ("        for (int e = 0; e < 4; ++e) s[q][e] = 0.f;\n"
     "      const bf16* brow",
     "        for (int e = 0; e < 4; ++e) s[q][e] = s2[q][e] = 0.f;\n"
     "      const bf16* brow"),
    ("          mma_bf16(s[0], cf[ks], r[0], r[1]);\n"
     "          mma_bf16(s[1], cf[ks], r[2], r[3]);\n        }\n      }\n",
     "          mma_bf16(ks & 1 ? s2[0] : s[0], cf[ks], r[0], r[1]);\n"
     "          mma_bf16(ks & 1 ? s2[1] : s[1], cf[ks], r[2], r[3]);\n"
     "        }\n      }\n#pragma unroll\n      for (int q = 0; q < 2; ++q)\n"
     "#pragma unroll\n        for (int e = 0; e < 4; ++e) s[q][e] += "
     "s2[q][e];\n"),
]
# diagnostics, whose outputs are wrong and not checked: the output kernel
# without one of its parts, to see what each part costs
_DIAG = {
    "diag_no_yoff": [("  if (active && c > 0) {", "  if (false) {")],
    "diag_no_s": [("          mma_bf16(s[0], cf[ks], r[0], r[1]);\n"
                   "          mma_bf16(s[1], cf[ks], r[2], r[3]);\n", "")],
    "diag_no_exp": [("expf((float)(acs_s[iw + gid] - ar)),",
                     "(float)(acs_s[iw + gid] - ar),"),
                    ("expf((float)(acs_s[iw + gid + 8] - ar))}",
                     "(float)(acs_s[iw + gid + 8] - ar)}")],
    "diag_no_mx": [("        if (2 * np < NTP) {",
                    "        if (2 * np < NTP && j0 < 0) {")],
}
# the hi and lo products of one accumulator issued apart, not back to
# back (each waits on the one before it), as the output kernel's C . h_c
# products are: fragments loaded first, then every hi product, then every
# lo product
_MX_ORDER = [(
    "#pragma unroll\n      for (int np = 0; np < MMA_P / 16; ++np) {\n"
    "        if (2 * np < NTP) {\n          uint32_t bv[4];\n"
    "          ldmatrix_x4_trans(bv, xrow + np * 16);\n"
    "          mma_bf16(o[2 * np], mh, bv[0], bv[1]);\n"
    "          mma_bf16(o[2 * np], ml, bv[0], bv[1]);\n"
    "          if (2 * np + 1 < NTP) {\n"
    "            mma_bf16(o[2 * np + 1], mh, bv[2], bv[3]);\n"
    "            mma_bf16(o[2 * np + 1], ml, bv[2], bv[3]);\n"
    "          }\n        }\n      }\n",
    "      uint32_t bv[MMA_P / 16][4];\n#pragma unroll\n"
    "      for (int np = 0; np < MMA_P / 16; ++np)\n"
    "        if (2 * np < NTP) ldmatrix_x4_trans(bv[np], xrow + np * 16);\n"
    "#pragma unroll\n      for (int np = 0; np < MMA_P / 16; ++np)\n"
    "        if (2 * np < NTP) {\n"
    "          mma_bf16(o[2 * np], mh, bv[np][0], bv[np][1]);\n"
    "          if (2 * np + 1 < NTP)\n"
    "            mma_bf16(o[2 * np + 1], mh, bv[np][2], bv[np][3]);\n"
    "        }\n#pragma unroll\n"
    "      for (int np = 0; np < MMA_P / 16; ++np)\n"
    "        if (2 * np < NTP) {\n"
    "          mma_bf16(o[2 * np], ml, bv[np][0], bv[np][1]);\n"
    "          if (2 * np + 1 < NTP)\n"
    "            mma_bf16(o[2 * np + 1], ml, bv[np][2], bv[np][3]);\n"
    "        }\n")]
_ST_ORDER = [(
    "          mma_bf16(acc[2 * q], ahi, bv[0], bv[1]);\n"
    "          mma_bf16(acc[2 * q], alo, bv[0], bv[1]);\n"
    "          mma_bf16(acc[2 * q + 1], ahi, bv[2], bv[3]);\n"
    "          mma_bf16(acc[2 * q + 1], alo, bv[2], bv[3]);\n",
    "          mma_bf16(acc[2 * q], ahi, bv[0], bv[1]);\n"
    "          mma_bf16(acc[2 * q + 1], ahi, bv[2], bv[3]);\n"
    "          mma_bf16(acc[2 * q], alo, bv[0], bv[1]);\n"
    "          mma_bf16(acc[2 * q + 1], alo, bv[2], bv[3]);\n")]
# the S products' B fragments all loaded before the first product
_S_HOIST = [(
    "#pragma unroll\n      for (int ks = 0; ks < MMA_N / 16; ++ks) {\n"
    "        if (ks < KSN) {\n          uint32_t r[4];\n"
    "          ldmatrix_x4(r, brow + ks * 16);\n"
    "          mma_bf16(s[0], cf[ks], r[0], r[1]);\n"
    "          mma_bf16(s[1], cf[ks], r[2], r[3]);\n        }\n      }\n",
    "      uint32_t r[MMA_N / 16][4];\n#pragma unroll\n"
    "      for (int ks = 0; ks < MMA_N / 16; ++ks)\n"
    "        if (ks < KSN) ldmatrix_x4(r[ks], brow + ks * 16);\n"
    "#pragma unroll\n      for (int ks = 0; ks < MMA_N / 16; ++ks)\n"
    "        if (ks < KSN) {\n"
    "          mma_bf16(s[0], cf[ks], r[ks][0], r[ks][1]);\n"
    "          mma_bf16(s[1], cf[ks], r[ks][2], r[ks][3]);\n        }\n")]
# the mma statements left to the compiler's scheduling (no volatile)
_MMA_PLAIN = [("  asm volatile(\n      \"mma.sync.aligned.m16n8k16",
               "  asm(\n      \"mma.sync.aligned.m16n8k16")]
SSD_VARIANTS = {
    "base": [],
    "mx_order": _MX_ORDER,
    "state_order": _ST_ORDER,
    "s_hoist": _S_HOIST,
    "mma_plain": _MMA_PLAIN,
    "cb_workspace": _CB_WORKSPACE,
    "jt32_stages3": [(_JT, "constexpr int JT = 32; "),
                     (_STAGES, "constexpr int STAGES = 3;")],
    "ti32": [(_TI, "constexpr int TI = 32; ")],
    "ti128": [(_TI, "constexpr int TI = 128; ")],
    "chains2": _SSD_CHAINS2,
    "bounds4": [("__global__ void __launch_bounds__(OUT_THREADS) "
                 "ssd_chunk_out_kernel(",
                 "__global__ void __launch_bounds__(OUT_THREADS, 4) "
                 "ssd_chunk_out_kernel(")],
    **_DIAG,
}
_SPAN = "constexpr int SPAN = 128; "
# P.C's hi and lo products of one accumulator issued apart (as above)
_PV_ORDER = [(
    "#pragma unroll\n        for (int np = 0; np < NTW / 2; ++np) {\n"
    "          uint32_t bv[4];\n"
    "          ldmatrix_x4_trans(bv, vrow + np * 16);\n"
    "          mma_bf16(o[2 * np], ah, bv[0], bv[1]);\n"
    "          mma_bf16(o[2 * np], al, bv[0], bv[1]);\n"
    "          mma_bf16(o[2 * np + 1], ah, bv[2], bv[3]);\n"
    "          mma_bf16(o[2 * np + 1], al, bv[2], bv[3]);\n        }\n",
    "        uint32_t bv[NTW / 2][4];\n#pragma unroll\n"
    "        for (int np = 0; np < NTW / 2; ++np)\n"
    "          ldmatrix_x4_trans(bv[np], vrow + np * 16);\n"
    "#pragma unroll\n        for (int np = 0; np < NTW / 2; ++np) {\n"
    "          mma_bf16(o[2 * np], ah, bv[np][0], bv[np][1]);\n"
    "          mma_bf16(o[2 * np + 1], ah, bv[np][2], bv[np][3]);\n"
    "        }\n#pragma unroll\n"
    "        for (int np = 0; np < NTW / 2; ++np) {\n"
    "          mma_bf16(o[2 * np], al, bv[np][0], bv[np][1]);\n"
    "          mma_bf16(o[2 * np + 1], al, bv[np][2], bv[np][3]);\n"
    "        }\n")]
MLA_VARIANTS = {
    "span128": [],
    "pv_order": _PV_ORDER,
    "span64": [(_SPAN, "constexpr int SPAN = 64; ")],
    "span256": [(_SPAN, "constexpr int SPAN = 256; ")],
}
# the SSD scans of a 1,024-token prefill, (B, S, H, P, N, chunk)
SSD_CASES = [("mamba2", (1, 1024, 64, 64, 128, 256)),
             ("zamba2", (1, 1024, 80, 64, 64, 128))]
MLA_CASES = [("serving lengths", [2048, 1, 17, 333, 1024, 1500, 64, 777]),
             ("2048 each", [2048] * 8)]


def _variant_source(kernel, name, table):
    with open(os.path.join(CSRC, f"{kernel}.cu")) as f:
        src = f.read()
    for old, new in table[name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} found "
                             f"{src.count(old)} times in {kernel}.cu")
        src = src.replace(old, new)
    return src


def build(jobs):
    """``jobs``: [(kernel, variant, replacements table, signatures)] ->
    {(kernel, variant): library}, every nvcc started at once."""
    from repro_torch.kernels import _build
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for kernel, name, table, sigs in jobs:
        cu = os.path.join(OUT_DIR, f"{kernel}_{name}.cu")
        with open(cu, "w") as f:
            f.write(_variant_source(kernel, name, table))
        so = os.path.join(OUT_DIR, f"lib{kernel}_{name}.so")
        procs[kernel, name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so,
            sigs)
    libs = {}
    for key, (proc, so, sigs) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {key}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
        print(f"built {key[0]} {key[1]}", flush=True)
    return libs


def _turns(timer, launchers):
    """Each launcher timed in turns, forward then backward: {name: ms}."""
    times = {n: [] for n in launchers}
    for order in (list(launchers), list(launchers)[::-1]):
        for n in order:
            times[n].append(timer(launchers[n]))
    return {n: statistics.median(t) for n, t in times.items()}


def _profile_kernels(label, fn, timer, n=10):
    """Device time of each kernel ``fn`` launches, averaged over ``n``
    calls each after the timer's L2 flush and device sleep."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            timer.flush.zero_()
            torch.cuda._sleep(200_000)
            fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                ("ssd_" in ev.key or "mla_" in ev.key):
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            rows[name] = ev.self_device_time_total / 1e3 / n
    print(f"  profile {label}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in rows.items()), flush=True)
    return rows


def time_ssd(libs, names, timer, gen, profile=False):
    from chip_smoke import SSD_TOL
    from repro_torch.kernels import ref, ssd_scan
    rows = []
    for label, (B, S, H, P, N, chunk) in SSD_CASES:
        x = torch.randn(B, S, H, P, generator=gen).to(torch.bfloat16).cuda()
        dt = (torch.rand(B, S, H, generator=gen) * 0.5 + 0.01).cuda()
        A = (-(torch.rand(H, generator=gen) + 0.5)).cuda()
        Bm = torch.randn(B, S, N, generator=gen).to(torch.bfloat16).cuda()
        Cm = torch.randn(B, S, N, generator=gen).to(torch.bfloat16).cuda()
        Q = min(chunk, S)
        nc = -(-S // Q)
        # room for the largest variant's workspace (cb_workspace's C.B^T)
        ws = torch.empty(ssd_scan.workspace_bytes(B, S, H, P, N, Q) + 16
                         + 4 * B * nc * ssd_scan._pad(Q) ** 2,
                         dtype=torch.uint8, device="cuda")
        y = torch.empty(B, S, H, P, device="cuda")
        st = torch.empty(B, H, N, P, device="cuda")
        wy, wst = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
        stream = torch.cuda.current_stream().cuda_stream

        def launcher(lib):
            return lambda: lib.ssd_scan_launch(
                1, 1, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), st.data_ptr(),
                ws.data_ptr(), B, S, H, P, N, Q, stream)

        for n in names:
            rc = launcher(libs["ssd_scan", n])()
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"ssd_scan {n} {label}: launch returned "
                                 f"{rc}")
            if not n.startswith("diag_"):
                torch.testing.assert_close(y, wy, **SSD_TOL)
                torch.testing.assert_close(st, wst, **SSD_TOL)
        ms = _turns(timer, {n: launcher(libs["ssd_scan", n]) for n in names})
        rows.append({"kernel": "ssd_scan", "case": label, "ms": ms})
        print(f"ssd_scan {label}: " + ", ".join(
            f"{n} {t:.4f}" for n, t in ms.items()), flush=True)
        if profile:
            rows[-1]["profile"] = {
                n: _profile_kernels(f"{label} {n}",
                                    launcher(libs["ssd_scan", n]), timer)
                for n in names}
    return rows


def time_mla(libs, names, timer, gen):
    from chip_smoke import MLA_DN, MLA_DR, MLA_H, MLA_R, TOL
    from repro_torch.kernels import ref
    rows = []
    B, H, r, dr, S = 8, MLA_H, MLA_R, MLA_DR, 2048
    scale = (MLA_DN + dr) ** -0.5
    spread = 3 / scale
    qe = (torch.randn(B, H, r, generator=gen) * spread * r ** -0.5) \
        .to(torch.bfloat16).cuda()
    qr = (torch.randn(B, H, dr, generator=gen) * spread * dr ** -0.5) \
        .to(torch.bfloat16).cuda()
    c = torch.randn(B, S, r, generator=gen).to(torch.bfloat16).cuda()
    kr = torch.randn(B, S, dr, generator=gen).to(torch.bfloat16).cuda()
    out = torch.empty_like(qe)
    # room for the smallest span's splits (64 tokens)
    n_acc = B * 16 * (S // 64) * r
    ws = torch.empty(n_acc + 2 * n_acc // r, device="cuda")
    done = torch.zeros(B, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for label, lengths in MLA_CASES:
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        want = ref.mla_decode_attention_ref(qe, qr, c, kr, lens, scale)

        def launcher(lib):
            return lambda: lib.mla_decode_attention_launch(
                1, qe.data_ptr(), qr.data_ptr(), c.data_ptr(), kr.data_ptr(),
                lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
                ws.data_ptr() + 4 * n_acc, done.data_ptr(), B, H, S, r, dr,
                scale, stream)

        for n in names:
            rc = launcher(libs["mla_decode", n])()
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"mla_decode {n} {label}: launch returned "
                                 f"{rc}")
            torch.testing.assert_close(out.float(), want.float(),
                                       **TOL[torch.bfloat16])
        ms = _turns(timer, {n: launcher(libs["mla_decode", n])
                            for n in names})
        rows.append({"kernel": "mla_decode_attention", "case": label,
                     "ms": ms})
        print(f"mla_decode_attention {label}: " + ", ".join(
            f"{n} {t:.4f}" for n, t in ms.items()), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json")
    ap.add_argument("--only", help="comma-separated variants (default all)")
    ap.add_argument("--profile", action="store_true",
                    help="also print each SSD variant's kernels' device "
                         "times (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ssd_mla_variants.py: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from chip_smoke import Timer
    from repro_torch.device import resolve_device
    from repro_torch.kernels import mla_decode, ssd_scan
    resolve_device("cuda")
    only = set(args.only.split(",")) if args.only else None
    ssd = [n for n in SSD_VARIANTS if only is None or n in only]
    mla = [n for n in MLA_VARIANTS if only is None or n in only]
    libs = build([("ssd_scan", n, SSD_VARIANTS, ssd_scan._SIGNATURES)
                  for n in ssd] +
                 [("mla_decode", n, MLA_VARIANTS, mla_decode._SIGNATURES)
                  for n in mla])
    timer = Timer()
    gen = torch.Generator().manual_seed(0)
    results = []
    if ssd:
        results += time_ssd(libs, ssd, timer, gen, args.profile)
    if mla:
        results += time_mla(libs, mla, timer, gen)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "results": results}, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
