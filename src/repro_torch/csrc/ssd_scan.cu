// Mamba2 SSD chunk scan (one B/C group), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_scan
// (src/repro/kernels/ssd_scan.py:67).
//
// What it computes.  x [B,S,H,P] (bf16 or f32); dt [B,S,H] f32 (> 0); A [H]
// f32 (< 0); Bm/Cm [B,S,N] of x's type, shared by every head -> y [B,S,H,P]
// f32 and the final state [B,H,N,P] f32, the state starting at zero.  Per
// (b, h), chunks of Q = min(chunk, S) rows, a = dt * A[h], acs the inclusive
// cumsum of a within the chunk:
//   y_c   = (C_c . state) * exp(acs)[:,None]
//         + ((C_c . B_c^T) o exp(acs_i - acs_j)[i >= j] o dt_j) . x_c
//   state <- state * exp(acs[-1]) + (B_c * (exp(acs[-1] - acs) * dt))^T . x_c
// in f32 -- the Pallas kernel's arithmetic.  A ragged last chunk (S not a
// multiple of Q, which the Pallas kernel refuses) reads its rows past S as
// dt = 0 and x = B = C = 0: decay 1 and no input, so the result is exact for
// any S.
//
// Bound on an H100.  The bytes: x, dt, B, C read once, y (f32) and the state
// written once -- at mamba2-1.3b's prefill (B=1, S=1024, H=64, P=64, N=128,
// bf16 x) 28.05 MB, 8.4 us at 3.35 TB/s; the operations with C.B^T once
// per (sequence, chunk) are 4.4 GFLOP, 4.5 us at the bf16 tensor-core rate
// (the Pallas kernel's, C.B^T per head, 8.6 GFLOP).  zamba2-2.7b (H=80,
// N=64, chunk 128): 33.36 MB, 10.0 us.  The workspaces below are the
// kernel's own traffic, not the bound's.
//
// Design: the chunk-parallel SSD algorithm (Mamba-2, arXiv:2405.21060,
// section 6).  The Pallas grid walks the chunks of a (sequence, head) in
// order, carrying the state in VMEM; on a GPU that chain left one thin block
// per (head, 32 columns) walking 4 chunks one after the other.  Here the
// chain is cut out of the heavy work: with h_c the state entering chunk c
// and S_c the chunk's own input,
//   y_c = exp(acs) o (C_c . h_c) + (C_c B_c^T o L o dt) . x_c,
//   h_{c+1} = h_c exp(acs_c[-1]) + S_c,  S_c = (B_c o w_c)^T . x_c,
//   w_c = exp(acs_c[-1] - acs_c) o dt_c,
// S_c and y_c depend on the other chunks only through h_c, an elementwise
// recurrence of N x P values per head.  Three launches (bf16 x, N and P
// multiples of 8, N <= 128, P <= 64, 16-byte aligned rows):
//   1. ssd_chunk_state_kernel, a block per (chunk, head, sequence): the
//      chunk's acs (a warp scan in f64: a served model's decays sum to
//      thousands over a chunk, where an f32 ulp of acs moves an exp by
//      1e-3) and its exps w_c and exp(acs[-1]), once per (head, chunk)
//      entry, into small workspaces; B and x of the chunk
//      staged in shared memory by 16-byte cp.async copies; S_c [N x P] on
//      the tensor cores (mma.sync m16n8k16): A = (B o w)^T through
//      ldmatrix.trans, each f32 entry split into bf16 parts hi + lo (the
//      split of csrc/paged_decode.cu, about 2^-17 of the entry), x exact in
//      bf16 as B; 8 warps over 16 x 32 output tiles.
//   2. ssd_state_pass_kernel: h_{c+1} = h_c exp(last_c) + S_c in chunk
//      order, a warp per 16 x 8 tile of the state; h_c is written split
//      (hi, lo) in the order of an mma B fragment, 16 bytes a lane, so the
//      next phase reads it from L2 without staging; the final state in f32.
//   3. ssd_chunk_out_kernel, a block of 4 warps per (64 rows, chunk, head,
//      sequence), the longest row tiles scheduled first: each warp's 16
//      rows of C as A fragments in registers (exact); y_off = C . h_hi +
//      C . h_lo, scaled by exp(acs_i); then for every 16 rows j at or
//      before its rows, with B and x streamed through a 2-stage cp.async
//      ring of 64 rows shared by the 4 warps: S = C B_j^T (recomputed per
//      head on the tensor cores, the flash-attention pattern Q K^T with C
//      as Q and B as K), M = S o exp(acs_i - acs_j) o dt_j for j <= i, M
//      split hi + lo, y += M_hi x_j + M_lo x_j (x through ldmatrix.trans).
//      Off the diagonal k-step exp(acs_i - acs_j) is exp(acs_i - acs_r)
//      exp(acs_r - acs_j) with r the last row of j's 16-row k-step, both
//      <= 1: the column factors (times dt_j) once per block, two row
//      factors per lane and k-step; on it, exp(acs_i - acs_j) itself (its
//      row factor would overflow at a served model's decays).
// No sum crosses a block or goes through atomics: every launch on the same
// inputs gives the same bits.  At mamba2's shape phase 1 runs 256 blocks
// and phase 3 1,024 (the sequential kernel ran 128).
//
// Timed on the way (tools/torch_ssd_mla_variants.py; an NVIDIA H100 80GB
// HBM3 at 700 W; ms at mamba2's / zamba2's prefill shape, each launch
// after an L2 flush): the first version (a 3-stage ring of 32 rows, exps
// per pair, C . h's hi and lo products of one accumulator back to back)
// 0.1236 / 0.1002; 64 rows in 2 stages 0.1083 / 0.0873; C.B^T once per
// (sequence, chunk) into an f32 workspace by a kernel of its own, read
// by the output blocks, 0.1538 / 0.0902 (not kept: slower on the main
// shape); 32- and 128-row tiles, S summed in two chains, at most 128
// registers: no gain; the exps factored on every k-step 0.1003 / 0.0813
// (its diagonal k-step overflowed at a served model's decays: NaN in the
// model check, now exp(acs_i - acs_j) there); C . h's fragments loaded
// first, then every hi product, then every lo product 0.0822 / 0.0674
// (the same reordering of M . x: slower).  Dropping one part of the
// output kernel at a time (64-row stages, exps factored; 68 us at
// mamba2's shape) showed C . h, S and M . x at about 20-25 us each, and
// the exps at 1 us.  The final source's times: PERF.md section 6.
//
// The f32 instance (and bf16 shapes outside the tensor-core instance)
// keeps the sequential CUDA-core kernel, ssd_scan_kernel below: a block per
// (32 columns of P, head, sequence) walking the chunks in order with the
// [N, 32] state in shared memory, C.B^T recomputed per block and scalar
// f32 FMAs.  It is not on the card's main path, which serves bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PB = 32;             // columns of P per block, one per lane
constexpr int TQ = 64;             // rows of an i or j tile
constexpr int RPW = TQ / WARPS;    // rows of an i tile per warp
constexpr int MP = TQ + 1;         // padded M rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Stage rows row0 .. row0 + TQ - 1 of src [B,S,N] (sequence b) into dst
// [TQ][N + 1] as f32; rows at or past `valid` are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int b,
                                           int S, int N, int row0,
                                           int valid) {
  const int NP = N + 1;
  for (int idx = threadIdx.x; idx < TQ * N; idx += THREADS) {
    const int r = idx / N, n = idx - r * N;
    dst[r * NP + n] =
        r < valid ? to_f32(src[((size_t)b * S + row0 + r) * N + n]) : 0.f;
  }
}

// grid (ceil(P / PB), H, B); dynamic shared memory: smem_floats(N, Q).
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ state_out, int S, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* state_s = smem;             // [N][PB]
  float* x_s = state_s + N * PB;     // [Q][PB]
  float* acs_s = x_s + Q * PB;       // [Q]
  float* dt_s = acs_s + Q;           // [Q]
  float* c_s = dt_s + Q;             // [TQ][N + 1]
  float* b_s = c_s + TQ * NP;        // [TQ][N + 1]
  float* m_s = b_s + TQ * NP;        // [TQ][TQ + 1]

  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = p0 + lane;
  const float a_h = A[h];
  const size_t row = (size_t)H * P;  // x and y stride between positions
  const size_t col = (size_t)h * P + p;

  for (int idx = tid; idx < N * PB; idx += THREADS) state_s[idx] = 0.f;

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int r0 = c * Q;
    const int qv = min(Q, S - r0);   // rows of this chunk inside S
    __syncthreads();                 // the last chunk is done with x_s, dt_s
    for (int i = tid; i < Q; i += THREADS)
      dt_s[i] = i < qv ? dt[((size_t)b * S + r0 + i) * H + h] : 0.f;
    for (int idx = tid; idx < Q * PB; idx += THREADS) {
      const int i = idx / PB, pp = idx - i * PB;
      x_s[idx] = i < qv && p0 + pp < P
                     ? to_f32(x[((size_t)b * S + r0 + i) * row +
                                (size_t)h * P + p0 + pp])
                     : 0.f;
    }
    __syncthreads();
    // inclusive cumsum of dt * A: warp 0, each lane a run of rows, then a
    // scan of the runs' totals across the warp
    if (warp == 0) {
      const int per = (Q + 31) / 32, i0 = lane * per;
      float run = 0.f;
      for (int k = 0; k < per && i0 + k < Q; ++k) {
        run += dt_s[i0 + k] * a_h;
        acs_s[i0 + k] = run;
      }
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, tot, o);
        if (lane >= o) tot += t;
      }
      const float before = tot - run;
      for (int k = 0; k < per && i0 + k < Q; ++k) acs_s[i0 + k] += before;
    }
    __syncthreads();
    const float acs_last = acs_s[Q - 1];   // padding rows keep it flat
    const int nt = (qv + TQ - 1) / TQ;

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * TQ;
      const bool last = it == nt - 1;
      stage_rows(c_s, Cm, b, S, N, r0 + i0, qv - i0);
      __syncthreads();
      // y_off of rows warp * RPW + r, column lane
      float acc[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) acc[r] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float sv = state_s[n * PB + lane];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          acc[r] = fmaf(c_s[(warp * RPW + r) * NP + n], sv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int i = i0 + warp * RPW + r;
        acc[r] *= i < qv ? expf(acs_s[i]) : 0.f;
      }
      if (last) {
        __syncthreads();             // every y_off has read the state
        const float decay = expf(acs_last);
        for (int n = warp; n < N; n += WARPS) state_s[n * PB + lane] *= decay;
      }
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TQ;
        const int jv = min(TQ, qv - j0);
        stage_rows(b_s, Bm, b, S, N, r0 + j0, jv);
        __syncthreads();
        {  // M tile: rows ty * 4 + u, columns tx + 16 * v
          const int ty = tid >> 4, tx = tid & 15;
          float s[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) s[u][v] = 0.f;
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) cv[u] = c_s[(ty * 4 + u) * NP + n];
#pragma unroll
            for (int v = 0; v < 4; ++v) bv[v] = b_s[(tx + 16 * v) * NP + n];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) s[u][v] = fmaf(cv[u], bv[v], s[u][v]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + ty * 4 + u;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int j = j0 + tx + 16 * v;
              m_s[(ty * 4 + u) * MP + tx + 16 * v] =
                  j <= i && i < qv
                      ? s[u][v] * expf(acs_s[i] - acs_s[j]) * dt_s[j]
                      : 0.f;
            }
          }
        }
        __syncthreads();
        for (int j = 0; j < jv; ++j) {
          const float xv = x_s[(j0 + j) * PB + lane];
#pragma unroll
          for (int r = 0; r < RPW; ++r)
            acc[r] = fmaf(m_s[(warp * RPW + r) * MP + j], xv, acc[r]);
        }
        if (last) {                  // the chunk's input into the state
          for (int j = 0; j < jv; ++j) {
            const float w = expf(acs_last - acs_s[j0 + j]) * dt_s[j0 + j] *
                            x_s[(j0 + j) * PB + lane];
            for (int n = warp; n < N; n += WARPS)
              state_s[n * PB + lane] =
                  fmaf(b_s[j * NP + n], w, state_s[n * PB + lane]);
          }
        }
        __syncthreads();             // b_s and m_s are restaged next
      }
      if (p < P) {
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int i = i0 + warp * RPW + r;
          if (i < qv) y[((size_t)b * S + r0 + i) * row + col] = acc[r];
        }
      }
    }
  }
  // a thread wrote only its own state entries since the last barrier
  if (p < P)
    for (int n = warp; n < N; n += WARPS)
      state_out[(((size_t)b * H + h) * N + n) * P + p] =
          state_s[n * PB + lane];
}

size_t smem_floats(int N, int Q) {
  return (size_t)N * PB + (size_t)Q * PB + 2 * (size_t)Q +
         2 * (size_t)TQ * (N + 1) + (size_t)TQ * MP;
}

template <typename T>
int launch_cuda_cores(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, void* y, void* state,
                      int B, int S, int H, int P, int N, int Q,
                      cudaStream_t stream) {
  const size_t smem = smem_floats(N, Q) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + PB - 1) / PB, H, B);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), S, H, P, N, Q);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ tensor-core instance

constexpr int MK = 16;        // mma depth: chunk rows and N padded to it
constexpr int MMA_N = 128;    // largest N of the tensor-core instance
constexpr int MMA_P = 64;     // largest P
constexpr int ST_THREADS = 256;            // chunk-state blocks
constexpr int TI = 64;        // rows of a chunk an output block owns
constexpr int OUT_THREADS = 32 * TI / 16;  // a warp per 16 rows
constexpr int JT = 64;        // rows of B and x a ring stage holds
constexpr int STAGES = 2;
static_assert(JT % 16 == 0 && TI % 16 == 0, "tiles of whole k-steps");

typedef __nv_bfloat16 bf16;

__host__ __device__ __forceinline__ int pad16(int v) {
  return (v + MK - 1) / MK * MK;
}
// bf16 elements a staged row of w values takes: w padded to the mma depth,
// then 16 bytes more, so ldmatrix's 8 rows fall on distinct banks
__host__ __device__ __forceinline__ int srow(int w) { return pad16(w) + 8; }

// 16-byte asynchronous copy; a piece that is not `valid` is zero-filled
// (no byte of src is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two floats a and b as two bf16 pairs: the rounded values (hi) and what
// the rounding left (lo), so that a = hi.x + lo.x to about 2^-17 of a
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// D += A B on the tensor cores: m16n8k16, bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 tiles of shared memory: lane l gives the row address of
// tile l / 8; .trans transposes each tile
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// a bf16 pair (exact) times (w.x, w.y), split into hi and lo pairs
__device__ __forceinline__ void scale_split(uint32_t u, float2 w,
                                            uint32_t& hi, uint32_t& lo) {
  split_bf16(__uint_as_float(u << 16) * w.x,
             __uint_as_float(u & 0xffff0000u) * w.y, hi, lo);
}

// Stage rows [r0, r0 + n) of a chunk into rows [0, n) of dst (row stride
// `stride` bf16): `w` values a row from src, whose rows are `ld` elements
// apart; rows at or past `valid` and values past w (up to the mma depth)
// are zero.  16-byte pieces, `threads` threads.
__device__ __forceinline__ void stage(bf16* dst, int stride, const bf16* src,
                                      size_t ld, int w, int r0, int n,
                                      int valid, int threads) {
  const int pieces = pad16(w) / 8;
  for (int i = threadIdx.x; i < n * pieces; i += threads) {
    const int r = i / pieces, q = i - r * pieces;
    const bool ok = r0 + r < valid && q * 8 < w;
    cp_async16(dst + r * stride + q * 8,
               src + (ok ? (r0 + r) * ld + q * 8 : 0), ok);
  }
}

// Phase 1.  grid (nc, H, B), ST_THREADS; dynamic shared memory:
// state_smem_bytes(N, P, Q).  Writes S_c = (B_c o w)^T x_c to ws_s
// [B,H,nc,N,P], the chunk's acs to ws_acs [B,H,nc,pad16(Q)] f64 (flat past
// the chunk's rows) and exp(acs[-1]) to ws_decay [B,H,nc].
__global__ void __launch_bounds__(ST_THREADS) ssd_chunk_state_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    float* __restrict__ ws_s, double* __restrict__ ws_acs,
    float* __restrict__ ws_decay, int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int Qp = pad16(Q), SB = srow(N), SX = srow(P);
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);         // [Qp][SB]
  bf16* x_s = b_s + (size_t)Qp * SB;                      // [Qp][SX]
  float* w_s = reinterpret_cast<float*>(x_s + (size_t)Qp * SX);  // [Qp]
  const int r0 = c * Q, qv = min(Q, S - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t bhc = ((size_t)b * H + h) * nc + c;

  stage(b_s, SB, Bm + ((size_t)b * S + r0) * N, N, N, 0, Qp, qv,
        ST_THREADS);
  stage(x_s, SX, x + ((size_t)b * S + r0) * H * P + (size_t)h * P,
        (size_t)H * P, P, 0, Qp, qv, ST_THREADS);
  cp_async_commit();

  // while the rows land: the inclusive cumsum of dt * A (warp 0, each lane
  // a run of rows, then a scan of the runs' totals across the warp), the
  // exps w_j = exp(acs[-1] - acs_j) dt_j and exp(acs[-1]).  In f64: a
  // served model's decays sum to thousands over a chunk, where an f32 ulp
  // of acs moves exp(acs_i - acs_j) by 1e-3; every exp here and in phase
  // 3 takes a difference of f64 sums, rounded once to f32
  if (warp == 0) {
    const double a_h = A[h];
    const int per = Qp / 32 + (Qp % 32 != 0), i0 = lane * per;
    float d[8];                // per <= 8: Qp <= 256
    double acs[8], run = 0.;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k;
      d[k] = k < per && i < qv ? dt[((size_t)b * S + r0 + i) * H + h] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      run += d[k] * a_h;
      acs[k] = run;
    }
    double tot = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, tot, o);
      if (lane >= o) tot += t;
    }
    const double before = tot - run;
    const double last = __shfl_sync(0xffffffffu, tot, 31);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k;
      if (k < per && i < Qp) {
        const double a = acs[k] + before;
        ws_acs[bhc * Qp + i] = a;
        w_s[i] = expf((float)(last - a)) * d[k];
      }
    }
    if (lane == 0) ws_decay[bhc] = expf((float)last);
  }
  cp_async_wait<0>();
  __syncthreads();

  // S_c [N x P] in tiles of 16 rows (n) x 32 columns (p), the warps in turn
  const int gid = lane >> 2, tig = lane & 3;
  const int MT = pad16(N) / 16, NG = (P + 31) / 32, KS = (qv + 15) / 16;
  float* out = ws_s + bhc * N * P;
  for (int item = warp; item < MT * NG; item += ST_THREADS / 32) {
    const int mt = item / NG, ng = item - mt * NG;
    float acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    for (int ks = 0; ks < KS; ++ks) {
      // A = (B o w)^T: rows n, depth j; B's rows [j][n] through .trans
      uint32_t r[4], ahi[4], alo[4];
      ldmatrix_x4_trans(r, b_s + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     SB + mt * 16 + ((lane >> 3) & 1) * 8);
      const float2 w01 = *reinterpret_cast<const float2*>(
          w_s + ks * 16 + 2 * tig);
      const float2 w89 = *reinterpret_cast<const float2*>(
          w_s + ks * 16 + 2 * tig + 8);
      scale_split(r[0], w01, ahi[0], alo[0]);
      scale_split(r[1], w01, ahi[1], alo[1]);
      scale_split(r[2], w89, ahi[2], alo[2]);
      scale_split(r[3], w89, ahi[3], alo[3]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p0 = ng * 32 + q * 16;
        if (p0 < P) {                       // warp-uniform
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, x_s + (ks * 16 + (lane & 15)) * SX + p0 +
                                    (lane >> 4) * 8);
          mma_bf16(acc[2 * q], ahi, bv[0], bv[1]);
          mma_bf16(acc[2 * q], alo, bv[0], bv[1]);
          mma_bf16(acc[2 * q + 1], ahi, bv[2], bv[3]);
          mma_bf16(acc[2 * q + 1], alo, bv[2], bv[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int p = ng * 32 + t * 8 + 2 * tig;
      const int n = mt * 16 + gid;
      if (p < P) {
        if (n < N)
          *reinterpret_cast<float2*>(out + (size_t)n * P + p) =
              make_float2(acc[t][0], acc[t][1]);
        if (n + 8 < N)
          *reinterpret_cast<float2*>(out + (size_t)(n + 8) * P + p) =
              make_float2(acc[t][2], acc[t][3]);
      }
    }
  }
}

// Phase 2.  grid (ceil(KSN * P/8 / 8), H, B), 256 threads, KSN =
// pad16(N) / 16: a warp per 16 x 8 tile (ks, nt) of the state, its lane
// holding the 4 entries of an mma B fragment (rows 16 ks + 2 tig, +1, +8,
// +9; column 8 nt + gid).  h_c, the state entering chunk c, goes to ws_h
// [B,H,nc,KSN,P/8,32] as one uint4 a lane: (hi b0, hi b1, lo b0, lo b1);
// rows past N are zero.  The final state goes to state [B,H,N,P].
__global__ void __launch_bounds__(256) ssd_state_pass_kernel(
    const float* __restrict__ ws_s, const float* __restrict__ ws_decay,
    uint4* __restrict__ ws_h, float* __restrict__ state, int H, int P, int N,
    int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int KSN = pad16(N) / 16, NTP = P / 8;
  const int item = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (item >= KSN * NTP) return;
  const int ks = item / NTP, nt = item - ks * NTP;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int p = nt * 8 + gid;
  const int n[4] = {ks * 16 + 2 * tig, ks * 16 + 2 * tig + 1,
                    ks * 16 + 2 * tig + 8, ks * 16 + 2 * tig + 9};
  const size_t bh = (size_t)b * H + h;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nc; ++c) {
    uint32_t hi0, lo0, hi1, lo1;
    split_bf16(v[0], v[1], hi0, lo0);
    split_bf16(v[2], v[3], hi1, lo1);
    ws_h[(((bh * nc + c) * KSN + ks) * NTP + nt) * 32 + lane] =
        make_uint4(hi0, hi1, lo0, lo1);
    const float d = ws_decay[bh * nc + c];
    const float* sc = ws_s + (bh * nc + c) * N * P;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = n[e] < N ? fmaf(v[e], d, sc[(size_t)n[e] * P + p]) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (n[e] < N) state[(bh * N + n[e]) * P + p] = v[e];
}

// Phase 3.  grid (nc * H, B, ceil(pad16(Q) / TI)), OUT_THREADS; dynamic
// shared memory: out_smem_bytes(N, P, Q).  Block (c h, b, z) owns rows
// [i0, i0 + TI) of chunk c, i0 = TI * (gridDim.z - 1 - z): the longest row
// tiles are scheduled first.
__global__ void __launch_bounds__(OUT_THREADS) ssd_chunk_out_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    const double* __restrict__ ws_acs, const uint4* __restrict__ ws_h,
    float* __restrict__ y, int S, int H, int P, int N, int Q, int nc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.x / H, h = blockIdx.x - c * H, b = blockIdx.y;
  const int i0 = TI * (gridDim.z - 1 - blockIdx.z);
  const int r0 = c * Q, qv = min(Q, S - r0);
  if (i0 >= qv) return;                  // rows past S: nothing to write
  const int Qp = pad16(Q), SB = srow(N), SX = srow(P);
  const int jend = min(i0 + TI, qv);     // rows of B and x the block reads
  const int stage_n = JT * (SB + SX);    // bf16 a ring stage
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  // acs (f64), dt and the column factors g, each [rows of the tiles]
  double* acs_s = reinterpret_cast<double*>(ring + (size_t)STAGES * stage_n);
  float* dt_s = reinterpret_cast<float*>(acs_s + gridDim.z * TI);
  float* g_s = dt_s + gridDim.z * TI;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int iw = i0 + 16 * warp;         // the warp's first row
  const bool active = iw < qv;           // warp-uniform
  const size_t bh = (size_t)b * H + h;
  const int KSN = pad16(N) / 16, NTP = P / 8;
  const int nj = (jend + JT - 1) / JT;   // ring tiles

  const bf16* b_src = Bm + ((size_t)b * S + r0) * N;
  const bf16* x_src = x + ((size_t)b * S + r0) * H * P + (size_t)h * P;
  auto issue = [&](int t) {
    if (t < nj) {
      bf16* bs = ring + (size_t)(t % STAGES) * stage_n;
      stage(bs, SB, b_src + (size_t)t * JT * N, N, N, 0, JT, jend - t * JT,
            OUT_THREADS);
      stage(bs + JT * SB, SX, x_src + (size_t)t * JT * H * P,
            (size_t)H * P, P, 0, JT, jend - t * JT, OUT_THREADS);
    }
    cp_async_commit();                   // empty past nj: counts stay even
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  // acs of rows [0, i0 + TI) (flat past the chunk's rows, zero past Qp)
  // and dt (zero past the block's rows)
  for (int j = tid; j < i0 + TI; j += OUT_THREADS) {
    const bool ok = j < jend;
    acs_s[j] = j < Qp ? ws_acs[(bh * nc + c) * Qp + j] : 0.;
    dt_s[j] = ok ? dt[((size_t)b * S + r0 + j) * H + h] : 0.f;
  }
  // the warp's 16 rows of C as A fragments, zero past S and past N
  uint32_t cf[MMA_N / 16][4];
  {
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
  }
  __syncthreads();                       // acs_s and dt_s
  // Before the warp's diagonal k-step every j < i, and exp(acs_i - acs_j)
  // = exp(acs_i - acs_r) exp(acs_r - acs_j), r = j | 15 the last row of
  // j's k-step: both factors <= 1, so neither overflows (an underflow is
  // a product below 2^-126).  The column factor times dt_j, g_j, once per
  // block.  On the diagonal k-step the row factor's exponent is positive
  // (up to 15 rows of decay: past 88 with a model's dt), so its products
  // are exp(acs_i - acs_j) dt_j, taken directly.
  for (int j = tid; j < i0 + TI; j += OUT_THREADS)
    g_s[j] = j < jend ? expf((float)(acs_s[j | 15] - acs_s[j])) * dt_s[j]
                      : 0.f;

  // y_off = exp(acs_i) (C . h_c), h_c split hi + lo; h_0 = 0.  A k-step's
  // fragments are loaded first, then every hi product, then every lo one:
  // the two products of one accumulator issued back to back (the second
  // waiting on the first) took 0.1010 ms at mamba2's shape, this 0.0822
  float o[MMA_P / 8][4];
#pragma unroll
  for (int t = 0; t < MMA_P / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  if (active && c > 0) {
    const uint4* hr = ws_h + (bh * nc + c) * KSN * NTP * 32 + lane;
#pragma unroll
    for (int ks = 0; ks < MMA_N / 16; ++ks) {
      if (ks < KSN) {
        uint4 f[MMA_P / 8];
#pragma unroll
        for (int t = 0; t < MMA_P / 8; ++t)
          if (t < NTP) f[t] = __ldg(hr + (ks * NTP + t) * 32);
#pragma unroll
        for (int t = 0; t < MMA_P / 8; ++t)
          if (t < NTP) mma_bf16(o[t], cf[ks], f[t].x, f[t].y);
#pragma unroll
        for (int t = 0; t < MMA_P / 8; ++t)
          if (t < NTP) mma_bf16(o[t], cf[ks], f[t].z, f[t].w);
      }
    }
    const float e0 = expf((float)acs_s[iw + gid]);
    const float e1 = expf((float)acs_s[iw + gid + 8]);
#pragma unroll
    for (int t = 0; t < MMA_P / 8; ++t) {
      o[t][0] *= e0;
      o[t][1] *= e0;
      o[t][2] *= e1;
      o[t][3] *= e1;
    }
  }

  // y_diag: 16 rows j at a time, at or before the warp's rows
  for (int t = 0; t < nj; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                     // stage t landed; t - 1 is free
    issue(t + STAGES - 1);
    const bf16* bs = ring + (size_t)(t % STAGES) * stage_n;
    const bf16* xs = bs + JT * SB;
#pragma unroll
    for (int kj = 0; kj < JT / 16; ++kj) {
      const int j0 = t * JT + kj * 16;
      if (!active || j0 > iw) continue;  // warp-uniform
      // S = C B_j^T: B's rows [j][n] are the K rows of Q K^T
      float s[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[q][e] = 0.f;
      const bf16* brow = bs + (kj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  SB + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < MMA_N / 16; ++ks) {
        if (ks < KSN) {
          uint32_t r[4];
          ldmatrix_x4(r, brow + ks * 16);
          mma_bf16(s[0], cf[ks], r[0], r[1]);
          mma_bf16(s[1], cf[ks], r[2], r[3]);
        }
      }
      // M = S o exp(acs_i - acs_j) o dt_j for j <= i, split hi + lo
      float m[2][4];
      if (j0 == iw) {                    // the diagonal k-step
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = iw + gid + 8 * (e >> 1);
            const int j = j0 + 8 * q + 2 * tig + (e & 1);
            m[q][e] = j <= i ? s[q][e] * expf((float)(acs_s[i] - acs_s[j])) *
                                   dt_s[j]
                             : 0.f;
          }
      } else {                           // every j < i
        const double ar = acs_s[j0 + 15];
        const float fr[2] = {expf((float)(acs_s[iw + gid] - ar)),
                             expf((float)(acs_s[iw + gid + 8] - ar))};
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            m[q][e] = s[q][e] * fr[e >> 1] *
                      g_s[j0 + 8 * q + 2 * tig + (e & 1)];
      }
      uint32_t mh[4], ml[4];
      split_bf16(m[0][0], m[0][1], mh[0], ml[0]);
      split_bf16(m[0][2], m[0][3], mh[1], ml[1]);
      split_bf16(m[1][0], m[1][1], mh[2], ml[2]);
      split_bf16(m[1][2], m[1][3], mh[3], ml[3]);
      const bf16* xrow = xs + (kj * 16 + (lane & 15)) * SX + (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < MMA_P / 16; ++np) {
        if (2 * np < NTP) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, xrow + np * 16);
          mma_bf16(o[2 * np], mh, bv[0], bv[1]);
          mma_bf16(o[2 * np], ml, bv[0], bv[1]);
          if (2 * np + 1 < NTP) {
            mma_bf16(o[2 * np + 1], mh, bv[2], bv[3]);
            mma_bf16(o[2 * np + 1], ml, bv[2], bv[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();                    // no copy outlives the block

  if (active) {
    const int i = iw + gid;
#pragma unroll
    for (int t = 0; t < MMA_P / 8; ++t) {
      if (t < NTP) {
        const int p = t * 8 + 2 * tig;
        float* yr = y + (((size_t)b * S + r0 + i) * H + h) * P + p;
        if (i < qv) *reinterpret_cast<float2*>(yr) = make_float2(o[t][0],
                                                                 o[t][1]);
        if (i + 8 < qv)
          *reinterpret_cast<float2*>(yr + (size_t)8 * H * P) =
              make_float2(o[t][2], o[t][3]);
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;         // devices a process may launch on

// Once per device and kernel: opt in to all the dynamic shared memory a
// block may have beside the kernel's static arrays (past 48 KB a launch
// needs it); then whether `smem` bytes fit.
template <typename K>
cudaError_t opt_in_smem(K kernel, std::atomic<int> (&limit)[MAX_DEVICES],
                        size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (limit[dev].load(std::memory_order_relaxed) == 0) {
    int optin = 0;
    cudaFuncAttributes fa{};
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    const int n = optin - (int)fa.sharedSizeBytes;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, n);
    if (err != cudaSuccess) return err;
    limit[dev].store(n, std::memory_order_relaxed);
  }
  return smem > (size_t)limit[dev].load(std::memory_order_relaxed)
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

size_t state_smem_bytes(int N, int P, int Q) {
  return (size_t)pad16(Q) * (srow(N) + srow(P)) * sizeof(bf16) +
         (size_t)pad16(Q) * sizeof(float);
}
size_t out_smem_bytes(int N, int P, int Q) {
  const int rows = (pad16(Q) + TI - 1) / TI * TI;
  return (size_t)STAGES * JT * (srow(N) + srow(P)) * sizeof(bf16) +
         (size_t)rows * (sizeof(double) + 2 * sizeof(float));
}

// Workspace (bytes, each part 16-byte aligned), carved in this order:
// ws_s [B,H,nc,N,P] f32, ws_h [B,H,nc,pad16(N)/16,P/8,32] uint4, ws_acs
// [B,H,nc,pad16(Q)] f64, ws_decay [B,H,nc] f32.
int launch_mma(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, void* state, void* ws, int B, int S,
               int H, int P, int N, int Q, cudaStream_t stream) {
  if (N % 8 || P % 8 || N > MMA_N || P > MMA_P || Q > 256)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  const size_t bhc = (size_t)B * H * nc;
  char* w = static_cast<char*>(ws);
  float* ws_s = reinterpret_cast<float*>(w);
  uint4* ws_h = reinterpret_cast<uint4*>(w + bhc * N * P * 4);
  double* ws_acs = reinterpret_cast<double*>(
      reinterpret_cast<char*>(ws_h) + bhc * pad16(N) * P * 4);
  float* ws_decay = reinterpret_cast<float*>(ws_acs + bhc * pad16(Q));
  const size_t s1 = state_smem_bytes(N, P, Q), s3 = out_smem_bytes(N, P, Q);
  static std::atomic<int> state_limit[MAX_DEVICES], out_limit[MAX_DEVICES];
  cudaError_t err = opt_in_smem(ssd_chunk_state_kernel, state_limit, s1);
  if (err == cudaSuccess)
    err = opt_in_smem(ssd_chunk_out_kernel, out_limit, s3);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  ssd_chunk_state_kernel<<<dim3(nc, H, B), ST_THREADS, s1, stream>>>(
      xb, dtf, static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      ws_s, ws_acs, ws_decay, S, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int items = pad16(N) / 16 * (P / 8);
  ssd_state_pass_kernel<<<dim3((items + 7) / 8, H, B), 256, 0, stream>>>(
      ws_s, ws_decay, ws_h, static_cast<float*>(state), H, P, N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_out_kernel<<<dim3(nc * H, B, (pad16(Q) + TI - 1) / TI),
                         OUT_THREADS, s3, stream>>>(
      xb, dtf, static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      ws_acs, ws_h, static_cast<float*>(y), S, H, P, N, Q, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// instance: 0 = CUDA cores (dtype 0 = float32 or 1 = bfloat16 for x, Bm,
// Cm), 1 = tensor cores (bfloat16 only; N and P multiples of 8, N <= 128,
// P <= 64, x, Bm and Cm 16-byte aligned; ws the workspace launch_mma
// describes).  dt, A, y and state f32.  Q = min(chunk, S) <= 256, N <= 256
// (the wrapper checks).  Returns cudaGetLastError() after the launches (0
// on success).  Allocates nothing and does not synchronise.
int ssd_scan_launch(int instance, int dtype, const void* x, const void* dt,
                    const void* A, const void* Bm, const void* Cm, void* y,
                    void* state, void* ws, int B, int S, int H, int P, int N,
                    int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  if (instance == 1 && dtype == 1)
    return launch_mma(x, dt, A, Bm, Cm, y, state, ws, B, S, H, P, N, Q, s);
  if (instance != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_cuda_cores<float>(x, dt, A, Bm, Cm, y, state, B, S, H, P,
                                    N, Q, s);
  if (dtype == 1)
    return launch_cuda_cores<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S,
                                            H, P, N, Q, s);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
