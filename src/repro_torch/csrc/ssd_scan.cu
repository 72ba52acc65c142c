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
// bf16 x) 28.05 MB, 8.4 us at 3.35 TB/s; the Pallas kernel's operations
// (C.B^T per head) are 8.6 GFLOP, 8.7 us at the bf16 tensor-core rate, and
// C.B^T once per chunk would make them 4.4 GFLOP.  zamba2-2.7b (H=80, N=64,
// chunk 128): 33.36 MB, 10.0 us.
//
// Design (right before fast).  The Pallas grid's sequential chunk axis
// becomes a loop inside the block, with the [N, P] state in shared memory.
// Columns of P are independent (y[:, p] needs only state[:, p] and x[:, p]),
// so one block of 256 threads takes (32 columns of P, head, sequence): 128
// blocks for mamba2's B=1 prefill on 132 SMs, where (head, sequence) alone
// would give 64.  Each block recomputes C.B^T and the decay mask for its
// slice; that recomputation is the price.  Rows of a chunk are tiled by 64:
// for each i tile, C's rows are staged in shared memory (f32), y_off comes
// from the state, then for each j tile at or before it B's rows are staged,
// the masked tile M = (C.B^T) o exp(acs_i - acs_j) o dt_j is formed in
// shared memory and y += M . x.  While the last i tile walks every j tile,
// the state (already read by every tile's y_off) is decayed and takes the
// chunk's input.  A lane owns one column: state, x and y are read and
// written 32 consecutive floats a warp.  Scalar f32 FMAs on CUDA cores, no
// mma / wgmma, no asynchronous copies: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int B, int S, int H, int P,
           int N, int Q, cudaStream_t stream) {
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm); dt, A, y and state f32.
// Q = min(chunk, S) <= 256, N <= 256 (the wrapper checks).  Returns
// cudaGetLastError() after the launch (0 on success).  Allocates nothing
// and does not synchronise.
int ssd_scan_launch(int dtype, const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* state,
                    int B, int S, int H, int P, int N, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N,
                                 Q, s);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
