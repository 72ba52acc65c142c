// Paged grouped expert matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_gmm
// (src/repro/kernels/moe_gmm.py:83); paged_expert_ffn (:131) stays the
// same three-launch composition in kernels/moe_gmm.py.
//
// What it computes.  out[e] = x[e] @ pool[table[e]] for every local expert
// e: x [E,C,D], pool [P,D,F] (a bank of weight pages), table [E] int32 page
// of each expert (tables may alias: several experts naming one page) ->
// out [E,C,F] in x's dtype, f32 accumulation.
//
// Bound on an H100.  Memory: every page the table names is read once, so
// the least time is (pages * D * F + x + out bytes) / 3.35 TB/s.  At decode
// (C = 1, capacity one token per expert) this is a batched GEMV: one qwen3
// bank of 128 pages of 2048x768 bf16 is 402.7 MB, 120 us per launch.  The
// arithmetic (2*E*C*D*F) stays under the memory time at every C the serving
// path produces (C <= 10 at a 128-token chunk).
//
// Design.  One block of BF = 128 threads per (F tile, expert); thread f owns
// output column f for all C rows.  The block reads table[e] itself (the
// TPU kernel's scalar prefetch) and streams that page's [D, BF] slab, each
// warp reading 32 consecutive columns of a row (coalesced along the
// contiguous F axis).  x[e] is staged through shared memory DT columns at a
// time for CT token rows per pass (CT = 1 at decode, so no work is spent on
// absent rows).  Ragged C and F edges are masked here: weights are never
// copied or padded (the Mosaic pad-or-clamp of the TPU kernel does not
// apply).  Known gaps, measured and left for later work: experts that
// received no token still stream their page, loads are 2 bytes per thread,
// and no tensor cores are used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BF = 128;  // output columns per block, one per thread
constexpr int DT = 256;  // contraction slab of x staged in shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid (ceil(F / BF), E); CT token rows per pass over the page.
template <typename T, int CT>
__global__ void __launch_bounds__(BF) paged_gmm_kernel(
    const int32_t* __restrict__ table, const T* __restrict__ x,
    const T* __restrict__ pool, T* __restrict__ out, int C, int D, int F,
    int P) {
  __shared__ float xs[CT][DT];
  const int e = blockIdx.y;
  const int f = blockIdx.x * BF + threadIdx.x;
  int page = table[e];
  page = min(max(page, 0), P - 1);
  const T* w = pool + (size_t)page * D * F;
  const T* xe = x + (size_t)e * C * D;

  for (int c0 = 0; c0 < C; c0 += CT) {
    const int nc = min(CT, C - c0);
    float acc[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[c] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DT) {
      const int nd = min(DT, D - d0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < CT * DT; idx += BF) {
        const int c = idx / DT, d = idx - (idx / DT) * DT;
        xs[c][d] = (c < nc && d < nd)
                       ? to_f32(xe[(size_t)(c0 + c) * D + d0 + d])
                       : 0.f;
      }
      __syncthreads();
      if (f < F) {
        const T* wp = w + (size_t)d0 * F + f;
#pragma unroll 8
        for (int d = 0; d < nd; ++d) {
          const float wv = to_f32(wp[(size_t)d * F]);
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[c] = fmaf(xs[c][d], wv, acc[c]);
        }
      }
    }
    if (f < F) {
#pragma unroll
      for (int c = 0; c < CT; ++c)
        if (c < nc) out[((size_t)e * C + c0 + c) * F + f] = from_f32<T>(acc[c]);
    }
  }
}

template <typename T>
int launch(const void* table, const void* x, const void* pool, void* out,
           int E, int C, int D, int F, int P, cudaStream_t stream) {
  const dim3 grid((F + BF - 1) / BF, E);
  const int32_t* t = static_cast<const int32_t*>(table);
  const T* xp = static_cast<const T*>(x);
  const T* pp = static_cast<const T*>(pool);
  T* op = static_cast<T*>(out);
  if (C == 1)
    paged_gmm_kernel<T, 1><<<grid, BF, 0, stream>>>(t, xp, pp, op, C, D, F, P);
  else if (C <= 4)
    paged_gmm_kernel<T, 4><<<grid, BF, 0, stream>>>(t, xp, pp, op, C, D, F, P);
  else
    paged_gmm_kernel<T, 8><<<grid, BF, 0, stream>>>(t, xp, pp, op, C, D, F, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, pool and out share it).  Returns
// cudaGetLastError() after the launch (0 on success).  Allocates nothing
// and does not synchronise.
int paged_gmm_launch(int dtype, const void* table, const void* x,
                     const void* pool, void* out, int E, int C, int D, int F,
                     int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(table, x, pool, out, E, C, D, F, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, x, pool, out, E, C, D, F, P, s);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
