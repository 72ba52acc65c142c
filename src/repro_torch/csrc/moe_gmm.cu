// Paged grouped expert matmul for Hopper (sm_90a), bf16/f32 and int8 pages.
//
// Replaces the Pallas TPU kernels paged_gmm (src/repro/kernels/moe_gmm.py:83)
// and quant_paged_gmm (:148); paged_expert_ffn (:131) and
// quant_paged_expert_ffn (:192) stay the same three-launch compositions in
// kernels/moe_gmm.py.
//
// What it computes.  out[e] = x[e] @ pool[table[e]] for every local expert
// e: x [E,C,D], pool [P,D,F] (a bank of weight pages), table [E] int32 page
// of each expert (tables may alias: several experts naming one page) ->
// out [E,C,F] in x's dtype, f32 accumulation.  int8 pages carry one f32
// scale per page, scales [P], read through the same table entry: the
// kernel accumulates x_f32 * float(w_i8) and multiplies the sum by the
// page's scale once, before the one rounding to x's dtype, as the Pallas
// _quant_kernel does (x @ (w_i8 * s) = (x @ w_i8) * s).  No int8 tensor
// cores: an int8 x int8 product would quantize the activations, another
// function.
//
// Bound on an H100.  Memory: every page the table names is read once, so
// the least time is (pages * D * F + x + out bytes) / 3.35 TB/s.  At decode
// (C = 1, capacity one token per expert) this is a batched GEMV: one qwen3
// bank of 128 pages of 2048x768 is 402.7 MB in bf16, 120 us per launch, and
// 201.3 MB in int8, 60 us.  The arithmetic (2*E*C*D*F) stays under the
// memory time at every C the serving path produces (C <= 10 at a 128-token
// chunk).
//
// Design, bf16/f32 pages.  One block of BF = 128 threads per (F tile,
// expert); thread f owns output column f for all C rows.  The block reads
// table[e] itself (the TPU kernel's scalar prefetch) and streams that page's
// [D, BF] slab, each warp reading 32 consecutive columns of a row
// (coalesced along the contiguous F axis).  x[e] is staged through shared
// memory DT columns at a time for CT token rows per pass (CT = 1 at decode,
// so no work is spent on absent rows).  Ragged C and F edges are masked
// here: weights are never copied or padded (the Mosaic pad-or-clamp of the
// TPU kernel does not apply).
//
// Design, int8 pages.  A byte per thread would take four times the load
// instructions for half the bytes, so each lane owns 4 adjacent columns
// and reads them with one 4-byte char4 load (a warp reads 128 contiguous
// bytes of a row; F % 4 == 0 and an aligned pool, else the wrapper asks
// for byte loads and the ragged F edge is masked per column).  A block of
// QWARPS = 8 warps covers QBF = 128 columns.  The CT rows of x[e] are
// staged once per pass in dynamic shared memory, in f32 (CT * D * 4 bytes:
// 64 KB at CT = 8, D = 2048), and each warp streams its own contiguous
// eighth of the page's rows with 16 loads in flight and no barrier,
// so 8 times as many row loads are in flight as with one warp per column
// tile.  The 8 partial sums are added in warp order through shared memory
// (deterministic) before the page scale and the rounding.
//
// Known gaps, measured and left for later work: experts that received no
// token still stream their page, and no tensor cores are used.
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

constexpr int QWARPS = 8;          // warps splitting the contraction
constexpr int QTHREADS = 32 * QWARPS;
constexpr int QBF = 128;           // output columns per block: 32 lanes x 4

size_t quant_smem_bytes(int CT, int D) {
  return sizeof(float) * ((size_t)CT * D + (size_t)QWARPS * CT * QBF);
}

// grid (ceil(F / QBF), E); CT token rows per pass over the page; dynamic
// shared memory: quant_smem_bytes(CT, D).  VEC: char4 loads, 4-byte aligned
// (F % 4 == 0 and an aligned pool); else byte loads, the F edge masked per
// column.
// min blocks 1: the CT = 8 accumulators and 16 loads in flight need more
// than the registers nvcc would leave a thread if it aimed at two blocks
template <typename T, int CT, bool VEC>
__global__ void __launch_bounds__(QTHREADS, 1) quant_paged_gmm_kernel(
    const int32_t* __restrict__ table, const T* __restrict__ x,
    const int8_t* __restrict__ pool, const float* __restrict__ scales,
    T* __restrict__ out, int C, int D, int F, int P) {
  extern __shared__ float qsmem[];
  float* xs = qsmem;                    // [CT][D] this pass's x rows, f32
  float* part = qsmem + CT * D;         // [QWARPS][CT][QBF] partial sums
  const int e = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * QBF + lane * 4;
  int page = table[e];
  page = min(max(page, 0), P - 1);
  const float s = scales[page];
  const int8_t* wp = pool + (size_t)page * D * F + f0;
  const T* xe = x + (size_t)e * C * D;
  // each warp streams its own contiguous range of the page's rows
  const int rpw = (D + QWARPS - 1) / QWARPS;
  const int r0 = warp * rpw, r1 = min(r0 + rpw, D);

  for (int c0 = 0; c0 < C; c0 += CT) {
    const int nc = min(CT, C - c0);
    __syncthreads();            // the previous pass's readers are done
    for (int idx = threadIdx.x; idx < CT * D; idx += QTHREADS) {
      const int c = idx / D;
      xs[idx] = c < nc ? to_f32(xe[(size_t)c0 * D + idx]) : 0.f;
    }
    __syncthreads();
    float acc[CT][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
    if (VEC) {
      if (f0 < F) {             // F % 4 == 0: all 4 columns are in range
        // 16 row loads in flight per lane
#pragma unroll 16
        for (int d = r0; d < r1; ++d) {
          const char4 wv =
              __ldg(reinterpret_cast<const char4*>(wp + (size_t)d * F));
          const float w4[4] = {static_cast<float>(wv.x),
                               static_cast<float>(wv.y),
                               static_cast<float>(wv.z),
                               static_cast<float>(wv.w)};
#pragma unroll
          for (int c = 0; c < CT; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[c][j] = fmaf(xs[c * D + d], w4[j], acc[c][j]);
        }
      }
    } else {
      for (int d = r0; d < r1; ++d) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float wj = f0 + j < F
                               ? static_cast<float>(wp[(size_t)d * F + j])
                               : 0.f;
#pragma unroll
          for (int c = 0; c < CT; ++c)
            acc[c][j] = fmaf(xs[c * D + d], wj, acc[c][j]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[(warp * CT + c) * QBF + lane * 4 + j] = acc[c][j];
    __syncthreads();
    // the QWARPS partial sums in warp order (deterministic), then the page
    // scale and the one rounding
    for (int idx = threadIdx.x; idx < nc * QBF; idx += QTHREADS) {
      const int c = idx / QBF, col = idx - (idx / QBF) * QBF;
      const int f = blockIdx.x * QBF + col;
      if (f < F) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < QWARPS; ++k) sum += part[(k * CT + c) * QBF + col];
        out[((size_t)e * C + c0 + c) * F + f] = from_f32<T>(sum * s);
      }
    }
  }
}

template <typename T, int CT, bool VEC>
int launch_quant_ct(const int32_t* t, const T* xp, const int8_t* pp,
                    const float* sp, T* op, int E, int C, int D, int F, int P,
                    cudaStream_t stream) {
  const size_t smem = quant_smem_bytes(CT, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        quant_paged_gmm_kernel<T, CT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((F + QBF - 1) / QBF, E);
  quant_paged_gmm_kernel<T, CT, VEC><<<grid, QTHREADS, smem, stream>>>(
      t, xp, pp, sp, op, C, D, F, P);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_quant_vec(const int32_t* t, const T* xp, const int8_t* pp,
                     const float* sp, T* op, int E, int C, int D, int F,
                     int P, cudaStream_t stream) {
  if (C == 1)
    return launch_quant_ct<T, 1, VEC>(t, xp, pp, sp, op, E, C, D, F, P,
                                      stream);
  if (C <= 4)
    return launch_quant_ct<T, 4, VEC>(t, xp, pp, sp, op, E, C, D, F, P,
                                      stream);
  return launch_quant_ct<T, 8, VEC>(t, xp, pp, sp, op, E, C, D, F, P, stream);
}

template <typename T>
int launch_quant(const void* table, const void* x, const void* pool,
                 const void* scales, void* out, int E, int C, int D, int F,
                 int P, int vec, cudaStream_t stream) {
  const int32_t* t = static_cast<const int32_t*>(table);
  const T* xp = static_cast<const T*>(x);
  const int8_t* pp = static_cast<const int8_t*>(pool);
  const float* sp = static_cast<const float*>(scales);
  T* op = static_cast<T*>(out);
  return vec ? launch_quant_vec<T, true>(t, xp, pp, sp, op, E, C, D, F, P,
                                         stream)
             : launch_quant_vec<T, false>(t, xp, pp, sp, op, E, C, D, F, P,
                                          stream);
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

// int8 pool [P,D,F] with f32 scales [P]; x and out of type dtype (0 =
// float32, 1 = bfloat16).  vec = 1: F % 4 == 0 and the pool is 4-byte
// aligned (char4 loads).
int quant_paged_gmm_launch(int dtype, const void* table, const void* x,
                           const void* pool, const void* scales, void* out,
                           int E, int C, int D, int F, int P, int vec,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quant<float>(table, x, pool, scales, out, E, C, D, F, P,
                               vec, s);
  if (dtype == 1)
    return launch_quant<__nv_bfloat16>(table, x, pool, scales, out, E, C, D,
                                       F, P, vec, s);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
