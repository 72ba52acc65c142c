// Causal blocked (flash) attention for a monolithic prefill, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:72).
//
// What it computes.  q/k [B,S,H|KVH,hd]; v [B,S,KVH,hdv] (GQA: query head
// h reads kv head h / (H/KVH)); out [B,S,H,hdv].  Query row i attends to
// key rows t <= i (causal) or to every row (not causal).  Online softmax
// in f32 (running max m, sum l, accumulator acc), score = dot(q, k) *
// scale (the caller's; 1/sqrt(hd) for a standard head), masked scores
// -1e30, output acc / max(l, 1e-30) rounded once to q's type -- the Pallas
// kernel's arithmetic.  Instances (hd, hdv): (64, 64), (80, 80) for
// zamba2's shared attention block, (128, 128), and (192, 128) for MLA's
// prefill (q/k carry dn + dr = 192 values, v 128:
// the reference pads v to 192 and trims the output, this instance reads
// and writes 128).
//
// Bound on an H100.  At the serving path's largest bucket (B=1, S=1024,
// H=32, KVH=4, hd=128, causal) the work is 4*hd operations per attended
// (query, key, head) triple: 8.6 GFLOP, 8.7 us at the bf16 tensor-core
// rate; the bytes (q, k, v read once, out written once) are 18.9 MB, 5.6
// us.  So the kernel is bound by operations, and by the CUDA-core rate
// (67 TFLOP/s in f32, ~128 us) as long as it does not use tensor cores.
// At MLA's (192, 128), B=1, S=1024, H=KVH=16: 2 * (192 + 128) operations
// per attended triple, 5.4 GFLOP (5.4 us); 21.0 MB of q, k, v and out
// (6.3 us): the bytes bound it there.  At zamba2's (80, 80), B=1, S=1024,
// H=KVH=32: 5.4 GFLOP (5.4 us); 21.0 MB (6.3 us): bytes again.
//
// Design.  One block of 256 threads per (query tile of BQ = 64 rows, head,
// sequence); heavier (later) causal tiles are scheduled first.  Shared
// memory is 4 * (64 * (hd+1) * 2 + 64 * hdv + 64 * 65) bytes: 148,224 at
// (192, 128), above the 48 KB default, so the launch raises the block's
// dynamic shared-memory limit first (227 KB on Hopper).  A loop
// inside the block over key tiles of BK = 64 rows takes the place of the
// Pallas grid's sequential kv axis; it ends at the tile's causal limit, so
// fully masked tiles are never read.  Q, K and V tiles are staged in shared
// memory as f32 (K and Q rows padded by one float: no bank conflicts).  A
// thread owns 4 query rows: it computes their scores against 4 key columns
// in registers, takes the row max and sum with shuffles across the 16
// threads that share the rows (m and l stay in registers), writes the
// probabilities to shared memory once, and keeps its 4 x hd/16 slice of the
// accumulator in registers for the whole loop.  The ragged last tile (S not
// a multiple of 64) is masked here: padded key columns score -1e30, padded
// query rows are computed on zeros and never written.  Known gaps, left for
// later work: scalar FMAs on CUDA cores (no mma / wgmma), no asynchronous
// copies or double buffering, three barriers per key tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

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

// Stage `rows` rows of `HD` values (row stride `stride` elements) from
// global memory into shared memory as f32, row pitch `pitch`; rows at or
// past `valid` are zero.  16-byte loads (hd is a multiple of 16 and the
// wrapper checks 16-byte alignment).
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      size_t stride, int rows, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * VEC;
    float* out = dst + r * pitch + c;
    if (r < valid) {
      const uint4 w = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = 0.f;
    }
  }
}

// grid (query tiles, H, B); dynamic shared memory: smem_bytes<HD, HDV>().
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int H, int KVH,
    int causal, float scale) {
  constexpr int QP = HD + 1;     // padded q / k rows
  constexpr int PP = BK + 1;     // padded probability rows
  constexpr int NC = HDV / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][HD + 1]
  float* k_s = q_s + BQ * QP;     // [BK][HD + 1]
  float* v_s = k_s + BK * QP;     // [BK][HDV]
  float* p_s = v_s + BK * HDV;    // [BQ][BK + 1]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KVH * HD;
  const size_t v_stride = (size_t)KVH * HDV, o_stride = (size_t)H * HDV;
  const T* q_base = q + ((size_t)b * S + q0) * q_stride + (size_t)h * HD;
  const T* k_base = k + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  const T* v_base = v + (size_t)b * S * v_stride + (size_t)kvh * HDV;

  stage<T, HD>(q_s, QP, q_base, q_stride, BQ, S - q0);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }
  // key tiles up to the last row this query tile attends
  const int last = causal ? min(S, q0 + BQ) : S;
  const int n_k = (last + BK - 1) / BK;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    stage<T, HD>(k_s, QP, k_base + (size_t)k0 * kv_stride, kv_stride, BK,
                 S - k0);
    stage<T, HDV>(v_s, HDV, v_base + (size_t)k0 * v_stride, v_stride, BK,
                  S - k0);
    __syncthreads();

    // scores of rows ty*4 + i against columns tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < S && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads holding row i are lanes tx = 0..15 of a half warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_cur = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_cur);
        p_s[(ty * 4 + i) * PP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - m_cur);
      l[i] = l[i] * alpha + sum;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[rows ty*4 + i][columns tx + 16*j] += p @ v
#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * PP + t];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = v_s[t * HDV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)b * S + q0 + r) * o_stride + (size_t)h * HDV;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <int HD, int HDV>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) +
                          (size_t)BK * HDV + (size_t)BQ * (BK + 1));
}

template <typename T, int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KVH, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, HDV>();
  static_assert(smem <= 232448, "above Hopper's 227 KB per block");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD, HDV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KVH, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_hd(int hd, int hdv, const void* q, const void* k, const void* v,
          void* out, int B, int S, int H, int KVH, int causal, float scale,
          cudaStream_t s) {
  if (hd == 64 && hdv == 64)
    return launch<T, 64, 64>(q, k, v, out, B, S, H, KVH, causal, scale, s);
  if (hd == 80 && hdv == 80)
    return launch<T, 80, 80>(q, k, v, out, B, S, H, KVH, causal, scale, s);
  if (hd == 128 && hdv == 128)
    return launch<T, 128, 128>(q, k, v, out, B, S, H, KVH, causal, scale, s);
  if (hd == 192 && hdv == 128)
    return launch<T, 192, 128>(q, k, v, out, B, S, H, KVH, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out); (hd, hdv) in {(64, 64),
// (80, 80), (128, 128), (192, 128)}.  Returns cudaGetLastError() after the launch (0
// on success).  Allocates nothing and does not synchronise.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, int B, int S, int H,
                           int KVH, int hd, int hdv, int causal, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0 || B <= 0) return 0;
  if (dtype == 0)
    return by_hd<float>(hd, hdv, q, k, v, out, B, S, H, KVH, causal, scale,
                        s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, hdv, q, k, v, out, B, S, H, KVH, causal,
                                scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
