// In-place writes of new K/V rows into the KV caches, for Hopper (sm_90a):
// the slot-contiguous cache of the dense-KV mode (one cache, or two in one
// launch) and the paged block pool (bf16/f32 rows, or int8 rows quantized
// on the way in with their f32 scales).
//
// Replaces the Pallas TPU kernel kv_cache_write
// (src/repro/kernels/kv_write.py:37), and the paged writes that the
// reference package leaves to XLA's scatter
// (.at[write_block, lengths % bs].set(mode="drop") at decode,
// .at[chunk_block_ids].set(mode="drop") at a prefill chunk and at
// write_prefill_to_blocks, with repro.kernels.quant.quantize_rows on an
// int8 pool; src/repro/models/layers.py:237-253, :296-318).  All write
// rows dropped on the device into a cache updated in place.
//
// What it computes.
//   * Slot write: cache [B,S,row] (one or two caches, each with its own row
//     width: K and V, or MLA's latent c and rope key kr); new [B,row] of the
//     cache's type; pos [B] int32.  cache[b, pos[b]] = new[b] for every b
//     with 0 <= pos[b] < S; other positions write nothing, as JAX's
//     .at[].set(mode="drop") drops them.
//   * Paged write: pools [L,NB,bs,row] for K and V (L = 1 for one layer's
//     view); n entries, entry e naming pool block ids[e].  A decode entry
//     (lens given) writes one token row at offset lens[e] mod bs; a block
//     entry (lens null) writes bs token rows at offsets 0..bs-1.  The token
//     rows of entry e are rows e * rpe .. e * rpe + rpe - 1 of the source
//     (rpe = 1 or bs), read through the source's row and layer strides.  An
//     entry whose id lies outside [0, NB) (the NB sentinel of inactive
//     slots, padding and copy-on-write-shared blocks) writes nothing: the
//     decision is made here, on the device.  Rows are converted to the
//     pool's type (f32 <-> bf16 rounds to nearest even), or, for an int8
//     pool, quantized over the whole token row (KVH * hd values) exactly as
//     kernels/quant.py's quantize_rows computes it as PyTorch runs it on the
//     card: amax = max |x| in f32; scale = max(amax, 1e-8) * (1/127), the
//     product by the f32 reciprocal that PyTorch's CUDA division by a
//     Python scalar computes; q = clamp(rint(x / scale), -127, 127), an
//     IEEE division (this file is built without --use_fast_math) and
//     round-half-to-even.  The scale goes to scale[id, off] in the same
//     launch.
//
// Bound on an H100.  Each new row is read once and written once: a qwen3
// decode step's K and V rows are 2 * 8 * 1 KiB read and written (32 KiB,
// about 10 ns at 3.35 TB/s), a chunk of 128 tokens 512 KiB (0.16 us).
// The launch, not the bytes, sets the time, so the design's aim is one
// launch per layer per step: K and V, the rows and their scales, and
// every layer of a monolithic prefill go in one launch, with no host
// synchronisation (ids, lengths and positions are read on the device), no
// allocation and no copy of the source (it is read through its strides).
//
// Design.  Slot write: one 64-thread block per (row b, cache); the row is
// copied as raw bytes, 16 per thread and load when the row size, the
// source's row stride and both addresses allow it (the wrapper checks),
// else byte by byte.  Paged write: one warp per (token row, K or V,
// layer), 4 warps a block.  A lane takes 8 consecutive values at a time:
// one 16-byte load of bf16 (two of f32) and one 8- or 16-byte store, when
// the row width is a multiple of 8 and every row start is 16-byte aligned
// (the wrapper checks), else one value at a time.  A same-type write copies
// the bytes; an int8 write takes the row's max |x| over the warp with
// shuffles, then reads the row again (from L1) to quantize it, and lane 0
// stores the scale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int SLOT_THREADS = 64;
constexpr int PAGED_WARPS = 4;

// ------------------------------------------------------------ slot write

struct SlotCache {
  char* cache;
  const char* src;
  long long row_bytes;
  long long src_stride;     // bytes between consecutive rows b of src
  int vec;                  // 16-byte pieces allowed
};

struct SlotArgs {
  SlotCache c[2];
  const int32_t* pos;
  int S;
};

__global__ void __launch_bounds__(SLOT_THREADS) slot_write_kernel(
    const SlotArgs a) {
  const int b = blockIdx.x;
  const SlotCache c = blockIdx.y ? a.c[1] : a.c[0];
  const int p = a.pos[b];
  if (p < 0 || p >= a.S) return;
  char* dst = c.cache + ((long long)b * a.S + p) * c.row_bytes;
  const char* in = c.src + (long long)b * c.src_stride;
  if (c.vec) {
    const long long n = c.row_bytes / 16;
    for (long long i = threadIdx.x; i < n; i += SLOT_THREADS)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(in)[i];
  } else {
    for (long long i = threadIdx.x; i < c.row_bytes; i += SLOT_THREADS)
      dst[i] = in[i];
  }
}

// ----------------------------------------------------------- paged write

struct PagedArgs {
  char* pool[2];                 // K, V pools [L, NB, bs, row]
  float* scale[2];               // int8 pools: [L, NB, bs]
  const char* src[2];            // K, V source rows
  const int32_t* ids;            // [n]
  const int32_t* lens;           // [n] (decode) or null (blocks)
  long long src_row_stride[2];   // elements between token rows
  long long src_layer_stride[2]; // elements between layers
  int n_rows;                    // token rows of one layer: n * rpe
  int rpe;                       // token rows an entry: 1 or bs
  int NB, bs, row;
  int vec;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename D>
__device__ __forceinline__ D from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive values (16-byte aligned) as f32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i],
                                                           v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// quantize_rows' arithmetic for one value of a row with this scale
__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, scale));
  return (int8_t)fminf(fmaxf(q, -127.0f), 127.0f);
}

template <typename S, typename D>
__global__ void __launch_bounds__(PAGED_WARPS * 32) paged_write_kernel(
    const PagedArgs a) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * PAGED_WARPS + (threadIdx.x >> 5);
  if (g >= a.n_rows) return;
  const int kv = blockIdx.y, layer = blockIdx.z;
  const int e = g / a.rpe;
  const int id = a.ids[e];
  if (id < 0 || id >= a.NB) return;             // the sentinel: dropped
  int off = g - e * a.rpe;
  if (a.lens != nullptr) {
    const int m = a.lens[e] % a.bs;
    off += m < 0 ? m + a.bs : m;
  }
  // the pool's (and scale pool's) token row; the K/V choice by selects,
  // not by a dynamic index into the parameters
  const long long slot = ((long long)layer * a.NB + id) * a.bs + off;
  const S* in = reinterpret_cast<const S*>(kv ? a.src[1] : a.src[0])
      + layer * (kv ? a.src_layer_stride[1] : a.src_layer_stride[0])
      + g * (kv ? a.src_row_stride[1] : a.src_row_stride[0]);
  D* out = reinterpret_cast<D*>(kv ? a.pool[1] : a.pool[0]) + slot * a.row;
  const int row = a.row;

  if constexpr (std::is_same<D, int8_t>::value) {
    float amax = 0.0f;
    if (a.vec) {
      for (int i = lane * 8; i < row; i += 256) {
        float v[8];
        load8(in + i, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
      }
    } else {
      for (int i = lane; i < row; i += 32)
        amax = fmaxf(amax, fabsf(to_f32(in[i])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fmul_rn(fmaxf(amax, (float)1e-8),
                                  1.0f / 127.0f);
    if (a.vec) {
      for (int i = lane * 8; i < row; i += 256) {
        float v[8];
        load8(in + i, v);
        uint32_t w[2] = {0u, 0u};               // 8 int8 values, packed
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j >> 2] |= (uint32_t)(uint8_t)quantize(v[j], scale)
                       << (8 * (j & 3));
        *reinterpret_cast<uint2*>(out + i) = make_uint2(w[0], w[1]);
      }
    } else {
      for (int i = lane; i < row; i += 32)
        out[i] = quantize(to_f32(in[i]), scale);
    }
    if (lane == 0) (kv ? a.scale[1] : a.scale[0])[slot] = scale;
  } else if constexpr (std::is_same<S, D>::value) {
    if (a.vec) {
      const int n = row * (int)sizeof(S) / 16;
      for (int i = lane; i < n; i += 32)
        reinterpret_cast<uint4*>(out)[i] =
            reinterpret_cast<const uint4*>(in)[i];
    } else {
      for (int i = lane; i < row; i += 32) out[i] = in[i];
    }
  } else {
    if (a.vec) {
      for (int i = lane * 8; i < row; i += 256) {
        float v[8];
        load8(in + i, v);
        store8(out + i, v);
      }
    } else {
      for (int i = lane; i < row; i += 32)
        out[i] = from_f32<D>(to_f32(in[i]));
    }
  }
}

template <typename S>
int launch_paged(const PagedArgs& a, int dst_type, int L,
                 cudaStream_t stream) {
  const dim3 grid((a.n_rows + PAGED_WARPS - 1) / PAGED_WARPS, 2, L);
  const dim3 block(PAGED_WARPS * 32);
  switch (dst_type) {
    case 0:
      paged_write_kernel<S, float><<<grid, block, 0, stream>>>(a);
      break;
    case 1:
      paged_write_kernel<S, __nv_bfloat16><<<grid, block, 0, stream>>>(a);
      break;
    case 2:
      paged_write_kernel<S, int8_t><<<grid, block, 0, stream>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ncaches (1 or 2) caches [B,S,row_bytes_i] and sources [B,...] with
// src_stride_i bytes between rows; pos [B] int32.  vec_i = 1: row_bytes_i
// and src_stride_i multiples of 16 and both pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success).  Allocates
// nothing and does not synchronise.
int kv_slot_write_launch(void* cache0, const void* src0, long long row_bytes0,
                         long long src_stride0, int vec0, void* cache1,
                         const void* src1, long long row_bytes1,
                         long long src_stride1, int vec1, int ncaches,
                         const void* pos, int B, int S, void* stream) {
  if (B <= 0) return 0;
  if (ncaches < 1 || ncaches > 2) return (int)cudaErrorInvalidValue;
  SlotArgs a;
  a.c[0] = {static_cast<char*>(cache0), static_cast<const char*>(src0),
            row_bytes0, src_stride0, vec0};
  a.c[1] = {static_cast<char*>(cache1), static_cast<const char*>(src1),
            row_bytes1, src_stride1, vec1};
  a.pos = static_cast<const int32_t*>(pos);
  a.S = S;
  slot_write_kernel<<<dim3(B, ncaches), SLOT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Paged write of n entries into the K and V pools [L,NB,bs,row] (see the
// note at the top).  src_type: 0 = float32, 1 = bfloat16; dst_type: 0 =
// float32, 1 = bfloat16, 2 = int8 (k_scale and v_scale [L,NB,bs] f32
// then).  Strides in elements.  lens null: block entries of bs rows;
// else decode entries of one row at lens[e] mod bs.  vec = 1: row % 8 ==
// 0 and every row start 16-byte aligned.  Returns cudaGetLastError()
// after the launch (0 on success).  Allocates nothing and does not
// synchronise.
int kv_paged_write_launch(int src_type, int dst_type, void* k_pool,
                          void* v_pool, void* k_scale, void* v_scale,
                          const void* k_src, const void* v_src,
                          const void* ids, const void* lens,
                          long long k_row_stride, long long v_row_stride,
                          long long k_layer_stride, long long v_layer_stride,
                          int n, int L, int NB, int bs, int row, int vec,
                          void* stream) {
  if (n <= 0 || L <= 0) return 0;
  PagedArgs a;
  a.pool[0] = static_cast<char*>(k_pool);
  a.pool[1] = static_cast<char*>(v_pool);
  a.scale[0] = static_cast<float*>(k_scale);
  a.scale[1] = static_cast<float*>(v_scale);
  a.src[0] = static_cast<const char*>(k_src);
  a.src[1] = static_cast<const char*>(v_src);
  a.ids = static_cast<const int32_t*>(ids);
  a.lens = static_cast<const int32_t*>(lens);
  a.src_row_stride[0] = k_row_stride;
  a.src_row_stride[1] = v_row_stride;
  a.src_layer_stride[0] = k_layer_stride;
  a.src_layer_stride[1] = v_layer_stride;
  a.rpe = lens == nullptr ? bs : 1;
  a.n_rows = n * a.rpe;
  a.NB = NB;
  a.bs = bs;
  a.row = row;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src_type) {
    case 0: return launch_paged<float>(a, dst_type, L, s);
    case 1: return launch_paged<__nv_bfloat16>(a, dst_type, L, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
