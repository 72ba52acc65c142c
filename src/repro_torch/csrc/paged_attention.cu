// Mixed (chunked-prefill) attention over the paged KV block pool, for
// Hopper (sm_90a), over pools of q's type or int8 pools with scales.
//
// Replaces two Pallas TPU kernels of the reference package:
//   * mixed_block_paged_attention         (src/repro/kernels/paged_attention.py:322)
//   * quant_mixed_block_paged_attention   (src/repro/kernels/paged_attention.py:430)
// One kernel, templated on the pools' storage type.  The decodes run the
// split-context kernel of paged_decode.cu: block_paged_decode_attention
// (paged_attention.py:123), the slot-contiguous paged_decode_attention
// (:75) and the int8 quant_block_paged_decode_attention (:217); at q_len
// == 1 this kernel computes the same function with sums in another order.
//
// What it computes.  q [B,Sq,H,hd]; k/v pools [NB,bs,KVH,hd]; block tables
// [B,MB] int32; ctx_lens [B]; q_lens [B].  Query row i of sequence b sits
// at position q_abs = ctx - q_len + i and attends to positions pos < ctx &&
// pos <= q_abs of its context, gathered block by block through its table.
// Online softmax in f32 (running max m, sum l, accumulator acc), scale
// 1/sqrt(hd), masked scores -1e30, output acc / max(l, 1e-30) cast to q's
// dtype — the Pallas kernel's arithmetic.
//
// int8 pools (_quant_mixed_kernel of the reference).  Each token row of k
// and v has one f32 scale, in [NB,bs] scale pools read through the same
// table entry as the rows.  The dequantization commutes out of both
// contractions, as in the Pallas kernel: the int8 rows are staged as f32
// without their scale; the score is dot(q, k_i8) * sk[t] * scale, in that
// order; the running sum l adds p, and the accumulator adds (p * sv[t]) *
// v_i8, so sv never enters l.  Rows are loaded 8 int8 values per thread
// (one 8-byte load; hd % 8 == 0 and 8-byte aligned pools, which the
// wrapper checks).
//
// Bound on an H100.  Memory: every K/V row of the context is read once per
// (sequence, kv head), so the least time is (K+V bytes of the context + q +
// out) / 3.35 TB/s; the arithmetic (4*hd FLOPs per query row and context
// token) is under that at a 128-token chunk: 2.03 us at qwen3-30b-a3b's
// chunk of 104 rows over a 1,000-token context.
//
// Design.  One block of 128 threads per (row tile, kv head, sequence).  A
// row tile holds up to ROWS_MAX query rows (the G = H/KVH grouped heads of
// consecutive chunk positions), so a 128-token chunk with G = 8 spreads over
// 64 tiles per kv head instead of one 1024-row accumulator (the Pallas
// kernel's VMEM block).  The block loads its own table entries (the TPU
// kernel's scalar prefetch), clamps the NB sentinel to NB - 1 where it reads
// the table (for the rows and the scales alike), and stages one K/V block
// [bs, hd] at a time in shared memory, in f32; scores, the softmax update
// and acc += p @ v are plain FMAs on CUDA cores.  Blocks past the last
// position any row of the tile attends are skipped: their scores are all
// masked, so skipping them changes no bit.  Known gaps, measured and left
// for later work: serial work inside the block, about 8 us per 16-token KV
// block (the scores are hd scalar FMAs per thread from shared memory, the
// softmax update runs on R of the 128 threads serially over the block's
// tokens, four barriers per block); no tensor cores or asynchronous
// copies: 0.79 ms at the chunk above on an NVIDIA H100 80GB HBM3 at 700 W,
// 11.7x SDPA.  paged_decode.cu's split-context design is what removed the
// same gaps from the decodes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS_MAX = 16;
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

// One int8 value of a 4-byte word, sign-extended, as f32.
__device__ __forceinline__ float i8_at(int w, int j) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * j)));
}

// grid (row tiles, KVH, B); dynamic shared memory: see smem_bytes().  KV is
// the pools' storage type: T itself, or int8_t with f32 scale pools
// k_scale / v_scale [NB, bs] (unused, and null, otherwise); block pools
// [NB, bs, KVH, hd] read through the tables.
template <typename T, typename KV>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_pool,
    const float* __restrict__ k_scale, const KV* __restrict__ v_pool,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ ctx_lens, const int32_t* __restrict__ q_lens,
    T* __restrict__ out, int Sq, int H, int KVH, int hd, int NB, int bs,
    int MB, int R, float scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  extern __shared__ float smem[];
  const int G = H / KVH;
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int row0 = tile * R;
  const int nrows = min(R, Sq * G - row0);
  const int hdp = hd + 1;  // padded K rows: no bank conflicts across t
  float* q_s = smem;              // [R][hd]
  float* acc = q_s + R * hd;      // [R][hd]
  float* k_s = acc + R * hd;      // [bs][hd + 1]
  float* v_s = k_s + bs * hdp;    // [bs][hd]
  float* p_s = v_s + bs * hd;     // [R][bs] scores, then probabilities
  float* m_s = p_s + R * bs;      // [R] running max
  float* l_s = m_s + R;           // [R] running sum
  float* a_s = l_s + R;           // [R] rescale factor of this step
  float* sk_s = a_s + R;          // [bs] k scales of the block (int8 only)
  float* sv_s = sk_s + bs;        // [bs] v scales of the block (int8 only)
  const int tid = threadIdx.x;

  const int ctx = ctx_lens[b];
  const int q_len = q_lens[b];

  for (int idx = tid; idx < R * hd; idx += THREADS) {
    const int r = idx / hd, d = idx - (idx / hd) * hd;
    float v = 0.f;
    if (r < nrows) {
      const int rr = row0 + r, i = rr / G, g = rr - (rr / G) * G;
      v = to_f32(q[(((size_t)b * Sq + i) * H + kvh * G + g) * hd + d]);
    }
    q_s[idx] = v;
    acc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  // q_abs grows with the row index, so the tile's last row bounds the
  // positions any of its rows attends
  const int last_qabs = ctx - q_len + (row0 + nrows - 1) / G;
  const int limit = min(ctx, last_qabs + 1);
  const int nblk = limit > 0 ? (limit + bs - 1) / bs : 0;
  __syncthreads();

  for (int ki = 0; ki < nblk; ++ki) {
    const int phys = min(max(tables[(size_t)b * MB + ki], 0), NB - 1);
    if constexpr (QUANT) {
      const int hd8 = hd >> 3;
      for (int idx = tid; idx < bs * hd8; idx += THREADS) {
        const int t = idx / hd8, d = (idx - t * hd8) << 3;
        const size_t off = (((size_t)phys * bs + t) * KVH + kvh) * hd + d;
        const int2 kw = *reinterpret_cast<const int2*>(k_pool + off);
        const int2 vw = *reinterpret_cast<const int2*>(v_pool + off);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          k_s[t * hdp + d + j] = i8_at(kw.x, j);
          k_s[t * hdp + d + 4 + j] = i8_at(kw.y, j);
          v_s[t * hd + d + j] = i8_at(vw.x, j);
          v_s[t * hd + d + 4 + j] = i8_at(vw.y, j);
        }
      }
      for (int t = tid; t < bs; t += THREADS) {
        sk_s[t] = k_scale[(size_t)phys * bs + t];
        sv_s[t] = v_scale[(size_t)phys * bs + t];
      }
    } else {
      for (int idx = tid; idx < bs * hd; idx += THREADS) {
        const int t = idx / hd, d = idx - (idx / hd) * hd;
        const size_t off = (((size_t)phys * bs + t) * KVH + kvh) * hd + d;
        k_s[t * hdp + d] = to_f32(k_pool[off]);
        v_s[idx] = to_f32(v_pool[off]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < R * bs; idx += THREADS) {
      const int r = idx / bs, t = idx - (idx / bs) * bs;
      const float* qr = q_s + r * hd;
      const float* kr = k_s + t * hdp;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int pos = ki * bs + t;
      const int q_abs = ctx - q_len + (row0 + r) / G;
      float sc;
      if constexpr (QUANT) sc = dot * sk_s[t] * scale;
      else sc = dot * scale;
      p_s[idx] = (pos < ctx && pos <= q_abs) ? sc : NEG_INF;
    }
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
      const float m_prev = m_s[r];
      float m_cur = m_prev;
      for (int t = 0; t < bs; ++t) m_cur = fmaxf(m_cur, p_s[r * bs + t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(p_s[r * bs + t] - m_cur);
        // int8: the v scale folds into the probability row, not into l
        if constexpr (QUANT) p_s[r * bs + t] = p * sv_s[t];
        else p_s[r * bs + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_cur);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_cur;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int idx = tid; idx < R * hd; idx += THREADS) {
      const int r = idx / hd, d = idx - (idx / hd) * hd;
      const float* pr = p_s + r * bs;
      float a = acc[idx] * a_s[r];
      for (int t = 0; t < bs; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
      acc[idx] = a;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nrows * hd; idx += THREADS) {
    const int r = idx / hd, d = idx - (idx / hd) * hd;
    const int rr = row0 + r, i = rr / G, g = rr - (rr / G) * G;
    const float o = acc[idx] / fmaxf(l_s[r], 1e-30f);
    out[(((size_t)b * Sq + i) * H + kvh * G + g) * hd + d] = from_f32<T>(o);
  }
}

size_t smem_bytes(int R, int hd, int bs, bool quant) {
  return sizeof(float) * ((size_t)2 * R * hd + (size_t)bs * (hd + 1) +
                          (size_t)bs * hd + (size_t)R * bs + 3 * (size_t)R +
                          (quant ? 2 * (size_t)bs : 0));
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pool, const void* k_scale,
           const void* v_pool, const void* v_scale, const void* tables,
           const void* ctx_lens, const void* q_lens, void* out, int B, int Sq,
           int H, int KVH, int hd, int NB, int bs, int MB, float scale,
           cudaStream_t stream) {
  const int rows = Sq * (H / KVH);
  const int R = rows < ROWS_MAX ? rows : ROWS_MAX;
  const dim3 grid((rows + R - 1) / R, KVH, B);
  const size_t smem =
      smem_bytes(R, hd, bs, std::is_same<KV, int8_t>::value);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attention_kernel<T, KV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const float*>(k_scale), static_cast<const KV*>(v_pool),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(ctx_lens),
      static_cast<const int32_t*>(q_lens), static_cast<T*>(out), Sq, H, KVH,
      hd, NB, bs, MB, R, scale);
  return (int)cudaGetLastError();
}

// dtype: q/out type, 0 = float32, 1 = bfloat16; quant: int8 pools + scales
// (else pools of q's type and null scales).
int dispatch(int dtype, bool quant, const void* q, const void* k_pool,
             const void* k_scale, const void* v_pool, const void* v_scale,
             const void* tables, const void* ctx_lens, const void* q_lens,
             void* out, int B, int Sq, int H, int KVH, int hd, int NB, int bs,
             int MB, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(T, KV)                                                    \
  launch<T, KV>(q, k_pool, k_scale, v_pool, v_scale, tables, ctx_lens,     \
                q_lens, out, B, Sq, H, KVH, hd, NB, bs, MB, scale, s)
  if (dtype == 0) return quant ? PA_LAUNCH(float, int8_t)
                               : PA_LAUNCH(float, float);
  if (dtype == 1) return quant ? PA_LAUNCH(__nv_bfloat16, int8_t)
                               : PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, out and, unquantized, the pools).
// Returns cudaGetLastError() after the launch (0 on success).  Allocates
// nothing and does not synchronise.
int mixed_block_paged_attention_launch(int dtype, const void* q,
                                       const void* k_pool, const void* v_pool,
                                       const void* tables,
                                       const void* ctx_lens,
                                       const void* q_lens, void* out, int B,
                                       int Sq, int H, int KVH, int hd, int NB,
                                       int bs, int MB, float scale,
                                       void* stream) {
  return dispatch(dtype, false, q, k_pool, nullptr, v_pool, nullptr, tables,
                  ctx_lens, q_lens, out, B, Sq, H, KVH, hd, NB, bs, MB, scale,
                  stream);
}

// int8 pools [NB,bs,KVH,hd] with f32 scale pools [NB,bs]; q and out of
// type dtype.
int quant_mixed_block_paged_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* tables,
    const void* ctx_lens, const void* q_lens, void* out, int B, int Sq, int H,
    int KVH, int hd, int NB, int bs, int MB, float scale, void* stream) {
  return dispatch(dtype, true, q, k_pool, k_scale, v_pool, v_scale, tables,
                  ctx_lens, q_lens, out, B, Sq, H, KVH, hd, NB, bs, MB, scale,
                  stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
