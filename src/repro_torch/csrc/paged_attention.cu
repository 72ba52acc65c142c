// Paged attention over the KV block pool, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the reference package:
//   * block_paged_decode_attention  (src/repro/kernels/paged_attention.py:123)
//   * mixed_block_paged_attention   (src/repro/kernels/paged_attention.py:322)
// Both are one kernel here: decode is the mixed case with one query row per
// sequence (q_len == 1), so the two agree exactly by construction.
//
// What it computes.  q [B,Sq,H,hd]; k/v pools [NB,bs,KVH,hd]; block tables
// [B,MB] int32; ctx_lens [B]; q_lens [B] (decode: 1).  Query row i of
// sequence b sits at position q_abs = ctx - q_len + i and attends to
// positions pos < ctx && pos <= q_abs of its context, gathered block by
// block through its table.  Online softmax in f32 (running max m, sum l,
// accumulator acc), scale 1/sqrt(hd), masked scores -1e30, output
// acc / max(l, 1e-30) cast to q's dtype — the Pallas kernel's arithmetic.
//
// Bound on an H100.  Memory: every K/V row of the context is read once per
// (sequence, kv head), so the least time is (K+V bytes of the context + q +
// out) / 3.35 TB/s.  Decode at B=8, ctx up to 2048 moves ~33 MB per layer:
// ~10 us.  The arithmetic (4*hd FLOPs per query row and context token) is
// far below the card's rate at decode and, at a 128-token chunk, still
// under the memory time.
//
// Design.  One block of 128 threads per (row tile, kv head, sequence).  A
// row tile holds up to ROWS_MAX query rows (the G = H/KVH grouped heads of
// consecutive chunk positions), so a 128-token chunk with G = 8 spreads over
// 64 tiles per kv head instead of one 1024-row accumulator (the Pallas
// kernel's VMEM block).  The block loads its own table entries (the TPU
// kernel's scalar prefetch) and stages one K/V block [bs, hd] at a time in
// shared memory, in f32; scores, the softmax update and acc += p @ v are
// plain FMAs on CUDA cores.  Blocks past the last position any row of the
// tile attends are skipped: their scores are all masked, so skipping them
// changes no bit.  Known gaps, measured and left for later work: decode
// fills B*KVH = 32 blocks of 132 SMs (no split over the context), and no
// tensor cores or asynchronous copies are used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// grid (row tiles, KVH, B); dynamic shared memory: see smem_bytes().
template <typename T>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ ctx_lens, const int32_t* __restrict__ q_lens,
    T* __restrict__ out, int Sq, int H, int KVH, int hd, int NB, int bs,
    int MB, int R, float scale) {
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
  const int tid = threadIdx.x;

  const int ctx = ctx_lens[b];
  const int q_len = q_lens ? q_lens[b] : 1;

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
    int phys = tables[(size_t)b * MB + ki];
    phys = min(max(phys, 0), NB - 1);
    for (int idx = tid; idx < bs * hd; idx += THREADS) {
      const int t = idx / hd, d = idx - (idx / hd) * hd;
      const size_t off = (((size_t)phys * bs + t) * KVH + kvh) * hd + d;
      k_s[t * hdp + d] = to_f32(k_pool[off]);
      v_s[idx] = to_f32(v_pool[off]);
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
      p_s[idx] = (pos < ctx && pos <= q_abs) ? dot * scale : NEG_INF;
    }
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
      const float m_prev = m_s[r];
      float m_cur = m_prev;
      for (int t = 0; t < bs; ++t) m_cur = fmaxf(m_cur, p_s[r * bs + t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(p_s[r * bs + t] - m_cur);
        p_s[r * bs + t] = p;
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

size_t smem_bytes(int R, int hd, int bs) {
  return sizeof(float) * ((size_t)2 * R * hd + (size_t)bs * (hd + 1) +
                          (size_t)bs * hd + (size_t)R * bs + 3 * (size_t)R);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* ctx_lens, const void* q_lens,
           void* out, int B, int Sq, int H, int KVH, int hd, int NB, int bs,
           int MB, float scale, cudaStream_t stream) {
  const int rows = Sq * (H / KVH);
  const int R = rows < ROWS_MAX ? rows : ROWS_MAX;
  const dim3 grid((rows + R - 1) / R, KVH, B);
  const size_t smem = smem_bytes(R, hd, bs);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(ctx_lens),
      static_cast<const int32_t*>(q_lens), static_cast<T*>(out), Sq, H, KVH,
      hd, NB, bs, MB, R, scale);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const void* q, const void* k_pool, const void* v_pool,
             const void* tables, const void* ctx_lens, const void* q_lens,
             void* out, int B, int Sq, int H, int KVH, int hd, int NB, int bs,
             int MB, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, ctx_lens, q_lens, out, B,
                         Sq, H, KVH, hd, NB, bs, MB, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, ctx_lens, q_lens,
                                 out, B, Sq, H, KVH, hd, NB, bs, MB, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  Allocates nothing and does not synchronise.
int block_paged_decode_attention_launch(int dtype, const void* q,
                                        const void* k_pool,
                                        const void* v_pool,
                                        const void* tables,
                                        const void* lengths, void* out, int B,
                                        int H, int KVH, int hd, int NB, int bs,
                                        int MB, float scale, void* stream) {
  return dispatch(dtype, q, k_pool, v_pool, tables, lengths, nullptr, out, B,
                  1, H, KVH, hd, NB, bs, MB, scale, stream);
}

int mixed_block_paged_attention_launch(int dtype, const void* q,
                                       const void* k_pool, const void* v_pool,
                                       const void* tables,
                                       const void* ctx_lens,
                                       const void* q_lens, void* out, int B,
                                       int Sq, int H, int KVH, int hd, int NB,
                                       int bs, int MB, float scale,
                                       void* stream) {
  return dispatch(dtype, q, k_pool, v_pool, tables, ctx_lens, q_lens, out, B,
                  Sq, H, KVH, hd, NB, bs, MB, scale, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
