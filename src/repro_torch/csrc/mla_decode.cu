// Absorbed MLA decode attention over the latent cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mla_decode_attention
// (src/repro/kernels/mla_decode.py:73).
//
// What it computes.  One query token per sequence (DeepSeek-V2/V3 decode,
// q already absorbed through W_uk): q_eff [B,H,r], q_rope [B,H,dr], the
// latent cache c [B,S,r] and the shared rope key kr [B,S,dr], lengths [B]
// int32, and a scale.  For t < min(lengths[b], S):
//   s[h,t] = (q_eff[b,h] . c[b,t] + q_rope[b,h] . kr[b,t]) * scale
// and the output is the latent context out[b,h] = softmax_t(s[h]) . c[b]
// [B,H,r], in q's type, f32 inside.  A length of 0 gives zeros, as the
// Pallas kernel (which skips every block) does.  The scale is the
// caller's: the model's 1/sqrt(dn+dr), not the Pallas kernel's formula
// derived from r.
//
// Bound on an H100.  The bytes bound it: every latent row up to each
// length is read once, (r + dr) * itemsize bytes a token (1,152 B in bf16
// at r = 512, dr = 64): 6.64 MB for the 5,764 context tokens of the
// serving path's decode lengths, 1.98 us at 3.35 TB/s.  The operations
// are 2 * H * (2r + dr) per token, 0.2 GFLOP there: 0.2 us on tensor
// cores, about 3 us at the f32 CUDA-core rate this kernel uses.
//
// Design.  What the Pallas kernel keeps out of HBM is the latent tile that
// all H heads share; what a GPU needs beyond that is enough rows in flight
// on enough SMs.  Grid (B, H/HG, ceil(S/CH)) with HG = 2 heads and CH =
// 256 tokens a block: block (b, g, s) serves heads 2g, 2g+1 of sequence b
// over its tokens [s*CH, (s+1)*CH) up to its length (blocks past the
// length exit at once), so a long sequence spreads over many SMs.  In a
// block, 8 warps each walk their own tokens (t = t0 + warp, + 8, ...) and
// read each latent row once from global memory into registers -- a lane
// holds r/64 (value pair)s of c and the pairs of kr, the next row loaded
// while the current one is used -- and use it for both products: the HG
// partial scores are summed across the warp with xor shuffles (so every
// lane holds the same score), and the row is folded into the lane's slice
// of the HG x r accumulator, which stays in registers.  Each warp keeps
// its own online softmax (max m, sum l, rescaling only when the max
// rises).  The block merges its 8 warps in a fixed order through shared
// memory; a sequence that fits one block writes its output there.
// Otherwise each block stores its (m, l, acc) in a workspace and counts
// itself done on an atomic counter; the last block of the (sequence, head
// group) resets the counter to zero for the next launch, merges the splits
// in order 0, 1, ... and writes the output: one launch, no memset, and the
// same result on every run.  Each block reads its rows once; the
// sequence's latent is read H/HG times in all (through L2 when the head
// groups run together): 8 reads at deepseek-v2-lite's decode shape (53 MB
// through L2 for the 6.64 MB), 8 x 8 x 8 blocks at most.  HG = 2 and CH =
// 256 were the fastest of the blockings timed on an H100 at that shape
// (HG 1, 2, 4; CH 128, 256, 512, 2048); one block per sequence (no split)
// was 4.6x slower there: with one row in flight per warp a single SM
// streams a 2,048-token sequence at a few GB/s.  Known gaps, left for
// later work: scalar f32 FMAs on CUDA cores (no mma / wgmma), one row in
// flight per warp, no asynchronous copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HG = 2;     // heads a block serves
constexpr int CH = 256;   // tokens of a sequence a block reads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Lane `lane`'s pairs of one latent row: pairs j*32 + lane of the r
// values (R/64 of them) and of the dr values (zero past dr/2 pairs).
template <typename T, int R, int DR>
__device__ __forceinline__ void load_row(
    const T* c_t, const T* kr_t, int lane, float2 (&cr)[R / 64],
    float2 (&kk)[(DR / 2 + 31) / 32]) {
#pragma unroll
  for (int j = 0; j < R / 64; ++j)
    cr[j] = load_pair(c_t + 2 * (j * 32 + lane));
#pragma unroll
  for (int j = 0; j < (DR / 2 + 31) / 32; ++j) {
    const int p = j * 32 + lane;
    kk[j] = p < DR / 2 ? load_pair(kr_t + 2 * p) : make_float2(0.f, 0.f);
  }
}

// grid (B, H / HG, ceil(S / CH)); a lane holds pairs j*32 + lane of each
// r row (NP of them) and of each dr row (NPR, valid while the pair index
// is < dr/2).  ws_acc [B, G, gridDim.z, HG, R] and ws_ml [B, G, gridDim.z,
// HG, 2] (f32) hold the splits of a sequence that spans several blocks;
// done [B * G] int32 is zero at the start, and the merging block leaves it
// zero at the end.
template <typename T, int R, int DR>
__global__ void __launch_bounds__(THREADS) mla_decode_kernel(
    const T* __restrict__ q_eff, const T* __restrict__ q_rope,
    const T* __restrict__ c, const T* __restrict__ kr,
    const int32_t* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    int* __restrict__ done, int H, int S, float scale) {
  constexpr int NP = R / 64;
  constexpr int NPR = (DR / 2 + 31) / 32;
  __shared__ float m_s[WARPS][HG], l_s[WARPS][HG], M_s[HG], L_s[HG];
  __shared__ float2 acc_s[HG][R / 2];
  __shared__ int last_s;

  const int b = blockIdx.x, g = blockIdx.y, h0 = g * HG, sp = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = max(0, min(lengths[b], S));
  const int n_split = max(1, (len + CH - 1) / CH);
  if (sp >= n_split) return;
  const int t0 = sp * CH, t1 = min(len, t0 + CH);

  float2 qe[HG][NP], qr[HG][NPR], acc[HG][NP];
  float m[HG], l[HG];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    const T* qe_h = q_eff + ((size_t)b * H + h0 + h) * R;
    const T* qr_h = q_rope + ((size_t)b * H + h0 + h) * DR;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      qe[h][j] = load_pair(qe_h + 2 * (j * 32 + lane));
      acc[h][j] = make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < NPR; ++j) {
      const int p = j * 32 + lane;
      qr[h][j] = p < DR / 2 ? load_pair(qr_h + 2 * p) : make_float2(0.f, 0.f);
    }
    m[h] = NEG_INF;
    l[h] = 0.f;
  }

  const T* c_b = c + (size_t)b * S * R;
  const T* kr_b = kr + (size_t)b * S * DR;
  float2 cv[NP], kv[NPR];
  if (t0 + warp < t1)
    load_row<T, R, DR>(c_b + (size_t)(t0 + warp) * R,
                       kr_b + (size_t)(t0 + warp) * DR, lane, cv, kv);
  for (int t = t0 + warp; t < t1; t += WARPS) {
    float2 cn[NP], kn[NPR];
    const int tn = t + WARPS;
    if (tn < t1)
      load_row<T, R, DR>(c_b + (size_t)tn * R, kr_b + (size_t)tn * DR, lane,
                         cn, kn);
    float s[HG];
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j)
        a = fmaf(qe[h][j].x, cv[j].x, fmaf(qe[h][j].y, cv[j].y, a));
#pragma unroll
      for (int j = 0; j < NPR; ++j)
        a = fmaf(qr[h][j].x, kv[j].x, fmaf(qr[h][j].y, kv[j].y, a));
      s[h] = a;
    }
    // xor butterfly: every lane ends with the same sum (a + b == b + a)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int h = 0; h < HG; ++h)
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], o);
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      const float sc = s[h] * scale;
      if (sc > m[h]) {                  // warp-uniform
        const float alpha = expf(m[h] - sc);
        l[h] *= alpha;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          acc[h][j].x *= alpha;
          acc[h][j].y *= alpha;
        }
        m[h] = sc;
      }
      const float p = expf(sc - m[h]);
      l[h] += p;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        acc[h][j].x = fmaf(p, cv[j].x, acc[h][j].x);
        acc[h][j].y = fmaf(p, cv[j].y, acc[h][j].y);
      }
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) cv[j] = cn[j];
#pragma unroll
    for (int j = 0; j < NPR; ++j) kv[j] = kn[j];
  }

  // merge the block's warps: acc_s = sum_w e^(m_w - M) acc_w, L = sum_w
  // e^(m_w - M) l_w, in warp order
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      m_s[warp][h] = m[h];
      l_s[warp][h] = l[h];
    }
  }
  __syncthreads();
  float f[HG];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_s[w][h]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) L += l_s[w][h] * expf(m_s[w][h] - M);
    f[h] = expf(m[h] - M);
    if (threadIdx.x == 0) {
      M_s[h] = M;
      L_s[h] = L;
    }
  }
  for (int w = 0; w < WARPS; ++w) {       // fixed order: deterministic
    if (warp == w) {
#pragma unroll
      for (int h = 0; h < HG; ++h)
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          float2& a = acc_s[h][j * 32 + lane];
          const float2 base = w ? a : make_float2(0.f, 0.f);
          a = make_float2(fmaf(acc[h][j].x, f[h], base.x),
                          fmaf(acc[h][j].y, f[h], base.y));
        }
    }
    __syncthreads();
  }
  const float* acc_flat = reinterpret_cast<const float*>(acc_s);
  T* o = out + ((size_t)b * H + h0) * R;
  if (n_split == 1) {
    for (int i = threadIdx.x; i < HG * R; i += THREADS)
      store(o + i, acc_flat[i] / fmaxf(L_s[i / R], 1e-30f));
    return;
  }

  // several blocks: store this split, and let the last one merge them all
  const size_t key = (size_t)b * gridDim.y + g;
  float* my_acc = ws_acc + (key * gridDim.z + sp) * HG * R;
  for (int i = threadIdx.x; i < HG * R; i += THREADS) my_acc[i] = acc_flat[i];
  if (threadIdx.x < HG) {
    float* ml = ws_ml + ((key * gridDim.z + sp) * HG + threadIdx.x) * 2;
    ml[0] = M_s[threadIdx.x];
    ml[1] = L_s[threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last_s = atomicAdd(done + key, 1) == n_split - 1;
    if (last_s) done[key] = 0;    // every split has counted: ready for reuse
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* base_acc = ws_acc + key * gridDim.z * HG * R;
  const float* base_ml = ws_ml + key * gridDim.z * HG * 2;
  if (threadIdx.x < HG) {
    const int h = threadIdx.x;
    float M = NEG_INF, L = 0.f;
    for (int q = 0; q < n_split; ++q)
      M = fmaxf(M, __ldcg(base_ml + (q * HG + h) * 2));
    for (int q = 0; q < n_split; ++q)
      L += __ldcg(base_ml + (q * HG + h) * 2 + 1) *
           expf(__ldcg(base_ml + (q * HG + h) * 2) - M);
    M_s[h] = M;
    L_s[h] = L;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HG * R; i += THREADS) {
    const int h = i / R;
    float v = 0.f;
    for (int q = 0; q < n_split; ++q)
      v = fmaf(__ldcg(base_acc + (size_t)q * HG * R + i),
               expf(__ldcg(base_ml + (q * HG + h) * 2) - M_s[h]), v);
    store(o + i, v / fmaxf(L_s[h], 1e-30f));
  }
}

template <typename T, int R, int DR>
int launch(const void* qe, const void* qr, const void* c, const void* kr,
           const void* lengths, void* out, void* ws_acc, void* ws_ml,
           void* done, int B, int H, int S, float scale,
           cudaStream_t stream) {
  const dim3 grid(B, H / HG, S > 0 ? (S + CH - 1) / CH : 1);
  mla_decode_kernel<T, R, DR><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(qe), static_cast<const T*>(qr),
      static_cast<const T*>(c), static_cast<const T*>(kr),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
      static_cast<int*>(done), H, S, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_shape(int r, int dr, const void* qe, const void* qr, const void* c,
             const void* kr, const void* lengths, void* out, void* ws_acc,
             void* ws_ml, void* done, int B, int H, int S, float scale,
             cudaStream_t s) {
  if (r == 512 && dr == 64)
    return launch<T, 512, 64>(qe, qr, c, kr, lengths, out, ws_acc, ws_ml,
                              done, B, H, S, scale, s);
  if (r == 64 && dr == 16)
    return launch<T, 64, 16>(qe, qr, c, kr, lengths, out, ws_acc, ws_ml,
                             done, B, H, S, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q_eff, q_rope, c, kr, out); lengths
// int32.  (r, dr) in {(512, 64), (64, 16)}; H even.  Workspace (f32):
// ws_acc holds B * H * max(1, ceil(S / 256)) * r values, ws_ml the same
// count over r times 2; done holds B * H / 2 int32 zeros, which the launch
// leaves zero; two launches that may run at once must not share it.
// Returns cudaGetLastError() after the launch (0 on
// success).  Allocates nothing and does not synchronise.
int mla_decode_attention_launch(int dtype, const void* q_eff,
                                const void* q_rope, const void* c,
                                const void* kr, const void* lengths,
                                void* out, void* ws_acc, void* ws_ml,
                                void* done, int B, int H, int S, int r,
                                int dr, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return 0;
  if (H % HG) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return by_shape<float>(r, dr, q_eff, q_rope, c, kr, lengths, out, ws_acc,
                           ws_ml, done, B, H, S, scale, s);
  if (dtype == 1)
    return by_shape<__nv_bfloat16>(r, dr, q_eff, q_rope, c, kr, lengths, out,
                                   ws_acc, ws_ml, done, B, H, S, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
