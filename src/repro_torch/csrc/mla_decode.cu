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
// serving path's decode lengths, 1.98 us at 3.35 TB/s (2.07 with q and
// the output).  The operations are 2 * H * (2r + dr) per token, 0.2 GFLOP
// there: 0.2 us on the tensor cores.  The split workspace is the kernel's
// own traffic, not the bound's.
//
// Design (bf16: mla_decode_mma_kernel).  Every head of a sequence reads
// the same latent row, and deepseek-v2-lite has 16 heads: the m = 16 of an
// mma.sync m16n8k16 product.  So a block serves 16 heads (the last group
// of a head count that is no multiple of 16 padded with zero rows) and
// reads each row of its span once for all of them.  Grid (B, context
// splits of SPAN tokens, 16-head groups); blocks past a sequence's length
// exit at once.  A block of 8 warps stages q and its span's rows, c then
// kr (1,152 B a token, 16 bytes of padding), into shared memory with
// 16-byte cp.async copies, 64 tokens a tile, two tiles in flight.  Per
// tile: S[16 x 64] = [q_eff | q_rope] [c | kr]^T on the tensor cores, a
// warp per 8 tokens over the 36 k-steps (bf16 in, exact; f32 sums); an
// online softmax per head in f32 with the tile's row maxima exchanged
// through shared memory (every warp holds the same running max); P split
// into bf16 parts P_hi + P_lo as in csrc/paged_decode.cu, so that the
// output is the f32 answer rounded once; O[16 x 512] += P_hi C + P_lo C
// with C through ldmatrix.trans, each warp 64 of the 512 columns (32 f32
// registers a thread).  The splits of a sequence longer than SPAN are
// merged by the last block to finish, in split order, through a workspace
// and a per-(sequence, head group) counter that the merging block resets
// (one launch, no memset, the same bits on every run); its loop keeps 4
// splits' loads in flight.  The scores' 36 products are summed in two
// chains (even and odd k-steps).  Timed on the way
// (tools/torch_ssd_mla_variants.py; an NVIDIA H100 80GB HBM3 at 700 W; ms
// at deepseek-v2-lite's decode lengths / 2,048 tokens each): SPAN 128
// 0.0231 / 0.0284, 64 (94 live blocks, 32 splits to merge) 0.0318 /
// 0.0380, 256 0.0252 / 0.0271; the merge with 4 splits in flight and the
// two score chains 0.0209 / 0.0263 (kept); P . C's hi and lo products
// of one accumulator issued apart: no gain.
//
// f32 (mla_decode_kernel) stays on CUDA cores, as every redesigned
// kernel's f32 instance has: grid (B, H/HG, ceil(S/CH)) with HG = 2 heads
// and CH = 256 tokens a block; 8 warps each walk their own tokens,
// reading each latent row into registers and folding it into both
// products as scalar f32 FMAs, one online softmax per warp, the warps and
// then the blocks merged in a fixed order (the same counter scheme).  It
// reads a sequence's rows H/HG times and is not on the card's main path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HG = 2;     // heads an f32 block serves
constexpr int CH = 256;   // tokens of a sequence an f32 block reads
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

// ------------------------------------------------ tensor-core instance

constexpr int MH = 16;         // heads a block serves: an mma's 16 rows
constexpr int SPAN = 128;      // context tokens a block reads
constexpr int TT = 64;         // tokens a staged tile holds
constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int RING = SPAN / TT < 2 ? 1 : 2;   // tiles in flight
constexpr int MAX_DEVICES = 64;         // devices a process may launch on
static_assert(SPAN % TT == 0 && TT == 8 * MMA_WARPS, "a warp per 8 tokens");

typedef __nv_bfloat16 bf16;

// 16-byte asynchronous copy; a piece that is not `valid` is zero-filled
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
// a gpu-scope atomic add that releases this thread's earlier writes (and
// those a barrier ordered before it) and acquires those of the adds
// before it
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// a = hi + lo to about 2^-17 of a, each part a bf16 (csrc/paged_decode.cu)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 8x8 b16 tiles of shared memory: lane l gives the row address of tile
// l / 8 (.x2: lanes 0-15); .trans transposes each tile
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}
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

// Shared memory of the tensor-core instance at (R, DR): q [MH][ROW], the
// tiles [RING][TT][ROW] (a token's c then kr, 16 bytes of padding so that
// ldmatrix's 8 rows fall on distinct banks), P's parts [2][MH][PROW], the
// warps' row maxima and sums [MMA_WARPS][MH] f32.
template <int R, int DR>
struct MlaSmem {
  static constexpr int F = R + DR;         // features a token
  static constexpr int ROW = F + 8;        // bf16 a staged row
  static constexpr int PROW = TT + 8;      // bf16 a row of P
  static constexpr int Q_OFF = 0;
  static constexpr int TILE_OFF = Q_OFF + MH * ROW * 2;
  static constexpr int TILE = TT * ROW * 2;
  static constexpr int P_OFF = TILE_OFF + RING * TILE;
  static constexpr int RED_OFF = P_OFF + 2 * MH * PROW * 2;
  static constexpr int BYTES = RED_OFF + 2 * MMA_WARPS * MH * 4;
};

// grid (B, ceil(S / SPAN), ceil(H / MH)), MMA_THREADS; dynamic shared
// memory: the larger of MlaSmem<R, DR>::BYTES and what the merge stages.
// Block (b, s, g) serves heads [MH g, MH g + MH) (rows past H are zero and
// never stored) over tokens [s SPAN, (s + 1) SPAN) up to the length.
// ws_acc [B, G, gridDim.y, MH, R] and ws_ml [B, G, gridDim.y, MH, 2] (f32)
// hold the splits of a sequence longer than SPAN; done [B * G] int32 is
// zero at the start, and the merging block leaves it zero at the end.
template <int R, int DR>
__global__ void __launch_bounds__(MMA_THREADS) mla_decode_mma_kernel(
    const bf16* __restrict__ q_eff, const bf16* __restrict__ q_rope,
    const bf16* __restrict__ c, const bf16* __restrict__ kr,
    const int32_t* __restrict__ lengths, bf16* __restrict__ out,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    int* __restrict__ done, int H, int S, float scale) {
  using L = MlaSmem<R, DR>;
  constexpr int KS = L::F / 16;            // k-steps of a score: 36 or 5
  constexpr int NTW = R / 8 / MMA_WARPS;   // output n-tiles a warp: 8 or 1
  constexpr int CW = R / MMA_WARPS;        // output columns a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* p_hi = reinterpret_cast<bf16*>(smem + L::P_OFF);
  bf16* p_lo = p_hi + MH * L::PROW;
  float* mx_s = reinterpret_cast<float*>(smem + L::RED_OFF);  // [W][MH]
  float* l_s = mx_s + MMA_WARPS * MH;                          // [W][MH]
  __shared__ int last_s;

  const int b = blockIdx.x, sp = blockIdx.y, g = blockIdx.z;
  const int h0 = g * MH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int len = max(0, min(lengths[b], S));
  const int n_split = max(1, (len + SPAN - 1) / SPAN);
  if (sp >= n_split) return;
  const int t0 = sp * SPAN, t1 = min(len, t0 + SPAN);
  const int n_tiles = (t1 - t0 + TT - 1) / TT;   // 0 at a length of 0

  // q of the group's heads, then a tile's rows: 16-byte pieces, zero past
  // H and past the span's last token
  constexpr int QR = R / 8, QD = DR / 8;   // pieces of a c and a kr row
  for (int i = tid; i < MH * (QR + QD); i += MMA_THREADS) {
    const int r = i / (QR + QD), p = i - r * (QR + QD);
    const bool ok = h0 + r < H;
    const size_t hrow = (size_t)b * H + h0 + (ok ? r : 0);
    const bf16* src = p < QR ? q_eff + hrow * R + p * 8
                             : q_rope + hrow * DR + (p - QR) * 8;
    cp_async16(q_s + r * L::ROW + p * 8, src, ok);
  }
  auto issue = [&](int t) {
    if (t < n_tiles) {
      bf16* dst = reinterpret_cast<bf16*>(smem + L::TILE_OFF +
                                          (t % RING) * L::TILE);
      for (int i = tid; i < TT * (QR + QD); i += MMA_THREADS) {
        const int r = i / (QR + QD), p = i - r * (QR + QD);
        const int tok = t0 + t * TT + r;
        const bool ok = tok < t1;
        const size_t row = (size_t)b * S + (ok ? tok : 0);
        const bf16* src = p < QR ? c + row * R + p * 8
                                 : kr + row * DR + (p - QR) * 8;
        cp_async16(dst + r * L::ROW + p * 8, src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < RING; ++t) issue(t);   // q goes with tile 0

  float o[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  // running max of rows gid and gid + 8 (the same in every warp), and the
  // lane's share of their sums
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t == 0) cp_async_wait<RING - 1>();
    else cp_async_wait<0>();
    __syncthreads();                     // tile t landed; t - 1 is done
    if (t > 0) issue(t + RING - 1);      // into tile t - 1's slot
    const bf16* tile = reinterpret_cast<const bf16*>(
        smem + L::TILE_OFF + (t % RING) * L::TILE);

    // scores of the warp's 8 tokens for the 16 heads: S = Q [c | kr]^T
    // two chains of products (even and odd k-steps), summed at the end
    float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const bf16* qrow = q_s + (lane & 15) * L::ROW + (lane >> 4) * 8;
      const bf16* krow = tile + (warp * 8 + (lane & 7)) * L::ROW +
                         (lane >> 3) * 8;
#pragma unroll 6
      for (int ks = 0; ks + 1 < KS; ks += 2) {
        uint32_t a0[4], a1[4], kb[4];
        ldmatrix_x4(a0, qrow + ks * 16);
        ldmatrix_x4(a1, qrow + ks * 16 + 16);
        ldmatrix_x4(kb, krow + ks * 16);
        mma_bf16(s, a0, kb[0], kb[1]);
        mma_bf16(s2, a1, kb[2], kb[3]);
      }
      if (KS % 2) {
        uint32_t a0[4], kb[2];
        ldmatrix_x4(a0, qrow + (KS - 1) * 16);
        ldmatrix_x2(kb, tile + (warp * 8 + (lane & 7)) * L::ROW +
                            (KS - 1) * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s, a0, kb[0], kb[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += s2[e];
    }
    // scale, mask, the warp's maxima of rows gid and gid + 8
    const int tok0 = t0 + t * TT + warp * 8 + 2 * tig;
    float mx[2];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] = tok0 + (e & 1) < t1 ? s[e] * scale : -CUDART_INF_F;
    mx[0] = fmaxf(s[0], s[1]);
    mx[1] = fmaxf(s[2], s[3]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (tig == 0) {
      mx_s[warp * MH + gid] = mx[0];
      mx_s[warp * MH + gid + 8] = mx[1];
    }
    __syncthreads();
    // the tile's maxima, the new running max, P = e^(s - m) split hi + lo
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = m_run[r];
#pragma unroll
      for (int w = 0; w < MMA_WARPS; ++w)
        m = fmaxf(m, mx_s[w * MH + gid + 8 * r]);
      alpha[r] = expf(m_run[r] - m);       // 1 while the max holds
      m_run[r] = m;
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = expf(s[e] - m_run[e >> 1]);
    l_run[0] = l_run[0] * alpha[0] + p[0] + p[1];
    l_run[1] = l_run[1] * alpha[1] + p[2] + p[3];
    {
      uint32_t hi, lo;
      const int col = warp * 8 + 2 * tig;
      split_bf16(p[0], p[1], hi, lo);
      *reinterpret_cast<uint32_t*>(p_hi + gid * L::PROW + col) = hi;
      *reinterpret_cast<uint32_t*>(p_lo + gid * L::PROW + col) = lo;
      split_bf16(p[2], p[3], hi, lo);
      *reinterpret_cast<uint32_t*>(p_hi + (gid + 8) * L::PROW + col) = hi;
      *reinterpret_cast<uint32_t*>(p_lo + (gid + 8) * L::PROW + col) = lo;
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    __syncthreads();                     // P is whole
    // O[:, the warp's CW columns] += P_hi C + P_lo C over the tile
#pragma unroll
    for (int kk = 0; kk < TT / 16; ++kk) {
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, p_hi + (lane & 15) * L::PROW + kk * 16 +
                          (lane >> 4) * 8);
      ldmatrix_x4(al, p_lo + (lane & 15) * L::PROW + kk * 16 +
                          (lane >> 4) * 8);
      const bf16* vrow = tile + (kk * 16 + (lane & 15)) * L::ROW +
                         warp * CW + (lane >> 4) * 8;
      if constexpr (NTW % 2 == 0) {
#pragma unroll
        for (int np = 0; np < NTW / 2; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + np * 16);
          mma_bf16(o[2 * np], ah, bv[0], bv[1]);
          mma_bf16(o[2 * np], al, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], ah, bv[2], bv[3]);
          mma_bf16(o[2 * np + 1], al, bv[2], bv[3]);
        }
      } else {
        uint32_t bv[2];                  // one n-tile: lanes 0-15's rows
        ldmatrix_x2_trans(bv, tile + (kk * 16 + (lane & 15)) * L::ROW +
                                  warp * CW);
        mma_bf16(o[0], ah, bv[0], bv[1]);
        mma_bf16(o[0], al, bv[0], bv[1]);
      }
    }
  }
  cp_async_wait<0>();

  // each row's sum: the quad's lanes, then the warps in order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (tig == 0) {
    l_s[warp * MH + gid] = l_run[0];
    l_s[warp * MH + gid + 8] = l_run[1];
  }
  __syncthreads();
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int w = 0; w < MMA_WARPS; ++w) {
    lsum[0] += l_s[w * MH + gid];
    lsum[1] += l_s[w * MH + gid + 8];
  }
  const int col0 = warp * CW + 2 * tig;
  if (n_split == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hh = h0 + gid + 8 * r;
      if (hh < H) {
        const float inv = 1.f / fmaxf(lsum[r], 1e-30f);
        bf16* orow = out + ((size_t)b * H + hh) * R + col0;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          *reinterpret_cast<uint32_t*>(orow + nt * 8) =
              pack_bf16(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
      }
    }
    return;
  }

  // several blocks: store this split, and let the last one merge them all
  const size_t key = (size_t)b * gridDim.z + g;
  const size_t split0 = key * gridDim.y;
  float* my_acc = ws_acc + (split0 + sp) * MH * R;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* arow = my_acc + (size_t)(gid + 8 * r) * R + col0;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
      *reinterpret_cast<float2*>(arow + nt * 8) =
          make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
  }
  if (warp == 0 && tig == 0) {
    float2* ml = reinterpret_cast<float2*>(ws_ml) + (split0 + sp) * MH;
    ml[gid] = make_float2(m_run[0], lsum[0]);
    ml[gid + 8] = make_float2(m_run[1], lsum[1]);
  }
  __syncthreads();
  if (tid == 0) {
    last_s = atomic_add_acq_rel(done + key, 1) == n_split - 1;
    if (last_s) done[key] = 0;    // every split has counted: ready for reuse
  }
  __syncthreads();
  if (!last_s) return;
  // the last block: each head's M and L over the splits, each split's
  // weight e^(m_s - M), then the weighted sum in split order, 4 values a
  // load, every split's loads of a value in flight together
  float* w_s = reinterpret_cast<float*>(smem);       // [n_split][MH]
  __shared__ float L_s[MH];
  const float2* base_ml = reinterpret_cast<const float2*>(ws_ml) +
                          split0 * MH;
  if (tid < MH) {
    float M = NEG_INF, Lt = 0.f;
    for (int q = 0; q < n_split; ++q) M = fmaxf(M, __ldcg(base_ml + q * MH +
                                                          tid).x);
    for (int q = 0; q < n_split; ++q) {
      const float2 ml = __ldcg(base_ml + q * MH + tid);
      const float w = expf(ml.x - M);
      w_s[q * MH + tid] = w;
      Lt += ml.y * w;
    }
    L_s[tid] = Lt;
  }
  __syncthreads();
  constexpr int E = MH * R / 4 / MMA_THREADS;        // float4s a thread
  const float4* base_acc = reinterpret_cast<const float4*>(
      ws_acc + split0 * MH * R);
  float4 a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int q = 0; q < n_split; ++q) {
    float4 v[E];
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = __ldcg(base_acc + (size_t)q * MH * R / 4 + tid + e * MMA_THREADS);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int row = (tid + e * MMA_THREADS) * 4 / R;
      const float w = w_s[q * MH + row];
      a[e].x = fmaf(v[e].x, w, a[e].x);
      a[e].y = fmaf(v[e].y, w, a[e].y);
      a[e].z = fmaf(v[e].z, w, a[e].z);
      a[e].w = fmaf(v[e].w, w, a[e].w);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = (tid + e * MMA_THREADS) * 4, row = i / R;
    if (h0 + row < H) {
      const float inv = 1.f / fmaxf(L_s[row], 1e-30f);
      bf16* o4 = out + ((size_t)b * H + h0) * R + i;
      *reinterpret_cast<uint2*>(o4) =
          make_uint2(pack_bf16(a[e].x * inv, a[e].y * inv),
                     pack_bf16(a[e].z * inv, a[e].w * inv));
    }
  }
}

template <int R, int DR>
int launch_mma(const void* qe, const void* qr, const void* c, const void* kr,
               const void* lengths, void* out, void* ws_acc, void* ws_ml,
               void* done, int B, int H, int S, float scale,
               cudaStream_t stream) {
  using L = MlaSmem<R, DR>;
  const dim3 grid(B, S > 0 ? (S + SPAN - 1) / SPAN : 1, (H + MH - 1) / MH);
  // the merge's weights [splits][MH] reuse the bytes of q and the tiles
  const size_t smem = std::max((size_t)L::BYTES,
                               (size_t)grid.y * MH * sizeof(float));
  auto kernel = mla_decode_mma_kernel<R, DR>;
  // once per device: opt in to all the dynamic shared memory a block may
  // have beside the kernel's static arrays (past 48 KB a launch needs it)
  static std::atomic<int> limit[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
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
    if (err != cudaSuccess) return (int)err;
    limit[dev].store(n, std::memory_order_relaxed);
  }
  if (smem > (size_t)limit[dev].load(std::memory_order_relaxed))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(qe), static_cast<const bf16*>(qr),
      static_cast<const bf16*>(c), static_cast<const bf16*>(kr),
      static_cast<const int32_t*>(lengths), static_cast<bf16*>(out),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
      static_cast<int*>(done), H, S, scale);
  return (int)cudaGetLastError();
}

template <int R, int DR>
int launch_by_type(int dtype, const void* qe, const void* qr, const void* c,
                   const void* kr, const void* lengths, void* out,
                   void* ws_acc, void* ws_ml, void* done, int B, int H, int S,
                   float scale, cudaStream_t s) {
  if (dtype == 1)
    return launch_mma<R, DR>(qe, qr, c, kr, lengths, out, ws_acc, ws_ml,
                             done, B, H, S, scale, s);
  if (dtype == 0 && H % HG == 0)
    return launch<float, R, DR>(qe, qr, c, kr, lengths, out, ws_acc, ws_ml,
                                done, B, H, S, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (H even), 1 = bfloat16 (any H) for q_eff, q_rope, c,
// kr and out; lengths int32; (r, dr) in {(512, 64), (64, 16)}; every
// pointer 16-byte aligned.  Workspace (f32): bf16 -- ws_acc holds B *
// ceil(H / 16) * max(1, ceil(S / SPAN)) * 16 * r values, ws_ml the same
// count over r times 2, done B * ceil(H / 16) int32 zeros; f32 -- B * H *
// max(1, ceil(S / CH)) * r values, the same over r times 2, B * H / 2
// zeros.  The launch leaves done zero; two launches that may run at once
// must not share it.  Returns cudaGetLastError() after the launch (0 on
// success).  Allocates nothing and does not synchronise.
int mla_decode_attention_launch(int dtype, const void* q_eff,
                                const void* q_rope, const void* c,
                                const void* kr, const void* lengths,
                                void* out, void* ws_acc, void* ws_ml,
                                void* done, int B, int H, int S, int r,
                                int dr, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return 0;
  if (r == 512 && dr == 64)
    return launch_by_type<512, 64>(dtype, q_eff, q_rope, c, kr, lengths, out,
                                   ws_acc, ws_ml, done, B, H, S, scale, s);
  if (r == 64 && dr == 16)
    return launch_by_type<64, 16>(dtype, q_eff, q_rope, c, kr, lengths, out,
                                  ws_acc, ws_ml, done, B, H, S, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
