// Blocked (flash) attention for a monolithic prefill, for Hopper
// (sm_90a): causal self-attention, with or without a sliding window, and
// non-causal attention (an encoder's, or a cross-attention's over another
// sequence's keys).
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:72).
//
// What it computes.  q [B,S,H,hd]; k [B,Skv,KVH,hd]; v [B,Skv,KVH,hdv]
// (GQA: query head h reads kv head h / (H/KVH)); out [B,S,H,hdv].  Query
// row i attends to key rows t <= i (causal, Skv = S) or to every row (not
// causal: the encoder's self-attention, Skv = S, and the VLM's cross
// prefill, S prompt rows over Skv = 1601 image rows), and with a window W
// only to rows with i - t < W.  None of the three has a TPU kernel of its
// own: the reference computes them in plain mha, which the port routes
// through this kernel.  A window's masked score is the reference's -1e30,
// so a row left with no key (a cross row W or more past the last image
// row) gets the mean of every row of v, as the reference's softmax gives;
// padding past Skv and the causal mask are -inf (a causal row always
// attends itself).  A causal window starts each query tile at the key
// tile of its first row's window and a warp skips a tile below all of its
// rows' windows: about S W key rows a head instead of S^2 / 2.  Online softmax
// in f32 (running max m, sum l, accumulator acc), score = dot(q, k) *
// scale (the caller's; 1/sqrt(hd) for a standard head), output acc /
// max(l, 1e-30) rounded once to q's type -- the Pallas kernel's
// arithmetic.  Given an lse buffer (the training forward, whose backward
// is csrc/flash_attention_bwd.cu), each row also writes m + log(l) in
// units of s * scale; serving passes none, and the output's bits do not
// depend on it.  Instances (hd, hdv): (64, 64), (80, 80) for zamba2's
// shared attention block, (128, 128), and (192, 128) for MLA's prefill
// (q/k carry dn + dr = 192 values, v 128: the reference pads v to 192 and
// trims the output, this instance reads and writes 128); and the reduced
// configs' widths, (16, 16) and MLA's (48, 32), which the f32 parity runs
// of the serving launcher and the closed loop reach on the card.
//
// Bound on an H100.  At the serving path's largest bucket (B=1, S=1024,
// H=32, KVH=4, hd=128, causal) the work is 4*hd operations per attended
// (query, key, head) triple: 8.6 GFLOP, 8.7 us at the bf16 tensor-core
// rate; the bytes (q, k, v read once, out written once) are 18.9 MB, 5.6
// us.  So the kernel is bound by operations.  At MLA's (192, 128), B=1,
// S=1024, H=KVH=16: 2 * (192 + 128) operations per attended triple, 5.4
// GFLOP (5.4 us); 21.0 MB of q, k, v and out (6.3 us): the bytes bound it
// there.  At zamba2's (80, 80), B=1, S=1024, H=KVH=32: 5.4 GFLOP (5.4
// us); 21.0 MB (6.3 us): bytes again.
//
// Design, bf16 (every served path): the tensor cores.  One block of 4
// warps per (query tile of TQ = 64 rows, head, sequence), heavier (later)
// causal tiles first in each head; a loop over key tiles of TK = 64 rows
// takes the place of the Pallas grid's sequential kv axis and stops at the
// tile's causal limit.  Each warp owns 16 query rows: their q fragments
// are loaded once from device memory into registers, and their output
// rows [16 x hdv] stay in f32 registers for the whole loop.  K and V tiles
// come in as bf16 through a two-stage cp.async ring (rows padded by 16
// bytes: ldmatrix reads 8 rows without bank conflicts), the next tile's
// copies in flight while this one is used; one barrier a tile.  S = Q K^T
// by m16n8k16 products (K's fragments by ldmatrix), scaled into log2
// units; masked only on the diagonal tile and the ragged last tile (a
// second instance of the tile body: any S >= 1, padded key columns score
// -inf, padded query rows are computed on zeros and never written); a
// warp skips a tile whose keys all lie past its rows; the row max and sum
// by shuffles within a quad, exponentials by ex2.approx.  The S fragments
// become P's A fragments in registers (P never goes through shared
// memory), split in two bf16 parts, P_hi = bf16(P) and P_lo = bf16(P -
// P_hi), and O += P_hi V + P_lo V (V's fragments by ldmatrix.trans), sums
// in f32.  The two parts keep each probability to about 2^-17 of itself
// as the Pallas kernel's f32 P.V does, so the bf16 output is the f32
// answer rounded once; they cost a second P.V product, 1.5x the tensor
// work of one pass.  A tile's P.V goes into a zeroed fragment a pair of
// n-tiles, added into O with f32 adds: the tensor cores' f32 sums do not
// round to nearest, and summing every tile of a long row on them put the
// output 3.85e-5 past one bf16 rounding of the f32 answer at 9,216 keys
// (8.3e-6 with the f32 adds, which cost 8 % at S = 1024).  No spills.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), causal,
// B=1, S=1024, summing on the tensor cores: 0.0825 ms at
// qwen3-30b-a3b's heads (32/4, 128), 0.0720 ms at MLA's (16/16,
// 192/128), 0.0594 ms at zamba2-2.7b's (32/32, 80): 1.7-2.4x causal SDPA
// and 9.5-11.5x the bound.  The cross instance (1,024 rows over 1,601
// keys) takes 1.11x SDPA's time, the window instance (9,216 rows, W =
// 8,192) 0.84x SDPA's with the same mask (PERF.md).  What is left: timed
// variants that skipped the copies after the first tile changed nothing,
// and dropping all of P.V saved only 28 %; the time is a chain of
// dependent steps per tile (the products, the row max across the quad,
// the rescale, P.V) with two blocks of four warps an SM (the registers of
// O, S and q allow no more).  A wider warp tile or wgmma's asynchronous
// products are the next steps.
//
// Design, f32 (the parity type; no served path runs it): CUDA cores.  One
// block of 256 threads per (query tile of 64 rows, head, sequence); Q, K
// and V tiles staged in shared memory (K and Q rows padded by one float);
// a thread owns 4 query rows and a 4 x hdv/16 slice of the accumulator in
// registers, the row max and sum by shuffles across the 16 threads that
// share the rows, probabilities through shared memory once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float NEG_INF = -1e30f;

// ----------------------------------------------------------- bf16, mma

constexpr int TQ = 64;                       // query rows a block
constexpr int TK = 64;                       // keys a tile
constexpr int STAGES = 2;                    // K/V tiles in flight
constexpr int TC_WARPS = TQ / 16;            // a warp per 16 query rows
constexpr int TC_THREADS = 32 * TC_WARPS;

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

// 2^x (MUFU.EX2: about 2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// four 8x8 bf16 tiles of shared memory: lane l gives the row address of
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

// bytes of a staged K or V row of n bf16 values, padded by 16
__host__ __device__ constexpr int tile_row(int n) { return 2 * n + 16; }
template <int HD, int HDV>
constexpr size_t mma_smem_bytes() {
  return (size_t)STAGES * TK * (tile_row(HD) + tile_row(HDV));
}

// grid (query tiles, H, B), TC_THREADS threads; dynamic shared memory:
// mma_smem_bytes<HD, HDV>() (STAGES K tiles, then STAGES V tiles)
template <int HD, int HDV>
__global__ void __launch_bounds__(TC_THREADS) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int S, int Skv, int H, int KVH, int causal,
    int window, float scale) {
  constexpr int KS = HD / 16;     // k-steps of S = Q K^T
  constexpr int NV = HDV / 8;     // n-tiles of O
  constexpr int KR = tile_row(HD), VR = tile_row(HDV);
  static_assert(HD % 16 == 0 && HDV % 16 == 0, "whole k-steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_s = smem_raw;                      // [STAGES][TK][KR]
  unsigned char* v_s = smem_raw + STAGES * TK * KR;   // [STAGES][TK][VR]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t kv_stride = (size_t)KVH * HD, v_stride = (size_t)KVH * HDV;
  const __nv_bfloat16* k_base = k + (size_t)b * Skv * kv_stride +
                                (size_t)kvh * HD;
  const __nv_bfloat16* v_base = v + (size_t)b * Skv * v_stride +
                                (size_t)kvh * HDV;

  // key tiles up to the last row this query tile attends, and, causal
  // with a window, from the first key its first row's window holds
  const int last = causal ? min(Skv, q0 + TQ) : Skv;
  const int n_k = (last + TK - 1) / TK;
  const int kt0 = causal && window > 0 ? max(0, q0 - window + 1) / TK : 0;

  // tile kt's K and V rows into stage st, zero past S: each thread
  // copies the same 16-byte pieces of every tile
  constexpr int KP = HD / 8, VP = HDV / 8;            // 16-byte pieces a row
  static_assert(TK * KP % TC_THREADS == 0 && TK * VP % TC_THREADS == 0,
                "whole pieces a thread");
  auto issue = [&](int kt, int st) {
    const int k0 = kt * TK;
    unsigned char* kd = k_s + (size_t)st * TK * KR;
    unsigned char* vd = v_s + (size_t)st * TK * VR;
#pragma unroll 2
    for (int i = 0; i < TK * KP / TC_THREADS; ++i) {
      const int c = tid + i * TC_THREADS, r = c / KP, p = c % KP;
      const bool ok = k0 + r < Skv;
      cp_async16(kd + r * KR + p * 16,
                 k_base + (ok ? (size_t)(k0 + r) * kv_stride + p * 8 : 0),
                 ok);
    }
#pragma unroll 2
    for (int i = 0; i < TK * VP / TC_THREADS; ++i) {
      const int c = tid + i * TC_THREADS, r = c / VP, p = c % VP;
      const bool ok = k0 + r < Skv;
      cp_async16(vd + r * VR + p * 16,
                 v_base + (ok ? (size_t)(k0 + r) * v_stride + p * 8 : 0),
                 ok);
    }
    cp_async_commit();
  };
  issue(kt0, 0);

  // this warp's 16 query rows as A fragments, straight from device
  // memory while the first tile is in flight (rows past S zero)
  const int row0 = q0 + warp * 16 + gid, row1 = row0 + 8;
  uint32_t qa[KS][4];
  {
    const size_t q_stride = (size_t)H * HD;
    const __nv_bfloat16* qr0 =
        q + ((size_t)b * S + row0) * q_stride + (size_t)h * HD + 2 * tig;
    const __nv_bfloat16* qr1 = qr0 + 8 * q_stride;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16;
      qa[ks][0] = row0 < S ? *reinterpret_cast<const uint32_t*>(qr0 + c) : 0;
      qa[ks][1] = row1 < S ? *reinterpret_cast<const uint32_t*>(qr1 + c) : 0;
      qa[ks][2] =
          row0 < S ? *reinterpret_cast<const uint32_t*>(qr0 + c + 8) : 0;
      qa[ks][3] =
          row1 < S ? *reinterpret_cast<const uint32_t*>(qr1 + c + 8) : 0;
    }
  }

  // scores in log2 units: exp(s * scale - m) = 2^(s * scale log2(e) - m')
  const float sl2 = scale * 1.4426950408889634f;
  float o[NV][4], m2[2] = {NEG_INF, NEG_INF}, l2[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NV; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;

  for (int kt = kt0; kt < n_k; ++kt) {
    const int st = (kt - kt0) % STAGES;
    if (kt + 1 < n_k) {
      issue(kt + 1, (kt + 1 - kt0) % STAGES);
      cp_async_wait<1>();          // tile kt has landed, kt + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * TK;
    // the tile's work; MASK: the diagonal tile or the ragged last one
    auto tile = [&](auto mask) {
      constexpr bool MASK = decltype(mask)::value;
      const unsigned char* kt_s = k_s + (size_t)st * TK * KR;
      const unsigned char* vt_s = v_s + (size_t)st * TK * VR;

      // S [16 x TK] = Q K^T: per k-step, one ldmatrix.x4 gives the B
      // fragments of two 8-key n-tiles (lane l: key 8 (l / 16) + l % 8 of
      // the pair, values 8 ((l / 8) % 2) of the step)
      float sc[TK / 8][4];
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
      const unsigned char* kr =
          kt_s + (size_t)((lane & 7) + ((lane >> 4) << 3)) * KR +
          ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < TK / 16; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kr + (size_t)np * 16 * KR + ks * 32);
          mma_bf16(sc[2 * np], qa[ks], bk[0], bk[1]);
          mma_bf16(sc[2 * np + 1], qa[ks], bk[2], bk[3]);
        }
      }
      // scale, and mask
      float mx[2] = {m2[0], m2[1]};
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = sc[nt][j] * sl2;
          if constexpr (MASK) {
            const int col = k0 + nt * 8 + 2 * tig + (j & 1);
            const int row = j < 2 ? row0 : row1;
            if (col >= Skv || (causal && col > row))
              s = -CUDART_INF_F;
            else if (window > 0 && row - col >= window)
              s = NEG_INF;     // the reference's -1e30: a row with no key
                               // left gets the mean of every row of v
          }
          sc[nt][j] = s;
          mx[j >> 1] = fmaxf(mx[j >> 1], s);
        }
      // the online softmax of rows gid and gid + 8: each row's TK scores
      // lie on the 4 lanes of a quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = ex2(m2[r] - mx[r]);     // 1 while unchanged
        m2[r] = mx[r];
        l2[r] *= alpha;
#pragma unroll
        for (int nt = 0; nt < NV; ++nt) {
          o[nt][2 * r] *= alpha;
          o[nt][2 * r + 1] *= alpha;
        }
      }
      // O += P_hi V + P_lo V, 16 keys a k-step: the S fragments of n-tiles
      // 2 kk and 2 kk + 1 are P's A fragment; one ldmatrix.x4.trans gives
      // the B fragments of two 8-value n-tiles of V.  Each n-tile pair's
      // products over the tile's TK keys are summed on the tensor cores
      // into a zeroed fragment, which is added into O with f32 adds:
      // the tensor cores' own f32 sums do not round to nearest, and a
      // chain of them through every key tile of a long row (8,192 keys
      // under chatglm3-6b's window) moved the output by more than an f32
      // sum in another order does
      const unsigned char* vr =
          vt_s + (size_t)(lane & 15) * VR + (lane >> 4) * 16;
      uint32_t pa[TK / 16][4], pl[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j] = ex2(sc[2 * kk + half][j] - m2[j >> 1]);  // 0 if masked
            l2[j >> 1] += p[j];
          }
          split_bf16(p[0], p[1], pa[kk][2 * half], pl[kk][2 * half]);
          split_bf16(p[2], p[3], pa[kk][2 * half + 1],
                     pl[kk][2 * half + 1]);
        }
      }
#pragma unroll
      for (int np = 0; np < HDV / 16; ++np) {
        float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vr + (size_t)kk * 16 * VR + np * 32);
          mma_bf16(t[0], pa[kk], bv[0], bv[1]);
          mma_bf16(t[0], pl[kk], bv[0], bv[1]);
          mma_bf16(t[1], pa[kk], bv[2], bv[3]);
          mma_bf16(t[1], pl[kk], bv[2], bv[3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[2 * np][j] += t[0][j];
          o[2 * np + 1][j] += t[1][j];
        }
      }
    };
    // a causal warp skips a tile whose keys all lie after its rows, or,
    // with a window, all before every one of its rows' windows (a causal
    // row always attends itself); the diagonal, the ragged last tile and
    // a window's edge are masked
    const int w0 = q0 + warp * 16, w1 = w0 + 15;
    const bool skip = causal && (k0 > w1 || (window > 0 &&
                                             k0 + TK - 1 <= w0 - window));
    if (k0 + TK > Skv || (causal && k0 + TK - 1 > w0) ||
        (window > 0 && k0 <= w1 - window)) {
      if (!skip) tile(std::true_type());
    } else if (!skip) {
      tile(std::false_type());
    }
    __syncthreads();               // every warp is done with stage st
  }

  // each lane summed l over its own columns: the quad's total
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l2[r] += __shfl_xor_sync(0xffffffffu, l2[r], 1);
    l2[r] += __shfl_xor_sync(0xffffffffu, l2[r], 2);
  }
  const size_t o_stride = (size_t)H * HDV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l2[r], 1e-30f);
    __nv_bfloat16* dst = out + ((size_t)b * S + row) * o_stride +
                         (size_t)h * HDV + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < NV; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
    // the row's log-sum-exp in units of s * scale, for the backward
    if (lse != nullptr && tig == 0)
      lse[((size_t)b * H + h) * S + row] =
          (m2[r] + log2f(l2[r])) * 0.6931471805599453f;
  }
}

// -------------------------------------------------------- f32, CUDA cores

constexpr int THREADS = 256;

// Stage `rows` rows of `HD` floats (row stride `stride`) from global
// memory into shared memory, row pitch `pitch`; rows at or past `valid`
// are zero.  16-byte loads (hd is a multiple of 16 and the wrapper checks
// 16-byte alignment).
template <int HD>
__device__ __forceinline__ void stage(float* dst, int pitch, const float* src,
                                      size_t stride, int rows, int valid) {
  constexpr int PER_ROW = HD / 4;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * 4;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) w = *reinterpret_cast<const float4*>(src + r * stride + c);
    float* o = dst + r * pitch + c;
    o[0] = w.x;
    o[1] = w.y;
    o[2] = w.z;
    o[3] = w.w;
  }
}

// grid (query tiles, H, B); dynamic shared memory: smem_bytes<HD, HDV>().
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int S, int Skv, int H, int KVH, int causal,
    int window, float scale) {
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
  const float* q_base = q + ((size_t)b * S + q0) * q_stride + (size_t)h * HD;
  const float* k_base = k + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const float* v_base = v + (size_t)b * Skv * v_stride + (size_t)kvh * HDV;

  stage<HD>(q_s, QP, q_base, q_stride, BQ, S - q0);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }
  // key tiles up to the last row this query tile attends, and, causal
  // with a window, from the first key its first row's window holds
  const int last = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_k = (last + BK - 1) / BK;
  const int kt0 = causal && window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int kt = kt0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    stage<HD>(k_s, QP, k_base + (size_t)k0 * kv_stride, kv_stride, BK,
              Skv - k0);
    stage<HDV>(v_s, HDV, v_base + (size_t)k0 * v_stride, v_stride, BK,
               Skv - k0);
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
        // padding past Skv never counts; a causal or window mask is the
        // reference's -1e30 (a row with no key left: the mean of v)
        s[i][j] = col >= Skv ? -CUDART_INF_F
                  : (causal && col > row) ||
                          (window > 0 && row - col >= window)
                      ? NEG_INF
                      : s[i][j] * scale;
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
    float* o = out + ((size_t)b * S + q0 + r) * o_stride + (size_t)h * HDV;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[tx + 16 * j] = acc[i][j] * inv;
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * S + q0 + r] = m[i] + logf(l[i]);
  }
}

template <int HD, int HDV>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) +
                          (size_t)BK * HDV + (size_t)BQ * (BK + 1));
}

// ------------------------------------------------------------- launches

template <int HD, int HDV>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int Skv, int H, int KVH, int causal,
           int window, float scale, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((S + TQ - 1) / TQ, H, B);
    constexpr size_t smem = mma_smem_bytes<HD, HDV>();
    static_assert(smem <= 232448, "above Hopper's 227 KB per block");
    auto kernel = flash_attention_mma_kernel<HD, HDV>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), lse, S, Skv, H, KVH, causal,
        window, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  constexpr size_t smem = smem_bytes<HD, HDV>();
  static_assert(smem <= 232448, "above Hopper's 227 KB per block");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<HD, HDV><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Skv,
      H, KVH, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out); q [B,S,H,hd], k
// [B,Skv,KVH,hd], v [B,Skv,KVH,hdv]; causal needs Skv = S; window > 0:
// row i attends keys t with i - t < window (0: no window); (hd, hdv) in
// {(16, 16), (48, 32), (64, 64), (80, 80), (128, 128), (192, 128)}.
// lse: null, or f32 [B,H,S] that receives each row's log-sum-exp of its
// scaled scores (the training forward; the output is the same bits either
// way).  Returns cudaGetLastError() after the launch (0 on success).
// Allocates nothing and does not synchronise.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, void* lse, int B, int S,
                           int Skv, int H, int KVH, int hd, int hdv,
                           int causal, int window, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0 || B <= 0) return 0;
  if (Skv <= 0 || (causal && Skv != S) || window < 0)
    return (int)cudaErrorInvalidValue;
#define FA_LAUNCH(HD, HDV)                                                \
  if (hd == HD && hdv == HDV)                                             \
    return launch<HD, HDV>(dtype, q, k, v, out, static_cast<float*>(lse), \
                           B, S, Skv, H, KVH, causal, window, scale, s);
  FA_LAUNCH(16, 16)
  FA_LAUNCH(48, 32)
  FA_LAUNCH(64, 64)
  FA_LAUNCH(80, 80)
  FA_LAUNCH(128, 128)
  FA_LAUNCH(192, 128)
#undef FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
