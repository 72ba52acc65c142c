// The backward of causal (flash) self-attention, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no Pallas backward (no
// custom_vjp in src/repro/) and trains through jax.grad of its plain mha
// (src/repro/models/layers.py:115).  The port's training forward runs the
// hand-written csrc/flash_attention.cu, which has no gradient of its own,
// so its backward is written here.
//
// What it computes.  q [B,S,H,hd], k [B,S,KVH,hd], v [B,S,KVH,hdv], the
// forward's output o and its gradient dout [B,S,H,hdv], and the forward's
// per-row log-sum-exp lse [B,H,S] (f32, units of s * scale) -> dq, dk, dv
// in the input type.  Query row i attends keys t <= i (causal, no window).
// With s = q.k * scale and P = exp(s - lse): dV = P^T dO, dP = dO V^T,
// D_i = rowsum(dO * O), dS = P * (dP - D), dQ = scale dS K, dK = scale
// dS^T Q; under GQA a kv head's dK and dV sum over the H/KVH query heads
// that read it.  Every sum is f32 and every output rounded once.
//
// Bound on an H100.  At qwen3-30b-a3b's training shape (B=2, S=1024, H=32,
// KVH=4, hd=128) the attended (query, key, head) triples are 33.6 M and the
// minimum work is 10 hd operations a triple (the forward's S = Q K^T
// recomputed, dV, dP, dQ, dK: five products of 2 hd): 43 GFLOP, 43.5 us at
// the bf16 tensor-core rate; the bytes (q, k, v, o, dout and lse read
// once, dq, dk, dv written once) are 75.8 MB, 22.6 us.  Operations bound
// it.
//
// Design.  Deterministic: no float atomics, so a launch gives the same
// bits every time.  Three launches on one stream:
//  1. D = rowsum(dout * o), one warp a (row, head), f32 [B,H,S].
//  2. dK and dV: one block a (64-key tile, kv head, sequence), its four
//     warps 16 keys each.  It walks every (query head of the group, query
//     tile at or after the key tile) in turn -- the group's heads summed
//     inside the block, in a fixed order -- with the query and dout tiles
//     (and their rows' lse and D) through a two-stage cp.async ring; K and
//     V stay in shared memory.  A warp takes a staged tile 32 queries at a
//     time: S^T = K Q^T, P^T, dP^T = V dO^T, dS^T, then dV += P^T dO and
//     dK += dS^T Q, its 16 rows of dK and dV in f32 registers throughout.
//  3. dQ: one block a (64-row query tile, head, sequence), heavy causal
//     tiles first; Q and dout tiles staged once, the key tiles up to the
//     diagonal through the ring; a warp's 16 rows of dQ in registers.
// This recomputes S and P in both passes (14 hd operations a triple where
// 10 would do) to keep every sum inside one block.
// bf16 runs on the tensor cores (mma.sync m16n8k16, f32 sums; the P and dS
// fragments go from the score registers straight into the next product's A
// operand, rounded once to bf16, as FlashAttention-2 does; K, V, Q, dO
// fragments by ldmatrix, transposed where the product sums over rows).
// f32 (the parity type) runs on CUDA cores, 32-row tiles through shared
// memory.  Instances (hd, hdv): (16, 16), (48, 32), (64, 64), (128, 128),
// (192, 128); MLA's v is narrower than its q and k.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ----------------------------------------------------------- bf16, mma

constexpr int TQ = 64;                 // rows of a staged tile
constexpr int QS = 32;                 // columns a warp takes at once
constexpr int STAGES = 2;
constexpr int WARPS = TQ / 16;         // a warp per 16 rows
constexpr int THREADS_MMA = 32 * WARPS;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x (MUFU.EX2)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// Fragment addresses in a staged tile of rows of `pitch` bytes (lane l):
// the A fragment of rows [r0, r0 + 16) at k-step ks (16 values);
__device__ __forceinline__ const unsigned char* a_row(
    const unsigned char* t, int pitch, int r0, int ks, int lane) {
  return t + (size_t)(r0 + (lane & 15)) * pitch + (lane >> 4) * 16 + ks * 32;
}
// the B fragments of two 8-row n-tiles [r0, r0 + 16) at k-step ks, where
// the product sums over the tile's columns (the rows are the n axis);
__device__ __forceinline__ const unsigned char* b_row(
    const unsigned char* t, int pitch, int r0, int ks, int lane) {
  return t + (size_t)(r0 + (lane & 7) + ((lane >> 4) << 3)) * pitch +
         ((lane >> 3) & 1) * 16 + ks * 32;
}
// and, with ldmatrix .trans, the B fragments of two 8-column n-tiles
// (columns [16 np, 16 np + 16)) at the k-step of rows [r0, r0 + 16), where
// the product sums over the tile's rows.
__device__ __forceinline__ const unsigned char* bt_row(
    const unsigned char* t, int pitch, int r0, int np, int lane) {
  return t + (size_t)(r0 + (lane & 15)) * pitch + (lane >> 4) * 16 + np * 32;
}

// bytes of a staged row of n bf16 values, padded by 16 (ldmatrix reads 8
// rows without bank conflicts)
__host__ __device__ constexpr int tile_row(int n) { return 2 * n + 16; }
template <int HD, int HDV>
constexpr size_t mma_smem_bytes() {
  // the fixed tiles, the ring's tiles, the ring's lse and D
  return (size_t)(1 + STAGES) * TQ * (tile_row(HD) + tile_row(HDV)) +
         (size_t)STAGES * 2 * TQ * sizeof(float);
}

// `rows` rows of n bf16 values from global rows (stride `stride` values,
// row 0 at `src`) into a staged tile, zero at and past `valid` rows
template <int N>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int valid,
                                           int tid) {
  constexpr int P = N / 8, R = tile_row(N);    // 16-byte pieces a row
  static_assert(TQ * P % THREADS_MMA == 0, "whole pieces a thread");
#pragma unroll 2
  for (int i = 0; i < TQ * P / THREADS_MMA; ++i) {
    const int c = tid + i * THREADS_MMA, r = c / P, p = c % P;
    const bool ok = r < valid;
    cp_async16(dst + r * R + p * 16, src + (ok ? r * stride + p * 8 : 0), ok);
  }
}

// the C fragments of a 16 x 32 product: [n-tile][4]
using Frag32 = float[QS / 8][4];

// S^T or S: rows of `a` (its 16 rows at ra) times rows of `b` (32 rows
// from rb), summed over N values
template <int N>
__device__ __forceinline__ void rows_dot(Frag32& acc, const unsigned char* a,
                                         int ra, const unsigned char* b,
                                         int rb, int lane) {
  constexpr int R = tile_row(N);
#pragma unroll
  for (int nt = 0; nt < QS / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t fa[4];
    ldmatrix_x4(fa, a_row(a, R, ra, ks, lane));
#pragma unroll
    for (int np = 0; np < QS / 16; ++np) {
      uint32_t fb[4];
      ldmatrix_x4(fb, b_row(b, R, rb + np * 16, ks, lane));
      mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// out[16 x N] += A[16 x 32] (bf16 A fragments of two k-steps) times the 32
// rows from rb of `b` (N values a row)
template <int N>
__device__ __forceinline__ void frag_times_rows(float (&out)[N / 8][4],
                                                const uint32_t (&fa)[2][4],
                                                const unsigned char* b,
                                                int rb, int lane) {
  constexpr int R = tile_row(N);
#pragma unroll
  for (int np = 0; np < N / 16; ++np)
#pragma unroll
    for (int kk = 0; kk < QS / 16; ++kk) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, bt_row(b, R, rb + kk * 16, np, lane));
      mma_bf16(out[2 * np], fa[kk], fb[0], fb[1]);
      mma_bf16(out[2 * np + 1], fa[kk], fb[2], fb[3]);
    }
}

// grid (key tiles, KVH, B), THREADS_MMA threads; dynamic shared memory
// mma_smem_bytes<HD, HDV>(): K, V, then STAGES Q tiles, STAGES dO tiles,
// STAGES lse rows, STAGES D rows
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS_MMA) dkdv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int S, int H, int KVH, float scale) {
  constexpr int KR = tile_row(HD), VR = tile_row(HDV);
  static_assert(HD % 16 == 0 && HDV % 16 == 0, "whole k-steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_s = smem_raw;
  unsigned char* v_s = k_s + TQ * KR;
  unsigned char* q_s = v_s + TQ * VR;                  // [STAGES][TQ][KR]
  unsigned char* o_s = q_s + STAGES * TQ * KR;         // [STAGES][TQ][VR]
  float* l_s = reinterpret_cast<float*>(o_s + STAGES * TQ * VR);
  float* d_s = l_s + STAGES * TQ;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH, k0 = kt * TQ;
  const int nq = (S + TQ - 1) / TQ - kt;       // query tiles kt .. end
  const int n_it = G * nq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t q_stride = (size_t)H * HD, o_stride = (size_t)H * HDV;

  stage_rows<HD>(k_s, k + ((size_t)b * S + k0) * KVH * HD + (size_t)kvh * HD,
                 (size_t)KVH * HD, S - k0, tid);
  stage_rows<HDV>(v_s,
                  v + ((size_t)b * S + k0) * KVH * HDV + (size_t)kvh * HDV,
                  (size_t)KVH * HDV, S - k0, tid);
  // iteration it: query head kvh G + it / nq, query tile kt + it % nq
  auto fetch = [&](int it, int st) {
    const int h = kvh * G + it / nq, q0 = (kt + it % nq) * TQ;
    stage_rows<HD>(q_s + (size_t)st * TQ * KR,
                   q + ((size_t)b * S + q0) * q_stride + (size_t)h * HD,
                   q_stride, S - q0, tid);
    stage_rows<HDV>(o_s + (size_t)st * TQ * VR,
                    dout + ((size_t)b * S + q0) * o_stride + (size_t)h * HDV,
                    o_stride, S - q0, tid);
    const int r = tid & (TQ - 1);
    const bool ok = q0 + r < S;
    const size_t row = ((size_t)b * H + h) * S + (ok ? q0 + r : 0);
    if (tid < TQ)
      cp_async4(l_s + st * TQ + r, lse + row, ok);
    else
      cp_async4(d_s + st * TQ + r, dsum + row, ok);
    cp_async_commit();
  };
  fetch(0, 0);

  float dk_acc[HD / 8][4], dv_acc[HDV / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[nt][j] = 0.f;
#pragma unroll
  for (int nt = 0; nt < HDV / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dv_acc[nt][j] = 0.f;

  const float sl2 = scale * LOG2E;
  const int kw0 = k0 + warp * 16;                // this warp's first key
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    if (it + 1 < n_it) {
      fetch(it + 1, (it + 1) % STAGES);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (kt + it % nq) * TQ;
    const unsigned char* qt_s = q_s + (size_t)st * TQ * KR;
    const unsigned char* ot_s = o_s + (size_t)st * TQ * VR;
    const float* lt = l_s + st * TQ;
    const float* dt = d_s + st * TQ;

    // 32 queries [c0, c0 + 32) of the tile against the warp's 16 keys;
    // MASK: the diagonal or a ragged edge
    auto slice = [&](int c, auto mask) {
      constexpr bool MASK = decltype(mask)::value;
      Frag32 p, dp;
      rows_dot<HD>(p, k_s, warp * 16, qt_s, c * QS, lane);      // S^T
      rows_dot<HDV>(dp, v_s, warp * 16, ot_s, c * QS, lane);    // dP^T
      uint32_t pa[QS / 16][4], da[QS / 16][4];
#pragma unroll
      for (int nt = 0; nt < QS / 8; ++nt) {
        float ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c * QS + nt * 8 + 2 * tig + (j & 1);
          float pv = ex2(p[nt][j] * sl2 - lt[col] * LOG2E);
          if constexpr (MASK) {
            const int key = kw0 + gid + 8 * (j >> 1), qr = q0 + col;
            if (key > qr || qr >= S || key >= S) pv = 0.f;
          }
          p[nt][j] = pv;
          ds[j] = pv * (dp[nt][j] - dt[col]);
        }
        const int kk = nt >> 1, half = nt & 1;
        pa[kk][2 * half] = pack_bf16(p[nt][0], p[nt][1]);
        pa[kk][2 * half + 1] = pack_bf16(p[nt][2], p[nt][3]);
        da[kk][2 * half] = pack_bf16(ds[0], ds[1]);
        da[kk][2 * half + 1] = pack_bf16(ds[2], ds[3]);
      }
      frag_times_rows<HDV>(dv_acc, pa, ot_s, c * QS, lane);    // += P^T dO
      frag_times_rows<HD>(dk_acc, da, qt_s, c * QS, lane);     // += dS^T Q
    };
#pragma unroll
    for (int c = 0; c < TQ / QS; ++c) {
      const int c0 = q0 + c * QS;
      if (kw0 > c0 + QS - 1) continue;    // every key after every query
      if (kw0 + 15 > c0 || c0 + QS > S || kw0 + 16 > S)
        slice(c, std::true_type());
      else
        slice(c, std::false_type());
    }
    __syncthreads();                 // every warp is done with stage st
  }

  // rows gid and gid + 8 of the warp's keys, columns 8 nt + 2 tig, + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + gid + 8 * r;
    if (key >= S) continue;
    const size_t row = ((size_t)b * S + key) * KVH + kvh;
    __nv_bfloat16* kd = dk + row * HD + 2 * tig;
    __nv_bfloat16* vd = dv + row * HDV + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(kd + nt * 8) = pack_bf16(
          dk_acc[nt][2 * r] * scale, dk_acc[nt][2 * r + 1] * scale);
#pragma unroll
    for (int nt = 0; nt < HDV / 8; ++nt)
      *reinterpret_cast<uint32_t*>(vd + nt * 8) =
          pack_bf16(dv_acc[nt][2 * r], dv_acc[nt][2 * r + 1]);
  }
}

// grid (query tiles, H, B), THREADS_MMA threads; dynamic shared memory
// mma_smem_bytes<HD, HDV>(): Q, dO, then STAGES K tiles, STAGES V tiles
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS_MMA) dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int S,
    int H, int KVH, float scale) {
  constexpr int KR = tile_row(HD), VR = tile_row(HDV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw;
  unsigned char* o_s = q_s + TQ * KR;
  unsigned char* k_s = o_s + TQ * VR;                  // [STAGES][TQ][KR]
  unsigned char* v_s = k_s + STAGES * TQ * KR;         // [STAGES][TQ][VR]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH), q0 = qt * TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t q_stride = (size_t)H * HD, o_stride = (size_t)H * HDV;
  const size_t k_stride = (size_t)KVH * HD, v_stride = (size_t)KVH * HDV;

  stage_rows<HD>(q_s, q + ((size_t)b * S + q0) * q_stride + (size_t)h * HD,
                 q_stride, S - q0, tid);
  stage_rows<HDV>(o_s,
                  dout + ((size_t)b * S + q0) * o_stride + (size_t)h * HDV,
                  o_stride, S - q0, tid);
  auto fetch = [&](int kt, int st) {
    const int kr0 = kt * TQ;
    stage_rows<HD>(k_s + (size_t)st * TQ * KR,
                   k + ((size_t)b * S + kr0) * k_stride + (size_t)kvh * HD,
                   k_stride, S - kr0, tid);
    stage_rows<HDV>(v_s + (size_t)st * TQ * VR,
                    v + ((size_t)b * S + kr0) * v_stride + (size_t)kvh * HDV,
                    v_stride, S - kr0, tid);
    cp_async_commit();
  };
  fetch(0, 0);

  // this thread's rows gid and gid + 8 of the warp's 16
  const int w0 = q0 + warp * 16;
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + gid + 8 * r;
    const size_t at = ((size_t)b * H + h) * S + (row < S ? row : 0);
    l2[r] = lse[at] * LOG2E;
    dd[r] = dsum[at];
  }
  float dq_acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq_acc[nt][j] = 0.f;

  const float sl2 = scale * LOG2E;
  const int n_k = qt + 1;                       // key tiles to the diagonal
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % STAGES;
    if (kt + 1 < n_k) {
      fetch(kt + 1, (kt + 1) % STAGES);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kt_s = k_s + (size_t)st * TQ * KR;
    const unsigned char* vt_s = v_s + (size_t)st * TQ * VR;

    // the warp's 16 rows against 32 keys [kt TQ + 32 c, + 32)
    auto slice = [&](int c, auto mask) {
      constexpr bool MASK = decltype(mask)::value;
      Frag32 p, dp;
      rows_dot<HD>(p, q_s, warp * 16, kt_s, c * QS, lane);      // S
      rows_dot<HDV>(dp, o_s, warp * 16, vt_s, c * QS, lane);    // dP
      uint32_t da[QS / 16][4];
#pragma unroll
      for (int nt = 0; nt < QS / 8; ++nt) {
        float ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j >> 1;
          float pv = ex2(p[nt][j] * sl2 - l2[r]);
          if constexpr (MASK) {
            const int key = kt * TQ + c * QS + nt * 8 + 2 * tig + (j & 1);
            const int row = w0 + gid + 8 * r;
            if (key > row || key >= S || row >= S) pv = 0.f;
          }
          ds[j] = pv * (dp[nt][j] - dd[r]);
        }
        const int kk = nt >> 1, half = nt & 1;
        da[kk][2 * half] = pack_bf16(ds[0], ds[1]);
        da[kk][2 * half + 1] = pack_bf16(ds[2], ds[3]);
      }
      frag_times_rows<HD>(dq_acc, da, kt_s, c * QS, lane);     // += dS K
    };
#pragma unroll
    for (int c = 0; c < TQ / QS; ++c) {
      const int c0 = kt * TQ + c * QS;
      if (c0 > w0 + 15) continue;       // every key after every row
      if (c0 + QS - 1 > w0 || c0 + QS > S || w0 + 16 > S)
        slice(c, std::true_type());
      else
        slice(c, std::false_type());
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + gid + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* dst =
        dq + ((size_t)b * S + row) * q_stride + (size_t)h * HD + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) = pack_bf16(
          dq_acc[nt][2 * r] * scale, dq_acc[nt][2 * r + 1] * scale);
  }
}

// -------------------------------------------------------- D = rowsum(dO O)

constexpr int DOT_WARPS = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// grid (ceil(B S H / DOT_WARPS)); warp w takes row r of o's [B,S,H] rows
template <typename T>
__global__ void __launch_bounds__(32 * DOT_WARPS) dot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ dsum, int rows, int S, int H, int hdv) {
  const int r = blockIdx.x * DOT_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* a = o + (size_t)r * hdv;
  const T* g = dout + (size_t)r * hdv;
  float acc = 0.f;
  for (int d = lane; d < hdv; d += 32) acc += to_f32(a[d]) * to_f32(g[d]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const int h = r % H, i = (r / H) % S, b = r / (H * S);
    dsum[((size_t)b * H + h) * S + i] = acc;
  }
}

// -------------------------------------------------------- f32, CUDA cores

constexpr int BT = 32;                 // rows of a staged f32 tile
constexpr int THREADS = 256;           // 8 threads a row of the tile

// `rows` rows of N floats (stride `stride`) into shared rows of pitch N + 1,
// zero at and past `valid`
template <int N>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          size_t stride, int valid) {
  for (int idx = threadIdx.x; idx < BT * N; idx += THREADS) {
    const int r = idx / N, c = idx - r * N;
    dst[r * (N + 1) + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

template <int HD, int HDV>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (2 * (size_t)BT * (HD + 1) + 2 * (size_t)BT * (HDV + 1) +
          2 * (size_t)BT * (BT + 1) + 2 * BT);
}

// grid (key tiles of BT, KVH, B); thread t: key row t / 8, output columns
// t % 8 + 8 j
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS) dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KVH,
    float scale) {
  constexpr int KP = HD + 1, VP = HDV + 1, PP = BT + 1;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BT * KP;
  float* q_s = v_s + BT * VP;
  float* o_s = q_s + BT * KP;
  float* p_s = o_s + BT * VP;          // P^T [key][query]
  float* s_s = p_s + BT * PP;          // dS^T
  float* l_s = s_s + BT * PP;
  float* d_s = l_s + BT;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH, k0 = kt * BT;
  const int tid = threadIdx.x, r = tid >> 3, cg = tid & 7;
  const size_t q_stride = (size_t)H * HD, o_stride = (size_t)H * HDV;
  stage_f32<HD>(k_s, k + ((size_t)b * S + k0) * KVH * HD + (size_t)kvh * HD,
                (size_t)KVH * HD, S - k0);
  stage_f32<HDV>(v_s, v + ((size_t)b * S + k0) * KVH * HDV +
                          (size_t)kvh * HDV,
                 (size_t)KVH * HDV, S - k0);
  float dk_acc[HD / 8], dv_acc[HDV / 8];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) dk_acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < HDV / 8; ++j) dv_acc[j] = 0.f;
  const int key = k0 + r;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = k0; q0 < S; q0 += BT) {
      __syncthreads();               // the previous tile is consumed
      stage_f32<HD>(q_s, q + ((size_t)b * S + q0) * q_stride +
                             (size_t)h * HD,
                    q_stride, S - q0);
      stage_f32<HDV>(o_s, dout + ((size_t)b * S + q0) * o_stride +
                              (size_t)h * HDV,
                     o_stride, S - q0);
      if (tid < BT) {
        const bool ok = q0 + tid < S;
        const size_t at = ((size_t)b * H + h) * S + q0 + tid;
        l_s[tid] = ok ? lse[at] : 0.f;
        d_s[tid] = ok ? dsum[at] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < BT / 8; ++jj) {
        const int c = cg + 8 * jj, qr = q0 + c;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < HD; ++d) s = fmaf(k_s[r * KP + d], q_s[c * KP + d], s);
        for (int d = 0; d < HDV; ++d)
          dp = fmaf(v_s[r * VP + d], o_s[c * VP + d], dp);
        const float p = (key > qr || qr >= S || key >= S)
                            ? 0.f
                            : expf(s * scale - l_s[c]);
        p_s[r * PP + c] = p;
        s_s[r * PP + c] = p * (dp - d_s[c]);
      }
      __syncthreads();
      for (int c = 0; c < BT; ++c) {
        const float p = p_s[r * PP + c], ds = s_s[r * PP + c];
#pragma unroll
        for (int j = 0; j < HDV / 8; ++j)
          dv_acc[j] = fmaf(p, o_s[c * VP + cg + 8 * j], dv_acc[j]);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          dk_acc[j] = fmaf(ds, q_s[c * KP + cg + 8 * j], dk_acc[j]);
      }
    }
  }
  if (key < S) {
    const size_t row = ((size_t)b * S + key) * KVH + kvh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) dk[row * HD + cg + 8 * j] = dk_acc[j] * scale;
#pragma unroll
    for (int j = 0; j < HDV / 8; ++j) dv[row * HDV + cg + 8 * j] = dv_acc[j];
  }
}

// grid (query tiles of BT, H, B); thread t: query row t / 8, output
// columns t % 8 + 8 j
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS) dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dq, int S, int H, int KVH, float scale) {
  constexpr int KP = HD + 1, VP = HDV + 1, PP = BT + 1;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* o_s = q_s + BT * KP;
  float* k_s = o_s + BT * VP;
  float* v_s = k_s + BT * KP;
  float* s_s = v_s + BT * VP;          // dS [query][key]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH), q0 = qt * BT;
  const int tid = threadIdx.x, r = tid >> 3, cg = tid & 7;
  const size_t q_stride = (size_t)H * HD, o_stride = (size_t)H * HDV;
  const size_t k_stride = (size_t)KVH * HD, v_stride = (size_t)KVH * HDV;
  stage_f32<HD>(q_s, q + ((size_t)b * S + q0) * q_stride + (size_t)h * HD,
                q_stride, S - q0);
  stage_f32<HDV>(o_s, dout + ((size_t)b * S + q0) * o_stride +
                          (size_t)h * HDV,
                 o_stride, S - q0);
  const int row = q0 + r;
  const size_t at = ((size_t)b * H + h) * S + (row < S ? row : 0);
  const float l = lse[at], dd = dsum[at];
  float dq_acc[HD / 8];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) dq_acc[j] = 0.f;
  for (int k0 = 0; k0 <= q0; k0 += BT) {
    __syncthreads();
    stage_f32<HD>(k_s, k + ((size_t)b * S + k0) * k_stride + (size_t)kvh * HD,
                  k_stride, S - k0);
    stage_f32<HDV>(v_s, v + ((size_t)b * S + k0) * v_stride +
                            (size_t)kvh * HDV,
                   v_stride, S - k0);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < BT / 8; ++jj) {
      const int c = cg + 8 * jj, key = k0 + c;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < HD; ++d) s = fmaf(q_s[r * KP + d], k_s[c * KP + d], s);
      for (int d = 0; d < HDV; ++d)
        dp = fmaf(o_s[r * VP + d], v_s[c * VP + d], dp);
      const float p =
          (key > row || key >= S || row >= S) ? 0.f : expf(s * scale - l);
      s_s[r * PP + c] = p * (dp - dd);
    }
    __syncthreads();
    for (int c = 0; c < BT; ++c) {
      const float ds = s_s[r * PP + c];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        dq_acc[j] = fmaf(ds, k_s[c * KP + cg + 8 * j], dq_acc[j]);
    }
  }
  if (row < S) {
    float* dst = dq + ((size_t)b * S + row) * q_stride + (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) dst[cg + 8 * j] = dq_acc[j] * scale;
  }
}

// ------------------------------------------------------------- launches

template <typename K>
int with_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int HD, int HDV>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, float* dsum,
           void* dq, void* dk, void* dv, int B, int S, int H, int KVH,
           float scale, cudaStream_t stream) {
  const int rows = B * S * H;
  const dim3 dot_grid((rows + DOT_WARPS - 1) / DOT_WARPS);
  int err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    dot_kernel<T><<<dot_grid, 32 * DOT_WARPS, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), dsum, rows, S,
        H, HDV);
    if ((err = (int)cudaGetLastError())) return err;
    constexpr size_t smem = mma_smem_bytes<HD, HDV>();
    static_assert(smem <= 232448, "above Hopper's 227 KB per block");
    const int n_t = (S + TQ - 1) / TQ;
    if ((err = with_smem(dkdv_mma_kernel<HD, HDV>, smem))) return err;
    dkdv_mma_kernel<HD, HDV><<<dim3(n_t, KVH, B), THREADS_MMA, smem,
                               stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
        static_cast<T*>(dk), static_cast<T*>(dv), S, H, KVH, scale);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = with_smem(dq_mma_kernel<HD, HDV>, smem))) return err;
    dq_mma_kernel<HD, HDV><<<dim3(n_t, H, B), THREADS_MMA, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
        static_cast<T*>(dq), S, H, KVH, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  dot_kernel<float><<<dot_grid, 32 * DOT_WARPS, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), dsum,
      rows, S, H, HDV);
  if ((err = (int)cudaGetLastError())) return err;
  constexpr size_t smem = f32_smem_bytes<HD, HDV>();
  static_assert(smem <= 232448, "above Hopper's 227 KB per block");
  const int n_t = (S + BT - 1) / BT;
  if ((err = with_smem(dkdv_f32_kernel<HD, HDV>, smem))) return err;
  dkdv_f32_kernel<HD, HDV><<<dim3(n_t, KVH, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      dsum, static_cast<float*>(dk), static_cast<float*>(dv), S, H, KVH,
      scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = with_smem(dq_f32_kernel<HD, HDV>, smem))) return err;
  dq_f32_kernel<HD, HDV><<<dim3(n_t, H, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      dsum, static_cast<float*>(dq), S, H, KVH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv); q and dq
// [B,S,H,hd], k and dk [B,S,KVH,hd], v and dv [B,S,KVH,hdv], o and dout
// [B,S,H,hdv]; lse f32 [B,H,S] from the forward; dsum f32 [B,H,S]
// scratch (D).  Causal self-attention, no window; (hd, hdv) in {(16, 16),
// (48, 32), (64, 64), (128, 128), (192, 128)}.  Three launches on
// `stream`; returns the first CUDA error (0 on success).  Allocates
// nothing and does not synchronise.
int flash_attention_bwd_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* o,
                               const void* dout, const void* lse,
                               void* dsum, void* dq, void* dk, void* dv,
                               int B, int S, int H, int KVH, int hd, int hdv,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0 || B <= 0) return 0;
  if (H <= 0 || KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
#define FB_LAUNCH(HD, HDV)                                                  \
  if (hd == HD && hdv == HDV)                                               \
    return launch<HD, HDV>(dtype, q, k, v, o, dout,                         \
                           static_cast<const float*>(lse),                  \
                           static_cast<float*>(dsum), dq, dk, dv, B, S, H,  \
                           KVH, scale, s);
  FB_LAUNCH(16, 16)
  FB_LAUNCH(48, 32)
  FB_LAUNCH(64, 64)
  FB_LAUNCH(128, 128)
  FB_LAUNCH(192, 128)
#undef FB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
