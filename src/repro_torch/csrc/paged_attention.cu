// Mixed (chunked-prefill) attention over the paged KV block pool, for
// Hopper (sm_90a), over pools of q's type or int8 pools with scales.
//
// Replaces two Pallas TPU kernels of the reference package:
//   * mixed_block_paged_attention         (src/repro/kernels/paged_attention.py:322)
//   * quant_mixed_block_paged_attention   (src/repro/kernels/paged_attention.py:430)
// The decodes run the split-context kernel of paged_decode.cu:
// block_paged_decode_attention (paged_attention.py:123), the
// slot-contiguous paged_decode_attention (:75) and the int8
// quant_block_paged_decode_attention (:217); at q_len == 1 this kernel
// computes the same function with sums in another order.
//
// What it computes.  q [B,Sq,H,hd]; k/v pools [NB,bs,KVH,hd]; block tables
// [B,MB] int32; ctx_lens [B]; q_lens [B].  Query row i of sequence b sits
// at position q_abs = ctx - q_len + i and attends to positions pos < ctx &&
// pos <= q_abs of its context (at most the MB * bs positions its table
// holds), gathered through its table; padding rows i >= q_len attend the
// whole context.  Online softmax in f32 (running max m, sum l, accumulator
// acc), scale 1/sqrt(hd), masked scores -1e30, output acc / max(l, 1e-30)
// rounded once to q's type -- the Pallas kernel's arithmetic.  int8 pools
// (_quant_mixed_kernel of the reference): each token row of k and v has
// one f32 scale, in [NB,bs] scale pools read through the same table entry
// as the rows.  The dequantization commutes out of both products, as in
// the Pallas kernel: the score is (dot(q, k_i8) * sk[t]) * scale; l adds
// p, and acc adds (p * sv[t]) * v_i8, so sv never enters l.
//
// Bound on an H100.  At qwen3-30b-a3b's chunk (a 128-row chunk with 104
// valid rows over a 1,000-token context, H = 32, KVH = 4, hd = 128) the
// work is 4 * hd operations per attended (query row, position, head):
// 2.01 GFLOP, 2.03 us at the bf16 tensor-core rate, against 2.05 MB of
// K/V read once (0.6 us; int8 rows and scales half that).  The tensor
// cores bound it.
//
// Design, bf16 q (every served path; bf16 or int8 pools): the tensor
// cores.  The rows of a (sequence, kv head) are the (position, head) pairs
// r = i * G + g of its G = H / KVH query heads, so the G heads share every
// K/V tile a block loads.  A block of 4 warps owns a tile of TQ = 64 rows
// (each warp 16, with their q fragments in registers, loaded once from
// device memory, and their output rows in f32 registers for the whole
// loop) and one span of SPAN = 256 context tokens; grid (row tiles, B *
// KVH, spans).  The block reads the span's table entries once (clamped to
// NB - 1) into its pool rows; the span's K/V come in as 64-key tiles
// through a two-stage 16-byte cp.async ring (rows past the span's last
// attended position zero-filled; rows padded by 16 bytes), the next
// tile's copies in flight while this one is used, one barrier a tile.
// S = Q K^T and O += P V by m16n8k16 products with f32 sums, as in
// flash_attention.cu: K's fragments by ldmatrix, V's by ldmatrix.trans,
// scores in log2 units, exponentials by ex2.approx, the row max and sum by
// shuffles within a quad; P split in two bf16 parts, P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), so that the bf16 output is the f32 answer rounded
// once (one bf16 rounding of P moves a peaked output by up to 2^-9 of the
// rows it weighs).  The mask (pos < ctx, pos <= q_abs) runs only on the
// tiles that need it, a second instance of the tile body: at the chunk
// above the first 896 positions are visible to every row, 14 of 16 tiles.
// A warp skips a tile past all of its rows' positions, and a block the
// tiles past its rows' last one: skipping changes no bit.  Head widths 64
// and 128 have instances of their own; any other multiple of 16 up to 128
// runs one that guards each k-step at run time (slower: the guards split
// the products into blocks the compiler schedules one by one).
//
// int8 pools: the 4 warps share each K/V tile, so the block converts the
// tile to bf16 once, exactly (|x| <= 127 fits bf16's significand), into a
// bf16 tile in shared memory after it lands (one more barrier), and the
// warps run the bf16 products on it; the k scales weigh the score columns
// and the v scales P before the split, copied beside their rows from the
// same table entries, and l sums the unscaled P.  Converting the fragments
// in registers as each warp reads them (paged_decode.cu's design: K by one
// 4-byte load a k-step with q's k order permuted, V by ldmatrix.trans on
// byte pairs) did the conversion four times a tile: 0.0397 against 0.0318
// ms at the chunk above.
//
// Spans fill the card: a row tile over the whole context gives 64 blocks at
// the chunk above, under half of the 132 SMs, each a serial walk over 16
// tiles: 0.0508 ms bf16 against 0.0312 with spans of 256 (spans of 128
// 0.0374, of 512 0.0361; tiles of 32 rows 0.0439; the same run). A row tile
// whose rows attend more than one span stores each span's (m, l, acc) in a
// workspace and counts the span done on a per-(row tile, kv head, sequence)
// counter with a gpu-scope acquire-release add; the last block resets the
// counter to zero for the next launch and merges the spans in order 0, 1,
// ... with each span's loads in flight together (the scheme of
// paged_decode.cu): one launch, no memset, the same bits on every run.
// A row tile inside one span writes its output directly.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's kernels phase): 0.0309
// ms bf16 and 0.0319 ms int8 at the chunk above, against SDPA's 0.066 and
// the 2.03 us bound; 195 registers in the bf16 hd-128 instance, 251 in the
// int8 one, no spills.  What is left: the per-tile chain of dependent
// steps that sets flash_attention.cu's time, with two blocks an SM.
//
// Design, f32 q (the parity type; no served path runs it): CUDA cores, the
// kernel of the first port.  One block of 128 threads per (row tile of at
// most 16 rows, kv head, sequence) stages one pool block at a time in f32
// shared memory (int8 rows without their scale, 8 values a load) and runs
// scores, the softmax update and acc += p v as plain FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;

// ----------------------------------------------------- bf16 q, tensor cores

constexpr int TQ = 64;                       // query rows a block
constexpr int TK = 64;                       // keys a tile
constexpr int SPAN = 256;                    // context tokens a block
constexpr int STAGES = 2;                    // K/V tiles in flight
constexpr int MMA_WARPS = TQ / 16;           // a warp per 16 query rows
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MAX_HD = 128;
constexpr int MAX_DEVICES = 64;         // devices a process may launch on
static_assert(TQ % 16 == 0 && TQ >= 16 && TQ <= 128, "whole warps");
static_assert(SPAN % TK == 0 && SPAN > 0, "whole tiles a span");

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
// four int8 values of a word as f32, exactly: each byte, offset to
// unsigned, goes into the mantissa of 2^23 (one byte_perm), and 2^23 + 128
// comes off
__device__ __forceinline__ void i8x4_f32(uint32_t w, float (&x)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
           8388736.f;
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

// four 8x8 b16 tiles of shared memory: lane l gives the row address of
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

// bytes of a staged K or V row: hd values and 16 bytes of padding, so the
// rows a warp reads at one offset hit distinct banks
template <typename KV>
__host__ __device__ __forceinline__ int row_bytes(int hd) {
  return hd * (int)sizeof(KV) + 16;
}

// grid (row tiles, B * KVH, spans), MMA_THREADS threads; dynamic shared
// memory: mma_smem_bytes().  KV: the pools' storage type, bf16, or int8_t
// with f32 scale pools k_scale / v_scale [NB, bs] (null otherwise).
// ws_acc [B * KVH * row tiles, spans, TQ, hd] and ws_ml [..., TQ, 2] (f32)
// hold the spans of a row tile that attends more than one; done [B * KVH
// * row tiles] int32 is zero at the start, and the merging blocks leave it
// zero at the end.
template <typename KV, int HD>
__global__ void __launch_bounds__(MMA_THREADS) mixed_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k_pool,
    const float* __restrict__ k_scale, const KV* __restrict__ v_pool,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ ctx_lens, const int32_t* __restrict__ q_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int* __restrict__ done, int Sq, int H,
    int KVH, int KVHP, int KOFF, int hd_arg, int NB, int bs, int MB,
    float scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  // HD: the head width, or 0 for any multiple of 16 up to MAX_HD (the
  // loops then guard each k-step and n-tile at run time)
  static_assert(HD % 16 == 0 && HD <= MAX_HD, "whole k-steps");
  constexpr int HDM = HD ? HD : MAX_HD;     // loop bound
  const int hd = HD ? HD : hd_arg;
  constexpr int VEC = 16 / sizeof(KV);       // values a 16-byte piece
  constexpr int LPR = MAX_HD / VEC;          // threads copying a row
  static_assert(MMA_THREADS % LPR == 0 && TK * LPR % MMA_THREADS == 0,
                "whole rows a pass");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sk_s[QUANT ? STAGES : 1][TK], sv_s[QUANT ? STAGES : 1][TK];
  __shared__ float M_s[TQ], L_s[TQ];
  __shared__ int rows_s[SPAN];     // the span's pool rows (-1 past t1)
  __shared__ int last_s;

  const int G = H / KVH;
  const int rows = Sq * G;
  const int tile = blockIdx.x, sp = blockIdx.z;
  const int b = blockIdx.y / KVH, kvh = blockIdx.y - b * KVH;
  const int row0 = tile * TQ;
  const int nrows = min(TQ, rows - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rb = row_bytes<KV>(hd);
  const int ks_n = hd / 16;
  // k-step ks (16 values) and value n-tile nt (8) lie within hd
  auto ks_on = [&](int ks) { return HD || ks < ks_n; };
  unsigned char* k_s = smem_raw;                       // [STAGES][TK][rb]
  unsigned char* v_s = smem_raw + STAGES * TK * rb;    // [STAGES][TK][rb]
  // int8: the tile's rows as bf16 [TK][rbb], K then V
  const int rbb = row_bytes<__nv_bfloat16>(hd);
  unsigned char* kb_s = smem_raw + 2 * STAGES * TK * rb;
  unsigned char* vb_s = kb_s + TK * rbb;

  const int ctx = ctx_lens[b], q_len = q_lens[b];
  const int qbase = ctx - q_len;          // position of chunk row i = 0
  const int ctx_eff = min(ctx, MB * bs);  // the table's positions only
  // q_abs grows with the row: the tile's last row bounds what any of its
  // rows attends
  const int limit = min(ctx_eff, qbase + (row0 + nrows - 1) / G + 1);
  const int n_split = max(1, (limit + SPAN - 1) / SPAN);
  if (sp >= n_split) return;
  const int t0 = sp * SPAN, t1 = min(limit, t0 + SPAN);
  const int n_tiles = t1 > t0 ? (t1 - t0 + TK - 1) / TK : 0;

  // this warp's 16 rows: lane rows rl[0] (gid) and rl[1], tile-local;
  // their q as A fragments straight from device memory, in flight while
  // the table is read (rows past the chunk's zero)
  const int wr0 = warp * 16;
  const int rl[2] = {wr0 + gid, wr0 + gid + 8};
  int qabs[2];
  uint32_t qa[HDM / 16][4];
  {
    const __nv_bfloat16* qr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + rl[h];
      const int i = r / G, g = r - (r / G) * G;
      qabs[h] = qbase + i;
      qr[h] = r < rows ? q + (((size_t)b * Sq + i) * H + kvh * G + g) * hd
                       : nullptr;
    }
#pragma unroll
    for (int ks = 0; ks < HDM / 16; ++ks) {
      if (!ks_on(ks)) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat16* p = qr[h] + ks * 16 + 2 * tig;
        qa[ks][h] = qr[h] ? *reinterpret_cast<const uint32_t*>(p) : 0;
        qa[ks][h + 2] = qr[h] ? *reinterpret_cast<const uint32_t*>(p + 8) : 0;
      }
    }
  }
  // the span's pool rows: position t0 + j is row tables[b, p / bs] * bs
  // + p % bs (the entry clamped to NB - 1), -1 at or past t1
  for (int j = tid; j < SPAN; j += MMA_THREADS) {
    const int pos = t0 + j;
    int row = -1;
    if (pos < t1) {
      const int e = min(max(tables[(size_t)b * MB + pos / bs], 0), NB - 1);
      row = e * bs + pos % bs;
    }
    rows_s[j] = row;
  }
  __syncthreads();

  // tile kt of the span into stage st: each thread copies piece tid % LPR
  // of every row it takes; rows past t1 zero-filled (int8: their scales
  // too)
  auto issue = [&](int kt, int st) {
    unsigned char* kd = k_s + (size_t)st * TK * rb;
    unsigned char* vd = v_s + (size_t)st * TK * rb;
    const int* rows_t = rows_s + kt * TK;
    const int piece = tid % LPR;
    if (piece * VEC < hd) {
#pragma unroll
      for (int i = 0; i < TK * LPR / MMA_THREADS; ++i) {
        const int t = tid / LPR + i * (MMA_THREADS / LPR);
        const int row = rows_t[t];
        const size_t off =
            row < 0 ? 0
                    : ((size_t)row * KVHP + KOFF + kvh) * hd + piece * VEC;
        cp_async16(kd + t * rb + piece * 16, k_pool + off, row >= 0);
        cp_async16(vd + t * rb + piece * 16, v_pool + off, row >= 0);
      }
    }
    if constexpr (QUANT) {
      for (int j = tid; j < 2 * TK; j += MMA_THREADS) {
        const int t = j % TK, row = rows_t[t];
        const size_t at = row < 0 ? 0 : (size_t)row;
        if (j < TK) cp_async4(&sk_s[st][t], k_scale + at, row >= 0);
        else cp_async4(&sv_s[st][t], v_scale + at, row >= 0);
      }
    }
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0, 0);

  // the positions this warp's rows attend: q_abs of its first row and of
  // its last valid one
  const int w_last = min(row0 + wr0 + 15, rows - 1);
  const bool w_live = row0 + wr0 < rows;
  const int qmin_w = qbase + (row0 + wr0) / G;
  const int qmax_w = qbase + w_last / G;

  // scores in log2 units: exp(s * scale - m) = 2^(s * scale log2(e) - m')
  const float sl2 = scale * 1.4426950408889634f;
  float o[HDM / 8][4], m2[2] = {NEG_INF, NEG_INF}, l2[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < HDM / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % STAGES;
    if (kt + 1 < n_tiles) {
      issue(kt + 1, (kt + 1) % STAGES);
      cp_async_wait<1>();          // tile kt has landed, kt + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QUANT) {
      // the tile's int8 rows as bf16, exactly (|x| <= 127 fits bf16's
      // significand), once for all the warps: 16 values a thread and step
      const int pieces = hd / 16;
      for (int j = tid; j < 2 * TK * pieces; j += MMA_THREADS) {
        const int v = j >= TK * pieces;                  // 0: K, 1: V
        const int t = (j - v * TK * pieces) / pieces;
        const int c = j - v * TK * pieces - t * pieces;
        const uint4 w = *reinterpret_cast<const uint4*>(
            (v ? v_s : k_s) + ((size_t)st * TK + t) * rb + c * 16);
        const uint32_t u[4] = {w.x, w.y, w.z, w.w};
        uint32_t pk[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x[4];
          i8x4_f32(u[i], x);
          pk[2 * i] = pack_bf16(x[0], x[1]);
          pk[2 * i + 1] = pack_bf16(x[2], x[3]);
        }
        uint4* dst = reinterpret_cast<uint4*>((v ? vb_s : kb_s) +
                                              (size_t)t * rbb + c * 32);
        dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
        dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
      }
      __syncthreads();
    }
    const int k0 = t0 + kt * TK;
    // the tile's work; MASK: a tile with positions at or past ctx or past
    // some row's q_abs
    auto body = [&](auto mask) {
      constexpr bool MASK = decltype(mask)::value;
      const unsigned char* kt_s = QUANT ? kb_s : k_s + (size_t)st * TK * rb;
      const unsigned char* vt_s = QUANT ? vb_s : v_s + (size_t)st * TK * rb;

      // S [16 x TK] = Q K^T
      float sc[TK / 8][4];
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
      // per k-step, one ldmatrix.x4 gives the B fragments of two 8-key
      // n-tiles (lane l: key 8 (l / 16) + l % 8 of the pair, values 8
      // ((l / 8) % 2) of the step)
      const unsigned char* kr =
          kt_s + (size_t)((lane & 7) + ((lane >> 4) << 3)) * rbb +
          ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int ks = 0; ks < HDM / 16; ++ks) {
        if (ks_on(ks)) {
#pragma unroll
          for (int np = 0; np < TK / 16; ++np) {
            uint32_t bk[4];
            ldmatrix_x4(bk, kr + (size_t)np * 16 * rbb + ks * 32);
            mma_bf16(sc[2 * np], qa[ks], bk[0], bk[1]);
            mma_bf16(sc[2 * np + 1], qa[ks], bk[2], bk[3]);
          }
        }
      }
      // scale (int8: (dot . sk) . scale, the reference's order), mask
      float mx[2] = {m2[0], m2[1]};
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = nt * 8 + 2 * tig + (j & 1);
          float s = sc[nt][j];
          if constexpr (QUANT) s *= sk_s[st][t];
          s *= sl2;
          if constexpr (MASK) {
            const int pos = k0 + t;
            if (pos >= ctx_eff || pos > qabs[j >> 1]) s = -CUDART_INF_F;
          }
          sc[nt][j] = s;
          mx[j >> 1] = fmaxf(mx[j >> 1], s);
        }
      // the online softmax of rows gid and gid + 8: each row's TK scores
      // lie on the 4 lanes of a quad
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float alpha = ex2(m2[h] - mx[h]);     // 1 while unchanged
        m2[h] = mx[h];
        l2[h] *= alpha;
#pragma unroll
        for (int nt = 0; nt < HDM / 8; ++nt) {
          o[nt][2 * h] *= alpha;
          o[nt][2 * h + 1] *= alpha;
        }
      }
      // O += P_hi V + P_lo V, 16 keys a k-step: the S fragments of
      // n-tiles 2 kk and 2 kk + 1 are P's A fragment (int8: P times sv,
      // while l sums P)
      const unsigned char* vr =
          vt_s + (size_t)(lane & 15) * rbb + (lane >> 4) * 16;
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t pa[4], pl[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j] = ex2(sc[2 * kk + half][j] - m2[j >> 1]);  // 0 if masked
            l2[j >> 1] += p[j];
            if constexpr (QUANT)
              p[j] *= sv_s[st][kk * 16 + half * 8 + 2 * tig + (j & 1)];
          }
          split_bf16(p[0], p[1], pa[2 * half], pl[2 * half]);
          split_bf16(p[2], p[3], pa[2 * half + 1], pl[2 * half + 1]);
        }
        const unsigned char* vk = vr + (size_t)kk * 16 * rbb;
        // one ldmatrix.x4.trans gives the B fragments of two 8-value
        // n-tiles
#pragma unroll
        for (int np = 0; np < HDM / 16; ++np) {
          if (ks_on(np)) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, vk + np * 32);
            mma_bf16(o[2 * np], pa, bv[0], bv[1]);
            mma_bf16(o[2 * np], pl, bv[0], bv[1]);
            mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
            mma_bf16(o[2 * np + 1], pl, bv[2], bv[3]);
          }
        }
      }
    };
    // a warp skips a tile past all of its rows' positions
    if (w_live && k0 <= qmax_w) {
      if (k0 + TK > ctx_eff || k0 + TK - 1 > qmin_w) body(std::true_type());
      else body(std::false_type());
    }
    __syncthreads();               // every warp is done with stage st
  }

  // each lane summed l over its own columns: the quad's total
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l2[h] += __shfl_xor_sync(0xffffffffu, l2[h], 1);
    l2[h] += __shfl_xor_sync(0xffffffffu, l2[h], 2);
  }
  // the lane's output values of row h in adjacent pairs: n-tile nt holds
  // values nt * 8 + 2 tig and + 1
  auto pairs = [&](int h, auto&& fn) {
#pragma unroll
    for (int nt = 0; nt < HDM / 8; ++nt)
      if (ks_on(nt / 2)) fn(nt * 8 + 2 * tig, o[nt][2 * h], o[nt][2 * h + 1]);
  };
  auto out_row = [&](int r) {   // r < rows
    const int i = r / G, g = r - (r / G) * G;
    return out + (((size_t)b * Sq + i) * H + kvh * G + g) * hd;
  };

  if (n_split == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + rl[h];
      if (r >= rows) continue;
      const float inv = 1.f / fmaxf(l2[h], 1e-30f);
      __nv_bfloat16* dst = out_row(r);
      pairs(h, [&](int c, float a, float bb) {
        *reinterpret_cast<uint32_t*>(dst + c) = pack_bf16(a * inv, bb * inv);
      });
    }
    return;
  }

  // several spans: store this one, and let the last block merge them all
  const size_t key = (size_t)blockIdx.y * gridDim.x + tile;
  const size_t slot0 = key * gridDim.z;
  {
    float* acc = ws_acc + (slot0 + sp) * TQ * hd;
    float2* ml = reinterpret_cast<float2*>(ws_ml) + (slot0 + sp) * TQ;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = acc + (size_t)rl[h] * hd;
      pairs(h, [&](int c, float a, float bb) {
        *reinterpret_cast<float2*>(dst + c) = make_float2(a, bb);
      });
      if (tig == 0) ml[rl[h]] = make_float2(m2[h], l2[h]);
    }
  }
  __syncthreads();
  if (tid == 0) {
    last_s = atomic_add_acq_rel(done + key, 1) == n_split - 1;
    if (last_s) done[key] = 0;    // every span has counted: ready for reuse
  }
  __syncthreads();
  if (!last_s) return;
  // the last block: each row's M (log2 units) and L over the spans, each
  // span's weight 2^(m_s - M), and the weighted sum in span order, every
  // value a thread sums of one span in flight together
  const float2* ml = reinterpret_cast<const float2*>(ws_ml) + slot0 * TQ;
  const float* acc0 = ws_acc + slot0 * TQ * hd;
  float* w_s = reinterpret_cast<float*>(smem_raw);      // [n_split][TQ]
  float* l_s = w_s + n_split * TQ;                       // [n_split][TQ]
  for (int j = tid; j < n_split * TQ; j += MMA_THREADS) {
    const float2 x = __ldcg(ml + j);
    w_s[j] = x.x;
    l_s[j] = x.y;
  }
  __syncthreads();
  for (int r = tid; r < TQ; r += MMA_THREADS) {
    float M = NEG_INF, L = 0.f;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, w_s[s * TQ + r]);
    for (int s = 0; s < n_split; ++s)
      L += l_s[s * TQ + r] * ex2(w_s[s * TQ + r] - M);
    M_s[r] = M;
    L_s[r] = L;
  }
  __syncthreads();
  for (int j = tid; j < n_split * TQ; j += MMA_THREADS)
    w_s[j] = ex2(w_s[j] - M_s[j % TQ]);
  __syncthreads();
  const int per = TQ * hd;                                // floats a span
  constexpr int E = TQ * HDM / 4 / MMA_THREADS;           // float4s a thread
  float4 a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    const float4* src = reinterpret_cast<const float4*>(acc0 + (size_t)s * per);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = tid + e * MMA_THREADS;
      if (HD || i < per / 4) {
        const float4 x = __ldcg(src + i);
        const float w = w_s[s * TQ + 4 * i / hd];
        a[e].x = fmaf(x.x, w, a[e].x);
        a[e].y = fmaf(x.y, w, a[e].y);
        a[e].z = fmaf(x.z, w, a[e].z);
        a[e].w = fmaf(x.w, w, a[e].w);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tid + e * MMA_THREADS;
    const int r = 4 * i / hd;
    if ((!HD && i >= per / 4) || row0 + r >= rows) continue;
    const float inv = 1.f / fmaxf(L_s[r], 1e-30f);
    *reinterpret_cast<uint2*>(out_row(row0 + r) + (4 * i - r * hd)) =
        make_uint2(pack_bf16(a[e].x * inv, a[e].y * inv),
                   pack_bf16(a[e].z * inv, a[e].w * inv));
  }
}

// the K/V ring (int8: and the tile as bf16); the last block's merge
// weights and sums reuse its bytes
template <typename KV>
size_t mma_smem_bytes(int hd, int splits) {
  const size_t bf16_tile = std::is_same<KV, int8_t>::value
                               ? (size_t)2 * TK * row_bytes<__nv_bfloat16>(hd)
                               : 0;
  return std::max((size_t)2 * STAGES * TK * row_bytes<KV>(hd) + bf16_tile,
                  (size_t)2 * splits * TQ * sizeof(float));
}

// --------------------------------------------------------- f32 q, CUDA cores

constexpr int THREADS = 128;
constexpr int ROWS_MAX = 16;

// One int8 value of a 4-byte word, sign-extended, as f32.
__device__ __forceinline__ float i8_at(int w, int j) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * j)));
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// grid (row tiles, KVH, B); dynamic shared memory: see smem_bytes().  KV is
// the pools' storage type: float, or int8_t with f32 scale pools k_scale /
// v_scale [NB, bs] (unused, and null, otherwise); block pools
// [NB, bs, KVHP, hd] read through the tables, the block's kv head head KOFF
// + kvh of a row.
template <typename KV>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const float* __restrict__ q, const KV* __restrict__ k_pool,
    const float* __restrict__ k_scale, const KV* __restrict__ v_pool,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ ctx_lens, const int32_t* __restrict__ q_lens,
    float* __restrict__ out, int Sq, int H, int KVH, int KVHP, int KOFF,
    int hd, int NB, int bs, int MB, int R, float scale) {
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
      v = q[(((size_t)b * Sq + i) * H + kvh * G + g) * hd + d];
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
  const int limit = min(min(ctx, MB * bs), last_qabs + 1);
  const int nblk = limit > 0 ? (limit + bs - 1) / bs : 0;
  __syncthreads();

  for (int ki = 0; ki < nblk; ++ki) {
    const int phys = min(max(tables[(size_t)b * MB + ki], 0), NB - 1);
    if constexpr (QUANT) {
      const int hd8 = hd >> 3;
      for (int idx = tid; idx < bs * hd8; idx += THREADS) {
        const int t = idx / hd8, d = (idx - t * hd8) << 3;
        const size_t off =
            (((size_t)phys * bs + t) * KVHP + KOFF + kvh) * hd + d;
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
        const size_t off =
            (((size_t)phys * bs + t) * KVHP + KOFF + kvh) * hd + d;
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
    out[(((size_t)b * Sq + i) * H + kvh * G + g) * hd + d] =
        acc[idx] / fmaxf(l_s[r], 1e-30f);
  }
}

size_t smem_bytes(int R, int hd, int bs, bool quant) {
  return sizeof(float) * ((size_t)2 * R * hd + (size_t)bs * (hd + 1) +
                          (size_t)bs * hd + (size_t)R * bs + 3 * (size_t)R +
                          (quant ? 2 * (size_t)bs : 0));
}

// ------------------------------------------------------------- launches

// the kernels' pointer arguments: q, K and V pools, their int8 scales
// (null unless the pools are int8), tables, lengths, out and the span
// workspace (bf16 only)
struct Args {
  const void *q, *k, *k_scale, *v, *v_scale, *tables, *ctx_lens, *q_lens;
  void *out, *ws_acc, *ws_ml, *done;
};

template <typename KV, int HD>
int launch_mma(const Args& a, int B, int Sq, int H, int KVH, int KVHP,
               int KOFF, int hd, int NB, int bs, int MB, float scale,
               cudaStream_t stream) {
  const int rows = Sq * (H / KVH);
  const int cap = MB * bs;
  const dim3 grid((rows + TQ - 1) / TQ, B * KVH,
                  std::max(1, (cap + SPAN - 1) / SPAN));
  const size_t smem = mma_smem_bytes<KV>(hd, grid.z);
  auto kernel = mixed_mma_kernel<KV, HD>;
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
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
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
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const float*>(a.k_scale), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.ctx_lens),
      static_cast<const int32_t*>(a.q_lens),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.ws_acc),
      static_cast<float*>(a.ws_ml), static_cast<int*>(a.done), Sq, H, KVH,
      KVHP, KOFF, hd, NB, bs, MB, scale);
  return (int)cudaGetLastError();
}

// the served head widths (64, 128) as their own instances; any other
// multiple of 16 up to MAX_HD through the guarded one
template <typename KV>
int by_width(const Args& a, int B, int Sq, int H, int KVH, int KVHP,
             int KOFF, int hd, int NB, int bs, int MB, float scale,
             cudaStream_t s) {
  if (hd % 16 || hd <= 0 || hd > MAX_HD) return (int)cudaErrorInvalidValue;
  if (hd == 128)
    return launch_mma<KV, 128>(a, B, Sq, H, KVH, KVHP, KOFF, hd, NB, bs, MB,
                               scale, s);
  if (hd == 64)
    return launch_mma<KV, 64>(a, B, Sq, H, KVH, KVHP, KOFF, hd, NB, bs, MB,
                              scale, s);
  return launch_mma<KV, 0>(a, B, Sq, H, KVH, KVHP, KOFF, hd, NB, bs, MB,
                           scale, s);
}

template <typename KV>
int launch_f32(const Args& a, int B, int Sq, int H, int KVH, int KVHP,
               int KOFF, int hd, int NB, int bs, int MB, float scale,
               cudaStream_t stream) {
  const int rows = Sq * (H / KVH);
  const int R = rows < ROWS_MAX ? rows : ROWS_MAX;
  const dim3 grid((rows + R - 1) / R, KVH, B);
  const size_t smem =
      smem_bytes(R, hd, bs, std::is_same<KV, int8_t>::value);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attention_kernel<KV><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const float*>(a.k_scale), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.ctx_lens),
      static_cast<const int32_t*>(a.q_lens), static_cast<float*>(a.out), Sq,
      H, KVH, KVHP, KOFF, hd, NB, bs, MB, R, scale);
  return (int)cudaGetLastError();
}

// dtype: q/out type, 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores); quant: int8 pools + scales (else pools of q's type and null
// scales).
int dispatch(int dtype, bool quant, const Args& a, int B, int Sq, int H,
             int KVH, int KVHP, int KOFF, int hd, int NB, int bs, int MB,
             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KVH <= 0 || H % KVH || KOFF < 0 || KOFF + KVH > KVHP)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return quant ? launch_f32<int8_t>(a, B, Sq, H, KVH, KVHP, KOFF, hd, NB,
                                      bs, MB, scale, s)
                 : launch_f32<float>(a, B, Sq, H, KVH, KVHP, KOFF, hd, NB, bs,
                                     MB, scale, s);
  if (dtype == 1)
    return quant ? by_width<int8_t>(a, B, Sq, H, KVH, KVHP, KOFF, hd, NB, bs,
                                    MB, scale, s)
                 : by_width<__nv_bfloat16>(a, B, Sq, H, KVH, KVHP, KOFF, hd,
                                           NB, bs, MB, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, out and, unquantized, the pools).
// The launch attends KVH kv heads from head KOFF of pool rows of KVHP
// heads (a TP rank's heads of a pool that holds them all; KVHP = KVH,
// KOFF = 0 for the whole pool); q and out hold H = G * KVH heads.
// bf16: hd a multiple of 16, at most 128; q and the pools 16-byte
// aligned.  Workspace (f32, bf16 only; null for f32): ws_acc holds B * KVH
// * ceil(Sq * H / KVH / TQ) * ceil(MB * bs / SPAN) * TQ * hd values
// (TQ = 64 rows, SPAN = 256 tokens), ws_ml the same count over hd times
// 2; done holds B * KVH * ceil(Sq * H / KVH / TQ) int32 zeros, which the launch
// leaves zero; two launches that may run at once must not share them.
// Returns cudaGetLastError() after the launch (0 on success).  Allocates
// nothing and does not synchronise.
int mixed_block_paged_attention_launch(int dtype, const void* q,
                                       const void* k_pool, const void* v_pool,
                                       const void* tables,
                                       const void* ctx_lens,
                                       const void* q_lens, void* out,
                                       void* ws_acc, void* ws_ml, void* done,
                                       int B, int Sq, int H, int KVH,
                                       int KVHP, int KOFF, int hd, int NB,
                                       int bs, int MB, float scale,
                                       void* stream) {
  const Args a{q,      k_pool, nullptr, v_pool, nullptr, tables,
               ctx_lens, q_lens, out,   ws_acc, ws_ml,   done};
  return dispatch(dtype, false, a, B, Sq, H, KVH, KVHP, KOFF, hd, NB, bs, MB,
                  scale, stream);
}

// int8 pools [NB,bs,KVH,hd] with f32 scale pools [NB,bs] (4-byte
// aligned); q and out of type dtype; f32: hd a multiple of 8 and the pools
// 8-byte aligned; otherwise as mixed_block_paged_attention_launch.
int quant_mixed_block_paged_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* tables,
    const void* ctx_lens, const void* q_lens, void* out, void* ws_acc,
    void* ws_ml, void* done, int B, int Sq, int H, int KVH, int KVHP,
    int KOFF, int hd, int NB, int bs, int MB, float scale, void* stream) {
  const Args a{q,      k_pool, k_scale, v_pool, v_scale, tables,
               ctx_lens, q_lens, out,   ws_acc, ws_ml,   done};
  return dispatch(dtype, true, a, B, Sq, H, KVH, KVHP, KOFF, hd, NB, bs, MB,
                  scale, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
