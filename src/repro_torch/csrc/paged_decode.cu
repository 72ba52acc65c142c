// Split-context decode attention over the paged KV pool (bf16/f32 rows,
// or int8 rows with per-token scales) and over the slot-contiguous KV
// cache, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the reference package:
//   * block_paged_decode_attention        (src/repro/kernels/paged_attention.py:123)
//   * quant_block_paged_decode_attention  (src/repro/kernels/paged_attention.py:217)
//   * paged_decode_attention              (src/repro/kernels/paged_attention.py:75)
// One kernel, templated on q's type (bf16, f32), on the rows' storage
// type (q's, or int8 with f32 scales) and on how a K/V row is addressed:
// a block pool [NB,bs,KVH,hd] read through [B,MB] tables (position p of
// sequence b is row tables[b, p / bs] * bs + p % bs; the NB sentinel is
// clamped to NB - 1 where it is read, and lengths to MB * bs), or a
// slot-contiguous cache [B,S_max,KVH,hd] (row b * S_max + p; lengths
// clamped to S_max).  The mixed (chunked-prefill) attentions stay in
// paged_attention.cu.
//
// What it computes.  One query row per (sequence, head), q [B,H,hd]; the G
// = H/KVH heads of a kv head share its rows.  Scores q.k / sqrt(hd) over
// positions pos < length; online softmax in f32 (running max m, sum l,
// accumulator acc); output acc / max(l, 1e-30) in q's type.  A length of 0
// gives zeros.  The slot cache's windowed instance (starts given, the
// reference's sliding-window ring decode, no TPU kernel of its own: the
// reference computes it in plain mha) reads positions [starts[b],
// lengths[b]) only; where that range is empty (a ring past 2W - 1 tokens,
// whose mask drops every slot) it reads all S_max rows with a score of 0
// each, which is the reference's softmax over equal -1e30 scores: the
// uniform mean of v.  A -inf mask that skipped the empty range would
// return zeros there.  At chatglm3-6b's ring (B = 8, 8,192 slots, 42,253
// rows read, two empty ranges) 0.0706 ms against SDPA's 0.0507 and a
// 0.013 ms bound (NVIDIA H100 80GB HBM3, 700 W).  int8 rows (_quant_block_kernel of the reference): each
// token row of k and v has one f32 scale, in [NB,bs] scale pools read
// through the same table entry as the rows, so a remapped block always
// arrives with its own scales.  The dequantization commutes out of both
// products, as in the Pallas kernel: the score is (dot(q, k_i8) * sk[t]) *
// scale, in that order; l adds p, and acc adds (p * sv[t]) . v_i8, so sv
// never enters l.
//
// Bound on an H100.  Decode does 4 * hd * G FLOPs per context token and kv
// head against 4 * hd bytes of bf16 K+V: 8 FLOP/B at qwen3-30b-a3b's G = 8,
// far below the ~295 FLOP/B where the tensor cores would bound it.  The
// bytes bound it: every K/V row up to each length read once, 11.94 MB for
// the 5,764 context tokens of the serving path's decode lengths at B = 8,
// KVH = 4, hd = 128: 3.56 us at 3.35 TB/s; int8 rows and their scales 6.08
// MB, 1.82 us (zamba2-2.7b's shared block, G = 1, KVH = 32, hd = 80: 59.1
// MB, 17.6 us).
//
// Design.  What a GPU needs here is bytes in flight on every SM and a short
// chain of dependent steps per block, not arithmetic.  Grid (B, KVH,
// context splits): block (b, h, s) serves the G query rows of kv head h of
// sequence b over positions [s*CH, (s+1)*CH) up to the length, CH = 128
// (blocks past the length exit at once; the splits are the slowest grid
// axis, so every sequence's first span is scheduled first).  196 live
// blocks at the main shape, where one block per (sequence, kv head) gave
// 32.  The loads that do not need the length (q, and the span's table
// entries) go out beside it.  Each of the 4 warps then copies its own
// 32-token tile of K and of V into shared memory with 16-byte cp.async
// copies (zero-filled past the length; rows padded by 16 bytes so that
// 32 lanes reading 32 rows at one offset hit distinct banks; an int8 row is
// hd bytes, so a piece is 16 values; the lane that finds a row's offset
// also copies the row's k or v scale, from the same clamped table entry),
// K and V as separate groups, so the scores start while V is still in
// flight; no barrier between a warp's copies and its use of them.  Per
// tile the warp runs an online softmax of its own (rescaling only when the
// max rises):
//   * bf16 q, 3 to 16 heads a kv head: tensor cores.  S = Q K^T with the
//     heads padded to the 16 rows of an m16n8k16 product (bf16 K read as
//     the B operand straight from the padded rows); P is split into two
//     bf16 parts, P_hi = bf16(P) and P_lo = bf16(P - P_hi), and O += P_hi
//     V + P_lo V (V through ldmatrix.trans), sums in f32.  The two parts
//     keep each probability to about 2^-17 of itself, as the Pallas
//     kernel's f32 P.V does, where one bf16 rounding of P moves the output
//     by up to 2^-9 of the V rows it weighs (a peaked output by a bf16
//     step).  int8 K and V enter the same products as bf16, exactly (every
//     int8 value fits bf16's 8-bit significand): the fragments are
//     converted in registers as they are read (each byte through the
//     mantissa of 2^23), K by one 4-byte load a k-step, V by ldmatrix.trans
//     on byte pairs; the scores are scaled by sk, and P by sv before the
//     split.  Converting each warp's tile into a bf16 copy in shared memory
//     first, then running the bf16 code, took 0.0311 ms against 0.0256 at
//     the main shape (NVIDIA H100 80GB HBM3, 700 W), and is not kept;
//   * f32 q, and bf16 with 1 or 2 heads: CUDA cores.  Lane t dots row t
//     with every head's q (held in shared memory as f32; int8 rows
//     unpacked 16 values a load), P (int8: times sv) goes through shared
//     memory, and lane l accumulates values 4l..4l+3 of every head's
//     output row.
// The warps are merged in a fixed order through shared memory; a
// sequence that fits one block writes its output there.  Otherwise each
// block stores its (m, l, acc) in a workspace and counts itself done on a
// per-(sequence, kv head) counter with a gpu-scope acquire-release add;
// the last block resets the counter to zero for the next launch, copies
// every split's accumulators into shared memory while it reads their
// (m, l), and sums the splits in order 0, 1, ...: one launch, no memset,
// the same bits on every run (the scheme of mla_decode.cu).  Why the
// tensor cores: on CUDA cores every FMA of the scores and of P.V comes
// with a shared-memory load or an unpack, and with one 32-token tile a
// warp that work sat on each block's critical path; the tensor cores
// take it off at G = 8, while zamba2-2.7b's one head a kv head (15 of the
// 16 rows idle) lost on them and stays on CUDA cores (PERF.md).
// CH = 128 with 4 warps tied with CH = 256 with 8 warps and beat CH 64
// and 1 or 2 warps a block when they were timed.  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py, the main shape): bf16 rows
// 0.0232 ms, slot cache 0.0216 ms, int8 rows 0.0256 ms, against SDPA's
// 0.0358-0.0360 ms; 120-128 registers in the tensor-core instances, and
// the f32-q, int8, 5-8 heads instance spills 8 bytes (f32 is the parity
// type: no served path runs it).  Known gaps: each block is a chain of
// dependent round trips (length, rows, partial store, counter, the last
// block's reads) whose latency, not the bytes, sets the time at the
// serving path's size: 6-14x the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

constexpr int CH = 128;                 // context tokens a block reads
constexpr int NW = 4;                   // its warps
constexpr int THREADS = 32 * NW;
constexpr int TPW = CH / (32 * NW);   // 32-token tiles a warp reads
constexpr int MAX_HD = 128;
constexpr int DPL = 4;                // values of a V row a lane owns
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;         // devices a process may launch on
static_assert(TPW >= 1 && TPW <= 4 && TPW * 32 * NW == CH, "blocking");

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes as f32 values: 4 floats, or 8 bf16
__device__ __forceinline__ void unpack16(uint4 w, float (&x)[4]) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack16(uint4 w, float (&x)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
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
// 16 bytes as 16 int8 values
__device__ __forceinline__ void unpack16(uint4 w, float (&x)[16]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    i8x4_f32(u[i], f);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[4 * i + j] = f[j];
  }
}
// 16 bytes of shared memory as f32 values
template <typename T, int N>
__device__ __forceinline__ void load16(const T* p, float (&x)[N]) {
  unpack16(*reinterpret_cast<const uint4*>(p), x);
}
// N f32 values of shared memory, 16 bytes at a time
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 w = *reinterpret_cast<const float4*>(p + i);
    x[i] = w.x;
    x[i + 1] = w.y;
    x[i + 2] = w.z;
    x[i + 3] = w.w;
  }
}
// DPL = 4 values of shared memory as f32
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  unpack16(*reinterpret_cast<const uint4*>(p), x);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(w.x << 16);
  x[1] = __uint_as_float(w.x & 0xffff0000u);
  x[2] = __uint_as_float(w.y << 16);
  x[3] = __uint_as_float(w.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  i8x4_f32(*reinterpret_cast<const uint32_t*>(p), x);
}

// 16-byte asynchronous copy; a piece that is not `valid` is zero-filled
// (no byte of src is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4-byte asynchronous copy, zero-filled where not `valid`
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
// wait until at most n (< 8) of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
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

// four 8x8 bf16 tiles of shared memory, transposed: lane l gives the row
// address of tile l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Bytes of a staged K or V row: hd values and 16 bytes of padding, so
// the 32 lanes reading 32 rows at one offset hit distinct banks.
template <typename KV>
__host__ __device__ __forceinline__ int row_bytes(int hd) {
  return hd * (int)sizeof(KV) + 16;
}

// grid (B, KVH, splits), THREADS threads; dynamic shared memory: see
// smem_bytes().  KV is the pools' storage type: T, or int8_t with f32
// scale pools k_scale / v_scale [NB, bs] (null otherwise) read through the
// same table entries as the rows.  SLOT: k/v are slot caches
// [B,S_max,KVHP,hd] (tables null), else pools [NB,bs,KVHP,hd] read through
// tables [B,MB]; the block's kv head is head KOFF + kvh of a row (KVH of
// the KVHP heads from KOFF: a TP rank's).  ws_acc [B, KVH, gridDim.z, G,
// hd] and ws_ml [B, KVH, gridDim.z, G, 2] (f32) hold the splits of a
// sequence longer than CH; done [B * KVH] int32 is zero at the start, and
// the merging block leaves it zero at the end.
template <typename T, typename KV, bool SLOT, int GP>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ starts,
    T* __restrict__ out,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    int* __restrict__ done, int H, int KVH, int KVHP, int KOFF, int hd,
    int NB, int bs, int MB, int S_max, float scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static_assert(!(QUANT && SLOT), "int8 rows come from block pools");
  constexpr int VEC = 16 / sizeof(KV);   // K/V values a 16-byte piece
  constexpr int QV = 16 / sizeof(T);     // q values a 16-byte load
  // bf16 groups of 3 to 16 heads: tensor-core tiles over 16 rows; f32,
  // and bf16 groups of 1 or 2 heads: CUDA cores
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value && GP == 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the span's K and V rows [CH][row_bytes] each; after the tiles, the
  // warps' merge [NW][GP][hd] f32, then the splits' weights [splits][GP]
  unsigned char* k_s = smem_raw;
  float* red = reinterpret_cast<float*>(smem_raw);
  __shared__ __align__(16) float q_s[GP][MAX_HD];
  __shared__ __align__(16) float p_s[MMA ? 1 : NW][32][GP];
  __shared__ int tab_s[CH + 1];
  __shared__ float m_s[NW][GP], l_s[NW][GP], M_s[GP], L_s[GP];
  // int8: the span's k and v scales, beside their rows
  __shared__ float sk_s[QUANT ? CH : 1], sv_s[QUANT ? CH : 1];
  __shared__ int last_s;

  const int b = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chk = hd / VEC;           // 16-byte pieces a row
  const int rb = row_bytes<KV>(hd);
  unsigned char* v_s = k_s + (size_t)CH * rb;

  const int cap = SLOT ? S_max : MB * bs;
  // the rows read: positions [lo, hi) (a slot cache with starts: the
  // windowed ring's range); an empty range reads every row with equal
  // scores, the reference's softmax over a row of -1e30
  int lo = 0, hi = max(0, min(lengths[b], cap));
  bool uniform = false;
  if constexpr (SLOT) {
    if (starts != nullptr) {
      lo = min(max(starts[b], 0), cap);
      if (lo >= hi) {
        uniform = true;
        lo = 0;
        hi = cap;
      }
    }
  }
  const int len = hi - lo;
  const int n_split = max(1, (len + CH - 1) / CH);
  const int t0 = sp * CH, t1 = min(len, t0 + CH);
  const int blk0 = t0 / bs;             // the span's first table entry

  // copy the 32 rows of the tile at row r0 of the span from src to dst:
  // lane t finds row t's offset (and, int8, copies its scale from sc_src
  // to sc_dst), then the lanes take the tile's 16-byte pieces in turn,
  // each piece's offset from its row's lane
  auto copy_tile = [&](unsigned char* dst, const KV* src,
                       const float* sc_src, float* sc_dst, int r0) {
    if (t0 + r0 >= t1) return;                   // warp-uniform
    const int pos = t0 + r0 + lane;
    long long off = -1;                          // elements; -1 past t1
    size_t row = 0;
    if (pos < t1) {
      if constexpr (SLOT) {
        row = (size_t)b * S_max + lo + pos;
      } else {
        row = (size_t)tab_s[pos / bs - blk0] * bs + pos % bs;
      }
      off = (long long)((row * KVHP + KOFF + kvh) * hd);
    }
    if constexpr (QUANT) cp_async4(sc_dst + r0 + lane, sc_src + row, off >= 0);
    int t = lane / chk, piece = lane - t * chk;  // piece c = t * chk + piece
    for (int c = lane; c < 32 * chk; c += 32) {
      const long long o = __shfl_sync(0xffffffffu, off, t);
      cp_async16(dst + (size_t)(r0 + t) * rb + piece * 16,
                 src + (o < 0 ? 0 : o + piece * VEC), o >= 0);
      for (piece += 32; piece >= chk; piece -= chk) ++t;
    }
  };
  // this warp's tiles: K then V, one commit group each (empty past t1)
  auto issue = [&]() {
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int r0 = (warp + NW * i) * 32;
      copy_tile(k_s, k, k_scale, sk_s, r0);
      cp_async_commit();
      copy_tile(v_s, v, v_scale, sv_s, r0);
      cp_async_commit();
    }
  };

  // q does not need the length: the kv head's G query rows are G * hd
  // contiguous values, loaded 16 bytes a thread, every load in flight at
  // once (rows past G zero), and kept in registers until q_s is written
  constexpr int QP = (GP * MAX_HD / QV + THREADS - 1) / THREADS;
  uint4 qw[QP];
  const T* q0 = q + ((size_t)b * H + kvh * G) * hd;
#pragma unroll
  for (int j = 0; j < QP; ++j) {
    const int pc = tid + j * THREADS;
    qw[j] = pc * QV < G * hd ? *reinterpret_cast<const uint4*>(q0 + pc * QV)
                             : make_uint4(0, 0, 0, 0);
  }
  // nor do the span's table entries (at most CH / bs + 1): their loads go
  // out beside the length's
  if constexpr (!SLOT) {
    const int nent = min((t0 + CH - 1) / bs, MB - 1) - blk0 + 1;
    for (int i = tid; i < nent; i += THREADS)
      tab_s[i] = min(max(tables[(size_t)b * MB + blk0 + i], 0), NB - 1);
  }
  if (sp >= n_split) return;
  if constexpr (SLOT) issue();             // the rows need only the length
#pragma unroll
  for (int j = 0; j < QP; ++j) {
    const int pc = tid + j * THREADS;
    if (pc * QV < GP * hd) {
      float x[QV];
      unpack16(qw[j], x);
      const int g = pc * QV / hd, d = pc * QV - g * hd;
#pragma unroll
      for (int e = 0; e < QV; ++e) q_s[g][d + e] = x[e];
    }
  }
  __syncthreads();
  if constexpr (!SLOT) issue();

  if constexpr (MMA) {
    // bf16 on the tensor cores, per warp and 32-token tile: S[16 x 32] =
    // Q[16 x hd] K^T (the G heads padded to 16 rows), then O[16 x hd] +=
    // P_hi V + P_lo V, m16n8k16 products summed in f32.  int8 rows enter
    // as bf16, exactly (|x| <= 127): K's fragments from one 4-byte load
    // a k-step (bytes 4 tig .. 4 tig + 3, so the lanes' k order within a
    // step is permuted, and q's fragments with it); V's through
    // ldmatrix.trans on byte pairs, which gives each lane two tokens of
    // two neighbouring values: an n-tile takes the even values of 16, the
    // next the odd ones.
    const int gid = lane >> 2, tig = lane & 3;
    const int ks_n = hd / 16, nt_n = hd / 8;
    uint32_t qa[MAX_HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < MAX_HD / 16; ++ks) {
      if (ks < ks_n && QUANT) {
        const int c = ks * 16 + 4 * tig;
        qa[ks][0] = pack_bf16(q_s[gid][c], q_s[gid][c + 1]);
        qa[ks][1] = pack_bf16(q_s[gid + 8][c], q_s[gid + 8][c + 1]);
        qa[ks][2] = pack_bf16(q_s[gid][c + 2], q_s[gid][c + 3]);
        qa[ks][3] = pack_bf16(q_s[gid + 8][c + 2], q_s[gid + 8][c + 3]);
      } else if (ks < ks_n) {
        const int c = ks * 16 + 2 * tig;
        qa[ks][0] = pack_bf16(q_s[gid][c], q_s[gid][c + 1]);
        qa[ks][1] = pack_bf16(q_s[gid + 8][c], q_s[gid + 8][c + 1]);
        qa[ks][2] = pack_bf16(q_s[gid][c + 8], q_s[gid][c + 9]);
        qa[ks][3] = pack_bf16(q_s[gid + 8][c + 8], q_s[gid + 8][c + 9]);
      }
    }
    float o[MAX_HD / 8][4], m2[2] = {NEG_INF, NEG_INF}, l2[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < MAX_HD / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int r0 = (warp + NW * i) * 32;
      const int n_tok = min(32, t1 - t0 - r0);  // warp-uniform
      if (n_tok <= 0) break;
      cp_async_wait_n(2 * (TPW - 1 - i) + 1);   // this tile's K has landed
      __syncwarp();
      float sc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
        const unsigned char* kr =
            k_s + (size_t)(r0 + nt * 8 + gid) * rb + 4 * tig;
#pragma unroll
        for (int ks = 0; ks < MAX_HD / 16; ++ks) {
          if (ks < ks_n && QUANT) {
            float x[4];
            i8x4_f32(*reinterpret_cast<const uint32_t*>(kr + ks * 16), x);
            mma_bf16(sc[nt], qa[ks], pack_bf16(x[0], x[1]),
                     pack_bf16(x[2], x[3]));
          } else if (ks < ks_n) {
            const uint32_t b0 =
                *reinterpret_cast<const uint32_t*>(kr + ks * 32);
            const uint32_t b1 =
                *reinterpret_cast<const uint32_t*>(kr + ks * 32 + 16);
            mma_bf16(sc[nt], qa[ks], b0, b1);
          }
        }
      }
      // scale, mask, and the online softmax of rows gid and gid + 8 (each
      // row's 32 scores lie on the 4 lanes of a quad)
      float mx[2] = {m2[0], m2[1]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tok = nt * 8 + 2 * tig + (j & 1);
          // int8: (dot . sk[t]) . scale, the reference's order
          const float s = QUANT ? sc[nt][j] * sk_s[r0 + tok] : sc[nt][j];
          sc[nt][j] = tok < n_tok ? (uniform ? 0.f : s * scale)
                                  : -CUDART_INF_F;
          mx[j >> 1] = fmaxf(mx[j >> 1], sc[nt][j]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float alpha = expf(m2[h] - mx[h]);   // 1 while unchanged
        m2[h] = mx[h];
        l2[h] *= alpha;
#pragma unroll
        for (int nt = 0; nt < MAX_HD / 8; ++nt) {
          o[nt][2 * h] *= alpha;
          o[nt][2 * h + 1] *= alpha;
        }
      }
      if constexpr (QUANT) {
        cp_async_wait_n(2 * (TPW - 1 - i));     // its V and v scales
        __syncwarp();
      }
      // P_hi and P_lo; int8: of p . sv[t], while l sums p
      uint32_t pa[2][4], pl[2][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = expf(sc[nt][j] - m2[j >> 1]);      // 0 for a masked token
          l2[j >> 1] += p[j];
          if constexpr (QUANT) p[j] *= sv_s[r0 + nt * 8 + 2 * tig + (j & 1)];
        }
        const int a = nt >> 1, r = 2 * (nt & 1);
        split_bf16(p[0], p[1], pa[a][r], pl[a][r]);
        split_bf16(p[2], p[3], pa[a][r + 1], pl[a][r + 1]);
      }
      if constexpr (!QUANT) {
        cp_async_wait_n(2 * (TPW - 1 - i));     // and its V
        __syncwarp();
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const unsigned char* vr =
            v_s + (size_t)(r0 + kk * 16 + (lane & 15)) * rb + (lane >> 4) * 16;
        if constexpr (QUANT) {
          // 32 values a load: matrices (tokens 0-7 | 8-15) x (values 0-15
          // | 16-31); past hd (hd % 32 == 16) the row's padding is read
          // into n-tiles that are never stored
#pragma unroll
          for (int dp = 0; dp < MAX_HD / 32; ++dp) {
            if (dp * 32 < hd) {
              uint32_t bv[4];
              ldmatrix_x4_trans(bv, vr + dp * 32);
              float x[4][4];
#pragma unroll
              for (int m = 0; m < 4; ++m) i8x4_f32(bv[m], x[m]);
#pragma unroll
              for (int h = 0; h < 2; ++h) {       // values 16 h .. 16 h + 15
#pragma unroll
                for (int par = 0; par < 2; ++par) {   // even, odd values
                  const uint32_t b0 = pack_bf16(x[2 * h][par],
                                                x[2 * h][par + 2]);
                  const uint32_t b1 = pack_bf16(x[2 * h + 1][par],
                                                x[2 * h + 1][par + 2]);
                  float(&acc)[4] = o[4 * dp + 2 * h + par];
                  mma_bf16(acc, pa[kk], b0, b1);
                  mma_bf16(acc, pl[kk], b0, b1);
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int np = 0; np < MAX_HD / 16; ++np) {
            if (np < ks_n) {
              uint32_t bv[4];
              ldmatrix_x4_trans(bv, vr + np * 32);
              mma_bf16(o[2 * np], pa[kk], bv[0], bv[1]);
              mma_bf16(o[2 * np], pl[kk], bv[0], bv[1]);
              mma_bf16(o[2 * np + 1], pa[kk], bv[2], bv[3]);
              mma_bf16(o[2 * np + 1], pl[kk], bv[2], bv[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l2[h] += __shfl_xor_sync(0xffffffffu, l2[h], 1);
      l2[h] += __shfl_xor_sync(0xffffffffu, l2[h], 2);
    }
    cp_async_wait<0>();
    __syncthreads();       // every warp is done with the rows: reuse them

    // merge the warps: red[w][row] = e^(m_w - M) o_w, in warp order
    if (tig == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_s[warp][gid + 8 * h] = m2[h];
        l_s[warp][gid + 8 * h] = l2[h];
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = gid + 8 * h;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) M = fmaxf(M, m_s[w][row]);
      const float f = expf(m2[h] - M);
      float* dst = red + (warp * GP + row) * hd;
#pragma unroll
      for (int nt = 0; nt < MAX_HD / 8; ++nt) {
        if constexpr (QUANT) {
          // n-tile nt: values 32 (nt / 4) + 16 ((nt / 2) % 2) + 2 n +
          // nt % 2 for its columns n
          const int d = (nt >> 2) * 32 + (nt & 2) * 8 + (nt & 1);
          if (d < hd) {
            dst[d + 4 * tig] = o[nt][2 * h] * f;
            dst[d + 4 * tig + 2] = o[nt][2 * h + 1] * f;
          }
        } else if (nt < nt_n) {
          dst[nt * 8 + 2 * tig] = o[nt][2 * h] * f;
          dst[nt * 8 + 2 * tig + 1] = o[nt][2 * h + 1] * f;
        }
      }
    }
    if (tid < GP) {
      float M = NEG_INF, L = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) M = fmaxf(M, m_s[w][tid]);
#pragma unroll
      for (int w = 0; w < NW; ++w) L += l_s[w][tid] * expf(m_s[w][tid] - M);
      M_s[tid] = M;
      L_s[tid] = L;
    }
    __syncthreads();
  } else {
    // online softmax of this warp's tiles: m[g] warp-uniform, l[g] the
    // lane's own tokens' share, acc[g][j] the lane's DPL values of the row
    float m[GP], l[GP], acc[GP][DPL];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
    }
    const bool v_on = lane * DPL < hd;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int r0 = (warp + NW * i) * 32;
      const int n_tok = min(32, t1 - t0 - r0);    // warp-uniform
      if (n_tok <= 0) break;
      cp_async_wait_n(2 * (TPW - 1 - i) + 1);   // this tile's K has landed
      __syncwarp();
      // scores: lane t dots its row with every head's q
      float s[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) s[g] = 0.f;
      const unsigned char* krow = k_s + (size_t)(r0 + lane) * rb;
#pragma unroll 2
      for (int pc = 0; pc < chk; ++pc) {
        float kx[VEC];
        load16(reinterpret_cast<const KV*>(krow + pc * 16), kx);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float qx[VEC];
          load_f32(&q_s[g][pc * VEC], qx);
#pragma unroll
          for (int j = 0; j < VEC; ++j) s[g] = fmaf(qx[j], kx[j], s[g]);
        }
      }
      const bool ok = lane < n_tok;
      // int8: (dot . sk[t]) . scale, the reference's order
      const float sk = QUANT ? sk_s[r0 + lane] : 1.f;
      float pg[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float sc = !ok      ? -CUDART_INF_F
                         : uniform ? 0.f
                                   : (QUANT ? s[g] * sk : s[g]) * scale;
        const float mx = fmaxf(m[g], warp_max(sc));
        const float alpha = expf(m[g] - mx);      // 1 while mx == m[g]
        const float p = expf(sc - mx);            // 0 for a masked token
        m[g] = mx;
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] *= alpha;
        pg[g] = p;
        if constexpr (!QUANT) p_s[warp][lane][g] = p;
      }
      cp_async_wait_n(2 * (TPW - 1 - i));       // and its V
      __syncwarp();
      if constexpr (QUANT) {
        // the v scale weighs the probability row, never l
        const float sv = sv_s[r0 + lane];
#pragma unroll
        for (int g = 0; g < GP; ++g) p_s[warp][lane][g] = pg[g] * sv;
        __syncwarp();
      }
      // acc += p . V: lane owns values lane*DPL ... of every row
      if (v_on) {
        const unsigned char* vcol = v_s + (size_t)r0 * rb + lane * DPL *
                                    sizeof(KV);
        for (int t = 0; t < n_tok; ++t) {
          float vx[DPL];
          load4(reinterpret_cast<const KV*>(vcol + (size_t)t * rb), vx);
#pragma unroll
          for (int g = 0; g < GP; ++g) {
            const float p = p_s[warp][t][g];
#pragma unroll
            for (int j = 0; j < DPL; ++j)
              acc[g][j] = fmaf(p, vx[j], acc[g][j]);
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) l[g] = warp_sum(l[g]);
    cp_async_wait<0>();
    __syncthreads();       // every warp is done with the rows: reuse them

    // merge the warps: red[w][g] = e^(m_w - M) acc_w, in warp order
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) M = fmaxf(M, m_s[w][g]);
      const float f = expf(m[g] - M);
      if (v_on) {
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          red[(warp * GP + g) * hd + lane * DPL + j] = acc[g][j] * f;
      }
      if (tid == 0) {
        float L = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) L += l_s[w][g] * expf(m_s[w][g] - M);
        M_s[g] = M;
        L_s[g] = L;
      }
    }
    __syncthreads();
  }

  // the block's sum in warp order, 4 values at a time: value 4i of the
  // G rows is value 4i of warp w's rows in red (the rows are hd apart)
  auto block_sum = [&](int i) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float4 x = reinterpret_cast<const float4*>(red + w * GP * hd)[i];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    return a;
  };
  auto store4 = [&](T* dst, float4 a, float L) {
    L = fmaxf(L, 1e-30f);
    store(dst, a.x / L);
    store(dst + 1, a.y / L);
    store(dst + 2, a.z / L);
    store(dst + 3, a.w / L);
  };
  T* o = out + ((size_t)b * H + kvh * G) * hd;
  if (n_split == 1) {
    for (int i = tid; i < G * hd / 4; i += THREADS)
      store4(o + 4 * i, block_sum(i), L_s[4 * i / hd]);
    return;
  }

  // several blocks: store this split, and let the last one merge them all
  const size_t key = (size_t)b * KVH + kvh;
  const size_t split0 = key * gridDim.z;
  float4* my_acc =
      reinterpret_cast<float4*>(ws_acc + (split0 + sp) * G * hd);
  for (int i = tid; i < G * hd / 4; i += THREADS) my_acc[i] = block_sum(i);
  if (tid < G) {
    float* ml = ws_ml + ((split0 + sp) * G + tid) * 2;
    ml[0] = M_s[tid];
    ml[1] = L_s[tid];
  }
  __syncthreads();
  if (tid == 0) {
    last_s = atomic_add_acq_rel(done + key, 1) == n_split - 1;
    if (last_s) done[key] = 0;    // every split has counted: ready for reuse
  }
  __syncthreads();
  if (!last_s) return;
  // the last block: every split's accumulators (as many as fit in shared
  // memory at a time) and (m, l) in flight together, then each head's M
  // and L, each split's weight e^(m_r - M), and the weighted sum in split
  // order
  const int per = G * hd;                            // floats a split
  const float* base_acc = ws_acc + split0 * per;
  const float2* base_ml = reinterpret_cast<const float2*>(ws_ml) + split0 * G;
  float* w_s = red;                                  // [n_split][GP]
  float* l_r = red + (size_t)n_split * GP;           // [n_split][GP]
  float* acc_s = red + ((2 * (size_t)n_split * GP + 3) & ~(size_t)3);
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  const int R = (int)((dyn / 4 - (acc_s - red)) / per);   // >= 1
  auto fetch = [&](int r0) {
    const int n4 = min(R, n_split - r0) * per / 4;
    for (int c = tid; c < n4; c += THREADS)
      cp_async16(acc_s + 4 * c, base_acc + (size_t)r0 * per + 4 * c, true);
    cp_async_commit();
  };
  fetch(0);
  for (int i = tid; i < n_split * G; i += THREADS) {
    const int r = i / G, g = i - r * G;
    const float2 ml = __ldcg(base_ml + i);
    w_s[r * GP + g] = ml.x;
    l_r[r * GP + g] = ml.y;
  }
  __syncthreads();
  if (tid < G) {
    float M = NEG_INF, L = 0.f;
    for (int r = 0; r < n_split; ++r) M = fmaxf(M, w_s[r * GP + tid]);
    for (int r = 0; r < n_split; ++r)
      L += l_r[r * GP + tid] * expf(w_s[r * GP + tid] - M);
    M_s[tid] = M;
    L_s[tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < n_split * G; i += THREADS) {
    const int r = i / G, g = i - r * G;
    w_s[r * GP + g] = expf(w_s[r * GP + g] - M_s[g]);
  }
  constexpr int E = (16 * MAX_HD / 4 + THREADS - 1) / THREADS;
  float4 a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < n_split; r0 += R) {
    cp_async_wait<0>();
    __syncthreads();
    const int nr = min(R, n_split - r0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = tid + e * THREADS;               // float4 of a split
      if (i < per / 4) {
        const int g = 4 * i / hd;
#pragma unroll 4
        for (int r = 0; r < nr; ++r) {
          const float4 x = reinterpret_cast<const float4*>(
              acc_s + (size_t)r * per)[i];
          const float w = w_s[(r0 + r) * GP + g];
          a[e].x = fmaf(x.x, w, a[e].x);
          a[e].y = fmaf(x.y, w, a[e].y);
          a[e].z = fmaf(x.z, w, a[e].z);
          a[e].w = fmaf(x.w, w, a[e].w);
        }
      }
    }
    __syncthreads();
    if (r0 + R < n_split) fetch(r0 + R);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tid + e * THREADS;
    if (i < per / 4) store4(o + 4 * i, a[e], L_s[4 * i / hd]);
  }
}

// the span's K and V rows; then, in the same bytes, the warps' merge and
// the splits' weights
template <typename KV, int GP>
size_t smem_bytes(int hd, int splits) {
  const size_t n = std::max((size_t)2 * CH * row_bytes<KV>(hd),
                            (size_t)NW * GP * hd * sizeof(float));
  // the last block's merge: weights and sums of every split, then at
  // least one split's accumulators
  return std::max(n, ((size_t)2 * splits * GP + 4 + (size_t)GP * hd) *
                         sizeof(float));
}

// the kernel's pointer arguments: q, K and V rows, their int8 scales
// (null unless KV is int8_t), tables (null for slot caches), lengths,
// out and the split workspace
struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *tables, *lengths, *starts;
  void *out, *ws_acc, *ws_ml, *done;
};

template <typename T, typename KV, bool SLOT, int GP>
int launch(const Args& a, int B, int H, int KVH, int KVHP, int KOFF, int hd,
           int NB, int bs, int MB, int S_max, float scale,
           cudaStream_t stream) {
  const int cap = SLOT ? S_max : MB * bs;
  // the splits slowest: every sequence's first span is scheduled first,
  // and the blocks past a short sequence's length come last
  const dim3 grid(B, KVH, cap > 0 ? (cap + CH - 1) / CH : 1);
  const size_t smem = smem_bytes<KV, GP>(hd, grid.z);
  auto kernel = paged_decode_kernel<T, KV, SLOT, GP>;
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
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.lengths),
      static_cast<const int32_t*>(a.starts), static_cast<T*>(a.out),
      static_cast<float*>(a.ws_acc), static_cast<float*>(a.ws_ml),
      static_cast<int*>(a.done), H, KVH, KVHP, KOFF, hd, NB, bs, MB, S_max,
      scale);
  return (int)cudaGetLastError();
}

// GP: the group size H / KVH rounded up to a power of two (f32), or 1, 2
// and else 16, the tensor-core tiles' rows (bf16)
template <typename T, typename KV, bool SLOT>
int by_group(const Args& a, int B, int H, int KVH, int KVHP, int KOFF,
             int hd, int NB, int bs, int MB, int S_max, float scale,
             cudaStream_t s) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  const int G = H / KVH;
#define PD_LAUNCH(GP) \
  launch<T, KV, SLOT, GP>(a, B, H, KVH, KVHP, KOFF, hd, NB, bs, MB, S_max, \
                          scale, s)
  if (G <= 1) return PD_LAUNCH(1);
  if (G <= 2) return PD_LAUNCH(2);
  if constexpr (!BF16) {
    if (G <= 4) return PD_LAUNCH(4);
    if (G <= 8) return PD_LAUNCH(8);
  }
  if (G <= 16) return PD_LAUNCH(16);
#undef PD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// quant: int8 rows with f32 scales (block pools only), else rows of q's
// type
template <bool SLOT, bool QUANT = false>
int dispatch(int dtype, const Args& a, int B, int H, int KVH, int KVHP,
             int KOFF, int hd, int NB, int bs, int MB, int S_max, float scale,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return 0;
  if (KVH <= 0 || H % KVH || hd <= 0 || hd > MAX_HD || KOFF < 0 ||
      KOFF + KVH > KVHP)
    return (int)cudaErrorInvalidValue;
  using F32KV = typename std::conditional<QUANT, int8_t, float>::type;
  using BF16KV =
      typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  if (dtype == 0 && hd % (QUANT ? 16 : 4) == 0)
    return by_group<float, F32KV, SLOT>(a, B, H, KVH, KVHP, KOFF, hd, NB, bs,
                                        MB, S_max, scale, s);
  if (dtype == 1 && hd % 16 == 0)
    return by_group<__nv_bfloat16, BF16KV, SLOT>(a, B, H, KVH, KVHP, KOFF, hd,
                                                 NB, bs, MB, S_max, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, out and the pools); tables and
// lengths int32.  The launch attends KVH kv heads from head KOFF of rows
// of KVHP heads (a TP rank's heads of a pool that holds them all; KVHP =
// KVH, KOFF = 0 for the whole pool); q and out hold H = G * KVH heads.
// G = H / KVH at most 16; hd at most 128 and a multiple of
// 16 bytes; pools 16-byte aligned.  Workspace (f32): ws_acc holds B * KVH
// * ceil(MB * bs / 128) * G * hd values, ws_ml the same count over hd times
// 2; done holds B * KVH int32 zeros, which the launch leaves zero; two
// launches that may run at once must not share it.  Returns
// cudaGetLastError() after the launch (0 on success).  Allocates nothing
// and does not synchronise.
int block_paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, void* ws_acc,
    void* ws_ml, void* done, int B, int H, int KVH, int KVHP, int KOFF,
    int hd, int NB, int bs, int MB, float scale, void* stream) {
  const Args a{q,       k_pool, v_pool, nullptr, nullptr, tables,
               lengths, nullptr, out,  ws_acc,  ws_ml,   done};
  return dispatch<false>(dtype, a, B, H, KVH, KVHP, KOFF, hd, NB, bs, MB, 0,
                         scale, stream);
}

// int8 pools [NB,bs,KVH,hd] with f32 scale pools [NB,bs] (4-byte
// aligned), q and out of type dtype; hd a multiple of 16; otherwise as
// block_paged_decode_attention_launch.
int quant_block_paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* ws_acc, void* ws_ml, void* done,
    int B, int H, int KVH, int KVHP, int KOFF, int hd, int NB, int bs,
    int MB, float scale, void* stream) {
  const Args a{q,       k_pool, v_pool, k_scale, v_scale, tables,
               lengths, nullptr, out,  ws_acc,  ws_ml,   done};
  return dispatch<false, true>(dtype, a, B, H, KVH, KVHP, KOFF, hd, NB, bs,
                               MB, 0, scale, stream);
}

// Slot-contiguous caches [B,S_max,KVH,hd] of q's type; lengths [B]
// (clamped to S_max); starts [B] or null: row b reads positions
// [starts[b], lengths[b]), and an empty range every row with equal
// scores; the workspace as above with S_max for MB * bs.
int paged_decode_attention_launch(int dtype, const void* q,
                                  const void* k_cache, const void* v_cache,
                                  const void* lengths, const void* starts,
                                  void* out,
                                  void* ws_acc, void* ws_ml, void* done,
                                  int B, int H, int KVH, int KVHP, int KOFF,
                                  int hd, int S_max, float scale,
                                  void* stream) {
  const Args a{q,       k_cache, v_cache, nullptr, nullptr, nullptr,
               lengths, starts,  out,     ws_acc,  ws_ml,   done};
  return dispatch<true>(dtype, a, B, H, KVH, KVHP, KOFF, hd, 0, 1, 0, S_max,
                        scale, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
