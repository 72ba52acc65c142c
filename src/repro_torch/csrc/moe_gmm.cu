// Paged grouped expert matmul for Hopper (sm_90a), bf16/f32 and int8 pages.
//
// Replaces the Pallas TPU kernels paged_gmm (src/repro/kernels/moe_gmm.py:83)
// and quant_paged_gmm (:148); paged_expert_ffn (:131) and
// quant_paged_expert_ffn (:192) stay the same three-launch compositions in
// kernels/moe_gmm.py.
//
// What it computes.  out[e] = x[e] @ pool[table[e]] for every local expert
// e: x [E,C,D], pool [P,D,F] (a bank of weight pages), table [E] int32 page
// of each expert (clamped to [0, P - 1]; tables may alias: several experts
// naming one page) -> out [E,C,F] in x's dtype, f32 sums rounded once.
// int8 pages carry one f32 scale per page, scales [P], read through the
// same table entry: the kernel sums x * w_i8 in f32 and multiplies the sum
// by the page's scale once, before the one rounding to x's dtype, as the
// Pallas _quant_kernel does (x @ (w_i8 * s) = (x @ w_i8) * s).  No int8
// tensor cores: an int8 x int8 product would quantize the activations,
// another function.
//
// Bound on an H100.  Memory: every page the table names is read once, so
// the least time is (pages * D * F + x + out bytes) / 3.35 TB/s.  At decode
// (C = 1, capacity one token per expert) this is a batched GEMV: one qwen3
// bank of 128 pages of 2048x768 is 402.7 MB in bf16, 120 us per launch, and
// 201.3 MB in int8, 60 us.  The arithmetic (2*E*C*D*F) stays under the
// memory time at every C the serving path produces: C = 10 at a 128-token
// chunk (qwen3), C = 120 at a 1,024-token prefill (deepseek-v2-lite, 47
// GFLOP: 48 us at the bf16 tensor-core rate against 126 us of pages).
//
// Design, bf16 x (every served path; bf16 or int8 pages): one pass over
// each page on the tensor cores.  A block of 4 warps owns one expert, a
// tile of FT = 128 of the page's F columns and up to ROWS = 128 of x[e]'s
// rows, and walks D in k-tiles of KT = 64, keeping every row's f32 sums in
// registers for the whole walk; grid (row blocks, F tiles, E).  The served
// C (1, 10, 120) fits one row block, so every page byte leaves device
// memory once whatever C is; a larger C takes more row blocks, which
// launch side by side (the row block is the grid's fastest index) and so
// find the page's tiles in L2.  A and B are swapped so that the small C is
// the product's n: the page's F columns are m (A = W^T, read by
// ldmatrix.trans from the [d][f] tile), x[e]'s rows are n in tiles of 8 (B
// = x^T, read by ldmatrix from the [c][d] rows), m16n8k16 products with f32
// sums.  A warp owns 32 columns, two m-tiles; the instance NT (1, 2, 4, 8
// or 16 n-tiles, the least that covers min(C, ROWS)) fixes the registers:
// at C = 1 a product's n is 7/8 padding, which costs only tensor-core time
// the memory bound leaves idle; at C = 120, NT = 16, 128 f32 sums a thread.
// Weight tiles [64 x 128] and x[e]'s [rows x 64] tile come in together
// through a ring of 16-byte cp.async copies, one barrier a k-tile: 4 stages
// for bf16 pages (48 KB of page in flight a block, 3 blocks an SM), 3 at
// NT = 16 (two blocks an SM) and for int8 pages (7 blocks an SM, so that
// qwen3's 768 blocks of wi at C = 1 run in one wave).  Rows are padded by
// 16 bytes so that the 8 rows an ldmatrix reads hit distinct banks.
// Columns past F and depths past D are zero-filled by the copies
// (src-size 0); x's rows past C are zeroed once and never stored.  The
// epilogue stages the block's [rows x 128] bf16 outputs in shared memory
// and writes them in 16-byte pieces.  No split over D: one block sums each
// output, in a fixed order, so a launch repeats its bits.
//
// int8 pages on the tensor cores.  int8 values are exact in bf16, so the
// bf16 products compute the same function.  No tile is shared between
// warps (each owns its columns), so the conversion happens in registers as
// each warp reads its fragments: one ldmatrix.x4.trans of the int8 tile
// taken as b16 pairs of adjacent columns gives a thread bytes (d, f), (d,
// f+1), (d+1, f), (d+1, f+1); the even columns form one m-tile's A
// fragment and the odd ones the other's, each pair converted exactly
// (2^23 + byte - (2^23 + 128) in f32, whose top half is the bf16 value).
// A warp's two m-tiles are thus its 16 even and 16 odd columns.  The page
// scale multiplies the f32 sums in the epilogue.
//
// Which instance.  kernels/moe_gmm.py's gmm_instance() decides by shape,
// never by a failure: the tensor cores take bf16 x with D % 8 == 0 (x's
// rows in 16-byte pieces), F % 8 == 0 (bf16 pages) or F % 16 == 0 (int8),
// and x and the pool 16-byte aligned; every served shape qualifies (D, F in
// {768, 1408, 2048}).  Everything else runs the CUDA-core kernels below.
//
// Design, f32 x and ragged shapes: CUDA cores, the kernels of the first
// port (f32 is the parity type, and tensor cores would need TF32, another
// function).  bf16/f32 pages: one block of BF = 128 threads per (F tile,
// expert), thread f owning output column f for CT rows per pass over the
// page (CT = 1, 4 or 8); x[e] staged through shared memory DT columns at a
// time.  int8 pages: each lane owns 4 adjacent columns read by one char4
// load (F % 4 == 0 and a 4-byte aligned pool, else byte loads), a block of
// 8 warps over 128 columns, each warp streaming its own eighth of the
// page's rows with 16 loads in flight, the CT rows of x[e] in f32 shared
// memory, the 8 partial sums added in warp order.  These walk the page once
// per CT rows.
//
// Every launch with more than 48 KB of dynamic shared memory opts in once
// per instance and device, not once per launch.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's kernels
// phase, each launch after an L2 flush): bf16 pages 0.1474 ms at qwen3's
// wi, C = 1 (bound 120.4 us, torch.bmm over gathered pages 0.1430), 0.1509
// at a chunk's C = 10, 0.1966 at deepseek-v2-lite's C = 120 (bound 126.0
// us, torch.bmm 0.1664); int8 pages 0.0861 and 0.0908 ms at C = 1 and 10
// (bound 60.3 us).  Timed on the way (tools/torch_gmm_variants.py, the
// same card): int8 pages with 4 stages 0.1044 ms at wi, C = 1 (5 blocks an
// SM: 1.16 waves); tiles of 256 columns within 2 % at every shape; 2, 3
// (bf16) or 5 stages and k-tiles of 128 at most 4 % faster at one shape
// and 4-16 % slower at another (2 stages 0.1565 at bf16 C = 1, k-tiles of
// 128 0.2255 at C = 120); int8 tiles converted to bf16 once in shared
// memory 0.1124 (a store, a load and a barrier more, and no warp shares
// the tile); int8 pairs converted by two bit masks and a bf16x2 add (7
// instructions for 4 bytes, not 11) 0.3-1.4 % slower, so the conversion
// does not bound the int8 kernel; a CUDA-core GEMV with 16-byte loads at
// C = 1, 0.1433 bf16 (3 % faster) but 0.1119 int8 (30 % slower).  The
// tensor cores take C = 1 too: one kernel for every C, 3 % off at bf16
// decode.
//
// Known gaps: experts that received no token still stream their page (at
// decode 8 tokens x top-8 reach at most 64 of qwen3's 128 experts; skipping
// needs the dispatch's counts and changes the bound's byte count); the
// products run on mma.sync, not wgmma, and at C = 120 the tensor cores'
// time does not hide under the page stream (0.1966 ms against 126 us of
// pages and about 50 us of products at the peak rate).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int MAX_DEVICES = 64;   // devices a process may launch on

// Opt the kernel in to `smem` bytes of dynamic shared memory on the current
// device, once: `limit` is the launch template's own per-device record of
// the opt-in (0 until the first launch there).
int opt_in(const void* kernel, std::atomic<int>* limit, size_t smem) {
  if (smem <= 48 * 1024) return 0;
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
  return 0;
}

// ------------------------------------------------- bf16 x, tensor cores

constexpr int FT = 128;                 // page columns a block
constexpr int KT = 64;                  // depth a k-tile
constexpr int ROWS = 128;               // x rows a block at most (NT <= 16)
constexpr int MMA_WARPS = FT / 32;      // a warp per 32 columns
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int X_ROW = KT * 2 + 16;      // bytes of a staged x row
constexpr int O_ROW = FT + 8;           // bf16 values of a staged out row

// shared-memory layout of an instance: W the page's storage type
template <typename W, int NT>
struct Ring {
  static constexpr int W_ROW = FT * (int)sizeof(W) + 16;   // bytes
  static constexpr int W_TILE = KT * W_ROW;
  static constexpr int X_TILE = NT * 8 * X_ROW;
  static constexpr int STAGE = W_TILE + X_TILE;
  // int8 pages: 3 stages, so that 7 blocks fit an SM at NT = 1 and
  // qwen3's 768 blocks of wi run in one wave (4 stages: 5 an SM, 1.16 waves)
  static constexpr int STAGES = NT >= 16 || sizeof(W) == 1 ? 3 : 4;
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(BYTES >= NT * 8 * O_ROW * 2, "the out tile fits the ring");
};

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

// D += A B on the tensor cores: m16n8k16, bf16 in, f32 sums
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

// four int8 bytes b0..b3 of a word as two bf16 pairs, exactly: (b0, b2)
// and (b1, b3), the first of each in the low half.  Each byte, offset to
// unsigned, goes into the mantissa of 2^23 (one byte_perm), 2^23 + 128
// comes off, and the f32 result's top half is its bf16 value.
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& even,
                                          uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
           8388736.f;
  even = __byte_perm(__float_as_uint(x[0]), __float_as_uint(x[2]), 0x7632u);
  odd = __byte_perm(__float_as_uint(x[1]), __float_as_uint(x[3]), 0x7632u);
}

// grid (row blocks of NT * 8, ceil(F / FT), E), MMA_THREADS threads;
// dynamic shared memory: Ring<W, NT>::BYTES.  W: the page's storage type,
// bf16, or int8_t with f32 scales [P] (null otherwise).
template <typename W, int NT>
__global__ void __launch_bounds__(MMA_THREADS) mma_gmm_kernel(
    const int32_t* __restrict__ table, const __nv_bfloat16* __restrict__ x,
    const W* __restrict__ pool, const float* __restrict__ scales,
    __nv_bfloat16* __restrict__ out, int C, int D, int F, int P) {
  constexpr bool QUANT = std::is_same<W, int8_t>::value;
  using R = Ring<W, NT>;
  constexpr int VALS = 16 / (int)sizeof(W);      // page values a piece
  constexpr int W_PIECES = FT / VALS;            // 16-byte pieces a row
  static_assert(KT * W_PIECES % MMA_THREADS == 0, "whole copies a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * NT * 8;
  const int f0 = blockIdx.y * FT;
  const int e = blockIdx.z;
  const int nrows = min(NT * 8, C - c0);
  int page = table[e];
  page = min(max(page, 0), P - 1);
  const W* wpage = pool + (size_t)page * D * F;
  const __nv_bfloat16* xe = x + ((size_t)e * C + c0) * D;
  const int ktiles = (D + KT - 1) / KT;

  // x rows past C: zero in every stage, never copied
  for (int idx = tid; idx < R::STAGES * (NT * 8 - nrows) * (X_ROW / 16);
       idx += MMA_THREADS) {
    const int per = (NT * 8 - nrows) * (X_ROW / 16);
    const int s = idx / per, rest = idx - s * per;
    const int r = nrows + rest / (X_ROW / 16), q = rest % (X_ROW / 16);
    *reinterpret_cast<uint4*>(smem + s * R::STAGE + R::W_TILE + r * X_ROW +
                              q * 16) = make_uint4(0, 0, 0, 0);
  }

  auto load = [&](int kt, int s) {
    unsigned char* ws = smem + s * R::STAGE;
    unsigned char* xs = ws + R::W_TILE;
    const int d0 = kt * KT;
#pragma unroll
    for (int i = 0; i < KT * W_PIECES / MMA_THREADS; ++i) {
      const int p = tid + i * MMA_THREADS;
      const int r = p / W_PIECES, q = p % W_PIECES;
      const int d = d0 + r, f = f0 + q * VALS;
      const bool ok = d < D && f < F;
      cp_async16(ws + r * R::W_ROW + q * 16,
                 ok ? wpage + (size_t)d * F + f : wpage, ok);
    }
    for (int p = tid; p < nrows * (KT / 8); p += MMA_THREADS) {
      const int r = p / (KT / 8), q = p % (KT / 8);
      const int d = d0 + q * 8;
      const bool ok = d < D;
      cp_async16(xs + r * X_ROW + q * 16, ok ? xe + (size_t)r * D + d : xe,
                 ok);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  // lane offsets of the fragments: A's rows (depth) and columns, B's rows
  const int a_row = (lane >> 4) * 8 + (lane & 7);
  const int a_col = QUANT ? warp * 32 + ((lane >> 3) & 1) * 16
                          : (warp * 32 + ((lane >> 3) & 1) * 8) * 2;
  const int b_off = (NT == 1 ? (lane & 7) : (lane >> 4) * 8 + (lane & 7)) *
                        X_ROW + ((lane >> 3) & 1) * 16;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<R::STAGES - 2>();   // tile kt has landed
    __syncthreads();                  // ... for every thread; and the stage
                                      // the next copy fills is free
    const int nk = kt + R::STAGES - 1;
    if (nk < ktiles) load(nk, nk % R::STAGES);
    cp_async_commit();
    const unsigned char* ws = smem + (kt % R::STAGES) * R::STAGE;
    const unsigned char* xs = ws + R::W_TILE;
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {
      uint32_t a[2][4];
      const unsigned char* arow = ws + (ks * 16 + a_row) * R::W_ROW + a_col;
      if constexpr (QUANT) {
        // columns 2i and 2i + 1 as b16 pairs: even columns m-tile 0, odd 1
        uint32_t r[4];
        ldmatrix_x4_trans(r, arow);
#pragma unroll
        for (int i = 0; i < 4; ++i) i8x4_bf16(r[i], a[0][i], a[1][i]);
      } else {
        ldmatrix_x4_trans(a[0], arow);
        ldmatrix_x4_trans(a[1], arow + 16 * 2);
      }
      const unsigned char* brow = xs + b_off + ks * 32;
      if constexpr (NT == 1) {
        uint32_t b[2];
        ldmatrix_x2(b, brow);
        mma_bf16(acc[0][0], a[0], b[0], b[1]);
        mma_bf16(acc[1][0], a[1], b[0], b[1]);
      } else {
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t b[4];
          ldmatrix_x4(b, brow + jp * 16 * X_ROW);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][2 * jp], a[m], b[0], b[1]);
            mma_bf16(acc[m][2 * jp + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  }

  // epilogue: scale, round once, stage [rows][FT] in shared memory, write
  // 16-byte pieces
  cp_async_wait<0>();
  __syncthreads();
  const float s = QUANT ? scales[page] : 1.f;
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = j * 8 + 2 * t + (i & 1);
        const int half = i >> 1;       // accumulator rows g or g + 8
        const int col = QUANT ? warp * 32 + half * 16 + 2 * g + m
                              : warp * 32 + m * 16 + half * 8 + g;
        os[c * O_ROW + col] =
            __float2bfloat16(QUANT ? acc[m][j][i] * s : acc[m][j][i]);
      }
  __syncthreads();
  for (int p = tid; p < nrows * (FT / 8); p += MMA_THREADS) {
    const int r = p / (FT / 8), q = p % (FT / 8);
    const int f = f0 + q * 8;
    if (f < F)
      *reinterpret_cast<uint4*>(out + ((size_t)e * C + c0 + r) * F + f) =
          *reinterpret_cast<const uint4*>(os + r * O_ROW + q * 8);
  }
}

template <typename W, int NT>
int launch_mma(const void* table, const void* x, const void* pool,
               const void* scales, void* out, int E, int C, int D, int F,
               int P, cudaStream_t stream) {
  auto kernel = mma_gmm_kernel<W, NT>;
  constexpr size_t smem = Ring<W, NT>::BYTES;
  static std::atomic<int> limit[MAX_DEVICES];
  const int rc = opt_in(reinterpret_cast<const void*>(kernel), limit, smem);
  if (rc) return rc;
  const dim3 grid((C + NT * 8 - 1) / (NT * 8), (F + FT - 1) / FT, E);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const int32_t*>(table),
      static_cast<const __nv_bfloat16*>(x), static_cast<const W*>(pool),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out), C,
      D, F, P);
  return (int)cudaGetLastError();
}

// the least instance whose n-tiles cover min(C, ROWS) rows
static_assert(ROWS == 16 * 8, "the largest instance covers ROWS rows");
template <typename W>
int by_rows(const void* table, const void* x, const void* pool,
            const void* scales, void* out, int E, int C, int D, int F, int P,
            cudaStream_t s) {
  if (C <= 8)
    return launch_mma<W, 1>(table, x, pool, scales, out, E, C, D, F, P, s);
  if (C <= 16)
    return launch_mma<W, 2>(table, x, pool, scales, out, E, C, D, F, P, s);
  if (C <= 32)
    return launch_mma<W, 4>(table, x, pool, scales, out, E, C, D, F, P, s);
  if (C <= 64)
    return launch_mma<W, 8>(table, x, pool, scales, out, E, C, D, F, P, s);
  return launch_mma<W, 16>(table, x, pool, scales, out, E, C, D, F, P, s);
}

// ------------------------------------------ f32 x or ragged, CUDA cores

constexpr int BF = 128;  // output columns per block, one per thread
constexpr int DT = 256;  // contraction slab of x staged in shared memory

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

// grid (ceil(F / BF), E); CT token rows per pass over the page.
template <typename T, int CT>
__global__ void __launch_bounds__(BF) paged_gmm_kernel(
    const int32_t* __restrict__ table, const T* __restrict__ x,
    const T* __restrict__ pool, T* __restrict__ out, int C, int D, int F,
    int P) {
  __shared__ float xs[CT][DT];
  const int e = blockIdx.y;
  const int f = blockIdx.x * BF + threadIdx.x;
  int page = table[e];
  page = min(max(page, 0), P - 1);
  const T* w = pool + (size_t)page * D * F;
  const T* xe = x + (size_t)e * C * D;

  for (int c0 = 0; c0 < C; c0 += CT) {
    const int nc = min(CT, C - c0);
    float acc[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[c] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DT) {
      const int nd = min(DT, D - d0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < CT * DT; idx += BF) {
        const int c = idx / DT, d = idx - (idx / DT) * DT;
        xs[c][d] = (c < nc && d < nd)
                       ? to_f32(xe[(size_t)(c0 + c) * D + d0 + d])
                       : 0.f;
      }
      __syncthreads();
      if (f < F) {
        const T* wp = w + (size_t)d0 * F + f;
#pragma unroll 8
        for (int d = 0; d < nd; ++d) {
          const float wv = to_f32(wp[(size_t)d * F]);
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[c] = fmaf(xs[c][d], wv, acc[c]);
        }
      }
    }
    if (f < F) {
#pragma unroll
      for (int c = 0; c < CT; ++c)
        if (c < nc) out[((size_t)e * C + c0 + c) * F + f] = from_f32<T>(acc[c]);
    }
  }
}

constexpr int QWARPS = 8;          // warps splitting the contraction
constexpr int QTHREADS = 32 * QWARPS;
constexpr int QBF = 128;           // output columns per block: 32 lanes x 4

size_t quant_smem_bytes(int CT, int D) {
  return sizeof(float) * ((size_t)CT * D + (size_t)QWARPS * CT * QBF);
}

// grid (ceil(F / QBF), E); CT token rows per pass over the page; dynamic
// shared memory: quant_smem_bytes(CT, D).  VEC: char4 loads, 4-byte aligned
// (F % 4 == 0 and an aligned pool); else byte loads, the F edge masked per
// column.
// min blocks 1: the CT = 8 accumulators and 16 loads in flight need more
// than the registers nvcc would leave a thread if it aimed at two blocks
template <typename T, int CT, bool VEC>
__global__ void __launch_bounds__(QTHREADS, 1) quant_paged_gmm_kernel(
    const int32_t* __restrict__ table, const T* __restrict__ x,
    const int8_t* __restrict__ pool, const float* __restrict__ scales,
    T* __restrict__ out, int C, int D, int F, int P) {
  extern __shared__ float qsmem[];
  float* xs = qsmem;                    // [CT][D] this pass's x rows, f32
  float* part = qsmem + CT * D;         // [QWARPS][CT][QBF] partial sums
  const int e = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * QBF + lane * 4;
  int page = table[e];
  page = min(max(page, 0), P - 1);
  const float s = scales[page];
  const int8_t* wp = pool + (size_t)page * D * F + f0;
  const T* xe = x + (size_t)e * C * D;
  // each warp streams its own contiguous range of the page's rows
  const int rpw = (D + QWARPS - 1) / QWARPS;
  const int r0 = warp * rpw, r1 = min(r0 + rpw, D);

  for (int c0 = 0; c0 < C; c0 += CT) {
    const int nc = min(CT, C - c0);
    __syncthreads();            // the previous pass's readers are done
    for (int idx = threadIdx.x; idx < CT * D; idx += QTHREADS) {
      const int c = idx / D;
      xs[idx] = c < nc ? to_f32(xe[(size_t)c0 * D + idx]) : 0.f;
    }
    __syncthreads();
    float acc[CT][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
    if (VEC) {
      if (f0 < F) {             // F % 4 == 0: all 4 columns are in range
        // 16 row loads in flight per lane
#pragma unroll 16
        for (int d = r0; d < r1; ++d) {
          const char4 wv =
              __ldg(reinterpret_cast<const char4*>(wp + (size_t)d * F));
          const float w4[4] = {static_cast<float>(wv.x),
                               static_cast<float>(wv.y),
                               static_cast<float>(wv.z),
                               static_cast<float>(wv.w)};
#pragma unroll
          for (int c = 0; c < CT; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[c][j] = fmaf(xs[c * D + d], w4[j], acc[c][j]);
        }
      }
    } else {
      for (int d = r0; d < r1; ++d) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float wj = f0 + j < F
                               ? static_cast<float>(wp[(size_t)d * F + j])
                               : 0.f;
#pragma unroll
          for (int c = 0; c < CT; ++c)
            acc[c][j] = fmaf(xs[c * D + d], wj, acc[c][j]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[(warp * CT + c) * QBF + lane * 4 + j] = acc[c][j];
    __syncthreads();
    // the QWARPS partial sums in warp order (deterministic), then the page
    // scale and the one rounding
    for (int idx = threadIdx.x; idx < nc * QBF; idx += QTHREADS) {
      const int c = idx / QBF, col = idx - (idx / QBF) * QBF;
      const int f = blockIdx.x * QBF + col;
      if (f < F) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < QWARPS; ++k) sum += part[(k * CT + c) * QBF + col];
        out[((size_t)e * C + c0 + c) * F + f] = from_f32<T>(sum * s);
      }
    }
  }
}

template <typename T, int CT, bool VEC>
int launch_quant_ct(const int32_t* t, const T* xp, const int8_t* pp,
                    const float* sp, T* op, int E, int C, int D, int F, int P,
                    cudaStream_t stream) {
  auto kernel = quant_paged_gmm_kernel<T, CT, VEC>;
  const size_t smem = quant_smem_bytes(CT, D);
  static std::atomic<int> limit[MAX_DEVICES];
  const int rc = opt_in(reinterpret_cast<const void*>(kernel), limit, smem);
  if (rc) return rc;
  const dim3 grid((F + QBF - 1) / QBF, E);
  kernel<<<grid, QTHREADS, smem, stream>>>(t, xp, pp, sp, op, C, D, F, P);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_quant_vec(const int32_t* t, const T* xp, const int8_t* pp,
                     const float* sp, T* op, int E, int C, int D, int F,
                     int P, cudaStream_t stream) {
  if (C == 1)
    return launch_quant_ct<T, 1, VEC>(t, xp, pp, sp, op, E, C, D, F, P,
                                      stream);
  if (C <= 4)
    return launch_quant_ct<T, 4, VEC>(t, xp, pp, sp, op, E, C, D, F, P,
                                      stream);
  return launch_quant_ct<T, 8, VEC>(t, xp, pp, sp, op, E, C, D, F, P, stream);
}

template <typename T>
int launch_quant(const void* table, const void* x, const void* pool,
                 const void* scales, void* out, int E, int C, int D, int F,
                 int P, int vec, cudaStream_t stream) {
  const int32_t* t = static_cast<const int32_t*>(table);
  const T* xp = static_cast<const T*>(x);
  const int8_t* pp = static_cast<const int8_t*>(pool);
  const float* sp = static_cast<const float*>(scales);
  T* op = static_cast<T*>(out);
  return vec ? launch_quant_vec<T, true>(t, xp, pp, sp, op, E, C, D, F, P,
                                         stream)
             : launch_quant_vec<T, false>(t, xp, pp, sp, op, E, C, D, F, P,
                                          stream);
}

template <typename T>
int launch(const void* table, const void* x, const void* pool, void* out,
           int E, int C, int D, int F, int P, cudaStream_t stream) {
  const dim3 grid((F + BF - 1) / BF, E);
  const int32_t* t = static_cast<const int32_t*>(table);
  const T* xp = static_cast<const T*>(x);
  const T* pp = static_cast<const T*>(pool);
  T* op = static_cast<T*>(out);
  if (C == 1)
    paged_gmm_kernel<T, 1><<<grid, BF, 0, stream>>>(t, xp, pp, op, C, D, F, P);
  else if (C <= 4)
    paged_gmm_kernel<T, 4><<<grid, BF, 0, stream>>>(t, xp, pp, op, C, D, F, P);
  else
    paged_gmm_kernel<T, 8><<<grid, BF, 0, stream>>>(t, xp, pp, op, C, D, F, P);
  return (int)cudaGetLastError();
}

// instances (kernels/moe_gmm.py's INSTANCES)
constexpr int FMA = 0;          // CUDA cores; int8 pages by byte loads
constexpr int FMA_CHAR4 = 1;    // CUDA cores, int8 pages by char4 loads
constexpr int MMA = 2;          // tensor cores, bf16 x

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, pool and out share it).  instance:
// 0 = CUDA cores, 2 = tensor cores (bf16 only: D % 8 == 0, F % 8 == 0, x
// and pool 16-byte aligned).  Returns cudaGetLastError() after the launch
// (0 on success).  Allocates nothing and does not synchronise.
int paged_gmm_launch(int dtype, const void* table, const void* x,
                     const void* pool, void* out, int E, int C, int D, int F,
                     int P, int instance, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == MMA) {
    if (dtype != 1 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
    return by_rows<__nv_bfloat16>(table, x, pool, nullptr, out, E, C, D, F,
                                  P, s);
  }
  if (instance != FMA) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(table, x, pool, out, E, C, D, F, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, x, pool, out, E, C, D, F, P, s);
  return (int)cudaErrorInvalidValue;
}

// int8 pool [P,D,F] with f32 scales [P]; x and out of type dtype (0 =
// float32, 1 = bfloat16).  instance: 0 = CUDA cores, byte loads; 1 = CUDA
// cores, char4 loads (F % 4 == 0, the pool 4-byte aligned); 2 = tensor
// cores (bf16 x, D % 8 == 0, F % 16 == 0, x and pool 16-byte aligned).
int quant_paged_gmm_launch(int dtype, const void* table, const void* x,
                           const void* pool, const void* scales, void* out,
                           int E, int C, int D, int F, int P, int instance,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == MMA) {
    if (dtype != 1 || D % 8 || F % 16) return (int)cudaErrorInvalidValue;
    return by_rows<int8_t>(table, x, pool, scales, out, E, C, D, F, P, s);
  }
  if (instance != FMA && instance != FMA_CHAR4)
    return (int)cudaErrorInvalidValue;
  const int vec = instance == FMA_CHAR4;
  if (dtype == 0)
    return launch_quant<float>(table, x, pool, scales, out, E, C, D, F, P,
                               vec, s);
  if (dtype == 1)
    return launch_quant<__nv_bfloat16>(table, x, pool, scales, out, E, C, D,
                                       F, P, vec, s);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
