// In-place one-row write into the slot-contiguous KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel kv_cache_write
// (src/repro/kernels/kv_write.py:37).
//
// What it computes.  cache [B,S,KVH,hd]; new [B,KVH,hd] of the cache's
// type; pos [B] int32.  cache[b, pos[b]] = new[b] for every b with
// 0 <= pos[b] < S; a position outside [0, S) writes nothing, as JAX's
// .at[].set(mode="drop") drops it.  The cache is updated in place, as the
// Pallas kernel's aliased output is: no other byte of it is read or
// written.
//
// Bound on an H100.  The B rows of new are read once and written once:
// 2 * B * KVH * hd * itemsize bytes (16 KiB at B=8, KVH=4, hd=128 in
// bf16), about 5 ns at 3.35 TB/s -- far below the launch latency, so one
// launch is the cost.
//
// Design.  One block per row b.  The row is copied as raw bytes, 16 bytes
// per thread and load when the row size and both addresses allow it (the
// wrapper checks), else byte by byte; the kernel is the same for every
// dtype.  It runs on the caller's stream, allocates nothing and needs no
// host synchronisation: the position is read on the device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS) kv_cache_write_kernel(
    char* __restrict__ cache, const char* __restrict__ src,
    const int32_t* __restrict__ pos, int S, long long row_bytes, int vec) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (p < 0 || p >= S) return;
  char* dst = cache + ((long long)b * S + p) * row_bytes;
  const char* in = src + (long long)b * row_bytes;
  if (vec) {
    const long long n = row_bytes / 16;
    for (long long i = threadIdx.x; i < n; i += THREADS)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(in)[i];
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += THREADS)
      dst[i] = in[i];
  }
}

}  // namespace

extern "C" {

// cache [B,S,row_bytes] and src [B,row_bytes] as raw bytes; pos [B] int32.
// vec = 1: row_bytes % 16 == 0 and both pointers 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 on success).  Allocates nothing
// and does not synchronise.
int kv_cache_write_launch(void* cache, const void* src, const void* pos,
                          int B, int S, long long row_bytes, int vec,
                          void* stream) {
  if (B <= 0) return 0;
  kv_cache_write_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(cache), static_cast<const char*>(src),
      static_cast<const int32_t*>(pos), S, row_bytes, vec);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
