// KV-block gather for Hopper (sm_90a): compacts the pool pages named by an
// index list into one contiguous buffer, the device half of the D2H
// offload snapshot.
//
// Replaces the TPU kernel repro/kernels/block_gather.py `block_gather`
// (one DMA per page through a scalar-prefetched index map).  The pool is
// seen as (planes, N, row): row = one page's bytes, planes = the axes in
// front of the block axis.  out[i, p] = pool[p, idx[i]], so out is
// (n, planes, row).  planes = 1 is the JAX form, pool (P, page, Hkv, hd)
// -> (n, page, Hkv, hd); the port's pool (L, 2, N, bs, Hkv, hd) is
// gathered in one launch with planes = L*2 into the (n, L, 2, bs, Hkv,
// hd) snapshot the D2H lane copies as one contiguous run.
//
// What bounds it on the card: memory bandwidth, 2 * n * planes * row
// bytes (each gathered page read once and written once) over 3.35 TB/s;
// it does no arithmetic.
//
// What the design does about it: one thread block per (i, p) pair copies
// one page with 16-byte loads and stores (uint4), neighbouring threads on
// neighbouring addresses; a page whose size or base is not 16-byte
// aligned is copied a byte at a time.  The block reads its index itself
// (this replaces the TPU's scalar prefetch).  The wrapper checks every
// index against N on the host before the launch.
//
// The kernel launches on the caller's stream, allocates nothing, and the
// C entry point returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const unsigned char* __restrict__ pool,
              const int* __restrict__ idx, unsigned char* __restrict__ out,
              int planes, long long N, long long row) {
  const long long i = blockIdx.x / planes;
  const long long p = blockIdx.x % planes;
  const unsigned char* src = pool + (p * N + idx[i]) * row;
  unsigned char* dst = out + (i * planes + p) * row;
  if (VEC) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long k = threadIdx.x; k < row / 16; k += THREADS) d[k] = s[k];
  } else {
    for (long long k = threadIdx.x; k < row; k += THREADS) dst[k] = src[k];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// pool (planes, N, row bytes) contiguous; idx (n,) int32 in [0, N); out
// (n, planes, row bytes).
extern "C" int proserve_block_gather(const void* pool, const void* idx,
                                     void* out, int n, int planes,
                                     long long N, long long row_bytes,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || planes <= 0 || row_bytes <= 0) return cudaSuccess;
  const long long blocks = static_cast<long long>(n) * planes;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* src = static_cast<const unsigned char*>(pool);
  const int* ip = static_cast<const int*>(idx);
  unsigned char* dst = static_cast<unsigned char*>(out);
  if (row_bytes % 16 == 0 && aligned16(pool) && aligned16(out))
    gather_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
        src, ip, dst, planes, N, row_bytes);
  else
    gather_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
        src, ip, dst, planes, N, row_bytes);
  return cudaGetLastError();
}
