// Int8 KV-block quantize / dequantize for Hopper (sm_90a): the cold tier
// of the tiered KV store and the int8 wire of both copy lanes.
//
// Replaces the TPU kernels repro/kernels/kv_quant.py `kv_block_quantize`
// (body `_quant_kernel`) and `kv_block_dequantize` (body
// `_dequant_kernel`).  The input (n, L, 2, bs, Hkv, hd) is seen as R =
// n*L*2 plane rows of E = bs*Hkv*hd values; each row gets one fp32 scale:
//
//   scale = absmax(row) * fp32(1/127)
//   inv   = scale > 0 ? 1 / scale : 0
//   q     = clamp(round_half_even(x * inv), -127, 127)   as int8
//   x'    = q * scale                                    (dequantize)
//
// Both must be BITWISE equal to the plain versions (and so to the JAX
// kernels): absmax is exact in any order; the constant is the fp32 value
// of the double 1/127, as the reference's weak-typed Python float is;
// `1.0f / scale` is an IEEE division (the build has no --use_fast_math);
// rintf rounds half to even like jnp.round (roundf would round half away
// from zero).  No expression here can contract into an FMA.
//
// What bounds them on the card: memory bandwidth.  Quantize reads E
// values and writes E bytes per row (about 1 flop per byte); dequantize
// reads E bytes and writes E floats.  The bound is those bytes over
// 3.35 TB/s.
//
// What the design does about it:
//  * Quantize reads each row once from HBM.  A row is split into slices of
//    THREADS * NV 16-byte vectors (4096 fp32 or 8192 bf16 values: 256
//    threads x NV = 4 vectors, 16 KiB of fp32 in registers per block), and
//    its slices over a thread-block cluster of C blocks, C the power of two
//    >= the slices, at most MAX_CLUSTER = 8 (portable): C = 4 at
//    Qwen1.5-0.5B widths (E = 16384 fp32), 1 at ChatGLM3-6B's (E = 4096).
//    A thread issues all NV loads of its slice before it uses any (an
//    unrolled, fixed count), reduces the absmax with shuffles and shared
//    memory over the block, and the cluster's through distributed shared
//    memory: each block writes its max into its slot in every block of the
//    cluster (map_shared_rank), then one cluster barrier, so every block
//    reads the C maxima locally.  Then it quantizes from registers, with
//    no second read, and stores the int8 values of its NV adjacent vectors
//    as 16-byte stores where the row allows (E % 16 == 0), else one store
//    per vector; rank 0 writes the scale.  The max is exact in any order,
//    so the result stays bitwise.
//  * The grid holds as many clusters as the card runs at once (an
//    occupancy query, kept per device and C), and cluster k takes rows k,
//    k + n, ...: a block issues the loads of its next row's slice before
//    it reduces the current one, so the reduction, the cluster barrier and
//    the stores overlap the next read.  (A grid of one cluster per row,
//    with no lookahead, runs a wave of blocks per ~10 MB and is ~8 %
//    slower than a one-block-per-row two-pass kernel on a group of 8
//    Qwen1.5-0.5B blocks: tools/kv_quant_variants.py, PERF.md.)
//  * A row of more than MAX_CLUSTER slices (a kernel instance of its own):
//    block rank r takes slices r, r + C, ...; it keeps its first slice in
//    registers and reads the others twice (once for the max, once to
//    quantize).
//  * Dequantize: one thread block per row, char4 loads and float4 stores,
//    the row's scale read once.
//  * Rows whose length or base does not fit the 16-byte vectors (fp32 E %
//    4, bf16 E % 8, an unaligned base) take a scalar kernel, one block per
//    row, two passes.
//
// The kernels launch on the caller's stream, allocate nothing, and each
// C entry point returns cudaGetLastError() of its launch (cudaLaunchKernelEx
// for the cluster launch).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NV = 4;            // 16-byte vectors per thread and slice
constexpr int MAX_CLUSTER = 8;   // blocks per row, at most
constexpr unsigned FULL = 0xffffffffu;
// the double 1/127 rounded once to fp32, as the reference computes it
constexpr float INV_127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of a row: N values of type T
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float (&f)[N]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static void unpack(const Raw& r, float (&f)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};

__device__ __forceinline__ signed char quant(float x, float inv) {
  const float r = fminf(fmaxf(rintf(x * inv), -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(r));
}

// four int8 values as one little-endian word (value i in byte i)
__device__ __forceinline__ uint32_t quant4(const float* f, float inv) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w |= static_cast<uint32_t>(static_cast<uint8_t>(quant(f[i], inv)))
         << (8 * i);
  return w;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Max over the block; every thread gets the result.  Calls of alternate
// parity use separate slots, so two calls need no barrier between them.
__device__ float block_max(float v, int parity) {
  __shared__ float part[2][THREADS / 32];
  v = warp_max(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[parity][warp] = v;
  __syncthreads();
  return warp_max(lane < THREADS / 32 ? part[parity][lane] : 0.0f);
}

// Clusters of C blocks, as many as the card holds at once; cluster k
// quantizes rows k, k + n, ... (see the note at the top).  LONG: rows of
// more than C slices (a compile-time choice: the loops for them cost the
// other rows ~3 %, tools/kv_quant_variants.py).
template <typename T, bool LONG>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, signed char* __restrict__ vals,
                float* __restrict__ scales, int R, long long E, int C,
                int wide) {
  using V = Vec<T>;
  using Raw = typename V::Raw;
  constexpr int W = V::N / 4;  // int8 words per vector
  // the blocks' maxima, by parity of the row: a block may write its next
  // row's max before a slower peer has read this row's
  __shared__ float rank_max[2][MAX_CLUSTER];
  // a block writes into its peers' shared memory only once they run
  if (C > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);
  const int rank = blockIdx.x % C;
  const int n_clusters = gridDim.x / C;
  const long long n_vec = E / V::N;
  const int n_slices = (int)((n_vec + THREADS * NV - 1) / (THREADS * NV));
  // vector v of this thread in slice s: its NV vectors are adjacent
  auto vec_at = [&](int s, int v) {
    return ((long long)s * THREADS + threadIdx.x) * NV + v;
  };
  auto load = [&](long long row, int s, Raw (&r)[NV]) {
    const Raw* xr = reinterpret_cast<const Raw*>(x + row * E);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const long long i = vec_at(s, v);
      r[v] = i < n_vec ? __ldg(xr + i) : Raw{};
    }
  };
  auto abs_max = [&](const Raw (&r)[NV], float m) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float f[V::N];
      V::unpack(r[v], f);
#pragma unroll
      for (int k = 0; k < V::N; ++k) m = fmaxf(m, fabsf(f[k]));
    }
    return m;
  };
  auto store = [&](long long row, int s, const Raw (&r)[NV], float inv) {
    signed char* qr = vals + row * E;
    uint32_t w[NV][W];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float f[V::N];
      V::unpack(r[v], f);
#pragma unroll
      for (int j = 0; j < W; ++j) w[v][j] = quant4(f + 4 * j, inv);
    }
    const long long i0 = vec_at(s, 0);
    if constexpr (NV * W % 4 == 0) {
      if (wide && i0 + NV <= n_vec) {  // 16-byte aligned, all NV live
        const uint32_t* flat = &w[0][0];
        uint4* dst = reinterpret_cast<uint4*>(qr + i0 * V::N);
#pragma unroll
        for (int u = 0; u < NV * W / 4; ++u)
          dst[u] = make_uint4(flat[4 * u], flat[4 * u + 1], flat[4 * u + 2],
                              flat[4 * u + 3]);
        return;
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (i0 + v >= n_vec) break;
      if constexpr (W == 1)
        reinterpret_cast<uint32_t*>(qr)[i0 + v] = w[v][0];
      else
        reinterpret_cast<uint2*>(qr)[i0 + v] = make_uint2(w[v][0], w[v][1]);
    }
  };

  // cur: this block's first slice of the current row; nxt: of the next
  Raw cur[NV], nxt[NV];
  long long row = blockIdx.x / C;
  const bool has_slice = rank < n_slices;
  if (has_slice) load(row, rank, cur);
  for (int it = 0; row < R; ++it, row += n_clusters) {
    float amax = has_slice ? abs_max(cur, 0.0f) : 0.0f;
    // a row of more than C slices: this block's others, read for the max
    if constexpr (LONG) {
      for (int s = rank + C; s < n_slices; s += C) {
        load(row, s, nxt);
        amax = abs_max(nxt, amax);
      }
    }
    // the next row's loads are in flight through the reduction below
    if (has_slice && row + n_clusters < R) load(row + n_clusters, rank, nxt);
    amax = block_max(amax, it & 1);
    if (C > 1) {
      if (it == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      if (threadIdx.x == 0) {
        cg::cluster_group cluster = cg::this_cluster();
        for (int k = 0; k < C; ++k)
          *cluster.map_shared_rank(&rank_max[it & 1][rank], k) = amax;
      }
      cg::this_cluster().sync();
      amax = 0.0f;
      for (int k = 0; k < C; ++k) amax = fmaxf(amax, rank_max[it & 1][k]);
    }
    const float scale = amax * INV_127;
    const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
    if (rank == 0 && threadIdx.x == 0) scales[row] = scale;
    if (has_slice) {
      store(row, rank, cur, inv);
      // the other slices of a long row are read a second time
      if constexpr (LONG) {
        for (int s = rank + C; s < n_slices; s += C) {
          load(row, s, cur);
          store(row, s, cur, inv);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) cur[v] = nxt[v];
  }
}

// Rows that do not fit the vectors: one block per row, two passes.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_scalar_kernel(const T* __restrict__ x, signed char* __restrict__ vals,
                       float* __restrict__ scales, long long E) {
  const long long row = blockIdx.x;
  const T* xr = x + row * E;
  signed char* qr = vals + row * E;
  float amax = 0.0f;
  for (long long i = threadIdx.x; i < E; i += THREADS)
    amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  amax = block_max(amax, 0);
  const float scale = amax * INV_127;
  const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
  if (threadIdx.x == 0) scales[row] = scale;
  for (long long i = threadIdx.x; i < E; i += THREADS)
    qr[i] = quant(to_f32(xr[i]), inv);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const signed char* __restrict__ vals,
                  const float* __restrict__ scales, float* __restrict__ out,
                  long long E) {
  const long long row = blockIdx.x;
  const float scale = scales[row];
  const signed char* qr = vals + row * E;
  float* orow = out + row * E;
  if (VEC) {
    for (long long i = 4LL * threadIdx.x; i < E; i += 4LL * THREADS) {
      const char4 q = *reinterpret_cast<const char4*>(qr + i);
      *reinterpret_cast<float4*>(orow + i) =
          make_float4(static_cast<float>(q.x) * scale,
                      static_cast<float>(q.y) * scale,
                      static_cast<float>(q.z) * scale,
                      static_cast<float>(q.w) * scale);
    }
  } else {
    for (long long i = threadIdx.x; i < E; i += THREADS)
      orow[i] = static_cast<float>(qr[i]) * scale;
  }
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

// Clusters of C blocks of quantize_kernel<T, LONG> that a device runs at
// once.
template <typename T, bool LONG>
cudaError_t resident_clusters(int C, int device, int* n) {
  static std::atomic<int> known[64][MAX_CLUSTER + 1];
  std::atomic<int>& slot = known[device & 63][C];
  *n = slot.load();
  if (*n > 0) return cudaSuccess;
  const void* fn = reinterpret_cast<const void*>(quantize_kernel<T, LONG>);
  cudaError_t err;
  if (C == 1) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, fn, THREADS, 0);
    *n *= sms;
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(THREADS);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(n, fn, &cfg);
  }
  if (err != cudaSuccess) return err;
  if (*n < 1) return cudaErrorInvalidConfiguration;
  slot.store(*n);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* vals, void* scales, int R,
                            long long E, int device, cudaStream_t st) {
  constexpr int N = Vec<T>::N;
  const T* xp = static_cast<const T*>(x);
  signed char* qp = static_cast<signed char*>(vals);
  float* sp = static_cast<float*>(scales);
  if (E % N != 0 || !aligned(x, 16) || !aligned(vals, N)) {
    quantize_scalar_kernel<T><<<R, THREADS, 0, st>>>(xp, qp, sp, E);
    return cudaGetLastError();
  }
  const long long slices = (E / N + THREADS * NV - 1) / (THREADS * NV);
  int C = 1;
  while (C < slices && C < MAX_CLUSTER) C *= 2;
  const bool long_rows = slices > C;
  int clusters;
  cudaError_t err = long_rows
                        ? resident_clusters<T, true>(C, device, &clusters)
                        : resident_clusters<T, false>(C, device, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters > R) clusters = R;
  const int wide = E % 16 == 0 && aligned(vals, 16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * C));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = long_rows ? cudaLaunchKernelEx(&cfg, quantize_kernel<T, true>, xp, qp,
                                      sp, R, E, C, wide)
                  : cudaLaunchKernelEx(&cfg, quantize_kernel<T, false>, xp,
                                      qp, sp, R, E, C, wide);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 input.  x (R, E) contiguous; vals
// (R, E) int8; scales (R,) float32.
extern "C" int proserve_kv_quantize(int dtype, const void* x, void* vals,
                                    void* scales, int R, long long E,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R <= 0 || E <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quantize<float>(x, vals, scales, R, E, device, st);
  if (dtype == 1)
    return launch_quantize<__nv_bfloat16>(x, vals, scales, R, E, device, st);
  return cudaErrorInvalidValue;
}

// vals (R, E) int8; scales (R,) float32; out (R, E) float32.
extern "C" int proserve_kv_dequantize(const void* vals, const void* scales,
                                      void* out, int R, long long E,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R <= 0 || E <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const signed char* qp = static_cast<const signed char*>(vals);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  if (E % 4 == 0 && aligned(vals, 4) && aligned(out, 16))
    dequantize_kernel<true><<<R, THREADS, 0, st>>>(qp, sp, op, E);
  else
    dequantize_kernel<false><<<R, THREADS, 0, st>>>(qp, sp, op, E);
  return cudaGetLastError();
}
