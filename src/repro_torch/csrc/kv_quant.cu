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
// floats and writes E bytes per row (about 1 flop per byte); dequantize
// reads E bytes and writes E floats.  The bound is those bytes over
// 3.35 TB/s.
//
// What the design does about it:
//  * Quantize: one thread block per row, two passes over the row, each a
//    single read.  Pass 1 reduces the absmax with 16-byte loads (float4,
//    or 4 bf16 as 8 bytes), a warp shuffle and a shared-memory step over
//    the warps; pass 2 rereads the row (a 64 KiB fp32 row at
//    Qwen1.5-0.5B widths is still in L2) and writes 4 int8 per thread
//    per step as one char4.
//  * Dequantize: one thread block per row, char4 loads and float4 stores,
//    the row's scale read once.
//  * Rows whose length or base is not 16-byte aligned take a scalar loop.
//
// The kernels launch on the caller's stream, allocate nothing, and each
// C entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// the double 1/127 rounded once to fp32, as the reference computes it
constexpr float INV_127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive values of a row as fp32 (p is 16-byte aligned for
// float, 8-byte aligned for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

__device__ __forceinline__ signed char quant(float x, float inv) {
  const float r = fminf(fmaxf(rintf(x * inv), -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(r));
}

// Max over the block; every thread gets the result.
__device__ float block_max(float v) {
  __shared__ float warp_max[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = lane < THREADS / 32 ? warp_max[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, signed char* __restrict__ vals,
                float* __restrict__ scales, long long E) {
  const long long row = blockIdx.x;
  const T* xr = x + row * E;
  signed char* qr = vals + row * E;

  float amax = 0.0f;
  if (VEC) {
    for (long long i = 4LL * threadIdx.x; i < E; i += 4LL * THREADS) {
      const float4 v = load4(xr + i);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (long long i = threadIdx.x; i < E; i += THREADS)
      amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  }
  amax = block_max(amax);
  const float scale = amax * INV_127;
  const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
  if (threadIdx.x == 0) scales[row] = scale;

  if (VEC) {
    for (long long i = 4LL * threadIdx.x; i < E; i += 4LL * THREADS) {
      const float4 v = load4(xr + i);
      char4 q;
      q.x = quant(v.x, inv);
      q.y = quant(v.y, inv);
      q.z = quant(v.z, inv);
      q.w = quant(v.w, inv);
      *reinterpret_cast<char4*>(qr + i) = q;
    }
  } else {
    for (long long i = threadIdx.x; i < E; i += THREADS)
      qr[i] = quant(to_f32(xr[i]), inv);
  }
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

template <typename T>
cudaError_t launch_quantize(const void* x, void* vals, void* scales, int R,
                            long long E, cudaStream_t st) {
  const bool vec = E % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(vals, 4);
  const T* xp = static_cast<const T*>(x);
  signed char* qp = static_cast<signed char*>(vals);
  float* sp = static_cast<float*>(scales);
  if (vec)
    quantize_kernel<T, true><<<R, THREADS, 0, st>>>(xp, qp, sp, E);
  else
    quantize_kernel<T, false><<<R, THREADS, 0, st>>>(xp, qp, sp, E);
  return cudaGetLastError();
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
  if (dtype == 0) return launch_quantize<float>(x, vals, scales, R, E, st);
  if (dtype == 1)
    return launch_quantize<__nv_bfloat16>(x, vals, scales, R, E, st);
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
