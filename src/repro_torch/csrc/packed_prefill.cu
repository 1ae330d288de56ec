// Packed multi-request and per-request chunked prefill attention for
// Hopper (sm_90a): one kernel body, two C entry points.
//
// Replaces two TPU kernels of repro/kernels/chunked_prefill.py:
//  * `packed_prefill_attention` (body `_packed_kernel`), entry
//    proserve_packed_prefill: S segments (request chunks) of Sq queries
//    each attend to their staged caches (S, Smax, Hkv, hd).  Query row r of
//    segment s sits at absolute position ctx = ctx_lens[s] plus r.
//  * `chunked_prefill_attention` (body `_kernel`), entry
//    proserve_chunked_prefill: B requests' chunks against their contiguous
//    staged caches, with lengths that include the chunk, so query row r of
//    request b sits at ctx = cache_lens[b] - Sq plus r.
// Both see keys k_pos <= ctx + r (causal + length mask); keys past the
// causal horizon ctx + Sq - 1 are never visited.  The two entries differ
// only in the ctx_sub they pass (0 or Sq), so the JAX contract "packed
// equals S separate chunked calls bit for bit, with cache_lens = ctx_lens
// + Sq" holds on the card by construction.  A chunked row with ctx + r < 0
// (cache_lens < Sq) has no valid key: it keeps l = 0, acc = 0 and writes
// acc / max(l, 1e-30) = 0, as the TPU kernel does.
//
// What bounds it on the card: arithmetic.  A chunk of Sq queries against a
// context of n keys does about 4 * Sq * n * hd * G flops on
// 2 * n * hd * 4 bytes of K/V per kv head, i.e. O(Sq * G) flops per byte;
// for the engine's 64..512-token chunks that is far above the fp32 ridge.
// The kernel computes in fp32 FMA on the CUDA cores (no TF32: the engine
// is an fp32 parity mode), so its bound is the needed flops over the
// H100's 67 TFLOP/s fp32 rate.
//
// What the design does about it:
//  * One thread block per (tile of 64 of the G * Sq query rows, kv_head,
//    segment).  The rows of a kv group share each K/V tile, so a K/V value
//    loaded to shared memory feeds up to 64 rows.  Rows are ordered
//    g-major (row = g * Sq + r), as in the TPU kernel's (G * Sq) score tile.
//  * Two threads per query row, each holding half of the row's q and of its
//    output accumulator in registers, in interleaved 4-float chunks so the
//    pair reads adjacent 16-byte words of a shared K/V row (a broadcast, no
//    bank conflict).  A dot product is two half sums and one shuffle.
//  * K/V tiles of BK keys are loaded to shared memory by the whole block;
//    the loop stops at the block's causal horizon min(Smax, ctx + r_max + 1)
//    instead of the staged length, which is where the TPU kernel's tile
//    skip stops too.  Inside a tile, keys past a row's own horizon get
//    s = -1e30 and p = 0, a bitwise no-op on that row's softmax state.
//  * Math follows the TPU kernel: NEG_INF = -1e30, fp32 online softmax,
//    output acc / max(l, 1e-30).  The order of every sum depends only on
//    (ctx, r, hd), not on S or on the other segments of the pack.
//  * Static shared memory is 2 * BK * HD * 4 bytes <= 16 KB.
//
// Tensor cores (wgmma), TMA and bf16 storage are later work.  The kernel
// launches on the caller's stream, allocates nothing and the C entry point
// returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int BQ = THREADS / 2;  // query rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(THREADS)
packed_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ ctx_lens, T* __restrict__ out,
                      int Sq, int H, int Hkv, int Smax, int ctx_sub,
                      float scale) {
  constexpr int HALF = HD / 2;   // dims per thread
  constexpr int CHUNKS = HD / 8;  // 4-float chunks per thread
  const int seg = blockIdx.z;
  const int kvh = blockIdx.y;
  const int G = H / Hkv;
  const int rows = G * Sq;
  const int r0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = r0 + tid / 2;
  const int half = tid & 1;
  const bool active = row < rows;
  const int g = active ? row / Sq : 0;
  const int r = active ? row % Sq : 0;
  const int ctx = ctx_lens[seg] - ctx_sub;
  const int q_pos = ctx + r;

  // this thread owns dims 8c + 4*half + e, c < CHUNKS, e < 4
  const size_t q_off = (((size_t)seg * Sq + r) * H + kvh * G + g) * HD;
  float qr[HALF], acc[HALF];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * c + e] = active ? to_f32(q[q_off + 8 * c + 4 * half + e]) : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  // the block's causal horizon: the largest r among its rows
  const int last = min(r0 + BQ, rows) - 1;
  const int r_max = (last / Sq != r0 / Sq) ? Sq - 1 : last % Sq;
  // BK depends only on HD, so a row's tiles (and the order of its sums) do
  // not depend on which entry point launched it
  const int horizon = min(Smax - 1, ctx + r_max);
  const int n_tiles = horizon < 0 ? 0 : horizon / BK + 1;

  __shared__ __align__(16) float ks[BK][HD];
  __shared__ __align__(16) float vs[BK][HD];
  const size_t pos_stride = (size_t)Hkv * HD;
  const size_t kv_off = ((size_t)seg * Smax * Hkv + kvh) * HD;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD;
      const int d = idx % HD;
      const int kp = k0 + j;
      const bool in = kp < Smax;
      ks[j][d] = in ? to_f32(k[kv_off + kp * pos_stride + d]) : 0.f;
      vs[j][d] = in ? to_f32(v[kv_off + kp * pos_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[BK];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][4 * half]);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const float4 kv4 = kr[2 * c];
        part = fmaf(qr[4 * c + 0], kv4.x, part);
        part = fmaf(qr[4 * c + 1], kv4.y, part);
        part = fmaf(qr[4 * c + 2], kv4.z, part);
        part = fmaf(qr[4 * c + 3], kv4.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const bool valid = k0 + j <= q_pos && k0 + j < Smax;
      sc[j] = valid ? part * scale : NEG_INF;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const bool valid = k0 + j <= q_pos && k0 + j < Smax;
      sc[j] = valid ? expf(sc[j] - m_new) : 0.f;
      psum += sc[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][4 * half]);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const float4 v4 = vr[2 * c];
        acc[4 * c + 0] = fmaf(sc[j], v4.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(sc[j], v4.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(sc[j], v4.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(sc[j], v4.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (active) {
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(out + q_off + 8 * c + 4 * half + e, acc[4 * c + e] * inv_l);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* ctx_lens, void* out, int S, int Sq, int H,
                   int Hkv, int Smax, int ctx_sub, float scale,
                   cudaStream_t stream) {
  constexpr int BK = HD >= 128 ? 16 : 32;
  const int G = H / Hkv;
  dim3 grid((G * Sq + BQ - 1) / BQ, Hkv, S);
  packed_prefill_kernel<T, HD, BK><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ctx_lens, static_cast<T*>(out), Sq, H, Hkv,
      Smax, ctx_sub, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v,
                   const int* ctx_lens, void* out, int S, int Sq, int H,
                   int Hkv, int hd, int Smax, int ctx_sub, float scale,
                   cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, ctx_lens, out, S, Sq, H, Hkv, Smax,
                           ctx_sub, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, ctx_lens, out, S, Sq, H, Hkv, Smax,
                           ctx_sub, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, ctx_lens, out, S, Sq, H, Hkv, Smax,
                           ctx_sub, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, ctx_lens, out, S, Sq, H, Hkv, Smax,
                            ctx_sub, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ctx_sub: subtracted from each entry of lens to give the tokens cached
// before the chunk (0: lens are ctx_lens; Sq: lens are cache_lens).
cudaError_t run(int dtype, const void* q, const void* k, const void* v,
                const void* lens, void* out, int S, int Sq, int H, int Hkv,
                int hd, int Smax, int ctx_sub, float scale, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (S <= 0 || Sq <= 0) return cudaSuccess;
  if (Smax < 1 || Hkv < 1 || H % Hkv != 0 || S > 65535 || Hkv > 65535)
    return cudaErrorInvalidValue;
  const int* cl = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim<float>(q, k, v, cl, out, S, Sq, H, Hkv, hd, Smax, ctx_sub,
                         scale, st);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(q, k, v, cl, out, S, Sq, H, Hkv, hd, Smax,
                                 ctx_sub, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Shapes: q (S, Sq, H, hd); k/v (S, Smax, Hkv, hd); ctx_lens (S,) int32
// tokens cached before each chunk; out (S, Sq, H, hd).  All contiguous.
extern "C" int proserve_packed_prefill(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* ctx_lens, void* out, int S,
                                       int Sq, int H, int Hkv, int hd,
                                       int Smax, float scale, int device,
                                       void* stream) {
  return run(dtype, q, k, v, ctx_lens, out, S, Sq, H, Hkv, hd, Smax, 0, scale,
             device, stream);
}

// The same kernel for B single-request chunks: q (B, Sq, H, hd); k/v
// (B, Smax, Hkv, hd); cache_lens (B,) int32 tokens valid INCLUDING the
// chunk; out (B, Sq, H, hd).  All contiguous.
extern "C" int proserve_chunked_prefill(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* cache_lens, void* out,
                                        int B, int Sq, int H, int Hkv, int hd,
                                        int Smax, float scale, int device,
                                        void* stream) {
  return run(dtype, q, k, v, cache_lens, out, B, Sq, H, Hkv, hd, Smax, Sq,
             scale, device, stream);
}
