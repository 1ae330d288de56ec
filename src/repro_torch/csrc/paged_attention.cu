// Paged decode and packed speculative-verify attention for Hopper
// (sm_90a): one kernel body, two C entry points.
//
// Replaces two TPU kernels:
//  * repro/kernels/paged_attention.py `paged_decode_attention` (body
//    `_kernel`), entry proserve_paged_decode: one decode step for B
//    requests read straight off the paged KV pool, an online softmax in
//    fp32 over the pages of each request's block table, the G = H / Hkv
//    query heads of a kv group sharing every K/V load, positions >=
//    lengths[b] masked.
//  * repro/kernels/spec_verify.py `packed_verify_attention`, entry
//    proserve_packed_verify: the same for R verify rows, where row b reads
//    the table row row_seg[b] of a compact (S, maxp) table (all rows of a
//    request share its table) with its own length l_kv + j + 1.  As in the
//    TPU kernel this is the only change: row_seg is read where the table
//    row is chosen, and nothing else in the body differs, so each verify
//    row is bitwise the decode row run on tables[row_seg[b]].  The
//    choice is a template flag, so the decode instances compile as they
//    did without it.
//
// What bounds it on the card: memory bandwidth.  Each (request, kv head)
// reads len * hd * 2 K/V values once and does 4 * G * hd flops per cached
// position, about G/2 flops per byte at fp32, far below the H100's ~20
// flop/byte fp32 ridge.  The bound is the live K/V bytes over 3.35 TB/s.
//
// What the design does about it:
//  * One thread block per (b, kv_head).  The block reads the block-table
//    entries itself (this replaces the TPU's scalar prefetch) and walks only
//    the pages i < ceil(lengths[b] / page).  On the TPU the pages past the
//    length are a bitwise no-op (s = -1e30, alpha = 1, p = 0), so stopping
//    at the length computes the same function and moves no dead bytes.
//  * K and V are read once per kv group: the G query heads of the group are
//    held in registers by every lane, so one coalesced row load feeds G dot
//    products.  Lanes own the head dims d = lane + 32 t, so a row load is a
//    run of 128-byte transactions.
//  * Four warps split the pages round-robin (warp w takes pages w, w+4, ..)
//    so a short request still has four loads in flight, and their partial
//    softmax states are merged at the end in the fixed order w = 0..3.
//    The order of every sum depends only on (length, page, hd, G), never on
//    B or on the other rows of the batch: the packed verify kernel can reuse
//    this body and get the decode row's bits.
//  * Math follows the TPU kernel: NEG_INF = -1e30, fp32 online softmax,
//    p = 0 on masked positions, output acc / max(l, 1e-30).
//
// The kernel launches on the caller's stream, allocates nothing and the C
// entry point returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// D: head dims per lane (ceil(hd / 32)); GM: largest G this instance takes;
// ROW_SEG: verify (row b reads table row row_seg[b]) or decode (row b).
template <typename T, int D, int GM, bool ROW_SEG>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    const int* __restrict__ row_seg, T* __restrict__ out,
                    int H, int Hkv, int hd, int page, int maxp, float scale) {
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lengths[b];
  const int n_pages = min((len + page - 1) / page, maxp);
  // decode: row b's own table row; verify: its request's (row_seg[b])
  const int trow = ROW_SEG ? row_seg[b] : b;

  float qr[GM][D], acc[GM][D], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < D; ++t) {
      const int d = lane + 32 * t;
      qr[g][t] = (g < G && d < hd)
                     ? to_f32(q[((size_t)b * H + kvh * G + g) * hd + d])
                     : 0.f;
      acc[g][t] = 0.f;
    }
  }

  const size_t pos_stride = (size_t)Hkv * hd;
  for (int i = warp; i < n_pages; i += WARPS) {
    const int phys = tables[(size_t)trow * maxp + i];
    const size_t base = ((size_t)phys * page * Hkv + kvh) * hd;
    const T* kp = k_pages + base;
    const T* vp = v_pages + base;
    const int pos0 = i * page;

    // scores: lane j ends up holding position j's score for every head
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = NEG_INF;
#pragma unroll 4
    for (int j = 0; j < page; ++j) {
      float kd[D];
#pragma unroll
      for (int t = 0; t < D; ++t) {
        const int d = lane + 32 * t;
        kd[t] = d < hd ? to_f32(kp[j * pos_stride + d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < D; ++t) part = fmaf(qr[g][t], kd[t], part);
          part = warp_sum(part);
          if (lane == j) s[g] = part * scale;
        }
      }
    }

    // online softmax update over this page (lane j = position pos0 + j)
    const bool valid = lane < page && pos0 + lane < len;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float sg = valid ? s[g] : NEG_INF;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float alpha = expf(m[g] - m_new);
        const float p = valid ? expf(sg - m_new) : 0.f;
        l[g] = l[g] * alpha + warp_sum(p);
#pragma unroll
        for (int t = 0; t < D; ++t) acc[g][t] *= alpha;
        m[g] = m_new;
        s[g] = p;
      }
    }

    // acc += p @ V, p broadcast from lane j
#pragma unroll 4
    for (int j = 0; j < page; ++j) {
      float vd[D];
#pragma unroll
      for (int t = 0; t < D; ++t) {
        const int d = lane + 32 * t;
        vd[t] = d < hd ? to_f32(vp[j * pos_stride + d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(FULL, s[g], j);
#pragma unroll
          for (int t = 0; t < D; ++t) acc[g][t] = fmaf(pj, vd[t], acc[g][t]);
        }
      }
    }
  }

  // merge the four warps' partial states in a fixed order
  __shared__ float sm_m[WARPS][GM];
  __shared__ float sm_l[WARPS][GM];
  __shared__ float sm_acc[WARPS][GM][D * 32];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int t = 0; t < D; ++t) sm_acc[warp][g][lane + 32 * t] = acc[g][t];
  }
  __syncthreads();
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float c[WARPS];
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      c[w] = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c[w];
    }
    const float inv_l = 1.f / fmaxf(lsum, 1e-30f);
    T* o = out + ((size_t)b * H + kvh * G + g) * hd;
#pragma unroll
    for (int t = 0; t < D; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) a += sm_acc[w][g][d] * c[w];
        store(o + d, a * inv_l);
      }
    }
  }
}

template <typename T, int D, int GM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* lengths, const int* row_seg,
                   void* out, int B, int H, int Hkv, int hd, int page,
                   int maxp, float scale, cudaStream_t stream) {
  if (row_seg)
    paged_decode_kernel<T, D, GM, true><<<B * Hkv, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), tables, lengths, row_seg,
        static_cast<T*>(out), H, Hkv, hd, page, maxp, scale);
  else
    paged_decode_kernel<T, D, GM, false><<<B * Hkv, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), tables, lengths, row_seg,
        static_cast<T*>(out), H, Hkv, hd, page, maxp, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int G, const void* q, const void* k, const void* v,
                     const int* tables, const int* lengths,
                     const int* row_seg, void* out, int B, int H, int Hkv,
                     int hd, int page, int maxp, float scale,
                     cudaStream_t st) {
  if (G <= 1)
    return launch<T, D, 1>(q, k, v, tables, lengths, row_seg, out, B, H,
                           Hkv, hd, page, maxp, scale, st);
  if (G <= 2)
    return launch<T, D, 2>(q, k, v, tables, lengths, row_seg, out, B, H,
                           Hkv, hd, page, maxp, scale, st);
  if (G <= 4)
    return launch<T, D, 4>(q, k, v, tables, lengths, row_seg, out, B, H,
                           Hkv, hd, page, maxp, scale, st);
  if (G <= 8)
    return launch<T, D, 8>(q, k, v, tables, lengths, row_seg, out, B, H,
                           Hkv, hd, page, maxp, scale, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v,
                   const int* tables, const int* lengths, const int* row_seg,
                   void* out, int B, int H, int Hkv, int hd, int page,
                   int maxp, float scale, cudaStream_t st) {
  const int G = H / Hkv;
  switch ((hd + 31) / 32) {
    case 1:
      return by_group<T, 1>(G, q, k, v, tables, lengths, row_seg, out, B,
                            H, Hkv, hd, page, maxp, scale, st);
    case 2:
      return by_group<T, 2>(G, q, k, v, tables, lengths, row_seg, out, B,
                            H, Hkv, hd, page, maxp, scale, st);
    case 3:
      return by_group<T, 3>(G, q, k, v, tables, lengths, row_seg, out, B,
                            H, Hkv, hd, page, maxp, scale, st);
    case 4:
      return by_group<T, 4>(G, q, k, v, tables, lengths, row_seg, out, B,
                            H, Hkv, hd, page, maxp, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t run(int dtype, const void* q, const void* k, const void* v,
                const void* tables, const void* lengths, const void* row_seg,
                void* out, int B, int H, int Hkv, int hd, int page, int maxp,
                float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  if (page < 1 || page > 32 || Hkv < 1 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* rs = static_cast<const int*>(row_seg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim<float>(q, k, v, tb, ln, rs, out, B, H, Hkv, hd, page, maxp,
                         scale, st);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(q, k, v, tb, ln, rs, out, B, H, Hkv, hd,
                                 page, maxp, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
// Shapes: q (B, H, hd); k/v pages (P, page, Hkv, hd); tables (B, maxp)
// int32; lengths (B,) int32; out (B, H, hd).  All contiguous.
extern "C" int proserve_paged_decode(int dtype, const void* q, const void* k,
                                     const void* v, const void* tables,
                                     const void* lengths, void* out, int B,
                                     int H, int Hkv, int hd, int page,
                                     int maxp, float scale, int device,
                                     void* stream) {
  return run(dtype, q, k, v, tables, lengths, nullptr, out, B, H, Hkv, hd,
             page, maxp, scale, device, stream);
}

// Packed verify: q (R, H, hd); k/v pages (P, page, Hkv, hd); tables
// (S, maxp) int32; lengths (R,) int32 per row; row_seg (R,) int32 in
// [0, S) (the wrapper checks it); out (R, H, hd).  All contiguous.
extern "C" int proserve_packed_verify(int dtype, const void* q,
                                      const void* k, const void* v,
                                      const void* tables, const void* lengths,
                                      const void* row_seg, void* out, int R,
                                      int H, int Hkv, int hd, int page,
                                      int maxp, float scale, int device,
                                      void* stream) {
  return run(dtype, q, k, v, tables, lengths, row_seg, out, R, H, Hkv, hd,
             page, maxp, scale, device, stream);
}
