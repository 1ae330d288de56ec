// Packed multi-request and per-request chunked prefill attention for
// Hopper (sm_90a) on the tensor cores: one kernel body, two C entry points.
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
// 2 * n * hd * bytes of K/V per kv head, i.e. O(Sq * G) flops per byte;
// for the engine's 64..512-token chunks that is far above the ridge.  The
// engine's fp32 is a parity mode, so fp32 products must keep fp32-level
// error: plain TF32 (10 mantissa bits, ~1e-3) does not, and the CUDA
// cores' fp32 FMA tops out at 67 TFLOP/s.  So fp32 runs 3xTF32 on the
// tensor cores: x = big + small with big = x rounded to TF32 (as
// cvt.rna.tf32.f32 rounds) and small = x - big, and a * b ~ small_a * big_b
// + big_a * small_b + big_a * big_b (the dropped small * small term is
// ~2^-22 relative), three TF32 products at 495 TFLOP/s = 165 TFLOP/s of
// fp32-accurate products.  bf16 runs bf16 products with fp32 accumulators
// (989 TFLOP/s).
//
// What the design does about it (FlashAttention-2's shape):
//  * One thread block per (tile of BQ = 64 of the G * Sq query rows,
//    kv_head, segment), rows g-major (row = g * Sq + r) as in the TPU
//    kernel's (G * Sq) score tile.  Four warps, each owning 16 rows: the
//    m16 of mma.sync.  All 64 rows share one kv head, so every K/V tile in
//    shared memory feeds all of them through the tensor cores.
//  * fp32: mma.sync m16n8k8 tf32, 3xTF32 (small*big, big*small, then
//    big*big into fp32 accumulators), for S = Q K^T and for O += P V (P is
//    split the same way).  bf16: mma.sync m16n8k16 bf16, P rounded to bf16
//    from the S accumulators (the usual register reuse), V's B fragments
//    through ldmatrix.trans.
//  * Online softmax on the accumulator fragments: the 4 lanes that hold a
//    row reduce its max with two shuffles; each lane keeps a partial row
//    sum, added across the quad once at the end.  NEG_INF = -1e30, the
//    rescale exp(m_old - m_new) and the output acc / max(l, 1e-30) are the
//    TPU kernel's; the exponentials are taken as 2^x of scores in log2
//    units (s * scale * log2(e); one MUFU.EX2 a score).  A key past a row's
//    position, or at or past Smax, gets s = NEG_INF and p = 0: a bitwise
//    no-op on that row's state.  Only tiles that reach past some row's
//    position or past Smax are masked.
//  * K/V tiles of BK keys in shared memory, two stages filled with 16-byte
//    cp.async (zero-filled past Smax) while the previous stage is consumed.
//    The MMAs' k-slots are permuted so that a lane reads both of its slots
//    of a K row (and of Q) in one 8-byte load, and the P V product takes
//    keys 2t, 2t + 1 in its k-slots t, t + 4 so P comes straight from the S
//    accumulators; the row pads (K 8 or 16 elements, V 4 or 8) put the
//    lanes of each read on distinct banks.  Q comes in through the same
//    path; its fragments stay in registers (fp32: split per k-step), except
//    fp32 hd 128, which reads Q from shared memory per k-step.  Dynamic
//    shared memory, its limit set once per instance and device.
//  * The loop stops at the block's causal horizon min(Smax, ctx + r_max +
//    1); a warp skips a tile that none of its rows reaches (a no-op on
//    their state).  Inside a tile the MMA steps are straight-line code, so
//    the scheduler interleaves the independent accumulator chains (a
//    branch per 8-key step serialised them).  Row tiles are launched heaviest
//    first (blockIdx.z walks the farthest horizons first, over all heads
//    and segments), so one wave does not end on its heaviest block.
//  * head_dim 8 (the SMOKE configs): fp32 Q K^T is one k8 step and P V one
//    n-tile; bf16 Q K^T is one k16 step whose dims 8-15 are zero in the Q
//    and K fragments (set in registers, never read), so the step adds
//    exact zero products, and P V is one n-tile fed by ldmatrix.x2.
//  * A row's sum order depends only on (its segment's ctx, r, Sq, G, HD,
//    Smax): BK depends only on HD and the type, key tiles start at 0, no
//    row's keys are split across blocks (no split-K, no atomics).
//
// wgmma and TMA are later work (wgmma's TF32 form takes K-major B only, so
// V would need a transpose in shared memory).  The kernel launches on the
// caller's stream, allocates nothing and the C entry points return
// cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;  // four warps
constexpr int BQ = 64;        // query rows per block, 16 per warp

template <typename T, int HD>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // keys per shared-memory tile (depends only on HD and the type)
  static constexpr int BK = (F32 && HD == 128) ? 32 : 64;
  // row strides (elements).  K and Q are read 8 bytes a lane (the
  // k-slots are permuted so that a lane's two slots are adjacent dims), V
  // 4 bytes a lane (fp32) or through ldmatrix (bf16); the pads put the
  // lanes of each read on distinct banks.
  static constexpr int K_STR = HD + (F32 ? 8 : 16);
  static constexpr int V_STR = HD + (F32 ? 4 : 8);
  static constexpr int EPC = 16 / sizeof(T);       // elements per 16 bytes
  static constexpr int CH = HD / EPC;              // 16-byte chunks a row
  static constexpr int NT = BK / 8;                // 8-key n-tiles of S
  static constexpr int DT = HD / 8;                // 8-dim n-tiles of O
  // dims per k-step of Q K^T, and the k-steps: bf16 hd 8 takes one
  // 16-dim step whose dims 8-15 are zero in Q and K (exact zero products)
  static constexpr int KSTEP = F32 ? 8 : 16;
  static constexpr int QK = (HD + KSTEP - 1) / KSTEP;
  // Q's fragments in registers, except fp32 hd 128 (register budget)
  static constexpr bool Q_REGS = !(F32 && HD == 128);
  static constexpr int STAGE = BK * (K_STR + V_STR);  // K and V tiles
  // Q comes in through the second stage when its fragments move to
  // registers before that stage is first filled; else it has its own room
  static constexpr int SMEM =
      (2 * STAGE + (Q_REGS ? 0 : BQ * K_STR)) * sizeof(T);
  static_assert(!Q_REGS || BQ * K_STR <= STAGE, "Q must fit in a stage");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small for 3xTF32.  big = x rounded to TF32 to nearest, ties
// away from zero: cvt.rna.tf32.f32's rounding for finite x, in two integer
// instructions (cheaper than cvt.rna on the card).  small = x - big is exact in
// fp32 and goes to the tensor core as it is, which reads its top 19 bits:
// |small - tf32 small| <= 2^-21 |x|.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a * b with fp32-level error: small*big, big*small, then big*big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
// two 8x8 matrices, rows addressed by lanes 0-15
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// 2^x (MUFU.EX2; ~2 ulp, denormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The largest and the smallest r among stack rows [lo, hi) (hi > lo),
// rows g-major.
__device__ __forceinline__ int max_r(int lo, int hi, int Sq) {
  const int last = hi - 1;
  return (last / Sq != lo / Sq) ? Sq - 1 : last % Sq;
}
__device__ __forceinline__ int min_r(int lo, int hi, int Sq) {
  return ((hi - 1) / Sq != lo / Sq) ? 0 : lo % Sq;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
packed_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ ctx_lens, T* __restrict__ out,
                      int Sq, int H, int Hkv, int Smax, int ctx_sub,
                      float scale) {
  using C = Cfg<T, HD>;
  constexpr int BK = C::BK, K_STR = C::K_STR, V_STR = C::V_STR;
  constexpr int EPC = C::EPC, CH = C::CH;
  constexpr int NT = C::NT, DT = C::DT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int kvh = blockIdx.x;
  const int seg = blockIdx.y;
  const int G = H / Hkv;
  const int rows = G * Sq;
  const int n_rt = (rows + BQ - 1) / BQ;
  // heaviest row tiles first: blockIdx.z = 0 takes the tiles whose rows
  // reach the farthest r
  int tile;
  if (Sq % BQ == 0) {
    const int per_g = Sq / BQ;
    tile = (blockIdx.z % G) * per_g + per_g - 1 - blockIdx.z / G;
  } else {
    tile = n_rt - 1 - blockIdx.z;
  }
  const int r0 = tile * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ctx = ctx_lens[seg] - ctx_sub;

  // the block's causal horizon (the loop bound) and this warp's
  const int horizon =
      min(Smax - 1, ctx + max_r(r0, min(r0 + BQ, rows), Sq));
  const int n_tiles = horizon < 0 ? 0 : horizon / BK + 1;
  const int w0 = r0 + 16 * warp;
  const int w1 = min(w0 + 16, rows);
  const int warp_h = w0 < rows ? min(Smax - 1, ctx + max_r(w0, w1, Sq)) : -1;
  // keys below this need no mask for any of the warp's rows (padding rows
  // past the stack are never written, so they need none)
  const int warp_full = w0 < rows ? min(Smax, ctx + min_r(w0, w1, Sq) + 1) : 0;
  // scores in log2 units: p = 2^(s * c - m)
  const float c = scale * 1.4426950408889634f;

  // this thread's two rows (gid, gid + 8 of the warp's 16); padding rows
  // past the stack see no key
  int q_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + gid + 8 * h;
    q_pos[h] = row < rows ? ctx + row % Sq : -1;
  }

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const size_t pos_stride = (size_t)Hkv * HD;
  const size_t kv_off = ((size_t)seg * Smax * Hkv + kvh) * HD;
  T* q_s = C::Q_REGS ? sm + C::STAGE : sm + 2 * C::STAGE;

  auto load_kv = [&](int t, int stage) {
    T* ks = sm + stage * C::STAGE;
    T* vs = ks + BK * K_STR;
    const int k0 = t * BK;
    for (int idx = tid; idx < BK * CH; idx += THREADS) {
      const int j = idx / CH, c = idx % CH;
      const bool in = k0 + j < Smax;
      const size_t off = kv_off + (size_t)(in ? k0 + j : 0) * pos_stride +
                         c * EPC;
      cp_async16(ks + j * K_STR + c * EPC, k + off, in);
      cp_async16(vs + j * V_STR + c * EPC, v + off, in);
    }
  };

  // Q's A fragments (fp32 bits, split per k-step; bf16 pairs), with the
  // k-slots permuted: fp32 slots tig, tig + 4 <-> dims 2 tig, 2 tig + 1 of
  // the 8-dim step; bf16 slot pairs (2 tig, +1), (2 tig + 8, +9) <-> dims
  // 4 tig .. 4 tig + 3 of the 16-dim step.  K's B fragments use the same
  // permutation, so each lane reads both of its slots in one 8-byte load.
  constexpr int QK = C::QK, KSTEP = C::KSTEP;
  constexpr int QR = C::Q_REGS ? QK : 1;
  // this lane's k-slot dims of step kk lie in the head (bf16 hd 8: only
  // lanes tig < 2; the others hold the step's zero dims 8-15)
  auto k_live = [&](int kk) {
    return HD % KSTEP == 0 || KSTEP * kk + 4 * tig < HD;
  };
  uint32_t qr[QR][4];
  auto q_frag = [&](const T* q_rows, int kk, uint32_t (&a)[4]) {
    if (!k_live(kk)) {
      a[0] = a[1] = a[2] = a[3] = 0u;
      return;
    }
    const T* qa = q_rows + (16 * warp + gid) * K_STR + KSTEP * kk +
                  (C::F32 ? 2 : 4) * tig;
    const uint2 x = *reinterpret_cast<const uint2*>(qa);
    const uint2 y = *reinterpret_cast<const uint2*>(qa + 8 * K_STR);
    a[0] = x.x;
    a[1] = y.x;
    a[2] = x.y;
    a[3] = y.y;
  };

  if (n_tiles > 0) {
    for (int idx = tid; idx < BQ * CH; idx += THREADS) {
      const int j = idx / CH, c = idx % CH;
      const int row = r0 + j;
      const bool in = row < rows;
      const size_t off =
          in ? (((size_t)seg * Sq + row % Sq) * H + kvh * G + row / Sq) * HD +
                   c * EPC
             : 0;
      cp_async16(q_s + j * K_STR + c * EPC, q + off, in);
    }
    load_kv(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (C::Q_REGS) {
#pragma unroll
      for (int kk = 0; kk < QK; ++kk) q_frag(q_s, kk, qr[kk]);
      __syncthreads();  // stage 1 (which held Q) is refilled next
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BK;
    // a warp whose rows see no key of this tile skips it (a no-op on
    // their state); inside a tile the steps are straight-line code, so
    // the independent MMA chains interleave
    if (warp_h >= k0) {
      const T* ks = sm + (t & 1) * C::STAGE;
      const T* vs = ks + BK * K_STR;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

      // S = Q K^T
#pragma unroll
      for (int kk = 0; kk < QK; ++kk) {
        uint32_t a[4], ab[4], as[4];
        if constexpr (C::Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qr[kk][i];
        } else {
          q_frag(q_s, kk, a);
        }
        if constexpr (C::F32) {
#pragma unroll
          for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), ab[i], as[i]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 kw = k_live(kk) ? *reinterpret_cast<const uint2*>(
              ks + (8 * j + gid) * K_STR + KSTEP * kk +
              (C::F32 ? 2 : 4) * tig) : make_uint2(0u, 0u);
          if constexpr (C::F32) {
            uint32_t bb[2], bs[2];
            split(__uint_as_float(kw.x), bb[0], bs[0]);
            split(__uint_as_float(kw.y), bb[1], bs[1]);
            mma_3xtf32(s[j], ab, as, bb, bs);
          } else {
            mma_bf16(s[j], a, kw.x, kw.y);
          }
        }
      }

      // online softmax on the fragments: s[j][2h + e] is row gid + 8h,
      // key k0 + 8j + 2 tig + e, in log2 units.  Only a tile that reaches
      // past a row's position or past Smax is masked (s = NEG_INF, so
      // p = 2^-huge = 0).
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= c;
      if (k0 + BK > warp_full) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + 2 * tig + (e & 1);
            if (kp > q_pos[e / 2] || kp >= Smax) s[j][e] = NEG_INF;
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // m stays NEG_INF while the row has seen no key; then every p is
        // 2^NEG_INF = 0
        const float m_new = fmaxf(m[h], mx);
        const float m_sub = m_new == NEG_INF ? 0.f : m_new;
        const float alpha = ex2(m[h] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(s[j][2 * h + e] - m_sub);
            s[j][2 * h + e] = p;
            psum += p;
          }
        }
        l[h] = l[h] * alpha + psum;
        m[h] = m_new;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          o[n][2 * h] *= alpha;
          o[n][2 * h + 1] *= alpha;
        }
      }

      // O += P V
      if constexpr (C::F32) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // k-slot tig <-> key 2 tig, slot tig + 4 <-> key 2 tig + 1
          uint32_t pb[4], ps[4];
          split(s[j][0], pb[0], ps[0]);
          split(s[j][2], pb[1], ps[1]);
          split(s[j][1], pb[2], ps[2]);
          split(s[j][3], pb[3], ps[3]);
          const T* v0 = vs + (8 * j + 2 * tig) * V_STR + gid;
#pragma unroll
          for (int n = 0; n < DT; ++n) {
            uint32_t bb[2], bs[2];
            split(v0[8 * n], bb[0], bs[0]);
            split(v0[V_STR + 8 * n], bb[1], bs[1]);
            mma_3xtf32(o[n], pb, ps, bb, bs);
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          const uint32_t a[4] = {
              pack_bf16(s[2 * jj][0], s[2 * jj][1]),
              pack_bf16(s[2 * jj][2], s[2 * jj][3]),
              pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
              pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
          const T* vrow =
              vs + (16 * jj + (lane & 15)) * V_STR + 8 * (lane >> 4);
#pragma unroll
          for (int np = 0; np < DT / 2; ++np) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vrow + 16 * np);
            mma_bf16(o[2 * np], a, b[0], b[1]);
            mma_bf16(o[2 * np + 1], a, b[2], b[3]);
          }
          if constexpr (DT % 2) {  // hd 8: one 8-dim n-tile
            uint32_t b[2];
            ldmatrix_x2_trans(
                b, vs + (16 * jj + (lane & 15)) * V_STR + 8 * (DT - 1));
            mma_bf16(o[DT - 1], a, b[0], b[1]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = w0 + gid + 8 * h;
    if (row >= rows) continue;
    const float inv_l = 1.f / fmaxf(lt, 1e-30f);
    T* dst = out +
             (((size_t)seg * Sq + row % Sq) * H + kvh * G + row / Sq) * HD +
             2 * tig;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2(dst + 8 * n, o[n][2 * h] * inv_l, o[n][2 * h + 1] * inv_l);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* ctx_lens, void* out, int S, int Sq, int H,
                   int Hkv, int Smax, int ctx_sub, float scale, int device,
                   cudaStream_t stream) {
  using C = Cfg<T, HD>;
  // the dynamic shared-memory limit, set once per instance and device
  static std::atomic<unsigned long long> smem_set{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(smem_set.load() & bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        packed_prefill_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit);
  }
  const int G = H / Hkv;
  const long long n_rt = ((long long)G * Sq + BQ - 1) / BQ;
  if (n_rt > 65535) return cudaErrorInvalidValue;
  dim3 grid(Hkv, S, (unsigned)n_rt);
  packed_prefill_kernel<T, HD><<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ctx_lens, static_cast<T*>(out), Sq, H, Hkv,
      Smax, ctx_sub, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v,
                   const int* ctx_lens, void* out, int S, int Sq, int H,
                   int Hkv, int hd, int Smax, int ctx_sub, float scale,
                   int device, cudaStream_t st) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, ctx_lens, out, S, Sq, H, Hkv, Smax,
                          ctx_sub, scale, device, st);
    case 16:
      return launch<T, 16>(q, k, v, ctx_lens, out, S, Sq, H, Hkv, Smax,
                           ctx_sub, scale, device, st);
    case 32:
      return launch<T, 32>(q, k, v, ctx_lens, out, S, Sq, H, Hkv, Smax,
                           ctx_sub, scale, device, st);
    case 64:
      return launch<T, 64>(q, k, v, ctx_lens, out, S, Sq, H, Hkv, Smax,
                           ctx_sub, scale, device, st);
    case 128:
      return launch<T, 128>(q, k, v, ctx_lens, out, S, Sq, H, Hkv, Smax,
                            ctx_sub, scale, device, st);
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
  if (Smax < 1 || Hkv < 1 || H % Hkv != 0 || S > 65535)
    return cudaErrorInvalidValue;
  // 16-byte cp.async and 8-byte stores
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const int* cl = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim<float>(q, k, v, cl, out, S, Sq, H, Hkv, hd, Smax, ctx_sub,
                         scale, device, st);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(q, k, v, cl, out, S, Sq, H, Hkv, hd, Smax,
                                 ctx_sub, scale, device, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Shapes: q (S, Sq, H, hd); k/v (S, Smax, Hkv, hd); ctx_lens (S,) int32
// tokens cached before each chunk; out (S, Sq, H, hd).  All contiguous,
// q, k, v and out 16-byte aligned.
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
// chunk; out (B, Sq, H, hd).  All contiguous, 16-byte aligned.
extern "C" int proserve_chunked_prefill(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* cache_lens, void* out,
                                        int B, int Sq, int H, int Hkv, int hd,
                                        int Smax, float scale, int device,
                                        void* stream) {
  return run(dtype, q, k, v, cache_lens, out, B, Sq, H, Hkv, hd, Smax, Sq,
             scale, device, stream);
}
