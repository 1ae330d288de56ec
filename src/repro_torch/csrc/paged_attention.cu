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
//    row is bitwise the decode row run on tables[row_seg[b]].  The choice
//    is a template flag, so the decode instances carry no test for it.
//
// What bounds it on the card: memory bandwidth.  Each (request, kv head)
// reads len * hd * 2 K/V values once and does 4 * G * hd flops per cached
// position: G / 2 flops per fp32 byte, at most 4 at G = 8, against the
// CUDA cores' fp32 ridge of ~20 flops per byte (67 TFLOP/s over 3.35
// TB/s).  So the kernel stays on the CUDA cores: mma.sync or wgmma would
// speed up arithmetic that is not the limit, and the design is about
// keeping enough bytes in flight (~2 MB over the card, ~15 KiB per SM, to
// cover ~0.6 us of memory latency at 3.35 TB/s).
//
// What the design does about it:
//  * The pages of one (row, kv head) are split over a thread-block
//    cluster of CLUSTER = 2 blocks (__cluster_dims__) and over the WARPS =
//    4 warps of each block: page i belongs to block rank i % CLUSTER and,
//    in that block, to warp (i / CLUSTER) % WARPS.  The rule depends only
//    on the page index; a row walks only its n_pages = min(ceil(len /
//    page), maxp) live pages, so a long row's chain is spread over SPLITS
//    = 8 warps on two SMs instead of four warps of one block.  (Clusters
//    of 4 gave the longest single row a shorter chain, but twice the
//    blocks, and were slower on the batched shapes: PERF.md, measured
//    with tools/paged_decode_variants.py.)
//  * Each warp stages its pages in shared memory with 16-byte cp.async, in
//    stages of TP positions (a whole page, or a TP-position slice of a
//    larger one; TP holds ~STAGE_BYTES = 4 KiB of K and V rows, 8 to 32
//    positions: 8 at fp32 hd 64 and hd 128, 16 at bf16 hd 64, 32 at hd 8),
//    in a ring of STAGES = 2: the next stage's copies are issued before
//    the current one is computed.  Rows at or past the length are zero-filled, not
//    read.  The table entries of a warp's first 32 pages are read once, a
//    lane each, beside the length.  At ~35 KiB of shared memory per block
//    (fp32 hd 64) six blocks fit an SM, so 24 warps keep up to ~100 KiB of
//    K/V loads in flight per SM.
//  * Scores come from shared memory with no warp-wide reduction per
//    position: in a stage, lane l owns position l % TP and one of LP = 32
//    / TP slices of the head dims, for all G heads of the group (q sits in
//    shared memory as fp32); the LP slices of a position are added by
//    log2(LP) shuffles.  The softmax then takes one max over the stage's
//    positions per head; each lane keeps a partial row sum for its
//    position slot, added over the positions once at the end.
//  * P V is spread over the warp: lane l owns the 16-byte column l % (hd /
//    VEC) of V (VEC = 4 fp32 or 8 bf16 values) for a class of heads and a
//    class of positions, so a lane holds at most 32 accumulators (G 8 x hd
//    128) instead of all G x hd; the position classes are added by
//    shuffles at the end.  P goes from the score lanes to the P V lanes
//    through a per-warp shared-memory row.
//  * Layout of a stage: K rows [0, TP) then V rows [0, TP), each hd
//    elements plus a 16-byte pad.  Score lanes read 16 bytes of eight
//    different rows at one column per quarter-warp: with a row stride of
//    (hd / VEC + 1) 16-byte units, odd, they fall in eight distinct bank
//    groups.  P V lanes read one row's consecutive 16-byte columns.
//  * Merge, in a fixed order and without atomics: each warp's partial
//    (m, l, acc) goes to shared memory; the block merges its warps in the
//    order w = 0..WARPS-1; after cluster.sync(), rank 0 reads the ranks'
//    block states through distributed shared memory (map_shared_rank) in
//    the order r = 0..CLUSTER-1 and writes the output; a second
//    cluster.sync() keeps the states alive until it has read them.  A
//    split with no page would carry (NEG_INF, 0, 0) and add exactly 0, so
//    the merges leave it out: a rank with no page (every rank but 0 of a
//    one-page row) returns at once, and a row whose pages all sit in rank
//    0 skips the cluster barriers.  All of the cluster's blocks derive that
//    choice from the same length.  No workspace, no second launch.
//  * A block takes at most GROUP = 8 query heads of its kv head.  A larger
//    G (ChatGLM3-6B's 16) runs ceil(G / GROUP) head groups, each a cluster
//    of its own on the GM = GROUP instance; the group index only offsets q
//    and the output, and the groups of one (row, kv head) are neighbours
//    in the grid, so the second group reads the pages from L2.  A head's
//    arithmetic does not depend on its place in the group, so its bits do
//    not depend on which group it sits in.
//  * The order of every sum depends only on (length, page, hd, GM, the
//    type), never on B, on maxp beyond the clamp, or on the other rows, so
//    the verify entry gets the decode row's bits, and the engine's
//    spec-on = spec-off and exact-stream contracts hold.
//  * Math follows the TPU kernel: scores scaled first, then masked to
//    NEG_INF = -1e30 with p = 0, so a masked score stays exactly NEG_INF
//    and m stays NEG_INF until a real key; fp32 online softmax (in log2
//    units: s * scale * log2(e), exp2); output acc / max(l, 1e-30), so a
//    length-0 row writes 0.
//
// The kernel launches on the caller's stream, allocates nothing and the C
// entry points return cudaGetLastError() of the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CLUSTER = 2;  // blocks per (row, kv head)
constexpr int WARPS = 4;    // warps per block
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;   // cp.async ring depth per warp
constexpr int STAGE_BYTES = 4096;  // K and V rows a stage aims at
constexpr int SPLITS = CLUSTER * WARPS;
constexpr int GROUP = 8;    // most query heads a block takes

template <typename T_, int HD_, int GM_>
struct Cfg {
  using T = T_;
  static constexpr int HD = HD_;  // head dim
  static constexpr int GM = GM_;  // query heads per block (G > GM: groups)
  static constexpr int VEC = 16 / sizeof(T);  // values per 16 bytes
  static constexpr int DC = HD / VEC;         // 16-byte columns per row
  // positions per stage: ~STAGE_BYTES of K and V rows, 8..32
  static constexpr int TP_RAW = STAGE_BYTES / (2 * HD * (int)sizeof(T));
  static constexpr int TP = TP_RAW < 8 ? 8 : (TP_RAW > 32 ? 32 : TP_RAW);
  static constexpr int RS = HD + VEC;  // stage row stride (elements)
  static constexpr int LP = 32 / TP;   // score lanes per position
  static constexpr int QC = DC / LP;   // 16-byte columns per score lane
  static constexpr int LR = 32 / DC;   // P V lanes per column
  static constexpr int HS = GM < LR ? GM : LR;  // P V head classes
  static constexpr int PS = LR / HS;            // P V position classes
  static constexpr int GL = GM / HS;            // heads per P V lane
  static constexpr int STAGE = 2 * TP * RS;     // elements: K, then V rows
  static constexpr int WS = 2 * GM + GM * HD;   // floats: m, l, acc
  static constexpr int Q_BYTES = GM * HD * 4;
  static constexpr int P_BYTES = (WARPS * (TP + 1) * GM * 4 + 15) / 16 * 16;
  static constexpr int RING_BYTES = WARPS * STAGES * STAGE * sizeof(T);
  static constexpr int SMEM = Q_BYTES + P_BYTES + RING_BYTES;
  static_assert(HD % VEC == 0 && 32 % DC == 0 && DC % LP == 0, "layout");
  static_assert((TP * DC) % 32 == 0 && PS <= TP, "layout");
  // the warps' and the block's merge states reuse the ring
  static_assert((WARPS + 1) * WS * 4 <= RING_BYTES, "merge room");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of shared memory as fp32 values
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// N consecutive fp32 values of shared memory, 16 or 8 bytes at a time
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

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

// Element e of the merge of the states st[0..n) (m[GM], l[GM],
// acc[GM][HD]; n <= N) in the order 0..n-1: e < GM * HD is acc element e,
// else l of head e - GM * HD.  Returns the merged value; *m_out gets the
// merged max of its head.  Leaving out a split with no page changes no
// bit: its (NEG_INF, 0, 0) adds exp2(NEG_INF - m) * 0 = 0.
template <int N, int GM, int HD>
__device__ __forceinline__ float merge(const float* const* st, int n, int e,
                                       float* m_out) {
  const bool is_acc = e < GM * HD;
  const int g = is_acc ? e / HD : e - GM * HD;
  float mx = NEG_INF;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < n) mx = fmaxf(mx, st[k][g]);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < n)
      sum += exp2f(st[k][g] - mx) * (is_acc ? st[k][2 * GM + e]
                                            : st[k][GM + g]);
  *m_out = mx;
  return sum;
}

// One cluster per (row b, kv head); see the note at the top.
template <class C, bool ROW_SEG>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
paged_decode_kernel(const typename C::T* __restrict__ q,
                    const typename C::T* __restrict__ k_pages,
                    const typename C::T* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    const int* __restrict__ row_seg,
                    typename C::T* __restrict__ out, int H, int Hkv, int page,
                    int maxp, float scale) {
  using T = typename C::T;
  constexpr int HD = C::HD, GM = C::GM, VEC = C::VEC, DC = C::DC;
  constexpr int TP = C::TP, RS = C::RS, LP = C::LP, HS = C::HS;
  constexpr int PS = C::PS, GL = C::GL, WS = C::WS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);            // [GM][HD]
  float* p_s = q_s + GM * HD;  // [WARPS][TP + 1][GM]: P rows, then alpha
  T* ring = reinterpret_cast<T*>(smem + C::Q_BYTES + C::P_BYTES);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = H / Hkv;
  const int NG = (G + GM - 1) / GM;  // head groups per (row, kv head)
  const int unit = blockIdx.x / CLUSTER;
  const int b = unit / (Hkv * NG);
  const int kvh = unit % (Hkv * NG) / NG;
  const int grp = unit % NG;
  const int h0 = kvh * G + grp * GM;  // the group's first query head
  const int heads = min(GM, G - grp * GM);  // its live heads
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lengths[b];
  const int n_pages = len > 0 ? min((len + page - 1) / page, maxp) : 0;
  // ranks with a page: page i is rank i % CLUSTER's.  A rank past them
  // (not rank 0, which writes the output) only keeps the cluster's
  // barriers, which exist only when two or more ranks have pages.
  const int n_ranks = min(CLUSTER, n_pages);
  if (rank > 0 && rank >= n_ranks) {
    if (n_ranks > 1) {
      cluster.sync();
      cluster.sync();
    }
    return;
  }
  // decode: row b's own table row; verify: its request's (row_seg[b])
  const int* trow = tables + (size_t)(ROW_SEG ? row_seg[b] : b) * maxp;
  const size_t pos_stride = (size_t)Hkv * HD;
  const int per_page = (page + TP - 1) / TP;  // stages per page
  const int split = warp * CLUSTER + rank;  // pages split + SPLITS * k
  T* my_ring = ring + warp * STAGES * C::STAGE;
  float* my_p = p_s + warp * (TP + 1) * GM;
  float* my_alpha = my_p + TP * GM;
  // lane k holds the table entry of this warp's k-th page (split + SPLITS *
  // k): one load for the warp's first 32 pages instead of one per stage
  const int my_phys =
      split + SPLITS * lane < maxp ? trow[split + SPLITS * lane] : 0;

  // Stage t of this warp: page i = split + SPLITS * (t / per_page),
  // positions j0 = TP * (t % per_page) .. of it.  Stages exist up to the
  // first one at or past the length (pages only grow with t).
  auto stage_of = [&](int t, int& i, int& j0) {
    const int kk = t / per_page;
    i = split + SPLITS * kk;
    j0 = (t - kk * per_page) * TP;
    return i < n_pages && i * page + j0 < len;
  };
  auto issue = [&](int t) {
    int i, j0;
    if (!stage_of(t, i, j0)) return;
    const int pos0 = i * page + j0;
    const int nrow = min(TP, page - j0);
    const int kk = t / per_page;
    const int phys = kk < 32 ? __shfl_sync(FULL, my_phys, kk) : trow[i];
    const size_t base =
        ((size_t)phys * page + j0) * pos_stride + (size_t)kvh * HD;
    T* st = my_ring + (t % STAGES) * C::STAGE;
#pragma unroll
    for (int n = 0; n < TP * DC / 32; ++n) {
      const int e = lane + 32 * n;
      const int j = e / DC, c = e % DC;
      if (j < nrow) {
        const bool live = pos0 + j < len;
        const size_t off = base + (size_t)j * pos_stride + c * VEC;
        cp_async16(st + j * RS + c * VEC, k_pages + off, live);
        cp_async16(st + (TP + j) * RS + c * VEC, v_pages + off, live);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    issue(t);
    cp_async_commit();
  }
  // the group's queries, fp32, zero past its live heads
  for (int e = threadIdx.x; e < GM * HD; e += THREADS) {
    const int g = e / HD;
    q_s[e] = g < heads ? to_f32(q[((size_t)b * H + h0 + g) * HD + e % HD])
                     : 0.f;
  }
  __syncthreads();

  const float scale2 = scale * LOG2E;
  // score lanes: position qp of a stage, dim slice qsl
  const int qp = lane % TP, qsl = lane / TP;
  // P V lanes: 16-byte column vc, head class hc, position class pc
  const int vc = lane % DC, hc = (lane / DC) % HS, pc = (lane / DC) / HS;

  float m[GM], l[GM], acc[GL][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < GL; ++i)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;

  for (int t = 0;; ++t) {
    int i, j0;
    if (!stage_of(t, i, j0)) break;
    issue(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const T* ks = my_ring + (t % STAGES) * C::STAGE;
    const T* vs = ks + TP * RS;
    const int pos0 = i * page + j0;
    const int nrow = min(TP, page - j0);

    // scores of position qp over this lane's dim slice, all heads
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
#pragma unroll
    for (int u = 0; u < C::QC; ++u) {
      const int c = qsl + LP * u;
      float kv[VEC];
      load16(ks + qp * RS + c * VEC, kv);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int h = 0; h < VEC / 4; ++h) {
          const float4 q4 =
              *reinterpret_cast<const float4*>(q_s + g * HD + c * VEC + 4 * h);
          s[g] = fmaf(q4.x, kv[4 * h], s[g]);
          s[g] = fmaf(q4.y, kv[4 * h + 1], s[g]);
          s[g] = fmaf(q4.z, kv[4 * h + 2], s[g]);
          s[g] = fmaf(q4.w, kv[4 * h + 3], s[g]);
        }
      }
    }
    // add the LP slices of a position (lanes qp + TP * slice)
#pragma unroll
    for (int o = TP; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g) s[g] += __shfl_xor_sync(FULL, s[g], o);

    // online softmax over the stage: scale, then mask
    const bool valid = qp < nrow && pos0 + qp < len;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float sg = valid ? s[g] * scale2 : NEG_INF;
      float mx = sg;
#pragma unroll
      for (int o = 1; o < TP; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = exp2f(m[g] - m_new);
      const float p = valid ? exp2f(sg - m_new) : 0.f;
      l[g] = l[g] * alpha + p;
      m[g] = m_new;
      s[g] = p;
      if (lane == 0) my_alpha[(g % HS) * GL + g / HS] = alpha;
    }
    // P to the P V lanes: row qp, heads of class hc contiguous
    if (qsl == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g) my_p[qp * GM + (g % HS) * GL + g / HS] = s[g];
    }
    __syncwarp();

    // acc = acc * alpha + P V for heads hc + HS * i, positions pc + PS * n
    {
      float a[GL];
      load_f32(my_alpha + hc * GL, a);
#pragma unroll
      for (int i = 0; i < GL; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[i][v] *= a[i];
    }
#pragma unroll
    for (int n = 0; n < TP / PS; ++n) {
      const int j = pc + PS * n;
      if (j < nrow) {
        float vv[VEC];
        load16(vs + j * RS + vc * VEC, vv);
        float pj[GL];
        load_f32(my_p + j * GM + hc * GL, pj);
#pragma unroll
        for (int i = 0; i < GL; ++i)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[i][v] = fmaf(pj[i], vv[v], acc[i][v]);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // the warp's state: l over its position slots, acc over position classes
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int o = 1; o < TP; o <<= 1) l[g] += __shfl_xor_sync(FULL, l[g], o);
#pragma unroll
  for (int o = DC * HS; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < GL; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[i][v] += __shfl_xor_sync(FULL, acc[i][v], o);
  __syncthreads();  // every warp is done with the ring
  // warps w < n_warps have pages (split = w * CLUSTER + rank < n_pages)
  const int n_warps = min(WARPS, (n_pages - rank + CLUSTER - 1) / CLUSTER);
  float* states = reinterpret_cast<float*>(ring);  // [WARPS + 1][WS]
  float* ws = states + warp * WS;
  if (warp < n_warps) {
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        ws[g] = m[g];
        ws[GM + g] = l[g];
      }
    }
    if (pc == 0) {
#pragma unroll
      for (int i = 0; i < GL; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          ws[2 * GM + (hc + HS * i) * HD + vc * VEC + v] = acc[i][v];
    }
  }
  __syncthreads();

  // the block's state: its warps merged in the order 0..n_warps-1
  float* bs = states + WARPS * WS;
  if (n_warps > 0) {
    const float* st[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) st[w] = states + w * WS;
    for (int e = threadIdx.x; e < GM * HD + GM; e += THREADS) {
      float mx;
      const float v = merge<WARPS, GM, HD>(st, n_warps, e, &mx);
      if (e < GM * HD) {
        bs[2 * GM + e] = v;
      } else {
        bs[e - GM * HD] = mx;
        bs[GM + e - GM * HD] = v;
      }
    }
  }
  if (n_ranks > 1) cluster.sync();
  else __syncthreads();

  // rank 0: the ranks' states, through distributed shared memory, merged
  // in the order 0..n_ranks-1, then acc / max(l, 1e-30)
  if (rank == 0) {
    const float* st[CLUSTER];
    st[0] = bs;
#pragma unroll
    for (int r = 1; r < CLUSTER; ++r)
      st[r] = r < n_ranks ? cluster.map_shared_rank(bs, r) : bs;
    for (int e = threadIdx.x; e < heads * HD; e += THREADS) {
      const int g = e / HD;
      float mx;
      const float a = merge<CLUSTER, GM, HD>(st, n_ranks, e, &mx);
      const float lsum = merge<CLUSTER, GM, HD>(st, n_ranks, GM * HD + g, &mx);
      store(out + ((size_t)b * H + h0) * HD + e, a / fmaxf(lsum, 1e-30f));
    }
  }
  // the ranks' states stay alive until rank 0 has read them
  if (n_ranks > 1) cluster.sync();
}

template <class C>
cudaError_t set_smem(int device) {
  // the dynamic shared-memory limit, set once per instance and device
  static std::atomic<unsigned long long> smem_set{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (smem_set.load() & bit) return cudaSuccess;
  for (auto fn : {paged_decode_kernel<C, false>, paged_decode_kernel<C, true>}) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
  }
  smem_set.fetch_or(bit);
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v;
  const int *tables, *lengths, *row_seg;
  void* out;
  int B, H, Hkv, page, maxp;
  float scale;
  int device;
  cudaStream_t stream;
};

template <class C>
cudaError_t launch(const Args& a) {
  using T = typename C::T;
  cudaError_t err = set_smem<C>(a.device);
  if (err != cudaSuccess) return err;
  const int groups = (a.H / a.Hkv + C::GM - 1) / C::GM;
  const long long blocks = (long long)a.B * a.Hkv * groups * CLUSTER;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (a.row_seg)
    paged_decode_kernel<C, true><<<(unsigned)blocks, THREADS, C::SMEM,
                                   a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.tables, a.lengths, a.row_seg,
        static_cast<T*>(a.out), a.H, a.Hkv, a.page, a.maxp, a.scale);
  else
    paged_decode_kernel<C, false><<<(unsigned)blocks, THREADS, C::SMEM,
                                    a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.tables, a.lengths, a.row_seg,
        static_cast<T*>(a.out), a.H, a.Hkv, a.page, a.maxp, a.scale);
  return cudaGetLastError();
}

// Calls f(Cfg<T, hd, GM>{}) for the instance that takes (dtype, hd, G):
// G > GROUP runs in head groups of GROUP.
template <typename T, int HD, typename F>
cudaError_t by_group(int G, F&& f) {
  static_assert(GROUP == 8, "instances below");
  if (G <= 1) return f(Cfg<T, HD, 1>{});
  if (G <= 2) return f(Cfg<T, HD, 2>{});
  if (G <= 4) return f(Cfg<T, HD, 4>{});
  return f(Cfg<T, HD, 8>{});
}

template <typename T, typename F>
cudaError_t by_dim(int hd, int G, F&& f) {
  switch (hd) {
    case 8:
      return by_group<T, 8>(G, f);
    case 16:
      return by_group<T, 16>(G, f);
    case 32:
      return by_group<T, 32>(G, f);
    case 64:
      return by_group<T, 64>(G, f);
    case 128:
      return by_group<T, 128>(G, f);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t dispatch(int dtype, int hd, int G, F&& f) {
  if (dtype == 0) return by_dim<float>(hd, G, f);
  if (dtype == 1) return by_dim<__nv_bfloat16>(hd, G, f);
  return cudaErrorInvalidValue;
}

cudaError_t run(int dtype, const Args& a, int hd) {
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return err;
  if (a.B <= 0) return cudaSuccess;
  if (a.page < 1 || a.maxp < 1 || a.Hkv < 1 || a.H % a.Hkv != 0)
    return cudaErrorInvalidValue;
  // 16-byte cp.async of K/V rows
  for (const void* p : {a.k, a.v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  return dispatch(dtype, hd, a.H / a.Hkv,
                  [&](auto cfg) { return launch<decltype(cfg)>(a); });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
// Shapes: q (B, H, hd); k/v pages (P, page, Hkv, hd); tables (B, maxp)
// int32; lengths (B,) int32; out (B, H, hd).  All contiguous, the pages
// 16-byte aligned; hd in {8, 16, 32, 64, 128}, H a multiple of Hkv.
extern "C" int proserve_paged_decode(int dtype, const void* q, const void* k,
                                     const void* v, const void* tables,
                                     const void* lengths, void* out, int B,
                                     int H, int Hkv, int hd, int page,
                                     int maxp, float scale, int device,
                                     void* stream) {
  const Args a{q, k, v, static_cast<const int*>(tables),
               static_cast<const int*>(lengths), nullptr, out, B, H, Hkv,
               page, maxp, scale, device, static_cast<cudaStream_t>(stream)};
  return run(dtype, a, hd);
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
  const Args a{q, k, v, static_cast<const int*>(tables),
               static_cast<const int*>(lengths),
               static_cast<const int*>(row_seg), out, R, H, Hkv, page, maxp,
               scale, device, static_cast<cudaStream_t>(stream)};
  return run(dtype, a, hd);
}

// The launch shape of the instance that takes (dtype, hd, G) on a device:
// out[0..7] = blocks per cluster, warps per block, cp.async stages per
// warp, positions per stage, dynamic shared memory per block (bytes),
// resident blocks per SM, resident clusters on the device (-1 where
// the occupancy query fails) and head groups per (row, kv head).
extern "C" int proserve_paged_decode_info(int dtype, int hd, int G,
                                          int device, void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out);
  return dispatch(dtype, hd, G, [&](auto cfg) {
    using C = decltype(cfg);
    cudaError_t e = set_smem<C>(device);
    if (e != cudaSuccess) return e;
    o[0] = CLUSTER;
    o[1] = WARPS;
    o[2] = STAGES;
    o[3] = C::TP;
    o[4] = C::SMEM;
    int n = -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, paged_decode_kernel<C, false>, THREADS, C::SMEM) !=
        cudaSuccess)
      n = -1;
    o[5] = n;
    cudaLaunchConfig_t lc = {};
    lc.gridDim = dim3(CLUSTER);
    lc.blockDim = dim3(THREADS);
    lc.dynamicSmemBytes = C::SMEM;
    int nc = -1;
    if (cudaOccupancyMaxActiveClusters(
            &nc, reinterpret_cast<const void*>(paged_decode_kernel<C, false>), &lc) != cudaSuccess)
      nc = -1;
    o[6] = nc;
    o[7] = (G + C::GM - 1) / C::GM;
    cudaGetLastError();  // a failed occupancy query leaves no error behind
    return cudaSuccess;
  });
}
