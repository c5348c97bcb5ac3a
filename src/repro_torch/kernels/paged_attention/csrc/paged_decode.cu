// Paged-attention decode for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/paged_attention.py
// (`paged_decode` at :89, its pallas_call at :136, body `_decode_kernel`):
// single-token GQA decode over a block-table KV pool, q (B, Hq, 1, D)
// against pools (P, Hkv, PS, D) through a table (B, NP) of physical pages,
// masked by each row's length, with a float32 (m, l, acc) carry; its
// weights p stay float32 and V is cast up (paged_attention.py:74-76: a
// p -> bf16 downcast visibly perturbs decode logits).  A row of length 0
// gives zeros.  Like the TPU kernel it takes any head_dim whose rows are
// whole 16-byte vectors (a multiple of 8 in bf16, of 4 in float32) up to
// 256, any group G = Hq / Hkv and any page of 2 tokens or more.
//
// What bounds it on the H100: memory.  A row reads the K and V of the
// positions its length covers, sum_b len_b * Hkv * D * 2 * sizeof(T) bytes
// (134 MB at the family's production problem, 32 rows x 8192 tokens in
// 128-token pages: 0.040 ms at 3.35 TB/s), and does 4 * G * D operations
// per position, far below the card's ~295 operations per byte.  So the
// design reads each K/V element once (ceil(G / 8) times for G > 8, the
// repeats mostly from L2), keeps many copies in flight on every SM, and
// keeps the products off the critical path.
//
// Design: a split page walk.
//   * Each row's positions are cut into `ns` spans of span_pages pages,
//     a number the wrapper derives from the shapes (B, Hkv, G, NP, PS)
//     alone (core/families/paged_attention.py `span_pages`), never from
//     the lengths, so the grid is fixed for a decode geometry; the host
//     never reads the lengths.  One CTA per (span, KV head, head block,
//     row) serves up to 8 query heads of its KV head (the head block:
//     heads [8j, 8j + 8) of the G), so for G <= 8 each K/V element is read
//     once.  A span that starts at or past its row's length writes an
//     empty partial (m = -1e30, l = 0, o = 0) and exits.  Each span writes
//     float32 partials o (B·Hq, ns, D), m and l (B·Hq, ns); a second
//     kernel on the same stream merges them by log-sum-exp and writes the
//     output in q's type, or zeros where the merged l is 0.
//   * A span walks its pages in tiles of T rows: a tile holds the whole
//     pages that fit it (a page of PS <= T tokens), or a T-row chunk of
//     one page (PS > T; a page's last chunk is short where T does not
//     divide PS).  Rows that hold no valid position (past the length, in
//     a short chunk, or in a page slot's tail) are masked.
//   * bf16 (paged_decode_bf16_kernel): tensor cores fed by TMA at three
//     tile widths W = 64, 128 and 256 columns; head_dim D runs in the
//     least width W >= D, with the tensor maps declared at D columns, so
//     that TMA's zero fill supplies columns D..W-1 (the HBM bytes stay
//     those of D) and the products skip the 16-column steps wholly past
//     D.
//     A producer warp reads the span's table entries from device memory,
//     32 at a time into its lanes (the TPU kernel's scalar prefetch), and
//     copies the page tiles by TMA into a three-stage ring of 16 KB K and
//     V tiles with full/empty mbarriers, two CTAs an SM: 128 positions at
//     W = 64, 64 at 128, 32 at 256.  The pool is viewed as a 3-D tensor
//     (D, PS, P·Hkv): a box of min(PS, T) rows at (column, row in page,
//     phys·Hkv + hk).  A page of PS <= T tokens lands in a slot of PS
//     rounded up to 8 rows, so every box starts 1024-byte aligned in the
//     128-byte-swizzled tile (a 24-token page: two 24-row slots, rows
//     48..63 masked; a 2-token page: eight 8-row slots); a longer page is
//     walked in T-row boxes at rows 0, T, 2T, ... of the page, TMA
//     zero-filling rows past its end (a 512-token page: eight 64-row
//     boxes at W = 128).  Only pages holding a valid position are
//     copied: pages wholly past the length, and so the null page and
//     foreign pages, are never read.  Four consumer warps (two at W =
//     256) each take 16 (W = 128, 256) or 32 (W = 64) rows of every tile
//     (64-position 32 KB tiles at one CTA an SM measured slower at D =
//     256: PERF.md): Sᵀ = K·Qᵀ with the head block's heads as mma.sync's
//     n = 8 (K by ldmatrix, Q in registers, zero past the block and past
//     D), and Oᵀ = Vᵀ·Pᵀ with V by ldmatrix.trans.  p keeps the TPU
//     kernel's float32 accuracy: it is split into p_hi = bf16(p) and p_lo
//     = bf16(p - p_hi), two products into one float32 accumulator (p_hi
//     alone would move ~39% of the bf16 outputs by a step).  Rows that
//     hold no valid position contribute exactly nothing: their scores are
//     selected to -1e30, their p is 0, and their V rows are zeroed before
//     the product, so whatever shared memory holds there (a poisoned
//     page's tail, a stale stage, an unwritten slot tail) never reaches
//     the output.  The running max is updated once per warp's slice of a
//     tile; the warps' (m, l, o) merge in shared memory at the span's end,
//     and only columns below D are stored.
//   * float32 pools (paged_decode_f32_kernel): the same split walk on
//     CUDA-core FMAs (TF32 stays off) at three widths (64, 128, 256
//     columns, D at run time below them, or D = W at compile time as
//     kFull): a CTA of 128 threads stages each tile of up to 64
//     positions (at most 16 KB: 64 positions at width 64, 32 at 128, 16
//     at 256; pages packed without slots) with 16-byte loads through the
//     table (rows of W columns, zero past D), scores with each warp
//     taking whole positions, the softmax one warp per head, P·V with
//     each thread owning the output columns d ≡ tid (mod 128), p in
//     float32.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kGB = 8;             // query heads a CTA serves (mma's n)
constexpr int kTileBytes = 16384;  // one K (or V) tile
constexpr int kMaxStep = 64;       // positions a tile, CUDA-core kernel
constexpr int kThreads = 128;      // CUDA-core kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMinPage = 2;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
// max / sum over the eight lanes that share lane % 4 (one column of an
// mma.sync accumulator fragment)
__device__ __forceinline__ float col_max(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The walk of span s of row b: its valid positions [begin, end) (the
// span's pages, cut at the row's length, clamped to the table) in tiles of
// T rows.  A page of PS <= T tokens takes a slot of `slot` rows (PS, or PS
// rounded up to 8 where TMA boxes need 1024-byte-aligned starts) and a
// tile holds pp = T / slot pages; a longer page is tpp = ceil(PS / T)
// chunks of T rows, one a tile.
struct Walk {
  int begin, end, PS, T, slot, pp, tpp;
  // every row r of a tile holds position start + r, up to the span's end
  // (whole pages fill the tile without slot tails, or chunks fill pages)
  bool dense;

  __device__ __forceinline__ Walk(const int* lengths, int b, int s, int PS_,
                                  int NP, int span_pages, int T_,
                                  int slot_) {
    const int len = max(0, min(lengths[b], NP * PS_));
    PS = PS_;
    T = T_;
    begin = s * span_pages * PS;
    end = min(begin + span_pages * PS, len);
    if (PS <= T) {
      slot = slot_;
      pp = T / slot;
      tpp = 1;
    } else {
      slot = T;
      pp = 1;
      tpp = (PS + T - 1) / T;
    }
    dense = PS <= T ? slot == PS && pp * PS == T : PS % T == 0;
  }
  __device__ __forceinline__ int n_tiles() const {
    const int n = end - begin;   // > 0: empty spans exit before the walk
    if (PS <= T) return (n + pp * PS - 1) / (pp * PS);
    return (n / PS) * tpp + (n % PS + T - 1) / T;
  }
  // tile i: the position of its row 0 and the rows of each slot that hold
  // a page's positions
  __device__ __forceinline__ int start(int i) const {
    if (PS <= T) return begin + i * pp * PS;
    return begin + (i / tpp) * PS + (i % tpp) * T;
  }
  __device__ __forceinline__ int rows(int i) const {
    return PS <= T ? PS : min(T, PS - (i % tpp) * T);
  }
  // the position row r of tile i holds, or -1 where it holds none
  __device__ __forceinline__ int pos(int t0, int lim, int r) const {
    const int j = r / slot, o = r - j * slot;
    const int p = t0 + j * PS + o;
    return (o < lim && j < pp && p < end) ? p : -1;
  }
};

// -- bf16: tensor cores, TMA through the table, tiles of W columns -----------

template <int W>
struct Tc {
  static constexpr int kR = W < 128 ? 128 / W : 1;  // 16-row slabs a warp
  // consumer warps: a 16 KB tile at width 256 is 32 positions, two 16-row
  // slabs
  static constexpr int kConsumers = W == 256 ? 2 : 4;
  static constexpr int kT = 16 * kR * kConsumers;  // positions a tile
  static constexpr int kPanels = W / 64;
  static constexpr int kTile = kT * W * 2;         // bytes of K (or V)
  static constexpr int kStages = 3;
  static constexpr int kThreads = 32 * (kConsumers + 1);
  static constexpr int kSmem = 1024 + kStages * 2 * kTile + 16 * kStages;
  static_assert(kTile == kTileBytes, "16 KB tiles");
  static_assert(kConsumers * kGB * W * 4 + 2 * kConsumers * kGB * 4 <=
                    kStages * 2 * kTile,
                "the warps' partials fit the idle ring");
};

// kFull: head_dim is the width itself (64, 128, 256), known at compile
// time, so the head_dim guards and strides fold away
template <int W, bool kFull>
__global__ void __launch_bounds__(Tc<W>::kThreads, 2)
paged_decode_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __nv_bfloat16* __restrict__ q,  // (B, Hq, D)
                         const int* __restrict__ table,        // (B, NP)
                         const int* __restrict__ lengths,      // (B,)
                         float* __restrict__ o_part,  // (B·Hq, ns, D)
                         float* __restrict__ m_part,  // (B·Hq, ns)
                         float* __restrict__ l_part,  // (B·Hq, ns)
                         int Hq, int Hkv, int D_, int PS, int NP,
                         int span_pages, int ns, int nhb, float scale) {
  using C = Tc<W>;
  const int D = kFull ? W : D_;
  constexpr int T = C::kT, R = C::kR, TB = C::kTile, NST = C::kStages;
  const int s = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / nhb, hb = blockIdx.y % nhb;
  const int G = Hq / Hkv;
  const int h0 = hk * G + hb * kGB;           // first query head served
  const int GB = min(kGB, G - hb * kGB);      // heads served
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NST * 2 * TB);
  uint64_t* empty = full + NST;

  if (s * span_pages * PS >= min(lengths[b], NP * PS)) {
    // a span wholly past its row's length writes the empty partial and
    // exits before any barrier or load (most spans of a decode batch of
    // mixed lengths)
    for (int i = threadIdx.x; i < GB * D; i += C::kThreads) {
      const size_t row = ((size_t)b * Hq + h0 + i / D) * ns + s;
      o_part[row * D + i % D] = 0.f;
      if (i % D == 0) {
        m_part[row] = kNegInf;
        l_part[row] = 0.f;
      }
    }
    return;
  }
  const Walk wk(lengths, b, s, PS, NP, span_pages, T, (PS + 7) & ~7);
  const int n_tiles = wk.n_tiles();

  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], C::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == C::kConsumers) {
    // producer warp: the span's table entries, 32 at a time in its lanes;
    // lane 0 copies each tile's boxes that hold a valid position
    const int box = min(PS, T);        // rows of one TMA box
    const int* trow = table + (size_t)b * NP;
    int base = -32, mine = 0;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % NST, ph = (i / NST) & 1;
      const int t0 = wk.start(i);
      // whole pages (PS <= T) or one chunk of a page
      const int nb = PS <= T ? min(wk.pp, (wk.end - t0 + PS - 1) / PS) : 1;
      mbar_wait(&empty[st], ph ^ 1);
      // whole boxes, zero-filled columns and rows included
      if (lane == 0)
        mbar_expect_tx(&full[st], 2 * nb * box * C::kPanels * 128);
      unsigned char* kd = ring + st * 2 * TB;
      for (int j = 0; j < nb; ++j) {
        const int pos = t0 + j * PS, pg = pos / PS;
        if (pg < base || pg >= base + 32) {          // uniform in the warp
          base = pg;
          mine = pg + lane < NP ? trow[pg + lane] : 0;
        }
        const int phys = __shfl_sync(0xffffffffu, mine, pg - base);
        if (lane == 0) {
#pragma unroll
          for (int pn = 0; pn < C::kPanels; ++pn) {
            const int off = pn * T * 128 + j * wk.slot * 128;
            tma_load_3d(kd + off, &tm_k, pn * 64, pos % PS, phys * Hkv + hk,
                        &full[st]);
            tma_load_3d(kd + TB + off, &tm_v, pn * 64, pos % PS,
                        phys * Hkv + hk, &full[st]);
          }
        }
      }
    }
    return;
  }

  // consumer warp: rows [warp·16R, warp·16R + 16R) of every tile; the
  // products take the 16-column steps that hold real columns.
  // Qᵀ as the B operand (the block's heads, zero past them and past D):
  // element (d, head g)
  uint32_t qb[W / 16][2];
  {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + ((size_t)b * Hq + h0 + min(g, GB - 1)) * D);
#pragma unroll
    for (int kt = 0; kt < W / 16; ++kt) {
      qb[kt][0] = g < GB && kt * 16 < D ? qrow[kt * 8 + t] : 0u;
      qb[kt][1] = g < GB && kt * 16 + 8 < D ? qrow[kt * 8 + 4 + t] : 0u;
    }
  }
  // Oᵀ accumulator: m-tile mt holds d in [16mt, 16mt + 16), heads 2t, 2t+1
  float acc[W / 16][4];
#pragma unroll
  for (int mt = 0; mt < W / 16; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // heads 2t and 2t + 1
  float l0 = 0.f, l1 = 0.f;           // this lane's share of their sums
  const int row0 = warp * 16 * R;     // first row of this warp in a tile
  const int mi = lane >> 3, r8 = lane & 7;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NST, ph = (i / NST) & 1;
    const int t0 = wk.start(i), lim = wk.rows(i);
    unsigned char* kt_s = ring + st * 2 * TB;
    unsigned char* vt_s = kt_s + TB;
    // does every row of this warp (16R <= 32 of them) hold a valid
    // position?  (In a dense walk row r holds t0 + r below the end.)
    const int nt = wk.end - t0;
    const bool whole =
        wk.dense ? row0 + 16 * R <= nt
                 : __all_sync(0xffffffffu, lane >= 16 * R ||
                                               wk.pos(t0, lim, row0 + lane) >= 0);
    const auto valid = [&](int row) {
      return wk.dense ? row < nt : wk.pos(t0, lim, row) >= 0;
    };
    mbar_wait(&full[st], ph);
    if (!whole) {
      // rows that hold no valid position hold a page's tail, a stale
      // stage or an unwritten slot tail: zero this warp's V rows there,
      // so that p = 0 meets zero
      bool wrote = false;
      for (int c = lane; c < 16 * R * C::kPanels * 8; c += 32) {
        const int row = row0 + c / (C::kPanels * 8);
        const int pn = (c / 8) % C::kPanels;
        if (!valid(row)) {
          *reinterpret_cast<uint4*>(vt_s + pn * T * 128 + row * 128 +
                                    (c % 8) * 16) = make_uint4(0, 0, 0, 0);
          wrote = true;
        }
      }
      if (wrote) fence_proxy_async();   // the stage is refilled by TMA
      __syncwarp();
    }

    // Sᵀ = K Qᵀ for each 16-row slab: rows g and g+8, heads 2t, 2t+1
    float sc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sc[r][0] = sc[r][1] = sc[r][2] = sc[r][3] = 0.f;
      const int row = row0 + 16 * r + (mi & 1) * 8 + r8;
#pragma unroll
      for (int kt = 0; kt < W / 16; ++kt) {
        if (kt * 16 < D) {
          uint32_t a[4];
          ldmatrix_x4(a, smem_u32(kt_s + (kt / 4) * T * 128 +
                                  swz_offset(row, (kt % 4) * 2 + (mi >> 1))));
          mma_bf16(sc[r], a, qb[kt][0], qb[kt][1]);
        }
      }
    }

    // scores of rows without a valid position selected to -1e30; online
    // softmax (natural-log max, exp2f with log2(e) folded in)
    float mx0 = kNegInf, mx1 = kNegInf;
    bool ok[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 16 * r + g + (e >> 1) * 8;
        if (!(e & 1)) ok[r][e >> 1] = whole || valid(row);
        const float x = ok[r][e >> 1] ? sc[r][e] * scale : kNegInf;
        sc[r][e] = x;
        if (e & 1) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
      }
    }
    const float mn0 = fmaxf(m0, col_max(mx0)), mn1 = fmaxf(m1, col_max(mx1));
    const float al0 = exp2f((m0 - mn0) * kLog2e);
    const float al1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t ph_b[R][2], pl_b[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = ok[r][e >> 1]
                    ? exp2f((sc[r][e] - ((e & 1) ? mn1 : mn0)) * kLog2e)
                    : 0.f;
        if (e & 1) sum1 += pe[e]; else sum0 += pe[e];
      }
      // p = p_hi + p_lo in bf16, each transposed into the B operand:
      // element (position, head g)
      uint32_t hi, lo;
      split_bf16(pe[0], pe[1], hi, lo);
      ph_b[r][0] = movmatrix_trans(hi);
      pl_b[r][0] = movmatrix_trans(lo);
      split_bf16(pe[2], pe[3], hi, lo);
      ph_b[r][1] = movmatrix_trans(hi);
      pl_b[r][1] = movmatrix_trans(lo);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;

    // Oᵀ = Oᵀ·alpha + Vᵀ P_hiᵀ + Vᵀ P_loᵀ
#pragma unroll
    for (int mt = 0; mt < W / 16; ++mt) {
      if (mt * 16 < D) {
        acc[mt][0] *= al0;
        acc[mt][1] *= al1;
        acc[mt][2] *= al0;
        acc[mt][3] *= al1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          uint32_t a[4];
          const int row = row0 + 16 * r + (mi >> 1) * 8 + r8;
          ldmatrix_x4_trans(a, smem_u32(vt_s + (mt / 4) * T * 128 +
                                        swz_offset(row, (mt % 4) * 2 + (mi & 1))));
          mma_bf16(acc[mt], a, ph_b[r][0], ph_b[r][1]);
          mma_bf16(acc[mt], a, pl_b[r][0], pl_b[r][1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  l0 = col_sum(l0);
  l1 = col_sum(l1);

  // merge the warps' (m, l, o) in shared memory (the ring is idle: every
  // tile issued has been consumed); columns at or past D are not kept
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * C::kConsumers));
  float* o_w = reinterpret_cast<float*>(ring);          // [warp][8][D]
  float* m_w = o_w + C::kConsumers * kGB * D;           // [warp][8]
  float* l_w = m_w + C::kConsumers * kGB;               // [warp][8]
#pragma unroll
  for (int mt = 0; mt < W / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = mt * 16 + g + (e >> 1) * 8;
      if (d < D) o_w[(warp * kGB + 2 * t + (e & 1)) * D + d] = acc[mt][e];
    }
  if (g == 0) {
    m_w[warp * kGB + 2 * t] = m0;
    m_w[warp * kGB + 2 * t + 1] = m1;
    l_w[warp * kGB + 2 * t] = l0;
    l_w[warp * kGB + 2 * t + 1] = l1;
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * C::kConsumers));
  for (int i = threadIdx.x; i < GB * D; i += 32 * C::kConsumers) {
    const int h = i / D, d = i % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < C::kConsumers; ++w) m = fmaxf(m, m_w[w * kGB + h]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < C::kConsumers; ++w) {
      const float f = expf(m_w[w * kGB + h] - m);
      o += o_w[(w * kGB + h) * D + d] * f;
      l += l_w[w * kGB + h] * f;
    }
    const size_t row = ((size_t)b * Hq + h0 + h) * ns + s;
    o_part[row * D + d] = o;
    if (d == 0) {
      m_part[row] = m;
      l_part[row] = l;
    }
  }
}

// -- float32: CUDA-core FMAs, rows of W columns -------------------------------

// the largest power of two <= n (n >= 1)
constexpr int floor_pow2(int n) { return n < 2 ? 1 : 2 * floor_pow2(n / 2); }

template <int W>
struct Tile {
  // positions a tile: 16 KB of K at width W, at most 64
  static constexpr int kTokens = floor_pow2(
      kTileBytes / (W * 4) < kMaxStep ? kTileBytes / (W * 4) : kMaxStep);
  static constexpr int kVec = 4;                        // floats per 16 B
  static constexpr int kChunksPerRow = W / kVec;  // rows of W, zero past D
  static constexpr int kChunks = kTokens * kChunksPerRow;
  static constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;
  static constexpr int kPages = kTokens / kMinPage;   // pages a tile, at most
  static constexpr int kCols = (W + kThreads - 1) / kThreads;  // P·V columns
};

template <int W, bool kFull>
__global__ void __launch_bounds__(kThreads)
paged_decode_f32_kernel(const float* __restrict__ q,       // (B, Hq, D)
                        const float* __restrict__ k_pages,  // (P, Hkv, PS, D)
                        const float* __restrict__ v_pages,  // (P, Hkv, PS, D)
                        const int* __restrict__ table,      // (B, NP)
                        const int* __restrict__ lengths,    // (B,)
                        float* __restrict__ o_part,         // (B·Hq, ns, D)
                        float* __restrict__ m_part,         // (B·Hq, ns)
                        float* __restrict__ l_part,         // (B·Hq, ns)
                        int Hq, int Hkv, int D_, int PS, int NP,
                        int span_pages, int ns, int nhb, float scale) {
  using TL = Tile<W>;
  constexpr int TT = TL::kTokens;
  const int D = kFull ? W : D_;
  const int s = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / nhb, hb = blockIdx.y % nhb;
  const int G = Hq / Hkv;
  const int h0 = hk * G + hb * kGB;
  const int GB = min(kGB, G - hb * kGB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int CPR = TL::kChunksPerRow;
  const int dv = D / TL::kVec;             // 16-byte chunks below D

  __shared__ __align__(16) float k_s[TT * W];
  __shared__ __align__(16) float v_s[TT * W];
  __shared__ float q_s[kGB][W];
  __shared__ float w_s[kGB][TT];  // scores, then weights
  __shared__ float m_s[kGB], l_s[kGB], alpha_s[kGB];
  __shared__ int phys_s[TL::kPages];

  // rows of W columns, zero past D (they add nothing)
  for (int i = tid; i < kGB * W; i += kThreads) {
    const int g = i / W, d = i % W;
    q_s[g][d] = g < GB && d < D ? q[((size_t)b * Hq + h0 + g) * D + d] : 0.f;
  }
  for (int c = tid; dv < CPR && c < TL::kChunks; c += kThreads)
    if (c % CPR >= dv) {
      reinterpret_cast<float4*>(k_s)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(v_s)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  if (tid < GB) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // pages packed without slots: tile rows are consecutive positions
  const Walk wk(lengths, b, s, PS, NP, span_pages, TT, PS);
  const int n_tiles = wk.end > wk.begin ? wk.n_tiles() : 0;
  const size_t page_stride = (size_t)Hkv * PS * D;
  const float* k_head = k_pages + (size_t)hk * PS * D;
  const float* v_head = v_pages + (size_t)hk * PS * D;
  const int* trow = table + (size_t)b * NP;

  float acc[TL::kCols][kGB];   // columns tid + 128 c of every head
#pragma unroll
  for (int c = 0; c < TL::kCols; ++c)
#pragma unroll
    for (int g = 0; g < kGB; ++g) acc[c][g] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int pos0 = wk.start(it);
    // valid positions this tile: whole pages, or a chunk of one
    const int nt = min(PS <= TT ? wk.pp * PS : wk.rows(it), wk.end - pos0);
    const int fp = pos0 / PS;                // its first page
    const int np_t = (pos0 + nt - 1) / PS - fp + 1;
    __syncthreads();  // the previous tile's readers are done
    if (tid < np_t) phys_s[tid] = trow[fp + tid];
    __syncthreads();

    // stage K and V: every load of this thread in flight before any store
    float4 kb[TL::kPerThread], vb[TL::kPerThread];
#pragma unroll
    for (int i = 0; i < TL::kPerThread; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / CPR;
      if (row < nt && c % CPR < dv) {
        const int pos = pos0 + row;
        const size_t off = (size_t)phys_s[pos / PS - fp] * page_stride +
                           (size_t)(pos % PS) * D + (c % CPR) * TL::kVec;
        kb[i] = *reinterpret_cast<const float4*>(k_head + off);
        vb[i] = *reinterpret_cast<const float4*>(v_head + off);
      }
    }
#pragma unroll
    for (int i = 0; i < TL::kPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c / CPR < nt && c % CPR < dv) {
        reinterpret_cast<float4*>(k_s)[c] = kb[i];
        reinterpret_cast<float4*>(v_s)[c] = vb[i];
      }
    }
    __syncthreads();

    // scores s[g][t] = (q_g . k_t) * scale (every staged position is valid)
    for (int t = warp; t < nt; t += kWarps) {
      float part[kGB];
#pragma unroll
      for (int g = 0; g < kGB; ++g) part[g] = 0.f;
#pragma unroll
      for (int d = lane; d < W; d += 32) {
        const float kv = k_s[t * W + d];
#pragma unroll
        for (int g = 0; g < kGB; ++g)
          if (g < GB) part[g] = fmaf(q_s[g][d], kv, part[g]);
      }
#pragma unroll
      for (int g = 0; g < kGB; ++g) {
        if (g < GB) {
          const float sc = warp_sum(part[g]);
          if (lane == 0) w_s[g][t] = sc * scale;
        }
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per query head
    for (int g = warp; g < GB; g += kWarps) {
      const int t0 = lane, t1 = lane + 32;
      const float s0 = t0 < nt ? w_s[g][t0] : kNegInf;
      const float s1 = t1 < nt ? w_s[g][t1] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_prev - m_new);
      const float e0 = t0 < nt ? expf(s0 - m_new) : 0.f;
      const float e1 = t1 < nt ? expf(s1 - m_new) : 0.f;
      if (t0 < nt) w_s[g][t0] = e0;
      if (t1 < nt) w_s[g][t1] = e1;
      const float sum = warp_sum(e0 + e1);
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha + sum_t p[g][t] * v[t][d], float32 throughout
    // (thread tid owns output columns tid + 128 c of every head)
#pragma unroll
    for (int c = 0; c < TL::kCols; ++c) {
      const int d = tid + c * kThreads;
      if (d < W) {
#pragma unroll
        for (int g = 0; g < kGB; ++g)
          if (g < GB) acc[c][g] *= alpha_s[g];
        for (int t = 0; t < nt; ++t) {
          const float vv = v_s[t * W + d];
#pragma unroll
          for (int g = 0; g < kGB; ++g)
            if (g < GB) acc[c][g] = fmaf(w_s[g][t], vv, acc[c][g]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kGB; ++g) {
    if (g < GB) {
      const size_t row = ((size_t)b * Hq + h0 + g) * ns + s;
#pragma unroll
      for (int c = 0; c < TL::kCols; ++c) {
        const int d = tid + c * kThreads;
        if (d < D) o_part[row * D + d] = acc[c][g];
      }
      if (tid == 0) {
        m_part[row] = m_s[g];
        l_part[row] = l_s[g];
      }
    }
  }
}

// -- the log-sum-exp combine --------------------------------------------------

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One CTA of D threads per (b·Hq + h) row: merges the row's ns partials
// and writes the output in q's type (zeros where the merged l is 0).
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ o_part,
                                     const float* __restrict__ m_part,
                                     const float* __restrict__ l_part,
                                     T* __restrict__ out, int ns, int D) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* m = m_part + row * ns;
  const float* l = l_part + row * ns;
  float mg = kNegInf;
  for (int s = 0; s < ns; ++s) mg = fmaxf(mg, m[s]);
  float lg = 0.f, o = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float w = expf(m[s] - mg);
    lg += l[s] * w;
    o += o_part[(row * ns + s) * D + d] * w;
  }
  store_out(out + row * D + d, o / (lg == 0.f ? 1.f : lg));
}

// -- launches -----------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *table, *lengths;
  void *o, *m, *l;
  int B, Hq, Hkv, P, D, PS, NP, span_pages, ns, nhb;
  float scale;
};

// a span is whole tiles: whole page groups where a page fits the tile
bool span_ok(const Args& a, int T, int slot) {
  return a.PS > T || a.span_pages % (T / slot) == 0;
}

template <int W, bool kFull>
int launch_tc(const Args& a, cudaStream_t st) {
  using C = Tc<W>;
  if (!span_ok(a, C::kT, (a.PS + 7) & ~7)) return (int)cudaErrorInvalidValue;
  const uint32_t box = a.PS < C::kT ? a.PS : C::kT;
  const uint64_t slices = (uint64_t)a.P * a.Hkv;
  CUtensorMap tk, tv;
  int e = encode_tensor_map_3d(&tk, a.k, a.D, a.PS, slices, box);
  if (!e) e = encode_tensor_map_3d(&tv, a.v, a.D, a.PS, slices, box);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      paged_decode_bf16_kernel<W, kFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  paged_decode_bf16_kernel<W, kFull>
      <<<dim3(a.ns, a.Hkv * a.nhb, a.B), C::kThreads, C::kSmem, st>>>(
          tk, tv, (const __nv_bfloat16*)a.q, (const int*)a.table,
          (const int*)a.lengths, (float*)a.o, (float*)a.m, (float*)a.l,
          a.Hq, a.Hkv, a.D, a.PS, a.NP, a.span_pages, a.ns, a.nhb, a.scale);
  return (int)cudaGetLastError();
}

template <int W>
int launch_bf16(const Args& a, cudaStream_t st) {
  return a.D == W ? launch_tc<W, true>(a, st) : launch_tc<W, false>(a, st);
}

template <int W>
int launch_f32(const Args& a, cudaStream_t st) {
  if (!span_ok(a, Tile<W>::kTokens, a.PS)) return (int)cudaErrorInvalidValue;
  auto kern = a.D == W ? paged_decode_f32_kernel<W, true>
                       : paged_decode_f32_kernel<W, false>;
  kern<<<dim3(a.ns, a.Hkv * a.nhb, a.B), kThreads, 0, st>>>(
          (const float*)a.q, (const float*)a.k, (const float*)a.v,
          (const int*)a.table, (const int*)a.lengths, (float*)a.o,
          (float*)a.m, (float*)a.l, a.Hq, a.Hkv, a.D, a.PS, a.NP,
          a.span_pages, a.ns, a.nhb, a.scale);
  return (int)cudaGetLastError();
}

int launch_split(const Args& a, int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    if (a.D % 8) return (int)cudaErrorInvalidValue;
    if (a.D <= 64) return launch_bf16<64>(a, st);
    if (a.D <= 128) return launch_bf16<128>(a, st);
    return launch_bf16<256>(a, st);
  }
  if (a.D % 4) return (int)cudaErrorInvalidValue;
  if (a.D <= 64) return launch_f32<64>(a, st);
  if (a.D <= 128) return launch_f32<128>(a, st);
  return launch_f32<256>(a, st);
}

}  // namespace

// q (B, Hq, 1, D), k/v pools (P, Hkv, PS, D), table (B, NP) int32, lengths
// (B,) int32, out (B, Hq, 1, D); all contiguous on one device and 16-byte
// aligned, q, pools and out of one type (is_bf16: bfloat16, else float32);
// D up to 256, a multiple of 8 in bf16 and of 4 in float32; any Hq / Hkv;
// PS >= 2; span_pages a whole number of tiles (a multiple of the pages a
// tile holds where a page fits the tile; core/families/paged_attention.py
// `pages_per_step`, `span_pages`).  o_part (B·Hq, ns, D), m_part and
// l_part (B·Hq, ns), ns = ceil(NP / span_pages), are float32 scratch for
// the spans' partials.  Enqueues the split walk, then the combine; returns
// the CUDA error code of the launches (0 on success).
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, void* o_part,
                                   void* m_part, void* l_part, void* out,
                                   int B, int Hq, int Hkv, int P, int D,
                                   int PS, int NP, int span_pages,
                                   float scale, int is_bf16, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq < Hkv || P <= 0 ||
      D <= 0 || D > kMaxD || PS < kMinPage || NP <= 0 || span_pages <= 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Args a;
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.table = table;
  a.lengths = lengths;
  a.o = o_part;
  a.m = m_part;
  a.l = l_part;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.P = P;
  a.D = D;
  a.PS = PS;
  a.NP = NP;
  a.span_pages = span_pages;
  a.ns = (NP + span_pages - 1) / span_pages;
  a.nhb = (Hq / Hkv + kGB - 1) / kGB;
  a.scale = scale;
  if ((long long)Hkv * a.nhb > 65535) return (int)cudaErrorInvalidValue;
  const int e = launch_split(a, is_bf16, st);
  if (e) return e;
  const unsigned rows = (unsigned)B * (unsigned)Hq;
  if (is_bf16)
    paged_combine_kernel<__nv_bfloat16><<<rows, D, 0, st>>>(
        (const float*)o_part, (const float*)m_part, (const float*)l_part,
        (__nv_bfloat16*)out, a.ns, D);
  else
    paged_combine_kernel<float><<<rows, D, 0, st>>>(
        (const float*)o_part, (const float*)m_part, (const float*)l_part,
        (float*)out, a.ns, D);
  return (int)cudaGetLastError();
}
