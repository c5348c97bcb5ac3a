// Paged-attention decode for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/paged_attention.py
// (`paged_decode` at :89, its pallas_call at :136, body `_decode_kernel`):
// single-token GQA decode over a block-table KV pool, q (B, Hq, 1, D)
// against pools (P, Hkv, PS, D) through a table (B, NP) of physical pages,
// masked by each row's length, with a float32 (m, l, acc) carry; its
// weights p stay float32 and V is cast up (paged_attention.py:74-76: a
// p -> bf16 downcast visibly perturbs decode logits).  A row of length 0
// gives zeros.
//
// What bounds it on the H100: memory.  A row reads the K and V of the
// positions its length covers, sum_b len_b * Hkv * D * 2 * sizeof(T) bytes
// (134 MB at the family's production problem, 32 rows x 8192 tokens in
// 128-token pages: 0.040 ms at 3.35 TB/s), and does 4 * G * D operations
// per position, far below the card's ~295 operations per byte.  So the
// design reads each K/V element once, keeps many copies in flight on every
// SM, and keeps the products off the critical path.
//
// Design: a split page walk.
//   * Each row's positions are cut into `ns` spans of span_pages pages,
//     a number the wrapper derives from the shapes (B, Hkv, NP, PS) alone
//     (core/families/paged_attention.py `span_pages`), never from the
//     lengths, so the grid is fixed for a decode geometry; the host never
//     reads the lengths.  One CTA per (span, KV head, row) serves the
//     G = Hq / Hkv <= 8 query heads of its KV head, so each K/V element is
//     read once.  A span that starts at or past its row's length writes an
//     empty partial (m = -1e30, l = 0, o = 0) and exits.  Each span writes
//     float32 partials o (B·Hq, ns, D), m and l (B·Hq, ns); a second
//     kernel on the same stream merges them by log-sum-exp and writes the
//     output in q's type, or zeros where the merged l is 0.
//   * bf16 at head_dim 64, 80, 128 and 256 (paged_decode_bf16_kernel): a
//     producer warp reads the span's table entries from device memory, 32
//     at a time into its lanes (the TPU kernel's scalar prefetch), and
//     copies the page tiles by TMA into a three-stage ring of 16 KB K and
//     V tiles with full/empty mbarriers, two CTAs an SM: 64 positions at
//     D = 128, 128 at D = 64, 32 at D = 256; at D = 80, D = 128's tiles
//     with the maps declared at 80 columns, so that TMA's zero fill
//     supplies columns 80..127, which no product reads (the HBM bytes
//     stay those of 80).  The pool is viewed as a 3-D tensor (D, PS,
//     P·Hkv): a box of min(PS, tile) rows at (column, row in page,
//     phys·Hkv + hk), so a page of 8 to 256 tokens that divides the
//     tile, or is divided by it,
//     lands as one or several 1024-byte-aligned boxes of a 128-byte-
//     swizzled tile.  Only pages holding a valid position are copied:
//     pages wholly past the length, and so the null page and foreign
//     pages, are never read.  Four consumer warps (two at D = 256) each
//     take 16 (D = 80, 128, 256) or 32 (D = 64) positions of every tile
//     (64-position 32 KB tiles at one CTA an SM measured slower at D =
//     256: PERF.md): Sᵀ = K·Qᵀ with the G heads
//     as mma.sync's n = 8 (K by ldmatrix, Q in registers, zero past G),
//     and Oᵀ = Vᵀ·Pᵀ with V by ldmatrix.trans.  p keeps the TPU kernel's
//     float32 accuracy: it is split into p_hi = bf16(p) and p_lo =
//     bf16(p - p_hi), two products into one float32 accumulator (p_hi
//     alone would move ~39% of the bf16 outputs by a step).  Positions past
//     the length contribute exactly nothing: their scores are selected to
//     -1e30, their p is 0, and the V rows of a partial tile are zeroed
//     before the product, so whatever the pool holds there (a poisoned
//     page, a stale stage) never reaches the output.  The running max is
//     updated once per warp's slice of a tile; the warps' (m, l, o) merge
//     in shared memory at the span's end.
//   * float32 pools, and bf16 at head_dim 8, 16 and 32, which only
//     reduced configurations reach (paged_decode_f32_kernel): the same
//     split walk on CUDA-core FMAs (TF32 stays off): a CTA of 128
//     threads stages each tile of up to 64 positions (at most 16 KB, a
//     power of two positions: 32 in float32 at head_dim 80, 16 at 256)
//     with 16-byte loads through the table,
//     scores with each warp taking whole positions, the softmax one warp
//     per head, P·V with each thread owning the output columns d ≡ tid
//     (mod 128), p in float32.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxG = 8;           // query heads per KV head
constexpr int kTileBytes = 16384;  // one K (or V) tile
constexpr int kMaxStep = 64;       // positions a tile, CUDA-core kernel
constexpr int kThreads = 128;      // CUDA-core kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMinPage = 8, kMaxPage = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// The valid positions [begin, end) of span s of row b: the span's pages,
// cut at the row's length (clamped to the table).
struct Span {
  int begin, end;
};
__device__ __forceinline__ Span span_of(const int* lengths, int b, int s,
                                        int PS, int NP, int span_pages) {
  const int len = max(0, min(lengths[b], NP * PS));
  Span sp;
  sp.begin = s * span_pages * PS;
  sp.end = min(sp.begin + span_pages * PS, len);
  return sp;
}

// -- bf16 at head_dim 64, 80, 128, 256: tensor cores, TMA through the table --

template <int D>
struct Tc {
  // head_dim 80 lands in D = 128's tile: the maps are declared at 80
  // columns, TMA's zero fill supplies 80..127, which no product reads
  static constexpr int kDP = D == 80 ? 128 : D;    // columns in shared memory
  static constexpr int kR = kDP < 128 ? 128 / kDP : 1;  // 16-row slabs a warp
  // consumer warps: a 16 KB tile at head_dim 256 is 32 positions, two
  // 16-row slabs
  static constexpr int kConsumers = D == 256 ? 2 : 4;
  static constexpr int kT = 16 * kR * kConsumers;  // positions a tile
  static constexpr int kPanels = kDP / 64;
  static constexpr int kTile = kT * kDP * 2;       // bytes of K (or V)
  static constexpr int kStages = 3;
  static constexpr int kThreads = 32 * (kConsumers + 1);
  static constexpr int kSmem = 1024 + kStages * 2 * kTile + 16 * kStages;
  static_assert(kTile == kTileBytes, "16 KB tiles");
};

template <int D>
__global__ void __launch_bounds__(Tc<D>::kThreads, 2)
paged_decode_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __nv_bfloat16* __restrict__ q,  // (B, Hq, D)
                         const int* __restrict__ table,        // (B, NP)
                         const int* __restrict__ lengths,      // (B,)
                         float* __restrict__ o_part,  // (B·Hq, ns, D)
                         float* __restrict__ m_part,  // (B·Hq, ns)
                         float* __restrict__ l_part,  // (B·Hq, ns)
                         int Hq, int Hkv, int PS, int NP, int span_pages,
                         int ns, float scale) {
  using C = Tc<D>;
  constexpr int T = C::kT, R = C::kR, TB = C::kTile, NST = C::kStages;
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NST * 2 * TB);
  uint64_t* empty = full + NST;

  const Span sp = span_of(lengths, b, s, PS, NP, span_pages);
  const int n_tiles = sp.end > sp.begin ? (sp.end - sp.begin + T - 1) / T
                                        : 0;
  if (n_tiles == 0) {
    // a span wholly past its row's length writes the empty partial and
    // exits before any barrier or load (most spans of a decode batch of
    // mixed lengths)
    for (int i = threadIdx.x; i < G * D; i += C::kThreads) {
      const size_t row = ((size_t)b * Hq + hk * G + i / D) * ns + s;
      o_part[row * D + i % D] = 0.f;
      if (i % D == 0) {
        m_part[row] = kNegInf;
        l_part[row] = 0.f;
      }
    }
    return;
  }

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
    // lane 0 copies each tile's pages that hold a valid position
    const int box = min(PS, T);        // rows of one TMA box
    const int* trow = table + (size_t)b * NP;
    int base = -32, mine = 0;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % NST, ph = (i / NST) & 1;
      const int t0 = sp.begin + i * T;
      const int nb = min(T / box, (sp.end - t0 + box - 1) / box);
      mbar_wait(&empty[st], ph ^ 1);
      // whole boxes, zero-filled columns included
      if (lane == 0)
        mbar_expect_tx(&full[st], 2 * nb * box * C::kPanels * 128);
      unsigned char* kd = ring + st * 2 * TB;
      for (int j = 0; j < nb; ++j) {
        const int pos = t0 + j * box, pg = pos / PS;
        if (pg < base || pg >= base + 32) {          // uniform in the warp
          base = pg;
          mine = pg + lane < NP ? trow[pg + lane] : 0;
        }
        const int phys = __shfl_sync(0xffffffffu, mine, pg - base);
        if (lane == 0) {
#pragma unroll
          for (int pn = 0; pn < C::kPanels; ++pn) {
            const int off = pn * T * 128 + j * box * 128;
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
  // products take the D / 16 slabs of real columns.
  // Qᵀ as the B operand (8 heads, zero past G): element (d, head g)
  uint32_t qb[D / 16][2];
  {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + ((size_t)b * Hq + hk * G + min(g, G - 1)) * D);
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      qb[kt][0] = g < G ? qrow[kt * 8 + t] : 0u;
      qb[kt][1] = g < G ? qrow[kt * 8 + 4 + t] : 0u;
    }
  }
  // Oᵀ accumulator: m-tile mt holds d in [16mt, 16mt + 16), heads 2t, 2t+1
  float acc[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // heads 2t and 2t + 1
  float l0 = 0.f, l1 = 0.f;           // this lane's share of their sums
  const int row0 = warp * 16 * R;     // first row of this warp in a tile
  const int mi = lane >> 3, r8 = lane & 7;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NST, ph = (i / NST) & 1;
    const int nt = min(T, sp.end - sp.begin - i * T);   // valid rows
    unsigned char* kt_s = ring + st * 2 * TB;
    unsigned char* vt_s = kt_s + TB;
    mbar_wait(&full[st], ph);
    if (nt < T) {
      // rows past the valid positions hold a page's tail or a stale
      // stage: zero this warp's V rows there, so that p = 0 meets zero
      bool wrote = false;
      for (int c = lane; c < 16 * R * C::kPanels * 8; c += 32) {
        const int row = row0 + c / (C::kPanels * 8);
        const int pn = (c / 8) % C::kPanels;
        if (row >= nt) {
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
      for (int kt = 0; kt < D / 16; ++kt) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(kt_s + (kt / 4) * T * 128 +
                                swz_offset(row, (kt % 4) * 2 + (mi >> 1))));
        mma_bf16(sc[r], a, qb[kt][0], qb[kt][1]);
      }
    }

    // scores past the valid positions selected to -1e30; online softmax
    // (natural-log max, exp2f with log2(e) folded in)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 16 * r + g + (e >> 1) * 8;
        const float x = row < nt ? sc[r][e] * scale : kNegInf;
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
        const int row = row0 + 16 * r + g + (e >> 1) * 8;
        pe[e] = row < nt ? exp2f((sc[r][e] - ((e & 1) ? mn1 : mn0)) * kLog2e)
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
    for (int mt = 0; mt < D / 16; ++mt) {
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
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  l0 = col_sum(l0);
  l1 = col_sum(l1);

  // merge the four warps' (m, l, o) in shared memory (the ring is idle:
  // every tile issued has been consumed)
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * C::kConsumers));
  float* o_w = reinterpret_cast<float*>(ring);          // [warp][8][D]
  float* m_w = o_w + C::kConsumers * kMaxG * D;         // [warp][8]
  float* l_w = m_w + C::kConsumers * kMaxG;             // [warp][8]
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_w[(warp * kMaxG + 2 * t + (e & 1)) * D + mt * 16 + g + (e >> 1) * 8] =
          acc[mt][e];
  if (g == 0) {
    m_w[warp * kMaxG + 2 * t] = m0;
    m_w[warp * kMaxG + 2 * t + 1] = m1;
    l_w[warp * kMaxG + 2 * t] = l0;
    l_w[warp * kMaxG + 2 * t + 1] = l1;
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * C::kConsumers));
  for (int i = threadIdx.x; i < G * D; i += 32 * C::kConsumers) {
    const int h = i / D, d = i % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < C::kConsumers; ++w) m = fmaxf(m, m_w[w * kMaxG + h]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < C::kConsumers; ++w) {
      const float f = expf(m_w[w * kMaxG + h] - m);
      o += o_w[(w * kMaxG + h) * D + d] * f;
      l += l_w[w * kMaxG + h] * f;
    }
    const size_t row = ((size_t)b * Hq + hk * G + h) * ns + s;
    o_part[row * D + d] = o;
    if (d == 0) {
      m_part[row] = m;
      l_part[row] = l;
    }
  }
}

// -- float32 (and bf16 at head_dim 8 / 16 / 32): CUDA-core FMAs --------------

// the largest power of two <= n (n >= 1)
constexpr int floor_pow2(int n) { return n < 2 ? 1 : 2 * floor_pow2(n / 2); }

template <typename T, int D>
struct Tile {
  // positions a tile: a power of two, so that a page of 8..256 tokens
  // divides it or is divided by it
  static constexpr int kTokens = floor_pow2(
      kTileBytes / (D * (int)sizeof(T)) < kMaxStep
          ? kTileBytes / (D * (int)sizeof(T))
          : kMaxStep);
  static constexpr int kVec = 16 / (int)sizeof(T);    // elements per 16 B
  static constexpr int kChunksPerRow = D / kVec;
  static constexpr int kChunks = kTokens * kChunksPerRow;
  static constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;
  static constexpr int kPages = kTokens / kMinPage;   // pages a tile, at most
  static constexpr int kCols = (D + kThreads - 1) / kThreads;  // P·V columns
  static_assert(D % kVec == 0, "rows of whole 16-byte vectors");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_f32_kernel(const T* __restrict__ q,         // (B, Hq, D)
                        const T* __restrict__ k_pages,   // (P, Hkv, PS, D)
                        const T* __restrict__ v_pages,   // (P, Hkv, PS, D)
                        const int* __restrict__ table,   // (B, NP)
                        const int* __restrict__ lengths,  // (B,)
                        float* __restrict__ o_part,      // (B·Hq, ns, D)
                        float* __restrict__ m_part,      // (B·Hq, ns)
                        float* __restrict__ l_part,      // (B·Hq, ns)
                        int Hq, int Hkv, int PS, int NP, int span_pages,
                        int ns, float scale) {
  using TL = Tile<T, D>;
  constexpr int TT = TL::kTokens;
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ __align__(16) T k_s[TT * D];
  __shared__ __align__(16) T v_s[TT * D];
  __shared__ float q_s[kMaxG][D];
  __shared__ float w_s[kMaxG][TT];  // scores, then weights
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  __shared__ int phys_s[TL::kPages];

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[g][d] = to_f32(q[((size_t)b * Hq + hk * G + g) * D + d]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const Span sp = span_of(lengths, b, s, PS, NP, span_pages);
  const size_t page_stride = (size_t)Hkv * PS * D;
  const T* k_head = k_pages + (size_t)hk * PS * D;
  const T* v_head = v_pages + (size_t)hk * PS * D;
  const int* trow = table + (size_t)b * NP;

  float acc[TL::kCols][kMaxG];   // columns tid + 128 c of every head
#pragma unroll
  for (int c = 0; c < TL::kCols; ++c)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[c][g] = 0.f;

  for (int pos0 = sp.begin; pos0 < sp.end; pos0 += TT) {
    const int nt = min(TT, sp.end - pos0);   // valid positions this tile
    const int fp = pos0 / PS;                // its first page
    const int np_t = (pos0 + nt - 1) / PS - fp + 1;
    __syncthreads();  // the previous tile's readers are done
    if (tid < np_t) phys_s[tid] = trow[fp + tid];
    __syncthreads();

    // stage K and V: every load of this thread in flight before any store
    uint4 kb[TL::kPerThread], vb[TL::kPerThread];
#pragma unroll
    for (int i = 0; i < TL::kPerThread; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / TL::kChunksPerRow;
      if (c < TL::kChunks && row < nt) {
        const int pos = pos0 + row;
        const size_t off = (size_t)phys_s[pos / PS - fp] * page_stride +
                           (size_t)(pos % PS) * D +
                           (c % TL::kChunksPerRow) * TL::kVec;
        kb[i] = *reinterpret_cast<const uint4*>(k_head + off);
        vb[i] = *reinterpret_cast<const uint4*>(v_head + off);
      }
    }
#pragma unroll
    for (int i = 0; i < TL::kPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c < TL::kChunks && c / TL::kChunksPerRow < nt) {
        reinterpret_cast<uint4*>(k_s)[c] = kb[i];
        reinterpret_cast<uint4*>(v_s)[c] = vb[i];
      }
    }
    __syncthreads();

    // scores s[g][t] = (q_g . k_t) * scale (every staged position is valid)
    for (int t = warp; t < nt; t += kWarps) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float kv = to_f32(k_s[t * D + d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) part[g] = fmaf(q_s[g][d], kv, part[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float sc = warp_sum(part[g]);
          if (lane == 0) w_s[g][t] = sc * scale;
        }
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
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
      if (d < D) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[c][g] *= alpha_s[g];
        for (int t = 0; t < nt; ++t) {
          const float vv = to_f32(v_s[t * D + d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[c][g] = fmaf(w_s[g][t], vv, acc[c][g]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const size_t row = ((size_t)b * Hq + hk * G + g) * ns + s;
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
  int B, Hq, Hkv, P, PS, NP, span_pages, ns;
  float scale;
};

template <int D>
int launch_bf16(const Args& a, cudaStream_t st) {
  using C = Tc<D>;
  if ((C::kT % a.PS && a.PS % C::kT) || (a.span_pages * a.PS) % C::kT)
    return (int)cudaErrorInvalidValue;
  const uint32_t box = a.PS < C::kT ? a.PS : C::kT;
  const uint64_t slices = (uint64_t)a.P * a.Hkv;
  CUtensorMap tk, tv;
  int e = encode_tensor_map_3d(&tk, a.k, D, a.PS, slices, box);
  if (!e) e = encode_tensor_map_3d(&tv, a.v, D, a.PS, slices, box);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      paged_decode_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  paged_decode_bf16_kernel<D>
      <<<dim3(a.ns, a.Hkv, a.B), C::kThreads, C::kSmem, st>>>(
          tk, tv, (const __nv_bfloat16*)a.q, (const int*)a.table,
          (const int*)a.lengths, (float*)a.o, (float*)a.m, (float*)a.l,
          a.Hq, a.Hkv, a.PS, a.NP, a.span_pages, a.ns, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_f32(const Args& a, cudaStream_t st) {
  constexpr int TT = Tile<T, D>::kTokens;
  if ((TT % a.PS && a.PS % TT) || (a.span_pages * a.PS) % TT)
    return (int)cudaErrorInvalidValue;
  paged_decode_f32_kernel<T, D><<<dim3(a.ns, a.Hkv, a.B), kThreads, 0, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.table,
      (const int*)a.lengths, (float*)a.o, (float*)a.m, (float*)a.l, a.Hq,
      a.Hkv, a.PS, a.NP, a.span_pages, a.ns, a.scale);
  return (int)cudaGetLastError();
}

int launch_split(const Args& a, int D, int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    switch (D) {
      case 8: return launch_f32<__nv_bfloat16, 8>(a, st);
      case 16: return launch_f32<__nv_bfloat16, 16>(a, st);
      case 32: return launch_f32<__nv_bfloat16, 32>(a, st);
      case 64: return launch_bf16<64>(a, st);
      case 80: return launch_bf16<80>(a, st);
      case 128: return launch_bf16<128>(a, st);
      case 256: return launch_bf16<256>(a, st);
    }
  } else {
    switch (D) {
      case 8: return launch_f32<float, 8>(a, st);
      case 16: return launch_f32<float, 16>(a, st);
      case 32: return launch_f32<float, 32>(a, st);
      case 64: return launch_f32<float, 64>(a, st);
      case 80: return launch_f32<float, 80>(a, st);
      case 128: return launch_f32<float, 128>(a, st);
      case 256: return launch_f32<float, 256>(a, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, 1, D), k/v pools (P, Hkv, PS, D), table (B, NP) int32, lengths
// (B,) int32, out (B, Hq, 1, D); all contiguous on one device and 16-byte
// aligned, q, pools and out of one type (is_bf16: bfloat16, else float32);
// D in {8, 16, 32, 64, 80, 128, 256}; Hq / Hkv <= 8; PS in [8, 256], dividing the
// instance's tile or divided by it, and span_pages · PS a multiple of the
// tile (core/families/paged_attention.py `tile_tokens`, `span_pages`).
// o_part (B·Hq, ns, D), m_part and l_part (B·Hq, ns), ns = ceil(NP /
// span_pages), are float32 scratch for the spans' partials.  Enqueues the
// split walk, then the combine; returns the CUDA error code of the
// launches (0 on success).
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, void* o_part,
                                   void* m_part, void* l_part, void* out,
                                   int B, int Hq, int Hkv, int P, int D,
                                   int PS, int NP, int span_pages,
                                   float scale, int is_bf16, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || P <= 0 ||
      PS < kMinPage || PS > kMaxPage || NP <= 0 || span_pages <= 0 ||
      B > 65535 || Hkv > 65535)
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
  a.PS = PS;
  a.NP = NP;
  a.span_pages = span_pages;
  a.ns = (NP + span_pages - 1) / span_pages;
  a.scale = scale;
  const int e = launch_split(a, D, is_bf16, st);
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
