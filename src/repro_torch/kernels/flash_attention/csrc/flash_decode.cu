// Split-KV flash decode for Hopper (sm_90a), plain C entry point.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/decode.py (`flash_decode`, body
// `_decode_kernel`, and the log-sum-exp combine that follows it): one
// query token per (batch row, query head), q (B, Hq, 1, D), against a
// dense cache k, v (B, Hkv, S, D) of which the first kv_len positions are
// valid (one length shared by every row, read from a device int32 so the
// host never waits).  The cache is cut into kv_splits spans of
// S / kv_splits positions; each span writes float32 partials o (B·Hq, ns,
// D), m and l (B·Hq, ns): its max, its sum of exp(s - m), and its
// unnormalised sum of p·v.  p is cast to v's type before P·V, as the TPU
// kernel does, and l sums the float32 p.  A span with no valid position
// writes m = -1e30, l = 0, o = 0, as the TPU kernel does.  A second
// kernel, enqueued by the same entry point, merges the partials (the
// TPU path's XLA epilogue) and writes o (B, Hq, 1, D) in q's type; a row
// whose merged l is 0 writes zeros.
//
// It takes any head_dim and any group G = Hq / Hkv, as the TPU kernel
// does: the designs below take rows of whole 16-byte vectors (a multiple
// of 8 in bf16, of 4 in float32) up to 256; any other head_dim (rows off
// the 16-byte grain, or above 256) runs on the panel route of
// panel_attention.cuh, one CTA per (span, output panel of 64 or 256
// columns, KV head, head block, row): bf16 on mma.sync with the operands
// swapped as below and p rounded to bf16, float32 on the CUDA cores, the
// span's rows staged by the widest copy they allow (64 positions a tile
// in bf16, 32 in float32), S over 64-column chunks of D, each panel
// recomputing S; its combine walks D in a loop.
//
// Design (bf16).  One CTA per (span, KV head, head block, batch row)
// serves up to 8 query heads of that KV head (the head block: heads [8j,
// 8j + 8) of the G), so for G <= 8 each K/V element of the span is read
// once, where the TPU grid (B·Hq, ns) reads it G times; for G > 8 the
// ceil(G / 8) blocks read it again, mostly from L2.  The operands are
// swapped so that the block's heads fill a tensor-core tile: Sᵀ
// (positions x 8) = K (positions x D) · Qᵀ (D x 8) and Oᵀ (D x 8) = Vᵀ (D
// x positions) · Pᵀ (positions x 8) on mma.sync.m16n8k16, K's fragments
// by ldmatrix, V's by ldmatrix.trans, Q's (zero past the block and past
// D) held in registers, Pᵀ moved from the S accumulator layout to the B
// operand layout by movmatrix.trans after its rounding to bf16.  A
// producer warp streams the span through a three-stage ring of 16 KB K
// and V tiles by TMA with a 128-byte swizzle (conflict-free ldmatrix),
// one "full" and one "empty" mbarrier a stage, and stops at kv_len (a
// tile past it would give alpha = 1 and p = 0: skipping is exact).  The
// tiles come in three widths W = 64, 128 and 256 columns (128, 64 and 32
// positions); head_dim D runs in the least W >= D, with the tensor maps
// declared at D columns, so that TMA's zero fill supplies columns D..W-1
// (HBM bytes stay those of D), the products run over all W columns (the
// zeros add nothing; at D = W the code is the fixed-D code it was) and
// only columns below D are stored.  Four consumer warps
// (two at W = 256) each take 16 (W = 128, 256) or 32 (W = 64) positions
// of every tile and keep their own running max, sum and accumulator,
// merged in shared memory at the span's end; V rows past the valid
// positions of a partial tile are zeroed first, so that whatever the
// cache holds there meets p = 0.  Two CTAs fit an SM, so up to four tiles
// (128 KB) are in flight on each.
//
// The running max is updated once per warp's slice of a tile, where the
// TPU kernel takes the max of its whole span at once: m and l agree to f32
// rounding, and a bf16 p rounded against an earlier max moves o by a
// fraction of a bf16 step.
//
// f32 keeps CUDA-core FMAs (TF32 stays off, as resolve_device sets it):
// one CTA of 128 threads per (span, KV head, head block, row) walks its
// span in tiles of at most 16 KB of K and V staged in shared memory, at
// three widths (64, 128, 256 columns, D at run time below them, or D = W
// at compile time as kFull, where the guards and strides of D fold away);
// scores with each warp taking whole positions and lanes splitting D, the
// softmax one warp per head, P·V with each thread owning the output
// columns d ≡ tid (mod 128) below D.
//
// What bounds it on the H100: memory.  It reads the valid part of the
// cache once, 2·B·Hkv·kv_len·D·sizeof(T) bytes (134 MB at the family's
// production problem, 0.040 ms at 3.35 TB/s), and does 4·G·D operations
// per position, far below the card's ~295 operations per byte.
#include "hopper.cuh"
#include "panel_attention.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;      // f32 kernel
constexpr int kWarps = kThreads / 32;
constexpr int kGB = 8;             // query heads a CTA serves (mma's n)
constexpr int kTileBytes = 16384;  // one K (or V) tile per step
constexpr int kMaxStep = 64;       // positions per step, f32 kernel
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

// -- bf16: tensor cores, TMA ring, tiles of W columns ------------------------

template <int W>
struct Bf16Dec {
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
};

template <int W>
__global__ void __launch_bounds__(Bf16Dec<W>::kThreads, 2)
decode_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __nv_bfloat16* __restrict__ q,  // (B, Hq, D)
                   const int* __restrict__ kv_len,       // () int32
                   float* __restrict__ o_part,           // (B·Hq, ns, D)
                   float* __restrict__ m_part,           // (B·Hq, ns)
                   float* __restrict__ l_part,           // (B·Hq, ns)
                   int Hq, int Hkv, int S, int D, int ns, int nhb,
                   float scale) {
  using C = Bf16Dec<W>;
  constexpr int T = C::kT, R = C::kR, TB = C::kTile, NST = C::kStages;
  const int s = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / nhb, hb = blockIdx.y % nhb;
  const int G = Hq / Hkv, span = S / ns;
  const int h0 = hk * G + hb * kGB;           // first query head served
  const int GB = min(kGB, G - hb * kGB);      // heads served
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NST * 2 * TB);
  uint64_t* empty = full + NST;

  const int len = max(0, min(*kv_len, S));
  const int p_begin = s * span;
  const int p_end = min(p_begin + span, len);   // valid positions: [begin, end)
  const int n_tiles = p_end > p_begin ? (p_end - p_begin + T - 1) / T : 0;
  const int bkv = b * Hkv + hk;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], C::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == C::kConsumers) {
    // producer: K and V tiles of the span, kept NST ahead
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % NST, ph = (i / NST) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], 2 * TB);
        unsigned char* kd = ring + st * 2 * TB;
#pragma unroll
        for (int pn = 0; pn < C::kPanels; ++pn) {
          tma_load_3d(kd + pn * T * 128, &tm_k, pn * 64, p_begin + i * T, bkv,
                      &full[st]);
          tma_load_3d(kd + TB + pn * T * 128, &tm_v, pn * 64, p_begin + i * T,
                      bkv, &full[st]);
        }
      }
    }
    return;
  }

  // consumer warp: rows [warp·16R, warp·16R + 16R) of every tile.
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

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NST, ph = (i / NST) & 1;
    const int nt = min(T, p_end - p_begin - i * T);   // valid rows
    unsigned char* kt_s = ring + st * 2 * TB;
    unsigned char* vt_s = kt_s + TB;
    mbar_wait(&full[st], ph);
    if (nt < T) {
      // rows past the valid positions may hold anything: zero this warp's
      // V rows there, so that p = 0 meets a finite value
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
    const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sc[r][0] = sc[r][1] = sc[r][2] = sc[r][3] = 0.f;
      const int row = row0 + 16 * r + (mi & 1) * 8 + r8;
#pragma unroll
      for (int kt = 0; kt < W / 16; ++kt) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(kt_s + (kt / 4) * T * 128 +
                                swz_offset(row, (kt % 4) * 2 + (mi >> 1))));
        mma_bf16(sc[r], a, qb[kt][0], qb[kt][1]);
      }
    }

    // mask past the valid positions, online softmax (natural-log max,
    // exp2f with log2(e) folded in)
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
    uint32_t pb[R][2];
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
      // p rounded to bf16 (the TPU kernel's p.astype(v.dtype)), then
      // transposed into the B operand: element (position, head g)
      pb[r][0] = movmatrix_trans(pack_bf16(pe[0], pe[1]));
      pb[r][1] = movmatrix_trans(pack_bf16(pe[2], pe[3]));
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;

    // Oᵀ = Oᵀ·alpha + Vᵀ Pᵀ (the rows past D are TMA's zeros)
#pragma unroll
    for (int mt = 0; mt < W / 16; ++mt) {
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
        mma_bf16(acc[mt], a, pb[r][0], pb[r][1]);
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

// -- f32: CUDA-core FMAs, rows of W columns -----------------------------------

template <int W>
struct Tile {
  static constexpr int kTokens =
      kTileBytes / (W * 4) < kMaxStep ? kTileBytes / (W * 4) : kMaxStep;
  static constexpr int kVec = 4;                        // floats per 16 B
  static constexpr int kChunksPerRow = W / kVec;  // rows of W, read below D
  static constexpr int kChunks = kTokens * kChunksPerRow;
  static constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;
  static constexpr int kCols = (W + kThreads - 1) / kThreads;  // P·V columns
};

template <int W, bool kFull>
__global__ void __launch_bounds__(kThreads)
decode_f32_kernel(const float* __restrict__ q,      // (B, Hq, D)
                  const float* __restrict__ k,      // (B, Hkv, S, D)
                  const float* __restrict__ v,      // (B, Hkv, S, D)
                  const int* __restrict__ kv_len,   // () int32
                  float* __restrict__ o_part,       // (B·Hq, ns, D)
                  float* __restrict__ m_part,       // (B·Hq, ns)
                  float* __restrict__ l_part,       // (B·Hq, ns)
                  int Hq, int Hkv, int S, int D_, int ns, int nhb,
                  float scale) {
  using TL = Tile<W>;
  constexpr int TT = TL::kTokens;
  const int D = kFull ? W : D_;
  const int s = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / nhb, hb = blockIdx.y % nhb;
  const int G = Hq / Hkv;
  const int h0 = hk * G + hb * kGB;
  const int GB = min(kGB, G - hb * kGB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = S / ns;
  constexpr int CPR = TL::kChunksPerRow;
  const int dv = D / TL::kVec;             // 16-byte chunks below D

  __shared__ __align__(16) float k_s[TT * W];
  __shared__ __align__(16) float v_s[TT * W];
  __shared__ float q_s[kGB][W];
  __shared__ float w_s[kGB][TT];  // scores, then weights
  __shared__ float m_s[kGB], l_s[kGB], alpha_s[kGB];

  // rows of W columns, zero past D (they add nothing)
  for (int i = tid; i < kGB * W; i += kThreads) {
    const int g = i / W, d = i % W;
    q_s[g][d] = g < GB && d < D ? q[((size_t)b * Hq + h0 + g) * D + d] : 0.f;
  }
  if (tid < GB) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int len = max(0, min(*kv_len, S));
  const int p_begin = s * span;
  const int p_end = min(p_begin + span, len);  // valid positions of the span
  const float* k_head = k + ((size_t)b * Hkv + hk) * S * D;
  const float* v_head = v + ((size_t)b * Hkv + hk) * S * D;

  float acc[TL::kCols][kGB];   // columns tid + 128 c of every head
#pragma unroll
  for (int c = 0; c < TL::kCols; ++c)
#pragma unroll
    for (int g = 0; g < kGB; ++g) acc[c][g] = 0.f;

  for (int pos0 = p_begin; pos0 < p_end; pos0 += TT) {
    const int nt = min(TT, p_end - pos0);  // positions this step
    __syncthreads();  // the previous step's readers of the tiles are done

    // stage K and V: every load of this thread in flight before any store
    float4 kb[TL::kPerThread], vb[TL::kPerThread];
#pragma unroll
    for (int i = 0; i < TL::kPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c / CPR < nt && c % CPR < dv) {
        const size_t off = (size_t)(pos0 + c / CPR) * D +
                           (size_t)(c % CPR) * TL::kVec;
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
#pragma unroll 4
      for (int d = lane; d < W; d += 32) {
        if (d >= D) break;           // the D real columns
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

    // acc[g][d] = acc * alpha + sum_t p[g][t] * v[t][d]
    // (thread tid owns output columns tid + 128 c of every head)
#pragma unroll
    for (int c = 0; c < TL::kCols; ++c) {
      const int d = tid + c * kThreads;
      if (d < D) {
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
// as decode.py's `combine` does, and writes the output in q's type.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ o_part,
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

struct Args {
  const void *q, *k, *v, *kv_len;
  void *o, *m, *l;
  int B, Hq, Hkv, S, D, ns, nhb;
  float scale;
};

template <int W>
int launch_split_bf16(const Args& a, cudaStream_t st) {
  using C = Bf16Dec<W>;
  CUtensorMap tk, tv;
  int e = encode_tensor_map_3d(&tk, a.k, a.D, a.S, (uint64_t)a.B * a.Hkv,
                               C::kT);
  if (!e)
    e = encode_tensor_map_3d(&tv, a.v, a.D, a.S, (uint64_t)a.B * a.Hkv,
                             C::kT);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      decode_bf16_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  decode_bf16_kernel<W>
      <<<dim3(a.ns, a.Hkv * a.nhb, a.B), C::kThreads, C::kSmem, st>>>(
          tk, tv, (const __nv_bfloat16*)a.q, (const int*)a.kv_len,
          (float*)a.o, (float*)a.m, (float*)a.l, a.Hq, a.Hkv, a.S, a.D,
          a.ns, a.nhb, a.scale);
  return (int)cudaGetLastError();
}

// kFull, the compile-time instance, where head_dim is the width itself
template <int W>
int launch_split_f32(const Args& a, cudaStream_t st) {
  auto kern = a.D == W ? decode_f32_kernel<W, true>
                       : decode_f32_kernel<W, false>;
  kern<<<dim3(a.ns, a.Hkv * a.nhb, a.B), kThreads, 0, st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const int*)a.kv_len, (float*)a.o, (float*)a.m, (float*)a.l, a.Hq,
      a.Hkv, a.S, a.D, a.ns, a.nhb, a.scale);
  return (int)cudaGetLastError();
}

int launch_split(const Args& a, int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    if (a.D <= 64) return launch_split_bf16<64>(a, st);
    if (a.D <= 128) return launch_split_bf16<128>(a, st);
    return launch_split_bf16<256>(a, st);
  }
  if (a.D <= 64) return launch_split_f32<64>(a, st);
  if (a.D <= 128) return launch_split_f32<128>(a, st);
  return launch_split_f32<256>(a, st);
}

// -- the panel route: any other head_dim --------------------------------------

// The span's valid positions [begin, end) of a dense cache, in tiles.
template <typename T>
struct DenseRows {
  const T *q, *k, *v;
  float *o_part, *m_part, *l_part;
  int Hq, Hkv, D, ns, nhb, npanel, grain;
  float scale;
  const int* kv_len;
  int S, p_begin, p_end, pos0;
  size_t kv_base;

  __device__ __forceinline__ int begin(int b, int s, int hk, int tt) {
    const int len = max(0, min(*kv_len, S)), span = S / ns;
    p_begin = s * span;
    p_end = min(p_begin + span, len);
    kv_base = ((size_t)b * Hkv + hk) * S;
    return p_end > p_begin ? (p_end - p_begin + tt - 1) / tt : 0;
  }
  __device__ __forceinline__ int tile(int i, int tt) {
    pos0 = p_begin + i * tt;
    return min(tt, p_end - pos0);
  }
  __device__ __forceinline__ long long row_off(int r) const {
    return (long long)(kv_base + pos0 + r) * D;
  }
};

template <typename T>
DenseRows<T> dense_rows(const Args& a, int grain) {
  DenseRows<T> r;
  r.q = static_cast<const T*>(a.q);
  r.k = static_cast<const T*>(a.k);
  r.v = static_cast<const T*>(a.v);
  r.o_part = static_cast<float*>(a.o);
  r.m_part = static_cast<float*>(a.m);
  r.l_part = static_cast<float*>(a.l);
  r.Hq = a.Hq;
  r.Hkv = a.Hkv;
  r.D = a.D;
  r.ns = a.ns;
  r.nhb = a.nhb;
  r.npanel = panel::n_panels(a.D);
  r.grain = grain;
  r.scale = a.scale;
  r.kv_len = static_cast<const int*>(a.kv_len);
  r.S = a.S;
  return r;
}

template <int PW>
int launch_panel(const Args& a, int is_bf16, void* out, cudaStream_t st) {
  const void* ptrs[3] = {a.q, a.k, a.v};
  const int es = is_bf16 ? 2 : 4;
  const int grain = panel::copy_grain((long long)a.D * es, ptrs, 3, es);
  const long long gx = (long long)a.ns * panel::n_panels(a.D);
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, a.Hkv * a.nhb, a.B);
  const unsigned rows = (unsigned)a.B * (unsigned)a.Hq;
  return is_bf16 ? panel::launch_decode<PW, false>(
                       dense_rows<uint16_t>(a, grain), grid, rows, out, st)
                 : panel::launch_decode<PW, false>(
                       dense_rows<float>(a, grain), grid, rows, out, st);
}

}  // namespace

// q (B, Hq, 1, D), k/v (B, Hkv, S, D), kv_len () int32, out (B, Hq, 1, D),
// all on one device and contiguous, q/k/v/out all bf16 (is_bf16) or all
// f32; any D >= 1: a multiple of 8 in bf16 (of 4 in float32) up to 256
// runs on the designs above (16-byte aligned tensors), any other on the
// panel route; any Hq / Hkv; kv_splits divides S.  o_part (B·Hq, ns, D),
// m_part and l_part (B·Hq, ns) are float32 scratch for the spans'
// partials.  Enqueues the split kernel, then the combine.  Returns the
// CUDA error code of the launches (0 on success).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* kv_len,
                                   void* o_part, void* m_part, void* l_part,
                                   void* out, int B, int Hq, int Hkv, int S,
                                   int D, int kv_splits, float scale,
                                   int is_bf16, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq < Hkv || S <= 0 ||
      kv_splits <= 0 || S % kv_splits != 0 || B > 65535 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_len = kv_len;
  a.o = o_part;
  a.m = m_part;
  a.l = l_part;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.D = D;
  a.ns = kv_splits;
  a.nhb = (Hq / Hkv + kGB - 1) / kGB;
  a.scale = scale;
  if ((long long)Hkv * a.nhb > 65535) return (int)cudaErrorInvalidValue;
  if (panel::off_grain(D, is_bf16))
    return D <= 64 ? launch_panel<64>(a, is_bf16, out, st)
                   : launch_panel<256>(a, is_bf16, out, st);
  const int e = launch_split(a, is_bf16, st);
  if (e) return e;
  const unsigned rows = (unsigned)B * (unsigned)Hq;
  if (is_bf16)
    combine_kernel<__nv_bfloat16><<<rows, D, 0, st>>>(
        (const float*)o_part, (const float*)m_part, (const float*)l_part,
        (__nv_bfloat16*)out, a.ns, D);
  else
    combine_kernel<float><<<rows, D, 0, st>>>(
        (const float*)o_part, (const float*)m_part, (const float*)l_part,
        (float*)out, a.ns, D);
  return (int)cudaGetLastError();
}
