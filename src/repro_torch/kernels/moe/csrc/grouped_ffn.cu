// Grouped expert FFN for Hopper (sm_90a): the MoE family's kernel.
//
// Replaces the JAX package's Pallas TPU kernel src/repro/kernels/moe/moe.py
// (`grouped_ffn` at :63, its pallas_call at :80, body `_moe_kernel` at :39) and
// computes what it computes, for each expert e and capacity row c:
//
//   y[e,c] = round( (round_x( silu(x·wg[e]) * (x·wu[e]) ) · wd[e])_f32
//                   * g[e,c] )
//
//   * x (E, C, DM), wg and wu (E, DM, DF), wd (E, DF, DM), y (E, C, DM),
//     all row-major and all bf16 or all f32; g (E, C) float32, or none;
//   * the products are summed in float32 (bf16 products are exact, as on
//     the MXU); silu(h) = h / (1 + exp(-h)), as the TPU kernel writes it;
//   * act = silu(hg) * hu is rounded to x's dtype before the down product
//     (moe.py:50), and the gate scales the float32 sum before the final
//     rounding (moe.py:54-59); with no gate the caller scales in float32;
//   * an empty capacity row (all zeros) gives a zero row.
//
// Design.  The TPU kernel keeps a (block_t, DM) float32 accumulator in
// VMEM across the whole d_ff walk (moe.py:92): 128 x 7168 x 4 B = 3.7 MB
// at the family's production problem, 16 times the 227 KB of shared
// memory an SM gives a block, so it cannot stay on chip here.  Two
// launches on one stream take its place:
//
//   1. gate/up: act[e] = round_x(silu(x[e]·wg[e]) * (x[e]·wu[e])), written
//      to a (E, C, DF) buffer in x's dtype.  That is the TPU kernel's own
//      rounding point, so nothing changes numerically; the cost is
//      2·E·C·DF elements of extra traffic (1.34 GB at the production
//      problem, ~0.4 ms at 3.35 TB/s, against a 14.6 ms operations bound).
//   2. down: y[e] = (act[e]·wd[e]) * g[e], each CTA owning a (rows, DM
//      columns) output tile and walking d_ff in order with its
//      accumulator in registers, the gate in its epilogue.
//
// (One kernel that split DM across CTAs and recomputed the up product for
// each output tile would repeat the up product's 2/3 of the operations
// DM / 128 = 56 times over; the buffer costs 3% of the bound.)
//
// What bounds it.  At the production problem (16,384 tokens, top-8 of 32
// experts, DM 7168, DF 2048, bf16) the kernel computes E·C = 163,840
// capacity rows: 6·E·C·DM·DF = 1.44e13 operations, 14.6 ms at 989
// TFLOP/s, against 7.5 GB of operands (2.2 ms at 3.35 TB/s): operations
// bound it, and only wgmma reaches the tensor cores' full rate on Hopper.
//
// Two designs, chosen by the wrapper from the config and the problem
// alone (core/families/moe.py `is_wgmma`), before any launch:
//
//   * bf16 on wgmma fed by TMA (ffn_wgmma_kernel), when x and the weights
//     are bf16, block_t is a multiple of 64, block_f of 128 and d_model of
//     64.  A CTA owns BM = 128 rows of one expert (64 where block_t is no
//     multiple of 128).  Gate/up: the CTA's 128 d_ff columns of wg and of
//     wu are staged side by side as one 256-column MN-major B, so each
//     consumer warpgroup issues one wgmma m64n256k16 a 16-deep slice (at
//     BM = 64 each warpgroup takes 64 of the columns of both, one
//     m64n128k16); in that accumulator the thread holding hg[r, j] also
//     holds hu[r, j], 64 (32) registers later, so the SwiGLU epilogue,
//     h / (1 + exp(-h)) * hu rounded to bf16 as the TPU writes it, stays
//     in the thread.  Down: act (K-major) · wd (MN-major) on BM x 256
//     tiles, d_ff walked in 64-deep stages in the TPU's f order, each row
//     scaled by its gate in float32 before the one rounding.  3-D tensor
//     maps over (expert, rows, columns) with 128-byte swizzle: a box past
//     an expert's last row or column is zero-filled, never the next
//     expert's.  One producer warp of a third warpgroup (40 registers
//     after setmaxnreg) keeps a four-stage ring full; two consumer
//     warpgroups (232 registers) run the products, one stage's in flight
//     while the previous stage is released.  The grid is persistent: one
//     CTA an SM walks a work list ordered expert by expert, then by config
//     tile (block_t x block_f for gate/up, block_t rows x 256 columns for
//     down), then by the CTA tiles in it, so the CTAs that run together
//     share an expert's weight panels in L2; the producer runs ahead into
//     the next tile's stages while the consumers store.
//   * everything else (f32, block_t 8, 16 or 32, block_f or d_model off
//     those multiples) on the first design, unchanged: one batched tile
//     GEMM templated on the CTA tile TM x TN and on the launch (UP: two B
//     operands, wg and wu, and the SwiGLU epilogue; else one, wd, and the
//     gate epilogue).  One CTA of 128 threads (four warps) computes a
//     TM x TN tile of one expert, TM in {16, 32, 64, 128}, TN in {32, 64}
//     (gate/up, two accumulators) or {64, 128} (down).  The caller picks
//     the largest TM dividing block_t (16 with the rest of the rows masked
//     when none does, as for block_t 8) and the largest gate/up TN
//     dividing block_f; a larger config tile (block_t x block_f) is
//     covered by several CTAs launched one after another, so that they
//     share the tile's operand panels in L2.  The depth (DM, then DF) is
//     staged through shared memory in 32-deep chunks, two stages deep, by
//     16-byte cp.async copies with zero-fill past the edge, where DM, DF,
//     block_f and every pointer are whole 16-byte vectors; any other
//     problem (d_model 100 or d_ff 60 in bf16, d_model 50 in float32, as
//     the TPU kernel takes them) is staged element by element (`narrow`),
//     each element zero-filled past the edge and the tail columns masked
//     on store, in the same shared-memory layout.  bf16
//     products run on the tensor cores with mma.sync.m16n8k16 (f32
//     accumulator fragments in registers); f32 products run as FMAs on
//     the CUDA cores, since the tensor cores would take f32 only as TF32
//     and the port keeps TF32 off.
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int KC = 32;       // depth of one shared-memory stage
constexpr int STAGES = 2;

template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;   // elements in 16 bytes
  static constexpr int PAD = 8;   // row padding: 16 bytes
};
template <> struct Elem<float> {
  static constexpr int VEC = 4;
  static constexpr int PAD = 4;
};

// One launch: for every expert e, C[e] (m, n) = A[e] (m, k) · B[e] (k, n)
// (two B operands in the gate/up launch), with the launch's epilogue.
struct Params {
  const void* a;        // x (gate/up) or act (down)
  const void* b0;       // wg (gate/up) or wd (down)
  const void* b1;       // wu (gate/up); unused (down)
  const float* gate;    // (E, m) gate of each row (down, fused), or null
  void* c;              // act (gate/up) or y (down)
  int m, n, k;          // per expert
  int bm, bn;           // the config tile (rows, columns)
  int subm, subn;       // CTAs per config tile along rows and columns
  int mi, nj;           // config tiles per expert along rows and columns
  int narrow;           // rows off the 16-byte grain: element copies
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch rounds
}

// The float32 value a launch writes for one output: gate/up —
// silu(hg) * hu (rounded by the caller to x's type); down — the sum,
// scaled by its row's gate when there is one.
template <bool UP>
__device__ __forceinline__ float finish(float a0, float a1, const float* G,
                                        int r) {
  if constexpr (UP) {
    return a0 / (1.f + expf(-a0)) * a1;
  } else {
    return G ? a0 * G[r] : a0;
  }
}

// Stage chunk [k0, k1) of the depth: A rows [row0, row_lim) and the B
// panels' columns [col0, col_lim), zero past either edge.  Every 16-byte
// vector lies wholly inside or wholly outside (k, n, the config tile's
// columns and k0 are multiples of a vector) unless `narrow`, where every
// element is copied on its own.
template <typename T, int TM, int TN, int NB>
__device__ __forceinline__ void load_chunk_narrow(const T* A, const T* B0,
                                                  const T* B1, int k, int n,
                                                  T* As, T* Bs, int row0,
                                                  int row_lim, int col0,
                                                  int col_lim, int k0,
                                                  int k1) {
  constexpr int LDA = KC + Elem<T>::PAD;
  constexpr int LDB = TN + Elem<T>::PAD;
  const int tid = threadIdx.x;
  for (int v = tid; v < TM * KC; v += THREADS) {
    const int r = v / KC, kk = v % KC;
    const int gr = row0 + r, gk = k0 + kk;
    As[r * LDA + kk] = gr < row_lim && gk < k1
                           ? A[static_cast<size_t>(gr) * k + gk]
                           : from_float<T>(0.f);
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const T* B = b == 0 ? B0 : B1;
    T* bs = Bs + b * KC * LDB;
    for (int v = tid; v < KC * TN; v += THREADS) {
      const int r = v / TN, c = v % TN;
      const int gk = k0 + r, gc = col0 + c;
      bs[r * LDB + c] = gk < k1 && gc < col_lim
                            ? B[static_cast<size_t>(gk) * n + gc]
                            : from_float<T>(0.f);
    }
  }
}

template <typename T, int TM, int TN, int NB, bool NARROW>
__device__ __forceinline__ void load_chunk(const T* A, const T* B0,
                                           const T* B1, int k, int n, T* As,
                                           T* Bs, int row0, int row_lim,
                                           int col0, int col_lim, int k0,
                                           int k1) {
  if constexpr (NARROW) {
    load_chunk_narrow<T, TM, TN, NB>(A, B0, B1, k, n, As, Bs, row0, row_lim,
                                     col0, col_lim, k0, k1);
    return;
  }
  constexpr int VEC = Elem<T>::VEC;
  constexpr int LDA = KC + Elem<T>::PAD;
  constexpr int LDB = TN + Elem<T>::PAD;
  const int tid = threadIdx.x;
  for (int v = tid; v < TM * (KC / VEC); v += THREADS) {
    int r = v / (KC / VEC), kv = (v % (KC / VEC)) * VEC;
    int gr = row0 + r, gk = k0 + kv;
    bool ok = gr < row_lim && gk < k1;
    const T* src = ok ? A + static_cast<size_t>(gr) * k + gk : A;
    cp_async16(As + r * LDA + kv, src, ok ? 16 : 0);
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const T* B = b == 0 ? B0 : B1;
    T* bs = Bs + b * KC * LDB;
    for (int v = tid; v < KC * (TN / VEC); v += THREADS) {
      int r = v / (TN / VEC), cv = (v % (TN / VEC)) * VEC;
      int gk = k0 + r, gc = col0 + cv;
      bool ok = gk < k1 && gc < col_lim;
      const T* src = ok ? B + static_cast<size_t>(gk) * n + gc : B;
      cp_async16(bs + r * LDB + cv, src, ok ? 16 : 0);
    }
  }
}

template <typename T, int TM, int TN, bool UP>
__global__ void __launch_bounds__(THREADS)
ffn_kernel(const Params p) {
  constexpr int NB = UP ? 2 : 1;
  constexpr int LDA = KC + Elem<T>::PAD;
  constexpr int LDB = TN + Elem<T>::PAD;
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  // tensor-core warp layout: 1 x 4 warps for a 16-row tile, else 2 x 2
  constexpr int WARPS_M = TM == 16 ? 1 : 2;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = TM / WARPS_M, WN = TN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  // CUDA-core layout: 16 x 8 threads, each RM x RN outputs
  constexpr int RM = TM / 16, RN = TN / 8;
  constexpr int ACC = TC ? MT * NT * 4 : RM * RN;
  static_assert(ACC * THREADS == TM * TN, "one accumulator per output");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + STAGES * TM * LDA;

  // which expert, which config tile, which CTA of it
  const int per_tile = p.subm * p.subn;
  const int tile = blockIdx.x / per_tile, sub = blockIdx.x % per_tile;
  const int e = tile / (p.mi * p.nj), rem = tile % (p.mi * p.nj);
  const int ti = rem / p.nj, tj = rem % p.nj;
  const int si = sub / p.subn, sj = sub % p.subn;
  const int row0 = ti * p.bm + si * TM;
  const int col0 = tj * p.bn + sj * TN;
  const int row_lim = min(min(row0 + TM, ti * p.bm + p.bm), p.m);
  const int col_lim = min(min(col0 + TN, tj * p.bn + p.bn), p.n);
  if (row0 >= row_lim || col0 >= col_lim) return;   // past the edge

  const T* A = static_cast<const T*>(p.a) + static_cast<size_t>(e) * p.m * p.k;
  const T* B0 =
      static_cast<const T*>(p.b0) + static_cast<size_t>(e) * p.k * p.n;
  const T* B1 = UP ? static_cast<const T*>(p.b1) +
                         static_cast<size_t>(e) * p.k * p.n
                   : B0;

  float acc[NB][ACC];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[b][i] = 0.f;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int ty = tid / 8, tx = tid % 8;

  // the K walk, compiled once for 16-byte vector copies and once for
  // element copies (rows off the grain), so that neither path carries
  // the other's registers
  const auto walk = [&](auto narrow) {
    constexpr bool NARROW = decltype(narrow)::value;
    const int nchunks = (p.k + KC - 1) / KC;
    load_chunk<T, TM, TN, NB, NARROW>(A, B0, B1, p.k, p.n, As, Bs, row0,
                                      row_lim, col0, col_lim, 0,
                                      min(KC, p.k));
    cp_async_commit();
    int stage = 0;
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) {
        int k0 = (c + 1) * KC;
        load_chunk<T, TM, TN, NB, NARROW>(
            A, B0, B1, p.k, p.n, As + (stage ^ 1) * TM * LDA,
            Bs + (stage ^ 1) * NB * KC * LDB, row0, row_lim, col0, col_lim,
            k0, min(k0 + KC, p.k));
      }
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      const T* as = As + stage * TM * LDA;
      const T* bs = Bs + stage * NB * KC * LDB;
      if constexpr (TC) {
#pragma unroll
        for (int ks = 0; ks < KC; ks += 16) {
          uint32_t af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const T* r0 = as + (wm0 + mt * 16 + g) * LDA + ks + 2 * q;
            const T* r8 = r0 + 8 * LDA;
            af[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
            af[mt][1] = *reinterpret_cast<const uint32_t*>(r8);
            af[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
            af[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
          }
#pragma unroll
          for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const T* bc =
                  bs + b * KC * LDB + (ks + 2 * q) * LDB + wn0 + nt * 8 + g;
              uint32_t b0 = pack_bf16(bc[0], bc[LDB]);
              uint32_t b1 = pack_bf16(bc[8 * LDB], bc[9 * LDB]);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                mma_bf16(acc[b] + (mt * NT + nt) * 4, af[mt], b0, b1);
            }
        }
      } else {
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
          float a[RM];
#pragma unroll
          for (int r = 0; r < RM; ++r) a[r] = as[(ty + 16 * r) * LDA + kk];
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            float bv[RN];
#pragma unroll
            for (int j = 0; j < RN; ++j)
              bv[j] = bs[b * KC * LDB + kk * LDB + tx + 8 * j];
#pragma unroll
            for (int r = 0; r < RM; ++r)
#pragma unroll
              for (int j = 0; j < RN; ++j) acc[b][r * RN + j] += a[r] * bv[j];
          }
        }
      }
      __syncthreads();   // the next load overwrites this stage
      stage ^= 1;
    }
  };
  if (p.narrow)
    walk(std::true_type{});
  else
    walk(std::false_type{});

  // epilogue: gate/up — act = round_x(silu(hg) * hu); down — the gate
  T* C = static_cast<T*>(p.c) + static_cast<size_t>(e) * p.m * p.n;
  const float* G = p.gate ? p.gate + static_cast<size_t>(e) * p.m : nullptr;
  if constexpr (TC) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + wm0 + mt * 16 + g + (i >= 2 ? 8 : 0);
          const int cc = col0 + wn0 + nt * 8 + 2 * q + (i & 1);
          const int a = (mt * NT + nt) * 4 + i;
          if (r < row_lim && cc < col_lim)
            C[static_cast<size_t>(r) * p.n + cc] =
                from_float<T>(finish<UP>(acc[0][a], acc[NB - 1][a], G, r));
        }
  } else {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gr = row0 + ty + 16 * r, gc = col0 + tx + 8 * j;
        const int a = r * RN + j;
        if (gr < row_lim && gc < col_lim)
          C[static_cast<size_t>(gr) * p.n + gc] =
              from_float<T>(finish<UP>(acc[0][a], acc[NB - 1][a], G, gr));
      }
  }
}

template <typename T, int TM, int TN, bool UP>
cudaError_t launch(const Params& p, long long ctas, cudaStream_t stream) {
  constexpr int NB = UP ? 2 : 1;
  constexpr int smem = STAGES *
                       (TM * (KC + Elem<T>::PAD) +
                        NB * KC * (TN + Elem<T>::PAD)) *
                       static_cast<int>(sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ffn_kernel<T, TM, TN, UP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  ffn_kernel<T, TM, TN, UP>
      <<<static_cast<unsigned>(ctas), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int TM>
cudaError_t launch_tn(const Params& p, bool up, int tn, long long ctas,
                      cudaStream_t st) {
  if (up) {
    switch (tn) {
      case 32: return launch<T, TM, 32, true>(p, ctas, st);
      case 64: return launch<T, TM, 64, true>(p, ctas, st);
    }
  } else {
    switch (tn) {
      case 64: return launch<T, TM, 64, false>(p, ctas, st);
      case 128: return launch<T, TM, 128, false>(p, ctas, st);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_tile(const Params& p, bool up, int tm, int tn,
                        long long ctas, cudaStream_t st) {
  switch (tm) {
    case 16: return launch_tn<T, 16>(p, up, tn, ctas, st);
    case 32: return launch_tn<T, 32>(p, up, tn, ctas, st);
    case 64: return launch_tn<T, 64>(p, up, tn, ctas, st);
    case 128: return launch_tn<T, 128>(p, up, tn, ctas, st);
  }
  return cudaErrorInvalidValue;
}

// -- bf16 on wgmma fed by TMA, persistent grouped schedule --------------------

constexpr int kWgDepth = 64;     // depth of a stage: one 128-byte row
constexpr int kWgStages = 4;
constexpr int kPanelBytes = kWgDepth * 64 * 2;   // a 64-deep x 64 B panel
constexpr int kWgUpCols = 128;   // d_ff columns of wg (and of wu) a CTA
constexpr int kWgDownCols = 256; // d_model columns a CTA
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int BM>
struct WgCfg {
  static constexpr int kABytes = BM * kWgDepth * 2;
  static constexpr int kStageBytes = kABytes + 4 * kPanelBytes;
  // columns of one consumer warpgroup's product: all 256 of the CTA's
  // (its 64 rows), or at BM = 64 half of them (all 64 rows)
  static constexpr int kN = BM == 128 ? 256 : 128;
  // 1024 of alignment slack (swizzled tiles need 1024-byte bases), the
  // ring, a full and an empty mbarrier a stage
  static constexpr int kSmem =
      1024 + kWgStages * kStageBytes + 16 * kWgStages;
};

struct WgTile {
  int e, row0, col0;
};

// CTA tile L of a launch's work list: expert by expert, then the config
// tiles of one expert in row order, then the CTA tiles of one config
// tile; false past the edge.
__device__ __forceinline__ bool wg_tile(const Params& p, int L, int BM,
                                        int TN, WgTile& w) {
  const int per_tile = p.subm * p.subn;
  const int per_expert = p.mi * p.nj * per_tile;
  w.e = L / per_expert;
  const int r = L % per_expert;
  const int tile = r / per_tile, sub = r % per_tile;
  w.row0 = (tile / p.nj) * p.bm + (sub / p.subn) * BM;
  w.col0 = (tile % p.nj) * p.bn + (sub % p.subn) * TN;
  return w.row0 < p.m && w.col0 < p.n;
}

__device__ __forceinline__ float swiglu(float hg, float hu) {
  return hg / (1.f + expf(-hg)) * hu;
}

// UP: act (E, m, n) = round(silu(x·wg) * (x·wu)), B panels wg | wu;
// else y (E, m, n) = round((act·wd) * gate).  tm_a is the A operand (x or
// act) as (k, m, E) in BM-row boxes, tm_b0 / tm_b1 the B operands (wg and
// wu, or wd twice) as (n, k, E) in 64-row boxes.
template <int BM, bool UP>
__global__ void __launch_bounds__(384, 1)
ffn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b0,
                 const __grid_constant__ CUtensorMap tm_b1, const Params p,
                 int n_work) {
  using C = WgCfg<BM>;
  constexpr int S = kWgStages, NW = C::kN;
  constexpr int TN = UP ? kWgUpCols : kWgDownCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kStageBytes);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);   // one arrival per consumer
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int n_stages = (p.k + kWgDepth - 1) / kWgDepth;

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full, tile after tile
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int L = blockIdx.x; L < n_work; L += gridDim.x) {
      WgTile w;
      if (!wg_tile(p, L, BM, TN, w)) continue;
      // gate/up: wg's and wu's 128 columns, as [wg0 wg1 wu0 wu1] (BM
      // 128) or [wg0 wu0 wg1 wu1] (BM 64: warpgroup i takes 2i, 2i + 1);
      // down: wd's panels, those wholly past n not loaded (their columns
      // are never stored)
      const int panels = UP ? 4 : min(4, (p.n - w.col0 + 63) / 64);
      for (int c = 0; c < n_stages; ++c, ++it) {
        const int st = it % S, ph = (it / S) & 1;
        unsigned char* a_s = ring + st * C::kStageBytes;
        const int k0 = c * kWgDepth;
        hopper::mbar_wait(&empty[st], ph ^ 1);
        hopper::mbar_expect_tx(&full[st], C::kABytes + panels * kPanelBytes);
        hopper::tma_load_3d(a_s, &tm_a, k0, w.row0, w.e, &full[st]);
        for (int pn = 0; pn < panels; ++pn) {
          unsigned char* b_s = a_s + C::kABytes + pn * kPanelBytes;
          if constexpr (UP) {
            const int src = BM == 128 ? pn / 2 : pn % 2;
            const int half = BM == 128 ? pn % 2 : pn / 2;
            hopper::tma_load_3d(b_s, src ? &tm_b1 : &tm_b0,
                                w.col0 + half * 64, k0, w.e, &full[st]);
          } else {
            hopper::tma_load_3d(b_s, &tm_b0, w.col0 + pn * 64, k0, w.e,
                                &full[st]);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: at BM 128 rows [wg·64, wg·64 + 64) and all the
  // CTA's columns; at BM 64 every row and panels 2wg, 2wg + 1
  hopper::reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q4 = lane & 3;
  float acc[NW / 2];
  int it = 0;
  for (int L = blockIdx.x; L < n_work; L += gridDim.x) {
    WgTile w;
    if (!wg_tile(p, L, BM, TN, w)) continue;
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int c = 0; c < n_stages; ++c, ++it) {
      const int st = it % S, ph = (it / S) & 1;
      const unsigned char* a_s = ring + st * C::kStageBytes +
                                 (BM == 128 ? wg * 64 * 128 : 0);
      const unsigned char* b_s = ring + st * C::kStageBytes + C::kABytes +
                                 (BM == 128 ? 0 : wg * 2 * kPanelBytes);
      hopper::mbar_wait(&full[st], ph);
      hopper::fence_operands(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgDepth / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(a_s + kk * 32, 16, 1024);
        const uint64_t db =
            hopper::desc_sw128(b_s + kk * 2048, kPanelBytes, 1024);
        if constexpr (NW == 256)
          hopper::wgmma_m64n256k16_ss_tb(acc, da, db, 1);
        else
          hopper::wgmma_m64n128k16_ss_tb(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::fence_operands(acc);
      // this stage's products stay in flight; the previous stage's are
      // done, so its buffers go back to the producer
      hopper::wgmma_wait<1>();
      if (prev >= 0 && tid == 0) hopper::mbar_arrive(&empty[prev]);
      prev = st;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    if (prev >= 0 && tid == 0) hopper::mbar_arrive(&empty[prev]);

    // accumulator element 4j + i: column 8j + 2·q4 + (i & 1) of the
    // warpgroup's product, row g (i < 2) or g + 8
    const int r_a = w.row0 + (BM == 128 ? wg * 64 : 0) + warp * 16 + g;
    const int r_b = r_a + 8;
    const size_t base = static_cast<size_t>(w.e) * p.m;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.c);
    if constexpr (UP) {
      // hg in the warpgroup's first half of the columns, hu in the second:
      // NW / 4 registers later
      constexpr int H = NW / 4;
      const int c0 = w.col0 + (BM == 128 ? 0 : wg * 64);
#pragma unroll
      for (int j = 0; j < NW / 16; ++j) {
        const int col = c0 + j * 8 + 2 * q4, i = 4 * j;
        if (r_a < p.m)
          *reinterpret_cast<uint32_t*>(out + (base + r_a) * p.n + col) =
              hopper::pack_bf16(swiglu(acc[i], acc[i + H]),
                                swiglu(acc[i + 1], acc[i + H + 1]));
        if (r_b < p.m)
          *reinterpret_cast<uint32_t*>(out + (base + r_b) * p.n + col) =
              hopper::pack_bf16(swiglu(acc[i + 2], acc[i + H + 2]),
                                swiglu(acc[i + 3], acc[i + H + 3]));
      }
    } else {
      const int c0 = w.col0 + (BM == 128 ? 0 : wg * 128);
      const float ga = p.gate && r_a < p.m ? p.gate[base + r_a] : 1.f;
      const float gb = p.gate && r_b < p.m ? p.gate[base + r_b] : 1.f;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = c0 + j * 8 + 2 * q4, i = 4 * j;
        if (col >= p.n) continue;   // n is even: col + 1 < n too
        if (r_a < p.m)
          *reinterpret_cast<uint32_t*>(out + (base + r_a) * p.n + col) =
              hopper::pack_bf16(acc[i] * ga, acc[i + 1] * ga);
        if (r_b < p.m)
          *reinterpret_cast<uint32_t*>(out + (base + r_b) * p.n + col) =
              hopper::pack_bf16(acc[i + 2] * gb, acc[i + 3] * gb);
      }
    }
  }
}

template <int BM, bool UP>
cudaError_t launch_wgmma(const Params& p, int E, cudaStream_t st) {
  using C = WgCfg<BM>;
  constexpr int TN = UP ? kWgUpCols : kWgDownCols;
  // A as (k, m, E) in BM-row boxes; B as (n, k, E) in 64-row boxes
  CUtensorMap ta, tb0, tb1;
  int e = hopper::encode_tensor_map_3d(&ta, p.a, p.k, p.m, E, BM);
  if (!e) e = hopper::encode_tensor_map_3d(&tb0, p.b0, p.n, p.k, E,
                                           kWgDepth);
  if (!e) e = hopper::encode_tensor_map_3d(&tb1, UP ? p.b1 : p.b0, p.n, p.k,
                                           E, kWgDepth);
  if (e) return static_cast<cudaError_t>(e);
  const long long n_work = static_cast<long long>(E) * p.mi * p.nj *
                           p.subm * p.subn;
  if (n_work > 0x7fffffffLL || p.subm * BM != p.bm ||
      (UP && p.subn * TN != p.bn))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t r = cudaGetDevice(&dev);
  if (r == cudaSuccess)
    r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (r != cudaSuccess) return r;
  const int grid = n_work < sms ? static_cast<int>(n_work) : sms;
  r = cudaFuncSetAttribute(ffn_wgmma_kernel<BM, UP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem);
  if (r != cudaSuccess) return r;
  ffn_wgmma_kernel<BM, UP><<<grid, 384, C::kSmem, st>>>(
      ta, tb0, tb1, p, static_cast<int>(n_work));
  return cudaGetLastError();
}

template <bool UP>
cudaError_t launch_wgmma_bm(const Params& p, int E, int tm,
                            cudaStream_t st) {
  switch (tm) {
    case 64: return launch_wgmma<64, UP>(p, E, st);
    case 128: return launch_wgmma<128, UP>(p, E, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point.  x (E, C, DM), wg and wu (E, DM, DF), wd (E, DF, DM) of
// one type (bf16 when `bf16`, else f32); gates (E, C) float32 or null
// (then y is not scaled); act (E, C, DF) scratch and y (E, C, DM) of that
// type.  bt x bf is the config tile (C a multiple of bt, DF of bf), tm the
// CTA rows, tn_up the gate/up CTA's columns, tn_down the down CTA's.
// Where DM, DF and bf are multiples of 16 bytes and every pointer is
// 16-byte aligned the rows are copied in 16-byte vectors, else element by
// element (not on wgmma).  With `wgmma` (bf16 only, bt a
// multiple of 64 and of tm, tm 64 or 128, bf a multiple of 128, DM of 64)
// tn_up is 128 and tn_down 256, each launch on a grid of one CTA an SM.
// Launches gate/up, then down, on `stream`; returns cudaGetLastError()
// after each launch, the first that is not cudaSuccess.
extern "C" int grouped_ffn_launch(const void* x, const void* wg,
                                  const void* wu, const void* wd,
                                  const float* gates, void* act, void* y,
                                  int E, int C, int DM, int DF, int bt,
                                  int bf, int tm, int tn_up, int tn_down,
                                  int bf16, int wgmma, void* stream) {
  if (E <= 0 || C <= 0 || DM <= 0 || DF <= 0 || bt <= 0 || bf <= 0 ||
      tm <= 0 || tn_up <= 0 || tn_down <= 0 || C % bt || DF % bf)
    return cudaErrorInvalidValue;
  if (wgmma && (!bf16 || bt % 64 || bt % tm || (tm != 64 && tm != 128) ||
                bf % kWgUpCols || DM % 64 || tn_up != kWgUpCols ||
                tn_down != kWgDownCols))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long mi = C / bt, subm = (bt + tm - 1) / tm;
  const int vec = bf16 ? 8 : 4;
  const void* ptrs[] = {x, wg, wu, wd, act, y};
  int narrow = DM % vec || DF % vec || bf % vec;
  for (const void* q : ptrs)
    narrow |= reinterpret_cast<uintptr_t>(q) % 16 != 0;
  if (wgmma && narrow) return cudaErrorInvalidValue;

  Params up;
  up.a = x;
  up.b0 = wg;
  up.b1 = wu;
  up.gate = nullptr;
  up.c = act;
  up.m = C;
  up.n = DF;
  up.k = DM;
  up.bm = bt;
  up.bn = bf;
  up.subm = static_cast<int>(subm);
  up.subn = (bf + tn_up - 1) / tn_up;
  up.mi = static_cast<int>(mi);
  up.nj = DF / bf;
  up.narrow = narrow;
  const long long ctas_up = E * mi * up.nj * subm * up.subn;

  Params down;
  down.a = act;
  down.b0 = wd;
  down.b1 = nullptr;
  down.gate = gates;
  down.c = y;
  down.m = C;
  down.n = DM;
  down.k = DF;
  down.bm = bt;
  down.bn = tn_down;
  down.subm = static_cast<int>(subm);
  down.subn = 1;
  down.mi = static_cast<int>(mi);
  down.nj = (DM + tn_down - 1) / tn_down;
  down.narrow = narrow;
  const long long ctas_down = E * mi * down.nj * subm;
  if (ctas_up > 0x7fffffffLL || ctas_down > 0x7fffffffLL)
    return cudaErrorInvalidValue;

  if (wgmma) {
    cudaError_t e = launch_wgmma_bm<true>(up, E, tm, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(launch_wgmma_bm<false>(down, E, tm, st));
  }
  cudaError_t e =
      bf16 ? launch_tile<__nv_bfloat16>(up, true, tm, tn_up, ctas_up, st)
           : launch_tile<float>(up, true, tm, tn_up, ctas_up, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = bf16 ? launch_tile<__nv_bfloat16>(down, false, tm, tn_down, ctas_down,
                                        st)
           : launch_tile<float>(down, false, tm, tn_down, ctas_down, st);
  return static_cast<int>(e);
}
