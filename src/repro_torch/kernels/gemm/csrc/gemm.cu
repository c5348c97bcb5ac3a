// GEMM for Hopper (sm_90a): C = A·B with a float32 accumulator.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/gemm/gemm.py (`gemm`, its pallas_call at :119) and
// computes what it computes:
//   * A (m, k) and B (k, n), row-major, both bf16 or both f32; the sum of
//     products is kept in float32 (bf16 products are exact, as on the MXU);
//   * the ragged edge (m, n, k not multiples of the config tile) is masked
//     here, in the loads and the stores, not padded by copies;
//   * stagger_k: the output tile (i, j) of the config walks its K blocks
//     in the order (kk + i + j) % nk;
//   * split_k > 1: K blocks s*nk .. s*nk+nk-1 go to split s, which writes
//     float32 partials at rows s*m + r of a (split_k*m, n) buffer; the
//     wrapper sums them in float32 and casts (as the TPU kernel's caller
//     does); stagger_k is ignored under split_k, as there;
//   * the config's precision knob is ignored: the accumulator is f32.
//
// Two designs, chosen by the wrapper from the config and the problem
// alone (families/gemm.py `is_wgmma` and `cta_tile`), before any launch:
//
//   * bf16 on wgmma fed by TMA (gemm_wgmma_kernel), when A and B are
//     bf16, k, n, bk, bn and both base pointers are 16-byte aligned (TMA's
//     rule), bk is a multiple of 64 (no stage straddles a K block) and the
//     config tile holds whole 128 x TN CTA tiles, TN = 256 where bn allows
//     it, else 128.  One producer warp of a third warpgroup (40 registers
//     after setmaxnreg) walks the CTA's K blocks in the config's order --
//     stagger and split are only the order and the range of TMA
//     coordinates -- and loads each 64-deep stage by TMA with 128-byte
//     swizzle and zero fill past m, n and k: an A tile of 128 x 64
//     (K-major) and TN / 64 B panels of 64 x 64 (MN-major), into a ring of
//     4 (TN 256) or 6 (TN 128) stages, 192 KB, with a full and an empty
//     mbarrier a stage.  Two consumer warpgroups (232 registers) each run
//     wgmma.mma_async m64nTNk16 on 64 rows, A and B from shared memory (B
//     through the transposed descriptor: the panel stride as LBO), one
//     stage's four products in flight while the previous stage is
//     released; the epilogue converts in registers and stores (bf16, f32,
//     or a split's f32 partials), masked at m and n.  The config tile is
//     the raster group: its CTA tiles are numbered one after another, so
//     the CTAs that share its operand panels run together.  The grid is
//     persistent: one CTA an SM (fewer when there are fewer tiles) walks
//     the tiles, its producer running ahead into the next tile's stages
//     while the consumers store.
//   * everything else (f32, bm = 8, a bk below 64 or not a multiple of it,
//     unaligned rows) on the first design, unchanged: one CTA of 128
//     threads (four warps) computes a TM x TN tile, TM in {16, 32, 64,
//     128} and TN in {32, 64, 128}, the largest instance that divides the
//     config's bm x bn tile, several CTAs covering a larger one.  The K
//     walk is staged through shared memory in 32-deep chunks, two stages
//     deep: 16-byte cp.async copies with zero-fill at the edge when every
//     operand row and block start is 16-byte aligned, masked element loads
//     otherwise.  bf16 products run on mma.sync.m16n8k16, f32 products as
//     FMAs on the CUDA cores (the tensor cores would take f32 only as
//     TF32, which the port keeps off).
//
// What bounds it.  At the family's production problem, 8192^3 bf16, the
// work is 1.1e12 operations against 403 MB of operands: 1.11 ms at the
// card's 989 TFLOP/s and 0.12 ms at 3.35 TB/s, so operations bound it,
// and only wgmma reaches the tensor cores' full rate on Hopper; the first
// design's mma.sync fed by 16-bit shared-memory loads took 5.54 ms there
// (PERF.md).
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int KC = 32;       // K depth of one shared-memory stage
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

struct Params {
  const void* a;
  const void* b;
  void* c;
  int m, n, k;
  int bm, bn, bk;
  int split, stagger;
  int subm, subn;       // CTAs per config tile along m and n
  int mi, nj;           // config tiles along m and n
  int nk_total, nk;     // K blocks in all; K blocks per split
  int vec, out_bf16;
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

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
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

// The K block that step t of this CTA's walk visits.
__device__ __forceinline__ int k_block(const Params& p, int s, int ti,
                                       int tj, int t) {
  if (p.split > 1) return s * p.nk + t;
  if (p.stagger) return (t + ti + tj) % p.nk_total;
  return t;
}

// [k0, k1) of chunk c of walk step t.
__device__ __forceinline__ void chunk_range(const Params& p, int s, int ti,
                                            int tj, int t, int c, int& k0,
                                            int& k1) {
  int kb = k_block(p, s, ti, tj, t);
  int block_end = min(kb * p.bk + p.bk, p.k);
  k0 = kb * p.bk + c * KC;
  k1 = min(k0 + KC, block_end);
}

// Next (t, c) of the walk; false past its end.
__device__ __forceinline__ bool advance(const Params& p, int s, int ti,
                                        int tj, int& t, int& c) {
  int kb = k_block(p, s, ti, tj, t);
  int len = min(p.bk, p.k - kb * p.bk);
  if ((c + 1) * KC < len) {
    ++c;
    return true;
  }
  ++t;
  c = 0;
  return t < p.nk;
}

template <typename T, int TM, int TN>
__device__ __forceinline__ void load_chunk(const Params& p, T* As, T* Bs,
                                           int row0, int row_lim, int col0,
                                           int col_lim, int k0, int k1) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int LDA = KC + Elem<T>::PAD;
  constexpr int LDB = TN + Elem<T>::PAD;
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  const int tid = threadIdx.x;
  if (p.vec) {
    // every vector lies wholly inside or wholly outside the valid range
    for (int v = tid; v < TM * (KC / VEC); v += THREADS) {
      int r = v / (KC / VEC), kv = (v % (KC / VEC)) * VEC;
      int gr = row0 + r, gk = k0 + kv;
      bool ok = gr < row_lim && gk < k1;
      const T* src = ok ? A + static_cast<size_t>(gr) * p.k + gk : A;
      cp_async16(As + r * LDA + kv, src, ok ? 16 : 0);
    }
    for (int v = tid; v < KC * (TN / VEC); v += THREADS) {
      int r = v / (TN / VEC), cv = (v % (TN / VEC)) * VEC;
      int gk = k0 + r, gc = col0 + cv;
      bool ok = gk < k1 && gc < col_lim;
      const T* src = ok ? B + static_cast<size_t>(gk) * p.n + gc : B;
      cp_async16(Bs + r * LDB + cv, src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < TM * KC; e += THREADS) {
      int r = e / KC, kk = e % KC;
      int gr = row0 + r, gk = k0 + kk;
      As[r * LDA + kk] = (gr < row_lim && gk < k1)
                             ? A[static_cast<size_t>(gr) * p.k + gk]
                             : zero<T>();
    }
    for (int e = tid; e < KC * TN; e += THREADS) {
      int r = e / TN, cc = e % TN;
      int gk = k0 + r, gc = col0 + cc;
      Bs[r * LDB + cc] = (gk < k1 && gc < col_lim)
                             ? B[static_cast<size_t>(gk) * p.n + gc]
                             : zero<T>();
    }
  }
}

__device__ __forceinline__ void store(const Params& p, size_t idx, float v) {
  if (p.out_bf16)
    static_cast<__nv_bfloat16*>(p.c)[idx] = __float2bfloat16(v);
  else
    static_cast<float*>(p.c)[idx] = v;
}

// two neighbouring outputs (idx even, so 4 or 8 bytes aligned)
__device__ __forceinline__ void store2(const Params& p, size_t idx, float x,
                                       float y) {
  if (p.out_bf16)
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.c) + idx) =
        hopper::pack_bf16(x, y);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(p.c) + idx) =
        make_float2(x, y);
}

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const Params p) {
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

  // which CTA of which config tile, and which split
  const int per_tile = p.subm * p.subn;
  const int tile = blockIdx.x / per_tile, sub = blockIdx.x % per_tile;
  const int ti = tile / p.nj, tj = tile % p.nj;
  const int si = sub / p.subn, sj = sub % p.subn;
  const int s = blockIdx.y;
  const int row0 = ti * p.bm + si * TM;
  const int col0 = tj * p.bn + sj * TN;
  const int row_lim = min(min(row0 + TM, ti * p.bm + p.bm), p.m);
  const int col_lim = min(min(col0 + TN, tj * p.bn + p.bn), p.n);
  if (row0 >= row_lim || col0 >= col_lim) return;   // past the edge

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int ty = tid / 8, tx = tid % 8;

  int t = 0, c = 0, k0, k1, stage = 0;
  chunk_range(p, s, ti, tj, t, c, k0, k1);
  load_chunk<T, TM, TN>(p, As, Bs, row0, row_lim, col0, col_lim, k0, k1);
  cp_async_commit();
  bool more = true;
  while (more) {
    int tn = t, cn = c;
    more = advance(p, s, ti, tj, tn, cn);
    if (more) {
      chunk_range(p, s, ti, tj, tn, cn, k0, k1);
      load_chunk<T, TM, TN>(p, As + (stage ^ 1) * TM * LDA,
                            Bs + (stage ^ 1) * KC * LDB, row0, row_lim,
                            col0, col_lim, k0, k1);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const T* as = As + stage * TM * LDA;
    const T* bs = Bs + stage * KC * LDB;
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
        for (int nt = 0; nt < NT; ++nt) {
          const T* bc = bs + (ks + 2 * q) * LDB + wn0 + nt * 8 + g;
          uint32_t b0 = pack_bf16(bc[0], bc[LDB]);
          uint32_t b1 = pack_bf16(bc[8 * LDB], bc[9 * LDB]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_bf16(acc + (mt * NT + nt) * 4, af[mt], b0, b1);
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float a[RM], b[RN];
#pragma unroll
        for (int r = 0; r < RM; ++r) a[r] = as[(ty + 16 * r) * LDA + kk];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = bs[kk * LDB + tx + 8 * j];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[r * RN + j] += a[r] * b[j];
      }
    }
    __syncthreads();   // the next load overwrites this stage
    t = tn;
    c = cn;
    stage ^= 1;
  }

  const size_t out_row0 = static_cast<size_t>(s) * p.m;
  if constexpr (TC) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int r = row0 + wm0 + mt * 16 + g + (e >= 2 ? 8 : 0);
          int cc = col0 + wn0 + nt * 8 + 2 * q + (e & 1);
          if (r < row_lim && cc < col_lim)
            store(p, (out_row0 + r) * p.n + cc, acc[(mt * NT + nt) * 4 + e]);
        }
  } else {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        int gr = row0 + ty + 16 * r, gc = col0 + tx + 8 * j;
        if (gr < row_lim && gc < col_lim)
          store(p, (out_row0 + gr) * p.n + gc, acc[r * RN + j]);
      }
  }
}

template <typename T, int TM, int TN>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = STAGES *
                       (TM * (KC + Elem<T>::PAD) + KC * (TN + Elem<T>::PAD)) *
                       static_cast<int>(sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<T, TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  gemm_kernel<T, TM, TN><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int TM>
cudaError_t launch_tn(const Params& p, int tn, dim3 grid, cudaStream_t st) {
  switch (tn) {
    case 32: return launch<T, TM, 32>(p, grid, st);
    case 64: return launch<T, TM, 64>(p, grid, st);
    case 128: return launch<T, TM, 128>(p, grid, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_tile(const Params& p, int tm, int tn, dim3 grid,
                        cudaStream_t st) {
  switch (tm) {
    case 16: return launch_tn<T, 16>(p, tn, grid, st);
    case 32: return launch_tn<T, 32>(p, tn, grid, st);
    case 64: return launch_tn<T, 64>(p, tn, grid, st);
    case 128: return launch_tn<T, 128>(p, tn, grid, st);
  }
  return cudaErrorInvalidValue;
}

// -- bf16 on wgmma fed by TMA -------------------------------------------------

constexpr int kWgRows = 128;   // CTA tile rows: two consumer warpgroups
constexpr int kWgDepth = 64;   // K depth of a stage: one 128-byte row
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int TN>
struct WgCfg {
  static constexpr int kStages = TN == 256 ? 4 : 6;    // 192 KB of ring
  static constexpr int kPanels = TN / 64;              // 64-column B boxes
  static constexpr int kABytes = kWgRows * kWgDepth * 2;
  static constexpr int kPanelBytes = kWgDepth * 64 * 2;
  static constexpr int kStageBytes = kABytes + kPanels * kPanelBytes;
  // 1024 of alignment slack (swizzled tiles need 1024-byte bases), the
  // ring, a full and an empty mbarrier a stage
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
};

// CTA tile L of the walk (split outermost, then the config tiles in row
// order, then the CTA tiles of one config tile); false past the edge.
struct WgTile {
  int s, ti, tj, row0, col0;
};

__device__ __forceinline__ bool wg_tile(const Params& p, int L, int TN,
                                        WgTile& w) {
  const int per_tile = p.subm * p.subn;
  const int per_split = p.mi * p.nj * per_tile;
  w.s = L / per_split;
  const int r = L % per_split;
  const int tile = r / per_tile, sub = r % per_tile;
  w.ti = tile / p.nj;
  w.tj = tile % p.nj;
  w.row0 = w.ti * p.bm + (sub / p.subn) * kWgRows;
  w.col0 = w.tj * p.bn + (sub % p.subn) * TN;
  return w.row0 < p.m && w.col0 < p.n;
}

// 64-deep stages of K block kb (the last block may be shorter)
__device__ __forceinline__ int wg_stages(const Params& p, int kb) {
  return (min(p.bk, p.k - kb * p.bk) + kWgDepth - 1) / kWgDepth;
}

template <int TN>
__global__ void __launch_bounds__(384, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b, const Params p,
                  int n_work) {
  using C = WgCfg<TN>;
  constexpr int S = C::kStages;
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

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full, tile after tile
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int L = blockIdx.x; L < n_work; L += gridDim.x) {
      WgTile w;
      if (!wg_tile(p, L, TN, w)) continue;
      // B panels wholly past n are not loaded (their columns are never
      // stored)
      const int panels = min(C::kPanels, (p.n - w.col0 + 63) / 64);
      for (int t = 0; t < p.nk; ++t) {
        const int kb = k_block(p, w.s, w.ti, w.tj, t);
        const int ns = wg_stages(p, kb);
        for (int c = 0; c < ns; ++c, ++it) {
          const int st = it % S, ph = (it / S) & 1;
          unsigned char* a_s = ring + st * C::kStageBytes;
          const int k0 = kb * p.bk + c * kWgDepth;
          hopper::mbar_wait(&empty[st], ph ^ 1);
          hopper::mbar_expect_tx(&full[st],
                                 C::kABytes + panels * C::kPanelBytes);
          hopper::tma_load_3d(a_s, &tm_a, k0, w.row0, 0, &full[st]);
          for (int pn = 0; pn < panels; ++pn)
            hopper::tma_load_3d(a_s + C::kABytes + pn * C::kPanelBytes,
                                &tm_b, w.col0 + pn * 64, k0, 0, &full[st]);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [wg·64, wg·64 + 64) of each CTA tile
  hopper::reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q4 = lane & 3;
  float acc[TN / 2];
  int it = 0;
  for (int L = blockIdx.x; L < n_work; L += gridDim.x) {
    WgTile w;
    if (!wg_tile(p, L, TN, w)) continue;
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int t = 0; t < p.nk; ++t) {
      const int ns = wg_stages(p, k_block(p, w.s, w.ti, w.tj, t));
      for (int c = 0; c < ns; ++c, ++it) {
        const int st = it % S, ph = (it / S) & 1;
        const unsigned char* a_s =
            ring + st * C::kStageBytes + wg * 64 * 128;
        const unsigned char* b_s = ring + st * C::kStageBytes + C::kABytes;
        hopper::mbar_wait(&full[st], ph);
        hopper::fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgDepth / 16; ++kk) {
          const uint64_t da = hopper::desc_sw128(a_s + kk * 32, 16, 1024);
          const uint64_t db =
              hopper::desc_sw128(b_s + kk * 2048, C::kPanelBytes, 1024);
          if constexpr (TN == 256)
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
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    if (prev >= 0 && tid == 0) hopper::mbar_arrive(&empty[prev]);

    const int r_a = w.row0 + wg * 64 + warp * 16 + g, r_b = r_a + 8;
    const size_t out_row0 = static_cast<size_t>(w.s) * p.m;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = w.col0 + j * 8 + 2 * q4;
      if (col >= p.n) continue;   // n is even: col + 1 < n too
      if (r_a < p.m) store2(p, (out_row0 + r_a) * p.n + col, acc[4 * j],
                            acc[4 * j + 1]);
      if (r_b < p.m) store2(p, (out_row0 + r_b) * p.n + col,
                            acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <int TN>
cudaError_t launch_wgmma(const Params& p, cudaStream_t st) {
  using C = WgCfg<TN>;
  CUtensorMap ta, tb;
  int e = hopper::encode_tensor_map_3d(&ta, p.a, p.k, p.m, 1, kWgRows);
  if (!e) e = hopper::encode_tensor_map_3d(&tb, p.b, p.n, p.k, 1, kWgDepth);
  if (e) return static_cast<cudaError_t>(e);
  const long long n_work = static_cast<long long>(p.split) * p.mi * p.nj *
                           p.subm * p.subn;
  if (n_work > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t r = cudaGetDevice(&dev);
  if (r == cudaSuccess)
    r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (r != cudaSuccess) return r;
  const int grid = n_work < sms ? static_cast<int>(n_work) : sms;
  r = cudaFuncSetAttribute(
      gemm_wgmma_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (r != cudaSuccess) return r;
  gemm_wgmma_kernel<TN><<<grid, 384, C::kSmem, st>>>(ta, tb, p,
                                                      static_cast<int>(n_work));
  return cudaGetLastError();
}

}  // namespace

// C entry point.  a (m, k), b (k, n) row-major of one type (bf16 when
// `bf16`, else f32); c (m, n), or (split*m, n) f32 partials when
// split > 1, in bf16 when `out_bf16`, else f32.  With `wgmma` (bf16 only,
// `vec` set, bk a multiple of 64, bm of 128 and bn of tn) tm x tn is
// 128 x 128 or 128 x 256, on a grid of one CTA an SM;
// otherwise tm x tn is an instance of the first design and `vec` asks
// for 16-byte copies, which the caller allows only when k, n, bk, bn and
// both base pointers are 16-byte aligned.  Returns cudaGetLastError()
// after the launch.
extern "C" int gemm_launch(const void* a, const void* b, void* c, int m,
                           int n, int k, int bm, int bn, int bk, int split,
                           int stagger, int tm, int tn, int bf16,
                           int out_bf16, int vec, int wgmma, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      split <= 0)
    return cudaErrorInvalidValue;
  Params p;
  p.a = a;
  p.b = b;
  p.c = c;
  p.m = m;
  p.n = n;
  p.k = k;
  p.bm = bm;
  p.bn = bn;
  p.bk = bk;
  p.split = split;
  p.stagger = stagger;
  p.subm = (bm + tm - 1) / tm;
  p.subn = (bn + tn - 1) / tn;
  p.mi = (m + bm - 1) / bm;
  p.nj = (n + bn - 1) / bn;
  p.nk_total = (k + bk - 1) / bk;
  if (p.nk_total % split) return cudaErrorInvalidValue;
  p.nk = p.nk_total / split;
  p.vec = vec;
  p.out_bf16 = out_bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (!bf16 || !vec || bk % kWgDepth || tm != kWgRows || bm % tm ||
        bn % tn)
      return cudaErrorInvalidValue;
    switch (tn) {
      case 128: return static_cast<int>(launch_wgmma<128>(p, st));
      case 256: return static_cast<int>(launch_wgmma<256>(p, st));
    }
    return cudaErrorInvalidValue;
  }
  const long long mi = p.mi;
  const long long ctas = mi * p.nj * p.subm * p.subn;
  if (ctas > 0x7fffffffLL || split > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(ctas), split);
  cudaError_t e = bf16 ? launch_tile<__nv_bfloat16>(p, tm, tn, grid, st)
                       : launch_tile<float>(p, tm, tn, grid, st);
  return static_cast<int>(e);
}
