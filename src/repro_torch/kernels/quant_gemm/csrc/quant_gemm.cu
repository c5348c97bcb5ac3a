// Quantized GEMM for Hopper (sm_90a): C = dequant(Aq·Bq) with int8
// operands and per-group float32 scales.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/quant_gemm/quant_gemm.py (`quant_gemm`, body
// `make_kernel`, its pallas_call at :79) and computes what it computes:
//   * A (m, k) and B (k, n), row-major int8; sa (m, g) and sb (g, n)
//     row-major float32, g = ceil(k / group), one scale per K-group;
//   * the K walk goes in bk-deep blocks (bk divides group, so each block
//     lies in one group g = k0 / group); each block's product is an exact
//     int32 partial, and at the block's end `f32(partial) * sa[r, g] *
//     sb[g, c]` is added into a float32 accumulator, block by block in K
//     order — dequantise before accumulate, the TPU kernel's rounding
//     point, which the family's `acc_depends_k` invariant is about;
//   * the ragged edge (m, n, k not multiples of the config tile) is
//     masked: masked int8 loads are zero, so they add nothing to the
//     partial, as the TPU kernel's zero padding;
//   * the output is float32 or bfloat16 (one rounding of the f32 sum).
// Both instances below promote a block with the same expression
// (`promote`: the partial converted exactly, times sa, rounded, then one
// fused multiply-add of sb into the sum), so at one bk they give
// bit-identical outputs whatever their tiles.
//
// What bounds it.  At the family's production problem, 8192^3 int8 with
// 128-wide groups, the work is 1.1e12 int8 operations against 134 MB of
// operands, 4 MB of scales and 268 MB of float32 output: 0.556 ms at the
// card's 1,979 TOP/s and 0.121 ms at 3.35 TB/s, so operations bound it,
// and only wgmma reaches the int8 tensor-core rate.  The promotion is as
// large: 8192^2 x 64 blocks x ~4 CUDA-core operations is ~0.5 ms, so it
// has to overlap the products.
//
// Two instances, chosen by the wrapper from the config and the problem
// alone (families/quant_gemm.py `is_wgmma`), before any launch:
//
//   * int8 wgmma fed by TMA (quant_wgmma_kernel), for bm and bn multiples
//     of 128, bk of 32, 64 or 128, k and n multiples of 16 and 16-byte
//     aligned pointers (TMA's rules).  wgmma takes 8-bit operands
//     K-major only, and B is (k, n): so the call first writes Bᵀ (n, k)
//     into scratch with transpose_kernel (64 x 64-byte tiles through
//     shared memory) on the same stream.  Then a persistent grid (one CTA
//     an SM) walks 128 x 128 CTA tiles, the config tile's CTA tiles one
//     after another.  A producer warp (40 registers after setmaxnreg)
//     loads each 128-deep stage by TMA with 128-byte swizzle and zero
//     fill: A (128 x 128 bytes), Bᵀ (128 x 128 bytes) and the stage's
//     four rows of sb (128 columns, unswizzled), into a ring of 6 stages
//     with a full and an empty mbarrier each.  Two consumer warpgroups
//     (232 registers) each own 64 rows and run
//     wgmma.mma_async.m64n128k32.s32.s8.s8, bk / 32 of them a block, into
//     an int32 partial, wait for it, and promote it — converted exactly
//     with the magic-number trick (|p| <= 128·128·128 = 2^21 < 2^22),
//     scaled by sa (two rows, read through L1 a block ahead) and sb (from
//     the stage), added into the float32 sum.  A partial can only be
//     read once its products are done, and ptxas serialises the wgmma of
//     a warpgroup that reads one partial while the next block's products
//     run into another (PERF.md: the double-buffered partial ran 20%
//     slower), so the overlap is between the warpgroups: named barriers
//     pass the turn to issue a block's products from one to the other,
//     and one promotes on the CUDA cores while the other's products hold
//     the tensor cores.  The walk's ring stage, scale group and sb row
//     advance block by block with no division.  Registers: 64 + 64
//     accumulators a thread.
//   * everything else (bm of 16-64, bn of 32-64 steps, the masked byte
//     path, bk above 128) on the first design, unchanged: one CTA of 128
//     threads (four warps) computes a TM x TN tile, TM in {16, 32, 64,
//     128} and TN in {32, 64} (template instances), the largest instance
//     dividing the config's bm x bn tile, a larger config tile on several
//     CTAs launched one after another.  A bk block is staged through
//     shared memory in 32-deep chunks, two stages deep: 16-byte cp.async
//     copies with zero-fill at the edge when every row and block start is
//     16-byte aligned, masked byte loads otherwise.  Each chunk is one
//     mma.sync.m16n8k32 s8 step per 16 x 8 output fragment; B is (k, n)
//     row-major, so each B register is assembled from four byte loads of
//     shared memory.  Two accumulators a thread (int32 partial and f32
//     sum) stop the column tile at 64.
#include "hopper.cuh"

namespace {

// The promotion of one block's partial p into the float32 sum, written
// once for both instances: (p · sa) rounded, then one fused multiply-add
// of sb into acc — the TPU kernel's `acc += f32(p) * sa * sb`.
__device__ __forceinline__ float promote(float acc, float p, float sa,
                                         float sb) {
  return __fmaf_rn(__fmul_rn(p, sa), sb, acc);
}

// p as a float, exactly, for |p| <= 2^22, on the FP32 pipe: p added to
// the bits of 1.5·2^23 (whose unit in the last place is 1), less 1.5·2^23.
__device__ __forceinline__ float exact_float(int p) {
  return __fsub_rn(__int_as_float(p + 0x4B400000), 12582912.0f);
}

constexpr int THREADS = 128;
constexpr int KC = 32;       // K depth (bytes) of one shared-memory stage
constexpr int STAGES = 2;
constexpr int PAD = 16;      // row padding: 16 bytes
constexpr int LDA = KC + PAD;

struct Params {
  const int8_t* a;
  const int8_t* b;
  const float* sa;
  const float* sb;
  void* c;
  int m, n, k, group, ng;
  int bm, bn, bk;
  int subm, subn;       // CTAs per config tile along m and n
  int mi, nj;           // config tiles along m and n
  int nk;               // bk blocks along K
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

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 values of B's column: rows r, r+1, r+2, r+3 of the stage,
// packed low byte first (the k order mma.sync wants).
__device__ __forceinline__ uint32_t b_column4(const int8_t* p, int ldb) {
  return static_cast<uint32_t>(static_cast<uint8_t>(p[0])) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[ldb])) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[2 * ldb])) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[3 * ldb])) << 24);
}

// Length of bk block t (the last one may be cut by k).
__device__ __forceinline__ int block_len(const Params& p, int t) {
  return min(p.bk, p.k - t * p.bk);
}

template <int TM, int TN>
__device__ __forceinline__ void load_chunk(const Params& p, int8_t* As,
                                           int8_t* Bs, int row0, int row_lim,
                                           int col0, int col_lim, int k0,
                                           int k1) {
  constexpr int LDB = TN + PAD;
  const int tid = threadIdx.x;
  if (p.vec) {
    // every 16-byte vector lies wholly inside or wholly outside the range
    for (int v = tid; v < TM * (KC / 16); v += THREADS) {
      int r = v / (KC / 16), kv = (v % (KC / 16)) * 16;
      int gr = row0 + r, gk = k0 + kv;
      bool ok = gr < row_lim && gk < k1;
      const int8_t* src = ok ? p.a + static_cast<size_t>(gr) * p.k + gk
                             : p.a;
      cp_async16(As + r * LDA + kv, src, ok ? 16 : 0);
    }
    for (int v = tid; v < KC * (TN / 16); v += THREADS) {
      int r = v / (TN / 16), cv = (v % (TN / 16)) * 16;
      int gk = k0 + r, gc = col0 + cv;
      bool ok = gk < k1 && gc < col_lim;
      const int8_t* src = ok ? p.b + static_cast<size_t>(gk) * p.n + gc
                             : p.b;
      cp_async16(Bs + r * LDB + cv, src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < TM * KC; e += THREADS) {
      int r = e / KC, kk = e % KC;
      int gr = row0 + r, gk = k0 + kk;
      As[r * LDA + kk] = (gr < row_lim && gk < k1)
                             ? p.a[static_cast<size_t>(gr) * p.k + gk]
                             : static_cast<int8_t>(0);
    }
    for (int e = tid; e < KC * TN; e += THREADS) {
      int r = e / TN, cc = e % TN;
      int gk = k0 + r, gc = col0 + cc;
      Bs[r * LDB + cc] = (gk < k1 && gc < col_lim)
                             ? p.b[static_cast<size_t>(gk) * p.n + gc]
                             : static_cast<int8_t>(0);
    }
  }
}

template <int TM, int TN>
__global__ void __launch_bounds__(THREADS)
quant_gemm_kernel(const Params p) {
  constexpr int LDB = TN + PAD;
  // warp layout: 1 x 4 warps for a 16-row tile, else 2 x 2
  constexpr int WARPS_M = TM == 16 ? 1 : 2;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = TM / WARPS_M, WN = TN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int ACC = MT * NT * 4;
  static_assert(ACC * THREADS == TM * TN, "one accumulator per output");
  static_assert(NT >= 1 && MT >= 1, "warp tile below the mma grain");

  __shared__ __align__(16) int8_t As[STAGES * TM * LDA];
  __shared__ __align__(16) int8_t Bs[STAGES * KC * LDB];

  // which CTA of which config tile
  const int per_tile = p.subm * p.subn;
  const int tile = blockIdx.x / per_tile, sub = blockIdx.x % per_tile;
  const int ti = tile / p.nj, tj = tile % p.nj;
  const int si = sub / p.subn, sj = sub % p.subn;
  const int row0 = ti * p.bm + si * TM;
  const int col0 = tj * p.bn + sj * TN;
  const int row_lim = min(min(row0 + TM, ti * p.bm + p.bm), p.m);
  const int col_lim = min(min(col0 + TN, tj * p.bn + p.bn), p.n);
  if (row0 >= row_lim || col0 >= col_lim) return;   // past the edge

  int part[ACC];     // int32 partial of the current bk block
  float acc[ACC];    // float32 sum of the dequantised block partials
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    part[i] = 0;
    acc[i] = 0.f;
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;

  // the walk: bk block t, 32-deep chunk c of it
  int t = 0, c = 0, stage = 0;
  load_chunk<TM, TN>(p, As, Bs, row0, row_lim, col0, col_lim, 0,
                     block_len(p, 0));
  cp_async_commit();
  for (;;) {
    // the next chunk of the walk, if any
    const int len = block_len(p, t);
    const bool block_ends = (c + 1) * KC >= len;
    int tn = t, cn = c + 1;
    if (block_ends) {
      tn = t + 1;
      cn = 0;
    }
    const bool more = tn < p.nk;
    if (more) {
      int k0 = tn * p.bk + cn * KC;
      int k1 = min(k0 + KC, tn * p.bk + block_len(p, tn));
      load_chunk<TM, TN>(p, As + (stage ^ 1) * TM * LDA,
                         Bs + (stage ^ 1) * KC * LDB, row0, row_lim, col0,
                         col_lim, k0, k1);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int8_t* as = As + stage * TM * LDA;
    const int8_t* bs = Bs + stage * KC * LDB;
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* r0 = as + (wm0 + mt * 16 + g) * LDA + 4 * q;
      const int8_t* r8 = r0 + 8 * LDA;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(r8);
      af[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      af[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int8_t* bc = bs + (4 * q) * LDB + wn0 + nt * 8 + g;
      uint32_t b0 = b_column4(bc, LDB);
      uint32_t b1 = b_column4(bc + 16 * LDB, LDB);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_s8(part + (mt * NT + nt) * 4, af[mt], b0, b1);
    }
    if (block_ends) {
      // dequantise this block's partial with its group's scales, then
      // accumulate (masked rows and columns read no scale)
      const int grp = (t * p.bk) / p.group;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float sr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int r = row0 + wm0 + mt * 16 + g + 8 * h;
          sr[h] = r < row_lim ? p.sa[static_cast<size_t>(r) * p.ng + grp]
                              : 0.f;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float sc[2];
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            int cc = col0 + wn0 + nt * 8 + 2 * q + w;
            sc[w] = cc < col_lim ? p.sb[static_cast<size_t>(grp) * p.n + cc]
                                 : 0.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int i = (mt * NT + nt) * 4 + e;
            acc[i] = promote(acc[i], static_cast<float>(part[i]),
                             sr[e >> 1], sc[e & 1]);
            part[i] = 0;
          }
        }
      }
    }
    __syncthreads();   // the next load overwrites this stage
    if (!more) break;
    t = tn;
    c = cn;
    stage ^= 1;
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = row0 + wm0 + mt * 16 + g + (e >= 2 ? 8 : 0);
        int cc = col0 + wn0 + nt * 8 + 2 * q + (e & 1);
        if (r < row_lim && cc < col_lim) {
          size_t idx = static_cast<size_t>(r) * p.n + cc;
          float v = acc[(mt * NT + nt) * 4 + e];
          if (p.out_bf16)
            static_cast<__nv_bfloat16*>(p.c)[idx] = __float2bfloat16(v);
          else
            static_cast<float*>(p.c)[idx] = v;
        }
      }
}

template <int TM, int TN>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  quant_gemm_kernel<TM, TN><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_tn(const Params& p, int tn, dim3 grid, cudaStream_t st) {
  switch (tn) {
    case 32: return launch<TM, 32>(p, grid, st);
    case 64: return launch<TM, 64>(p, grid, st);
  }
  return cudaErrorInvalidValue;
}

// -- int8 wgmma fed by TMA ---------------------------------------------------

// Bᵀ (n, k) from B (k, n), int8, both row-major: a CTA of 256 threads
// moves a 64 (k) x 64 (n) byte tile through shared memory, reading rows
// of B and writing rows of Bᵀ as 16-byte vectors (k and n multiples of
// 16, both pointers 16-byte aligned).
__global__ void __launch_bounds__(256)
transpose_kernel(const int8_t* __restrict__ b, int8_t* __restrict__ bt,
                 int k, int n) {
  constexpr int LD = 64 + 4;   // row stride in bytes (word aligned)
  __shared__ __align__(16) uint8_t tile[64 * LD];
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (k0 + r < k && n0 + c < n)
    v = *reinterpret_cast<const uint4*>(b + static_cast<size_t>(k0 + r) * n +
                                        n0 + c);
  uint32_t* w = reinterpret_cast<uint32_t*>(tile + r * LD + c);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
  __syncthreads();
  if (n0 + r >= n || k0 + c >= k) return;
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint8_t* col = tile + (c + 4 * j) * LD + r;
    o[j] = static_cast<uint32_t>(col[0]) |
           (static_cast<uint32_t>(col[LD]) << 8) |
           (static_cast<uint32_t>(col[2 * LD]) << 16) |
           (static_cast<uint32_t>(col[3 * LD]) << 24);
  }
  *reinterpret_cast<uint4*>(bt + static_cast<size_t>(n0 + r) * k + k0 + c) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

constexpr int kWgRows = 128;     // CTA tile rows: two consumer warpgroups
constexpr int kWgCols = 128;     // CTA tile columns
constexpr int kWgDepth = 128;    // K bytes a stage: one 128-byte row
constexpr int kWgStages = 6;
constexpr int kSbRows = 4;       // scale groups a stage spans (bk >= 32)
constexpr int kABytes = kWgRows * kWgDepth;
constexpr int kBBytes = kWgCols * kWgDepth;
constexpr int kSbBytes = kSbRows * kWgCols * 4;
constexpr int kStageBytes = kABytes + kBBytes + kSbBytes;   // 34 KB
// 1024 of alignment slack (swizzled tiles need 1024-byte bases), the
// ring, a full and an empty mbarrier a stage
constexpr int kWgSmem = 1024 + kWgStages * kStageBytes + 16 * kWgStages;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kStageBytes % 1024 == 0, "stages keep 1024-byte alignment");

// CTA tile L of the persistent walk (config tiles in row order, then the
// CTA tiles of one config tile); false past the edge.
__device__ __forceinline__ bool wg_tile(const Params& p, int L, int& row0,
                                        int& col0) {
  const int per_tile = p.subm * p.subn;
  const int tile = L / per_tile, sub = L % per_tile;
  row0 = (tile / p.nj) * p.bm + (sub / p.subn) * kWgRows;
  col0 = (tile % p.nj) * p.bn + (sub % p.subn) * kWgCols;
  return row0 < p.m && col0 < p.n;
}

// A consumer warpgroup's place in the walk, advanced block by block
// with no division: the ring stage and the parity its full barrier
// completes with, the block within the stage, the scale group, the
// blocks left in it and its row among the stage's staged sb rows.
struct WgCursor {
  int st, ph, j;
  int grp, left, row;
};

__device__ __forceinline__ void wg_next_stage(WgCursor& c) {
  c.j = 0;
  c.row = 0;
  if (++c.st == kWgStages) {
    c.st = 0;
    c.ph ^= 1;
  }
}

// Named barriers that order the two consumer warpgroups' wgmma issue
// (barrier 0 is __syncthreads'): warpgroup 0 issues block t, then 1
// issues block t, then 0 issues block t+1 — so one warpgroup's
// promotion on the CUDA cores runs while the other's products hold the
// tensor cores, and the two do not fall into step.
constexpr int kTurn0 = 1, kTurn1 = 2;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Block j of a stage: its STEPS k32 products into the partial, the
// first one overwriting it.  da and db describe the stage's A rows and
// Bᵀ tile; a k32 step 32 bytes on is 2 more in the descriptor's address
// field (bytes / 16; shared memory stays below its 2^18-byte range).
template <int STEPS>
__device__ __forceinline__ void wg_products(uint64_t da, uint64_t db, int j,
                                            int (&part)[64]) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const uint64_t off = (j * STEPS + kk) * 2;
    hopper::wgmma_m64n128k32_s8(part, da + off, db + off, kk > 0);
  }
}

// Promote the block's partial into the float32 sum with the scales of
// its group: sa for the thread's two rows (zero past m) and sb for its 32
// columns, from the stage.
__device__ __forceinline__ void wg_promote(const float* sb,
                                           const int (&part)[64],
                                           float (&acc)[64], float sa0,
                                           float sa1) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 c = *reinterpret_cast<const float2*>(sb + 8 * j);
    acc[4 * j] = promote(acc[4 * j], exact_float(part[4 * j]), sa0, c.x);
    acc[4 * j + 1] =
        promote(acc[4 * j + 1], exact_float(part[4 * j + 1]), sa0, c.y);
    acc[4 * j + 2] =
        promote(acc[4 * j + 2], exact_float(part[4 * j + 2]), sa1, c.x);
    acc[4 * j + 3] =
        promote(acc[4 * j + 3], exact_float(part[4 * j + 3]), sa1, c.y);
  }
}

__global__ void __launch_bounds__(384, 1)
quant_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_sb, const Params p,
                   int n_work) {
  constexpr int S = kWgStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kStageBytes);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      // one arrival per consumer warp: each reads its sb from the
      // stage until its promotion is done
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int n_stages = (p.k + kWgDepth - 1) / kWgDepth;   // a tile

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full, tile after tile
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int L = blockIdx.x; L < n_work; L += gridDim.x) {
      int row0, col0;
      if (!wg_tile(p, L, row0, col0)) continue;
      for (int s = 0; s < n_stages; ++s, ++it) {
        const int st = it % S, ph = (it / S) & 1;
        unsigned char* base = ring + st * kStageBytes;
        const int k0 = s * kWgDepth;
        hopper::mbar_wait(&empty[st], ph ^ 1);
        hopper::mbar_expect_tx(&full[st], kStageBytes);
        hopper::tma_load_3d(base, &tm_a, k0, row0, 0, &full[st]);
        hopper::tma_load_3d(base + kABytes, &tm_b, k0, col0, 0, &full[st]);
        hopper::tma_load_3d(base + kABytes + kBBytes, &tm_sb, col0,
                            k0 / p.group, 0, &full[st]);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [wg·64, wg·64 + 64) of each CTA tile
  hopper::reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int q4 = lane & 3;
  const int per_stage = kWgDepth / p.bk, per_group = p.group / p.bk;
  WgCursor c = {0, 0, 0, 0, per_group, 0};
  int part[64];
  float acc[64];
  bool first = true;
  for (int L = blockIdx.x; L < n_work; L += gridDim.x) {
    int row0, col0;
    if (!wg_tile(p, L, row0, col0)) continue;
    const int r_a = row0 + wg * 64 + warp * 16 + (lane >> 2), r_b = r_a + 8;
    // the thread's rows of sa, or none past m
    const float* sa_a = r_a < p.m ? p.sa + static_cast<size_t>(r_a) * p.ng
                                  : nullptr;
    const float* sa_b = r_b < p.m ? p.sa + static_cast<size_t>(r_b) * p.ng
                                  : nullptr;
    float sa0 = sa_a ? __ldg(sa_a) : 0.f, sa1 = sa_b ? __ldg(sa_b) : 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int t = 0; t < p.nk; ++t) {
      unsigned char* stage = ring + c.st * kStageBytes;
      if (c.j == 0) hopper::mbar_wait(&full[c.st], c.ph);
      if (wg == 1) bar_sync(kTurn1);
      else if (!first) bar_sync(kTurn0);
      first = false;
      const uint64_t da = hopper::desc_sw128(stage + wg * 64 * 128, 16, 1024);
      const uint64_t db = hopper::desc_sw128(stage + kABytes, 16, 1024);
      hopper::wgmma_fence();
      switch (p.bk) {
        case 32: wg_products<1>(da, db, c.j, part); break;
        case 64: wg_products<2>(da, db, c.j, part); break;
        default: wg_products<4>(da, db, c.j, part); break;
      }
      hopper::wgmma_commit();
      bar_arrive(wg == 0 ? kTurn1 : kTurn0);
      // the next block's row scales, in flight while this block runs
      const float s0 = sa0, s1 = sa1;
      const int next = c.left == 1 ? c.grp + 1 : c.grp;
      if (t + 1 < p.nk) {
        sa0 = sa_a ? __ldg(sa_a + next) : 0.f;
        sa1 = sa_b ? __ldg(sa_b + next) : 0.f;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(part);
      wg_promote(reinterpret_cast<const float*>(stage + kABytes + kBBytes) +
                     c.row * kWgCols + 2 * q4,
                 part, acc, s0, s1);
      const bool stage_done = c.j == per_stage - 1 || t == p.nk - 1;
      if (stage_done) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[c.st]);
      }
      if (--c.left == 0) {
        ++c.grp;
        ++c.row;
        c.left = per_group;
      }
      if (stage_done) wg_next_stage(c);
      else ++c.j;
    }
    c.grp = 0;
    c.left = per_group;
    c.row = 0;

#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + j * 8 + 2 * q4;
      if (col >= p.n) continue;   // n is a multiple of 16: col + 1 < n
      const size_t ia = static_cast<size_t>(r_a) * p.n + col;
      const size_t ib = static_cast<size_t>(r_b) * p.n + col;
      if (p.out_bf16) {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.c);
        if (r_a < p.m)
          *reinterpret_cast<uint32_t*>(out + ia) =
              hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
        if (r_b < p.m)
          *reinterpret_cast<uint32_t*>(out + ib) =
              hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      } else {
        float* out = static_cast<float*>(p.c);
        if (r_a < p.m)
          *reinterpret_cast<float2*>(out + ia) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
        if (r_b < p.m)
          *reinterpret_cast<float2*>(out + ib) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
  // warpgroup 1's last turn hand-back, so no barrier is left half-arrived
  if (wg == 0 && !first) bar_sync(kTurn0);
}

cudaError_t launch_wgmma(const Params& p, int8_t* bt, cudaStream_t st) {
  // Bᵀ first, on the same stream
  dim3 tgrid((p.n + 63) / 64, (p.k + 63) / 64);
  if (tgrid.y > 65535) return cudaErrorInvalidValue;
  transpose_kernel<<<tgrid, 256, 0, st>>>(p.b, bt, p.k, p.n);
  cudaError_t r = cudaGetLastError();
  if (r != cudaSuccess) return r;
  CUtensorMap ta, tb, tsb;
  int e = hopper::encode_tensor_map_3d(&ta, p.a, p.k, p.m, 1, kWgRows,
                                       CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (!e) e = hopper::encode_tensor_map_3d(&tb, bt, p.k, p.n, 1, kWgCols,
                                           CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (!e) e = hopper::encode_tensor_map(&tsb, p.sb,
                                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.n,
                                        p.ng, 1, kWgCols, kSbRows, false);
  if (e) return static_cast<cudaError_t>(e);
  const long long n_work = static_cast<long long>(p.mi) * p.nj * p.subm *
                           p.subn;
  if (n_work > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  r = cudaGetDevice(&dev);
  if (r == cudaSuccess)
    r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (r != cudaSuccess) return r;
  const int grid = n_work < sms ? static_cast<int>(n_work) : sms;
  r = cudaFuncSetAttribute(quant_wgmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kWgSmem);
  if (r != cudaSuccess) return r;
  quant_wgmma_kernel<<<grid, 384, kWgSmem, st>>>(ta, tb, tsb, p,
                                                 static_cast<int>(n_work));
  return cudaGetLastError();
}

}  // namespace

// C entry point.  a (m, k), b (k, n) row-major int8; sa (m, ceil(k /
// group)), sb (ceil(k / group), n) row-major float32; c (m, n) in
// bfloat16 when `out_bf16`, else float32.  bm x bn x bk is the config
// tile (bk must divide group).  With `wgmma` (bm and bn multiples of 128,
// bk 32, 64 or 128, k and n multiples of 16, a, b and sb 16-byte
// aligned) `bt` is n x k bytes of scratch for Bᵀ, written here before the
// GEMM on the same stream, and tm x tn is 128 x 128; otherwise `bt` is
// unused, tm x tn is an instance of the first design and `vec` asks for
// 16-byte copies, which the caller allows only when k, n, bk, bn and both
// operand pointers are 16-byte aligned.  Returns cudaGetLastError() after
// the launches.
extern "C" int quant_gemm_launch(const void* a, const void* b,
                                 const void* sa, const void* sb, void* c,
                                 void* bt, int m, int n, int k, int group,
                                 int bm, int bn, int bk, int tm, int tn,
                                 int out_bf16, int vec, int wgmma,
                                 void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || group <= 0 || bm <= 0 || bn <= 0 ||
      bk <= 0 || group % bk)
    return cudaErrorInvalidValue;
  Params p;
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.c = c;
  p.m = m;
  p.n = n;
  p.k = k;
  p.group = group;
  p.ng = (k + group - 1) / group;
  p.bm = bm;
  p.bn = bn;
  p.bk = bk;
  p.subm = (bm + tm - 1) / tm;
  p.subn = (bn + tn - 1) / tn;
  p.mi = (m + bm - 1) / bm;
  p.nj = (n + bn - 1) / bn;
  p.nk = (k + bk - 1) / bk;
  p.vec = vec;
  p.out_bf16 = out_bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (tm != kWgRows || tn != kWgCols || bm % tm || bn % tn || k % 16 ||
        n % 16 || kWgDepth % bk || bk < 32 || bt == nullptr)
      return cudaErrorInvalidValue;
    return static_cast<int>(launch_wgmma(p, static_cast<int8_t*>(bt), st));
  }
  const long long ctas = static_cast<long long>(p.mi) * p.nj * p.subm *
                         p.subn;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(ctas));
  cudaError_t e;
  switch (tm) {
    case 16: e = launch_tn<16>(p, tn, grid, st); break;
    case 32: e = launch_tn<32>(p, tn, grid, st); break;
    case 64: e = launch_tn<64>(p, tn, grid, st); break;
    case 128: e = launch_tn<128>(p, tn, grid, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
