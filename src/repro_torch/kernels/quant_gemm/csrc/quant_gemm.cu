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
//     int32 partial, and at the block's end `float(partial) * sa[r, g] *
//     sb[g, c]` is added into a float32 accumulator — dequantise before
//     accumulate, the TPU kernel's rounding point, which the family's
//     `acc_depends_k` invariant is about;
//   * the ragged edge (m, n, k not multiples of the config tile) is masked
//     here, in the loads and the stores: masked int8 loads are zero, so
//     they add nothing to the partial, as the TPU kernel's zero padding;
//   * the output is float32 or bfloat16 (one rounding of the f32 sum).
//
// Design.  One CTA of 128 threads (four warps) computes a TM x TN tile,
// TM in {16, 32, 64, 128} and TN in {32, 64} (template instances); the
// wrapper picks the largest instance dividing the config's bm x bn tile,
// and a larger config tile is covered by several CTAs launched one after
// another (they share the tile's operand panels in L2).  A bk block is
// staged through shared memory in 32-deep chunks, two stages deep:
// 16-byte cp.async copies with zero-fill at the edge when every row and
// block start is 16-byte aligned, masked byte loads otherwise.  Each
// chunk is one mma.sync.m16n8k32 s8 step per 16 x 8 output fragment.
// A's fragment is four consecutive K bytes of a row (one 32-bit shared
// load); B is (k, n) row-major, but the instruction wants four
// consecutive K bytes of one column, so each B register is assembled from
// four byte loads of shared memory (no transpose of B in device memory).
// Every thread holds two accumulators: the int32 partial of the current
// block and the float32 sum — 128 registers at 128 x 64, which is why
// the column tile stops at 64.
//
// What bounds it.  At the family's production problem, 8192^3 int8 with
// 128-wide groups, the work is 1.1e12 int8 operations against 134 MB of
// operands, 4 MB of scales and 268 MB of float32 output: 0.556 ms at the
// card's 1,979 TOP/s and 0.121 ms at 3.35 TB/s, so operations bound it.
// This simple kernel does not come near that: mma.sync fed from shared
// memory (B by byte loads) reaches a fraction of the int8 tensor-core
// rate, which only wgmma reaches; the per-block epilogue adds two float32
// multiplies and an add per output per bk block on the CUDA cores.  wgmma
// fed by TMA, with B staged K-major, is left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  int nj;               // config tiles along n
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
            acc[i] += static_cast<float>(part[i]) * sr[e >> 1] * sc[e & 1];
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

}  // namespace

// C entry point.  a (m, k), b (k, n) row-major int8; sa (m, ceil(k /
// group)), sb (ceil(k / group), n) row-major float32; c (m, n) in
// bfloat16 when `out_bf16`, else float32.  bm x bn x bk is the config
// tile (bk must divide group), tm x tn the CTA tile (an instance above);
// `vec` asks for 16-byte copies, which the caller allows only when k, n,
// bk, bn and both operand pointers are 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int quant_gemm_launch(const void* a, const void* b,
                                 const void* sa, const void* sb, void* c,
                                 int m, int n, int k, int group, int bm,
                                 int bn, int bk, int tm, int tn,
                                 int out_bf16, int vec, void* stream) {
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
  p.nj = (n + bn - 1) / bn;
  p.nk = (k + bk - 1) / bk;
  p.vec = vec;
  p.out_bf16 = out_bf16;
  const long long mi = (m + bm - 1) / bm;
  const long long ctas = mi * p.nj * p.subm * p.subn;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(ctas));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
