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
//   * split_k > 1: K blocks s*nk .. s*nk+nk-1 go to grid row s, which
//     writes float32 partials at rows s*m + r of a (split_k*m, n) buffer;
//     the wrapper sums them in float32 and casts (as the TPU kernel's
//     caller does); stagger_k is ignored under split_k, as there;
//   * the config's precision knob is ignored: the accumulator is f32.
//
// Design.  One CTA of 128 threads (four warps) computes a TM x TN tile,
// TM in {16, 32, 64, 128} and TN in {32, 64, 128} (template instances).
// The wrapper picks the largest instance that divides the config's
// bm x bn tile; a larger config tile is covered by several CTAs, launched
// one after another so that they share the tile's operand panels in L2.
// Inside a CTA the K walk of the config (bk-deep blocks, in the config's
// order) is staged through shared memory in 32-deep chunks, two stages
// deep: 16-byte cp.async copies with zero-fill at the edge when every
// operand row and block start is 16-byte aligned, masked element loads
// otherwise.  bf16 products run on the tensor cores with
// mma.sync.m16n8k16 (f32 accumulator fragments in registers); f32
// products run as FMAs on the CUDA cores, since the tensor cores would
// take f32 only as TF32 and the port keeps TF32 off.
//
// What bounds it.  At the family's production problem, 8192^3 bf16, the
// work is 1.1e12 operations against 403 MB of operands: 1.11 ms at the
// card's 989 TFLOP/s and 0.12 ms at 3.35 TB/s, so operations bound it.
// This simple kernel does not come near that: mma.sync fed by 16-bit
// shared-memory loads reaches a fraction of the tensor-core rate, which
// only wgmma reaches.  wgmma fed by TMA, with a persistent warp-
// specialised pipeline, is left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  int nj;               // config tiles along n
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

}  // namespace

// C entry point.  a (m, k), b (k, n) row-major of one type (bf16 when
// `bf16`, else f32); c (m, n), or (split*m, n) f32 partials when
// split > 1, in bf16 when `out_bf16`, else f32.  tm x tn is the CTA tile
// (an instance above); `vec` asks for 16-byte copies, which the caller
// allows only when k, n, bk, bn and both base pointers are 16-byte
// aligned.  Returns cudaGetLastError() after the launch.
extern "C" int gemm_launch(const void* a, const void* b, void* c, int m,
                           int n, int k, int bm, int bn, int bk, int split,
                           int stagger, int tm, int tn, int bf16,
                           int out_bf16, int vec, void* stream) {
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
  p.nj = (n + bn - 1) / bn;
  p.nk_total = (k + bk - 1) / bk;
  if (p.nk_total % split) return cudaErrorInvalidValue;
  p.nk = p.nk_total / split;
  p.vec = vec;
  p.out_bf16 = out_bf16;
  const long long mi = (m + bm - 1) / bm;
  const long long ctas = mi * p.nj * p.subm * p.subn;
  if (ctas > 0x7fffffffLL || split > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(ctas), split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = bf16 ? launch_tile<__nv_bfloat16>(p, tm, tn, grid, st)
                       : launch_tile<float>(p, tm, tn, grid, st);
  return static_cast<int>(e);
}
