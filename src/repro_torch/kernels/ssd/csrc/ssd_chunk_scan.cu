// SSD (Mamba-2 state-space dual) chunk scan for Hopper (sm_90a), on
// tensor cores with float32 accuracy (3xTF32).
//
// Replaces the JAX package's Pallas TPU kernel src/repro/kernels/ssd/ssd.py
// (`ssd_chunk_scan`, body `_ssd_kernel`, its pallas_call at :78) and
// computes what it computes, per (bh, chunk c) of `q` positions:
//   cs = cumsum(da) within the chunk (reset at every chunk boundary);
//   y  = ((C·Bᵀ) ⊙ L)·x + exp(cs) ⊙ (C·state),  L[i, j] = exp(cs_i − cs_j)
//        for j <= i, else 0 — taken from the difference, never as
//        exp(cs_i)·exp(−cs_j), which overflows over a long, fast-decaying
//        chunk;
//   state <- exp(cs_end)·state + Bᵀ·(exp(cs_end − cs) ⊙ x),
// with the (N, P) float32 state carried across the chunks of one bh.
// x, B and C are float32 or bfloat16 (read as float32), da float32, y in
// x's type; S is a multiple of q.
//
// What bounds it.  At the family's production problem (64 heads x 8192 x
// P 64 x N 128, float32) the operands are 0.81 GB, 0.241 ms at 3.35 TB/s;
// the algorithmic work at the best chunk, 2.1e10 operations, takes 0.126
// ms at 3xTF32's 165 TFLOP/s (a third of the dense TF32 rate), so bytes
// bound it.  The TPU kernel's sequential chunk axis is the obstacle on
// Hopper: one CTA walking a bh's 128 chunks in order leaves the card
// idle and its products run on the CUDA cores.
//
// Design: three launches on one stream from one C entry point.
//   (1) ssd_state_kernel, one CTA per (bh, chunk, 64 columns of P): cs
//       by a warp scan, then the chunk's own state contribution bx_c =
//       Bᵀ·(exp(cs_end − cs) ⊙ x) into float32 scratch (BH, nc, N, P),
//       and cs_end into (BH, nc);
//   (2) ssd_pass_kernel, one thread per (bh, state element): the TPU
//       kernel's recurrence in chunk order, S <- exp(cs_end_c)·S + bx_c,
//       writing over each bx_c the state S_{c-1} that enters chunk c;
//   (3) ssd_scan_kernel, one CTA per (bh, chunk, 64-row query block, 64
//       columns of P): y_i = exp(cs_i)·(C_i·S_{c-1}), then, flash-style
//       over the key blocks at or below the query block, s = (C_i·B_jᵀ)
//       ⊙ L_ij into shared memory and y_i += s·x_j.
// The state crosses device memory four times (written by (1), read and
// written by (2), read by (3)): 268 MB a pass at 64-long chunks of the
// production problem, so a longer chunk trades score work for state
// traffic (families/ssd.py prices both).  Every product is
// mma.sync.m16n8k8 TF32 with each float32 operand split into hi =
// tf32(a) (to nearest) and lo = a − hi, of which the tensor core reads
// the top 19 bits: lo·hi and hi·lo first, then hi·hi, into a float32
// accumulator — one TF32 product (2^-11 a rounding) would miss
// ssd_error's float32 limits; a bfloat16 operand is exact in TF32, so
// its lo products are skipped.  The split costs more issue slots than
// the products (PERF.md), so it is kept to three integer and float
// operations an element.  mma.sync and not wgmma: wgmma takes
// TF32 only K-major, and x (as the B of s·x), B (as the A of Bᵀ·x) and
// the state are MN-major as stored, while mma.sync fragments are loaded
// from shared memory in any layout.  The tiles sit in shared memory as
// float32 with row strides that make every fragment load free of bank
// conflicts; the state dim is zero-padded to a multiple of 8 (the k of
// the TF32 product), P to the 64-column tile and the chunk to whole
// 64-row blocks: the padding is zero and adds nothing.
//
// Any d_state: the state dim is walked in panels of 128 (NPANEL).  The
// chunk-state launch takes one panel a CTA (a grid axis: each reads the
// chunk's x again), so its accumulator and its staged B stay at 128 rows;
// where N is more than one panel the scan runs on ssd_scan_panel_kernel,
// which sums C·state and C·Bᵀ across the panels, staging the panel's C,
// state rows and B in turn (ssd_scan_kernel, unchanged, takes N up to
// 128).  The scratch keeps one (N, P) state a (bh, chunk).
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;  // eight warps
constexpr int BR = 64;        // rows of a query or key block
constexpr int PT = 64;        // columns of P a CTA
constexpr int LDX = PT + 8;   // x / state tile stride: 8 (mod 32) words
constexpr int LDS = BR + 4;   // score tile stride: 4 (mod 32) words
constexpr int NPANEL = 128;   // state rows a panel

struct Params {
  const void* x;
  const float* da;
  const void* b;
  const void* c;
  void* y;
  float* states;   // (bh, nc, N, P): bx_c, then the state entering c
  float* cs_end;   // (bh, nc)
  int bh_count, S, P, N, q, nc;
  int np;   // N padded to a multiple of 8
  int npp;  // rows of the widest panel: min(np, NPANEL)
  int npn;  // panels
  int qr;   // q padded to whole 64-row blocks
  int pt;   // 64-column tiles of P
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// a stride of n floats rounded up to 32 words, plus `mod`
__host__ __device__ __forceinline__ int stride(int n, int mod) {
  return (n + 31) / 32 * 32 + mod;
}

// cs[0, qr) = cumsum of the chunk's da (zeros added past q); run by one
// warp: each lane sums a run of positions, a warp scan of the runs'
// totals gives their offsets.  Every launch computes it the same way.
__device__ __forceinline__ void chunk_cumsum(const Params& p, size_t row0,
                                             float* cs) {
  const int lane = threadIdx.x & 31, per = p.qr / 32;
  float run = 0.f;
  for (int e = 0; e < per; ++e) {
    const int i = lane * per + e;
    run += i < p.q ? p.da[row0 + i] : 0.f;
    cs[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int e = 0; e < per; ++e) cs[lane * per + e] += excl;
}

// A 64-row tile of a chunk's (q, width) operand in flight: a warp takes
// every eighth row, lane l columns l, l + 32, ... (CK of them, up to 32·CK
// columns).  fetch() issues every load of the tile before any is used,
// so a CTA can have two tiles in flight; put() stores them as float32,
// each row times scale[r] when given.
template <int CK>
struct TileRegs {
  float v[BR / 8][CK];
};

// Rows [r0, r0 + 64), columns [c0, c0 + cols); zero past the chunk's q
// rows, past `width` and past `cols`.
template <typename T, int CK>
__device__ __forceinline__ void fetch(TileRegs<CK>& t, const T* src,
                                      size_t row0, int width, int q, int r0,
                                      int c0, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < BR / 8; ++i) {
    const int r = warp + 8 * i;
    const bool row_ok = r0 + r < q;
    const T* s = src + (row0 + r0 + r) * static_cast<size_t>(width) + c0;
#pragma unroll
    for (int k = 0; k < CK; ++k) {
      const int c = lane + 32 * k;
      t.v[i][k] = row_ok && c < cols && c0 + c < width ? to_f(s[c]) : 0.f;
    }
  }
}

template <int CK>
__device__ __forceinline__ void put(const TileRegs<CK>& t, float* dst,
                                    int ld, int cols, const float* scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < BR / 8; ++i) {
    const int r = warp + 8 * i;
    const float w = scale != nullptr ? scale[r] : 1.f;
#pragma unroll
    for (int k = 0; k < CK; ++k) {
      const int c = lane + 32 * k;
      if (c < cols) dst[r * ld + c] = w * t.v[i][k];
    }
  }
}

// Rows [r0, r0 + 64), columns [c0, c0 + cols) of a chunk's operand into
// dst (row stride ld) in 64-column passes: half the registers of a
// 128-column TileRegs in flight, for the state panels' staging.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      size_t row0, int width, int q, int r0,
                                      int c0, int cols) {
  for (int h = 0; h < cols; h += 64) {
    TileRegs<2> t;
    fetch(t, src, row0, width, q, r0, c0 + h, min(64, cols - h));
    put(t, dst + h, ld, min(64, cols - h), nullptr);
  }
}

__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// d += a·b in 3xTF32 for fragments held as float32: lo·hi and hi·lo
// first, then hi·hi; an operand exact in TF32 (bfloat16 data) skips the
// product of its lo.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float* d, const float (&a)[4],
                                     const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) hopper::split_tf32(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) hopper::split_tf32(b[i], bh[i], bl[i]);
  if (!A_EXACT) hopper::mma_tf32(d, al, bh[0], bh[1]);
  if (!B_EXACT) hopper::mma_tf32(d, ah, bl[0], bl[1]);
  hopper::mma_tf32(d, ah, bh[0], bh[1]);
}

// The A fragment (16 x 8) at rows m0.., columns k0.. of a row-major tile
// (ld a row), and the B fragment (8 x 8) at rows k0.., columns n0.. of a
// row-major (k, n) tile or of a column-major one (n rows of k).
__device__ __forceinline__ void frag_a(const float* t, int ld, int m0,
                                       int k0, float (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  const float* r = t + (m0 + g) * ld + k0 + c;
  a[0] = r[0];
  a[1] = r[8 * ld];
  a[2] = r[4];
  a[3] = r[8 * ld + 4];
}
// A (16 x 8) stored transposed: element (m, k) at t[k * ld + m]
__device__ __forceinline__ void frag_a_t(const float* t, int ld, int m0,
                                         int k0, float (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  const float* r = t + (k0 + c) * ld + m0 + g;
  a[0] = r[0];
  a[1] = r[8];
  a[2] = r[4 * ld];
  a[3] = r[4 * ld + 8];
}
__device__ __forceinline__ void frag_b(const float* t, int ld, int k0,
                                       int n0, float (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  const float* r = t + (k0 + c) * ld + n0 + g;
  b[0] = r[0];
  b[1] = r[4 * ld];
}
// B (8 x 8) stored transposed: element (k, n) at t[n * ld + k]
__device__ __forceinline__ void frag_b_t(const float* t, int ld, int k0,
                                         int n0, float (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  const float* r = t + (n0 + g) * ld + k0 + c;
  b[0] = r[0];
  b[1] = r[4];
}

// -- (1) chunk states --------------------------------------------------------

// bx_c (state rows of panel blockIdx.z x 64 columns of P) = Bᵀ · (dte ⊙
// x) (q x 64): warp w owns the panel's state rows [16w, 16w + 16), all 64
// columns; the chunk goes by in 64-row blocks.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const Params p) {
  constexpr bool EXACT = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int ldb = stride(p.npp, 8);
  const int n0 = blockIdx.z * NPANEL, pnp = min(p.np - n0, NPANEL);
  float* Bs = smem;                // 64 x ldb: a block of B, (pos, n)
  float* Xs = Bs + BR * ldb;       // 64 x LDX: dte ⊙ x
  float* cs = Xs + BR * LDX;       // qr
  float* dte = cs + p.qr;          // qr: exp(cs_end - cs)
  const int bh = blockIdx.x / p.nc, ch = blockIdx.x % p.nc;
  const int p0 = blockIdx.y * PT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t row0 = static_cast<size_t>(bh) * p.S +
                      static_cast<size_t>(ch) * p.q;
  if (warp == 0) chunk_cumsum(p, row0, cs);
  __syncthreads();
  const float cs_end = cs[p.q - 1];
  for (int i = threadIdx.x; i < p.qr; i += THREADS)
    dte[i] = i < p.q ? expf(cs_end - cs[i]) : 0.f;
  if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    p.cs_end[static_cast<size_t>(bh) * p.nc + ch] = cs_end;
  __syncthreads();

  const int m0 = 16 * warp;
  const bool live = m0 < pnp;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int j0 = 0; j0 < p.qr; j0 += BR) {
    // the last live warp's rows run to a multiple of 16: zero past np
    const int bcols = (pnp + 15) / 16 * 16;
    TileRegs<NPANEL / 32> tb;
    TileRegs<PT / 32> tx;
    fetch(tb, static_cast<const T*>(p.b), row0, p.N, p.q, j0, n0, bcols);
    fetch(tx, static_cast<const T*>(p.x), row0, p.P, p.q, j0, p0, PT);
    put(tb, Bs, ldb, bcols, nullptr);
    put(tx, Xs, LDX, PT, dte + j0);
    __syncthreads();
    if (live) {
      for (int k0 = 0; k0 < BR; k0 += 8) {
        float a[4];
        frag_a_t(Bs, ldb, m0, k0, a);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float b[2];
          frag_b(Xs, LDX, k0, nt * 8, b);
          mma3<EXACT, false>(acc[nt], a, b);
        }
      }
    }
    __syncthreads();
  }
  float* out = p.states + (static_cast<size_t>(bh) * p.nc + ch) *
                              static_cast<size_t>(p.N) * p.P;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + m0 + g + (e >= 2 ? 8 : 0);
      const int c = p0 + nt * 8 + 2 * t4 + (e & 1);
      if (n < p.N && c < p.P) out[static_cast<size_t>(n) * p.P + c] =
          acc[nt][e];
    }
}

// -- (2) the state pass ------------------------------------------------------

// V state elements a thread (4 when N·P allows 16-byte vectors), the
// chunks in order, eight chunks' loads in flight ahead of the
// recurrence; the bh's chunk decays staged in shared memory first.
template <int V>
struct Vec;
template <> struct Vec<1> { using type = float; };
template <> struct Vec<4> { using type = float4; };

__device__ __forceinline__ float& lane_of(float& v, int) { return v; }
__device__ __forceinline__ float& lane_of(float4& v, int i) {
  return (&v.x)[i];
}

template <int V>
__global__ void __launch_bounds__(256)
ssd_pass_kernel(const Params p) {
  using VT = typename Vec<V>::type;
  constexpr int U = 8;
  extern __shared__ float dec[];   // exp(cs_end) of each chunk
  const int bh = blockIdx.y;
  const float* ce = p.cs_end + static_cast<size_t>(bh) * p.nc;
  for (int c = threadIdx.x; c < p.nc; c += 256) dec[c] = expf(ce[c]);
  __syncthreads();
  const size_t NV = static_cast<size_t>(p.N) * p.P / V;
  const size_t e = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= NV) return;
  VT* st = reinterpret_cast<VT*>(p.states) +
           static_cast<size_t>(bh) * p.nc * NV + e;
  float s[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = 0.f;
  int c = 0;
  for (; c + U <= p.nc; c += U) {
    VT bx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) bx[u] = st[(c + u) * NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      VT out;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        lane_of(out, i) = s[i];
        s[i] = dec[c + u] * s[i] + lane_of(bx[u], i);
      }
      st[(c + u) * NV] = out;
    }
  }
  for (; c < p.nc; ++c) {
    VT bx = st[c * NV], out;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      lane_of(out, i) = s[i];
      s[i] = dec[c] * s[i] + lane_of(bx, i);
    }
    st[c * NV] = out;
  }
}

// -- (3) the chunk scan ------------------------------------------------------

// y of one 64-row query block and 64 columns of P: warp w owns rows
// [16 (w % 4), +16) and columns [32 (w / 4), +32) of y and of each score
// tile.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel(const Params p) {
  constexpr bool EXACT = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int ldc = stride(p.np, 4);
  float* Cs = smem;                // 64 x ldc: the query block of C
  float* Bs = Cs + BR * ldc;       // 64 x ldc: a key block of B, (pos, n)
  float* Xs = Bs + BR * ldc;       // 64 x LDX: a key block of x
  float* Ss = Xs + BR * LDX;       // 64 x LDS: a score tile
  float* cs = Ss + BR * LDS;       // qr
  float* St = Bs;                  // np x LDX: the entering state, first
  const int bh = blockIdx.x / p.nc, ch = blockIdx.x % p.nc;
  const int qb = blockIdx.y, p0 = blockIdx.z * PT, i0 = qb * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = 16 * (warp & 3), wc = 32 * (warp >> 2);
  const size_t row0 = static_cast<size_t>(bh) * p.S +
                      static_cast<size_t>(ch) * p.q;
  if (warp == 0) chunk_cumsum(p, row0, cs);
  const float* sg = p.states + (static_cast<size_t>(bh) * p.nc + ch) *
                                   static_cast<size_t>(p.N) * p.P;
  {
    TileRegs<NPANEL / 32> tc;
    TileRegs<PT / 32> ts0, ts1;
    fetch(tc, static_cast<const T*>(p.c), row0, p.N, p.q, i0, 0, p.np);
    fetch(ts0, sg, 0, p.P, p.N, 0, p0, PT);
    if (p.np > BR) fetch(ts1, sg, 0, p.P, p.N, BR, p0, PT);
    put(tc, Cs, ldc, p.np, nullptr);
    put(ts0, St, LDX, PT, nullptr);
    if (p.np > BR) put(ts1, St + BR * LDX, LDX, PT, nullptr);
  }
  __syncthreads();

  // inter-chunk term: exp(cs_i) * (C_i · S)
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int k0 = 0; k0 < p.np; k0 += 8) {
    float a[4];
    frag_a(Cs, ldc, wr, k0, a);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float b[2];
      frag_b(St, LDX, k0, wc + nt * 8, b);
      mma3<EXACT, false>(acc[nt], a, b);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + wr + g + 8 * h;
    const float d = i < p.q ? expf(cs[i]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[nt][2 * h] *= d;
      acc[nt][2 * h + 1] *= d;
    }
  }
  __syncthreads();   // the key blocks overwrite the state tile

  // intra-chunk term over the key blocks at or below this one
  for (int kb = 0; kb <= qb; ++kb) {
    const int j0 = kb * BR;
    {
      TileRegs<NPANEL / 32> tb;
      TileRegs<PT / 32> tx;
      fetch(tb, static_cast<const T*>(p.b), row0, p.N, p.q, j0, 0, p.np);
      fetch(tx, static_cast<const T*>(p.x), row0, p.P, p.q, j0, p0, PT);
      put(tb, Bs, ldc, p.np, nullptr);
      put(tx, Xs, LDX, PT, nullptr);
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int k0 = 0; k0 < p.np; k0 += 8) {
      float a[4];
      frag_a(Cs, ldc, wr, k0, a);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float b[2];
        frag_b_t(Bs, ldc, k0, wc + nt * 8, b);
        mma3<EXACT, EXACT>(s[nt], a, b);
      }
    }
    // s ⊙ L into the score tile
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + g + 8 * h, i = i0 + r;
        const int c = wc + nt * 8 + 2 * t4, j = j0 + c;
        float2 v;
        v.x = j <= i && i < p.q ? s[nt][2 * h] * expf(cs[i] - cs[j]) : 0.f;
        v.y = j + 1 <= i && i < p.q
                  ? s[nt][2 * h + 1] * expf(cs[i] - cs[j + 1])
                  : 0.f;
        *reinterpret_cast<float2*>(Ss + r * LDS + c) = v;
      }
    __syncthreads();
    for (int k0 = 0; k0 < BR; k0 += 8) {
      float a[4];
      frag_a(Ss, LDS, wr, k0, a);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float b[2];
        frag_b(Xs, LDX, k0, wc + nt * 8, b);
        mma3<false, EXACT>(acc[nt], a, b);
      }
    }
    __syncthreads();   // the next key block overwrites Bs, Xs, Ss
  }

  T* yg = static_cast<T*>(p.y);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + wr + g + (e >= 2 ? 8 : 0);
      const int c = p0 + wc + nt * 8 + 2 * t4 + (e & 1);
      if (i < p.q && c < p.P)
        yg[(row0 + i) * static_cast<size_t>(p.P) + c] = from_f<T>(acc[nt][e]);
    }
}

// -- (3') the chunk scan at a d_state above one panel -------------------------

// ssd_scan_kernel's work where the state dim is more than one panel: C·S
// and C·Bᵀ summed over the state panels, each panel's C, state rows and B
// staged in turn (64 columns at a time, so that its registers stay those
// of one 64-column tile), C staged again for every key block.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_panel_kernel(const Params p) {
  constexpr bool EXACT = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int ldc = stride(p.npp, 4);
  float* Cs = smem;                // 64 x ldc: a panel of the query block's C
  float* Bs = Cs + BR * ldc;       // 64 x ldc: a panel of a key block's B
  float* Xs = Bs + BR * ldc;       // 64 x LDX: a key block of x
  float* Ss = Xs + BR * LDX;       // 64 x LDS: a score tile
  float* cs = Ss + BR * LDS;       // qr
  float* St = Bs;                  // npp x LDX: a panel of the state, first
  const int bh = blockIdx.x / p.nc, ch = blockIdx.x % p.nc;
  const int qb = blockIdx.y, p0 = blockIdx.z * PT, i0 = qb * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = 16 * (warp & 3), wc = 32 * (warp >> 2);
  const size_t row0 = static_cast<size_t>(bh) * p.S +
                      static_cast<size_t>(ch) * p.q;
  if (warp == 0) chunk_cumsum(p, row0, cs);
  const float* sg = p.states + (static_cast<size_t>(bh) * p.nc + ch) *
                                   static_cast<size_t>(p.N) * p.P;

  // inter-chunk term: exp(cs_i) * (C_i · S)
  float acc[4][4];
  zero(acc);
  for (int pn = 0; pn < p.npn; ++pn) {
    const int n0 = pn * NPANEL, pnp = min(p.np - n0, NPANEL);
    if (pn > 0) __syncthreads();   // the previous panel has been read
    stage(Cs, ldc, static_cast<const T*>(p.c), row0, p.N, p.q, i0, n0, pnp);
    stage(St, LDX, sg, 0, p.P, p.N, n0, p0, PT);
    if (pnp > BR) stage(St + BR * LDX, LDX, sg, 0, p.P, p.N, n0 + BR, p0, PT);
    __syncthreads();
    for (int k0 = 0; k0 < pnp; k0 += 8) {
      float a[4];
      frag_a(Cs, ldc, wr, k0, a);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float b[2];
        frag_b(St, LDX, k0, wc + nt * 8, b);
        mma3<EXACT, false>(acc[nt], a, b);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + wr + g + 8 * h;
    const float d = i < p.q ? expf(cs[i]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[nt][2 * h] *= d;
      acc[nt][2 * h + 1] *= d;
    }
  }
  __syncthreads();   // the key blocks overwrite the state tile

  // intra-chunk term over the key blocks at or below this one
  for (int kb = 0; kb <= qb; ++kb) {
    const int j0 = kb * BR;
    float s[4][4];
    zero(s);
    for (int pn = 0; pn < p.npn; ++pn) {
      const int n0 = pn * NPANEL, pnp = min(p.np - n0, NPANEL);
      if (pn > 0) __syncthreads();   // the previous panel has been read
      stage(Cs, ldc, static_cast<const T*>(p.c), row0, p.N, p.q, i0, n0,
            pnp);
      stage(Bs, ldc, static_cast<const T*>(p.b), row0, p.N, p.q, j0, n0,
            pnp);
      if (pn == 0)
        stage(Xs, LDX, static_cast<const T*>(p.x), row0, p.P, p.q, j0, p0,
              PT);
      __syncthreads();
      for (int k0 = 0; k0 < pnp; k0 += 8) {
        float a[4];
        frag_a(Cs, ldc, wr, k0, a);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float b[2];
          frag_b_t(Bs, ldc, k0, wc + nt * 8, b);
          mma3<EXACT, EXACT>(s[nt], a, b);
        }
      }
    }
    // s ⊙ L into the score tile
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + g + 8 * h, i = i0 + r;
        const int c = wc + nt * 8 + 2 * t4, j = j0 + c;
        float2 v;
        v.x = j <= i && i < p.q ? s[nt][2 * h] * expf(cs[i] - cs[j]) : 0.f;
        v.y = j + 1 <= i && i < p.q
                  ? s[nt][2 * h + 1] * expf(cs[i] - cs[j + 1])
                  : 0.f;
        *reinterpret_cast<float2*>(Ss + r * LDS + c) = v;
      }
    __syncthreads();
    for (int k0 = 0; k0 < BR; k0 += 8) {
      float a[4];
      frag_a(Ss, LDS, wr, k0, a);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float b[2];
        frag_b(Xs, LDX, k0, wc + nt * 8, b);
        mma3<false, EXACT>(acc[nt], a, b);
      }
    }
    __syncthreads();   // the next key block overwrites Bs, Xs, Ss
  }

  T* yg = static_cast<T*>(p.y);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + wr + g + (e >= 2 ? 8 : 0);
      const int c = p0 + wc + nt * 8 + 2 * t4 + (e & 1);
      if (i < p.q && c < p.P)
        yg[(row0 + i) * static_cast<size_t>(p.P) + c] = from_f<T>(acc[nt][e]);
    }
}

size_t state_smem(const Params& p) {
  return sizeof(float) * (static_cast<size_t>(BR) * stride(p.npp, 8) +
                          BR * LDX + 2 * static_cast<size_t>(p.qr));
}

size_t scan_smem(const Params& p) {
  return sizeof(float) * (2 * static_cast<size_t>(BR) * stride(p.npp, 4) +
                          BR * LDX + BR * LDS + static_cast<size_t>(p.qr));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const unsigned chunks = static_cast<unsigned>(p.bh_count) * p.nc;
  const size_t s1 = state_smem(p), s3 = scan_smem(p);
  cudaError_t e = allow_smem(ssd_state_kernel<T>, s1);
  const auto scan =
      p.npn == 1 ? ssd_scan_kernel<T> : ssd_scan_panel_kernel<T>;
  if (e == cudaSuccess) e = allow_smem(scan, s3);
  if (e != cudaSuccess) return e;
  ssd_state_kernel<T><<<dim3(chunks, p.pt, p.npn), THREADS, s1, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t np = static_cast<size_t>(p.N) * p.P;
  const size_t s2 = sizeof(float) * static_cast<size_t>(p.nc);
  if (np % 4 == 0) {
    e = allow_smem(ssd_pass_kernel<4>, s2);
    if (e != cudaSuccess) return e;
    ssd_pass_kernel<4><<<dim3(static_cast<unsigned>((np / 4 + 255) / 256),
                              p.bh_count), 256, s2, st>>>(p);
  } else {
    e = allow_smem(ssd_pass_kernel<1>, s2);
    if (e != cudaSuccess) return e;
    ssd_pass_kernel<1><<<dim3(static_cast<unsigned>((np + 255) / 256),
                              p.bh_count), 256, s2, st>>>(p);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  scan<<<dim3(chunks, p.qr / BR, p.pt), THREADS, s3, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point.  x (bh, S, P), b and c (bh, S, N), contiguous, in
// bfloat16 when `bf16`, else float32; da (bh, S) float32; y (bh, S, P) in
// x's type.  q is the chunk (S a multiple of it), any N >= 1.
// `states` is scratch of bh·(S/q)·N·P float32 and `cs_end` of bh·(S/q).
// Launches the three kernels on `stream`; returns cudaGetLastError()
// after each launch (a chunk whose cumulative decays do not fit shared
// memory beside the tiles is refused there).
extern "C" int ssd_chunk_scan_launch(const void* x, const void* da,
                                     const void* b, const void* c, void* y,
                                     void* states, void* cs_end,
                                     int bh_count, int S, int P, int N,
                                     int q, int bf16, void* stream) {
  if (bh_count <= 0 || bh_count > 65535 || S <= 0 || P <= 0 || N <= 0 ||
      q <= 0 || S % q)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.da = static_cast<const float*>(da);
  p.b = b;
  p.c = c;
  p.y = y;
  p.states = static_cast<float*>(states);
  p.cs_end = static_cast<float*>(cs_end);
  p.bh_count = bh_count;
  p.S = S;
  p.P = P;
  p.N = N;
  p.q = q;
  p.nc = S / q;
  p.np = (N + 7) / 8 * 8;
  p.npp = p.np < NPANEL ? p.np : NPANEL;
  p.npn = (p.np + NPANEL - 1) / NPANEL;
  p.qr = (q + BR - 1) / BR * BR;
  p.pt = (P + PT - 1) / PT;
  if (static_cast<long long>(bh_count) * p.nc > 0x7fffffffLL ||
      p.qr / BR > 65535 || p.pt > 65535 || p.npn > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = bf16 ? launch<__nv_bfloat16>(p, st) : launch<float>(p, st);
  return static_cast<int>(e);
}
