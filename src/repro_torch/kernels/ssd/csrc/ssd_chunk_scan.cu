// SSD (Mamba-2 state-space dual) chunk scan for Hopper (sm_90a), all in
// float32 FMAs.
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
// Design.  The TPU grid (bh, c) runs its chunk axis in order on one core;
// on Hopper that axis becomes a loop inside one CTA of 256 threads, which
// owns (bh, 64 columns of P) and keeps its (N, 64) slice of the state in
// shared memory (32 KB at N = 128).  A chunk may be 512 long, and its
// q x q score tile (1 MB at 512) fits no SM, so the chunk is tiled as
// flash attention tiles a causal row, without the softmax: 64-row query
// blocks, and for each the key blocks at or below it — s = (C_i·B_jᵀ) ⊙
// L_ij into shared memory, then y_i += s·x_j; y_i starts from
// exp(cs_i)·(C_i·state), and after the chunk's last query block the state
// is updated from the key blocks once more.  The cumulative decays are a
// warp scan in shared memory.  Each thread holds a 4 x 4 block of y or of
// the scores (8 x 4 of the state); every product is a float32 FMA on the
// CUDA cores (the port keeps TF32 off).  The state dim is zero-padded to
// a multiple of 16, P to the 64-column tile and the chunk to whole
// 64-row blocks; the padding is zero and adds nothing.  A P wider than 64
// runs on several CTAs, each recomputing the scores: y's and the state's
// P columns are independent given the scores, so the split is exact.
//
// What bounds it.  At the family's production problem (64 heads x 8192 x
// P 64 x N 128, float32) the algorithmic work at the best chunk is about
// 2.4e10 operations and the operands 0.81 GB: 0.357 ms at 67 TFLOP/s and
// 0.241 ms at 3.35 TB/s, so operations bound it.  This kernel does not
// come near that: one CTA per (bh, P tile) leaves SMs idle at 64 heads,
// the products are FMAs fed from shared memory (a load for every two),
// and the chunks of one bh run one after another.  Tensor cores (TF32 or
// 3xTF32) and a chunk-parallel schedule (chunk states first, a short
// scan over them, then every chunk's y in parallel) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BR = 64;        // rows of a query or key block
constexpr int PT = 64;        // columns of P per CTA
constexpr int LDX = PT;       // x block row stride
constexpr int LDS = BR + 16;  // score block row stride (no bank conflicts)
constexpr int MAX_N = 128;

struct Params {
  const void* x;
  const float* da;
  const void* b;
  const void* c;
  void* y;
  int bh_count, S, P, N, q;
  int np;   // N padded to a multiple of 16
  int qr;   // q padded to whole 64-row blocks
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

// Rows [j0, j0 + 64) of the chunk at row0 of a (S, N) operand into a 64 x ldn
// float block, zero past the chunk's q rows and past N.
template <typename T>
__device__ __forceinline__ void load_rows_n(const Params& p, const T* src,
                                            float* dst, int ldn, size_t row0,
                                            int j0) {
  for (int e = threadIdx.x; e < BR * p.np; e += THREADS) {
    int r = e / p.np, n = e % p.np;
    bool ok = j0 + r < p.q && n < p.N;
    dst[r * ldn + n] =
        ok ? to_f(src[(row0 + j0 + r) * static_cast<size_t>(p.N) + n]) : 0.f;
  }
}

// Rows [j0, j0 + 64) of x's chunk, columns [p0, p0 + 64), zero outside.
template <typename T>
__device__ __forceinline__ void load_rows_x(const Params& p, float* dst,
                                            size_t row0, int j0, int p0) {
  const T* x = static_cast<const T*>(p.x);
  for (int e = threadIdx.x; e < BR * PT; e += THREADS) {
    int r = e / PT, c = e % PT;
    bool ok = j0 + r < p.q && p0 + c < p.P;
    dst[r * LDX + c] =
        ok ? to_f(x[(row0 + j0 + r) * static_cast<size_t>(p.P) + p0 + c])
           : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = p.np + 1;
  float* Cs = smem;                   // 64 x ldn: a query block of C
  float* Bs = Cs + BR * ldn;          // 64 x ldn: a key block of B
  float* Xs = Bs + BR * ldn;          // 64 x 64: a key block of x
  float* Ss = Xs + BR * LDX;          // 64 x LDS: a score block
  float* St = Ss + BR * LDS;          // np x 64: the carried state
  float* cs = St + p.np * PT;         // qr: cumulative decays
  float* dte = cs + p.qr;             // qr: exp(cs_end - cs)

  const T* Bg = static_cast<const T*>(p.b);
  const T* Cg = static_cast<const T*>(p.c);
  T* yg = static_cast<T*>(p.y);
  const int bh = blockIdx.x, p0 = blockIdx.y * PT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % 16, ty = tid / 16;
  const int nb = p.qr / BR, nr = p.np / 16;

  for (int e = tid; e < p.np * PT; e += THREADS) St[e] = 0.f;

  const int nc = p.S / p.q;
  for (int ch = 0; ch < nc; ++ch) {
    const size_t row0 = static_cast<size_t>(bh) * p.S +
                        static_cast<size_t>(ch) * p.q;
    // cs = cumsum(da) over the chunk: each lane sums a run of
    // positions, a warp scan of the runs' totals gives their offsets
    if (warp == 0) {
      const int per = p.qr / 32;
      float run = 0.f;
      for (int e = 0; e < per; ++e) {
        int i = lane * per + e;
        run += i < p.q ? p.da[row0 + i] : 0.f;
        cs[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      for (int e = 0; e < per; ++e) cs[lane * per + e] += excl;
    }
    __syncthreads();
    const float cs_end = cs[p.q - 1];
    for (int i = tid; i < p.qr; i += THREADS)
      dte[i] = i < p.q ? expf(cs_end - cs[i]) : 0.f;

    // y of every query block, against the state as it entered the chunk
    for (int qb = 0; qb < nb; ++qb) {
      const int i0 = qb * BR;
      load_rows_n<T>(p, Cg, Cs, ldn, row0, i0);
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      // inter-chunk term: exp(cs_i) * (C_i · state)
#pragma unroll 4
      for (int n = 0; n < p.np; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * ldn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = St[n * PT + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += cv[r] * sv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int i = i0 + ty + 16 * r;
        float d = i < p.q ? expf(cs[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= d;
      }
      // intra-chunk term over the key blocks at or below this one
      for (int kb = 0; kb <= qb; ++kb) {
        const int j0 = kb * BR;
        load_rows_n<T>(p, Bg, Bs, ldn, row0, j0);
        load_rows_x<T>(p, Xs, row0, j0, p0);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
        for (int n = 0; n < p.np; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * ldn + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * ldn + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] += cv[r] * bv[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
            float l = (j <= i && i < p.q) ? expf(cs[i] - cs[j]) : 0.f;
            Ss[(ty + 16 * r) * LDS + tx + 16 * c] = s[r][c] * l;
          }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < BR; ++j) {
          float sv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = Ss[(ty + 16 * r) * LDS + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = Xs[j * LDX + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += sv[r] * xv[c];
        }
        __syncthreads();   // the next key block overwrites Bs, Xs, Ss
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int i = i0 + ty + 16 * r;
        if (i >= p.q) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int pc = p0 + tx + 16 * c;
          if (pc < p.P)
            yg[(row0 + i) * static_cast<size_t>(p.P) + pc] =
                from_f<T>(acc[r][c]);
        }
      }
    }

    // state <- exp(cs_end) * state + Bᵀ (exp(cs_end - cs) ⊙ x)
    float st[8][4];
    const float decay = expf(cs_end);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        st[r][c] = r < nr ? decay * St[(ty + 16 * r) * PT + tx + 16 * c]
                          : 0.f;
    for (int kb = 0; kb < nb; ++kb) {
      const int j0 = kb * BR;
      load_rows_n<T>(p, Bg, Bs, ldn, row0, j0);
      load_rows_x<T>(p, Xs, row0, j0, p0);
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < BR; ++j) {
        const float w = dte[j0 + j];
        float xv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = w * Xs[j * LDX + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r < nr) {
            float bv = Bs[j * ldn + ty + 16 * r];
#pragma unroll
            for (int c = 0; c < 4; ++c) st[r][c] += bv * xv[c];
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < nr)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          St[(ty + 16 * r) * PT + tx + 16 * c] = st[r][c];
    __syncthreads();   // the next chunk reads the state and rewrites cs
  }
}

template <typename T>
cudaError_t launch(const Params& p, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  ssd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point.  x (bh, S, P), b and c (bh, S, N), contiguous, in
// bfloat16 when `bf16`, else float32; da (bh, S) float32; y (bh, S, P) in
// x's type.  q is the chunk (S a multiple of it), N at most 128.  Returns
// cudaGetLastError() after the launch (a chunk whose cumulative decays do
// not fit shared memory beside the blocks is refused there).
extern "C" int ssd_chunk_scan_launch(const void* x, const void* da,
                                     const void* b, const void* c, void* y,
                                     int bh_count, int S, int P, int N,
                                     int q, int bf16, void* stream) {
  if (bh_count <= 0 || S <= 0 || P <= 0 || N <= 0 || N > MAX_N || q <= 0 ||
      S % q)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.da = static_cast<const float*>(da);
  p.b = b;
  p.c = c;
  p.y = y;
  p.bh_count = bh_count;
  p.S = S;
  p.P = P;
  p.N = N;
  p.q = q;
  p.np = (N + 15) / 16 * 16;
  p.qr = (q + BR - 1) / BR * BR;
  const size_t floats = 2 * static_cast<size_t>(BR) * (p.np + 1) +
                        BR * LDX + BR * LDS +
                        static_cast<size_t>(p.np) * PT + 2 * p.qr;
  const size_t smem = floats * sizeof(float);
  dim3 grid(bh_count, (P + PT - 1) / PT);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = bf16 ? launch<__nv_bfloat16>(p, grid, smem, st)
                       : launch<float>(p, grid, smem, st);
  return static_cast<int>(e);
}
