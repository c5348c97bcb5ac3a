// Paged-attention decode for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/paged_attention.py
// (`paged_decode`, body `_decode_kernel`): single-token GQA decode over a
// block-table KV pool, masked by each sequence's length, online softmax with
// a float32 (m, l, acc) carry, weights kept in float32 and V cast up.
//
// What bounds it on the H100: memory.  Each sequence reads the K/V of the
// tokens its length covers, sum_b len_b * Hkv * D * 2 * sizeof(T) bytes, and
// does 4 * Hq * D flops per token — about G flops per byte, far below the
// card's ~295 flops per byte.  The design therefore reads every K/V element
// once per KV head, not once per query head, and keeps many loads in flight:
//   * one CTA per (sequence b, KV head hk) serves the G = Hq / Hkv query
//     heads that share that KV head;
//   * the CTA loads its own row of the block table and its length (the TPU
//     kernel had them scalar-prefetched) and walks the pages in order,
//     pages_per_step pages of K and of V per step in tiles of at most
//     16 KB (64 tokens in bfloat16, 32 in float32), never touching a page
//     beyond the length (such a page contributes alpha = 1, p = 0 in the
//     reference: skipping is exact), so the null page and foreign pages
//     are never read.  The wrapper passes as many pages as fit one tile;
//     the last step is shorter where that count does not divide the
//     table width (the ARGUS gate verifies the program whose steps these
//     are made of: core/families/paged_attention.py);
//   * each step stages the K and V tiles in shared memory with 16-byte
//     loads, all of a thread's loads issued before any is stored, so one
//     memory latency is paid per step, not one per token;
//   * scores: each warp takes whole tokens, lanes split D, one warp
//     reduction per query head; softmax: one warp per query head; P·V: one
//     thread per output column, all G accumulators in registers.
// Positions at or beyond the length get -1e30 and an explicit zero weight
// (-1e30 is finite: exp(s - m) of a fully masked block would be 1, not 0).
// A row of length zero writes zeros.  The output is rounded to T once, from
// the float32 result (round to nearest even, as torch's .to()).
// Not yet done (later PRs): splitting long sequences across CTAs to fill all
// 132 SMs at small batch, double-buffered TMA loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;          // query heads per KV head
constexpr int kTileBytes = 16384;  // one K (or V) tile per step
constexpr int kMaxStep = 64;      // tokens per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

template <typename T, int D>
struct Tile {
  static constexpr int kTokens =
      kTileBytes / (D * (int)sizeof(T)) < kMaxStep
          ? kTileBytes / (D * (int)sizeof(T))
          : kMaxStep;
  static constexpr int kVec = 16 / (int)sizeof(T);    // elements per 16 B
  static constexpr int kChunksPerRow = D / kVec;
  static constexpr int kChunks = kTokens * kChunksPerRow;
  static constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,        // (B, Hq, D)
                    const T* __restrict__ k_pages,  // (P, Hkv, PS, D)
                    const T* __restrict__ v_pages,  // (P, Hkv, PS, D)
                    const int* __restrict__ table,  // (B, NP)
                    const int* __restrict__ lengths,  // (B,)
                    T* __restrict__ out,            // (B, Hq, D)
                    int Hq, int Hkv, int PS, int NP, int pages_per_step,
                    float scale) {
  using TL = Tile<T, D>;
  constexpr int TT = TL::kTokens;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ __align__(16) T k_s[TT * D];
  __shared__ __align__(16) T v_s[TT * D];
  __shared__ float q_s[kMaxG][D];
  __shared__ float w_s[kMaxG][TT];  // scores, then weights
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  __shared__ int phys_s[TT];

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[g][d] = to_f32(q[((size_t)b * Hq + hk * G + g) * D + d]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int len = max(0, min(lengths[b], NP * PS));
  const int n_pages = (len + PS - 1) / PS;
  const size_t page_stride = (size_t)Hkv * PS * D;
  const T* k_head = k_pages + (size_t)hk * PS * D;
  const T* v_head = v_pages + (size_t)hk * PS * D;

  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  for (int p0 = 0; p0 < n_pages; p0 += pages_per_step) {
    const int np_step = min(pages_per_step, n_pages - p0);
    const int nt = np_step * PS;  // tokens this step (<= TT)
    const int pos0 = p0 * PS;
    __syncthreads();  // the previous step's readers of the tiles are done
    if (tid < np_step) phys_s[tid] = table[(size_t)b * NP + p0 + tid];
    __syncthreads();

    // stage K and V: every load of this thread in flight before any store
    uint4 kb[TL::kPerThread], vb[TL::kPerThread];
#pragma unroll
    for (int i = 0; i < TL::kPerThread; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / TL::kChunksPerRow;
      if (c < TL::kChunks && row < nt) {
        const size_t off = (size_t)phys_s[row / PS] * page_stride +
                           (size_t)(row % PS) * D +
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

    // scores s[g][t] = (q_g . k_t) * scale, -1e30 beyond the length
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
      const bool valid = pos0 + t < len;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float s = warp_sum(part[g]);
          if (lane == 0) w_s[g][t] = valid ? s * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      const int t0 = lane, t1 = lane + 32;
      const bool v0 = t0 < nt && pos0 + t0 < len;
      const bool v1 = t1 < nt && pos0 + t1 < len;
      const float s0 = t0 < nt ? w_s[g][t0] : kNegInf;
      const float s1 = t1 < nt ? w_s[g][t1] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_prev - m_new);
      const float e0 = v0 ? expf(s0 - m_new) : 0.f;
      const float e1 = v1 ? expf(s1 - m_new) : 0.f;
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
    // (D <= kThreads: thread d owns output column d of every head)
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= alpha_s[g];
      for (int t = 0; t < nt; ++t) {
        const float vv = to_f32(v_s[t * D + tid]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(w_s[g][t], vv, acc[g]);
      }
    }
  }
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float l = l_s[g];
        out[((size_t)b * Hq + hk * G + g) * D + tid] =
            from_f32<T>(acc[g] / (l == 0.f ? 1.f : l));
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lengths, void* out, int B, int Hq, int Hkv, int PS,
           int NP, int step, float scale, cudaStream_t s) {
  if (step * PS > Tile<T, D>::kTokens) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  paged_decode_kernel<T, D><<<grid, kThreads, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)table,
      (const int*)lengths, (T*)out, Hq, Hkv, PS, NP, step, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* table, const void* lengths, void* out, int B,
             int Hq, int Hkv, int PS, int NP, int step, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, table, lengths, out, B, Hq, Hkv, PS, NP, step, scale, s);
    case 32: return launch<T, 32>(q, k, v, table, lengths, out, B, Hq, Hkv, PS, NP, step, scale, s);
    case 64: return launch<T, 64>(q, k, v, table, lengths, out, B, Hq, Hkv, PS, NP, step, scale, s);
    case 128: return launch<T, 128>(q, k, v, table, lengths, out, B, Hq, Hkv, PS, NP, step, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, 1, D), k/v pools (P, Hkv, PS, D), table (B, NP) int32, lengths
// (B,) int32, out (B, Hq, 1, D); all contiguous on one device and 16-byte
// aligned, q, pools and out of one type (is_bf16: bfloat16, else float32);
// D in {16, 32, 64, 128}; pages_per_step pages of PS tokens at most one
// tile (64 tokens in bfloat16 at D = 128, 32 in float32).
// Returns the CUDA error code of the launch.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, void* out, int B,
                                   int Hq, int Hkv, int D, int PS, int NP,
                                   int pages_per_step, float scale,
                                   int is_bf16, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || PS <= 0 ||
      NP <= 0 || pages_per_step <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k_pages, v_pages, table, lengths,
                                   out, B, Hq, Hkv, PS, NP, pages_per_step,
                                   scale, s);
  return launch_d<float>(D, q, k_pages, v_pages, table, lengths, out, B, Hq,
                         Hkv, PS, NP, pages_per_step, scale, s);
}
