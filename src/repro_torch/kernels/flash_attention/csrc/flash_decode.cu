// Split-KV flash decode for Hopper (sm_90a), plain C entry point.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/decode.py (`flash_decode`, body
// `_decode_kernel`): one query token per (batch row, query head),
// q (B, Hq, 1, D), against a dense cache k, v (B, Hkv, S, D) of which the
// first kv_len positions are valid (one length shared by every row, read
// from a device int32 so the host never waits).  The cache is cut into
// kv_splits spans of S / kv_splits positions; each span writes float32
// partials o (B·Hq, ns, D), m and l (B·Hq, ns, 1): its running max, its sum
// of exp(s - m), and its unnormalised sum of p·v.  p is cast to v's type
// before P·V, as the TPU kernel does, and l sums the float32 p.  A span
// with no valid position writes m = -1e30, l = 0, o = 0, as the TPU kernel
// does.  The log-sum-exp combine of the partials runs after this kernel,
// as plain tensor ops (in JAX it is an XLA epilogue outside the kernel).
//
// Design.  One CTA of 128 threads per (span, KV head, batch row) serves
// the G = Hq / Hkv query heads of that KV head, so each K/V element of the
// span is read once, where the TPU grid (B·Hq, ns) reads it G times.  The
// CTA walks its span in 16 KB tiles of K and of V (64 positions in bf16 at
// D = 128, 32 in f32), staged in shared memory with all of a thread's
// 16-byte loads in flight before any store, and stops at kv_len (a tile
// past it would give alpha = 1 and p = 0: skipping is exact).  Scores: each
// warp takes whole positions, lanes split D; softmax: one warp per query
// head; P·V: one thread per output column, all G accumulators in
// registers.  Products are FMAs on the CUDA cores: G rows of one token do
// not fill a tensor-core tile.
//
// The running max is updated once per tile, where the TPU kernel takes the
// max of its whole span at once: m and l agree to f32 rounding, and a bf16
// p rounded against an earlier max moves o by a fraction of a bf16 step.
//
// What bounds it on the H100: memory.  It reads the valid part of the
// cache once, 2·B·Hkv·kv_len·D·sizeof(T) bytes (134 MB at the family's
// production problem, 0.040 ms at 3.35 TB/s), and does 4·G·D operations
// per position, far below the card's ~295 operations per byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;           // query heads per KV head
constexpr int kTileBytes = 16384;  // one K (or V) tile per step
constexpr int kMaxStep = 64;       // positions per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// p.astype(v.dtype), back in float32 for the FMA
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
flash_decode_kernel(const T* __restrict__ q,        // (B, Hq, D)
                    const T* __restrict__ k,        // (B, Hkv, S, D)
                    const T* __restrict__ v,        // (B, Hkv, S, D)
                    const int* __restrict__ kv_len,  // () int32
                    float* __restrict__ o_part,     // (B·Hq, ns, D)
                    float* __restrict__ m_part,     // (B·Hq, ns)
                    float* __restrict__ l_part,     // (B·Hq, ns)
                    int Hq, int Hkv, int S, int ns, float scale) {
  using TL = Tile<T, D>;
  constexpr int TT = TL::kTokens;
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = S / ns;

  __shared__ __align__(16) T k_s[TT * D];
  __shared__ __align__(16) T v_s[TT * D];
  __shared__ float q_s[kMaxG][D];
  __shared__ float w_s[kMaxG][TT];  // scores, then weights
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[g][d] = to_f32(q[((size_t)b * Hq + hk * G + g) * D + d]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int len = max(0, min(*kv_len, S));
  const int p_begin = s * span;
  const int p_end = min(p_begin + span, len);  // valid positions of the span
  const T* k_head = k + ((size_t)b * Hkv + hk) * S * D;
  const T* v_head = v + ((size_t)b * Hkv + hk) * S * D;

  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  for (int pos0 = p_begin; pos0 < p_end; pos0 += TT) {
    const int nt = min(TT, p_end - pos0);  // positions this step
    __syncthreads();  // the previous step's readers of the tiles are done

    // stage K and V: every load of this thread in flight before any store
    uint4 kb[TL::kPerThread], vb[TL::kPerThread];
#pragma unroll
    for (int i = 0; i < TL::kPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c < TL::kChunks && c / TL::kChunksPerRow < nt) {
        const size_t off = (size_t)pos0 * D + (size_t)c * TL::kVec;
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

    // acc[g][d] = acc * alpha + sum_t round(p[g][t]) * v[t][d]
    // (D <= kThreads: thread d owns output column d of every head)
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= alpha_s[g];
      for (int t = 0; t < nt; ++t) {
        const float vv = to_f32(v_s[t * D + tid]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(round_to(w_s[g][t], T()), vv, acc[g]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const size_t row = ((size_t)b * Hq + hk * G + g) * ns + s;
      if (tid < D) o_part[row * D + tid] = acc[g];
      if (tid == 0) {
        m_part[row] = m_s[g];
        l_part[row] = l_s[g];
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* o, void* m, void* l, int B, int Hq, int Hkv, int S, int ns,
           float scale, cudaStream_t st) {
  const dim3 grid(ns, Hkv, B);
  flash_decode_kernel<T, D><<<grid, kThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)kv_len, (float*)o,
      (float*)m, (float*)l, Hq, Hkv, S, ns, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* kv_len, void* o, void* m, void* l, int B, int Hq,
             int Hkv, int S, int ns, float scale, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, kv_len, o, m, l, B, Hq, Hkv, S, ns, scale, st);
    case 128: return launch<T, 128>(q, k, v, kv_len, o, m, l, B, Hq, Hkv, S, ns, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, 1, D), k/v (B, Hkv, S, D), kv_len () int32, all on one device,
// contiguous and 16-byte aligned, q/k/v all bf16 (is_bf16) or all f32;
// D in {64, 128}; Hq / Hkv <= 8; kv_splits divides S.  Writes float32
// partials o (B·Hq, ns, D), m (B·Hq, ns), l (B·Hq, ns).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* kv_len,
                                   void* o_part, void* m_part, void* l_part,
                                   int B, int Hq, int Hkv, int S, int D,
                                   int kv_splits, float scale, int is_bf16,
                                   void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || S <= 0 ||
      kv_splits <= 0 || S % kv_splits != 0 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, kv_len, o_part, m_part,
                                   l_part, B, Hq, Hkv, S, kv_splits, scale,
                                   st);
  return launch_d<float>(D, q, k, v, kv_len, o_part, m_part, l_part, B, Hq,
                         Hkv, S, kv_splits, scale, st);
}
