// Ragged (packed variable-length) prefill attention for Hopper (sm_90a),
// plain C entry point.
//
// Replaces the TPU kernel src/repro/kernels/ragged_prefill/ragged_prefill.py
// (`ragged_prefill`, body `_ragged_kernel`): queries q (Hq, TQ, D) and keys /
// values k, v (Hkv, TK, D) at packed offsets, with per-token metadata seg
// (owning sequence, -1 on padding) and pos (position in the sequence).  A
// pair is admitted iff seg_q == seg_k, pos_k <= pos_q and both segs >= 0;
// the mask is applied before the online softmax, whose (m, l, acc) carry is
// float32, with float32 weights and V cast up.  Query head h reads KV head
// h / G.  Fully masked rows (padding queries) write zeros.
//
// What bounds it on the H100: it does 4 * D flops per admitted (query head,
// key) pair, against reading q, k, v once; at the serving path's shapes (8
// chunks of 256 queries against their prefixes) that is about 200 flops per
// byte in bfloat16, just under the card's ~295 at the bf16 tensor-core
// peak, so the least time is set by bytes, with operations close behind.
// This design does its products as float32 FMAs on the CUDA cores (67
// TFLOP/s, see below), so for it operations are the limit.  The design:
//   * one CTA of 256 threads per (query head, block of 64 packed queries)
//     loops over blocks of 32 packed keys, staging Q, K, V and the weights in
//     shared memory as float32 (rows padded by one word against bank
//     conflicts); each thread holds a 4 x 2 tile of scores and a 4 x D/16
//     tile of the accumulator in registers;
//   * a KV block is skipped when it shares no segment with the query block,
//     or when every key in it lies causally after every query of the block.
//     Such a block contributes alpha = 1, p = 0, so the skip is exact.  The
//     CTA decides it from each block's [seg min, seg max] and pos min, one
//     block per thread, 256 blocks per pass, before it loads any K/V.
//     Packing is contiguous by segment, so without the skip a tick of 8
//     chunks would do about 8x the admitted work;
//   * products run on the CUDA cores in float32 (fmaf): P·V must stay
//     float32 (the reference keeps p in float32), which the tensor cores
//     offer only as TF32.  wgmma, TMA and warp specialisation are for later
//     PRs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kBQ = 64;     // packed queries per CTA
constexpr int kBK = 32;     // packed keys per step
constexpr int kThreads = 256;
constexpr int kLP = kBK + 1;
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

// reductions over the 16 lanes that share one row group (xor < 16 stays in
// the half-warp)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr int smem_floats() {
  return (kBQ + 2 * kBK) * (D + 1) + kBQ * kLP;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_kernel(const T* __restrict__ q,  // (Hq, TQ, D)
                      const T* __restrict__ k,  // (Hkv, TK, D)
                      const T* __restrict__ v,  // (Hkv, TK, D)
                      const int* __restrict__ seg_q,
                      const int* __restrict__ pos_q,
                      const int* __restrict__ seg_k,
                      const int* __restrict__ pos_k,
                      T* __restrict__ out,      // (Hq, TQ, D)
                      int Hq, int Hkv, int TQ, int TK, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // kBQ x LD
  float* k_s = q_s + kBQ * LD;     // kBK x LD
  float* v_s = k_s + kBK * LD;     // kBK x LD
  float* p_s = v_s + kBK * LD;     // kBQ x kLP
  __shared__ int sq_s[kBQ], pq_s[kBQ], sk_s[kBK], pk_s[kBK];
  __shared__ int qmeta[3];
  __shared__ bool active_s[kThreads];

  const int h = blockIdx.x, q0 = blockIdx.y * kBQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    q_s[r * LD + c] =
        row < TQ ? to_f32(q[((size_t)h * TQ + row) * D + c]) : 0.f;
  }
  if (tid < kBQ) {
    const int row = q0 + tid;
    sq_s[tid] = row < TQ ? seg_q[row] : -1;
    pq_s[tid] = row < TQ ? pos_q[row] : 0;
  }
  __syncthreads();
  if (tid < 32) {  // the query block's segment range and last position
    int smin = INT_MAX, smax = -1, pmax = INT_MIN;
    for (int r = tid; r < kBQ; r += 32) {
      if (sq_s[r] >= 0) {
        smin = min(smin, sq_s[r]);
        smax = max(smax, sq_s[r]);
        pmax = max(pmax, pq_s[r]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, o));
      smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, o));
      pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
    }
    if (tid == 0) {
      qmeta[0] = smin;
      qmeta[1] = smax;
      qmeta[2] = pmax;
    }
  }
  __syncthreads();
  const int q_smin = qmeta[0], q_smax = qmeta[1], q_pmax = qmeta[2];

  float m_r[4], l_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nkb = (TK + kBK - 1) / kBK;
  for (int g0 = 0; q_smax >= 0 && g0 < nkb; g0 += kThreads) {
    // which of the next kThreads KV blocks can admit any pair
    bool act = false;
    const int kb = g0 + tid;
    if (kb < nkb) {
      int smin = INT_MAX, smax = -1, pmin = INT_MAX;
      const int c1 = min(TK, (kb + 1) * kBK);
      for (int c = kb * kBK; c < c1; ++c) {
        const int s = seg_k[c];
        if (s >= 0) {
          smin = min(smin, s);
          smax = max(smax, s);
          pmin = min(pmin, pos_k[c]);
        }
      }
      act = smax >= 0 && smax >= q_smin && smin <= q_smax && pmin <= q_pmax;
    }
    __syncthreads();  // the previous pass's readers of active_s are done
    active_s[tid] = act;
    __syncthreads();

    for (int j = 0; j < kThreads && g0 + j < nkb; ++j) {
      if (!active_s[j]) continue;
      const int k0 = (g0 + j) * kBK;
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int r = i / D, c = i % D, col = k0 + r;
        const size_t src = ((size_t)hk * TK + col) * D + c;
        k_s[r * LD + c] = col < TK ? to_f32(k[src]) : 0.f;
        v_s[r * LD + c] = col < TK ? to_f32(v[src]) : 0.f;
      }
      if (tid < kBK) {
        const int col = k0 + tid;
        sk_s[tid] = col < TK ? seg_k[col] : -1;
        pk_s[tid] = col < TK ? pos_k[col] : 0;
      }
      __syncthreads();

      // scores for rows ty*4+i, columns tx and tx+16
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float k0v = k_s[tx * LD + d], k1v = k_s[(tx + 16) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qv = q_s[(ty * 4 + i) * LD + d];
          s[i][0] = fmaf(qv, k0v, s[i][0]);
          s[i][1] = fmaf(qv, k1v, s[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, sq = sq_s[r], pq = pq_s[r];
        bool ok[2];
        float mx = kNegInf;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = tx + 16 * jj, sk = sk_s[c];
          ok[jj] = sq >= 0 && sk >= 0 && sq == sk && pk_s[c] <= pq;
          s[i][jj] = ok[jj] ? s[i][jj] * scale : kNegInf;
          mx = fmaxf(mx, s[i][jj]);
        }
        const float m_new = fmaxf(m_r[i], half_warp_max(mx));
        const float alpha = expf(m_r[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
          p_s[r * kLP + tx + 16 * jj] = p;
          sum += p;
        }
        l_r[i] = l_r[i] * alpha + half_warp_sum(sum);
        m_r[i] = m_new;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      }
      __syncthreads();

#pragma unroll 4
      for (int t = 0; t < kBK; ++t) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = p_s[(ty * 4 + i) * kLP + t];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float vv = v_s[t * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
      __syncthreads();  // before the next block overwrites k_s, v_s, p_s
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < TQ) {
      const float l = l_r[i] == 0.f ? 1.f : l_r[i];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        out[((size_t)h * TQ + row) * D + tx + 16 * c] =
            from_f32<T>(acc[i][c] / l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* sq,
           const void* pq, const void* sk, const void* pk, void* out, int Hq,
           int Hkv, int TQ, int TK, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = ragged_prefill_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, (TQ + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)sq, (const int*)pq,
      (const int*)sk, (const int*)pk, (T*)out, Hq, Hkv, TQ, TK, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* sq, const void* pq, const void* sk, const void* pk,
             void* out, int Hq, int Hkv, int TQ, int TK, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, sq, pq, sk, pk, out, Hq, Hkv, TQ, TK, scale, s);
    case 32: return launch<T, 32>(q, k, v, sq, pq, sk, pk, out, Hq, Hkv, TQ, TK, scale, s);
    case 64: return launch<T, 64>(q, k, v, sq, pq, sk, pk, out, Hq, Hkv, TQ, TK, scale, s);
    case 128: return launch<T, 128>(q, k, v, sq, pq, sk, pk, out, Hq, Hkv, TQ, TK, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (Hq, TQ, D), k/v (Hkv, TK, D), seg_q/pos_q (TQ,) int32, seg_k/pos_k
// (TK,) int32, out (Hq, TQ, D); all contiguous on one device, q, k, v and
// out of one type (is_bf16: bfloat16, else float32); D in {16, 32, 64, 128}.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ragged_prefill_launch(const void* q, const void* k,
                                     const void* v, const void* seg_q,
                                     const void* pos_q, const void* seg_k,
                                     const void* pos_k, void* out, int Hq,
                                     int Hkv, int TQ, int TK, int D,
                                     float scale, int is_bf16, void* stream) {
  if (Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || TQ <= 0 || TK <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, seg_q, pos_q, seg_k, pos_k,
                                   out, Hq, Hkv, TQ, TK, scale, s);
  return launch_d<float>(D, q, k, v, seg_q, pos_q, seg_k, pos_k, out, Hq,
                         Hkv, TQ, TK, scale, s);
}
