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
// Both designs skip a KV tile that shares no segment with the query tile,
// or whose every key lies causally after every query of the tile: such a
// tile contributes alpha = 1, p = 0, so the skip is exact.  Packing is
// contiguous by segment, so without it a tick of 8 chunks would do about
// 8x the admitted work.  Like the TPU kernel it takes any head_dim whose
// rows are whole 16-byte vectors (a multiple of 8 in bf16, of 4 in
// float32) up to 256, and any group.  Two designs, chosen by type alone
// (families/ragged_prefill.py `is_wgmma`):
//
//   * bf16 (ragged_wgmma_kernel): one CTA per (query head, 128 packed
//     queries): two consumer warpgroups of 64 rows and a producer
//     warpgroup, as flash_attention.cu's wgmma kernel.  A CTA of one head
//     serves every group size G without an instance per G, and the G
//     heads' CTAs re-read a KV head's tiles from L2 (2.6 MB a KV head at
//     qwen3's phase-3 shape).  Before it splits into roles the CTA
//     summarises its rows' metadata and, one warp per key tile, each
//     tile's (segment range, position range, padding), marks the live
//     tiles and, for each warpgroup, the tiles that admit every pair of its
//     64 rows (one segment, every key causally before every row), and
//     compacts the live tiles into a list: the walk visits only those.
//     The producer loads Q once and each live tile of K and V by TMA
//     (128-byte swizzle, zero fill past TQ and TK) into a two-stage ring;
//     each consumer computes S = Q·Kᵀ by wgmma m64nBKk16 (bf16 products
//     exact, float32 sums), masks from seg/pos staged in shared memory (a
//     wholly admitted tile skips the mask), runs the online softmax in
//     float32 (running max per key tile, exp2 with log2(e) in the
//     scale), and computes P·V on wgmma with p kept at float32 accuracy:
//     p = p_hi + p_lo with p_hi = bf16(p) and p_lo = bf16(p - p_hi), two
//     register-A products into one float32 accumulator, V (exact in bf16)
//     the MN-major shared-memory B; the residual is at most 2^-16 p (two
//     roundings of 2^-8) against the bf16 output's 2^-8, and l sums the
//     float32 p.  TF32 would run at half the rate on V that is already
//     exact in bf16, and p rounded to bf16 alone visibly perturbs logits
//     (the TPU kernel's docstring).  The tiles come in three widths, W =
//     64, 128 and 256 columns: head_dim D runs in the least W >= D, with
//     the tensor maps declared at D columns (rows of 2D bytes), so that
//     TMA's zero fill supplies columns D..W-1 in shared memory and the
//     HBM bytes stay those of D; S takes the 16-column k-steps that hold
//     real columns (at D = 8, 24, 40, ... the last of them half zeros),
//     P·V runs at N = W and its columns past D are not stored.  Key tiles
//     (BK) are 128 keys, 64 at W = 256, where Q (64 KB) and a two-stage
//     ring of 32 KB K and V tiles take 192 KB of the SM's 227: S on
//     m64n64k16, P·V on m64n256k16 into 128 float32 accumulators a
//     thread (the consumers' 232 registers of setmaxnreg).
//   * float32 (ragged_prefill_kernel): one CTA of 256 threads per (query
//     head, block of 64 packed queries) loops over blocks of 32 packed
//     keys, staging Q, K, V and the weights in shared memory (rows of W
//     columns, zero past D, padded by one word against bank conflicts;
//     137 KB at W = 256); each thread holds a 4 x 2 tile of scores and a
//     4 x W/16 tile of the accumulator (columns tx + 16 c, stored below D)
//     in registers, at three widths W = 64, 128, 256; S runs over the D
//     real columns and P·V over the accumulator columns that hold any;
//     the skip is decided from each block's [seg min, seg max] and pos
//     min, one block per thread, before any K/V is loaded; products are
//     float32 FMAs on the CUDA cores (67 TFLOP/s).
//
// Both designs are compiled twice a width: with D read at run time, and
// with D = W known at compile time (kFull), where the guards and strides
// of D fold away; the launch takes the second where D is the width.  The
// float32 design has no D = W instance at W = 64: ptxas trims it to 64
// registers with a spill, and the run-time instance serves D = 64.
#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;     // packed queries per CTA
constexpr int kBK = 32;     // packed keys per step
constexpr int kThreads = 256;
constexpr int kLP = kBK + 1;
constexpr float kNegInf = -1e30f;

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

template <int W>
constexpr int smem_floats() {
  return (kBQ + 2 * kBK) * (W + 1) + kBQ * kLP;
}

template <int W, bool kFull>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_kernel(const float* __restrict__ q,  // (Hq, TQ, D)
                      const float* __restrict__ k,  // (Hkv, TK, D)
                      const float* __restrict__ v,  // (Hkv, TK, D)
                      const int* __restrict__ seg_q,
                      const int* __restrict__ pos_q,
                      const int* __restrict__ seg_k,
                      const int* __restrict__ pos_k,
                      float* __restrict__ out,      // (Hq, TQ, D)
                      int Hq, int Hkv, int TQ, int TK, int D_,
                      float scale) {
  const int D = kFull ? W : D_;
  // rows of W columns, zero past D (they add nothing), padded by a word
  constexpr int LD = W + 1;
  constexpr int DC = W / 16;  // accumulator columns per thread
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

  for (int i = tid; i < kBQ * W; i += kThreads) {
    const int r = i / W, c = i % W, row = q0 + r;
    q_s[r * LD + c] =
        row < TQ && c < D ? q[((size_t)h * TQ + row) * D + c] : 0.f;
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
      for (int i = tid; i < kBK * W; i += kThreads) {
        const int r = i / W, c = i % W, col = k0 + r;
        const bool ok = col < TK && c < D;
        const size_t src = ((size_t)hk * TK + col) * D + c;
        k_s[r * LD + c] = ok ? k[src] : 0.f;
        v_s[r * LD + c] = ok ? v[src] : 0.f;
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
          if (16 * c >= D) break;    // columns wholly past D
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
        if (tx + 16 * c < D)
          out[((size_t)h * TQ + row) * D + tx + 16 * c] = acc[i][c] / l;
    }
  }
}

template <int W>
int launch(const void* q, const void* k, const void* v, const void* sq,
           const void* pq, const void* sk, const void* pk, void* out, int Hq,
           int Hkv, int TQ, int TK, int D, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<W>() * sizeof(float);
  auto kern = ragged_prefill_kernel<W, false>;
  if constexpr (W > 64)   // no D = W instance at 64 (the file's header)
    if (D == W) kern = ragged_prefill_kernel<W, true>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, (TQ + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)sq,
      (const int*)pq, (const int*)sk, (const int*)pk, (float*)out, Hq, Hkv,
      TQ, TK, D, scale);
  return (int)cudaGetLastError();
}

// -- bf16: wgmma fed by TMA, tiles of W columns ------------------------------

constexpr int kWgQ = 128;        // packed queries per CTA
constexpr int kWgK = 128;        // packed keys per TMA tile, at most
constexpr int kWgStages = 2;     // K/V ring depth
constexpr int kWgWarps = 12;     // three warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

template <int W>
struct WgCfg {
  // W = 256 halves the key tile: Q (64 KB) and a two-stage ring of 32 KB
  // K and V tiles fit one SM's shared memory
  static constexpr int kBK = W == 256 ? 64 : kWgK;  // packed keys per tile
  static constexpr int kPanels = W / 64;            // 64-column TMA boxes
  static constexpr int kQBytes = kWgQ * W * 2;
  static constexpr int kTileBytes = kBK * W * 2;    // one K (or V) tile
  // 1024 of alignment slack, Q, the ring and the mbarriers; then a flag
  // byte and a list entry (2 bytes) a key tile
  static constexpr int kFixed = 1024 + kQBytes + 2 * kWgStages * kTileBytes +
                                8 * (1 + 4 * kWgStages);
  static int smem(int n_tiles) {
    return kFixed + 2 * ((n_tiles + 1) / 2) + 2 * n_tiles;
  }
};

// min / max over a warp
__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Metadata summary of a set of tokens (a warp's rows, a key tile): the
// least segment with padding as -1 (so >= 0 iff no padding), the least and
// greatest real segment, the least and greatest position of a real token.
struct Summary {
  int min_raw, smin, smax, pmin, pmax;
};

__device__ __forceinline__ void summary_add(Summary& a, int s, int p) {
  a.min_raw = min(a.min_raw, s);
  if (s >= 0) {
    a.smin = min(a.smin, s);
    a.smax = max(a.smax, s);
    a.pmin = min(a.pmin, p);
    a.pmax = max(a.pmax, p);
  }
}
__device__ __forceinline__ Summary summary_empty() {
  return Summary{INT_MAX, INT_MAX, -1, INT_MAX, INT_MIN};
}
__device__ __forceinline__ Summary summary_merge(Summary a, const Summary& b) {
  a.min_raw = min(a.min_raw, b.min_raw);
  a.smin = min(a.smin, b.smin);
  a.smax = max(a.smax, b.smax);
  a.pmin = min(a.pmin, b.pmin);
  a.pmax = max(a.pmax, b.pmax);
  return a;
}
__device__ __forceinline__ Summary warp_summary(Summary a) {
  return Summary{warp_min(a.min_raw), warp_min(a.smin), warp_max(a.smax),
                 warp_min(a.pmin), warp_max(a.pmax)};
}

// a barrier of the 128 threads of consumer warpgroup wg (named barriers
// 1 and 2; __syncthreads uses 0)
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

template <int W, bool kFull>
__global__ void __launch_bounds__(384, 1)
ragged_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const int* __restrict__ seg_q,
                    const int* __restrict__ pos_q,
                    const int* __restrict__ seg_k,
                    const int* __restrict__ pos_k,
                    __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int TQ,
                    int TK, int D_, float scale) {
  using C = WgCfg<W>;
  const int D = kFull ? W : D_;
  constexpr int S = kWgStages, TB = C::kTileBytes, BK = C::kBK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_s = q_s + C::kQBytes;     // [stage][panel][BK][64]
  unsigned char* v_s = k_s + S * TB;         // [stage][panel][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + S * TB);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;
  const int n_tiles = (TK + BK - 1) / BK;
  unsigned char* flags = reinterpret_cast<unsigned char*>(v_empty + S);
  uint16_t* live = reinterpret_cast<uint16_t*>(flags + 2 * ((n_tiles + 1) / 2));
  __shared__ Summary row_sum[4];   // the 32-row slices of the query tile
  __shared__ int2 key_meta[2][kWgK];   // (seg, pos) of a masked tile's keys
  __shared__ int n_live_s;

  const int h = blockIdx.x, q0 = blockIdx.y * kWgQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the query rows' metadata, a summary per 32-row slice
  if (warp < 4) {
    const int row = q0 + tid;
    Summary a = summary_empty();
    summary_add(a, row < TQ ? seg_q[row] : -1, row < TQ ? pos_q[row] : 0);
    a = warp_summary(a);
    if (lane == 0) row_sum[warp] = a;
  }
  __syncthreads();
  const Summary wg_sum[2] = {summary_merge(row_sum[0], row_sum[1]),
                             summary_merge(row_sum[2], row_sum[3])};
  const Summary cta = summary_merge(wg_sum[0], wg_sum[1]);

  // 2. one warp per key tile: bit 0 of its flag marks a tile that may
  // admit a pair of the CTA's rows; bit 1 + w a tile that admits every
  // pair of warpgroup w's rows (one segment, no padding on either side,
  // every key causally at or before every row)
  for (int t = warp; t < n_tiles; t += kWgWarps) {
    Summary a = summary_empty();
#pragma unroll
    for (int i = 0; i < BK / 32; ++i) {
      const int key = t * BK + i * 32 + lane;
      summary_add(a, key < TK ? seg_k[key] : -1, key < TK ? pos_k[key] : 0);
    }
    a = warp_summary(a);
    if (lane == 0) {
      const bool lv = a.smax >= 0 && a.smax >= cta.smin &&
                      a.smin <= cta.smax && a.pmin <= cta.pmax;
      int f = lv ? 1 : 0;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const Summary& r = wg_sum[w];
        if (lv && a.min_raw >= 0 && a.smin == a.smax && r.min_raw >= 0 &&
            r.smin == r.smax && a.smin == r.smin && a.pmax <= r.pmin)
          f |= 2 << w;
      }
      flags[t] = static_cast<unsigned char>(f);
    }
  }
  __syncthreads();
  // 3. the live tiles, in order
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const int t = base + lane;
      const bool lv = t < n_tiles && (flags[t] & 1);
      const unsigned b = __ballot_sync(0xffffffffu, lv);
      if (lv) live[n + __popc(b & ((1u << lane) - 1))] = static_cast<uint16_t>(t);
      n += __popc(b);
    }
    if (lane == 0) n_live_s = n;
  }
  // a warpgroup none of whose rows is real takes no part in the walk
  const int n_active = int(wg_sum[0].smax >= 0) + int(wg_sum[1].smax >= 0);
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], n_active > 0 ? n_active : 1);
      hopper::mbar_init(&v_empty[s], n_active > 0 ? n_active : 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int n_live = n_active > 0 ? n_live_s : 0;

  const int wg = tid / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    hopper::reg_dealloc<kProducerRegs>();
    if (tid == 256 && n_live > 0) {
      hopper::mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int pn = 0; pn < C::kPanels; ++pn)
        hopper::tma_load_3d(q_s + pn * kWgQ * 128, &tm_q, pn * 64, q0, h,
                            q_full);
      for (int it = 0; it < n_live; ++it) {
        const int st = it % S, ph = (it / S) & 1;
        const int k0 = live[it] * BK;
        hopper::mbar_wait(&k_empty[st], ph ^ 1);
        hopper::mbar_expect_tx(&k_full[st], TB);
#pragma unroll
        for (int pn = 0; pn < C::kPanels; ++pn)
          hopper::tma_load_3d(k_s + st * TB + pn * BK * 128, &tm_k, pn * 64,
                              k0, hk, &k_full[st]);
        hopper::mbar_wait(&v_empty[st], ph ^ 1);
        hopper::mbar_expect_tx(&v_full[st], TB);
#pragma unroll
        for (int pn = 0; pn < C::kPanels; ++pn)
          hopper::tma_load_3d(v_s + st * TB + pn * BK * 128, &tm_v, pn * 64,
                              k0, hk, &v_full[st]);
      }
    }
    return;
  }

  // consumer warpgroup wg: packed queries [q0 + wg·64, q0 + wg·64 + 64)
  hopper::reg_alloc<kConsumerRegs>();
  const int ct = tid % 128, cw = ct / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int qrow_a = q0 + wg * 64 + cw * 16 + g, qrow_b = qrow_a + 8;
  const int sq_a = qrow_a < TQ ? seg_q[qrow_a] : -1;
  const int sq_b = qrow_b < TQ ? seg_q[qrow_b] : -1;
  const int pq_a = qrow_a < TQ ? pos_q[qrow_a] : 0;
  const int pq_b = qrow_b < TQ ? pos_q[qrow_b] : 0;
  const float sl2 = scale * kLog2e;
  const unsigned char* q_wg = q_s + wg * 64 * 128;
  const int whole = 2 << wg;

  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  // running max in log2 units; l is this thread's share of its rows' sum
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const int n_walk = (wg == 0 ? wg_sum[0] : wg_sum[1]).smax >= 0 ? n_live : 0;
  if (n_walk > 0) hopper::mbar_wait(q_full, 0);

  for (int it = 0; it < n_walk; ++it) {
    const int st = it % S, ph = (it / S) & 1;
    const int tile = live[it], k0 = tile * BK;
    const unsigned char* kt_s = k_s + st * TB;
    const unsigned char* vt_s = v_s + st * TB;

    // S = Q Kᵀ, 64 rows x BK keys, over the 16-column k-steps that hold
    // real columns (zeros past D)
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    hopper::mbar_wait(&k_full[st], ph);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      if (kk * 16 >= D) break;
      const int pn = kk / 4, off = (kk % 4) * 32;
      const uint64_t dq =
          hopper::desc_sw128(q_wg + pn * kWgQ * 128 + off, 16, 1024);
      const uint64_t dk =
          hopper::desc_sw128(kt_s + pn * BK * 128 + off, 16, 1024);
      if constexpr (BK == 128)
        hopper::wgmma_m64n128k16_ss(s, dq, dk, 1);
      else
        hopper::wgmma_m64n64k16_ss(s, dq, dk, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(s);
    if (ct == 0) hopper::mbar_arrive(&k_empty[st]);   // K of this stage read

    // online softmax in log2 units, s becoming p
    float mx_a = kNegInf, mx_b = kNegInf, sum_a = 0.f, sum_b = 0.f;
    float al_a, al_b;
    if (flags[tile] & whole) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a) * sl2);
      const float mn_b = fmaxf(m_b, quad_max(mx_b) * sl2);
      al_a = exp2f(m_a - mn_a);
      al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[4 * j] = exp2f(fmaf(s[4 * j], sl2, -mn_a));
        s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl2, -mn_a));
        s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl2, -mn_b));
        s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl2, -mn_b));
        sum_a += s[4 * j] + s[4 * j + 1];
        sum_b += s[4 * j + 2] + s[4 * j + 3];
      }
    } else {
      // the tile's key metadata, staged in shared memory by the warpgroup
      // (a key a thread); the first barrier waits for the readers of the
      // previous masked tile
      int2* meta = key_meta[wg];
      wg_barrier(wg);
      if (ct < BK)
        meta[ct] = k0 + ct < TK ? make_int2(seg_k[k0 + ct], pos_k[k0 + ct])
                                : make_int2(-1, 0);
      wg_barrier(wg);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int2 km = meta[j * 8 + 2 * t4 + e];
          const int sk = km.x, pk = km.y;
          float xa = s[4 * j + e] * sl2, xb = s[4 * j + 2 + e] * sl2;
          if (!(sq_a >= 0 && sk == sq_a && pk <= pq_a)) xa = kNegInf;
          if (!(sq_b >= 0 && sk == sq_b && pk <= pq_b)) xb = kNegInf;
          s[4 * j + e] = xa;
          s[4 * j + 2 + e] = xb;
          mx_a = fmaxf(mx_a, xa);
          mx_b = fmaxf(mx_b, xb);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      al_a = exp2f(m_a - mn_a);
      al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e];
          // a masked score gets an explicit zero weight
          const float pe =
              x == kNegInf ? 0.f : exp2f(x - (e < 2 ? mn_a : mn_b));
          s[4 * j + e] = pe;
          if (e < 2) sum_a += pe; else sum_b += pe;
        }
      }
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }

    // P split into two bf16 register A operands: k-step kk holds keys
    // [16kk, 16kk + 16)
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        hopper::split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1],
                           p_hi[kk][r], p_lo[kk][r]);

    // O += P_hi V + P_lo V
    hopper::mbar_wait(&v_full[st], ph);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = hopper::desc_sw128(vt_s + kk * 2048, BK * 128, 1024);
      if constexpr (W == 256) {
        hopper::wgmma_m64n256k16_rs_tb(o, p_hi[kk], dv, 1);
        hopper::wgmma_m64n256k16_rs_tb(o, p_lo[kk], dv, 1);
      } else if constexpr (W == 128) {
        hopper::wgmma_m64n128k16_rs_tb(o, p_hi[kk], dv, 1);
        hopper::wgmma_m64n128k16_rs_tb(o, p_lo[kk], dv, 1);
      } else {
        hopper::wgmma_m64n64k16_rs_tb(o, p_hi[kk], dv, 1);
        hopper::wgmma_m64n64k16_rs_tb(o, p_lo[kk], dv, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
    if (ct == 0) hopper::mbar_arrive(&v_empty[st]);   // V of this stage read
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    if (j * 8 >= D) break;            // the real columns only
    const int col = j * 8 + 2 * t4;
    if (qrow_a < TQ)
      *reinterpret_cast<uint32_t*>(out + ((size_t)h * TQ + qrow_a) * D + col) =
          hopper::pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (qrow_b < TQ)
      *reinterpret_cast<uint32_t*>(out + ((size_t)h * TQ + qrow_b) * D + col) =
          hopper::pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

template <int W>
int launch_wgmma(const void* q, const void* k, const void* v, const void* sq,
                 const void* pq, const void* sk, const void* pk, void* out,
                 int Hq, int Hkv, int TQ, int TK, int D, float scale,
                 cudaStream_t stream) {
  using C = WgCfg<W>;
  CUtensorMap tq, tk, tv;
  int e = hopper::encode_tensor_map_3d(&tq, q, D, TQ, Hq, kWgQ);
  if (!e) e = hopper::encode_tensor_map_3d(&tk, k, D, TK, Hkv, C::kBK);
  if (!e) e = hopper::encode_tensor_map_3d(&tv, v, D, TK, Hkv, C::kBK);
  if (e) return e;
  const int n_tiles = (TK + C::kBK - 1) / C::kBK;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const int smem = C::smem(n_tiles);
  auto kern = D == W ? ragged_wgmma_kernel<W, true>
                     : ragged_wgmma_kernel<W, false>;
  cudaError_t r = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (r != cudaSuccess) return (int)r;
  const dim3 grid(Hq, (TQ + kWgQ - 1) / kWgQ);
  kern<<<grid, 384, smem, stream>>>(
      tq, tk, tv, (const int*)sq, (const int*)pq, (const int*)sk,
      (const int*)pk, (__nv_bfloat16*)out, Hq, Hkv, TQ, TK, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (Hq, TQ, D), k/v (Hkv, TK, D), seg_q/pos_q (TQ,) int32, seg_k/pos_k
// (TK,) int32, out (Hq, TQ, D); all contiguous on one device, q, k, v and
// out of one type (is_bf16: bfloat16, else float32); D up to 256, a
// multiple of 8 in bf16 (the wgmma design; q, k, v 16-byte aligned) and of
// 4 in float32 (the CUDA-core one).  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int ragged_prefill_launch(const void* q, const void* k,
                                     const void* v, const void* seg_q,
                                     const void* pos_q, const void* seg_k,
                                     const void* pos_k, void* out, int Hq,
                                     int Hkv, int TQ, int TK, int D,
                                     float scale, int is_bf16, void* stream) {
  if (Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || TQ <= 0 || TK <= 0 || D <= 0 ||
      D > 256 || D % (is_bf16 ? 8 : 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (D <= 64)
      return launch_wgmma<64>(q, k, v, seg_q, pos_q, seg_k, pos_k, out, Hq,
                              Hkv, TQ, TK, D, scale, s);
    if (D <= 128)
      return launch_wgmma<128>(q, k, v, seg_q, pos_q, seg_k, pos_k, out, Hq,
                               Hkv, TQ, TK, D, scale, s);
    return launch_wgmma<256>(q, k, v, seg_q, pos_q, seg_k, pos_k, out, Hq,
                             Hkv, TQ, TK, D, scale, s);
  }
  if (D <= 64)
    return launch<64>(q, k, v, seg_q, pos_q, seg_k, pos_k, out, Hq, Hkv, TQ,
                      TK, D, scale, s);
  if (D <= 128)
    return launch<128>(q, k, v, seg_q, pos_q, seg_k, pos_k, out, Hq, Hkv,
                       TQ, TK, D, scale, s);
  return launch<256>(q, k, v, seg_q, pos_q, seg_k, pos_k, out, Hq, Hkv, TQ,
                     TK, D, scale, s);
}
