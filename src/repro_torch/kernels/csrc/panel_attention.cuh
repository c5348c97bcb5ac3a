// The panel route of the four attention kernels (flash_attention.cu,
// ragged_prefill.cu, flash_decode.cu, paged_decode.cu): the head dims their
// TMA and 16-byte-vector instances cannot take.  Those instances need rows
// of whole 16-byte vectors (TMA's global strides are multiples of 16 bytes,
// and so are cp.async's 16-byte copies) and at most 256 columns (wgmma's
// widest N, TMA's widest box, and an O accumulator that fits the
// registers).  Here:
//
//   * rows are staged into shared memory with the widest copy every row
//     allows (copy_grain: 16-, 8- or 4-byte cp.async, or 2-byte loads for an
//     odd bf16 head_dim), zero-filled past head_dim and past the valid rows,
//     in padded row-major tiles the compute reads with ldmatrix (bf16) or
//     scalar loads (float32);
//   * S is accumulated over the whole head_dim in 64-column chunks: a chunk
//     of Q (or of the head block's queries) and of K is staged, its 16-deep
//     k-steps are issued, and the next chunk replaces it, so no tile grows
//     with head_dim;
//   * the output columns are cut into panels of PW <= 256 columns, one grid
//     index a panel: each CTA recomputes S for its panel and keeps only the
//     panel's accumulator (PW/8 x 4 float32 a thread in the prefill, PW/16
//     x 4 in the decode);
//   * bf16 products run on mma.sync.m16n8k16 (float32 accumulators), float32
//     products as FMAs on the CUDA cores, as in the on-grain instances; p is
//     rounded to bf16 (flash kernels: the TPU kernels' p.astype(v.dtype)) or
//     kept at float32 accuracy as p_hi + p_lo (serving kernels).
//
// What it costs: each panel past the first reads Q and K again (from L2)
// and repeats S; a 2-byte grain issues eight times the copies of a 16-byte
// one.  The route is right first; its times stand in PERF.md.
#pragma once

#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace panel {

constexpr int kChunk = 64;           // columns of D a staged chunk of Q / K
constexpr int kLdc = kChunk + 8;     // its bf16 row stride: 144 bytes
constexpr int kLdcF = kChunk + 4;    // its float32 row stride: 272 bytes
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The widest copy (bytes) that every row of `row_bytes` and every base
// pointer allows: 16, 8, 4 or, for bf16, 2.
inline int copy_grain(long long row_bytes, const void* const* ptrs, int n,
                      int elem) {
  int g = 16;
  while (g > elem) {
    bool ok = row_bytes % g == 0;
    for (int i = 0; i < n && ok; ++i)
      ok = reinterpret_cast<uintptr_t>(ptrs[i]) % g == 0;
    if (ok) break;
    g /= 2;
  }
  return g;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Stage `rows` rows x `cols` columns (a multiple of 8) of T (uint16_t for
// bf16, float) into dst (row stride ld, 16-byte aligned rows): row r, column
// c is element c0 + c of the row at src + off(r), or zero where off(r) < 0
// (no such row) or c0 + c >= D.  With a grain of g bytes, D is a multiple of
// g / sizeof(T), so every copy lies wholly below D or wholly past it.
template <typename T, typename Off>
__device__ __forceinline__ void stage(T* dst, int ld, int rows, int cols,
                                      const T* src, int c0, int D, int grain,
                                      Off off) {
  const int e = grain / static_cast<int>(sizeof(T));
  const int per_row = cols / e;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * e;
    const long long o = off(r);
    const bool ok = o >= 0 && c0 + c < D;
    const T* s = ok ? src + o + c0 + c : src;
    T* d = dst + r * ld + c;
    if (grain >= 4)
      cp_async(d, s, grain, ok);
    else
      *d = ok ? *s : T(0);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// over the eight lanes that share lane % 4 (one column of an mma.sync
// accumulator fragment)
__device__ __forceinline__ float col_max(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
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

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// -- prefill ------------------------------------------------------------------
//
// A prefill policy (flash_attention.cu's FlashRows, ragged_prefill.cu's
// RaggedRows) gives the CTA's query rows and key chunks:
//   bool begin(int tile, int kc, int& r0, int& rend, int& n_chunks): the
//        absolute rows [r0, rend) of this CTA (false: none) and the key
//        chunks of kc keys it walks (run by every thread);
//   bool live(int ch, int kc): whether chunk ch admits any pair of the
//        CTA (block-uniform; every thread calls it);
//   bool admit(int row, int key): the mask (row, key absolute);
//   long long q_off(int row), kv_off(int key): element offsets of a row of
//        q / o and of k / v (-1: no such row; zero-filled);
//   const T* q, k, v; T* o; int D, n_keys; float scale; int grain.

constexpr int kPrefillRows = 64;     // bf16: four warps of 16 query rows
constexpr int kPrefillKeys = 64;     // bf16: keys a chunk
constexpr int kPrefillRowsF = 32;    // float32: eight groups of 4 rows
constexpr int kPrefillKeysF = 32;    // float32: keys a chunk

template <int PW>
constexpr int prefill_smem_bf16() {
  return (2 * kPrefillRows * kLdc + kPrefillKeys * (PW + 8)) * 2;
}
template <int PW>
constexpr int prefill_smem_f32() {
  return ((kPrefillRowsF + kPrefillKeysF) * kLdcF +
          kPrefillKeysF * (PW + 4) + kPrefillRowsF * (kPrefillKeysF + 1)) *
         4;
}

// bf16: four warps, 64 query rows, 64 keys a chunk, output columns
// [PW·blockIdx.z, +PW).  SPLIT: p as p_hi + p_lo (two products); else p
// rounded to bf16.
template <int PW, bool SPLIT, class Pol>
__global__ void __launch_bounds__(128)
prefill_bf16_panel(Pol pol) {
  constexpr int BM = kPrefillRows, KC = kPrefillKeys, LV = PW + 8;
  int r0, rend, n_chunks;
  if (!pol.begin(BM, KC, r0, rend, n_chunks)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);   // BM x kLdc
  uint16_t* k_s = q_s + BM * kLdc;                         // KC x kLdc
  uint16_t* v_s = k_s + KC * kLdc;                         // KC x LV
  const int D = pol.D, c0 = blockIdx.z * PW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  const int qr = warp * 16 + (mi & 1) * 8 + (lane & 7);   // ldmatrix row
  const int qrow_a = r0 + warp * 16 + g, qrow_b = qrow_a + 8;

  float acc[PW / 8][4];
#pragma unroll
  for (int j = 0; j < PW / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const auto q_off = [&](int r) {
    return r0 + r < rend ? pol.q_off(r0 + r) : -1ll;
  };

  for (int ch = 0; ch < n_chunks; ++ch) {
    if (!pol.live(ch, KC)) continue;
    const int k0 = ch * KC;
    const auto kv_off = [&](int r) {
      return k0 + r < pol.n_keys ? pol.kv_off(k0 + r) : -1ll;
    };
    float s[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int dc = 0; dc < D; dc += kChunk) {
      __syncthreads();   // the previous readers of q_s, k_s (and v_s) done
      if (dc == 0) stage(v_s, LV, KC, PW, pol.v, c0, D, pol.grain, kv_off);
      stage(q_s, kLdc, BM, kChunk, pol.q, dc, D, pol.grain, q_off);
      stage(k_s, kLdc, KC, kChunk, pol.k, dc, D, pol.grain, kv_off);
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int kt = 0; kt < kChunk / 16; ++kt) {
        if (dc + kt * 16 >= D) break;    // k-steps wholly past D
        uint32_t qa[4];
        hopper::ldmatrix_x4(qa, hopper::smem_u32(q_s + qr * kLdc + kt * 16 +
                                                 (mi >> 1) * 8));
#pragma unroll
        for (int np = 0; np < KC / 16; ++np) {
          const int key = np * 16 + (mi >> 1) * 8 + (lane & 7);
          uint32_t b[4];
          hopper::ldmatrix_x4(b, hopper::smem_u32(k_s + key * kLdc + kt * 16 +
                                                  (mi & 1) * 8));
          hopper::mma_bf16(s[2 * np], qa, b[0], b[1]);
          hopper::mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        }
      }
    }

    // mask, online softmax in float32 (natural-log max)
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? qrow_a : qrow_b;
        const float x = row < rend && key < pol.n_keys && pol.admit(row, key)
                            ? s[j][e] * pol.scale : kNegInf;
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score gets an explicit zero weight
        const float x = s[j][e];
        const float pe = x == kNegInf ? 0.f : expf(x - (e < 2 ? mn_a : mn_b));
        s[j][e] = pe;
        if (e < 2) sum_a += pe; else sum_b += pe;
      }
    l_a = l_a * al_a + quad_sum(sum_a);
    l_b = l_b * al_b + quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < PW / 8; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }

    // O += P V over the panel's columns below D
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a[4], lo[4];
      if constexpr (SPLIT) {
        hopper::split_bf16(s[2 * kk][0], s[2 * kk][1], a[0], lo[0]);
        hopper::split_bf16(s[2 * kk][2], s[2 * kk][3], a[1], lo[1]);
        hopper::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], a[2], lo[2]);
        hopper::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], a[3], lo[3]);
      } else {
        a[0] = hopper::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = hopper::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = hopper::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = hopper::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < PW / 16; ++dp) {
        if (c0 + dp * 16 >= D) break;     // columns wholly past D
        const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
        uint32_t b[4];
        hopper::ldmatrix_x4_trans(
            b, hopper::smem_u32(v_s + key * LV + dp * 16 + (mi >> 1) * 8));
        hopper::mma_bf16(acc[2 * dp], a, b[0], b[1]);
        hopper::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
        if constexpr (SPLIT) {
          hopper::mma_bf16(acc[2 * dp], lo, b[0], b[1]);
          hopper::mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
        }
      }
    }
  }

  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int j = 0; j < PW / 8; ++j) {
    const int col = c0 + j * 8 + 2 * t;
    if (col >= D) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? qrow_a : qrow_b;
      if (row < rend && col + (e & 1) < D)
        store_elem(pol.o + pol.q_off(row) + col + (e & 1),
                   acc[j][e] * (e < 2 ? inv_a : inv_b));
    }
  }
}

// float32: 128 threads, 32 query rows (thread ty = tid / 16 owns rows
// 4ty..4ty+3, tx = tid % 16 keys tx and tx + 16 of a 32-key chunk and
// output columns c0 + tx + 16c).
template <int PW, class Pol>
__global__ void __launch_bounds__(128, 1)
prefill_f32_panel(Pol pol) {
  constexpr int TM = kPrefillRowsF, KC = kPrefillKeysF, LV = PW + 4;
  constexpr int LP = KC + 1, DC = PW / 16;
  int r0, rend, n_chunks;
  if (!pol.begin(TM, KC, r0, rend, n_chunks)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // TM x kLdcF
  float* k_s = q_s + TM * kLdcF;                     // KC x kLdcF
  float* v_s = k_s + KC * kLdcF;                     // KC x LV
  float* p_s = v_s + KC * LV;                        // TM x LP
  const int D = pol.D, c0 = blockIdx.z * PW;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float m_r[4], l_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const auto q_off = [&](int r) {
    return r0 + r < rend ? pol.q_off(r0 + r) : -1ll;
  };

  for (int ch = 0; ch < n_chunks; ++ch) {
    if (!pol.live(ch, KC)) continue;
    const int k0 = ch * KC;
    const auto kv_off = [&](int r) {
      return k0 + r < pol.n_keys ? pol.kv_off(k0 + r) : -1ll;
    };
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int dc = 0; dc < D; dc += kChunk) {
      __syncthreads();
      if (dc == 0) stage(v_s, LV, KC, PW, pol.v, c0, D, pol.grain, kv_off);
      stage(q_s, kLdcF, TM, kChunk, pol.q, dc, D, pol.grain, q_off);
      stage(k_s, kLdcF, KC, kChunk, pol.k, dc, D, pol.grain, kv_off);
      cp_async_wait_all();
      __syncthreads();
      const int dn = min(kChunk, D - dc);
#pragma unroll 8
      for (int d = 0; d < dn; ++d) {
        const float k0v = k_s[tx * kLdcF + d], k1v = k_s[(tx + 16) * kLdcF + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qv = q_s[(ty * 4 + i) * kLdcF + d];
          s[i][0] = fmaf(qv, k0v, s[i][0]);
          s[i][1] = fmaf(qv, k1v, s[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = r0 + r;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int key = k0 + tx + 16 * jj;
        ok[jj] = row < rend && key < pol.n_keys && pol.admit(row, key);
        s[i][jj] = ok[jj] ? s[i][jj] * pol.scale : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m_r[i], half_warp_max(mx));
      const float alpha = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float pe = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        p_s[r * LP + tx + 16 * jj] = pe;
        sum += pe;
      }
      l_r[i] = l_r[i] * alpha + half_warp_sum(sum);
      m_r[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int tk = 0; tk < KC; ++tk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * LP + tk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        if (c0 + 16 * c >= D) break;     // columns wholly past D
        const float vv = v_s[tk * LV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row < rend) {
      const float l = l_r[i] == 0.f ? 1.f : l_r[i];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = c0 + tx + 16 * c;
        if (col < D) pol.o[pol.q_off(row) + col] = acc[i][c] / l;
      }
    }
  }
}

// -- decode -------------------------------------------------------------------
//
// One CTA per (span, output panel, KV head, head block, row): grid x = span
// · panels + panel, y = KV head · head blocks + head block, z = row.  A
// decode policy (flash_decode.cu's DenseRows, paged_decode.cu's PagedRows)
// walks the span:
//   int begin(int b, int s, int hk, int T): the span's tiles of T positions
//        (0: no valid position);
//   int tile(int i, int T): makes tile i current (may stage page numbers,
//        with __syncthreads) and returns its valid rows;
//   long long row_off(int r): the element offset in k / v of row r of the
//        current tile (r below the valid rows);
//   const T* q, k, v; float *o_part, *m_part, *l_part; int Hq, Hkv, D, ns,
//        nhb, npanel; float scale; int grain.
// Rows of a tile past its valid ones are staged as zeros and masked.

constexpr int kGB = 8;               // query heads a CTA serves (mma's n)
constexpr int kDecodeRows = 64;      // bf16: positions a tile, 16 a warp
constexpr int kDecodeRowsF = 32;     // float32: positions a tile

template <int PW>
constexpr int decode_smem_bf16() {
  return (kGB * kLdc + kDecodeRows * kLdc + kDecodeRows * (PW + 8)) * 2;
}
template <int PW>
constexpr int decode_smem_f32() {
  return (kGB * kLdcF + kDecodeRowsF * kLdcF + kDecodeRowsF * (PW + 4) +
          kGB * (kDecodeRowsF + 1) + 3 * kGB) * 4;
}

struct DecodeCta {
  int s, panel, hk, hb, b, h0, GB, c0;
  template <class Pol>
  __device__ __forceinline__ DecodeCta(const Pol& pol, int PW) {
    s = blockIdx.x / pol.npanel;
    panel = blockIdx.x % pol.npanel;
    hk = blockIdx.y / pol.nhb;
    hb = blockIdx.y % pol.nhb;
    b = blockIdx.z;
    const int G = pol.Hq / pol.Hkv;
    h0 = hk * G + hb * kGB;
    GB = min(kGB, G - hb * kGB);
    c0 = panel * PW;
  }
  // the partial row of head h of the block
  template <class Pol>
  __device__ __forceinline__ size_t row(const Pol& pol, int h) const {
    return ((size_t)b * pol.Hq + h0 + h) * pol.ns + s;
  }
};

// a span with no valid position: o = 0 on the panel's columns, m = -1e30
// and l = 0 (written by panel 0)
template <int PW, class Pol>
__device__ __forceinline__ void empty_partial(const Pol& pol,
                                              const DecodeCta& c) {
  for (int i = threadIdx.x; i < c.GB * PW; i += blockDim.x) {
    const int h = i / PW, d = c.c0 + i % PW;
    const size_t row = c.row(pol, h);
    if (d < pol.D) pol.o_part[row * pol.D + d] = 0.f;
    if (c.panel == 0 && i % PW == 0) {
      pol.m_part[row] = kNegInf;
      pol.l_part[row] = 0.f;
    }
  }
}

// bf16: four warps, each 16 positions of a 64-position tile, the head
// block's heads as mma.sync's n = 8 (Sᵀ = K·Qᵀ, Oᵀ = Vᵀ·Pᵀ as in the
// on-grain instances); each warp keeps its own running max, sum and
// accumulator over the panel, merged in shared memory at the end.
template <int PW, bool SPLIT, class Pol>
__global__ void __launch_bounds__(128)
decode_bf16_panel(Pol pol) {
  constexpr int T = kDecodeRows, LV = PW + 8, NW = 4;
  const DecodeCta c(pol, PW);
  const int n_tiles = pol.begin(c.b, c.s, c.hk, T);
  if (n_tiles == 0) {
    empty_partial<PW>(pol, c);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);  // kGB x kLdc
  uint16_t* k_s = q_s + kGB * kLdc;                       // T x kLdc
  uint16_t* v_s = k_s + T * kLdc;                         // T x LV
  const int D = pol.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int row0 = warp * 16;
  const size_t q_base = ((size_t)c.b * pol.Hq + c.h0) * D;
  const auto q_off = [&](int r) {
    return r < c.GB ? (long long)(q_base + (size_t)r * D) : -1ll;
  };

  float acc[PW / 16][4];
#pragma unroll
  for (int mt = 0; mt < PW / 16; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int nt = pol.tile(i, T);
    const auto kv_off = [&](int r) { return r < nt ? pol.row_off(r) : -1ll; };
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int dc = 0; dc < D; dc += kChunk) {
      __syncthreads();
      if (dc == 0) stage(v_s, LV, T, PW, pol.v, c.c0, D, pol.grain, kv_off);
      stage(q_s, kLdc, kGB, kChunk, pol.q, dc, D, pol.grain, q_off);
      stage(k_s, kLdc, T, kChunk, pol.k, dc, D, pol.grain, kv_off);
      cp_async_wait_all();
      __syncthreads();
      const int row = row0 + (mi & 1) * 8 + r8;
#pragma unroll
      for (int kt = 0; kt < kChunk / 16; ++kt) {
        if (dc + kt * 16 >= D) break;
        uint32_t a[4];
        hopper::ldmatrix_x4(a, hopper::smem_u32(k_s + row * kLdc + kt * 16 +
                                                (mi >> 1) * 8));
        const uint16_t* qg = q_s + g * kLdc + kt * 16 + 2 * t;
        hopper::mma_bf16(sc, a, *reinterpret_cast<const uint32_t*>(qg),
                         *reinterpret_cast<const uint32_t*>(qg + 8));
      }
    }

    // rows g, g + 8 of this warp's slab; heads 2t, 2t + 1
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = row0 + g + (e >> 1) * 8 < nt ? sc[e] * pol.scale
                                                   : kNegInf;
      sc[e] = x;
      if (e & 1) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    const float mn0 = fmaxf(m0, col_max(mx0)), mn1 = fmaxf(m1, col_max(mx1));
    const float al0 = exp2f((m0 - mn0) * kLog2e);
    const float al1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float pe[4], sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pe[e] = row0 + g + (e >> 1) * 8 < nt
                  ? exp2f((sc[e] - ((e & 1) ? mn1 : mn0)) * kLog2e) : 0.f;
      if (e & 1) sum1 += pe[e]; else sum0 += pe[e];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    uint32_t ph[2], pl[2];
    if constexpr (SPLIT) {
      uint32_t hi, lo;
      hopper::split_bf16(pe[0], pe[1], hi, lo);
      ph[0] = hopper::movmatrix_trans(hi);
      pl[0] = hopper::movmatrix_trans(lo);
      hopper::split_bf16(pe[2], pe[3], hi, lo);
      ph[1] = hopper::movmatrix_trans(hi);
      pl[1] = hopper::movmatrix_trans(lo);
    } else {
      ph[0] = hopper::movmatrix_trans(hopper::pack_bf16(pe[0], pe[1]));
      ph[1] = hopper::movmatrix_trans(hopper::pack_bf16(pe[2], pe[3]));
    }
#pragma unroll
    for (int mt = 0; mt < PW / 16; ++mt) {
      if (c.c0 + mt * 16 >= D) break;
      acc[mt][0] *= al0;
      acc[mt][1] *= al1;
      acc[mt][2] *= al0;
      acc[mt][3] *= al1;
      uint32_t a[4];
      const int row = row0 + (mi >> 1) * 8 + r8;
      hopper::ldmatrix_x4_trans(
          a, hopper::smem_u32(v_s + row * LV + mt * 16 + (mi & 1) * 8));
      hopper::mma_bf16(acc[mt], a, ph[0], ph[1]);
      if constexpr (SPLIT) hopper::mma_bf16(acc[mt], a, pl[0], pl[1]);
    }
  }
  l0 = col_sum(l0);
  l1 = col_sum(l1);

  // merge the warps' (m, l, o) over the panel's columns below D
  __syncthreads();
  float* o_w = reinterpret_cast<float*>(smem_raw);   // [warp][8][PW]
  float* m_w = o_w + NW * kGB * PW;                  // [warp][8]
  float* l_w = m_w + NW * kGB;
#pragma unroll
  for (int mt = 0; mt < PW / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = mt * 16 + g + (e >> 1) * 8;
      o_w[(warp * kGB + 2 * t + (e & 1)) * PW + d] = acc[mt][e];
    }
  if (g == 0) {
    m_w[warp * kGB + 2 * t] = m0;
    m_w[warp * kGB + 2 * t + 1] = m1;
    l_w[warp * kGB + 2 * t] = l0;
    l_w[warp * kGB + 2 * t + 1] = l1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < c.GB * PW; j += blockDim.x) {
    const int h = j / PW, d = j % PW;
    if (c.c0 + d >= D) continue;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, m_w[w * kGB + h]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(m_w[w * kGB + h] - m);
      o += o_w[(w * kGB + h) * PW + d] * f;
      l += l_w[w * kGB + h] * f;
    }
    const size_t row = c.row(pol, h);
    pol.o_part[row * D + c.c0 + d] = o;
    if (c.panel == 0 && d == 0) {
      pol.m_part[row] = m;
      pol.l_part[row] = l;
    }
  }
}

// float32: 128 threads, 32-position tiles; scores with four threads a
// position (each a quarter of the chunk's columns for all 8 heads), the
// softmax one warp per head, P·V with each thread owning the panel
// columns c0 + tid + 128j.
template <int PW, class Pol>
__global__ void __launch_bounds__(128)
decode_f32_panel(Pol pol) {
  constexpr int T = kDecodeRowsF, LV = PW + 4, LW = T + 1;
  constexpr int NC = (PW + 127) / 128;
  const DecodeCta c(pol, PW);
  const int n_tiles = pol.begin(c.b, c.s, c.hk, T);
  if (n_tiles == 0) {
    empty_partial<PW>(pol, c);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // kGB x kLdcF
  float* k_s = q_s + kGB * kLdcF;                    // T x kLdcF
  float* v_s = k_s + T * kLdcF;                      // T x LV
  float* w_s = v_s + T * LV;                         // kGB x LW
  float* m_s = w_s + kGB * LW;
  float* l_s = m_s + kGB;
  float* a_s = l_s + kGB;
  const int D = pol.D, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tp = tid >> 2, sub = tid & 3;    // position, quarter
  const size_t q_base = ((size_t)c.b * pol.Hq + c.h0) * D;
  const auto q_off = [&](int r) {
    return r < c.GB ? (long long)(q_base + (size_t)r * D) : -1ll;
  };
  if (tid < kGB) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    a_s[tid] = 1.f;    // heads past the block keep theirs
  }
  float acc[NC][kGB];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int h = 0; h < kGB; ++h) acc[j][h] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int nt = pol.tile(i, T);
    const auto kv_off = [&](int r) { return r < nt ? pol.row_off(r) : -1ll; };
    float part[kGB];
#pragma unroll
    for (int h = 0; h < kGB; ++h) part[h] = 0.f;
    for (int dc = 0; dc < D; dc += kChunk) {
      __syncthreads();
      if (dc == 0) stage(v_s, LV, T, PW, pol.v, c.c0, D, pol.grain, kv_off);
      stage(q_s, kLdcF, kGB, kChunk, pol.q, dc, D, pol.grain, q_off);
      stage(k_s, kLdcF, T, kChunk, pol.k, dc, D, pol.grain, kv_off);
      cp_async_wait_all();
      __syncthreads();
      const int dn = min(kChunk, D - dc);
      for (int d = sub; d < dn; d += 4) {
        const float kv = k_s[tp * kLdcF + d];
#pragma unroll
        for (int h = 0; h < kGB; ++h)
          part[h] = fmaf(q_s[h * kLdcF + d], kv, part[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < kGB; ++h) {
      const float sc = quad_sum(part[h]);
      if (sub == 0) w_s[h * LW + tp] = sc * pol.scale;
    }
    __syncthreads();
    // online softmax, one warp per head: lane = position
    for (int h = warp; h < c.GB; h += 4) {
      const float x = lane < nt ? w_s[h * LW + lane] : kNegInf;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[h], m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      const float e = lane < nt ? expf(x - m_new) : 0.f;
      w_s[h * LW + lane] = e;
      float sum = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
        a_s[h] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tid + 128 * j;
      if (d < PW && c.c0 + d < D) {
#pragma unroll
        for (int h = 0; h < kGB; ++h) acc[j][h] *= a_s[h];
        for (int r = 0; r < nt; ++r) {
          const float vv = v_s[r * LV + d];
#pragma unroll
          for (int h = 0; h < kGB; ++h)
            acc[j][h] = fmaf(w_s[h * LW + r], vv, acc[j][h]);
        }
      }
    }
  }
  __syncthreads();
  for (int h = 0; h < c.GB; ++h) {
    const size_t row = c.row(pol, h);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tid + 128 * j;
      if (d < PW && c.c0 + d < D) pol.o_part[row * D + c.c0 + d] = acc[j][h];
    }
    if (c.panel == 0 && tid == 0) {
      pol.m_part[row] = m_s[h];
      pol.l_part[row] = l_s[h];
    }
  }
}

// The log-sum-exp merge of a row's ns partials: one CTA per (b·Hq + h) row,
// its threads walking the D columns.
template <typename T>
__global__ void combine_panels(const float* __restrict__ o_part,
                               const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               T* __restrict__ out, int ns, int D) {
  const size_t row = blockIdx.x;
  const float* m = m_part + row * ns;
  const float* l = l_part + row * ns;
  float mg = kNegInf;
  for (int s = 0; s < ns; ++s) mg = fmaxf(mg, m[s]);
  float lg = 0.f;
  for (int s = 0; s < ns; ++s) lg += l[s] * expf(m[s] - mg);
  if (lg == 0.f) lg = 1.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < ns; ++s)
      o += o_part[(row * ns + s) * D + d] * expf(m[s] - mg);
    store_elem(out + row * D + d, o / lg);
  }
}

// Whether head_dim D runs on the panel route (kernelspec.on_grain): rows
// that are not whole 16-byte vectors, or more than 256 columns.
inline bool off_grain(int D, int is_bf16) {
  return D > 256 || D % (is_bf16 ? 8 : 4) != 0;
}

// the panel width a head_dim runs at (64, or 256), and its panels
inline int panel_width(int D) { return D <= 64 ? 64 : 256; }
inline int n_panels(int D) { return (D + panel_width(D) - 1) / panel_width(D); }

// the element type of a row policy (its q pointer's)
template <class Pol>
using elem_t = typename std::remove_cv<typename std::remove_pointer<
    decltype(std::declval<Pol>().q)>::type>::type;

template <typename K, class Pol>
inline int launch(K kern, int smem, dim3 grid, cudaStream_t st,
                  const Pol& pol) {
  const int e = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  kern<<<grid, 128, smem, st>>>(pol);
  return (int)cudaGetLastError();
}

// The prefill kernels' panel route: a CTA per entry of `grid`, on the
// bf16 or float32 kernel by the policy's element type; SPLIT keeps p as
// p_hi + p_lo (the serving kernel) instead of rounding it to bf16.
template <int PW, bool SPLIT, class Pol>
int launch_prefill(const Pol& pol, dim3 grid, cudaStream_t st) {
  if constexpr (std::is_same<elem_t<Pol>, uint16_t>::value)
    return launch(prefill_bf16_panel<PW, SPLIT, Pol>, prefill_smem_bf16<PW>(),
                  grid, st, pol);
  else
    return launch(prefill_f32_panel<PW, Pol>, prefill_smem_f32<PW>(), grid,
                  st, pol);
}

// The decode kernels' panel route: the span walk on `grid` (spans x
// panels, KV heads x head blocks, batch rows) into the policy's o/m/l
// partials, then combine_panels over its ns spans into `out` for the
// `rows` = B·Hq query rows.
template <int PW, bool SPLIT, class Pol>
int launch_decode(const Pol& pol, dim3 grid, unsigned rows, void* out,
                  cudaStream_t st) {
  using T = elem_t<Pol>;
  int e;
  if constexpr (std::is_same<T, uint16_t>::value)
    e = launch(decode_bf16_panel<PW, SPLIT, Pol>, decode_smem_bf16<PW>(),
               grid, st, pol);
  else
    e = launch(decode_f32_panel<PW, Pol>, decode_smem_f32<PW>(), grid, st,
               pol);
  if (e) return e;
  combine_panels<T><<<rows, pol.D < 256 ? pol.D : 256, 0, st>>>(
      pol.o_part, pol.m_part, pol.l_part, static_cast<T*>(out), pol.ns,
      pol.D);
  return (int)cudaGetLastError();
}

}  // namespace panel
