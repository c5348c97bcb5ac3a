// Flash attention (prefill) for Hopper (sm_90a), plain C entry point.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (`flash_attention`,
// body `_fa_kernel`) and computes what it computes:
//   * q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), all bf16 or all f32,
//     give o (B, Hq, Sq, D) in the same type; query head h reads KV head
//     h / (Hq / Hkv);
//   * keys at or beyond Skv are masked; under `causal` a pair needs
//     qpos >= kpos in absolute positions (top-left alignment, as the
//     plain version's mask);
//   * the online-softmax carry (m, l, acc) is float32, masked scores are
//     -1e30 with an explicit zero weight, and a row whose l is 0 writes
//     zeros;
//   * p is cast to v's type before P·V, as the TPU kernel does: in bf16 it
//     is exactly the bf16 A operand of an mma.sync m16n8k16, built in
//     registers from the S accumulator fragments; l sums the float32 p.
//
// Design.  One CTA per (b·Hq + h, query tile).  The config's block_q maps
// onto compiled CTA tiles as gemm.cu maps its tiles: the wrapper picks the
// largest tile of 64, 32 or 16 query rows that divides block_q (16 when
// none does, with the rows past the config block masked), and a config
// block larger than the tile runs on several CTAs.  So the family
// example's block_q = 8 runs on a 16-row tile, and block_q = 256 on four
// 64-row CTAs.  Inside a CTA the keys are walked in chunks; with
// causal_block_skip (only under `causal`) the walk stops after the chunk
// that holds the CTA's last query row, which is exact: a later chunk
// would give alpha = 1 and p = 0 to every row of the CTA.
//
// The running max is updated once per kernel chunk (64 keys in bf16, 32
// in f32), whatever block_kv is, where the TPU kernel updates it once per
// block_kv keys.  p is rounded to bf16 against the running max of its
// chunk, so a bf16 result can move by about one bf16 step against the TPU
// kernel's; f32 results agree to f32 rounding.  block_kv and
// v_transposed_staging select nothing here: V's fragments come through
// ldmatrix.trans from V as it is staged (rows of keys), which is where a
// transposed staging would be honoured.
//
//   * bf16: 16 query rows per warp (1, 2 or 4 warps for a 16, 32 or
//     64-row tile).  Q, and each 64-key chunk of K and V, are staged in
//     shared memory by 16-byte cp.async copies (zero-filled past the
//     edge), K and V double-buffered; rows are padded by 16 bytes so the
//     ldmatrix reads are free of bank conflicts.  Q·Kᵀ and P·V run on
//     mma.sync.m16n8k16 with float32 accumulators; Q's fragments are
//     loaded once, K's by ldmatrix, V's by ldmatrix.trans.
//   * f32: CUDA-core FMAs (TF32 stays off, as resolve_device sets it), 4
//     threads per query row: each thread holds a 4 x 2 tile of scores and
//     a 4 x D/16 tile of the accumulator; Q and each 32-key chunk of K and
//     V are staged in shared memory as float32.
//
// head_dim 64 and 128 are compiled; the wrapper raises ValueError for any
// other before a launch.
//
// What bounds it on the H100.  At the family's production problem
// (16 x 8 query heads over 1 KV head, 8192 x 8192, D = 128, causal, bf16)
// the causal half of the products is 2.2e12 operations against 0.6 GB of
// q, k, v and o: 2.22 ms at 989 TFLOP/s against 0.18 ms at 3.35 TB/s, so
// operations bound it.  mma.sync fed by ldmatrix reaches a fraction of the
// tensor-core rate; wgmma fed by TMA with warp specialisation (the shape
// of a fast Hopper attention kernel) is left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunkBf16 = 64;  // keys per chunk, bf16 path
constexpr int kChunkF32 = 32;   // keys per chunk, f32 path

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hkv, Sq, Skv;
  int bq;    // the config's block_q
  int cps;   // CTAs per config block
  int causal, skip;
  float scale;
};

// Rows [r0, rend) of this CTA, the base of its (b, h) slices, and the
// number of key chunks it walks.  False when the CTA lies past the edge.
struct Work {
  int r0, rend, n_chunks;
  size_t q_base, kv_base;
};

__device__ __forceinline__ bool cta_work(const Params& p, int tile, int kc,
                                         Work& w) {
  const int bh = blockIdx.x;
  const int qi = blockIdx.y / p.cps, sub = blockIdx.y % p.cps;
  w.r0 = qi * p.bq + sub * tile;
  w.rend = min(min(qi * p.bq + p.bq, w.r0 + tile), p.Sq);
  if (w.r0 >= w.rend) return false;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  w.q_base = (size_t)bh * p.Sq;
  w.kv_base = ((size_t)b * p.Hkv + hk) * p.Skv;
  w.n_chunks = (p.Skv + kc - 1) / kc;
  if (p.causal && p.skip) w.n_chunks = min(w.n_chunks, (w.rend - 1) / kc + 1);
  return true;
}

__device__ __forceinline__ bool admitted(const Params& p, int qpos,
                                         int kpos) {
  return kpos < p.Skv && (!p.causal || qpos >= kpos);
}

// -- bf16: mma.sync ----------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// max / sum over the four lanes of a quad (the lanes holding one row of an
// accumulator fragment)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, int NW>
struct Bf16Cfg {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kTile = 16 * NW;
  static constexpr int KC = kChunkBf16;
  static constexpr int LDS = D + 8;     // padded row, in elements
  static constexpr int kSmem = (kTile + 4 * KC) * LDS * 2;  // bytes
};

template <int D, int NW>
__global__ void __launch_bounds__(32 * NW)
fa_bf16_kernel(Params p) {
  using C = Bf16Cfg<D, NW>;
  constexpr int KC = C::KC, LDS = C::LDS, NT = C::kThreads;
  constexpr int VEC = 8;  // bf16 per 16 bytes
  Work w;
  if (!cta_work(p, C::kTile, KC, w)) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + C::kTile * LDS;        // [2][KC][LDS]
  __nv_bfloat16* v_s = k_s + 2 * KC * LDS;          // [2][KC][LDS]

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // Q tile (rows past the CTA's end are zero-filled and never stored)
  for (int i = tid; i < C::kTile * (D / VEC); i += NT) {
    const int r = i / (D / VEC), c = i % (D / VEC);
    const int row = w.r0 + r;
    const bool ok = row < w.rend;
    cp_async16(q_s + r * LDS + c * VEC,
               q + (w.q_base + (ok ? row : w.r0)) * D + c * VEC, ok ? 16 : 0);
  }
  auto load_kv = [&](int chunk, int buf) {
    __nv_bfloat16* kd = k_s + buf * KC * LDS;
    __nv_bfloat16* vd = v_s + buf * KC * LDS;
    for (int i = tid; i < KC * (D / VEC); i += NT) {
      const int r = i / (D / VEC), c = i % (D / VEC);
      const int key = chunk * KC + r;
      const bool ok = key < p.Skv;
      const size_t src = (w.kv_base + (ok ? key : 0)) * D + c * VEC;
      cp_async16(kd + r * LDS + c * VEC, k + src, ok ? 16 : 0);
      cp_async16(vd + r * LDS + c * VEC, v + src, ok ? 16 : 0);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qa[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const int qrow_a = w.r0 + warp * 16 + g, qrow_b = qrow_a + 8;

  for (int ch = 0; ch < w.n_chunks; ++ch) {
    if (ch + 1 < w.n_chunks) {
      load_kv(ch + 1, (ch + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (ch == 0) {
#pragma unroll
      for (int kt = 0; kt < D / 16; ++kt) {
        const int mi = lane >> 3;
        const int row = warp * 16 + (mi & 1) * 8 + (lane & 7);
        ldmatrix_x4(qa[kt], q_s + row * LDS + kt * 16 + (mi >> 1) * 8);
      }
    }
    const __nv_bfloat16* kb = k_s + (ch & 1) * KC * LDS;
    const __nv_bfloat16* vb = v_s + (ch & 1) * KC * LDS;

    // S = Q Kᵀ for this warp's 16 rows and the chunk's KC keys
    float s[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
#pragma unroll
      for (int np = 0; np < KC / 16; ++np) {
        const int mi = lane >> 3;
        const int key = np * 16 + (mi >> 1) * 8 + (lane & 7);
        uint32_t b[4];
        ldmatrix_x4(b, kb + key * LDS + kt * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qa[kt], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kt], b[2], b[3]);
      }
    }

    // mask, online softmax (float32)
    const int k0 = ch * KC;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? qrow_a : qrow_b;
        const float x = admitted(p, qpos, kpos) ? s[j][e] * p.scale : kNegInf;
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? qrow_a : qrow_b;
        const float pe = admitted(p, qpos, kpos)
                             ? expf(s[j][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
        s[j][e] = pe;
        if (e < 2) sum_a += pe; else sum_b += pe;
      }
    }
    l_a = l_a * al_a + quad_sum(sum_a);
    l_b = l_b * al_b + quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }

    // O += P V, P rounded to bf16 (the TPU kernel's p.astype(v.dtype))
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int mi = lane >> 3;
        const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + key * LDS + dp * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next load overwrites this chunk's buffer
  }

  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (qrow_a < w.rend)
      *reinterpret_cast<uint32_t*>(o + (w.q_base + qrow_a) * D + col) =
          pack_bf16(acc[j][0] * inv_a, acc[j][1] * inv_a);
    if (qrow_b < w.rend)
      *reinterpret_cast<uint32_t*>(o + (w.q_base + qrow_b) * D + col) =
          pack_bf16(acc[j][2] * inv_b, acc[j][3] * inv_b);
  }
}

// -- f32: CUDA-core FMAs -----------------------------------------------------

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

template <int D, int TM>
struct F32Cfg {
  static constexpr int kThreads = 4 * TM;  // 16 per group of 4 rows
  static constexpr int KC = kChunkF32;
  static constexpr int LD = D + 1;
  static constexpr int LP = KC + 1;
  static constexpr int kSmem = ((TM + 2 * KC) * LD + TM * LP) * 4;  // bytes
};

template <int D, int TM>
__global__ void __launch_bounds__(4 * TM)
fa_f32_kernel(Params p) {
  using C = F32Cfg<D, TM>;
  constexpr int KC = C::KC, LD = C::LD, LP = C::LP, NT = C::kThreads;
  constexpr int DC = D / 16;  // accumulator columns per thread
  Work w;
  if (!cta_work(p, TM, KC, w)) return;

  extern __shared__ float smem[];
  float* q_s = smem;            // TM x LD
  float* k_s = q_s + TM * LD;   // KC x LD
  float* v_s = k_s + KC * LD;   // KC x LD
  float* p_s = v_s + KC * LD;   // TM x LP

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  float* o = static_cast<float*>(p.o);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < TM * D; i += NT) {
    const int r = i / D, c = i % D, row = w.r0 + r;
    q_s[r * LD + c] = row < w.rend ? q[(w.q_base + row) * D + c] : 0.f;
  }

  float m_r[4], l_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int ch = 0; ch < w.n_chunks; ++ch) {
    const int k0 = ch * KC;
    __syncthreads();  // q_s written / the previous chunk's readers done
    for (int i = tid; i < KC * D; i += NT) {
      const int r = i / D, c = i % D, key = k0 + r;
      const bool ok = key < p.Skv;
      const size_t src = (w.kv_base + (ok ? key : 0)) * D + c;
      k_s[r * LD + c] = ok ? k[src] : 0.f;
      v_s[r * LD + c] = ok ? v[src] : 0.f;
    }
    __syncthreads();

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
      const int r = ty * 4 + i, qpos = w.r0 + r;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        ok[jj] = admitted(p, qpos, k0 + tx + 16 * jj);
        s[i][jj] = ok[jj] ? s[i][jj] * p.scale : kNegInf;
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
        const float vv = v_s[tk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = w.r0 + ty * 4 + i;
    if (row < w.rend) {
      const float l = l_r[i] == 0.f ? 1.f : l_r[i];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        o[(w.q_base + row) * D + tx + 16 * c] = acc[i][c] / l;
    }
  }
}

// -- launch ------------------------------------------------------------------

template <typename Kern>
int launch_kernel(Kern kern, int smem, int threads, dim3 grid,
                  const Params& p, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int tile, int is_bf16, dim3 grid, const Params& p,
             cudaStream_t s) {
  if (is_bf16) {
    switch (tile) {
      case 16: return launch_kernel(fa_bf16_kernel<D, 1>, Bf16Cfg<D, 1>::kSmem, 32, grid, p, s);
      case 32: return launch_kernel(fa_bf16_kernel<D, 2>, Bf16Cfg<D, 2>::kSmem, 64, grid, p, s);
      case 64: return launch_kernel(fa_bf16_kernel<D, 4>, Bf16Cfg<D, 4>::kSmem, 128, grid, p, s);
    }
  } else {
    switch (tile) {
      case 16: return launch_kernel(fa_f32_kernel<D, 16>, F32Cfg<D, 16>::kSmem, 64, grid, p, s);
      case 32: return launch_kernel(fa_f32_kernel<D, 32>, F32Cfg<D, 32>::kSmem, 128, grid, p, s);
      case 64: return launch_kernel(fa_f32_kernel<D, 64>, F32Cfg<D, 64>::kSmem, 256, grid, p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), o (B, Hq, Sq, D); contiguous, on
// one device, 16-byte aligned, all bf16 (is_bf16) or all f32; D in {64,
// 128}; tile in {16, 32, 64} query rows per CTA; block_q the config's
// query block (a multiple of tile, or smaller than it).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      int block_q, int tile, int causal,
                                      int skip, float scale, int is_bf16,
                                      void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      block_q <= 0 || tile <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.bq = block_q;
  p.cps = (block_q + tile - 1) / tile;
  p.causal = causal;
  p.skip = skip;
  p.scale = scale;
  const long long nq = (Sq + block_q - 1) / block_q;
  if (nq * p.cps > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * Hq, (unsigned)(nq * p.cps));
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_d<64>(tile, is_bf16, grid, p, s);
    case 128: return launch_d<128>(tile, is_bf16, grid, p, s);
  }
  return (int)cudaErrorInvalidValue;
}
