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
//     is the bf16 A operand of the P·V product, built in registers from
//     the S accumulator fragments; l sums the float32 p.
//
// Design.  One CTA per (b·Hq + h, query tile).  The config's block_q maps
// onto compiled CTA tiles as gemm.cu maps its tiles: the wrapper picks the
// largest tile of 128, 64, 32 or 16 query rows that divides block_q (16
// when none does, with the rows past the config block masked), and a
// config block larger than the tile runs on several CTAs.  So the family
// example's block_q = 8 runs on a 16-row tile, and block_q = 256 on two
// 128-row CTAs.  The grid walks the query tiles last to first, so that
// under `causal` the longest key walks are dispatched first.  Inside a
// CTA the keys are walked in tiles; with causal_block_skip (only under
// `causal`) the walk stops after the tile that holds the CTA's last query
// row, which is exact: a later tile would give alpha = 1 and p = 0 to
// every row of the CTA.
//
// The running max is updated once per kernel key tile (128 keys on the
// 128- and 64-row bf16 tiles, 64 on the 32- and 16-row ones, 32 in f32),
// whatever block_kv is, where the TPU kernel updates it once per block_kv
// keys.  p is rounded to bf16 against the running max of its tile, so a
// bf16 result can move by about one bf16 step against the TPU kernel's;
// f32 results agree to f32 rounding.  block_kv and v_transposed_staging
// select nothing here: V is read as it is staged (rows of keys), by the
// transposed (MN-major) B mode of wgmma or by ldmatrix.trans, which is
// where a transposed staging would be honoured.
//
//   * bf16, 128- and 64-row tiles (fa_wgmma_kernel): the FlashAttention-3
//     layout.  A producer warpgroup (one thread issues) loads Q once and
//     each 128-key tile of K and of V by TMA (128-byte swizzle, zero fill
//     past Sq and Skv) into a two-stage ring of shared memory and runs
//     ahead of the consumers; K and V of a stage each have a "full" and
//     an "empty" mbarrier, so K is refilled once S has been computed and
//     V once P·V has.  One or two consumer warpgroups of 64 query rows
//     each compute S = Q·Kᵀ by wgmma.mma_async m64n128k16 (Q and K from
//     shared memory, f32 accumulator in registers), the softmax in
//     registers with exp2f and log2(e) folded into the scale, masking only
//     the tiles that cross the causal diagonal or the Skv edge, and O +=
//     P·V by wgmma with P as the bf16 register A operand and V as the
//     MN-major shared-memory B operand.  The softmax of a tile that
//     crosses neither the diagonal nor the edge takes its max on the raw
//     scores and one FFMA and one exp2f per score (the scale folded into
//     the FFMA): an earlier form with a multiply, a subtract and the
//     mask's selects per score took 6.39 ms at the family's production
//     problem on an H100, this one 4.22 (chip_smoke.py phase 7c;
//     PERF.md).
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232).
//   * bf16, 32- and 16-row tiles (fa_bf16_kernel): 16 query rows per warp.
//     Q, and each 64-key chunk of K and V, are staged in shared memory by
//     16-byte cp.async copies (zero-filled past the edge), K and V
//     double-buffered; rows are padded by 16 bytes so the ldmatrix reads
//     are free of bank conflicts.  Q·Kᵀ and P·V run on mma.sync.m16n8k16
//     with float32 accumulators.  These tiles serve block_q below 64 (the
//     family example's 8).
//   * f32: CUDA-core FMAs (TF32 stays off, as resolve_device sets it), 4
//     threads per query row: each thread holds a 4 x 2 tile of scores and
//     a 4 x D/16 tile of the accumulator; Q and each 32-key chunk of K and
//     V are staged in shared memory as float32.
//
// head_dim: any, as the TPU kernel takes.  The three designs above take
// every width whose rows are whole 16-byte vectors (a multiple of 8 in
// bf16, of 4 in f32) up to 256; any other head_dim (rows off the 16-byte
// grain, or above 256) runs on the panel route of panel_attention.cuh:
// fa_panel_bf16 (mma.sync, 64 query rows a CTA, p rounded to bf16 as
// here) and fa_panel_f32 (CUDA-core FMAs, 32 rows), Q, K and V staged by
// the widest copy the rows allow, S over 64-column chunks of D, and a
// grid axis of output panels of 64 or 256 columns, each recomputing S.
// Of the on-grain widths, each
// design is compiled at three widths W = 64, 128 and 256 columns, and D
// runs in the least W >= D; HBM bytes stay those of D and only columns
// below D are stored.  The wgmma tiles declare their TMA maps at D
// columns (TMA's zero fill supplies columns D..W-1 in shared memory); the
// mma.sync and f32 tiles stage rows of W columns whose columns past D are
// zero.  Every design skips the k-steps of S wholly past D and the
// columns of P·V wholly past it.  Each is compiled twice a width: with D
// read at run time, and with D = W known at compile time (kFull), where
// the guards and strides of D fold away; the launch takes the second
// where D is the width (64, 128, 256).  At W = 256 the wgmma tiles take
// 64 keys (Q and a two-stage ring of 128-key tiles would not fit), S on
// m64n64k16 and P·V on m64n256k16.
//
// What bounds it on the H100.  At the family's production problem
// (16 x 8 query heads over 1 KV head, 8192 x 8192, D = 128, causal, bf16)
// the causal half of the products is 2.2e12 operations against 0.6 GB of
// q, k, v and o: 2.22 ms at 989 TFLOP/s against 0.18 ms at 3.35 TB/s, so
// operations bound it, and only wgmma reaches the tensor cores' full rate
// on Hopper.  A warpgroup's softmax does not overlap its own products
// here: issuing S of tile j with P·V of tile j-1, and ping-pong turns
// between the two warpgroups, both measured slower on an H100 than this
// plain order (PERF.md).
#include "hopper.cuh"
#include "panel_attention.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunkBf16 = 64;  // keys per chunk, 32- and 16-row bf16 tiles
constexpr int kChunkF32 = 32;   // keys per chunk, f32 path

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hkv, Sq, Skv, D;
  int bq;    // the config's block_q
  int cps;   // CTAs per config block
  int causal, skip;
  float scale;
};

// Rows [r0, rend) of this CTA, the base of its (b, h) slices, and the
// number of key chunks it walks.  False when the CTA lies past the edge.
// Query tiles are taken last to first (the longest causal walks first).
struct Work {
  int r0, rend, n_chunks;
  size_t q_base, kv_base;
};

__device__ __forceinline__ bool cta_work(const Params& p, int tile, int kc,
                                         Work& w) {
  const int bh = blockIdx.x;
  const int y = gridDim.y - 1 - blockIdx.y;
  const int qi = y / p.cps, sub = y % p.cps;
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

// -- bf16, 32- and 16-row tiles: mma.sync -------------------------------------

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

template <int W, int NW>
struct Bf16Cfg {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kTile = 16 * NW;
  static constexpr int KC = kChunkBf16;
  static constexpr int LDS = W + 8;     // padded row, in elements
  static constexpr int kSmem = (kTile + 4 * KC) * LDS * 2;  // bytes
};

template <int W, int NW, bool kFull>
__global__ void __launch_bounds__(32 * NW)
fa_bf16_kernel(Params p) {
  using C = Bf16Cfg<W, NW>;
  constexpr int KC = C::KC, LDS = C::LDS, NT = C::kThreads;
  constexpr int VEC = 8;  // bf16 per 16 bytes
  const int D = kFull ? W : p.D, DV = D / VEC;
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

  // rows of W columns: the 16-byte chunks past D are copied as zeros (a
  // copy of 0 source bytes), so the last k-step, where D is not a
  // multiple of 16, adds nothing past D
  constexpr int CW = W / VEC;           // 16-byte chunks of a padded row
  // Q tile (rows past the CTA's end are zero-filled and never stored)
  for (int i = tid; i < C::kTile * CW; i += NT) {
    const int r = i / CW, c = i % CW;
    const int row = w.r0 + r;
    const bool ok = row < w.rend && c < DV;
    cp_async16(q_s + r * LDS + c * VEC,
               q + (w.q_base + (ok ? row : w.r0)) * D + (ok ? c * VEC : 0),
               ok ? 16 : 0);
  }
  auto load_kv = [&](int chunk, int buf) {
    __nv_bfloat16* kd = k_s + buf * KC * LDS;
    __nv_bfloat16* vd = v_s + buf * KC * LDS;
    for (int i = tid; i < KC * CW; i += NT) {
      const int r = i / CW, c = i % CW;
      const int key = chunk * KC + r;
      const bool ok = key < p.Skv && c < DV;
      const size_t src = (w.kv_base + (ok ? key : 0)) * D + (ok ? c * VEC : 0);
      cp_async16(kd + r * LDS + c * VEC, k + src, ok ? 16 : 0);
      cp_async16(vd + r * LDS + c * VEC, v + src, ok ? 16 : 0);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // Q's fragments stay in registers up to width 128; at 256 they are read
  // from shared memory at each k-step (the accumulator takes 128
  // registers there)
  constexpr int QF = W <= 128 ? W / 16 : 1;
  uint32_t qa[QF][4];
  float acc[W / 8][4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const int qrow_a = w.r0 + warp * 16 + g, qrow_b = qrow_a + 8;
  const int mi = lane >> 3;
  const int qr = warp * 16 + (mi & 1) * 8 + (lane & 7);

  for (int ch = 0; ch < w.n_chunks; ++ch) {
    if (ch + 1 < w.n_chunks) {
      load_kv(ch + 1, (ch + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (W <= 128) {
      if (ch == 0) {
#pragma unroll
        for (int kt = 0; kt < W / 16; ++kt) {
          if (kt * 16 >= D) break;
          ldmatrix_x4(qa[kt],
                      smem_u32(q_s + qr * LDS + kt * 16 + (mi >> 1) * 8));
        }
      }
    }
    const __nv_bfloat16* kb = k_s + (ch & 1) * KC * LDS;
    const __nv_bfloat16* vb = v_s + (ch & 1) * KC * LDS;

    // S = Q Kᵀ for this warp's 16 rows and the chunk's KC keys
    float s[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < W / 16; ++kt) {
      if (kt * 16 >= D) break;       // k-steps wholly past D
      if constexpr (W > 128)
        ldmatrix_x4(qa[0], smem_u32(q_s + qr * LDS + kt * 16 + (mi >> 1) * 8));
      constexpr int one = W > 128 ? 0 : 1;   // qa[kt], or qa[0] reloaded
#pragma unroll
      for (int np = 0; np < KC / 16; ++np) {
        const int key = np * 16 + (mi >> 1) * 8 + (lane & 7);
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(kb + key * LDS + kt * 16 + (mi & 1) * 8));
        mma_bf16(s[2 * np], qa[kt * one], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kt * one], b[2], b[3]);
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
    for (int j = 0; j < W / 8; ++j) {
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
      for (int dp = 0; dp < W / 16; ++dp) {
        if (dp * 16 >= D) break;     // columns wholly past D
        const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(vb + key * LDS + dp * 16 + (mi >> 1) * 8));
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next load overwrites this chunk's buffer
  }

  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    if (j * 8 >= D) break;            // the real columns only
    const int col = j * 8 + 2 * t;
    if (qrow_a < w.rend)
      *reinterpret_cast<uint32_t*>(o + (w.q_base + qrow_a) * D + col) =
          pack_bf16(acc[j][0] * inv_a, acc[j][1] * inv_a);
    if (qrow_b < w.rend)
      *reinterpret_cast<uint32_t*>(o + (w.q_base + qrow_b) * D + col) =
          pack_bf16(acc[j][2] * inv_b, acc[j][3] * inv_b);
  }
}

// -- bf16, 128- and 64-row tiles: wgmma fed by TMA ----------------------------

constexpr int kStages = 2;        // K/V ring depth
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int W, int NCW>
struct WgCfg {
  static constexpr int BM = 64 * NCW;              // query rows per CTA
  // keys per K/V tile: 128, 64 at width 256 (Q and a two-stage ring of
  // 128-key tiles would not fit)
  static constexpr int BN = W == 256 ? 64 : 128;
  static constexpr int kPanels = W / 64;           // 64-column TMA boxes
  static constexpr int kThreads = 128 * (NCW + 1);
  static constexpr int kQBytes = BM * W * 2;
  static constexpr int kTileBytes = BN * W * 2;    // one K (or V) tile
  // 1024 of alignment slack (the swizzled tiles need 1024-byte bases),
  // Q, the ring, and the mbarriers
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 4 * kStages);
};

template <int W, int NCW, bool kFull>
__global__ void __launch_bounds__(128 * (NCW + 1), 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, Params p) {
  using C = WgCfg<W, NCW>;
  constexpr int BM = C::BM, BN = C::BN, TB = C::kTileBytes;
  const int D = kFull ? W : p.D;
  Work w;
  if (!cta_work(p, BM, BN, w)) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_s = q_s + C::kQBytes;        // [stage][panel][BN][64]
  unsigned char* v_s = k_s + kStages * TB;      // [stage][panel][BN][64]
  // K and V of a stage fill and drain apart: K is free once S has been
  // computed, V once P·V has
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * TB);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int bh = blockIdx.x;
  const int hk = (bh % p.Hq) / (p.Hq / p.Hkv);
  const int bkv = (bh / p.Hq) * p.Hkv + hk;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], NCW);   // one arrival per consumer warpgroup
      mbar_init(&v_empty[s], NCW);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCW) {
    // producer: one thread keeps the ring full
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == NCW * 128) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int pn = 0; pn < C::kPanels; ++pn)
        tma_load_3d(q_s + pn * BM * 128, &tm_q, pn * 64, w.r0, bh, q_full);
      for (int it = 0; it < w.n_chunks; ++it) {
        const int st = it % kStages, ph = (it / kStages) & 1;
        mbar_wait(&k_empty[st], ph ^ 1);
        mbar_expect_tx(&k_full[st], TB);
#pragma unroll
        for (int pn = 0; pn < C::kPanels; ++pn)
          tma_load_3d(k_s + st * TB + pn * BN * 128, &tm_k, pn * 64,
                      it * BN, bkv, &k_full[st]);
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_expect_tx(&v_full[st], TB);
#pragma unroll
        for (int pn = 0; pn < C::kPanels; ++pn)
          tma_load_3d(v_s + st * TB + pn * BN * 128, &tm_v, pn * 64,
                      it * BN, bkv, &v_full[st]);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows [wg·64, wg·64 + 64) of the tile
  reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = w.r0 + wg * 64;
  const int qrow_a = wg_row0 + warp * 16 + g, qrow_b = qrow_a + 8;
  const float sl2 = p.scale * kLog2e;
  const unsigned char* q_wg = q_s + wg * 64 * 128;

  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  // running max in log2 units; l is this thread's share of its rows' sum
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  mbar_wait(q_full, 0);

  for (int it = 0; it < w.n_chunks; ++it) {
    const int st = it % kStages, ph = (it / kStages) & 1;
    const unsigned char* kt_s = k_s + st * TB;
    const unsigned char* vt_s = v_s + st * TB;

    // S = Q Kᵀ, 64 rows x BN keys, over the 16-column k-steps that hold
    // real columns (zeros past D)
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    mbar_wait(&k_full[st], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      if (kk * 16 >= D) break;
      const int pn = kk / 4, off = (kk % 4) * 32;
      const uint64_t dq = desc_sw128(q_wg + pn * BM * 128 + off, 16, 1024);
      const uint64_t dk = desc_sw128(kt_s + pn * BN * 128 + off, 16, 1024);
      if constexpr (BN == 128)
        wgmma_m64n128k16_ss(s, dq, dk, 1);
      else
        wgmma_m64n64k16_ss(s, dq, dk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    if (tid == 0) mbar_arrive(&k_empty[st]);   // K of this stage is read

    // online softmax in log2 units, s becoming p (rounded to bf16 below
    // against this tile's running max).  A tile that crosses the causal
    // diagonal or the Skv edge is masked element by element; any other
    // takes its max on the raw scores and one FFMA and one exp2 a score.
    const int k0 = it * BN;
    const bool masked =
        k0 + BN > p.Skv || (p.causal && k0 + BN - 1 > wg_row0);
    float mx_a = kNegInf, mx_b = kNegInf, sum_a = 0.f, sum_b = 0.f;
    float al_a, al_b;
    if (!masked) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
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
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j] = exp2f(fmaf(s[4 * j], sl2, -mn_a));
        s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl2, -mn_a));
        s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl2, -mn_b));
        s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl2, -mn_b));
        sum_a += s[4 * j] + s[4 * j + 1];
        sum_b += s[4 * j + 2] + s[4 * j + 3];
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * sl2;
          if (!admitted(p, e < 2 ? qrow_a : qrow_b,
                        k0 + j * 8 + 2 * t + (e & 1)))
            x = kNegInf;
          s[4 * j + e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      al_a = exp2f(m_a - mn_a);
      al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
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

    // P rounded to bf16 (the TPU kernel's p.astype(v.dtype)), as the
    // register A operand: k-step kk holds keys [16kk, 16kk + 16)
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V
    mbar_wait(&v_full[st], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = desc_sw128(vt_s + kk * 2048, BN * 128, 1024);
      if constexpr (W == 256)
        wgmma_m64n256k16_rs_tb(o, pa[kk], dv, 1);
      else if constexpr (W == 128)
        wgmma_m64n128k16_rs_tb(o, pa[kk], dv, 1);
      else
        wgmma_m64n64k16_rs_tb(o, pa[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    if (tid == 0) mbar_arrive(&v_empty[st]);   // V of this stage is read
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    if (j * 8 >= D) break;            // the real columns only
    const int col = j * 8 + 2 * t;
    if (qrow_a < w.rend)
      *reinterpret_cast<uint32_t*>(out + (w.q_base + qrow_a) * D + col) =
          pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (qrow_b < w.rend)
      *reinterpret_cast<uint32_t*>(out + (w.q_base + qrow_b) * D + col) =
          pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
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

template <int W, int TM>
struct F32Cfg {
  static constexpr int kThreads = 4 * TM;  // 16 per group of 4 rows
  static constexpr int KC = kChunkF32;
  static constexpr int LD = W + 1;         // rows of W, zero past D
  static constexpr int LP = KC + 1;
  static constexpr int kSmem = ((TM + 2 * KC) * LD + TM * LP) * 4;  // bytes
};

template <int W, int TM, bool kFull>
__global__ void __launch_bounds__(4 * TM)
fa_f32_kernel(Params p) {
  using C = F32Cfg<W, TM>;
  constexpr int KC = C::KC, LD = C::LD, LP = C::LP, NT = C::kThreads;
  constexpr int DC = W / 16;  // accumulator columns per thread
  const int D = kFull ? W : p.D;
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

  // rows staged at the width W, zeros past D (they add nothing)
  for (int i = tid; i < TM * W; i += NT) {
    const int r = i / W, c = i % W, row = w.r0 + r;
    q_s[r * LD + c] =
        row < w.rend && c < D ? q[(w.q_base + row) * D + c] : 0.f;
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
    for (int i = tid; i < KC * W; i += NT) {
      const int r = i / W, c = i % W, key = k0 + r;
      const bool ok = key < p.Skv && c < D;
      const size_t src = (w.kv_base + (ok ? key : 0)) * D + (ok ? c : 0);
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
        if (16 * c >= D) break;      // columns wholly past D
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
        if (tx + 16 * c < D)
          o[(w.q_base + row) * D + tx + 16 * c] = acc[i][c] / l;
    }
  }
}

// -- launch ------------------------------------------------------------------

template <typename Kern, typename... Args>
int launch_kernel(Kern kern, int smem, int threads, dim3 grid,
                  cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int W, int NCW, bool kFull>
int launch_wgmma(int B, dim3 grid, const Params& p, cudaStream_t s) {
  using C = WgCfg<W, NCW>;
  CUtensorMap tq, tk, tv;
  int e = encode_tensor_map_3d(&tq, p.q, p.D, p.Sq, (uint64_t)B * p.Hq, C::BM);
  if (!e) e = encode_tensor_map_3d(&tk, p.k, p.D, p.Skv, (uint64_t)B * p.Hkv, C::BN);
  if (!e) e = encode_tensor_map_3d(&tv, p.v, p.D, p.Skv, (uint64_t)B * p.Hkv, C::BN);
  if (e) return e;
  return launch_kernel(fa_wgmma_kernel<W, NCW, kFull>, C::kSmem, C::kThreads,
                       grid, s, tq, tk, tv, p);
}

template <int W, bool kFull>
int launch_tile(int tile, int is_bf16, int B, dim3 grid, const Params& p,
                cudaStream_t s) {
  if (is_bf16) {
    switch (tile) {
      case 16: return launch_kernel(fa_bf16_kernel<W, 1, kFull>, Bf16Cfg<W, 1>::kSmem, 32, grid, s, p);
      case 32: return launch_kernel(fa_bf16_kernel<W, 2, kFull>, Bf16Cfg<W, 2>::kSmem, 64, grid, s, p);
      case 64: return launch_wgmma<W, 1, kFull>(B, grid, p, s);
      case 128: return launch_wgmma<W, 2, kFull>(B, grid, p, s);
    }
  } else {
    switch (tile) {
      case 16: return launch_kernel(fa_f32_kernel<W, 16, kFull>, F32Cfg<W, 16>::kSmem, 64, grid, s, p);
      case 32: return launch_kernel(fa_f32_kernel<W, 32, kFull>, F32Cfg<W, 32>::kSmem, 128, grid, s, p);
      case 64: return launch_kernel(fa_f32_kernel<W, 64, kFull>, F32Cfg<W, 64>::kSmem, 256, grid, s, p);
      case 128: return launch_kernel(fa_f32_kernel<W, 128, kFull>, F32Cfg<W, 128>::kSmem, 512, grid, s, p);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// the compile-time instance where head_dim is the width itself
template <int W>
int launch_w(int tile, int is_bf16, int B, dim3 grid, const Params& p,
             cudaStream_t s) {
  return p.D == W ? launch_tile<W, true>(tile, is_bf16, B, grid, p, s)
                  : launch_tile<W, false>(tile, is_bf16, B, grid, p, s);
}

// -- the panel route: any other head_dim --------------------------------------

// The CTA's rows and key walk as cta_work's, at the route's own tile.
template <typename T>
struct FlashRows {
  const T *q, *k, *v;
  T* o;
  int D, n_keys, grain;
  float scale;
  int Hq, Hkv, Sq, bq, cps, causal, skip;
  size_t q_base, kv_base;

  __device__ __forceinline__ bool begin(int tile, int kc, int& r0, int& rend,
                                        int& n_chunks) {
    const int bh = blockIdx.x;
    const int y = gridDim.y - 1 - blockIdx.y;
    const int qi = y / cps, sub = y % cps;
    r0 = qi * bq + sub * tile;
    rend = min(min(qi * bq + bq, r0 + tile), Sq);
    if (r0 >= rend) return false;
    const int b = bh / Hq, h = bh % Hq;
    q_base = (size_t)bh * Sq;
    kv_base = ((size_t)b * Hkv + h / (Hq / Hkv)) * n_keys;
    n_chunks = (n_keys + kc - 1) / kc;
    if (causal && skip) n_chunks = min(n_chunks, (rend - 1) / kc + 1);
    return true;
  }
  __device__ __forceinline__ bool live(int, int) const { return true; }
  __device__ __forceinline__ bool admit(int row, int key) const {
    return !causal || row >= key;
  }
  __device__ __forceinline__ long long q_off(int row) const {
    return (long long)(q_base + row) * D;
  }
  __device__ __forceinline__ long long kv_off(int key) const {
    return (long long)(kv_base + key) * D;
  }
};

template <typename T>
FlashRows<T> flash_rows(const Params& p, int tile, int grain) {
  FlashRows<T> r;
  r.q = static_cast<const T*>(p.q);
  r.k = static_cast<const T*>(p.k);
  r.v = static_cast<const T*>(p.v);
  r.o = static_cast<T*>(p.o);
  r.D = p.D;
  r.n_keys = p.Skv;
  r.grain = grain;
  r.scale = p.scale;
  r.Hq = p.Hq;
  r.Hkv = p.Hkv;
  r.Sq = p.Sq;
  r.bq = p.bq;
  r.cps = (p.bq + tile - 1) / tile;
  r.causal = p.causal;
  r.skip = p.skip;
  return r;
}

template <int PW>
int launch_panel(int is_bf16, int B, const Params& p, cudaStream_t s) {
  const void* ptrs[4] = {p.q, p.k, p.v, p.o};
  const int es = is_bf16 ? 2 : 4;
  const int grain = panel::copy_grain((long long)p.D * es, ptrs, 4, es);
  const int tile = is_bf16 ? panel::kPrefillRows : panel::kPrefillRowsF;
  const long long nq = (p.Sq + p.bq - 1) / p.bq, cps = (p.bq + tile - 1) / tile;
  if (nq * cps > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * p.Hq, (unsigned)(nq * cps), panel::n_panels(p.D));
  return is_bf16 ? panel::launch_prefill<PW, false>(
                       flash_rows<uint16_t>(p, tile, grain), grid, s)
                 : panel::launch_prefill<PW, false>(
                       flash_rows<float>(p, tile, grain), grid, s);
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), o (B, Hq, Sq, D); contiguous, on
// one device, all bf16 (is_bf16) or all f32; any D >= 1.  Where D is a
// multiple of 8 in bf16 (of 4 in f32) up to 256 (the on-grain instances):
// 16-byte aligned, tile in {16, 32, 64, 128} query rows per CTA; any other
// D runs on the panel route (aligned to the element, its own tile).
// block_q is the config's query block (a multiple of tile, or smaller than
// it).  Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      int block_q, int tile, int causal,
                                      int skip, float scale, int is_bf16,
                                      void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      block_q <= 0 || tile <= 0 || D <= 0)
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
  p.D = D;
  p.bq = block_q;
  p.cps = (block_q + tile - 1) / tile;
  p.causal = causal;
  p.skip = skip;
  p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (panel::off_grain(D, is_bf16))
    return D <= 64 ? launch_panel<64>(is_bf16, B, p, s)
                   : launch_panel<256>(is_bf16, B, p, s);
  const long long nq = (Sq + block_q - 1) / block_q;
  if (nq * p.cps > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * Hq, (unsigned)(nq * p.cps));
  if (D <= 64) return launch_w<64>(tile, is_bf16, B, grid, p, s);
  if (D <= 128) return launch_w<128>(tile, is_bf16, B, grid, p, s);
  return launch_w<256>(tile, is_bf16, B, grid, p, s);
}
