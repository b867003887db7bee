// K1 and K4: mask-free multi-head attention forward for Hopper (sm_90a), bf16.
//
// Replaces two Pallas TPU kernels of hippomm_tpu/ops/flash_attention.py:
//   * K1 `_mha_kernel` (reached through `flash_mha`): q/k/v in the
//     head-split (B, H, T, hd) layout;
//   * K4 `_mha_kernel_bthd` (reached through `flash_mha_bthd`): q/k/v in the
//     native (B, T, H, hd) layout the QKV projection's reshape produces, so
//     the caller needs neither the three head-split transposes nor the
//     output merge.
// Both are one kernel here over element strides: TMA reads row t of head h of
// batch b at b·s_b + h·s_h + t·s_t through a 4-D tensor map (hd, T, H, B).
// K1 passes the strides of a contiguous (B, H, T, hd) tensor; K4 those of a
// (B, T, H, hd) view, whose row stride is H·hd for a (B, T, D) tensor and 3·D
// for a slice of a packed (B, T, 3D) projection — a view, never a copy. Per
// (batch, head) it computes softmax(q·kᵀ·scale) in fp32 → bf16 weights → ·v
// with fp32 accumulation → bf16 output; the (Tq, Tk) logits never leave
// registers.
//
// Bound on the H100 (bytes once at 3.35 TB/s against 4·Tq·Tk·hd flops at
// 989 TF/s): vision (32, 16, 257, 257, 80) and audio (96, 12, 229, 230, 64)
// are bound by bytes (0.025 and 0.040 ms, ~130 flops per byte); Whisper's
// encoder (4, 20, 1500, 1500, 64) by operations (0.047 ms). At hd 64 a logit
// costs 256 tensor flops and one exponential; the SFU retires ~16 of those
// per clock per SM, so Whisper's 180 M exponentials take about as long as its
// products (~0.045 ms): they have to run under the tensor cores' work.
//
// Design (FlashAttention-3's shape): a persistent, warp-specialised block per
// SM walks work tiles of 128 query rows of one head (consecutive work tiles
// are the same head's query tiles, so the blocks that run together share its
// K/V in the L2 and device memory serves each head's K/V about once).
//   * Producer: one thread issues TMA loads (cp.async.bulk.tensor): each work
//     tile's Q into one of two Q buffers, then its K and V tiles into a ring
//     of 2-4 stages, K and V with their own full/empty mbarriers. Rows past
//     Tq and keys past Tk of the head are zero-filled by TMA.
//   * Consumers: two warpgroups, 64 query rows each of the same work tile,
//     reading the same K/V stages. Per key tile j a warpgroup issues
//     S_j = Q·K_jᵀ (wgmma, both operands K-major from shared memory) together
//     with O += P_{j−1}·V_{j−1} (wgmma with P as the A operand from
//     registers: the fp32 S accumulator's layout is the bf16 A fragment's, so
//     P never leaves registers; V is the MN-major B operand, the transpose
//     bit). Then, while those run, the online softmax of S_j in registers:
//     row max, rescale factor, exponentials, row sums.
//   * Ping-pong: the two warpgroups issue their products in turns (named
//     barriers), so one warpgroup's softmax runs while the other's products
//     keep the tensor cores busy.
//   * setmaxnreg moves registers from the producer (24) to the consumers
//     (240): S (64 fp32), O (hd/2 fp32) and P (32 × bf16x2) of a 64 × 128
//     tile live in a consumer's registers.
// Key tiles, chosen by the wrapper (ops/flash_attention._attn_plan): 128 keys
// each; a last remainder of at most 16 keys takes a 16-key tile (S of
// m64n16, one k-step of P·V) instead of a mostly empty 128-key one. Vision's
// 257 keys are 128 + 128 + 16, audio's 230 128 + 128 (102 real), Whisper's
// 1500 twelve of 128 (the last 92 real). Keys at and past Tk get a −inf
// logit (TMA's zero fill gives 0, not −inf).
//
// hd panels: a wgmma shared-memory operand has rows of one swizzle width, at
// most 128 bytes (64 bf16), so every tile is stored as hd/64 panels of 64
// columns (128B swizzle) plus a panel for the rest: 16 columns with a 32B
// swizzle (hd 80 = 64 + 16), 32 with 64B, or 48 stored 64 wide with TMA
// zero-filling columns 48-63. Each panel is its own TMA box; S issues only
// the k-steps that carry data (5 at hd 80, 4 at hd 64); P·V issues one
// product per panel, N = its width.
//
// Numerics: exponentials are exp2 of logits pre-scaled by scale·log2(e),
// folded with the max subtraction into one FFMA (ex2.approx, a few fp32 ulp
// from expf before P is rounded to bf16). The TPU bodies normalise the
// weights before the bf16 cast; the online softmax casts the unnormalised
// exp(s − m) and divides the fp32 output at the end (the TPU kernel's
// `defer_div` body). The two differ by ≤ 1 bf16 ulp.
//
// Requirements (checked by the wrappers): hd a multiple of 16 and at most 128
// (the wrappers pad); every stride a multiple of 8 elements and every base
// 16-byte aligned (TMA).

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;      // query rows per work tile: two consumer warpgroups × 64
constexpr int kBN = 128;      // keys per key tile
constexpr int kTail = 16;     // keys of the short last tile
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBudget = 200 * 1024;  // shared memory for the Q buffers and the K/V ring
constexpr int kMaxStages = 4;

// hd panels (see the note above); panel p's offset in a tile of `rows` rows
// is rows · 128 · p bytes, since every panel before the last is 64 wide
template <int HD>
struct Panels {
  static constexpr int kFull = HD / 64;               // 64-column panels
  static constexpr int kRem = HD % 64;                // columns of the last panel: 0, 16, 32, 48
  static constexpr int kRemW = kRem == 48 ? 64 : kRem;  // its stored width
  static constexpr int kStored = kFull * 64 + kRemW;  // stored columns per row
};

template <int HD>
struct Layout {
  static constexpr int kQTile = kBM * Panels<HD>::kStored * 2;
  static constexpr int kKTile = kBN * Panels<HD>::kStored * 2;
  static constexpr int kStages =
      (kBudget - 2 * kQTile) / (2 * kKTile) < kMaxStages ? (kBudget - 2 * kQTile) / (2 * kKTile)
                                                         : kMaxStages;
  static_assert(kStages >= 2, "the K/V ring needs two stages");
  // Q buffers, K stages, V stages, then the barriers: q full/empty (2 each),
  // k full/empty, v full/empty (kStages each)
  static constexpr int kK = 2 * kQTile;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBars = kV + kStages * kKTile;
  static constexpr int kBytes = kBars + 8 * (4 + 4 * kStages) + 1024;  // + 1024-byte alignment slack
};

struct AttnArgs {
  int h, tq, tk;
  int nqb;          // 128-row query tiles per head
  int n_full;       // 128-key tiles
  int tail;         // 1: a 16-key tile after them
  int work;         // work tiles: B · H · nqb
  float scale_log2; // scale · log2(e)
  __nv_bfloat16* o;
  int64_t so_b, so_h, so_t;  // output element strides
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// one tile of `rows` rows from (row0, head, batch), every panel, into dst
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* main, const CUtensorMap* rem,
                                          int rows, int row0, int hh, int bb, uint32_t bar) {
  using P = Panels<HD>;
#pragma unroll
  for (int p = 0; p < P::kFull; ++p) tma_load_4d(dst + rows * 128 * p, main, 64 * p, row0, hh, bb, bar);
  if constexpr (P::kRem != 0) {
    // a 48-column rest is boxed 64 wide through the main map (zero-filled)
    tma_load_4d(dst + rows * 128 * P::kFull, P::kRemW == 64 ? main : rem, 64 * P::kFull, row0, hh,
                bb, bar);
  }
}

// grid: one block per SM (at most one per work tile); work tile w is query
// tile w % nqb of head (w / nqb) % H of batch w / (nqb · H)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_mha_kernel(const __grid_constant__ CUtensorMap q_main, const __grid_constant__ CUtensorMap q_rem,
                 const __grid_constant__ CUtensorMap k_main, const __grid_constant__ CUtensorMap k_rem,
                 const __grid_constant__ CUtensorMap v_main, const __grid_constant__ CUtensorMap v_rem,
                 const AttnArgs args) {
  using P = Panels<HD>;
  using L = Layout<HD>;
  constexpr int kStages = L::kStages;
  constexpr int kRemSw = 2 * P::kRemW;  // swizzle bytes of the last panel
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBars, q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16, k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages, v_empty = v_full + 8 * kStages;
  const int n_tiles = args.n_full + args.tail;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 4 * kConsumers);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * kConsumers);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread keeps the Q buffers and the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      int slot = 0, it = 0;
      for (int w = blockIdx.x; w < args.work; w += gridDim.x, ++it) {
        const int qt = w % args.nqb, bh = w / args.nqb, hh = bh % args.h, bb = bh / args.h;
        const int qb = it & 1;
        mbar_wait(q_empty + 8 * qb, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, L::kQTile);
        load_tile<HD>(base + qb * L::kQTile, &q_main, &q_rem, kBM, qt * kBM, hh, bb, q_full + 8 * qb);
        for (int j = 0; j < n_tiles; ++j, ++slot) {
          const int s = slot % kStages;
          const uint32_t ph = ((slot / kStages) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, ph);
          mbar_expect_tx(k_full + 8 * s, L::kKTile);
          load_tile<HD>(base + L::kK + s * L::kKTile, &k_main, &k_rem, kBN, j * kBN, hh, bb,
                        k_full + 8 * s);
          mbar_wait(v_empty + 8 * s, ph);
          mbar_expect_tx(v_full + 8 * s, L::kKTile);
          load_tile<HD>(base + L::kV + s * L::kKTile, &v_main, &v_rem, kBN, j * kBN, hh, bb,
                        v_full + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, q4 = lane % 4;  // accumulator rows g, g + 8; column pair q4
    const bool signal = lane == 0;
    const float sl2 = args.scale_log2;

    float s[kBN / 2];                        // S of a 128-key tile (m64n128 accumulator)
    float s16[kTail / 2];                    // S of the 16-key tail
    uint32_t pa[kBN / 4];                    // P as bf16 A fragments, 4 registers per k16 step
    float o_full[P::kFull > 0 ? P::kFull : 1][32];  // O, one m64n64 accumulator per full panel
    float o_rem[P::kRemW > 0 ? P::kRemW / 2 : 1];   // O of the last panel
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

    // O += P·V over the N keys of V stage vs
    auto issue_pv = [&](auto n_tag, int vs) {
      constexpr int N = decltype(n_tag)::value;
      const uint32_t vb = base + L::kV + vs * L::kKTile;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t(&a)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&pa[4 * kk]);
#pragma unroll
        for (int p = 0; p < P::kFull; ++p)
          wgmma_rs<64>(o_full[p], a, desc_mn<128>(vb + kBN * 128 * p + kk * 16 * 128));
        if constexpr (P::kRem != 0)
          wgmma_rs<P::kRemW>(o_rem, a, desc_mn<kRemSw>(vb + kBN * 128 * P::kFull + kk * 16 * kRemSw));
      }
    };
    // S = Q·Kᵀ for this warpgroup's 64 rows against K stage ks (N keys)
    auto issue_s = [&](auto& acc, auto n_tag, uint32_t qa, int ks) {
      constexpr int N = decltype(n_tag)::value;
      const uint32_t kb = base + L::kK + ks * L::kKTile;
#pragma unroll
      for (int p = 0; p < P::kFull; ++p) {
        const uint64_t da = desc_k<128>(qa + kBM * 128 * p + 64 * wg * 128);
        const uint64_t db = desc_k<128>(kb + kBN * 128 * p);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<N>(acc, da + 2 * kk, db + 2 * kk, p + kk > 0);
      }
      if constexpr (P::kRem != 0) {
        const uint64_t da = desc_k<kRemSw>(qa + kBM * 128 * P::kFull + 64 * wg * kRemSw);
        const uint64_t db = desc_k<kRemSw>(kb + kBN * 128 * P::kFull);
#pragma unroll
        for (int kk = 0; kk < P::kRem / 16; ++kk)
          wgmma_ss<N>(acc, da + 2 * kk, db + 2 * kk, P::kFull + kk > 0);
      }
    };
    // online softmax of S over keys key0 .. key0 + N: masks keys at and past
    // tk, updates m and l, leaves exp2((s − m)·scale·log2 e) in acc and the
    // rescale factor of the rows' earlier output in alpha
    // Row maxima and sums are taken over 4 independent partials a row, so
    // that their dependent chains are 8 long, not 32: a softmax warp has no
    // other warp of its sub-partition to hide its latency behind.
    auto softmax = [&](auto& acc, auto n_tag, int key0, float (&alpha)[2]) {
      constexpr int N = decltype(n_tag)::value;
      if (key0 + N > args.tk) {  // the ragged tile
#pragma unroll
        for (int n = 0; n < N / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + 8 * n + 2 * q4 + (e & 1) >= args.tk) acc[4 * n + e] = -INFINITY;
        }
      }
      // acc[4n + 2h + e] is row h, partial (n % 2)·2 + e
      float mx[2][4], rs[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mx[h][i] = -INFINITY;
          rs[h][i] = 0.0f;
        }
      }
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& part = mx[e >> 1][(n & 1) * 2 + (e & 1)];
          part = fmaxf(part, acc[4 * n + e]);
        }
      }
      float neg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float row = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
        row = fmaxf(row, __shfl_xor_sync(0xffffffffu, row, 1));
        row = fmaxf(row, __shfl_xor_sync(0xffffffffu, row, 2));
        const float m_new = fmaxf(m[h], row);  // finite: every tile holds a real key
        alpha[h] = ex2((m[h] - m_new) * sl2);  // 0 on the first tile (m = −inf)
        m[h] = m_new;
        neg[h] = -m_new * sl2;
      }
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(acc[4 * n + e], sl2, neg[e >> 1]));
          acc[4 * n + e] = p;
          rs[e >> 1][(n & 1) * 2 + (e & 1)] += p;
        }
      }
      // l stays a per-thread partial sum (its quad is summed at the end)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = l[h] * alpha[h] + ((rs[h][0] + rs[h][1]) + (rs[h][2] + rs[h][3]));
    };
    auto fence_o = [&] {
#pragma unroll
      for (int p = 0; p < P::kFull; ++p) fence_acc(o_full[p]);
      if constexpr (P::kRem != 0) fence_acc(o_rem);
    };
    // every register a product reads or writes, fenced before the
    // wgmma.fence that opens a section
    auto open_section = [&] {
      fence_acc(s);
      fence_acc(s16);
      fence_o();
      fence_regs(pa);
      wgmma_fence();
    };
    auto rescale_o = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int p = 0; p < P::kFull; ++p) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o_full[p][i] *= alpha[(i >> 1) & 1];
      }
      if constexpr (P::kRem != 0) {
#pragma unroll
        for (int i = 0; i < P::kRemW / 2; ++i) o_rem[i] *= alpha[(i >> 1) & 1];
      }
    };
    auto pack_p = [&](const auto& acc, auto n_tag) {
      constexpr int N = decltype(n_tag)::value;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        pa[4 * kk] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
        pa[4 * kk + 1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
        pa[4 * kk + 2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
        pa[4 * kk + 3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
      }
    };
    // One turn of the ping-pong: S of the key tile in slot `slot` (SN keys,
    // none when 0) and P·V of the previous tile (PN keys, none when 0) are
    // issued together, then the softmax of S runs while the other
    // warpgroup's products do. Each section's shape is fixed at compile
    // time: a wgmma issued on a data-dependent path makes ptxas serialize
    // the kernel's products (C7520).
    int slot = 0, prev_stage = 0;
    auto section = [&](auto sn_tag, auto pn_tag, uint32_t qa, int key0, bool last_s, int qb) {
      constexpr int SN = decltype(sn_tag)::value, PN = decltype(pn_tag)::value;
      auto& acc = [&]() -> auto& {
        if constexpr (SN == kTail) {
          return s16;
        } else {
          return s;
        }
      }();
      const int st = slot % kStages;
      const uint32_t ph = (slot / kStages) & 1;
      if constexpr (SN > 0) mbar_wait(k_full + 8 * st, ph);
      named_barrier_sync(kTurnBarrier + wg);
      open_section();
      if constexpr (SN > 0) {
        issue_s(acc, sn_tag, qa, st);
        wgmma_commit();
      }
      if constexpr (PN > 0) {
        issue_pv(pn_tag, prev_stage);
        wgmma_commit();
      }
      named_barrier_arrive(kTurnBarrier + (wg ^ 1));
      float alpha[2];
      if constexpr (SN > 0) {
        wgmma_wait<(PN > 0 ? 1 : 0)>();
        fence_acc(acc);
        if (signal) {
          mbar_arrive(k_empty + 8 * st);
          if (last_s) mbar_arrive(q_empty + 8 * qb);
        }
        softmax(acc, sn_tag, key0, alpha);
      }
      if constexpr (PN > 0) {
        wgmma_wait<0>();
        fence_o();
        fence_regs(pa);
        if (signal) mbar_arrive(v_empty + 8 * prev_stage);
      }
      if constexpr (SN > 0) {
        rescale_o(alpha);
        pack_p(acc, sn_tag);
        prev_stage = st;
        ++slot;
        mbar_wait(v_full + 8 * st, ph);
      }
    };
    const std::integral_constant<int, 0> none{};
    const std::integral_constant<int, kBN> wide{};
    const std::integral_constant<int, kTail> narrow{};

    if (wg == 1) named_barrier_arrive(kTurnBarrier);  // warpgroup 0 takes the first turn
    int it = 0;
    for (int w = blockIdx.x; w < args.work; w += gridDim.x, ++it) {
      const int qt = w % args.nqb, bh = w / args.nqb, hh = bh % args.h, bb = bh / args.h;
      const int qb = it & 1;
      const uint32_t qa = base + qb * L::kQTile;
#pragma unroll
      for (int p = 0; p < P::kFull; ++p) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o_full[p][i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < (P::kRemW > 0 ? P::kRemW / 2 : 1); ++i) o_rem[i] = 0.0f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.0f;
      mbar_wait(q_full + 8 * qb, (it >> 1) & 1);

      // n_full 128-key tiles, then the 16-key tail if any: S_0; S_j with
      // P·V_{j−1}; the last P·V
      const int nf = args.n_full;
      if (nf == 0) {
        section(narrow, none, qa, 0, true, qb);
        section(none, narrow, qa, 0, false, qb);
      } else {
        section(wide, none, qa, 0, nf == 1 && !args.tail, qb);
        for (int j = 1; j < nf; ++j) section(wide, wide, qa, j * kBN, j == nf - 1 && !args.tail, qb);
        if (args.tail) {
          section(narrow, wide, qa, nf * kBN, true, qb);
          section(none, narrow, qa, 0, false, qb);
        } else {
          section(none, wide, qa, 0, false, qb);
        }
      }

      // epilogue: O / l in bf16, rows below tq only; o[4j + 2h + e] is row
      // 16·warp + g + 8h, column 8j + 2·q4 + e of its panel
      __nv_bfloat16* out = args.o + bb * args.so_b + hh * args.so_h;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = l[h];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.0f / sum;
        const int row = qt * kBM + 64 * wg + 16 * warp + g + 8 * h;
        if (row >= args.tq) continue;
        __nv_bfloat16* orow = out + row * args.so_t + 2 * q4;
#pragma unroll
        for (int p = 0; p < P::kFull; ++p) {
#pragma unroll
          for (int jn = 0; jn < 8; ++jn)
            *reinterpret_cast<uint32_t*>(orow + 64 * p + 8 * jn) =
                pack_bf16(o_full[p][4 * jn + 2 * h] * inv, o_full[p][4 * jn + 2 * h + 1] * inv);
        }
        if constexpr (P::kRem != 0) {
#pragma unroll
          for (int jn = 0; jn < P::kRem / 8; ++jn)
            *reinterpret_cast<uint32_t*>(orow + 64 * P::kFull + 8 * jn) =
                pack_bf16(o_rem[4 * jn + 2 * h] * inv, o_rem[4 * jn + 2 * h + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// element strides of one operand: batch, head, row (the hd axis is contiguous)
struct Strides {
  int64_t b, h, t;
};

// (hd, T, H, B) map of one operand: boxes of `box_cols` columns (the
// swizzle width) × `rows` rows of one head; columns past hd and rows past T
// read as zeros
int make_map(CUtensorMap* map, const void* base, int hd, int t, int h, int b, Strides st,
             int box_cols, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kMapError;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)t, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st.t * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// the main (64-column) and last-panel maps of one operand
template <int HD>
int make_maps(CUtensorMap (&maps)[2], const void* base, int t, int h, int b, Strides st, int rows) {
  using P = Panels<HD>;
  int rc = make_map(&maps[0], base, HD, t, h, b, st, 64, rows);
  if (rc == 0 && (P::kRemW == 16 || P::kRemW == 32))
    rc = make_map(&maps[1], base, HD, t, h, b, st, P::kRemW, rows);
  else
    maps[1] = maps[0];
  return rc;
}

struct Call {
  const void *q, *k, *v;
  void* o;
  int b, h, tq, tk, n_full, tail;
  float scale;
  Strides sq, sk, sv, so;
};

template <int HD>
int launch(const Call& c, cudaStream_t stream) {
  static bool sized[kMaxDevices] = {};  // the kernel's shared memory, set once per device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int sms = sm_count(dev);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  CUtensorMap qm[2], km[2], vm[2];
  int rc = make_maps<HD>(qm, c.q, c.tq, c.h, c.b, c.sq, kBM);
  if (rc == 0) rc = make_maps<HD>(km, c.k, c.tk, c.h, c.b, c.sk, kBN);
  if (rc == 0) rc = make_maps<HD>(vm, c.v, c.tk, c.h, c.b, c.sv, kBN);
  if (rc != 0) return rc;
  if (!sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mha_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<HD>::kBytes);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  AttnArgs args;
  args.h = c.h;
  args.tq = c.tq;
  args.tk = c.tk;
  args.nqb = (c.tq + kBM - 1) / kBM;
  args.n_full = c.n_full;
  args.tail = c.tail;
  const int64_t work = (int64_t)c.b * c.h * args.nqb;
  if (work > INT32_MAX) return (int)cudaErrorInvalidValue;
  args.work = (int)work;
  args.scale_log2 = (float)((double)c.scale * 1.4426950408889634);
  args.o = static_cast<__nv_bfloat16*>(c.o);
  args.so_b = c.so.b;
  args.so_h = c.so.h;
  args.so_t = c.so.t;
  flash_mha_kernel<HD><<<args.work < sms ? args.work : sms, kThreads, Layout<HD>::kBytes, stream>>>(
      qm[0], qm[1], km[0], km[1], vm[0], vm[1], args);
  return (int)cudaGetLastError();
}

int dispatch(const Call& c, int hd, void* stream_) {
  if (c.b <= 0 || c.h <= 0 || c.tq <= 0 || c.tk <= 0 || c.n_full < 0 || (c.tail != 0 && c.tail != 1))
    return (int)cudaErrorInvalidValue;
  // the key tiles cover [0, tk) and the last one starts below tk
  const int n_tiles = c.n_full + c.tail;
  const int covered = c.n_full * kBN + c.tail * kTail;
  if (n_tiles == 0 || covered < c.tk || (n_tiles - 1) * kBN >= c.tk) return (int)cudaErrorInvalidValue;
  for (const Strides& s : {c.sq, c.sk, c.sv})
    if (s.b % 8 || s.h % 8 || s.t % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (hd) {
    case 16: return launch<16>(c, stream);
    case 32: return launch<32>(c, stream);
    case 48: return launch<48>(c, stream);
    case 64: return launch<64>(c, stream);
    case 80: return launch<80>(c, stream);
    case 96: return launch<96>(c, stream);
    case 112: return launch<112>(c, stream);
    case 128: return launch<128>(c, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K1. q (b, h, tq, hd), k/v (b, h, tk, hd), o (b, h, tq, hd): contiguous
// bf16 on the current device, 16-byte aligned, hd a multiple of 16 up to
// 128. Key tiles: n_full of 128 keys, then a 16-key tile if tail is 1
// (ops/flash_attention._attn_plan). Launches on `stream`; returns 0 or the
// CUDA error code (1000 + CUresult when a tensor map cannot be built).
int hmm_flash_mha_bf16(const void* q, const void* k, const void* v, void* o, int b, int h, int tq,
                       int tk, int hd, int n_full, int tail, float scale, void* stream) {
  const Strides sq{(int64_t)h * tq * hd, (int64_t)tq * hd, hd};
  const Strides skv{(int64_t)h * tk * hd, (int64_t)tk * hd, hd};
  return dispatch(Call{q, k, v, o, b, h, tq, tk, n_full, tail, scale, sq, skv, skv, sq}, hd, stream);
}

// K4. q (b, tq, h, hd), k/v (b, tk, h, hd) as strided views: element strides
// (batch, head, row) per operand, hd contiguous, every stride a multiple of 8
// and every base 16-byte aligned. o (b, tq, h, hd) contiguous bf16. Key
// tiles and return value as K1.
int hmm_flash_mha_bthd_bf16(const void* q, const void* k, const void* v, void* o, int b, int h,
                            int tq, int tk, int hd, int64_t q_sb, int64_t q_sh, int64_t q_st,
                            int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb,
                            int64_t v_sh, int64_t v_st, int n_full, int tail, float scale,
                            void* stream) {
  const Strides so{(int64_t)tq * h * hd, hd, (int64_t)h * hd};
  return dispatch(Call{q, k, v, o, b, h, tq, tk, n_full, tail, scale, Strides{q_sb, q_sh, q_st},
                       Strides{k_sb, k_sh, k_st}, Strides{v_sb, v_sh, v_st}, so},
                  hd, stream);
}

// dynamic shared memory of one block at head dim hd (0 for an hd the kernel
// does not take), for reports
int hmm_flash_mha_smem_bytes(int hd) {
  switch (hd) {
    case 16: return Layout<16>::kBytes;
    case 32: return Layout<32>::kBytes;
    case 48: return Layout<48>::kBytes;
    case 64: return Layout<64>::kBytes;
    case 80: return Layout<80>::kBytes;
    case 96: return Layout<96>::kBytes;
    case 112: return Layout<112>::kBytes;
    case 128: return Layout<128>::kBytes;
    default: return 0;
  }
}

}  // extern "C"
