// K1 and K4 at fp32: mask-free multi-head attention forward for Hopper
// (sm_90a) when q, k and v are fp32.
//
// Replaces the same two Pallas TPU kernels as flash_mha.cu, for the fp32
// operands the JAX package passes them (its fp32 towers and its training,
// which runs in fp32): `_mha_kernel` (K1, reached through `flash_mha`) and
// `_mha_kernel_bthd` (K4, through `flash_mha_bthd`) of
// hippomm_tpu/ops/flash_attention.py. Those compute in the operand dtype, so
// at fp32 both products accumulate fp32 products of fp32 operands, with an
// fp32 softmax, and the output is divided by the row sum at the end (the
// TPU kernel's `defer_div` body). So does this kernel.
//
// Products: 3×TF32 on the tensor cores, as fused_mlp_f32.cu takes its
// GEMMs: each operand element v is split into hi = tf32(v) and lo = tf32(v
// − hi) (cvt.rna), and a·b is taken as a_hi·b_hi + a_hi·b_lo + a_lo·b_hi
// (the dropped a_lo·b_lo is about 2⁻²² of a·b). The tensor cores truncate as
// they add, so S keeps the three products in accumulators of their own,
// added on the CUDA cores: one accumulator for all three truncates the
// cross products' sum at the magnitude of S, which at sharp logits costs
// more than fp32 rounding. O += P·V stays one accumulator over all keys
// (tests/test_torch_tf32_attention.py emulates both products and the
// softmax in numpy at the path shapes).
//
// One kernel serves K1 and K4: TMA reads row t of head h of batch b at
// b·s_b + h·s_h + t·s_t elements through 4-D tensor maps (hd, T, H, B), so
// K1 passes the strides of a contiguous (B, H, T, hd) tensor and K4 those of
// (B, T, H, hd) views, such as the q, k and v slices of a packed (B, T, 3D)
// projection (row stride 3D, each slice at an offset of d·4 bytes), with no
// copy. Rows past T and columns past hd read as zeros.
//
// Bound on the H100: 4·Tq·Tk·hd operations, three times over as TF32 at 495
// TF/s, against q, k, v and the output once at 3.35 TB/s
// (4·B·H·hd·(2·Tq + 2·Tk) bytes): the operations bound every path shape
// (vision (32, 16, 257, 257, 80) 0.0656 ms against 0.0503 ms of bytes; audio
// (96, 12, 229, 230, 64) 0.0941 against 0.0808; Whisper's encoder (4, 20,
// 1500, 1500, 64) 0.2793 against 0.0367). At fp32 on the CUDA cores (67
// TF/s) the same work is bound at 0.1615, 0.2318 and 0.6878 ms.
//
// Design (FlashAttention-3's structure, the bf16 flash_mha.cu's TMA, wgmma
// and ping-pong): a persistent block per SM walks work tiles of 128 query
// rows of one head (consecutive work tiles are the same head's query tiles,
// so the blocks that run together share its K/V in the L2) and the head's
// keys in tiles of 32 (16 past hd 80: shared memory).
//   * Producer warpgroup, warp 0: one thread TMA-loads each key tile's K
//     and V (raw fp32) into a ring of 2-4 stages, another each work tile's
//     Q into one buffer (freed when both consumers have taken their last
//     q·kᵀ). Q and K land as K-major panels of 32 columns (128-byte rows,
//     128B swizzle) and one of 16 (64B) where hd/16 is odd — hd 80 is 32 +
//     32 + 16 — V as plain rows; a stage leaves room after each K panel for
//     the panel's lo rows.
//   * Producer warpgroup, warps 1-3: the 3×TF32 split of each key tile as
//     it lands, K in place in its stage (hi over the raw rows, lo after
//     them: the same swizzled layout, so one descriptor walk serves both),
//     V into one of two Vᵀ hi/lo buffers (hd rows, the tile's keys
//     contiguous: tf32 wgmma has no transpose, so P·V needs V K-major) once
//     the P·V that last read it is done. mbarriers carry each step: K
//     ready, V ready, stage free (after q·kᵀ of both consumers and V's
//     split), Vᵀ buffer free.
//   * Two consumer warpgroups, 64 query rows each of the work tile. Each
//     splits its Q rows once a work tile (hi in place, lo beside). Per key
//     tile a consumer issues S = Q·Kᵀ as, per k8 step, q_hi against a
//     panel's hi and lo rows together (wgmma m64n(2·KT)k8: one read of q_hi
//     for two products) and q_lo against its hi rows (m64nKTk8), both
//     operands from shared memory; takes the online softmax of S in
//     registers (fp32; exponentials as ex2 of logits pre-scaled by
//     scale·log2 e in one FFMA; the row max and sum over the quad);
//     rescales O, splits P in registers and issues O += P·V (wgmma
//     m64nHDk8 with P as the A operand from registers). The two issue their
//     products in turns (named barriers), so that one's softmax runs while
//     the other's products do.
//   * P never leaves registers: the fp32 accumulator holds columns 2t, 2t+1
//     of each 8-column group (t = lane % 4) where the tf32 A fragment holds
//     columns t and t + 4, so the V split writes key κ of each group of 8
//     at Vᵀ column (κ >> 1) + 4·(κ & 1) — keys (0, 2, 4, 6, 1, 3, 5, 7) — and
//     P·V, a sum over keys, is the same with the keys permuted on both
//     sides.
//   * A consumer warpgroup whose 64 rows all lie past Tq (the last work
//     tile of a head at Tq 257) keeps the turns and issues nothing.
//   * The output is divided by the row sum at the end, written in fp32.
// Keys past Tk get −inf logits (TMA's zero fill gives 0).
// What it costs (measured, chip_smoke.py phase 2 and
// scripts/torch_flash_variants.py --f32, PERF.md): the consumers' CUDA-core
// work (softmax, O rescale, P split: latency-bound at two warps a
// sub-partition) weighed more than the products, and the turns hide it
// under the other warpgroup's products. Measured slower: the K/V split in
// the consumers (in step, one named barrier a key tile); q·kᵀ of tile j
// issued with P·V of tile j − 1 within a warpgroup (the extra live P spills
// at hd 80); setmaxnreg (ptxas then spills in both roles).
//
// Requirements (checked by the wrapper, which pads otherwise): every
// stride of q, k and v a multiple of 4 elements and every base 16-byte
// aligned (TMA); hd ≤ 128.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;            // query rows a work tile: two consumer warpgroups × 64
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may have
constexpr int kMaxStages = 4;
constexpr int kSplitters = 96;     // the producer warpgroup's warps 1-3 split K and V
constexpr int kQBarrier = 3;        // + warpgroup: named barrier of its split of Q (1, 2: the turns)

// Tiles and shared memory of template instance NC (hd ≤ 16·NC). Every
// buffer is a multiple of 1024 bytes (the 128B swizzle's atom).
template <int NC>
struct Plan {
  static constexpr int kHdp = 16 * NC;        // stored columns
  static constexpr int kFull = kHdp / 32;     // 32-column panels (128B swizzle)
  static constexpr bool kRem = kHdp % 32 != 0;  // a last 16-column panel (64B swizzle)
  static constexpr int kKt = NC <= 5 ? 32 : 16;  // keys a tile
  static constexpr int kVSw = 4 * kKt;        // a Vᵀ row's bytes, its swizzle width
  static constexpr int kQ = kBM * kHdp * 4;   // Q (hi or lo)
  static constexpr int kKv = kKt * kHdp * 4;  // a K or V tile, or a Vᵀ one (hi, lo or raw)
  static constexpr int kFixed = 2 * kQ + 4 * kKv;  // Q hi and lo, two Vᵀ buffers (hi, lo)
  // a ring stage: each K panel's hi (as TMA loads it, then split in place)
  // and lo, one after the other, then raw V
  static constexpr int kRaw = 3 * kKv;
  static constexpr int kPanel = 2 * kKt * 128;  // a 32-column K panel, hi and lo
  static constexpr int kFit = (kSmemMax - 1024 - 48 - kFixed) / (kRaw + 24);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  // three or four up to hd 112 (a key tile landing while one is split and
  // one read), two at hd 128
  static_assert(kStages >= 2, "the K/V ring needs two stages");
  static constexpr int kQLo = kQ;
  static constexpr int kVBuf = 2 * kQ;         // Vᵀ buffer b: hi at kVBuf + 2b·kKv, lo after it
  static constexpr int kRing = kVBuf + 4 * kKv;
  // mbarriers: raw full, stage empty, K ready (kStages each), V ready and
  // Vᵀ empty (two each), Q full and empty
  static constexpr int kBars = kRing + kStages * kRaw;
  static constexpr int kBytes = kBars + 24 * kStages + 48 + 1024;  // + 1024-byte alignment slack
};

struct AttnArgs {
  int h, tq, tk, hd;
  int nqt;           // 128-row query tiles a head
  int key_tiles;     // key tiles a head
  int work;          // work tiles: B · H · nqt
  float scale_log2;  // scale · log2(e)
  float* o;
  int64_t so_b, so_h, so_t;  // output element strides
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one tile of `rows` rows from (row0, head, batch) into dst, every hd
// panel, `stride` bytes apart: the 32-column ones through `main`, a
// 16-column one through `rem`
template <int NC>
__device__ __forceinline__ void load_panels(uint32_t dst, int stride, const CUtensorMap* main,
                                            const CUtensorMap* rem, int row0, int hh, int bb, uint32_t bar) {
  using P = Plan<NC>;
#pragma unroll
  for (int p = 0; p < P::kFull; ++p) tma_load_4d(dst + stride * p, main, 32 * p, row0, hh, bb, bar);
  if constexpr (P::kRem) tma_load_4d(dst + stride * P::kFull, rem, 32 * P::kFull, row0, hh, bb, bar);
}

// K of one ring stage (at `stage`), panel by panel: hi in place, lo right
// after the panel's hi rows (the same swizzled layout), float4 by float4 over
// kN threads (tid < kN). Each thread's loads are issued together before it
// splits and stores.
template <int NC, int kN>
__device__ __forceinline__ void split_k(unsigned char* stage, int tid) {
  using P = Plan<NC>;
  float4* const k4 = reinterpret_cast<float4*>(stage);
  constexpr int kMain = P::kKt * 8;  // float4s of a 32-column panel's hi (or lo)
  constexpr int kAll = P::kKv / 16, kPer = (kAll + kN - 1) / kN;
  float4 v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = tid + kN * r;
    if (i < kAll) v[r] = k4[i / kMain * 2 * kMain + i % kMain];
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = tid + kN * r;
    const int p = i / kMain;  // kFull for the 16-column panel, whose halves are kKt · 4 float4s
    const int at = p * 2 * kMain + i % kMain;
    if (i < kAll) split4(v[r], k4[at], k4[at + (p < P::kFull ? kMain : kMain / 2)]);
  }
}

// V of one ring stage (`vraw`: kKt plain rows of kHdp) into a Vᵀ buffer (hi
// at `vt`, lo after it): row n holds column n of V, its 16-byte chunk c the
// keys 8·(c >> 1) + 2e + (c & 1) (e < 4) — the permuted order — at the
// chunk's swizzled place; over kN threads, the loads issued together
template <int NC, int kN>
__device__ __forceinline__ void split_v(const unsigned char* vraw, unsigned char* vt, int tid) {
  using P = Plan<NC>;
  constexpr int kHdp = P::kHdp, kKt = P::kKt;
  const float* const src = reinterpret_cast<const float*>(vraw);
  constexpr int kAll = kHdp * kKt / 4, kPer = (kAll + kN - 1) / kN;
  float4 v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = tid + kN * r;
    const int n = i % kHdp, c = i / kHdp;
    const float* const col = src + (8 * (c >> 1) + (c & 1)) * kHdp + n;
    if (i < kAll) v[r] = make_float4(col[0], col[2 * kHdp], col[4 * kHdp], col[6 * kHdp]);
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = tid + kN * r;
    const int n = i % kHdp, c = i / kHdp;
    // 128B swizzle (32-key rows): chunk ^ (n % 8); 64B (16 keys): chunk ^ ((n / 2) % 4)
    const int at = n * P::kVSw + ((c ^ (kKt == 32 ? n & 7 : (n >> 1) & 3)) << 4);
    if (i < kAll)
      split4(v[r], *reinterpret_cast<float4*>(vt + at), *reinterpret_cast<float4*>(vt + P::kKv + at));
  }
}

// grid: one block per SM (at most one per work tile); work tile w is query
// tile w % nqt of head (w / nqt) % H of batch w / (nqt · H). Key tile c of
// the block's running count sits in ring stage c % kStages and Vᵀ buffer
// c % 2.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
flash_mha_f32_kernel(const __grid_constant__ CUtensorMap q_main, const __grid_constant__ CUtensorMap q_rem,
                     const __grid_constant__ CUtensorMap k_main, const __grid_constant__ CUtensorMap k_rem,
                     const __grid_constant__ CUtensorMap v_map, const AttnArgs args) {
  using P = Plan<NC>;
  constexpr int kHdp = P::kHdp, kKt = P::kKt, kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const uint32_t raw_full = base + P::kBars, stage_empty = raw_full + 8 * kStages;
  const uint32_t k_ready = stage_empty + 8 * kStages, v_ready = k_ready + 8 * kStages;
  const uint32_t vt_empty = v_ready + 16, q_full = vt_empty + 16, q_empty = q_full + 8;
  constexpr int kConsumerWarps = 4 * kConsumers;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(raw_full + 8 * s, 1);
      // the consumer warps have taken S from its K, the splitters its raw V
      mbar_init(stage_empty + 8 * s, kConsumerWarps + kSplitters / 32);
      mbar_init(k_ready + 8 * s, kSplitters / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(v_ready + 8 * b, kSplitters / 32);
      mbar_init(vt_empty + 8 * b, kConsumerWarps);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (wg == kConsumers) {
    if (warp == 0) {
      // lane 0 streams K and V through the ring, lane 1 each work tile's Q
      if (lane == 0) {
        int c = 0;
        for (int w = blockIdx.x; w < args.work; w += gridDim.x) {
          const int bh = w / args.nqt, hh = bh % args.h, bb = bh / args.h;
          for (int j = 0; j < args.key_tiles; ++j, ++c) {
            const int st = c % kStages;
            mbar_wait(stage_empty + 8 * st, ((c / kStages) & 1) ^ 1);
            mbar_expect_tx(raw_full + 8 * st, 2 * P::kKv);
            const uint32_t dst = base + P::kRing + st * P::kRaw;
            load_panels<NC>(dst, P::kPanel, &k_main, &k_rem, j * kKt, hh, bb, raw_full + 8 * st);
            tma_load_4d(dst + 2 * P::kKv, &v_map, 0, j * kKt, hh, bb, raw_full + 8 * st);
          }
        }
      } else if (lane == 1) {
        int it = 0;
        for (int w = blockIdx.x; w < args.work; w += gridDim.x, ++it) {
          const int qt = w % args.nqt, bh = w / args.nqt, hh = bh % args.h, bb = bh / args.h;
          mbar_wait(q_empty, (it & 1) ^ 1);
          mbar_expect_tx(q_full, P::kQ);
          load_panels<NC>(base, kBM * 128, &q_main, &q_rem, qt * kBM, hh, bb, q_full);
        }
      }
      return;
    }
    // warps 1-3 split each key tile once it lands: K in place in its stage
    // (hi over the raw rows, lo after them), then, once the P·V that last
    // read its Vᵀ buffer is done, V into that buffer
    const int sp = threadIdx.x - kConsumers * 128 - 32;
    int c = 0;
    for (int w = blockIdx.x; w < args.work; w += gridDim.x) {
      for (int j = 0; j < args.key_tiles; ++j, ++c) {
        const int st = c % kStages, b = c & 1;
        mbar_wait(raw_full + 8 * st, (c / kStages) & 1);
        split_k<NC, kSplitters>(smem + P::kRing + st * P::kRaw, sp);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(k_ready + 8 * st);
        mbar_wait(vt_empty + 8 * b, ((c >> 1) & 1) ^ 1);
        split_v<NC, kSplitters>(smem + P::kRing + st * P::kRaw + 2 * P::kKv, smem + P::kVBuf + 2 * b * P::kKv,
                                sp);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(v_ready + 8 * b);
          mbar_arrive(stage_empty + 8 * st);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x % 128;
  const int g = lane / 4, q4 = lane % 4;  // accumulator rows g, g + 8; column pair q4
  const float sl2 = args.scale_log2;

  // S of a key tile: q_hi·[k_hi; k_lo] (the keys' q_hi·k_hi, then their
  // q_hi·k_lo) and q_lo·k_hi; the softmax leaves P in sh's first half (s)
  float sh[kKt], sx[kKt / 2];
  float(&s)[kKt / 2] = *reinterpret_cast<float(*)[kKt / 2]>(&sh[0]);
  uint32_t ph[kKt / 2], pl[kKt / 2];  // P hi and lo as A fragments, 4 registers a k8 step
  float o[kHdp / 2];                  // O, m64n(hd) accumulator
  float m[2], l[2];

  // this warpgroup's 64 Q rows, hi in place, lo into the Q lo buffer
  auto split_q = [&] {
    float4* const hi = reinterpret_cast<float4*>(smem);
    float4* const lo = reinterpret_cast<float4*>(smem + P::kQLo);
#pragma unroll
    for (int p = 0; p < P::kFull; ++p) {
      const int at = (p * kBM * 128 + wg * 64 * 128) / 16 + t;
#pragma unroll
      for (int i = 0; i < 4; ++i) split4(hi[at + 128 * i], hi[at + 128 * i], lo[at + 128 * i]);
    }
    if constexpr (P::kRem) {
      const int at = (P::kFull * kBM * 128 + wg * 64 * 64) / 16 + t;
#pragma unroll
      for (int i = 0; i < 2; ++i) split4(hi[at + 128 * i], hi[at + 128 * i], lo[at + 128 * i]);
    }
  };
  // S = Q·Kᵀ for this warpgroup's 64 rows against ring stage st: per k8
  // step one product of q_hi with the panel's hi and lo rows together (N =
  // 2·kKt, one read of q_hi) and one of q_lo with its hi rows
  auto issue_s = [&](int st) {
    const uint32_t qh = base, ql = base + P::kQLo, k = base + P::kRing + st * P::kRaw;
#pragma unroll
    for (int p = 0; p < P::kFull; ++p) {
      const uint32_t qo = p * kBM * 128 + wg * 64 * 128;
      const uint64_t dah = desc_k<128>(qh + qo), dal = desc_k<128>(ql + qo);
      const uint64_t db = desc_k<128>(k + p * P::kPanel);
#pragma unroll
      for (int k8 = 0; k8 < 4; ++k8) {
        wgmma_tf32<2 * kKt>(sh, dah + 2 * k8, db + 2 * k8, p + k8 > 0);
        wgmma_tf32<kKt>(sx, dal + 2 * k8, db + 2 * k8, p + k8 > 0);
      }
    }
    if constexpr (P::kRem) {
      const uint32_t qo = P::kFull * kBM * 128 + wg * 64 * 64;
      const uint64_t dah = desc_k<64>(qh + qo), dal = desc_k<64>(ql + qo);
      const uint64_t db = desc_k<64>(k + P::kFull * P::kPanel);
#pragma unroll
      for (int k8 = 0; k8 < 2; ++k8) {
        wgmma_tf32<2 * kKt>(sh, dah + 2 * k8, db + 2 * k8, P::kFull + k8 > 0);
        wgmma_tf32<kKt>(sx, dal + 2 * k8, db + 2 * k8, P::kFull + k8 > 0);
      }
    }
  };
  // O += P·V over Vᵀ buffer b
  auto issue_pv = [&](int b) {
    const uint32_t vh = base + P::kVBuf + 2 * b * P::kKv, vl = vh + P::kKv;
#pragma unroll
    for (int kk = 0; kk < kKt / 8; ++kk) {
      const uint32_t(&ah)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&ph[4 * kk]);
      const uint32_t(&al)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&pl[4 * kk]);
      const uint64_t dbh = desc_k<P::kVSw>(vh + 32 * kk), dbl = desc_k<P::kVSw>(vl + 32 * kk);
      wgmma_tf32_rs<kHdp>(o, ah, dbh);
      wgmma_tf32_rs<kHdp>(o, ah, dbl);
      wgmma_tf32_rs<kHdp>(o, al, dbh);
    }
  };
  // the online softmax of S over keys key0 .. key0 + kKt: masks keys at and
  // past tk, updates m and l, leaves p in s and the rescale factor of the
  // rows' earlier output in alpha
  auto softmax = [&](int key0, float (&alpha)[2]) {
    // the key's q_hi·k_hi (accumulator columns 0 .. kKt), q_hi·k_lo
    // (columns kKt .. 2·kKt: registers kKt / 2 later) and q_lo·k_hi
#pragma unroll
    for (int i = 0; i < kKt / 2; ++i) s[i] = sh[i] + (sh[i + kKt / 2] + sx[i]);
    if (key0 + kKt > args.tk) {  // the ragged tile
#pragma unroll
      for (int i = 0; i < kKt / 2; ++i)
        if (key0 + 8 * (i / 4) + 2 * q4 + (i & 1) >= args.tk) s[i] = -INFINITY;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kKt / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);  // finite: every tile holds a real key
      alpha[h] = ex2((m[h] - m_new) * sl2);  // 0 on the first tile (m = −inf)
      m[h] = m_new;
      const float neg = -m_new * sl2;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < kKt / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(s[4 * n + 2 * h + e], sl2, neg));
          s[4 * n + 2 * h + e] = p;
          sum += p;
        }
      }
      l[h] = l[h] * alpha[h] + sum;  // a per-thread partial: its quad is summed at the end
    }
  };
  // O rescaled, and P (in s) split into A fragments: register 4·kk + i of
  // a k8 step takes accumulator element (0, 2, 1, 3)[i] of its 8-key group
  auto rescale_split_p = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < kHdp / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kKt / 8; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = s[4 * kk + (i == 1 ? 2 : i == 2 ? 1 : i)];
        const float hi = tf32_rna(p);
        ph[4 * kk + i] = __float_as_uint(hi);
        pl[4 * kk + i] = __float_as_uint(tf32_rna(p - hi));
      }
    }
  };
  auto fence_all = [&] {
    fence_acc(sh);
    fence_acc(sx);
    fence_acc(o);
    fence_regs(ph);
    fence_regs(pl);
  };

  // The ping-pong (FlashAttention-3's): each warpgroup issues its products
  // in turns with the other (named barriers), so that its softmax runs while
  // the other's products do. A turn issues S of key tile c, or P·V of key
  // tile c, and waits on it. A warpgroup without query rows below tq
  // (kActive false) keeps the turns and the arrivals and issues nothing.
  // Each turn's shape is fixed at compile time: a wgmma on a data-dependent
  // path makes ptxas serialize the products.
  int slot = 0, it = 0;
  auto s_turn = [&](auto active_tag, int c, int key0, bool last_s) {
    constexpr bool kActive = decltype(active_tag)::value;
    const int st = c % kStages;
    if constexpr (kActive) mbar_wait(k_ready + 8 * st, (c / kStages) & 1);
    named_barrier_sync(kTurnBarrier + wg);
    if constexpr (kActive) {
      fence_all();
      wgmma_fence();
      issue_s(st);
      wgmma_commit();
    }
    named_barrier_arrive(kTurnBarrier + (wg ^ 1));
    if constexpr (kActive) {
      wgmma_wait<0>();
      fence_all();
    }
    if (lane == 0) {
      mbar_arrive(stage_empty + 8 * st);
      if (last_s && kActive) mbar_arrive(q_empty);
    }
    if constexpr (kActive) {
      float alpha[2];
      softmax(key0, alpha);
      rescale_split_p(alpha);
    }
  };
  auto pv_turn = [&](auto active_tag, int c) {
    constexpr bool kActive = decltype(active_tag)::value;
    const int b = c & 1;
    if constexpr (kActive) mbar_wait(v_ready + 8 * b, (c >> 1) & 1);
    named_barrier_sync(kTurnBarrier + wg);
    if constexpr (kActive) {
      fence_all();
      wgmma_fence();
      issue_pv(b);
      wgmma_commit();
    }
    named_barrier_arrive(kTurnBarrier + (wg ^ 1));
    if constexpr (kActive) {
      wgmma_wait<0>();
      fence_all();
    }
    if (lane == 0) mbar_arrive(vt_empty + 8 * b);
  };
  // one work tile: per key tile, S and its softmax, then P·V
  auto tile = [&](auto active_tag, int qt, int bh) {
    constexpr bool kActive = decltype(active_tag)::value;
    const int n = args.key_tiles, c0 = slot;
    if constexpr (kActive) {
#pragma unroll
      for (int i = 0; i < kHdp / 2; ++i) o[i] = 0.0f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.0f;
      mbar_wait(q_full, it & 1);
      split_q();
      fence_proxy_async();
      named_barrier_sync(kQBarrier + wg, 128);
    } else {
      if (lane == 0) mbar_arrive(q_empty);  // this warpgroup never reads the tile's Q
    }
    for (int j = 0; j < n; ++j) {
      s_turn(active_tag, c0 + j, j * kKt, j == n - 1);
      pv_turn(active_tag, c0 + j);
    }
    slot = c0 + n;
    if constexpr (kActive) {
      // O / l in fp32, rows below tq and columns below hd; o[4j + 2h + e]
      // is row 16·warp + g + 8h, column 8j + 2·q4 + e of this warpgroup
      const int hh = bh % args.h, bb = bh / args.h;
      float* const out = args.o + bb * args.so_b + hh * args.so_h;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = l[h];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.0f / sum;
        const int row = qt * kBM + 64 * wg + 16 * warp + g + 8 * h;
        if (row >= args.tq) continue;
        float* const orow = out + row * args.so_t;
#pragma unroll
        for (int jn = 0; jn < kHdp / 8; ++jn) {
          const int col = 8 * jn + 2 * q4;
          if (col < args.hd) orow[col] = o[4 * jn + 2 * h] * inv;
          if (col + 1 < args.hd) orow[col + 1] = o[4 * jn + 2 * h + 1] * inv;
        }
      }
    }
  };
  if (wg == 1) named_barrier_arrive(kTurnBarrier);  // warpgroup 0 takes the first turn
  for (int w = blockIdx.x; w < args.work; w += gridDim.x, ++it) {
    const int qt = w % args.nqt, bh = w / args.nqt;
    if (qt * kBM + 64 * wg < args.tq)
      tile(std::true_type{}, qt, bh);
    else
      tile(std::false_type{}, qt, bh);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// element strides of one operand: batch, head, row (the hd axis is contiguous)
struct Strides {
  int64_t b, h, t;
};

// (hd, T, H, B) map of one fp32 operand: boxes of `box_cols` columns ×
// `rows` rows of one head, swizzled as given; columns past hd and rows past
// T read as zeros
int make_map(CUtensorMap* map, const void* base, int hd, int t, int h, int b, Strides st, int box_cols,
             int rows, CUtensorMapSwizzle sw) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kMapError;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)t, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st.t * 4, (cuuint64_t)st.h * 4, (cuuint64_t)st.b * 4};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides,
                            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// the 32-column (128B) and 16-column (64B) panel maps of Q or K
template <int NC>
int panel_maps(CUtensorMap (&maps)[2], const void* base, int hd, int t, int h, int b, Strides st, int rows) {
  using P = Plan<NC>;
  int rc = 0;
  if (P::kFull > 0) rc = make_map(&maps[0], base, hd, t, h, b, st, 32, rows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0 && P::kRem) rc = make_map(&maps[1], base, hd, t, h, b, st, 16, rows, CU_TENSOR_MAP_SWIZZLE_64B);
  if (P::kFull == 0) maps[0] = maps[1];
  if (!P::kRem) maps[1] = maps[0];
  return rc;
}

struct Call {
  const void *q, *k, *v;
  float* o;
  int b, h, tq, tk, hd;
  Strides sq, sk, sv, so;
  float scale;
};

template <int NC>
int launch(const Call& c, cudaStream_t stream) {
  using P = Plan<NC>;
  static bool sized[kMaxDevices] = {};  // the kernel's shared memory, set once per device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int sms = sm_count(dev);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  CUtensorMap qm[2], km[2], vm;
  int rc = panel_maps<NC>(qm, c.q, c.hd, c.tq, c.h, c.b, c.sq, kBM);
  if (rc == 0) rc = panel_maps<NC>(km, c.k, c.hd, c.tk, c.h, c.b, c.sk, P::kKt);
  if (rc == 0) rc = make_map(&vm, c.v, c.hd, c.tk, c.h, c.b, c.sv, P::kHdp, P::kKt, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  if (!sized[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_mha_f32_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  AttnArgs args;
  args.h = c.h;
  args.tq = c.tq;
  args.tk = c.tk;
  args.hd = c.hd;
  args.nqt = (c.tq + kBM - 1) / kBM;
  args.key_tiles = (c.tk + P::kKt - 1) / P::kKt;
  const int64_t work = (int64_t)c.b * c.h * args.nqt;
  if (work > INT32_MAX) return (int)cudaErrorInvalidValue;
  args.work = (int)work;
  args.scale_log2 = (float)((double)c.scale * 1.4426950408889634);
  args.o = c.o;
  args.so_b = c.so.b;
  args.so_h = c.so.h;
  args.so_t = c.so.t;
  flash_mha_f32_kernel<NC><<<args.work < sms ? args.work : sms, kThreads, P::kBytes, stream>>>(
      qm[0], qm[1], km[0], km[1], vm, args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 and K4 at fp32. q (b, ·, tq, hd), k/v (b, ·, tk, hd) as strided fp32
// tensors: element strides (batch, head, row) per operand, hd contiguous,
// every q/k/v stride a multiple of 4 and every base 16-byte aligned (TMA);
// o any strides. The plan of ops/flash_attention._attn_plan_f32: q_tiles
// tiles of 128 query rows, key_tiles of 32 keys (16 when nc > 5), nc = hd
// rounded up to 16, over 16. Launches on `stream`; returns 0 or the CUDA
// error code (1000 + CUresult when a tensor map cannot be built).
int hmm_flash_mha_f32(const void* q, const void* k, const void* v, void* o, int b, int h, int tq, int tk,
                      int hd, int64_t q_sb, int64_t q_sh, int64_t q_st, int64_t k_sb, int64_t k_sh,
                      int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t o_sb, int64_t o_sh,
                      int64_t o_st, int q_tiles, int key_tiles, int nc, float scale, void* stream) {
  if (b <= 0 || h <= 0 || tq <= 0 || tk <= 0 || hd <= 0 || nc < 1 || nc > 8 || hd > 16 * nc ||
      hd <= 16 * (nc - 1))
    return (int)cudaErrorInvalidValue;
  const int kt = nc <= 5 ? 32 : 16;
  if (q_tiles != (tq + kBM - 1) / kBM || key_tiles != (tk + kt - 1) / kt) return (int)cudaErrorInvalidValue;
  for (const int64_t s : {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st})
    if (s % 4 != 0) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  const Call c{q, k, v, static_cast<float*>(o), b, h, tq, tk, hd, Strides{q_sb, q_sh, q_st},
               Strides{k_sb, k_sh, k_st}, Strides{v_sb, v_sh, v_st}, Strides{o_sb, o_sh, o_st}, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 1: return launch<1>(c, s);
    case 2: return launch<2>(c, s);
    case 3: return launch<3>(c, s);
    case 4: return launch<4>(c, s);
    case 5: return launch<5>(c, s);
    case 6: return launch<6>(c, s);
    case 7: return launch<7>(c, s);
    case 8: return launch<8>(c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory of one block at nc = hd / 16 (0 for another nc),
// for reports
int hmm_flash_mha_f32_smem_bytes(int nc) {
  switch (nc) {
    case 1: return Plan<1>::kBytes;
    case 2: return Plan<2>::kBytes;
    case 3: return Plan<3>::kBytes;
    case 4: return Plan<4>::kBytes;
    case 5: return Plan<5>::kBytes;
    case 6: return Plan<6>::kBytes;
    case 7: return Plan<7>::kBytes;
    case 8: return Plan<8>::kBytes;
    default: return 0;
  }
}

}  // extern "C"
