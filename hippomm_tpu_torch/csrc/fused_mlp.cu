// K2 and K3: fused transformer MLP for Hopper (sm_90a), bf16.
//   K2:  out = cast(cast(x·W1ᵀ + b1) → exact-erf GELU → ·W2ᵀ + b2)
//   K3:  out = x + K2(cast(LN(x)))   (LN statistics and affine in fp32)
//
// K2 replaces the Pallas TPU kernel `_mlp_kernel` in
// hippomm_tpu/ops/fused_mlp.py (reached through `fused_mlp` /
// `fused_mlp_vjp`); K3 replaces `_ln_mlp_kernel` of the same file (reached
// through `fused_ln_mlp_residual`), the encoder block's x + mlp(ln_2(x)).
//
// Bound on the H100. 4·N·D·F flops against N·D·4 + D·F·4 bytes: at the
// ingest shapes (N in the thousands) the tensor cores bound it (0.218 ms for
// the ViT-H tower's (8224, 1280, 5120) at 989 TF/s); at the text tower's
// 77 rows the 16.8 MB weight read bounds it (0.0051 ms at 3.35 TB/s).
//
// Why the hidden goes through device memory. The TPU kernel kept the (N, F)
// hidden in VMEM because its exact-erf GELU ran on the VPU in series with the
// MXU and the hidden was hundreds of MB of HBM there. On the H100 a block
// cannot hold a (rows, D) fp32 accumulator beside a weight ring at a row tile
// large enough to read each weight tile once per 128 rows, and the hidden's
// round trip is cheap beside the tensor-core work: at the vision shape the
// (8224, 5120) bf16 hidden is 84 MB, written once and read once (168 MB,
// 0.050 ms of HBM time), against about 0.11 ms of tensor-core work per GEMM
// pass. So one call is two GEMM passes, each a "TN" product whose operands
// are both K-major exactly as stored:
//   pass 1 (fc1): H = gelu(bf16(x·W1ᵀ + b1)) in bf16   — A x (or t), B W1 (F, D)
//   pass 2 (fc2): out = bf16(H·W2ᵀ + b2) [+ x for K3]   — A H,        B W2 (D, F)
// with the MLP's elementwise work fused into each pass's epilogue, in
// registers. K3 first writes t = bf16(LN(x)) with a row kernel (one warp per
// row, fp32 mean then mean of squared deviations), and its pass 2 re-reads x
// for the residual (2 × 21 MB at vision, about 0.013 ms).
//
// Each pass is one persistent, warp-specialised kernel (`gemm_tn`):
//   * one producer thread issues TMA loads (cp.async.bulk.tensor) of
//     128-byte-swizzled (128 × 64) A and (BN × 64) B tiles into a ring of 6
//     (BN 128) or 8 (BN 32) stages with full/empty mbarriers; rows past N
//     are zero-filled by TMA, so the wrapper neither pads nor slices;
//   * two consumer warpgroups take turns (ping-pong): each owns whole
//     128 × BN output tiles and issues wgmma.mma_async with both operands
//     from shared memory and fp32 accumulators in registers, one k-step's
//     group in flight while the previous stage is released; one warpgroup's
//     epilogue (the erf-GELU of pass 1 is the heavy one) overlaps the other's
//     products, and writes 16 bytes a lane (a 4 × 4 shuffle transpose in each
//     quad of lanes turns the wgmma layout's 4-byte pairs into rows of 8);
//   * setmaxnreg moves registers from the producer (40) to the consumers
//     (232), so a 128 × 128 fp32 tile lives in one warpgroup's registers;
//   * at most one block per SM walks the output tiles, so the producer loads
//     the next tile while the consumers finish this one.
// Tile plans, chosen by the wrapper (ops/fused_mlp._plan) from (N, D, F):
//   * ingest shapes: 128 × 128 tiles in both passes (2600 and 650 at vision:
//     19.7 and 4.9 tiles for each of 132 blocks);
//   * small N (the text tower, 77 rows) is bytes-bound, so the weight read is
//     spread over about one wave: pass 1 narrows BN (32 at 77 rows: 128
//     blocks over F 4096), and pass 2 splits K over F (16 slices at 77 rows,
//     4 at 616), each block writing an fp32 partial of its F-slice to a
//     workspace that `splitk_reduce` sums, adding b2, rounding and adding x.
// CUDA kernels per call: K2 2 (3 with split-K), K3 3 (4 with split-K).
//
// TMA descriptors are built on the host per call with cuTensorMapEncodeTiled,
// reached through the runtime's cudaGetDriverEntryPoint (no -lcuda), and
// passed as __grid_constant__ kernel parameters.
//
// Requirements (checked by the wrappers): N ≥ 8, D and F multiples of 128,
// all tensors contiguous and 16-byte aligned; x, W1, W2 bf16; b1, b2, γ, β
// fp32; the hidden (N, F) bf16, K3's t (N, D) bf16 and the split-K partials
// (splits, N, D) fp32 are workspaces the wrapper allocates.

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                    // rows per tile (two m64 products)
constexpr int kBK = 64;                     // K per stage: one 128-byte swizzle row of bf16
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRingBudget = 196 * 1024;     // shared memory for the ring
constexpr int kBN2 = 128;                   // pass 2's tile width

enum Epilogue { kGelu, kBias, kBiasResidual, kPartial };

__host__ __device__ constexpr int stage_bytes(int bn) { return (kBM + bn) * kBK * 2; }
__host__ __device__ constexpr int ring_stages(int bn) {
  return kRingBudget / stage_bytes(bn) < 8 ? kRingBudget / stage_bytes(bn) : 8;
}
// ring + full/empty barriers + slack to align the ring to 1024 bytes (128B swizzle)
__host__ __device__ constexpr int smem_bytes(int bn) {
  return ring_stages(bn) * stage_bytes(bn) + 2 * ring_stages(bn) * 8 + 1024;
}

struct GemmArgs {
  int m, n, k;                  // C (m, n) = A (m, k) · B (n, k)ᵀ
  int splits;                   // K slices; > 1 only with kPartial
  const float* bias;            // (n,) fp32
  const __nv_bfloat16* resid;   // (m, n) bf16, kBiasResidual
  void* out;                    // (m, n) bf16, or (splits, m, n) fp32 for kPartial
};

// 4 × 4 transpose across the four lanes of a quad (lanes 4k .. 4k + 3): lane
// q's v[t] becomes lane t's v[q] (two butterfly exchanges)
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int m = 2; m >= 1; m >>= 1) {
    uint32_t o[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) o[t] = __shfl_xor_sync(0xffffffffu, v[t ^ m], m);
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = ((t ^ q) & m) ? o[t] : v[t];
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// One GEMM pass: C = A·Bᵀ over the output tiles this block takes (local
// tile i is tile blockIdx.x + i·gridDim.x, tile t = ((split · m_tiles) + mt)
// · n_tiles + nt), with EPI's elementwise tail. Warpgroups 0-1 consume,
// warpgroup 2's first thread produces. Ping-pong: consumer warpgroup w takes
// local tiles w, w + 2, ..., all 128 rows of each (two m64 products per k16
// step), so one warpgroup's epilogue runs while the other's products keep
// the tensor cores busy. Local tile i's k-steps take ring slots i·ksteps ..
// i·ksteps + ksteps − 1, so both warpgroups walk one ring in the producer's
// order, taking turns (named barriers) to start their tiles' waits on it.
template <int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tn(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
        const GemmArgs args) {
  // a warpgroup holds its 128 × BN fp32 tile in registers
  static_assert(BN == 32 || BN == 128, "tile widths: 32, 128");
  constexpr int kStages = ring_stages(BN);
  constexpr int kStageA = kBM * kBK * 2;
  constexpr int kStage = stage_bytes(BN);
  constexpr int kMma = kBM / 64;  // m64 products per k16 step
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kStages * kStage;  // kStages × 8 bytes
  const uint32_t empty = full + kStages * 8;

  const int m_tiles = (args.m + kBM - 1) / kBM, n_tiles = args.n / BN;
  const int tiles = m_tiles * n_tiles * args.splits;
  const int ksteps = args.k / kBK / args.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // one arrival per warp of the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int split = tile / (m_tiles * n_tiles), rest = tile % (m_tiles * n_tiles);
        const int row0 = (rest / n_tiles) * kBM, col0 = (rest % n_tiles) * BN;
        const int kstep0 = split * ksteps;
        for (int kk = 0; kk < ksteps; ++kk) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, kStage);
          const uint32_t a = ring + stage * kStage;
          tma_load(a, &ta, (kstep0 + kk) * kBK, row0, full + 8 * stage);
          tma_load(a + kStageA, &tb, (kstep0 + kk) * kBK, col0, full + 8 * stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const bool signal = lane == 0;
    float acc[kMma][BN / 2];
    for (int i = wg;; i += kConsumers) {
      const int tile = blockIdx.x + i * gridDim.x;
      if (tile >= tiles) break;
      const int split = tile / (m_tiles * n_tiles), rest = tile % (m_tiles * n_tiles);
      const int row0 = (rest / n_tiles) * kBM, col0 = (rest % n_tiles) * BN;
#pragma unroll
      for (int mi = 0; mi < kMma; ++mi) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[mi][e] = 0.0f;
      }
      // wait for the other warpgroup to finish waiting on the ring slots of
      // local tile i − 1, so that every full barrier this tile waits on is at
      // most one phase behind (a parity wait cannot tell phases two apart)
      if (i > 0) named_barrier_sync(kTurnBarrier + wg);
      int prev = -1;
      for (int kk = 0; kk < ksteps; ++kk) {
        const int slot = i * ksteps + kk;
        const int stage = slot % kStages;
        mbar_wait(full + 8 * stage, (slot / kStages) & 1);
        const uint32_t a = ring + stage * kStage;
        const uint64_t db = desc_k<128>(a + kStageA);
        wgmma_fence();
#pragma unroll
        for (int mi = 0; mi < kMma; ++mi) fence_acc(acc[mi]);
#pragma unroll
        for (int k16 = 0; k16 < kBK / 16; ++k16) {
#pragma unroll
          for (int mi = 0; mi < kMma; ++mi) {
            const uint64_t da = desc_k<128>(a + mi * 64 * 128);
            wgmma_ss<BN>(acc[mi], da + 2 * k16, db + 2 * k16, 1);
          }
        }
        wgmma_commit();
#pragma unroll
        for (int mi = 0; mi < kMma; ++mi) fence_acc(acc[mi]);
        wgmma_wait<1>();  // the previous k-step's products are done: free its stage
        if (prev >= 0 && signal) mbar_arrive(empty + 8 * prev);
        prev = stage;
      }
      // the other warpgroup's next tile may start waiting on the ring
      named_barrier_arrive(kTurnBarrier + (wg ^ 1));
      wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < kMma; ++mi) fence_acc(acc[mi]);
      if (signal) mbar_arrive(empty + 8 * prev);

      // epilogue: acc[mi][4j + 2h + e] is row mi·64 + 16·warp + lane/4 + 8h,
      // column 8j + 2·(lane%4) + e of the tile
      const int q = lane % 4;
#pragma unroll
      for (int mi = 0; mi < kMma; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + mi * 64 + warp * 16 + lane / 4 + 8 * h;
          if constexpr (EPI == kPartial) {
            if (row >= args.m) continue;
            float* out = static_cast<float*>(args.out) + ((int64_t)split * args.m + row) * args.n;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              *reinterpret_cast<float2*>(out + col0 + 8 * j + 2 * q) =
                  make_float2(acc[mi][4 * j + 2 * h], acc[mi][4 * j + 2 * h + 1]);
            }
          } else {
#pragma unroll
            for (int g = 0; g < BN / 32; ++g) {
              // columns 8(4g + t) + 2q, +1 for t = 0..3, rounded to bf16 pairs
              uint32_t v[4];
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                const int j = 4 * g + t;
                const float2 bias =
                    *reinterpret_cast<const float2*>(args.bias + col0 + 8 * j + 2 * q);
                const float v0 = acc[mi][4 * j + 2 * h] + bias.x;
                const float v1 = acc[mi][4 * j + 2 * h + 1] + bias.y;
                // pass 1: + b1 → bf16 → exact GELU → bf16, the reference's casts
                const __nv_bfloat162 y =
                    EPI == kGelu ? __floats2bfloat162_rn(gelu_erf(bf16_round(v0)), gelu_erf(bf16_round(v1)))
                                 : __floats2bfloat162_rn(v0, v1);
                v[t] = *reinterpret_cast<const uint32_t*>(&y);
              }
              quad_transpose(v, q);  // now columns 8(4g + q) .. + 7: one 16-byte store
              if (row >= args.m) continue;
              const int64_t at = (int64_t)row * args.n + col0 + 8 * (4 * g + q);
              if constexpr (EPI == kBiasResidual) {
                // residual in bf16: cast, then add, as x + mlp(ln(x)).astype(bf16)
                const uint4 raw = *reinterpret_cast<const uint4*>(args.resid + at);
                const uint32_t xs[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&xs[t]);
                  const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&v[t]);
                  const __nv_bfloat162 o = __floats2bfloat162_rn(__low2float(x) + __low2float(y),
                                                                 __high2float(x) + __high2float(y));
                  v[t] = *reinterpret_cast<const uint32_t*>(&o);
                }
              }
              *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(args.out) + at) =
                  make_uint4(v[0], v[1], v[2], v[3]);
            }
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K3's first step: t = bf16(LN(x)), one warp per row, fp32 two-pass
// statistics (mean, then the mean of squared deviations) and affine. A lane
// holds up to kLnVec 16-byte vectors of its row in registers, so a row of up
// to 256·kLnVec elements (D ≤ 2048) is read once; wider rows are re-read in
// chunks for each pass.
constexpr int kLnVec = 8;

__global__ void __launch_bounds__(256)
layer_norm_rows(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, float eps, __nv_bfloat16* __restrict__ t, int m,
                int d) {
  constexpr int kChunk = 256 * kLnVec;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const __nv_bfloat16* xr = x + (int64_t)row * d;
  const bool resident = d <= kChunk;
  uint4 v[kLnVec];
  auto load = [&](int c0) {
#pragma unroll
    for (int i = 0; i < kLnVec; ++i) {
      const int c = c0 + (i * 32 + lane) * 8;
      if (c < d) v[i] = *reinterpret_cast<const uint4*>(xr + c);
    }
  };
  float s = 0.0f;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    load(c0);
#pragma unroll
    for (int i = 0; i < kLnVec; ++i) {
      if (c0 + (i * 32 + lane) * 8 >= d) continue;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
    }
  }
  const float mean = warp_sum(s) / d;
  float s2 = 0.0f;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    if (!resident) load(c0);
#pragma unroll
    for (int i = 0; i < kLnVec; ++i) {
      if (c0 + (i * 32 + lane) * 8 >= d) continue;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dev = __bfloat162float(e[j]) - mean;
        s2 += dev * dev;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(s2) / d + eps);
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    if (!resident) load(c0);
#pragma unroll
    for (int i = 0; i < kLnVec; ++i) {
      const int c = c0 + (i * 32 + lane) * 8;
      if (c >= d) continue;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float y = (__bfloat162float(e[j]) - mean) * rstd;
        e[j] = __float2bfloat16(y * gamma[c + j] + beta[c + j]);
      }
      *reinterpret_cast<uint4*>(t + (int64_t)row * d + c) = v[i];
    }
  }
}

// split-K's last step: out = bf16(Σ partials + b2) [then bf16(x + that)],
// four columns a thread
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ partial, int splits, const float* __restrict__ bias,
              const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out, int m,
              int n) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= (int64_t)m * n) return;
  const int col = (int)(i % n);
  float4 s = *reinterpret_cast<const float4*>(partial + i);
  for (int p = 1; p < splits; ++p) {
    const float4 v = *reinterpret_cast<const float4*>(partial + (int64_t)p * m * n + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float4 b = *reinterpret_cast<const float4*>(bias + col);
  __nv_bfloat162 lo = __floats2bfloat162_rn(s.x + b.x, s.y + b.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(s.z + b.z, s.w + b.w);
  if (resid != nullptr) {
    const uint2 raw = *reinterpret_cast<const uint2*>(resid + i);
    const __nv_bfloat162 x0 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 x1 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    lo = __floats2bfloat162_rn(__low2float(x0) + __low2float(lo), __high2float(x0) + __high2float(lo));
    hi = __floats2bfloat162_rn(__low2float(x1) + __low2float(hi), __high2float(x1) + __high2float(hi));
  }
  uint2 o;
  o.x = *reinterpret_cast<const uint32_t*>(&lo);
  o.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + i) = o;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// (rows, cols) row-major bf16 → (box_rows × 64) boxes, 128B swizzle; rows
// past the end read as zeros
int make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kMapError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

template <int BN, int EPI>
int gemm(const void* a, const void* b, const GemmArgs& args, cudaStream_t stream) {
  static bool sized[kMaxDevices] = {};  // the ring's shared memory, set once per device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int sms = sm_count(dev);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  CUtensorMap ta, tb;
  int rc = make_map(&ta, a, args.m, args.k, kBM);
  if (rc == 0) rc = make_map(&tb, b, args.n, args.k, BN);
  if (rc != 0) return rc;
  if (!sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tn<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BN));
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  const int tiles = (args.m + kBM - 1) / kBM * (args.n / BN) * args.splits;
  gemm_tn<BN, EPI><<<tiles < sms ? tiles : sms, kThreads, smem_bytes(BN), stream>>>(ta, tb, args);
  return (int)cudaGetLastError();
}

// the whole MLP; gamma != nullptr makes it K3 (normed is then t's workspace),
// resid != nullptr adds that (n, d) bf16 residual in pass 2's epilogue
int mlp(const void* x, const float* gamma, const float* beta, float eps, void* normed,
        const void* w1, const float* b1, const void* w2, const float* b2, const void* resid_,
        void* out, void* hidden, void* partial, int n, int d, int f, int bn1, int splits,
        void* stream_) {
  if (n < 8 || d % 128 || f % 128 || (bn1 != 128 && bn1 != 32) || splits < 1 || (f / kBK) % splits ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const void* a = x;
  if (gamma != nullptr) {
    layer_norm_rows<<<(n + 7) / 8, 256, 0, stream>>>(xb, gamma, beta, eps,
                                                     static_cast<__nv_bfloat16*>(normed), n, d);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    a = normed;
  }
  // pass 1: hidden = gelu(a·W1ᵀ + b1), at one of the plans' tile widths
  const GemmArgs args1{n, f, d, 1, b1, nullptr, hidden};
  int rc = bn1 == 128 ? gemm<128, kGelu>(a, w1, args1, stream)
                      : gemm<32, kGelu>(a, w1, args1, stream);
  if (rc != 0) return rc;
  // pass 2: out = hidden·W2ᵀ + b2 (+ x), or fp32 partials of its K slices
  const __nv_bfloat16* resid = static_cast<const __nv_bfloat16*>(resid_);
  if (splits == 1) {
    const GemmArgs args2{n, d, f, 1, b2, resid, out};
    return resid != nullptr ? gemm<kBN2, kBiasResidual>(hidden, w2, args2, stream)
                            : gemm<kBN2, kBias>(hidden, w2, args2, stream);
  }
  rc = gemm<kBN2, kPartial>(hidden, w2, GemmArgs{n, d, f, splits, nullptr, nullptr, partial},
                            stream);
  if (rc != 0) return rc;
  const int64_t vecs = (int64_t)n * d / 4;
  splitk_reduce<<<(unsigned)((vecs + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), splits, b2, resid, static_cast<__nv_bfloat16*>(out), n,
      d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2. x (n, d) bf16; w1 (f, d) bf16; b1 (f,) fp32; w2 (d, f) bf16; b2 (d,)
// fp32; out (n, d) bf16; hidden (n, f) bf16 workspace; partial (splits, n, d)
// fp32 workspace (null when splits is 1) — contiguous, 16-byte aligned, on
// the current device. bn1: pass 1's tile width (128 or 32); splits: pass
// 2's K slices over f.
// Launches on `stream`; returns 0 or the CUDA error code (1000 + CUresult
// when a tensor map cannot be built).
int hmm_fused_mlp_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, void* hidden, void* partial, int n, int d, int f,
                       int bn1, int splits, void* stream) {
  return mlp(x, nullptr, nullptr, 0.0f, nullptr, w1, static_cast<const float*>(b1), w2,
             static_cast<const float*>(b2), nullptr, out, hidden, partial, n, d, f, bn1, splits,
             stream);
}

// K3. As K2, plus gamma/beta (d,) fp32, eps, resid (n, d) bf16 and normed
// (n, d) bf16, the workspace of t = LN(x): out = resid + K2(t), or K2(t) when
// resid is null (a tensor-parallel shard other than the first, whose sum
// with the first's adds the residual once).
int hmm_fused_ln_mlp_residual_bf16(const void* x, const void* gamma, const void* beta,
                                   const void* w1, const void* b1, const void* w2, const void* b2,
                                   const void* resid, void* out, void* normed, void* hidden,
                                   void* partial, int n, int d, int f, int bn1, int splits,
                                   float eps, void* stream) {
  return mlp(x, static_cast<const float*>(gamma), static_cast<const float*>(beta), eps, normed, w1,
             static_cast<const float*>(b1), w2, static_cast<const float*>(b2), resid, out, hidden,
             partial, n, d, f, bn1, splits, stream);
}

// dynamic shared memory of one GEMM block at tile width bn (ring, barriers,
// alignment slack), for reports
int hmm_fused_mlp_smem_bytes(int bn) { return smem_bytes(bn); }

}  // extern "C"
