// K2 and K3 at fp32: the fused transformer MLP for Hopper (sm_90a) when x
// and the weights are fp32.
//   K2:  out = (gelu(x·W1ᵀ + b1))·W2ᵀ + b2     (exact-erf GELU)
//   K3:  out = x + K2(LN(x))                  (LN statistics and affine in fp32)
//
// Replaces the same Pallas TPU kernels as fused_mlp.cu, for the fp32
// operands the JAX package passes them (its fp32 towers and its training,
// which runs in fp32): `_mlp_kernel` (K2, reached through `fused_mlp`) and
// `_ln_mlp_kernel` (K3, through `fused_ln_mlp_residual`) of
// hippomm_tpu/ops/fused_mlp.py. Those compute in the operand dtype, so at
// fp32 both products accumulate fp32 products of fp32 operands.
//
// Products: 3×TF32 on the tensor cores. TF32 keeps 10 mantissa bits, which
// alone fails the reference's fp32 tolerance, so each operand element v is
// split into hi = tf32(v) and lo = tf32(v − hi) (round to nearest, ties
// away: cvt.rna), and a·b is taken as a_hi·b_hi + a_hi·b_lo + a_lo·b_hi; the
// dropped a_lo·b_lo is about 2⁻²² of a·b. The tensor cores' fp32
// accumulation loses more than fp32 rounding would as it adds (one
// accumulator over K 5120 came to 4.7e-5 of max |out| from the plain
// version, at the 5e-5 gate), so a tile's products go into a partial
// accumulator that is added to the tile's fp32 sum on the CUDA cores every
// kPromote k-steps (256 of K): 6.4e-6 then.
//
// Bound on the H100: 4·N·D·F operations, three times over as TF32 at 495
// TF/s (1.31 ms at the vision shape (8224, 1280, 5120), 1.26 ms at audio's
// (21984, 768, 3072)), against x, W1, W2 and the output once at 3.35 TB/s,
// which bounds the text tower's (77, 1024, 4096): 33.5 MB of weights, 0.010
// ms.
//
// Design, as fused_mlp.cu's two passes (the hidden goes through device
// memory, in fp32 here), each a "TN" GEMM whose operands are both K-major as
// stored, as tf32 wgmma needs (it has no transpose):
//   pass 1 (fc1): H = gelu(x·W1ᵀ + b1)          — A x (or t), B W1 (F, D)
//   pass 2 (fc2): out = H·W2ᵀ + b2 [+ x for K3]  — A H,        B W2 (D, F)
// with the MLP's elementwise work in each pass's epilogue, in registers.
// The A operands come split from device memory, as hi and lo arrays: pass
// 1's from a row kernel (K3's LN, one warp a row, fp32 mean, then the mean
// of squared deviations, writes t = LN(x) split; K2's `split_rows_f32`
// splits x), pass 2's from pass 1's epilogue, which writes the hidden
// split. An activation is split once so, where splitting it per tile in
// shared memory repeats the work for every column tile (40 at the vision
// fc1): the hidden's second array costs 2·N·F·4 bytes of traffic, and the
// weights are never copied (at the text tower's rows they are the bytes).
// Each pass is one persistent, warp-specialised kernel (`gemm_tf32x3`):
//   * one producer thread issues TMA loads of 128-byte-swizzled (128 × 32)
//     A hi and lo and (BN × 32) fp32 B tiles (32 floats: the 128-byte row
//     that a bf16 stage holds as 64 values, so the swizzle and the
//     descriptor walk are fused_mlp.cu's) into a ring with full/empty
//     mbarriers; rows past N are zero-filled, so nothing is padded or
//     sliced;
//   * two consumer warpgroups share each 128 × BN output tile, 64 rows each
//     (cooperative, not ping-pong: the registers a ping-pong warpgroup would
//     spend on a second 64-row half hold the partial accumulator instead).
//     Each splits its half of a landed stage's B in shared memory: hi over
//     the fp32 value in place, lo at the same offset of one of three lo
//     buffers (the same swizzled layout, so one descriptor walk serves
//     both), then a proxy fence and a barrier of both warpgroups; then
//     3 × 4 wgmma m64nBNk8 per k-step, the next k-step's B split while they
//     run. Each weight byte still comes from device memory once.
// What bounds it (measured, chip_smoke.py phase 2 and
// scripts/torch_fused_mlp_variants.py --f32, PERF.md): the B split, on the
// consumer warps' path, adds its time to the products' instead of hiding
// under them. Measured slower: A split in shared memory too (the first
// design), A from registers (the wgmma RS form; it spills under the
// 168-register cap of a 384-thread block), and the split moved to the
// producer warpgroup's three spare warps (too few threads to hide
// shared-memory latency).
// Tile plans, chosen by the wrapper (ops/fused_mlp._plan_f32) from (N, D,
// F): 128 × 128 tiles at the ingest and training shapes; where a pass has
// less than a wave of 132 tiles, pass 1 narrows BN (to 32 at the text
// tower's 77 rows) and pass 2 splits K over F, each block writing an fp32
// partial of its F-slice to a workspace that `splitk_reduce_f32` sums,
// adding b2 and x.
// CUDA kernels per call: 3 (the A split or LN, two passes), 4 with split-K.
//
// Requirements (checked by the wrappers): N ≥ 8; D and F multiples of 128;
// all tensors contiguous fp32 and 16-byte aligned; the split hidden (2, N,
// F), the split pass-1 A (2, N, D) and the split-K partials (splits, N, D)
// are workspaces the wrapper allocates.

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;            // rows per tile: one m64 half per consumer warpgroup
constexpr int kBK = 32;             // K per stage: one 128-byte swizzle row of fp32
constexpr int kConsumers = 2;       // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kLoBufs = 3;          // lo buffers, used in turn by the k-steps
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may have
constexpr int kPromote = 8;         // k-steps a partial accumulator sums
constexpr int kBN2 = 128;           // pass 2's tile width
constexpr int kSplitBarrier = 1;    // named barrier: both warpgroups' splits are written
constexpr int kLnWarps = 8;         // rows a block of the LN kernel

enum Epilogue { kGelu, kBias, kBiasResidual, kPartial };

// a stage: A's hi and lo (128 × 32 each), then B (bn × 32), fp32; a lo
// buffer: B's lo
__host__ __device__ constexpr int stage_bytes(int bn) { return (2 * kBM + bn) * kBK * 4; }
__host__ __device__ constexpr int lo_bytes(int bn) { return bn * kBK * 4; }
__host__ __device__ constexpr int ring_stages(int bn) {
  return (kSmemMax - 2048 - kLoBufs * lo_bytes(bn)) / stage_bytes(bn) < 8
             ? (kSmemMax - 2048 - kLoBufs * lo_bytes(bn)) / stage_bytes(bn)
             : 8;
}
// ring + lo buffers + full/empty barriers + slack to align to 1024 bytes
// (128B swizzle)
__host__ __device__ constexpr int smem_bytes(int bn) {
  return ring_stages(bn) * stage_bytes(bn) + kLoBufs * lo_bytes(bn) + 2 * ring_stages(bn) * 8 + 1024;
}

struct GemmArgs {
  int m, n, k;          // C (m, n) = A (m, k) · B (n, k)ᵀ
  int splits;           // K slices; > 1 only with kPartial
  const float* bias;    // (n,)
  const float* resid;   // (m, n), kBiasResidual
  float* out;           // (m, n), or (splits, m, n) for kPartial; kGelu: C's hi
  float* out_lo;        // kGelu: C's lo (m, n), pass 2's A split as it is written
};

// hi over v in place, lo at the same index of `lo`: V float4s a consumer
// thread, thread t taking t, t + 128, ...
template <int V>
__device__ __forceinline__ void split_tf32(float4* at, float4* lo, int t) {
#pragma unroll
  for (int i = 0; i < V; ++i) split4(at[t + 128 * i], at[t + 128 * i], lo[t + 128 * i]);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// a tile's epilogue: acc[4j + 2h + e] is row 64·wg + 16·warp + lane/4 + 8h,
// column 8j + 2·(lane%4) + e of the tile; EPI's elementwise tail, then
// float2 stores (a quad of lanes writes 32 contiguous bytes of a row)
template <int BN, int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], const GemmArgs& args, int tile,
                                         int m_tiles, int n_tiles, int wg, int warp, int lane) {
  const int split = tile / (m_tiles * n_tiles), rest = tile % (m_tiles * n_tiles);
  const int row0 = (rest / n_tiles) * kBM + wg * 64 + warp * 16 + lane / 4;
  const int col0 = (rest % n_tiles) * BN + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= args.m) continue;
    const int64_t base = (EPI == kPartial ? (int64_t)split * args.m + row : (int64_t)row) * args.n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if constexpr (EPI != kPartial) {
        const float2 b = *reinterpret_cast<const float2*>(args.bias + col);
        v.x += b.x;
        v.y += b.y;
        if constexpr (EPI == kGelu) {
          v.x = gelu_erf(v.x);
          v.y = gelu_erf(v.y);
          const float2 h = make_float2(tf32_rna(v.x), tf32_rna(v.y));
          *reinterpret_cast<float2*>(args.out_lo + base + col) =
              make_float2(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y));
          v = h;
        } else if constexpr (EPI == kBiasResidual) {
          const float2 r = *reinterpret_cast<const float2*>(args.resid + base + col);
          v.x += r.x;
          v.y += r.y;
        }
      }
      *reinterpret_cast<float2*>(args.out + base + col) = v;
    }
  }
}

// One GEMM pass: C = A·Bᵀ over the output tiles this block takes (tile
// blockIdx.x + i·gridDim.x, tile t = ((split · m_tiles) + mt) · n_tiles +
// nt), with EPI's elementwise tail. Warpgroups 0-1 consume (warpgroup w
// the tile's rows 64w .. 64w + 63), warpgroup 2's first thread produces.
// Both consumers take every k-step of every tile, so they wait on the ring
// in step; k-step c (counted over the block's tiles) uses ring stage
// c % kStages and lo buffer c % kLoBufs, and is split while k-step c − 1's
// products run. Lo buffer c % 3 is rewritten by k-step c + 3's split, after
// both warpgroups passed the barrier that ends k-step c + 1, which each
// reaches after waiting on its k-step-c products.
template <int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3(const __grid_constant__ CUtensorMap ta_hi, const __grid_constant__ CUtensorMap ta_lo,
            const __grid_constant__ CUtensorMap tb, const GemmArgs args) {
  static_assert(BN == 32 || BN == 128, "tile widths: 32, 128");
  constexpr int kStages = ring_stages(BN);
  constexpr int kA = kBM * kBK * 4;       // A's hi (then its lo) in a stage
  constexpr int kHalfA = kA / 2;          // a warpgroup's 64 rows of it
  constexpr int kHalfB = BN * kBK * 2;    // a warpgroup's BN / 2 rows of B (it splits them)
  constexpr int kStage = stage_bytes(BN), kLo = lo_bytes(BN);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* const ring_ptr = smem_raw + (ring - raw);
  const uint32_t lo_ring = ring + kStages * kStage;  // kLoBufs × kLo
  const uint32_t full = lo_ring + kLoBufs * kLo;     // kStages × 8 bytes
  const uint32_t empty = full + kStages * 8;

  const int m_tiles = (args.m + kBM - 1) / kBM, n_tiles = args.n / BN;
  const int tiles = m_tiles * n_tiles * args.splits;
  const int ksteps = args.k / kBK / args.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival per consumer warp
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
          tma_load(a, &ta_hi, (kstep0 + kk) * kBK, row0, full + 8 * stage);
          tma_load(a + kA, &ta_lo, (kstep0 + kk) * kBK, row0, full + 8 * stage);
          tma_load(a + 2 * kA, &tb, (kstep0 + kk) * kBK, col0, full + 8 * stage);
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
    // split k-step c's B once its stage lands (A comes split): this
    // warpgroup's half, hi in place, lo into lo buffer c % kLoBufs
    auto split = [&](int c) {
      const int stage = c % kStages;
      mbar_wait(full + 8 * stage, (c / kStages) & 1);
      split_tf32<kHalfB / 2048>(
          reinterpret_cast<float4*>(ring_ptr + stage * kStage + 2 * kA + wg * kHalfB),
          reinterpret_cast<float4*>(ring_ptr + kStages * kStage + c % kLoBufs * kLo + wg * kHalfB), t);
      fence_proxy_async();  // the generic-proxy writes before the wgmmas' async-proxy reads
    };
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
    // the block's k-steps over all its tiles, in order; k-step c + 1 is split
    // while k-step c's products run
    const int total = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * ksteps;
    if (total > 0) split(0);
    named_barrier_sync(kSplitBarrier);  // both halves of k-step 0 are split
    int prev = -1;
    for (int c = 0; c < total; ++c) {
      const int kk = c % ksteps, tile = blockIdx.x + c / ksteps * gridDim.x;
      const int stage = c % kStages;
      const uint32_t at = ring + stage * kStage;
      const uint64_t dah = desc_k<128>(at + wg * kHalfA), dal = desc_k<128>(at + kA + wg * kHalfA);
      const uint64_t dbh = desc_k<128>(at + 2 * kA), dbl = desc_k<128>(lo_ring + c % kLoBufs * kLo);
      // the partial's k-steps; warpgroup 1's are offset by half of them,
      // so that the two drain the tensor pipe at different k-steps
      const int pos = (kk + wg * (kPromote / 2)) % kPromote;
      const bool fresh = kk == 0 || pos == 0, last = kk == ksteps - 1 || pos == kPromote - 1;
      wgmma_fence();
      fence_acc(part);
#pragma unroll
      for (int k8 = 0; k8 < kBK / 8; ++k8) {
        wgmma_tf32<BN>(part, dah + 2 * k8, dbh + 2 * k8, (k8 > 0 || !fresh) ? 1 : 0);
        wgmma_tf32<BN>(part, dah + 2 * k8, dbl + 2 * k8, 1);
        wgmma_tf32<BN>(part, dal + 2 * k8, dbh + 2 * k8, 1);
      }
      wgmma_commit();
      fence_acc(part);
      if (c + 1 < total) split(c + 1);
      if (last) {
        wgmma_wait<0>();
        fence_acc(part);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[e] += part[e];
      } else {
        wgmma_wait<1>();  // the previous k-step's products are done: free its stage
      }
      if (prev >= 0 && signal) mbar_arrive(empty + 8 * prev);
      prev = stage;
      if (kk == ksteps - 1) {
        // the tile's last k-step waited on every product
        if (signal) mbar_arrive(empty + 8 * prev);
        prev = -1;
        epilogue<BN, EPI>(acc, args, tile, m_tiles, n_tiles, wg, warp, lane);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
      }
      named_barrier_sync(kSplitBarrier);  // both halves of k-step c + 1 are split
    }
  }
}

// t = LN(x)·gamma + beta, one warp a row: fp32 mean, then the mean of the
// squared deviations (the plain version's order); written split, as pass
// 1's A: t_hi = tf32(t), t_lo = tf32(t − t_hi)
__global__ void __launch_bounds__(32 * kLnWarps)
layer_norm_rows_f32(const float* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ t_hi, float* __restrict__ t_lo,
                    int n, int d, float eps) {
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* xr = x + (int64_t)row * d;
  float sum = 0.0f;
  for (int c = lane; c < d; c += 32) sum += xr[c];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mu = sum / (float)d;
  float sq = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float e = xr[c] - mu;
    sq += e * e;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rs = rsqrtf(sq / (float)d + eps);
  for (int c = lane; c < d; c += 32) {
    const float y = (xr[c] - mu) * rs * gamma[c] + beta[c], h = tf32_rna(y);
    t_hi[(int64_t)row * d + c] = h;
    t_lo[(int64_t)row * d + c] = tf32_rna(y - h);
  }
}

// K2's pass-1 A: x_hi = tf32(x), x_lo = tf32(x − x_hi), four elements a
// thread
__global__ void __launch_bounds__(256)
split_rows_f32(const float* __restrict__ x, float* __restrict__ x_hi, float* __restrict__ x_lo, int64_t n) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  split4(*reinterpret_cast<const float4*>(x + i), *reinterpret_cast<float4*>(x_hi + i),
         *reinterpret_cast<float4*>(x_lo + i));
}

// split-K's last step: out = (Σ partials + b2) [+ x], four columns a thread
__global__ void __launch_bounds__(256)
splitk_reduce_f32(const float* __restrict__ partial, int splits, const float* __restrict__ bias,
                  const float* __restrict__ resid, float* __restrict__ out, int m, int n) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= (int64_t)m * n) return;
  float4 s = *reinterpret_cast<const float4*>(partial + i);
  for (int p = 1; p < splits; ++p) {
    const float4 v = *reinterpret_cast<const float4*>(partial + (int64_t)p * m * n + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float4 b = *reinterpret_cast<const float4*>(bias + i % n);
  s = make_float4(s.x + b.x, s.y + b.y, s.z + b.z, s.w + b.w);
  if (resid != nullptr) {
    const float4 r = *reinterpret_cast<const float4*>(resid + i);
    s = make_float4(s.x + r.x, s.y + r.y, s.z + r.z, s.w + r.w);
  }
  *reinterpret_cast<float4*>(out + i) = s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// (rows, cols) row-major fp32 → (box_rows × 32) boxes, 128B swizzle; rows
// past the end read as zeros
int make_map(CUtensorMap* map, const float* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kMapError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// A given split as (a_hi, a_lo), both (m, k); B (n, k) fp32
template <int BN, int EPI>
int gemm(const float* a_hi, const float* a_lo, const float* b, const GemmArgs& args, cudaStream_t stream) {
  static bool sized[kMaxDevices] = {};  // the ring's shared memory, set once per device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int sms = sm_count(dev);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  CUtensorMap ta_hi, ta_lo, tb;
  int rc = make_map(&ta_hi, a_hi, args.m, args.k, kBM);
  if (rc == 0) rc = make_map(&ta_lo, a_lo, args.m, args.k, kBM);
  if (rc == 0) rc = make_map(&tb, b, args.n, args.k, BN);
  if (rc != 0) return rc;
  if (!sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tf32x3<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BN));
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  const int tiles = (args.m + kBM - 1) / kBM * (args.n / BN) * args.splits;
  gemm_tf32x3<BN, EPI><<<tiles < sms ? tiles : sms, kThreads, smem_bytes(BN), stream>>>(ta_hi, ta_lo, tb,
                                                                                         args);
  return (int)cudaGetLastError();
}

// the whole MLP; gamma != nullptr makes it K3. normed (2, n, d) takes pass
// 1's A split (LN(x) for K3, x for K2), hidden (2, n, f) the hidden split
// as pass 1 writes it (hi, then lo); resid != nullptr adds that (n, d)
// residual in pass 2's epilogue (or the split-K reduce)
int mlp(const float* x, const float* gamma, const float* beta, float eps, float* normed, const float* w1,
        const float* b1, const float* w2, const float* b2, const float* resid, float* out, float* hidden,
        float* partial, int n, int d, int f, int bn1, int splits, void* stream_) {
  if (n < 8 || d < 128 || f < 128 || d % 128 || f % 128 || (bn1 != 128 && bn1 != 32) ||
      splits < 1 || (f / kBK) % splits || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  float* const a_lo = normed + (int64_t)n * d;
  if (gamma != nullptr) {
    layer_norm_rows_f32<<<(n + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, stream>>>(x, gamma, beta, normed,
                                                                                   a_lo, n, d, eps);
  } else {
    const int64_t vecs = (int64_t)n * d / 4;
    split_rows_f32<<<(unsigned)((vecs + 255) / 256), 256, 0, stream>>>(x, normed, a_lo, (int64_t)n * d);
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // pass 1: hidden = gelu(a·W1ᵀ + b1), split, at one of the plans' tile widths
  float* const h_lo = hidden + (int64_t)n * f;
  const GemmArgs args1{n, f, d, 1, b1, nullptr, hidden, h_lo};
  rc = bn1 == 128 ? gemm<128, kGelu>(normed, a_lo, w1, args1, stream)
                  : gemm<32, kGelu>(normed, a_lo, w1, args1, stream);
  if (rc != 0) return rc;
  // pass 2: out = hidden·W2ᵀ + b2 (+ x), or fp32 partials of its K slices
  if (splits == 1) {
    const GemmArgs args2{n, d, f, 1, b2, resid, out, nullptr};
    return resid != nullptr ? gemm<kBN2, kBiasResidual>(hidden, h_lo, w2, args2, stream)
                            : gemm<kBN2, kBias>(hidden, h_lo, w2, args2, stream);
  }
  rc = gemm<kBN2, kPartial>(hidden, h_lo, w2, GemmArgs{n, d, f, splits, nullptr, nullptr, partial, nullptr},
                            stream);
  if (rc != 0) return rc;
  const int64_t vecs = (int64_t)n * d / 4;
  splitk_reduce_f32<<<(unsigned)((vecs + 255) / 256), 256, 0, stream>>>(partial, splits, b2, resid, out, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 at fp32. x (n, d); w1 (f, d); b1 (f,); w2 (d, f); b2 (d,); out (n, d);
// normed (2, n, d), hidden (2, n, f) and partial (splits, n, d; null when
// splits is 1) workspaces — fp32, contiguous, 16-byte aligned, on the
// current device. bn1: pass 1's tile width (128 or 32); splits: pass 2's
// K slices over f. Launches on `stream`; returns 0 or the CUDA error code
// (1000 + CUresult when a tensor map cannot be built).
int hmm_fused_mlp_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                      void* out, void* normed, void* hidden, void* partial, int n, int d, int f, int bn1,
                      int splits, void* stream) {
  return mlp(static_cast<const float*>(x), nullptr, nullptr, 0.0f, static_cast<float*>(normed),
             static_cast<const float*>(w1), static_cast<const float*>(b1), static_cast<const float*>(w2),
             static_cast<const float*>(b2), nullptr, static_cast<float*>(out), static_cast<float*>(hidden),
             static_cast<float*>(partial), n, d, f, bn1, splits, stream);
}

// K3 at fp32. As K2, plus gamma/beta (d,), eps and resid (n, d), with LN(x)
// in place of x: out = resid + K2(LN(x)), or K2(LN(x)) when resid is null
// (a tensor-parallel shard other than the first).
int hmm_fused_ln_mlp_residual_f32(const void* x, const void* gamma, const void* beta, const void* w1,
                                  const void* b1, const void* w2, const void* b2, const void* resid,
                                  void* out, void* normed, void* hidden, void* partial, int n, int d, int f,
                                  int bn1, int splits, float eps, void* stream) {
  return mlp(static_cast<const float*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
             eps, static_cast<float*>(normed), static_cast<const float*>(w1), static_cast<const float*>(b1),
             static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<const float*>(resid),
             static_cast<float*>(out), static_cast<float*>(hidden), static_cast<float*>(partial), n, d, f, bn1,
             splits, stream);
}

// dynamic shared memory of one GEMM block at tile width bn (ring, lo
// buffers, barriers, alignment slack), for reports
int hmm_fused_mlp_f32_smem_bytes(int bn) { return smem_bytes(bn); }

}  // extern "C"
