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
// fp32 both products accumulate fp32 products of fp32 operands. So does this
// code, on the CUDA cores (fp32 FMA): the tensor cores take fp32 only as
// TF32, which keeps about three decimal digits and fails the reference's
// fp32 tolerance.
//
// Bound on the H100: 4·N·D·F fp32 operations at 67 TF/s against x, W1, W2
// and the output once at 3.35 TB/s: the operations bound every path shape
// (vision (8224, 1280, 5120) 3.22 ms, audio (21984, 768, 3072) 3.10 ms,
// the text tower's (77, 1024, 4096) 0.019 ms against its 0.034 ms weight
// read — that one the bytes bound).
//
// Design, as fused_mlp.cu's two passes (the hidden goes through device
// memory, in fp32 here), each a tiled SIMT GEMM whose operands are both
// K-major as stored ("TN"):
//   pass 1 (fc1): H = gelu(x·W1ᵀ + b1)          — A x (or t), B W1 (F, D)
//   pass 2 (fc2): out = H·W2ᵀ + b2 [+ x for K3]  — A H,        B W2 (D, F)
// with the MLP's elementwise work in each pass's epilogue, in registers.
// K3 first writes t = LN(x) with a row kernel (one warp a row, fp32 mean,
// then the mean of squared deviations), into an (N, D) fp32 workspace.
// `gemm_f32`: a block of 256 threads computes one BM × BN output tile (128
// × 128, or 64 × 64 where 128-wide tiles would not fill the card: the text
// tower's rows; ops/fused_mlp._plan_f32 picks) over K in steps of 16. The
// A and B slices of a step are read from device memory as float4 rows and
// stored k-major into shared memory (double-buffered: the next step's loads
// are in flight during this step's products); each thread then owns an 8 × 8
// (or 4 × 4) block of the tile, split into 4 × 4 quads 64 rows and columns
// apart so that its float4 shared-memory reads hit distinct banks, and
// issues 64 FMAs per 4 float4 reads. Rows past N read zeros and are not
// written. Making it faster (3×TF32 on the tensor cores, TMA) is later work.
// CUDA kernels per call: K2 2, K3 3.
//
// Requirements (checked by the wrappers): N ≥ 1; D and F multiples of 128;
// all tensors contiguous fp32 and 16-byte aligned; the hidden (N, F) and
// K3's t (N, D) are workspaces the wrapper allocates.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 × 16
constexpr int kBK = 16;        // K per step
constexpr int kPad = 4;        // floats after each k-row of the A and B tiles
constexpr int kLnWarps = 8;    // rows a block of the LN kernel

enum Epilogue { kGelu = 0, kBias = 1, kBiasResidual = 2 };

// C (M, N) = epilogue(A (M, K) · B (N, K)ᵀ), one BM × BN tile a block
template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
gemm_f32(const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ bias,
         const float* __restrict__ R, float* __restrict__ C, int M, int N, int K) {
  constexpr int kGm = BM / 64, kGn = BN / 64;  // 4 × 4 quads a thread, 64 apart
  constexpr int kLda = BM + kPad, kLdb = BN + kPad;
  __shared__ __align__(16) float as[2][kBK][kLda];
  __shared__ __align__(16) float bs[2][kBK][kLdb];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_tiles = N / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;
  // the step's loads: float4 (row, k4) with row = tid / 4 + 64·p, k4 = 4·(tid % 4)
  const int lr = tid >> 2, lk = 4 * (tid & 3);
  float4 ra[kGm], rb[kGn];
  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < kGm; ++p) {
      const int m = m0 + lr + 64 * p;
      ra[p] = m < M ? __ldg(reinterpret_cast<const float4*>(A + (int64_t)m * K + k0 + lk))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int p = 0; p < kGn; ++p)
      rb[p] = __ldg(reinterpret_cast<const float4*>(B + (int64_t)(n0 + lr + 64 * p) * K + k0 + lk));
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int p = 0; p < kGm; ++p) {
      as[buf][lk + 0][lr + 64 * p] = ra[p].x;
      as[buf][lk + 1][lr + 64 * p] = ra[p].y;
      as[buf][lk + 2][lr + 64 * p] = ra[p].z;
      as[buf][lk + 3][lr + 64 * p] = ra[p].w;
    }
#pragma unroll
    for (int p = 0; p < kGn; ++p) {
      bs[buf][lk + 0][lr + 64 * p] = rb[p].x;
      bs[buf][lk + 1][lr + 64 * p] = rb[p].y;
      bs[buf][lk + 2][lr + 64 * p] = rb[p].z;
      bs[buf][lk + 3][lr + 64 * p] = rb[p].w;
    }
  };

  float acc[4 * kGm][4 * kGn];
#pragma unroll
  for (int i = 0; i < 4 * kGm; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kGn; ++j) acc[i][j] = 0.0f;

  const int steps = K / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load((s + 1) * kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[4 * kGm], b[4 * kGn];
#pragma unroll
      for (int g = 0; g < kGm; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&as[cur][k][64 * g + 4 * ty]);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < kGn; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&bs[cur][k][64 * g + 4 * tx]);
        b[4 * g] = v.x;
        b[4 * g + 1] = v.y;
        b[4 * g + 2] = v.z;
        b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * kGm; ++i)
#pragma unroll
        for (int j = 0; j < 4 * kGn; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in step s - 1, which every thread has
    // finished (the barrier below it)
    if (s + 1 < steps) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < kGm; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 64 * g + 4 * ty + i;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < kGn; ++h) {
        const int n = n0 + 64 * h + 4 * tx;
        const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + n));
        float4 y = make_float4(acc[4 * g + i][4 * h] + bv.x, acc[4 * g + i][4 * h + 1] + bv.y,
                               acc[4 * g + i][4 * h + 2] + bv.z, acc[4 * g + i][4 * h + 3] + bv.w);
        if (EPI == kGelu) {
          y.x = 0.5f * y.x * (1.0f + erff(y.x * 0.70710678118654752f));
          y.y = 0.5f * y.y * (1.0f + erff(y.y * 0.70710678118654752f));
          y.z = 0.5f * y.z * (1.0f + erff(y.z * 0.70710678118654752f));
          y.w = 0.5f * y.w * (1.0f + erff(y.w * 0.70710678118654752f));
        } else if (EPI == kBiasResidual) {
          const float4 r = __ldg(reinterpret_cast<const float4*>(R + (int64_t)m * N + n));
          y.x += r.x;
          y.y += r.y;
          y.z += r.z;
          y.w += r.w;
        }
        *reinterpret_cast<float4*>(C + (int64_t)m * N + n) = y;
      }
    }
}

// t = LN(x)·gamma + beta, one warp a row: fp32 mean, then the mean of the
// squared deviations (the plain version's order)
__global__ void __launch_bounds__(32 * kLnWarps)
layer_norm_rows_f32(const float* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ t, int n, int d, float eps) {
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
  float* tr = t + (int64_t)row * d;
  for (int c = lane; c < d; c += 32) tr[c] = (xr[c] - mu) * rs * gamma[c] + beta[c];
}

template <int EPI>
int gemm(int tile, const float* A, const float* B, const float* bias, const float* R, float* C, int M,
         int N, int K, cudaStream_t stream) {
  if (tile != 128 && tile != 64) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)((M + tile - 1) / tile) * (N / tile);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (tile == 128)
    gemm_f32<128, 128, EPI><<<(int)blocks, kThreads, 0, stream>>>(A, B, bias, R, C, M, N, K);
  else
    gemm_f32<64, 64, EPI><<<(int)blocks, kThreads, 0, stream>>>(A, B, bias, R, C, M, N, K);
  return (int)cudaGetLastError();
}

int mlp(const float* x, const float* gamma, const float* beta, float eps, float* normed, const float* w1,
        const float* b1, const float* w2, const float* b2, const float* resid, float* out, float* hidden,
        int n, int d, int f, int tile1, int tile2, void* stream_) {
  if (n < 1 || d < 128 || f < 128 || d % 128 || f % 128) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const float* a = x;
  if (gamma != nullptr) {
    layer_norm_rows_f32<<<(n + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, stream>>>(x, gamma, beta, normed,
                                                                                   n, d, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a = normed;
  }
  int rc = gemm<kGelu>(tile1, a, w1, b1, nullptr, hidden, n, f, d, stream);
  if (rc != 0) return rc;
  if (resid != nullptr) return gemm<kBiasResidual>(tile2, hidden, w2, b2, resid, out, n, d, f, stream);
  return gemm<kBias>(tile2, hidden, w2, b2, nullptr, out, n, d, f, stream);
}

}  // namespace

extern "C" {

// K2 at fp32. x (n, d); w1 (f, d); b1 (f,); w2 (d, f); b2 (d,); out (n, d);
// hidden (n, f) workspace — fp32, contiguous, 16-byte aligned, on the
// current device. tile1 / tile2: pass 1's and pass 2's square tile (128 or
// 64). Launches on `stream`; returns 0 or the CUDA error code.
int hmm_fused_mlp_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                      void* out, void* hidden, int n, int d, int f, int tile1, int tile2, void* stream) {
  return mlp(static_cast<const float*>(x), nullptr, nullptr, 0.0f, nullptr, static_cast<const float*>(w1),
             static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<const float*>(b2),
             nullptr, static_cast<float*>(out), static_cast<float*>(hidden), n, d, f, tile1, tile2, stream);
}

// K3 at fp32. As K2, plus gamma/beta (d,), eps, resid (n, d) and normed
// (n, d), the workspace of t = LN(x): out = resid + K2(t), or K2(t) when
// resid is null (a tensor-parallel shard other than the first).
int hmm_fused_ln_mlp_residual_f32(const void* x, const void* gamma, const void* beta, const void* w1,
                                  const void* b1, const void* w2, const void* b2, const void* resid,
                                  void* out, void* normed, void* hidden, int n, int d, int f, int tile1,
                                  int tile2, float eps, void* stream) {
  return mlp(static_cast<const float*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
             eps, static_cast<float*>(normed), static_cast<const float*>(w1), static_cast<const float*>(b1),
             static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<const float*>(resid),
             static_cast<float*>(out), static_cast<float*>(hidden), n, d, f, tile1, tile2, stream);
}

}  // extern "C"
