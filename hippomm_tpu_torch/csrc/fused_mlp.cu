// K2 and K3: fused transformer MLP for Hopper (sm_90a), bf16.
//   K2:  out = cast(cast(x·W1ᵀ + b1) → exact-erf GELU → ·W2ᵀ + b2)
//   K3:  out = x + K2(cast(LN(x)))   (LN statistics and affine in fp32)
//
// K2 replaces the Pallas TPU kernel `_mlp_kernel` in
// hippomm_tpu/ops/fused_mlp.py (reached through `fused_mlp` /
// `fused_mlp_vjp`). As there, the (N, F) hidden activation — the largest
// tensor of an encoder block — never exists in device memory: each block
// owns a 32-row tile of x and walks the hidden dim in 128-wide chunks. Per
// chunk it computes the fc1 slice in registers, adds b1, rounds to bf16 (the
// cast-before-GELU of models/layers.py mlp), applies the exact erf GELU
// (CUDA has erff; the TPU kernel's Abramowitz–Stegun and polynomial erfs
// existed only because Mosaic has none), parks the bf16 chunk in shared
// memory, and accumulates its fc2 partial into a (32, D) fp32 accumulator
// kept in shared memory. After the last chunk it adds b2 and writes bf16
// once.
//
// K3 replaces the half-block kernel `_ln_mlp_kernel` of the same file
// (reached through `fused_ln_mlp_residual`): the encoder block's
// x + mlp(ln_2(x)) as one pass, so neither the LN output nor the MLP output
// reaches device memory. The TPU kernel keeps the LN'd tile resident in
// VMEM; here the (32, D) fp32 accumulator already takes 160 KB of the 227 KB
// a block may use at D 1280, and a resident (32, D) bf16 tile (80 KB) would
// not fit. K3 therefore runs K2's schedule with two additions: a prologue
// that computes each row's mean and rstd in fp32 (two passes over the row,
// as the TPU kernel) into 32 × 2 floats of shared memory, and an in-place
// normalisation of every X slice after its cp.async lands — each thread
// normalises the 16 bytes it copied itself, so the stage's existing barrier
// publishes them: y = (x − μ)·rstd·γ + β in fp32, rounded to bf16 (the TPU
// kernel's `t_ref[...] = y.astype(dt)`). That repeats per hidden chunk, a
// few elementwise operations per element against 2·128 multiply-adds. The
// epilogue rounds acc + b2 to bf16 and adds x, read again from device
// memory, in bf16 — the TPU kernel's order.
//
// Bound on the H100: 4·N·D·F flops (216 GFLOP for the ViT-H tower at 32
// frames) against ~N·D·4 + D·F·4 bytes — far above the ~295 flops per byte
// where bf16 tensor cores, not memory, are the limit: compute-bound. What
// holds this design back instead is L2: the 32-row tile is what the fp32
// accumulator allows (32 × 1280 × 4 B = 160 KB of the 227 KB a block may
// hold; 64 rows would not fit), so every row tile streams all of W1 and W2
// (26 MB bf16 at ViT-H, resident in the 50 MB L2) once. The weights flow
// through a two-stage cp.async ring of 64-wide slices while the previous
// slice feeds mma.sync m16n8k16 (bf16 in, fp32 accumulate) via ldmatrix.
// Splitting D across a thread-block cluster (bigger row tiles, less L2
// traffic) is the next step.
//
// Requirements (checked by the wrappers): N a multiple of 32 (the wrappers
// pad), D and F multiples of 128, D ≤ 1280, all tensors contiguous and
// 16-byte aligned; x, W1, W2 bf16; b1, b2, γ, β fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBM = 32;       // rows per block
constexpr int kBF = 128;      // hidden chunk
constexpr int kSL = 64;       // slice width of every pipeline stage
constexpr int kThreads = 256;  // 8 warps
constexpr int kXLD = kSL + 8;  // padded rows of the fc1 stage tiles (bf16)
constexpr int kWLD = kBF + 8;  // padded rows of the fc2 stage tile and of G (bf16)
constexpr int kStageBytes = (kBM + kBF) * kXLD * 2;  // X slice + W1 slice ≥ W2 slice
constexpr int kGBytes = kBM * kWLD * 2;
constexpr int kStatBytes = kBM * 2 * 4;  // K3: mean and rstd per row

__host__ __device__ inline int acc_ld(int d) { return d + 8; }  // ≡ 8 (mod 32): no float2 conflicts
__host__ __device__ inline int acc_bytes(int d) { return kBM * acc_ld(d) * 4; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K3 prologue: mean and rstd of each of the tile's 32 rows, fp32, two passes
// (mean, then the mean of squared deviations); warp w takes rows 4w..4w+3
__device__ void row_stats(const __nv_bfloat16* X, int d, float eps, float* stat_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = 0; rr < kBM / 8; ++rr) {
    const int row = warp * (kBM / 8) + rr;
    const __nv_bfloat16* xr = X + (int64_t)row * d;
    float s = 0.0f;
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
    }
    const float mean = warp_sum(s) / d;
    float s2 = 0.0f;
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = __bfloat162float(e[i]) - mean;
        s2 += t * t;
      }
    }
    const float var = warp_sum(s2) / d;
    if (lane == 0) {
      stat_s[2 * row] = mean;
      stat_s[2 * row + 1] = rsqrtf(var + eps);
    }
  }
}

// K3: LN affine of the 8 x values this thread copied into an X slice stage
// (row tid/8, columns k0 + 8·(tid%8) ..), in place, rounded to bf16
__device__ __forceinline__ void normalize_own(__nv_bfloat16* s, int k0, const float* stat_s,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta) {
  const int row = threadIdx.x >> 3, c = (threadIdx.x & 7) * 8;
  uint4* p = reinterpret_cast<uint4*>(s + row * kXLD + c);
  uint4 raw = *p;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
  const float mean = stat_s[2 * row], rstd = stat_s[2 * row + 1];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float y = (__bfloat162float(e[i]) - mean) * rstd;
    e[i] = __float2bfloat16(y * gamma[k0 + c + i] + beta[k0 + c + i]);
  }
  *p = raw;
}

// Stage st of the pipeline: per hidden chunk, D/64 fc1 slices (x[:, k:k+64]
// and W1[chunk, k:k+64]) then D/64 fc2 slices (W2[d:d+64, chunk]).
__device__ __forceinline__ void load_stage(int st, int ks, unsigned char* buf,
                                           const __nv_bfloat16* X, const __nv_bfloat16* w1,
                                           const __nv_bfloat16* w2, int d, int f) {
  const int chunk = st / (2 * ks), r = st % (2 * ks);
  const int f0 = chunk * kBF;
  __nv_bfloat16* s = reinterpret_cast<__nv_bfloat16*>(buf);
  if (r < ks) {
    const int k0 = r * kSL;
    {  // X slice: 32 rows × 8 vectors, one per thread
      const int row = threadIdx.x >> 3, v = threadIdx.x & 7;
      cp_async16(s + row * kXLD + v * 8, X + (int64_t)row * d + k0 + v * 8);
    }
    __nv_bfloat16* ws = s + kBM * kXLD;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // W1 slice: 128 rows × 8 vectors
      const int idx = threadIdx.x + i * kThreads, row = idx >> 3, v = idx & 7;
      cp_async16(ws + row * kXLD + v * 8, w1 + (int64_t)(f0 + row) * d + k0 + v * 8);
    }
  } else {
    const int d0 = (r - ks) * kSL;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // W2 slice: 64 rows × 16 vectors
      const int idx = threadIdx.x + i * kThreads, row = idx >> 4, v = idx & 15;
      cp_async16(s + row * kWLD + v * 8, w2 + (int64_t)(d0 + row) * f + f0 + v * 8);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// kLN = false: K2. kLN = true: K3 (gamma, beta, eps read; x added back).
template <bool kLN>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                 const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ gamma,
                 const float* __restrict__ beta, float eps, __nv_bfloat16* __restrict__ out,
                 int n, int d, int f) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = acc_ld(d);
  float* acc_s = reinterpret_cast<float*>(smem);
  __nv_bfloat16* g_s = reinterpret_cast<__nv_bfloat16*>(smem + acc_bytes(d));
  unsigned char* stage[2] = {smem + acc_bytes(d) + kGBytes,
                             smem + acc_bytes(d) + kGBytes + kStageBytes};
  float* stat_s = reinterpret_cast<float*>(smem + acc_bytes(d) + kGBytes + 2 * kStageBytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 1;            // 16-row half of the tile
  const int nb1 = (warp >> 1) * 32;   // fc1: this warp's 32 hidden columns of the chunk
  const int nb2 = (warp >> 1) * 16;   // fc2: this warp's 16 output columns of a slice
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const __nv_bfloat16* X = x + m0 * d;
  const int ks = d / kSL;
  const int total = (f / kBF) * 2 * ks;

  for (int i = threadIdx.x; i < kBM * lda; i += kThreads) acc_s[i] = 0.0f;
  if (kLN) {
    row_stats(X, d, eps, stat_s);
    __syncthreads();  // every thread normalises rows whose stats another warp computed
  }

  float h[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.0f;
  uint32_t ga[kBF / 16][4];

  load_stage(0, ks, stage[0], X, w1, w2, d, f);
  for (int st = 0; st < total; ++st) {
    if (st + 1 < total) {
      load_stage(st + 1, ks, stage[(st + 1) & 1], X, w1, w2, d, f);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    const int chunk = st / (2 * ks), r = st % (2 * ks);
    const int f0 = chunk * kBF;
    if (kLN && r < ks) {
      // this thread's own cp.async has landed (wait_group); the barrier
      // below publishes the normalised values to the other warps
      normalize_own(reinterpret_cast<__nv_bfloat16*>(stage[st & 1]), r * kSL, stat_s, gamma,
                    beta);
    }
    __syncthreads();
    const __nv_bfloat16* s = reinterpret_cast<const __nv_bfloat16*>(stage[st & 1]);
    if (r < ks) {
      // fc1: h (16 rows × 32 hidden) += x_slice · W1_sliceᵀ
      const __nv_bfloat16* ws = s + kBM * kXLD;
#pragma unroll
      for (int kk = 0; kk < kSL / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, s + (mt * 16 + (lane & 15)) * kXLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, ws + (nb1 + np * 16 + (lane & 7) + (lane >> 4) * 8) * kXLD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
          mma_bf16(h[2 * np], a, b[0], b[1]);
          mma_bf16(h[2 * np + 1], a, b[2], b[3]);
        }
      }
      if (r == ks - 1) {
        // + b1 → bf16 → exact GELU → bf16 into G; the chunk's fc2 reads it
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = nb1 + j * 8 + 2 * t4;
          const float bias0 = b1[f0 + col], bias1 = b1[f0 + col + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = mt * 16 + g + 8 * hh;
            const float v0 = gelu_erf(bf16_round(h[j][2 * hh] + bias0));
            const float v1 = gelu_erf(bf16_round(h[j][2 * hh + 1] + bias1));
            *reinterpret_cast<__nv_bfloat162*>(g_s + row * kWLD + col) =
                __floats2bfloat162_rn(v0, v1);
          }
          h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.0f;
        }
      }
    } else {
      const int j = r - ks;
      if (j == 0) {  // G was completed before this stage's barrier
#pragma unroll
        for (int kk = 0; kk < kBF / 16; ++kk)
          ldsm_x4(ga[kk], g_s + (mt * 16 + (lane & 15)) * kWLD + kk * 16 + (lane >> 4) * 8);
      }
      // fc2: acc[:, d0 + nb2 : +16] += G · W2_sliceᵀ
      const int d0 = j * kSL;
      float c[2][4];
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 v = *reinterpret_cast<const float2*>(
              acc_s + (mt * 16 + g + 8 * hh) * lda + d0 + nb2 + tt * 8 + 2 * t4);
          c[tt][2 * hh] = v.x;
          c[tt][2 * hh + 1] = v.y;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBF / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, s + (nb2 + (lane & 7) + (lane >> 4) * 8) * kWLD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(c[0], ga[kk], b[0], b[1]);
        mma_bf16(c[1], ga[kk], b[2], b[3]);
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          *reinterpret_cast<float2*>(acc_s + (mt * 16 + g + 8 * hh) * lda + d0 + nb2 + tt * 8 +
                                     2 * t4) = make_float2(c[tt][2 * hh], c[tt][2 * hh + 1]);
        }
      }
    }
    __syncthreads();  // this stage's buffer is refilled two stages on
  }

  for (int i = threadIdx.x; i < kBM * d; i += kThreads) {
    const int r = i / d, c = i % d;
    if (m0 + r >= n) continue;
    const __nv_bfloat16 y = __float2bfloat16(acc_s[r * lda + c] + b2[c]);
    if (kLN) {  // residual in bf16: cast, then add, as x + mlp(ln(x)).astype(bf16)
      out[(m0 + r) * d + c] = __float2bfloat16(__bfloat162float(X[(int64_t)r * d + c]) +
                                               __bfloat162float(y));
    } else {
      out[(m0 + r) * d + c] = y;
    }
  }
}

template <bool kLN>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* gamma, const void* beta, float eps, void* out, int n, int d, int f,
           void* stream) {
  if (n <= 0 || n % kBM || d % 128 || f % kBF || d > 1280) return (int)cudaErrorInvalidValue;
  const int bytes = acc_bytes(d) + kGBytes + 2 * kStageBytes + (kLN ? kStatBytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<kLN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_kernel<kLN><<<n / kBM, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), eps, static_cast<__nv_bfloat16*>(out), n, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2. x (n, d) bf16 with n % 32 == 0; w1 (f, d) bf16; b1 (f,) fp32; w2 (d, f)
// bf16; b2 (d,) fp32; out (n, d) bf16 — contiguous, 16-byte aligned, on the
// current device. Launches on `stream`; returns the CUDA error code (0 = ok).
int hmm_fused_mlp_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int n, int d, int f, void* stream) {
  return launch<false>(x, w1, b1, w2, b2, nullptr, nullptr, 0.0f, out, n, d, f, stream);
}

// K3. As K2, plus gamma/beta (d,) fp32 and eps: out = x + K2(LN(x)).
int hmm_fused_ln_mlp_residual_bf16(const void* x, const void* gamma, const void* beta,
                                   const void* w1, const void* b1, const void* w2, const void* b2,
                                   void* out, int n, int d, int f, float eps, void* stream) {
  return launch<true>(x, w1, b1, w2, b2, gamma, beta, eps, out, n, d, f, stream);
}

}  // extern "C"
