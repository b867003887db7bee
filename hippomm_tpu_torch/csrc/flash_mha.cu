// K1 and K4: mask-free multi-head attention forward for Hopper (sm_90a), bf16.
//
// Replaces two Pallas TPU kernels of hippomm_tpu/ops/flash_attention.py:
//   * K1 `_mha_kernel` (reached through `flash_mha`): q/k/v in the
//     head-split (B, H, T, hd) layout;
//   * K4 `_mha_kernel_bthd` (reached through `flash_mha_bthd`): q/k/v in the
//     native (B, T, H, hd) layout the QKV projection's reshape produces, so
//     the caller needs neither the three head-split transposes nor the
//     output merge.
// Both are one kernel here, written over element strides: a block reads row
// t of head h of batch b at b·s_b + h·s_h + t·s_t. K1 passes the strides of
// a contiguous (B·H, T, hd) tensor; K4 passes those of a (B, T, H, hd) view,
// whose row stride is H·hd for a (B, T, D) tensor and 3·D for a slice of a
// packed (B, T, 3D) projection — a view, never a copy. It computes, per
// (batch, head), softmax(q·kᵀ·scale) in fp32 → bf16 weights → ·v with fp32
// accumulation → bf16 output, without the (Tq, Tk) logits ever reaching
// device memory.
//
// Bound on the H100: at the ingest shapes (Tk 257 / 230, hd 80 / 64) the
// work is ~4·Tq·Tk·hd flops against q/k/v/o read and written once, about
// 130 flops per byte — under the card's ~295 bf16 flops per byte, so the
// kernel is bound by device-memory bytes (Whisper's Tk 1500 is ~730 flops
// per byte, bound by operations). The design keeps every byte to one read
// and the logits in registers (the FlashAttention-2 schedule): each block
// owns 64 query rows of one head (4 warps × 16 rows); K/V stream through
// shared memory in 64-key tiles; each warp keeps its Q fragments, its 16×64
// logits and its 16×hd output accumulator in registers and runs an online
// softmax there (running max m, running sum l, output rescaled by
// exp(m_old − m_new)). The logit accumulator's register layout is exactly
// the A-operand layout of the next product, so P never leaves registers.
//
// Numerics differ from the TPU kernels' default bodies in one place: the TPU
// bodies normalise the weights before the bf16 cast; an online softmax casts
// the unnormalised exp(s − m) and divides the fp32 output at the end (the
// TPU kernel's `defer_div` body). The two differ by ≤ 1 bf16 ulp.
//
// Tensor cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate) with
// ldmatrix from padded shared-memory rows. Ragged edges: K/V rows at and past
// Tk are zero-filled and their logits set to −inf; Q rows past Tq are zero
// and never stored. hd must be a multiple of 16 and at most 128 (the wrappers
// pad); every row start 16-byte aligned (strides multiples of 8 elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;  // query rows per block (4 warps × 16)
constexpr int kBK = 64;  // keys per K/V tile
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a · b for one m16n8k16 tile (a row-major 16×16, b col-major 16×8)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// element strides of one operand: batch, head, row (the hd axis is contiguous)
struct Strides {
  int64_t b, h, t;
};

// rows [r0, r0 + 64) of a (rows, HD) bf16 matrix whose rows are `ld`
// elements apart into a padded smem tile; rows at and past `rows` are zero
template <int HD, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                          int rows, int64_t ld) {
  constexpr int kVec = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) v = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

// grid (⌈tq/64⌉, B·nh); blockIdx.y = b·nh + h
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_mha_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int nh,
                 int tq, int tk, float scale, Strides sq, Strides sk, Strides sv, Strides so) {
  constexpr int LD = HD + 8;       // padded smem row (16-byte multiple, fewer bank conflicts)
  constexpr int KS = HD / 16;      // k-steps of Q·Kᵀ
  constexpr int NO = HD / 8;       // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + kBQ * LD;
  __nv_bfloat16* v_s = k_s + kBK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row group / column pair
  const int64_t bi = blockIdx.y / nh, hi = blockIdx.y % nh;
  const int q0 = blockIdx.x * kBQ;
  const __nv_bfloat16* Q = q + bi * sq.b + hi * sq.h;
  const __nv_bfloat16* K = k + bi * sk.b + hi * sk.h;
  const __nv_bfloat16* V = v + bi * sv.b + hi * sv.h;
  __nv_bfloat16* O = o + bi * so.b + hi * so.h;

  load_tile<HD, LD>(q_s, Q, q0, tq, sq.t);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qa[kk], smem_addr(q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};

  for (int kt0 = 0; kt0 < tk; kt0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD, LD>(k_s, K, kt0, tk, sk.t);
    load_tile<HD, LD>(v_s, V, kt0, tk, sv.t);
    __syncthreads();

    // S = Q_w · K_tileᵀ: 16 rows × 64 keys as eight n8 tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, smem_addr(k_s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                             ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }

    // online softmax; this thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + n * 8 + 2 * t4 + (e & 1);
        const float val = key < tk ? s[n][e] * scale : -INFINITY;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2], m_new[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m_run[h], mx[h]);  // finite: every tile holds a real key
      alpha[h] = expf(m_run[h] - m_new[h]);
      m_run[h] = m_new[h];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_new[e >> 1]);
        s[n][e] = p;
        rsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + rsum[h];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O_w += P · V_tile; P's accumulator layout is the A-operand layout
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_addr(v_s + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                   dp * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row < tq) {
      const float inv = 1.0f / l_run[h];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        __nv_bfloat162 val = __floats2bfloat162_rn(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row * so.t + n * 8 + 2 * t4) = val;
      }
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int nh, int tq,
                   int tk, float scale, Strides sq, Strides sk, Strides sv, Strides so,
                   cudaStream_t stream) {
  constexpr int bytes = (kBQ + 2 * kBK) * (HD + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kBQ - 1) / kBQ, b * nh);
  flash_mha_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), nh, tq, tk, scale,
      sq, sk, sv, so);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int b, int nh, int tq,
                     int tk, int hd, float scale, Strides sq, Strides sk, Strides sv, Strides so,
                     cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, b, nh, tq, tk, scale, sq, sk, sv, so, s);
    case 32: return launch<32>(q, k, v, o, b, nh, tq, tk, scale, sq, sk, sv, so, s);
    case 48: return launch<48>(q, k, v, o, b, nh, tq, tk, scale, sq, sk, sv, so, s);
    case 64: return launch<64>(q, k, v, o, b, nh, tq, tk, scale, sq, sk, sv, so, s);
    case 80: return launch<80>(q, k, v, o, b, nh, tq, tk, scale, sq, sk, sv, so, s);
    case 96: return launch<96>(q, k, v, o, b, nh, tq, tk, scale, sq, sk, sv, so, s);
    case 112: return launch<112>(q, k, v, o, b, nh, tq, tk, scale, sq, sk, sv, so, s);
    case 128: return launch<128>(q, k, v, o, b, nh, tq, tk, scale, sq, sk, sv, so, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K1. q (bh, tq, hd), k/v (bh, tk, hd), o (bh, tq, hd): contiguous bf16 on
// the current device, 16-byte aligned. Launches on `stream`; returns the CUDA
// error code (0 = ok).
int hmm_flash_mha_bf16(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                       int tk, int hd, float scale, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  const Strides sq{(int64_t)tq * hd, 0, hd}, skv{(int64_t)tk * hd, 0, hd};
  return (int)dispatch(q, k, v, o, bh, 1, tq, tk, hd, scale, sq, skv, skv, sq,
                       static_cast<cudaStream_t>(stream));
}

// K4. q (b, tq, h, hd), k/v (b, tk, h, hd) as strided views: element strides
// (batch, head, row) per operand, hd contiguous, every stride a multiple of 8
// and every row start 16-byte aligned. o (b, tq, h, hd) contiguous bf16.
// Launches on `stream`; returns the CUDA error code (0 = ok).
int hmm_flash_mha_bthd_bf16(const void* q, const void* k, const void* v, void* o, int b, int h,
                            int tq, int tk, int hd, int64_t q_sb, int64_t q_sh, int64_t q_st,
                            int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb,
                            int64_t v_sh, int64_t v_st, float scale, void* stream) {
  if (b <= 0 || h <= 0 || tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  const int64_t st[9] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st};
  for (int64_t x : st)
    if (x % 8) return (int)cudaErrorInvalidValue;
  const Strides so{(int64_t)tq * h * hd, hd, (int64_t)h * hd};
  return (int)dispatch(q, k, v, o, b, h, tq, tk, hd, scale, Strides{q_sb, q_sh, q_st},
                       Strides{k_sb, k_sh, k_st}, Strides{v_sb, v_sh, v_st}, so,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
