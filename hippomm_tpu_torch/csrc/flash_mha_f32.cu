// K1 and K4 at fp32: mask-free multi-head attention forward for Hopper
// (sm_90a) when q, k and v are fp32.
//
// Replaces the same two Pallas TPU kernels as flash_mha.cu, for the fp32
// operands the JAX package passes them (its fp32 towers and its training,
// which runs in fp32): `_mha_kernel` (K1, reached through `flash_mha`) and
// `_mha_kernel_bthd` (K4, through `flash_mha_bthd`) of
// hippomm_tpu/ops/flash_attention.py. Those compute in the operand dtype, so
// at fp32 every step is fp32: q·kᵀ, the softmax, and the weights·v product
// with fp32 accumulation. So does this kernel, on the CUDA cores (fp32 FMA):
// the tensor cores take fp32 only as TF32, which keeps about three decimal
// digits and fails the reference's fp32 tolerance.
//
// One kernel serves K1 and K4: it reads row t of head h of batch b at
// b·s_b + h·s_h + t·s_t elements (hd contiguous), so K1 passes the strides
// of a contiguous (B, H, T, hd) tensor and K4 those of (B, T, H, hd) views,
// such as the q, k and v slices of a packed (B, T, 3D) projection (row
// stride 3D), with no copy. Any stride and any hd up to 128 is taken: tiles
// are loaded with ordinary loads, zero-filled past hd and past the rows.
//
// Bound on the H100: 4·Tq·Tk·hd fp32 operations at 67 TF/s against q, k, v
// and the output once at 3.35 TB/s: the operations bound every path shape
// (vision (32, 16, 257, 257, 80) 0.162 ms, audio (96, 12, 229, 230, 64)
// 0.232 ms, Whisper's encoder (4, 20, 1500, 1500, 64) 0.688 ms; the bytes
// 0.050, 0.108 and 0.018 ms).
//
// Design (a plain FlashAttention-2 block, SIMT): a block owns 64 query rows
// of one (batch, head) and walks the keys in tiles of 64 (the plan of
// ops/flash_attention._attn_plan_f32); the block order puts one head's query
// tiles side by side, so the blocks that run together share its K/V in the
// L2. 256 threads as 16 × 16: thread (ty, tx) owns query rows 4·ty .. 4·ty+3
// and, of each key tile, keys tx + 16·j (j < 4), and of the output columns
// tx + 16·c (c < hd/16, hd rounded up to 16).
//   * S = Q·Kᵀ from shared memory, 16 FMAs per pair of float4 reads (Q rows
//     broadcast in a half-warp; K rows padded by 4 floats, so the 8 lanes
//     of a 128-bit read hit 8 distinct bank groups).
//   * The online softmax in registers: the row max and sum over a key tile
//     reduce across the 16 lanes of a half-warp (shuffles), exp with expf
//     (not the approximate exp2 of the bf16 kernel: fp32 is the point), the
//     running output rescaled by exp(m_old − m_new).
//   * P goes through shared memory (64 × 68 floats) to O += P·V, float4
//     reads of P and one V read per 4 FMAs.
//   * The output is divided by the row sum at the end (the TPU kernel's
//     `defer_div` body), written in fp32.
// Shared memory: Q and K (64 × (hdp + 4)), V (64 × hdp) and P: 81 KB at hd
// 80, two blocks an SM. Making it faster (3×TF32 on the tensor cores, a
// TMA ring) is later work.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 × 16
constexpr int kPad = 4;        // floats after each Q, K and P row in shared memory
constexpr int kMaxDevices = 64;

struct Strides {
  int64_t b, h, t;
};

struct Args {
  const float *q, *k, *v;
  float* o;
  int h, tq, tk, hd;
  int q_tiles, key_tiles;
  Strides sq, sk, sv, so;
  float scale;
};

template <int NC>
struct Layout {
  static constexpr int kHdp = 16 * NC;    // hd rounded up to 16
  static constexpr int kLdq = kHdp + kPad;  // a Q or K row
  static constexpr int kLdp = kBK + kPad;   // a P row
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLdq;
  static constexpr int kV = kK + kBK * kLdq;
  static constexpr int kP = kV + kBK * kHdp;
  static constexpr int kFloats = kP + kBQ * kLdp;
  static constexpr int kBytes = 4 * kFloats;
};

// rows [row0, row0 + 64) of one head into a 64 × ld tile, zero past
// `valid` rows and past hd columns: thread (ty, tx) takes rows ty + 16·i
// and columns tx + 16·c, so its addresses are 4 row pointers and constant
// offsets, few registers beside the running output and softmax state
static_assert(kBQ == 64 && kBK == 64, "load_tile covers 64 rows with 16 × 16 threads");
template <int NC>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int64_t st,
                                          int row0, int valid, int hd, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float* row = src + (int64_t)(row0 + r) * st;
    float buf[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      buf[c] = (r < valid && tx + 16 * c < hd) ? __ldg(row + tx + 16 * c) : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[r * ld + tx + 16 * c] = buf[c];
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 2) flash_mha_f32_kernel(const Args a) {
  using L = Layout<NC>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::kQ;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* ps = smem + L::kP;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qt = blockIdx.x % a.q_tiles;
  const int bh = blockIdx.x / a.q_tiles;
  const int bi = bh / a.h, hi = bh % a.h;
  const int q0 = qt * kBQ;
  const float* qg = a.q + bi * a.sq.b + hi * a.sq.h;
  const float* kg = a.k + bi * a.sk.b + hi * a.sk.h;
  const float* vg = a.v + bi * a.sv.b + hi * a.sv.h;

  load_tile<NC>(qs, L::kLdq, qg, a.sq.t, q0, min(kBQ, a.tq - q0), a.hd, ty, tx);

  float o[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.0f;
  }

  for (int j = 0; j < a.key_tiles; ++j) {
    const int k0 = j * kBK, kn = min(kBK, a.tk - k0);
    __syncthreads();  // the last tile's K, V and P are read
    load_tile<NC>(ks, L::kLdq, kg, a.sk.t, k0, kn, a.hd, ty, tx);
    load_tile<NC>(vs, L::kHdp, vg, a.sv.t, k0, kn, a.hd, ty, tx);
    __syncthreads();

    // S = Q·Kᵀ: rows 4·ty + i, keys tx + 16·jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < L::kHdp; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * L::kLdq + c);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(ks + (tx + 16 * jj) * L::kLdq + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float acc = s[i][jj];
          acc = fmaf(qv[i].x, kv[jj].x, acc);
          acc = fmaf(qv[i].y, kv[jj].y, acc);
          acc = fmaf(qv[i].z, kv[jj].z, acc);
          acc = fmaf(qv[i].w, kv[jj].w, acc);
          s[i][jj] = acc;
        }
    }

    // the online softmax of each row over this tile's kn keys (key 0 is
    // always real, so every row's max is finite)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = tx + 16 * jj < kn ? s[i][jj] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 0 at the first tile (m = −inf)
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);  // 0 for a masked key
        sum += p;
        ps[(4 * ty + i) * L::kLdp + tx + 16 * jj] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // O += P·V over the tile's keys (P is 0 and V zero past kn)
    const int kend = (kn + 3) & ~3;
    for (int kk = 0; kk < kend; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * L::kLdp + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = vs[(kk + u) * L::kHdp + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
            o[i][c] = fmaf(p, vv, o[i][c]);
          }
        }
      }
    }
  }

  float* og = a.o + bi * a.so.b + hi * a.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= a.tq) continue;
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < a.hd) og[(int64_t)r * a.so.t + col] = o[i][c] * inv;
    }
  }
}

template <int NC>
int launch(const Args& a, int bh, cudaStream_t stream) {
  static bool sized[kMaxDevices] = {};  // the kernel's shared memory, set once per device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mha_f32_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<NC>::kBytes);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  const int64_t blocks = (int64_t)bh * a.q_tiles;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  flash_mha_f32_kernel<NC><<<(int)blocks, kThreads, Layout<NC>::kBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 and K4 at fp32. q (b, ·, tq, hd), k/v (b, ·, tk, hd) and o as strided
// fp32 tensors: element strides (batch, head, row) per operand, hd
// contiguous. The plan of ops/flash_attention._attn_plan_f32: q_tiles tiles
// of 64 query rows, key_tiles of 64 keys (the last may be short), nc = hd
// rounded up to 16, over 16. Launches on `stream`; returns 0 or the CUDA
// error code.
int hmm_flash_mha_f32(const void* q, const void* k, const void* v, void* o, int b, int h, int tq,
                      int tk, int hd, int64_t q_sb, int64_t q_sh, int64_t q_st, int64_t k_sb,
                      int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st,
                      int64_t o_sb, int64_t o_sh, int64_t o_st, int q_tiles, int key_tiles, int nc,
                      float scale, void* stream) {
  if (b <= 0 || h <= 0 || tq <= 0 || tk <= 0 || hd <= 0 || hd > 16 * nc || hd <= 16 * (nc - 1))
    return (int)cudaErrorInvalidValue;
  // the tiles cover the rows and the keys, and none starts past them
  if (q_tiles < 1 || (q_tiles - 1) * kBQ >= tq || q_tiles * kBQ < tq || key_tiles < 1 ||
      (key_tiles - 1) * kBK >= tk || key_tiles * kBK < tk)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
               static_cast<float*>(o), h, tq, tk, hd, q_tiles, key_tiles,
               Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st}, Strides{v_sb, v_sh, v_st},
               Strides{o_sb, o_sh, o_st}, scale};
  const int bh = b * h;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 1: return launch<1>(a, bh, s);
    case 2: return launch<2>(a, bh, s);
    case 3: return launch<3>(a, bh, s);
    case 4: return launch<4>(a, bh, s);
    case 5: return launch<5>(a, bh, s);
    case 6: return launch<6>(a, bh, s);
    case 7: return launch<7>(a, bh, s);
    case 8: return launch<8>(a, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory of one block at nc = hd / 16 (0 for another nc),
// for reports
int hmm_flash_mha_f32_smem_bytes(int nc) {
  switch (nc) {
    case 1: return Layout<1>::kBytes;
    case 2: return Layout<2>::kBytes;
    case 3: return Layout<3>::kBytes;
    case 4: return Layout<4>::kBytes;
    case 5: return Layout<5>::kBytes;
    case 6: return Layout<6>::kBytes;
    case 7: return Layout<7>::kBytes;
    case 8: return Layout<8>::kBytes;
    default: return 0;
  }
}

}  // extern "C"
