// K5: exact cosine top-k of one query over a feature store, Hopper (sm_90a), fp32.
//   sims[r] = (F[r]·q) / (max(‖q‖, 1e-8) · sqrt(max(‖F[r]‖², 1e-16)))
//   out     = the k largest sims, value descending, then lower row index
//
// Replaces the Pallas TPU kernel `_topk_kernel` in hippomm_tpu/ops/pallas_topk.py
// (reached through `pallas_top_k_cosine`). As there, only k values and k
// indices leave the chip: the (N,) similarity vector never reaches device
// memory. The TPU kernel walks the store as a sequential grid and carries a
// running top-k in VMEM scratch from step to step; blocks on the card run in
// parallel and in no order, so the carry becomes two passes:
//
//   pass 1 (`topk_tiles`): one block per 1024-row tile. The block stages q in
//   shared memory; each warp takes a row at a time, reads it once with float4
//   streaming loads, and reduces its dot with q and its sum of squares in fp32
//   on the CUDA cores (a mat-vec does 4 flops per 4-byte element: tensor cores
//   would not help). The tile's 1024 (similarity, row) pairs stay in shared
//   memory, are bitonic-sorted there, and the best k go to a small candidate
//   buffer (tiles × k).
//   pass 2 (`topk_merge`): one block merges the candidates. The k-th best of
//   any k candidates is a lower bound for the global k-th; it takes the tiles'
//   best (one or more per tile, at least k in all), sorts them and uses their
//   k-th as a threshold, then keeps only candidates at or above it, which for
//   real data is a few hundred of the tiles × k. Survivors collect in a
//   4096-entry shared buffer; a full buffer is sorted down to its best k (and
//   the threshold raised) before more are added, so any input, ties included,
//   ends right.
//
// Order: the key is (value, row) with the larger value first and, at equal
// values, the lower row first — lax.top_k's order, which the product route of
// the JAX package uses. (The TPU kernel's merge lets a later tile win a tie.)
// Rows at and past n never enter (value −inf). Normalisation as the TPU
// kernel: rows by rsqrt(max(Σf², 1e-16)), the query by 1 / max(‖q‖, 1e-8).
//
// Bound on the H100: N·D·4 bytes read once against 4·N·D fp32 flops — one
// flop per byte, far below the ~20 of fp32 CUDA cores per byte of HBM:
// memory-bound. The design keeps the one read of the store the only large
// traffic; the sorts work in shared memory, and pass 2 reads tiles × k × 8
// bytes from L2.
//
// Requirements (checked by the wrapper): 1 ≤ k ≤ 128, k ≤ n, D a multiple
// of 4, feats fp32 contiguous and 16-byte aligned; q fp32 (D,).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kRows = 1024;      // rows per pass-1 tile
constexpr int kThreads1 = 256;   // pass 1: 8 warps
constexpr int kThreads2 = 1024;  // pass 2
constexpr int kBuf = 4096;       // pass-2 survivor buffer (entries)
constexpr int kWindow = 2048;    // candidates scanned between buffer checks
constexpr int kMaxK = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (av, ai) comes before (bv, bi): larger value, then lower row
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Bitonic sort of n (a power of two) entries in shared memory, best first.
// Every thread of the block calls it after a barrier that published v/idx.
__device__ void bitonic_sort(float* v, int* idx, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const float lv = v[lo], hv = v[hi];
        const int li = idx[lo], hj = idx[hi];
        // the subsequence starting at a multiple of 2·size runs best first,
        // the next one worst first; at size == n everything is best first
        const bool swap = (lo & size) == 0 ? better(hv, hj, lv, li) : better(lv, li, hv, hj);
        if (swap) {
          v[lo] = hv;
          v[hi] = lv;
          idx[lo] = hj;
          idx[hi] = li;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads1)
topk_tiles(const float* __restrict__ q, const float* __restrict__ feats, int n, int d, int k,
           float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(smem + kRows * 4);
  float* qs = reinterpret_cast<float*>(smem + kRows * 8);
  __shared__ float red[kThreads1 / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float qq = 0.0f;
  for (int c = threadIdx.x; c < d; c += kThreads1) {
    const float x = q[c];
    qs[c] = x;
    qq += x * x;
  }
  qq = warp_sum(qq);
  if (lane == 0) red[warp] = qq;
  __syncthreads();
  qq = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads1 / 32; ++w) qq += red[w];
  const float inv_q = 1.0f / fmaxf(sqrtf(qq), 1e-8f);

  const int64_t base = (int64_t)blockIdx.x * kRows;
  const int d4 = d >> 2;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  for (int r = warp; r < kRows; r += kThreads1 / 32) {
    const int64_t row = base + r;
    float sim = -INFINITY;
    int id = INT_MAX;
    if (row < n) {
      const float4* f4 = reinterpret_cast<const float4*>(feats + row * d);
      float dot = 0.0f, ss = 0.0f;
#pragma unroll 8
      for (int c = lane; c < d4; c += 32) {
        const float4 f = __ldcs(f4 + c);  // read once: do not keep it in L2
        const float4 qv = q4[c];
        dot += f.x * qv.x + f.y * qv.y + f.z * qv.z + f.w * qv.w;
        ss += f.x * f.x + f.y * f.y + f.z * f.z + f.w * f.w;
      }
      dot = warp_sum(dot);
      ss = warp_sum(ss);
      sim = dot * inv_q * rsqrtf(fmaxf(ss, 1e-16f));
      id = (int)row;
    }
    if (lane == 0) {
      sv[r] = sim;
      si[r] = id;
    }
  }
  __syncthreads();
  bitonic_sort(sv, si, kRows);
  for (int j = threadIdx.x; j < k; j += kThreads1) {
    cand_v[(int64_t)blockIdx.x * k + j] = sv[j];
    cand_i[(int64_t)blockIdx.x * k + j] = si[j];
  }
}

__device__ __forceinline__ int pow2_at_least(int x) {
  int p = 2;
  while (p < x) p <<= 1;
  return p;
}

// Sort the buffer's `*cnt` entries down to its best k at the front and raise
// the threshold to the k-th of them. All threads call it with the same *cnt.
__device__ void flush(float* bv, int* bi, int* cnt, float* thr_v, int* thr_i, int k) {
  const int c = *cnt;
  const int ns = pow2_at_least(c > k ? c : k);
  for (int j = c + threadIdx.x; j < ns; j += blockDim.x) {
    bv[j] = -INFINITY;
    bi[j] = INT_MAX;
  }
  __syncthreads();
  bitonic_sort(bv, bi, ns);
  if (threadIdx.x == 0) {
    *cnt = k;
    if (better(bv[k - 1], bi[k - 1], *thr_v, *thr_i)) {
      *thr_v = bv[k - 1];
      *thr_i = bi[k - 1];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads2)
topk_merge(const float* __restrict__ cand_v, const int* __restrict__ cand_i, int nb, int k,
           float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float bv[kBuf];
  __shared__ int bi[kBuf];
  __shared__ int cnt;
  __shared__ float thr_v;
  __shared__ int thr_i;

  // threshold: the k-th best of the first m candidates of (up to) every tile
  const int m = (k + nb - 1) / nb;
  const int tiles = nb < kBuf / m ? nb : kBuf / m;
  const int ns = tiles * m;
  for (int j = threadIdx.x; j < ns; j += kThreads2) {
    const int64_t src = (int64_t)(j / m) * k + j % m;
    bv[j] = cand_v[src];
    bi[j] = cand_i[src];
  }
  if (threadIdx.x == 0) {
    cnt = ns;
    thr_v = -INFINITY;
    thr_i = INT_MAX;
  }
  __syncthreads();
  flush(bv, bi, &cnt, &thr_v, &thr_i, k);
  if (threadIdx.x == 0) cnt = 0;  // the sample only set the threshold

  const int64_t total = (int64_t)nb * k;
  for (int64_t w0 = 0; w0 < total; w0 += kWindow) {
    __syncthreads();
    // every thread reads the count before any thread adds to it again, so
    // all of them take the same branch into flush (which has barriers)
    const bool full = cnt > kBuf - kWindow;
    __syncthreads();
    if (full) flush(bv, bi, &cnt, &thr_v, &thr_i, k);
    const float tv = thr_v;
    const int ti = thr_i;
    const int64_t w1 = w0 + kWindow < total ? w0 + kWindow : total;
    for (int64_t j = w0 + threadIdx.x; j < w1; j += kThreads2) {
      const float v = cand_v[j];
      const int i = cand_i[j];
      if (!better(tv, ti, v, i)) {
        const int p = atomicAdd(&cnt, 1);
        bv[p] = v;
        bi[p] = i;
      }
    }
  }
  __syncthreads();
  flush(bv, bi, &cnt, &thr_v, &thr_i, k);
  for (int j = threadIdx.x; j < k; j += kThreads2) {
    out_v[j] = bv[j];
    out_i[j] = bi[j];
  }
}

}  // namespace

extern "C" {

// Rows per pass-1 tile: the wrapper sizes the candidate buffers as
// ceil(n / rows) × k.
int hmm_topk_tile_rows() { return kRows; }

// q (d,) fp32; feats (n, d) fp32 contiguous, 16-byte aligned, d % 4 == 0;
// cand_v / cand_i scratch of ceil(n / 1024) · k fp32 / int32; out_v (k,)
// fp32, out_i (k,) int32. 1 ≤ k ≤ 128, k ≤ n. Launches both passes on
// `stream`; returns the CUDA error code (0 = ok).
int hmm_topk_cosine_f32(const void* q, const void* feats, int n, int d, int k, void* cand_v,
                        void* cand_i, void* out_v, void* out_i, void* stream) {
  if (n <= 0 || d <= 0 || d % 4 || k < 1 || k > kMaxK || k > n) return (int)cudaErrorInvalidValue;
  const int nb = (n + kRows - 1) / kRows;
  const int bytes = kRows * 8 + d * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(topk_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_tiles<<<nb, kThreads1, bytes, s>>>(static_cast<const float*>(q),
                                          static_cast<const float*>(feats), n, d, k,
                                          static_cast<float*>(cand_v), static_cast<int*>(cand_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<1, kThreads2, 0, s>>>(static_cast<const float*>(cand_v),
                                     static_cast<const int*>(cand_i), nb, k,
                                     static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
