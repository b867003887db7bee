// The routed experts' dispatch and combine around torch._grouped_mm, for
// the MoE layers of Kimi-VL (models/kimi_vl/model.py: KimiVL._moe, _swiglu),
// Hopper (sm_90a): fp32 routing, bf16 activations.
//
// Replaces no TPU kernel: the JAX package has no Kimi-VL. Added because the
// composition of torch ops it replaces (σ, top-k, a stable argsort and its
// gathers, searchsorted, the SwiGLU's fp32 copies, index_add_ counters, a
// scatter back and an fp32 weighted sum) launched ~50 kernels a MoE layer. A
// decode step of 1 to 256 rows is bound by that count (each kernel a graph
// node of a few µs), not by its bytes; a prefill forward of 32768 tokens by
// the bytes of those fp32 intermediates (~15 GB a layer), which these
// kernels never write. All four are bytes-bound (a few flops a byte):
//
//   hmm_moe_route         one warp a row: σ of the fp32 logits as torch
//                         computes it (1 / (1 + expf(-x))), the top k of
//                         σ + the correction bias by k rounds of a warp
//                         arg-max (ties to the lower expert: a row of equal
//                         scores gets the experts torch.topk picks, in
//                         ascending order rather than torch's), the chosen σ
//                         normalised to sum 1 (k in order) and scaled.
//   hmm_moe_permute       the order of a stable sort of the chosen experts:
//                         a route's slot is its expert's start plus the routes
//                         to that expert from earlier rows. A block ranks one
//                         tile of at most 1024 rows, a warp 32 of them: for
//                         each expert one ballot over the warp's rows gives
//                         their count and each row's rank. Counts of earlier
//                         tiles come from a count kernel (a prefill forward,
//                         more than one tile); a decode step is one tile and
//                         one launch, each block ranking the tile again and
//                         copying a share of its rows, so that the copy is
//                         spread over the SMs. Block (0, 0) writes each
//                         expert's end (grouped_mm's `offs`) and adds the
//                         live rows' counters (experts hit, routes, the
//                         busiest expert's routes) to `stats`.
//   hmm_swiglu_bf16       bf16(silu(fp32 g) · fp32 u) over a (M, 2F) product,
//                         silu as torch computes it (x / (1 + expf(-x))).
//   hmm_moe_combine_bf16  bf16(x + (Σ_k w_k · y[slot_k] + shared)) in fp32,
//                         k in order, each product and sum rounded on its own
//                         (no FMA), as torch's separate ops round them.
//
// None synchronises with the host or allocates: the wrappers (ops/moe.py)
// allocate outputs and scratch with torch, so every launch is captured in the
// decode step's CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxExperts = 64;  // a row's chosen experts are one 64-bit mask
constexpr int kMaxK = 8;
constexpr int kTile = 1024;  // rows one permute block ranks: 32 warps of 32
constexpr int kChunks = kTile / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kRouteWarps = 8;  // rows a route block takes

typedef __nv_bfloat16 bf16;

constexpr int kVec = 8;  // bf16 a 16-byte load: the SwiGLU's and the combine's widths are multiples of 8

struct alignas(16) Pack {
  bf16 v[kVec];
};

__device__ __forceinline__ Pack load(const bf16* p) { return *reinterpret_cast<const Pack*>(p); }

__device__ __forceinline__ void store(bf16* p, const Pack& x) { *reinterpret_cast<Pack*>(p) = x; }

__global__ void moe_route_kernel(const float* __restrict__ logits, const float* __restrict__ bias, int n,
                                 int e, int k, float scale, long long* __restrict__ idx,
                                 float* __restrict__ wts) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRouteWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // a whole warp leaves
  const float neg_inf = -__int_as_float(0x7f800000);
  const float* lr = logits + (size_t)row * e;
  // a lane holds experts lane and lane + 32
  const int e0 = lane, e1 = lane + 32;
  float s0 = 0.f, s1 = 0.f, c0 = neg_inf, c1 = neg_inf;
  if (e0 < e) {
    s0 = 1.0f / (1.0f + expf(-lr[e0]));
    c0 = s0 + bias[e0];
  }
  if (e1 < e) {
    s1 = 1.0f / (1.0f + expf(-lr[e1]));
    c1 = s1 + bias[e1];
  }
  float chosen[kMaxK];
  int which[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    chosen[j] = 0.f;
    which[j] = 0;
    if (j < k) {
      float v = c0;
      int x = e0;
      if (c1 > c0) {
        v = c1;
        x = e1;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(kAll, v, off);
        const int ox = __shfl_xor_sync(kAll, x, off);
        if (ov > v || (ov == v && ox < x)) {
          v = ov;
          x = ox;
        }
      }
      // every lane holds the same x now; its owner gives σ and drops it
      chosen[j] = __shfl_sync(kAll, x < 32 ? s0 : s1, x & 31);
      which[j] = x;
      if (x == e0) c0 = neg_inf;
      if (x == e1) c1 = neg_inf;
    }
  }
  if (lane == 0) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < k) sum += chosen[j];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) {
        idx[(size_t)row * k + j] = which[j];
        wts[(size_t)row * k + j] = chosen[j] / sum * scale;
      }
    }
  }
}

// Each tile's routes per expert: counts[tile][0][expert] over all its rows,
// counts[tile][1][expert] over the rows `live` marks (null: all).
__global__ void moe_count_kernel(const long long* __restrict__ idx, const unsigned char* __restrict__ live,
                                 int n, int k, int e, int* __restrict__ counts) {
  __shared__ int all[kMaxExperts], alive[kMaxExperts];
  for (int i = threadIdx.x; i < e; i += blockDim.x) all[i] = alive[i] = 0;
  __syncthreads();
  const int row = blockIdx.x * kTile + threadIdx.x;
  if (row < n) {
    const bool on = live == nullptr || live[row];
    for (int j = 0; j < k; ++j) {
      const int x = (int)idx[(size_t)row * k + j];
      atomicAdd(&all[x], 1);
      if (on) atomicAdd(&alive[x], 1);
    }
  }
  __syncthreads();
  int* out = counts + (size_t)blockIdx.x * 2 * e;
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    out[i] = all[i];
    out[e + i] = alive[i];
  }
}

// Block (split s, tile t): thread r of the block is row r of the tile (warp
// w its rows 32w .. 32w + 31); it ranks the whole tile and copies the rows
// of its split, ceil(rows / splits) of them.
__global__ void moe_permute_kernel(const long long* __restrict__ idx, const unsigned char* __restrict__ live,
                                   const bf16* __restrict__ h, const int* __restrict__ tile_counts, int n,
                                   int k, int e, int d, bf16* __restrict__ xs, int* __restrict__ slots,
                                   int* __restrict__ offs, long long* __restrict__ stats) {
  __shared__ int chunk[kChunks][kMaxExperts];  // a warp's routes per expert, then their prefix in the tile
  __shared__ int base[kMaxExperts];  // slot of the tile's first route to the expert
  __shared__ int before[kMaxExperts], total[kMaxExperts], alive[kMaxExperts];
  __shared__ int slot_of[kTile * kMaxK];  // the split's routes' slots
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int tiles = gridDim.y, tile = blockIdx.y, r0 = tile * kTile;
  const int rows = min(kTile, n - r0);
  const int per = (rows + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * per, hi = min(rows, lo + per);
  for (int i = threadIdx.x; i < e; i += blockDim.x) alive[i] = 0;

  // this thread's row: its experts and their mask
  const int r = threadIdx.x;
  int mine[kMaxK];
  unsigned long long mask = 0;
  bool on = false;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) mine[j] = -1;
  if (r < rows) {
    on = live == nullptr || live[r0 + r];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) {
        mine[j] = (int)idx[(size_t)(r0 + r) * k + j];
        mask |= 1ull << mine[j];
      }
    }
  }
  __syncthreads();

  // per expert, one ballot over the warp's rows: their count, each row's rank
  int rank[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) rank[j] = 0;
  for (int x = 0; x < e; ++x) {
    const bool has = (mask >> x) & 1ull;
    const unsigned b = __ballot_sync(kAll, has);
    const unsigned bl = __ballot_sync(kAll, has && on);
    if (lane == 0) {
      chunk[warp][x] = __popc(b);
      if (bl) atomicAdd(&alive[x], __popc(bl));
    }
    if (has) {
      const int below = __popc(b & ((1u << lane) - 1u));
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (mine[j] == x) rank[j] = below;
    }
  }
  __syncthreads();

  // prefixes over the tile's warps and over earlier tiles; the totals
  for (int x = threadIdx.x; x < e; x += blockDim.x) {
    int run = 0;
    for (int c = 0; c < warps; ++c) {
      const int v = chunk[c][x];
      chunk[c][x] = run;
      run += v;
    }
    int earlier = 0, all = run, live_all = alive[x];
    if (tiles > 1) {
      all = live_all = 0;
      for (int t = 0; t < tiles; ++t) {
        const int v = tile_counts[(size_t)t * 2 * e + x];
        if (t < tile) earlier += v;
        all += v;
        live_all += tile_counts[(size_t)t * 2 * e + e + x];
      }
    }
    before[x] = earlier;
    total[x] = all;
    alive[x] = live_all;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool first = blockIdx.x == 0 && blockIdx.y == 0;
    int run = 0, hit = 0, routed = 0, busiest = 0;
    for (int x = 0; x < e; ++x) {
      base[x] = run + before[x];
      run += total[x];
      if (first) offs[x] = run;
      hit += alive[x] > 0;
      routed += alive[x];
      busiest = max(busiest, alive[x]);
    }
    if (first && stats != nullptr) {
      stats[0] += hit;
      stats[1] += routed;
      stats[2] += busiest;
    }
  }
  __syncthreads();

  // the split's routes: their slots, then the rows copied into them
  if (r >= lo && r < hi) {
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) {
        const int x = mine[j];
        const int s = base[x] + chunk[warp][x] + rank[j];
        slot_of[(r - lo) * k + j] = s;
        slots[(size_t)(r0 + r) * k + j] = s;
      }
    }
  }
  __syncthreads();
  const int routes = max(0, hi - lo) * k, vecs = d / 8;
  for (int q = warp; q < routes; q += warps) {
    const uint4* src = reinterpret_cast<const uint4*>(h + (size_t)(r0 + lo + q / k) * d);
    uint4* dst = reinterpret_cast<uint4*>(xs + (size_t)slot_of[q] * d);
    for (int v = lane; v < vecs; v += 32) dst[v] = src[v];
  }
}

__global__ void swiglu_kernel(const bf16* __restrict__ gu, bf16* __restrict__ out, long long m, int f) {
  const int fv = f / kVec;
  const long long total = m * fv;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / fv;
    const int c = (int)(i - row * fv) * kVec;
    const bf16* g = gu + row * 2 * f + c;
    const Pack gv = load(g), uv = load(g + f);
    Pack o;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const float a = __bfloat162float(gv.v[t]);
      o.v[t] = __float2bfloat16_rn((a / (1.0f + expf(-a))) * __bfloat162float(uv.v[t]));
    }
    store(out + row * f + c, o);
  }
}

__global__ void moe_combine_kernel(const bf16* __restrict__ y, const int* __restrict__ slots,
                                   const float* __restrict__ wts, const bf16* __restrict__ shared,
                                   const bf16* __restrict__ x, bf16* __restrict__ out, int n, int k, int d) {
  const int dv = d / kVec;
  const long long total = (long long)n * dv;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / dv;
    const int c = (int)(i - row * dv) * kVec;
    float acc[kVec];
#pragma unroll
    for (int t = 0; t < kVec; ++t) acc[t] = 0.f;
    for (int j = 0; j < k; ++j) {
      const long long s = slots[row * k + j];
      const float w = wts[row * k + j];
      const Pack yv = load(y + s * d + c);
#pragma unroll
      for (int t = 0; t < kVec; ++t) acc[t] = __fadd_rn(acc[t], __fmul_rn(__bfloat162float(yv.v[t]), w));
    }
    const Pack sv = load(shared + row * d + c), xv = load(x + row * d + c);
    Pack o;
#pragma unroll
    for (int t = 0; t < kVec; ++t)
      o.v[t] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(xv.v[t]), __fadd_rn(acc[t], __bfloat162float(sv.v[t]))));
    store(out + row * d + c, o);
  }
}

// every pointer 16-byte aligned
bool aligned(const void* const* ptrs, int count) {
  for (int i = 0; i < count; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

int grid_for(long long items, int threads) {
  const long long blocks = (items + threads - 1) / threads;
  return (int)(blocks < 132 * 16 ? (blocks < 1 ? 1 : blocks) : 132 * 16);
}

}  // namespace

extern "C" {

// logits (n, e) fp32 and bias (e,) fp32, contiguous; idx (n, k) int64 and
// wts (n, k) fp32 out. e ≤ 64, 1 ≤ k ≤ min(8, e). Returns the CUDA error.
int hmm_moe_route(const void* logits, const void* bias, int n, int e, int k, float scale, void* idx, void* wts,
                  void* stream) {
  if (n < 1 || e < 1 || e > kMaxExperts || k < 1 || k > kMaxK || k > e) return (int)cudaErrorInvalidValue;
  moe_route_kernel<<<(n + kRouteWarps - 1) / kRouteWarps, 32 * kRouteWarps, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(logits), static_cast<const float*>(bias), n, e, k, scale,
      static_cast<long long*>(idx), static_cast<float*>(wts));
  return (int)cudaGetLastError();
}

// idx (n, k) int64 from hmm_moe_route; live (n,) bool or null (every row);
// h (n, d) bf16, d % 8 == 0, 16-byte aligned. Out: xs (n·k, d) bf16, slots
// (n, k) int32, offs (e,) int32; stats (3,) int64 gains the live rows'
// counters (null: none). The plan of ops/moe._permute_plan: tiles =
// ceil(n / 1024), splits blocks a tile, threads a block (a multiple of 32,
// at least 64 and the rows of a tile); tile_counts int32 (tiles, 2, e) where
// tiles > 1 (then a count kernel runs first). Returns the CUDA error.
int hmm_moe_permute(const void* idx, const void* live, const void* h, int n, int k, int e, int d, int tiles,
                    int splits, int threads, void* tile_counts, void* xs, void* slots, void* offs, void* stats,
                    void* stream) {
  if (n < 1 || e < 1 || e > kMaxExperts || k < 1 || k > kMaxK || d < 8 || d % 8 ||
      tiles != (n + kTile - 1) / kTile || splits < 1 || threads % 32 || threads < 64 || threads > kTile ||
      threads < (n < kTile ? n : kTile) || (tiles > 1 && tile_counts == nullptr) ||
      reinterpret_cast<uintptr_t>(h) % 16 || reinterpret_cast<uintptr_t>(xs) % 16)
    return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  const auto* ix = static_cast<const long long*>(idx);
  const auto* lv = static_cast<const unsigned char*>(live);
  if (tiles > 1) moe_count_kernel<<<tiles, kTile, 0, s>>>(ix, lv, n, k, e, static_cast<int*>(tile_counts));
  moe_permute_kernel<<<dim3(splits, tiles), threads, 0, s>>>(
      ix, lv, static_cast<const bf16*>(h), static_cast<const int*>(tile_counts), n, k, e, d,
      static_cast<bf16*>(xs), static_cast<int*>(slots), static_cast<int*>(offs), static_cast<long long*>(stats));
  return (int)cudaGetLastError();
}

// gu (m, 2f) bf16 contiguous -> out (m, f) bf16; f % 8 == 0, both 16-byte
// aligned. Returns the CUDA error.
int hmm_swiglu_bf16(const void* gu, void* out, long long m, int f, void* stream) {
  const void* ptrs[2] = {gu, out};
  if (m < 1 || f < kVec || f % kVec || !aligned(ptrs, 2)) return (int)cudaErrorInvalidValue;
  swiglu_kernel<<<grid_for(m * (f / kVec), 256), 256, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(gu), static_cast<bf16*>(out), m, f);
  return (int)cudaGetLastError();
}

// y (n·k, d), shared (n, d), x (n, d) bf16 contiguous, d % 8 == 0, 16-byte
// aligned; slots (n, k) int32, wts (n, k) fp32 -> out (n, d) bf16. Returns
// the CUDA error.
int hmm_moe_combine_bf16(const void* y, const void* slots, const void* wts, const void* shared, const void* x,
                         void* out, int n, int k, int d, void* stream) {
  const void* ptrs[4] = {y, shared, x, out};
  if (n < 1 || k < 1 || d < kVec || d % kVec || !aligned(ptrs, 4)) return (int)cudaErrorInvalidValue;
  moe_combine_kernel<<<grid_for((long long)n * (d / kVec), 256), 256, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(slots), static_cast<const float*>(wts),
      static_cast<const bf16*>(shared), static_cast<const bf16*>(x), static_cast<bf16*>(out), n, k, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
