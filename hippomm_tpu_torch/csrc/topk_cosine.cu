// K5: exact cosine top-k of one query over a feature store, Hopper (sm_90a), fp32.
//   sims[r] = (F[r]·q) / (max(‖q‖, 1e-8) · sqrt(max(‖F[r]‖², 1e-16)))
//   out     = the k largest sims, value descending, then lower row index
//
// Replaces the Pallas TPU kernel `_topk_kernel` in hippomm_tpu/ops/pallas_topk.py
// (reached through `pallas_top_k_cosine`). As there, only k values and k
// indices leave the chip: the (N,) similarity vector never reaches device
// memory. The TPU kernel walks the store as a sequential grid, carries a
// running top-k in VMEM from step to step, and skips the merge of a tile
// whose best is below the running k-th. Here the carry and the skip run in
// parallel, in one launch:
//
//   * A persistent, balanced grid (ops/topk._topk_plan): at most two blocks
//     per SM, each over one contiguous row range [b·n/B, (b+1)·n/B) — the
//     ranges differ by at most one row, so no SM streams twice the rows of
//     another.
//   * A ring of row chunks in shared memory. One producer thread fills it
//     with 1-D bulk copies (cp.async.bulk, completion on an mbarrier); the
//     plan gives each block 2-8 chunks of ~32 KB in flight. Eight consumer
//     warps take a row each: float4 reads from shared memory, the row's dot
//     with q and its sum of squares in fp32 on the CUDA cores (a mat-vec does
//     one flop per byte: tensor cores would not help).
//   * A threshold filter instead of a sort per tile. Each block keeps its
//     running top-k and the (value, row) of its k-th in shared memory; a row
//     enters the candidate buffer behind the list only if it is not worse
//     than that k-th (warps append with a ballot). Once 2k rows are in, then
//     at geometrically spaced chunks, at least every (1024 − k) / rows
//     chunks, and at the end of the range, the list and the buffer are
//     sorted down to k and the threshold rises. The buffer cannot overflow:
//     that many chunks hold at most 1024 − k rows, so an ascending store,
//     where every row passes, ends right.
//   * One launch. Each block writes its k candidates to a scratch buffer,
//     fences, and takes an atomic ticket; the last block merges all blocks ×
//     k: the k-th best of the lists' heads bounds the global k-th from below
//     (each list is sorted), one flat read counts each list's prefix that
//     is not worse, and the prefixes are gathered and sorted in groups that
//     fit in shared memory (one group unless ties crowd the bound). It then
//     resets the ticket for the next call: no second kernel, no memset.
//
// Order: the key is (value, row) with the larger value first and, at equal
// values, the lower row first — lax.top_k's order, which the product route
// of the JAX package uses. (The TPU kernel's merge lets a later tile win a
// tie.) Every row's similarity comes from the same code whatever block and
// warp compute it, so equal rows tie exactly. Normalisation as the TPU
// kernel: rows by rsqrt(max(Σf², 1e-16)), the query by 1 / max(‖q‖, 1e-8).
// Row offsets are 64-bit (N·D ≥ 2³¹ is fine); rows themselves are int32.
//
// Any D and any 4-byte aligned store (a view at any element offset): a
// chunk's bulk copy takes its 16-byte aligned interior, and the producer
// warp reads the at most 3 elements before it and 3 after it with ordinary
// loads into the same slot, before the slot's barrier arrival releases
// them; the slot keeps the store's alignment (the chunk starts at element
// (base + first) % 4 of it), so no copy of the store is made. Rows are then
// read one element a lane. Where D % 4 == 0 and the base is 16-byte aligned
// (`kVec`, the search path's stores), every chunk is aligned, and rows are
// read as float4 — that instance has no head or tail code.
//
// Bound on the H100: N·D·4 bytes read once against 4·N·D fp32 flops — one
// flop per byte, far below the ~20 of fp32 CUDA cores per byte of HBM:
// memory-bound. The store's one read is the only large traffic; the sorts
// work in shared memory, and the merge reads blocks × k × 8 bytes from L2.
//
// Requirements (checked by the wrapper and here): 1 ≤ k ≤ 128, k ≤ n, D ≥ 1,
// feats fp32 contiguous (4-byte aligned, as any fp32 tensor); q fp32 (D,).

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;  // the consumer threads
constexpr int kThreads = kConsumers + 32;         // and one producer warp
constexpr int kList = 1024;  // a block's running top-k and its candidate buffer (entries)
constexpr int kMaxK = 128;
constexpr int kMaxStages = 8;
constexpr int kBatch = 8;  // the merge's loads in flight a thread
constexpr int kConsumerBar = 1;  // named barrier of the consumer warps
constexpr int kSmemBlock = 232448;  // the most shared memory a block may use (H100)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (av, ai) comes before (bv, bi): larger value, then lower row
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__host__ __device__ __forceinline__ int pow2_at_least(int x) {
  int p = 2;
  while (p < x) p <<= 1;
  return p;
}

// Bitonic sort of n (a power of two) entries in shared memory, best first,
// by the `count` threads (tid in [0, count)) of named barrier `bar`. The
// caller has published v/idx with a barrier; the sort ends with one.
__device__ void sort_best_first(float* v, int* idx, int n, int tid, int count, int bar) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < n / 2; t += count) {
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
      bar_sync(bar, count);
    }
  }
}

struct Shared {
  int cnt;       // candidates in the buffer behind the list
  float thr_v;   // the list's k-th (value, row): the filter's threshold
  int thr_i;
  int last;      // this block took the last ticket
  int group_end;
  float red[kConsumerWarps];
};

constexpr int kMergeMin = 4096;  // entries the merge needs in the ring's shared memory

// The byte layout of the dynamic shared memory, as ops/topk._topk_plan
// computes it: the ring of `stages` slots of `slot` floats (a chunk, and
// up to 3 floats before it and after it where the chunks are not aligned;
// at least the merge's 4096 entries, which reuse it), q, the list and
// buffer, one count per block (the merge), the ring's full and empty
// barriers.
struct Layout {
  int slot, ring, q, list, lens, bars, total;
  __host__ __device__ Layout(int d, int chunk_rows, int stages, int blocks, bool vec) {
    slot = vec ? chunk_rows * d : (chunk_rows * d + 3 + 3) / 4 * 4;
    ring = (stages * slot * 4 + 127) / 128 * 128;
    q = ring > 8 * kMergeMin ? ring : 8 * kMergeMin;
    ring = 0;
    list = q + (4 * d + 15) / 16 * 16;
    lens = list + 8 * kList;
    bars = lens + (4 * (blocks + 1) + 15) / 16 * 16;
    total = bars + 16 * stages;
  }
};

// Sorts the list and the buffer's candidates down to the best k at the
// front and raises the threshold. Every consumer thread calls it.
__device__ void flush(float* lv, int* li, Shared& sh, int k, int tid) {
  bar_sync(kConsumerBar, kConsumers);  // every append is in
  const int c = sh.cnt;
  const int ns = pow2_at_least(k + c);
  for (int j = k + c + tid; j < ns; j += kConsumers) {
    lv[j] = -INFINITY;
    li[j] = INT_MAX;
  }
  bar_sync(kConsumerBar, kConsumers);  // every thread has read the count
  if (c > 0) sort_best_first(lv, li, ns, tid, kConsumers, kConsumerBar);
  if (tid == 0) {
    sh.cnt = 0;
    sh.thr_v = lv[k - 1];
    sh.thr_i = li[k - 1];
  }
  bar_sync(kConsumerBar, kConsumers);
}

struct TopkArgs {
  const float* q;
  const float* feats;
  int n, d, k, chunk_rows, stages;
  int* scratch;  // [ticket, -, -, -], then blocks × k values, then blocks × k rows
  float* out_v;
  int* out_i;
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
topk_cosine(const TopkArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Shared sh;
  const int d = a.d, k = a.k, rows_per_chunk = a.chunk_rows, stages = a.stages;
  const int nb = gridDim.x;
  const Layout lay(d, rows_per_chunk, stages, nb, kVec);
  const int slot = lay.slot;
  // the store's first element's position in its 16 bytes (0 for kVec)
  const int mis = kVec ? 0 : (int)((reinterpret_cast<uintptr_t>(a.feats) >> 2) & 3);
  float* ring = reinterpret_cast<float*>(smem + lay.ring);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* lv = reinterpret_cast<float*>(smem + lay.list);
  int* li = reinterpret_cast<int*>(smem + lay.list + 4 * kList);
  int* lens = reinterpret_cast<int*>(smem + lay.lens);
  const uint32_t full = smem_u32(smem + lay.bars), empty = full + 8 * stages;
  unsigned* ticket = reinterpret_cast<unsigned*>(a.scratch);
  float* cand_v = reinterpret_cast<float*>(a.scratch + 4);
  int* cand_i = a.scratch + 4 + nb * k;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int64_t row0 = (int64_t)blockIdx.x * a.n / nb;
  const int rows = (int)((int64_t)(blockIdx.x + 1) * a.n / nb - row0);
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: the whole warp walks the chunks, lane 0 issues the copies
    for (int c = 0; c < chunks; ++c) {
      const int s = c % stages;
      if (c >= stages) mbar_wait(empty + 8 * s, ((c / stages) - 1) & 1);
      const int r_in = min(rows_per_chunk, rows - c * rows_per_chunk);
      const int64_t first = (row0 + (int64_t)c * rows_per_chunk) * d;
      if (kVec) {
        if (lane == 0) {
          const uint32_t bytes = (uint32_t)r_in * (uint32_t)d * 4u;
          mbar_expect_tx(full + 8 * s, bytes);
          bulk_load(smem_u32(ring + (size_t)s * slot), a.feats + first, bytes, full + 8 * s);
        }
      } else {
        // the chunk [first, first + len) at element `off` of its slot: the
        // head up to the next 16 bytes and the tail past the last by
        // ordinary loads (lanes 0-2 and 4-6), the aligned body in bulk
        const int len = r_in * d;
        const int off = (int)((mis + first) & 3);
        const int head = min((4 - off) & 3, len);
        const int body = (len - head) & ~3;
        const int tail = len - head - body;
        float* dst = ring + (size_t)s * slot + off;
        if (lane < head) dst[lane] = __ldg(a.feats + first + lane);
        if (lane >= 4 && lane < 4 + tail) dst[head + body + lane - 4] = __ldg(a.feats + first + head + body + lane - 4);
        __syncwarp();
        if (lane == 0) {
          // the arrival releases the head and tail stores to the consumers
          mbar_expect_tx(full + 8 * s, (uint32_t)body * 4u);
          if (body > 0) bulk_load(smem_u32(dst + head), a.feats + first + head, (uint32_t)body * 4u, full + 8 * s);
        }
      }
      __syncwarp();
    }
  } else {
    // consumers: q in shared memory and its inverse norm; an empty list
    float qq = 0.0f;
    for (int c = tid; c < d; c += kConsumers) {
      const float x = a.q[c];
      qs[c] = x;
      qq += x * x;
    }
    qq = warp_sum(qq);
    if (lane == 0) sh.red[warp] = qq;
    for (int j = tid; j < k; j += kConsumers) {
      lv[j] = -INFINITY;
      li[j] = INT_MAX;
    }
    if (tid == 0) {
      sh.cnt = 0;
      sh.thr_v = -INFINITY;
      sh.thr_i = INT_MAX;
    }
    bar_sync(kConsumerBar, kConsumers);
    qq = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) qq += sh.red[w];
    const float inv_q = 1.0f / fmaxf(sqrtf(qq), 1e-8f);
    const int d4 = d >> 2;
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    // flushes: the first once 2k rows are in, then after as many chunks as
    // are in (the threshold rises early, so later buffers hold few rows and
    // the last sort, which nothing hides, is short), at least every
    // (1024 - k) / rows chunks (the buffer never overflows)
    const int flush_every = (kList - k) / rows_per_chunk;
    int next_flush = min(max(1, (2 * k + rows_per_chunk - 1) / rows_per_chunk), flush_every);

    for (int c = 0; c < chunks; ++c) {
      const int s = c % stages;
      const int r_in = min(rows_per_chunk, rows - c * rows_per_chunk);
      const float tv = sh.thr_v;
      const int ti = sh.thr_i;
      const int first = (int)(row0 + (int64_t)c * rows_per_chunk);
      mbar_wait(full + 8 * s, (c / stages) & 1);
      const float* tile = ring + (size_t)s * slot + (kVec ? 0 : (int)((mis + (int64_t)first * d) & 3));
      // warp w takes rows w, w + 8, ...; 32 of them at a time, lane j
      // keeping the j-th one's similarity for the ballot
      for (int r0 = warp; r0 < r_in; r0 += 32 * kConsumerWarps) {
        float my_v = -INFINITY;
        int my_i = INT_MAX;
        for (int j = 0; j < 32; ++j) {
          const int r = r0 + j * kConsumerWarps;
          if (r >= r_in) break;
          float dot = 0.0f, ss = 0.0f;
          if (kVec) {
            const float4* f4 = reinterpret_cast<const float4*>(tile + (size_t)r * d);
#pragma unroll 8
            for (int e = lane; e < d4; e += 32) {
              const float4 f = f4[e];
              const float4 qv = q4[e];
              dot += f.x * qv.x + f.y * qv.y + f.z * qv.z + f.w * qv.w;
              ss += f.x * f.x + f.y * f.y + f.z * f.z + f.w * f.w;
            }
          } else {
            const float* fr = tile + (size_t)r * d;
#pragma unroll 4
            for (int e = lane; e < d; e += 32) {
              const float f = fr[e];
              dot += f * qs[e];
              ss += f * f;
            }
          }
          dot = warp_sum(dot);
          ss = warp_sum(ss);
          if (lane == j) {
            my_v = dot * inv_q * rsqrtf(fmaxf(ss, 1e-16f));
            my_i = first + r;
          }
        }
        const bool pass = my_i != INT_MAX && !better(tv, ti, my_v, my_i);
        const unsigned mask = __ballot_sync(0xffffffffu, pass);
        if (mask) {
          int base = 0;
          if (lane == 0) base = atomicAdd(&sh.cnt, __popc(mask));
          base = __shfl_sync(0xffffffffu, base, 0);
          if (pass) {
            const int p = k + base + __popc(mask & ((1u << lane) - 1u));
            lv[p] = my_v;
            li[p] = my_i;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (c + 1 == next_flush || c + 1 == chunks) {
        flush(lv, li, sh, k, tid);
        next_flush = c + 1 + min(c + 1, flush_every);
      }
    }
    // this block's k candidates (padding past its rows), best first
    for (int j = tid; j < k; j += kConsumers) {
      cand_v[blockIdx.x * k + j] = lv[j];
      cand_i[blockIdx.x * k + j] = li[j];
    }
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) sh.last = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
  __syncthreads();
  if (!sh.last) return;
  __threadfence();

  // The last block merges every block's list, with all its threads, in the
  // ring's shared memory (no chunk is in flight any more).
  int cap = kMergeMin;
  while (2 * cap * 8 <= lay.q) cap *= 2;
  float* mv = ring;
  int* mi = reinterpret_cast<int*>(ring + cap);
  // 1. a lower bound of the global k-th: the k-th best of the first m
  //    entries of every list (m·nb ≥ k real rows, each list best first)
  const int m = (k + nb - 1) / nb;
  const int ns = pow2_at_least(nb * m);
  for (int j = tid; j < ns; j += kThreads) {
    float v = -INFINITY;
    int i = INT_MAX;
    if (j < nb * m) {
      const int src = (j / m) * k + j % m;
      v = __ldcg(cand_v + src);
      i = __ldcg(cand_i + src);
    }
    mv[j] = v;
    mi[j] = i;
  }
  for (int b = tid; b <= nb; b += kThreads) lens[b] = 0;
  __syncthreads();
  sort_best_first(mv, mi, ns, tid, kThreads, 0);
  const float t_v = mv[k - 1];
  const int t_i = mi[k - 1];
  // 2. how many entries of each list are not worse than it (a prefix):
  //    one flat read of the values as float4, kBatch loads in flight a
  //    thread (a loop of single loads would wait out L2's latency each time)
  const int total = nb * k, total4 = total >> 2;
  auto count = [&](float v, int e) {
    if (e < total && (v > t_v || (v == t_v && __ldcg(cand_i + e) <= t_i))) atomicAdd(&lens[e / k], 1);
  };
  const float4* cv4 = reinterpret_cast<const float4*>(cand_v);
  for (int e0 = tid; e0 < total4; e0 += kThreads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      v[u] = e < total4 ? __ldcg(cv4 + e) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = 4 * (e0 + u * kThreads);
      count(v[u].x, e);
      count(v[u].y, e + 1);
      count(v[u].z, e + 2);
      count(v[u].w, e + 3);
    }
  }
  for (int e = 4 * total4 + tid; e < total; e += kThreads) count(__ldcg(cand_v + e), e);
  __syncthreads();
  // 3. their offsets: an exclusive scan by one warp; lens[nb] = the sum
  if (warp == 0) {
    const int per = (nb + 31) / 32, lo = min(lane * per, nb), hi = min(lo + per, nb);
    int sum = 0;
    for (int b = lo; b < hi; ++b) sum += lens[b];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
    for (int b = lo; b < hi; ++b) {
      const int len = lens[b];
      lens[b] = run;
      run += len;
    }
    if (lane == 31) lens[nb] = incl;
  }
  for (int j = tid; j < k; j += kThreads) {
    mv[j] = -INFINITY;
    mi[j] = INT_MAX;
  }
  __syncthreads();
  // 4. gather the prefixes in groups that fit behind the running best k,
  //    and sort each group down to k
  for (int b0 = 0; b0 < nb;) {
    if (tid == 0) {
      int lo = b0 + 1, hi = nb;  // the last list end whose group fits
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (lens[mid] - lens[b0] <= cap - k) lo = mid;
        else hi = mid - 1;
      }
      sh.group_end = lo;
    }
    __syncthreads();
    const int b1 = sh.group_end;
    const int gc = lens[b1] - lens[b0];
    for (int b = b0 + tid; b < b1; b += kThreads) {
      const int dst = k + lens[b] - lens[b0], len = lens[b + 1] - lens[b];
      for (int j = 0; j < len; ++j) {
        mv[dst + j] = __ldcg(cand_v + b * k + j);
        mi[dst + j] = __ldcg(cand_i + b * k + j);
      }
    }
    const int ng = pow2_at_least(k + gc);
    for (int j = k + gc + tid; j < ng; j += kThreads) {
      mv[j] = -INFINITY;
      mi[j] = INT_MAX;
    }
    __syncthreads();
    if (gc > 0) sort_best_first(mv, mi, ng, tid, kThreads, 0);
    b0 = b1;
  }
  for (int j = tid; j < k; j += kThreads) {
    a.out_v[j] = mv[j];
    a.out_i[j] = mi[j];
  }
  if (tid == 0) *ticket = 0u;  // for the next call on this scratch
}

}  // namespace

extern "C" {

// q (d,) fp32; feats (n, d) fp32 contiguous, any d ≥ 1 and any 4-byte
// aligned base (the float4 instance where d % 4 == 0 and the base is 16-byte
// aligned); the plan of ops/topk._topk_plan (blocks, chunk_rows, stages,
// smem_bytes, for the same d and the base's element offset mod 4);
// scratch int32 of 4 + 2 · blocks · k, zero at the first call (each call
// leaves it so); out (2, k) int32: the values' bits, then the rows.
// 1 ≤ k ≤ 128, k ≤ n. One launch on `stream`; returns the CUDA error code
// (0 = ok).
int hmm_topk_cosine_f32(const void* q, const void* feats, int n, int d, int k, int blocks,
                        int chunk_rows, int stages, int smem_bytes, void* scratch, void* out,
                        void* stream) {
  if (n <= 0 || d <= 0 || k < 1 || k > kMaxK || k > n || blocks < 1 || chunk_rows < 1 ||
      chunk_rows > kList - kMaxK || stages < 2 || stages > kMaxStages ||
      reinterpret_cast<uintptr_t>(feats) % 4)
    return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const Layout lay(d, chunk_rows, stages, blocks, vec);
  // the merge works in the ring's shared memory (at least 4096 entries),
  // which holds the lists' heads and a group of prefixes behind k
  if (smem_bytes != lay.total || pow2_at_least(blocks * ((k + blocks - 1) / blocks)) > kMergeMin)
    return (int)cudaErrorInvalidValue;
  // the most dynamic shared memory a block may take beside the kernel's
  // static shared memory, set once per device and instance
  static int most[2][kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const auto fn = vec ? topk_cosine<true> : topk_cosine<false>;
  if (most[vec][dev] == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    const int dyn = kSmemBlock - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
    most[vec][dev] = dyn;
  }
  if (smem_bytes > most[vec][dev]) return (int)cudaErrorInvalidValue;
  TopkArgs args;
  args.q = static_cast<const float*>(q);
  args.feats = static_cast<const float*>(feats);
  args.n = n;
  args.d = d;
  args.k = k;
  args.chunk_rows = chunk_rows;
  args.stages = stages;
  args.scratch = static_cast<int*>(scratch);
  args.out_v = static_cast<float*>(out);
  args.out_i = static_cast<int*>(out) + k;
  fn<<<blocks, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

}  // extern "C"
