// Exact top-k serving kernel for Hopper (sm_90a): a radix select.
//
// Replaces yt8m_tpu/kernels/topk.py :: exact_topk (reached through
// serving_topk and sorted_topk). For x [B, C] f32 and k <= 128 it writes
// the k largest values of each row in descending order and their column
// indices. Ties go to the lowest index. NaN and values <= -3e38 (so -inf
// too) rank last and come out as exactly -3e38 with in-range indices.
// -0.0 and +0.0 tie (the TPU kernel's `v == m`, a stable sort's order):
// the lower index first, each reported with its own sign.
//
// What bounds it: reading x once (9.7 MB at B=512, C=4716: 2.9 us at the
// card's memory rate), and at that size a row's latency: B=512 rows put
// ~4 blocks on each SM. The TPU kernel's k selection sweeps ran in
// series; this one has no round per output. A block a row:
//  1. Load. The row with 16-byte loads (C % 4 == 0, 4716 is) or 4-byte
//     ones, up to 8 a thread in flight, sanitised and mapped to an
//     order-preserving 32-bit key (the sign bit flipped for positives,
//     every bit for negatives; -0.0 first made +0.0 so that the two share
//     a key), the keys into shared memory.
//  2. Threshold. Each thread takes the largest of the keys it loaded (an
//     empty set 0, below every key); each warp sorts its 32 maxima with
//     shuffles; the threshold is the least of the warps' ceil(k / 8)-th
//     largest: at least k distinct keys of the row reach it (8 warps,
//     each with ceil(k / 8) maxima at or above it), so every key of the
//     top k does.
//  3. Candidates. The keys that reach it (~k + 15 at 4716 scores) go to
//     shared memory in any order (a warp's slots taken by one atomic) and
//     a bitonic network sorts them by (key descending, index ascending):
//     one warp's shuffles up to 32 of them, shared memory above; the
//     first k are the output, each value from its key (+-0.0 from x).
//  4. Where more than 256 keys reach it (a row of many equal values) and
//     fewer than k pass it, the threshold is the k-th key; where k or more
//     pass it, a radix select on the row's keys finds the k-th, a byte a
//     pass from the top: a histogram of the keys still in the running
//     (those whose resolved bytes equal the threshold's) in 256 shared
//     bins, one warp's scan from the top to the bin that holds the k-th;
//     the passes stop once that bin holds exactly the keys still needed.
//     Each thread owns a contiguous span of columns (an odd number of
//     them: no two threads of a warp on one bank) and counts runs of equal
//     digits over it, a warp's equal counts merged before the atomic. The
//     keys above the k-th (any order) and its first ties in index order
//     (one block scan of the spans' counts) are gathered and sorted.
// Measured on the card (NVIDIA H100 80GB HBM3, 700 W): the radix select on
// every row took 0.030 ms at B=512 and the maxima's threshold found by
// radix select 0.025 ms: the time went to the passes' shared-memory work
// and barriers, not to the bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxK = 128;
constexpr int kCand = 256;  // candidates the first route sorts
constexpr int kLoads = 5;   // loads a thread keeps in flight (one round for C <= 5120)
constexpr float kNeg = -3.0e38f;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ float sanitise(float v) { return isnan(v) ? kNeg : fmaxf(v, kNeg); }

// Larger value, larger key; -0.0 and +0.0 on one key. No sanitised value
// maps to 0, the key the sort's padding (and an empty set's maximum) takes.
__device__ __forceinline__ uint32_t key_of(float v) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The value of column c from its key: the key's inverse, but for +-0.0
// (one key) the row's own bits.
__device__ __forceinline__ float value_of(uint32_t key, const float* xr, int c) {
  if (key == 0x80000000u) return sanitise(xr[c]);
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// (key, i) ranks before (key2, j): larger key first, then lower index.
__device__ __forceinline__ bool before(uint32_t a, int i, uint32_t b, int j) {
  return a > b || (a == b && i < j);
}

// The row's keys into shared memory: V values a load (4 or 1); the
// largest of the keys this thread loaded into *best (0, below every key,
// where it loaded none).
template <int V>
__device__ __forceinline__ void load_keys(const float* xr, uint32_t* keys, int C, uint32_t* best) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  using Key = typename std::conditional<V == 4, uint4, uint32_t>::type;
  const Vec* src = reinterpret_cast<const Vec*>(xr);
  const int n = C / V;
  *best = 0u;
  for (int base = 0; base < n; base += kThreads * kLoads) {
    Vec q[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * kThreads + static_cast<int>(threadIdx.x);
      if (i < n) q[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * kThreads + static_cast<int>(threadIdx.x);
      if (i < n) {
        Key kv;
        const float* v = reinterpret_cast<const float*>(&q[u]);
        uint32_t* k = reinterpret_cast<uint32_t*>(&kv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          k[e] = key_of(sanitise(v[e]));
          *best = max(*best, k[e]);
        }
        reinterpret_cast<Key*>(keys)[i] = kv;
      }
    }
  }
}

// fn(key, column) for each key this thread loaded (load_keys' order).
template <int V, typename Fn>
__device__ __forceinline__ void for_loaded(const uint32_t* keys, int C, Fn fn) {
  if constexpr (V == 4) {
    for (int i = threadIdx.x; i < C / 4; i += kThreads) {
      const uint4 kv = reinterpret_cast<const uint4*>(keys)[i];
      fn(kv.x, 4 * i);
      fn(kv.y, 4 * i + 1);
      fn(kv.z, 4 * i + 2);
      fn(kv.w, 4 * i + 3);
    }
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads) fn(keys[c], c);
  }
}

// One warp's bitonic network over (key, index), a pair a lane: lane 0
// ends with the first by (key descending, index ascending).
__device__ __forceinline__ void warp_sort(uint32_t& key, int& idx) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint32_t ok = __shfl_xor_sync(0xffffffffu, key, stride);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, stride);
      const bool first = (lane & stride) == 0;  // the pair's lower lane
      const bool down = (lane & size) == 0;     // this block sorts first-to-last
      if (before(ok, oi, key, idx) == (first == down)) {
        key = ok;
        idx = oi;
      }
    }
  }
}

struct Shared {
  unsigned hist[kBins];
  uint32_t cand_key[kCand];
  int cand_idx[kCand];
  unsigned warp_sums[kWarps];
  unsigned digit, above, count;
};
// count: the first route's candidates; then a radix pass's bin count.

// Exclusive block scan of x (every thread calls it); the block's total in
// *total.
__device__ __forceinline__ unsigned block_scan(unsigned x, Shared& sh, unsigned* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  __syncthreads();  // warp_sums free
  if (lane == 31) sh.warp_sums[warp] = incl;
  __syncthreads();
  unsigned before_warp = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned s = sh.warp_sums[w];
    before_warp += w < warp ? s : 0u;
    all += s;
  }
  *total = all;
  return before_warp + incl - x;
}

// Adds `run` keys of digit d to its bin (a thread with run > 0); the runs
// of the lanes that share the lowest such lane's digit are summed first.
// Every lane of the warp calls it.
__device__ __forceinline__ void flush(unsigned* hist, unsigned run, uint32_t d) {
  const unsigned active = __ballot_sync(0xffffffffu, run > 0);
  if (active == 0) return;
  const int first = __ffs(active) - 1;
  const uint32_t lead = __shfl_sync(0xffffffffu, d, first);
  const bool same = run > 0 && d == lead;
  const unsigned sum = __reduce_add_sync(0xffffffffu, same ? run : 0u);
  if ((threadIdx.x & 31) == first)
    atomicAdd(&hist[lead], sum);
  else if (run > 0 && !same)
    atomicAdd(&hist[d], run);
}

// The k-th largest of the keys key_at(j, &valid) (j < n, the same n for
// every thread; at least k valid keys in the block), a byte a pass from
// the top: its resolved bytes in *prefix under *mask; *need keys are
// still to take from those that equal it there. Every thread calls it.
template <typename KeyAt>
__device__ __forceinline__ void select_kth(KeyAt key_at, int n, unsigned k, Shared& sh,
                                           uint32_t* prefix, uint32_t* mask, unsigned* need) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  *prefix = 0;
  *mask = 0;
  *need = k;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int i = threadIdx.x; i < kBins; i += kThreads) sh.hist[i] = 0;
    __syncthreads();
    unsigned run = 0;  // keys of digit d in a row
    uint32_t d = 0;
    for (int j = 0; j < n; ++j) {
      bool valid;
      const uint32_t key = key_at(j, &valid);
      if (valid && (key & *mask) == *prefix) {
        const uint32_t dj = (key >> shift) & 0xffu;
        if (dj != d && run > 0) {
          atomicAdd(&sh.hist[d], run);
          run = 0;
        }
        d = dj;
        ++run;
      }
    }
    flush(sh.hist, run, d);
    __syncthreads();
    if (warp == 0) {
      // Lane l holds bins 255 - 8l down to 248 - 8l; the lane where the
      // count from the top first reaches `need` finds the bin.
      unsigned h[8], s = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        h[e] = sh.hist[kBins - 1 - 8 * lane - e];
        s += h[e];
      }
      unsigned incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      unsigned cum = incl - s;
      if (cum < *need && *need <= incl) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (cum + h[e] >= *need) {
            sh.digit = kBins - 1 - 8 * lane - e;
            sh.above = cum;
            sh.count = h[e];
            break;
          }
          cum += h[e];
        }
      }
    }
    __syncthreads();
    *need -= sh.above;
    *prefix |= sh.digit << shift;
    *mask |= 0xffu << shift;
    const unsigned s_count = sh.count;
    __syncthreads();  // every thread has read sh before the next pass
    if (s_count == *need) break;  // the whole bin is taken
  }
}

// Sorts cand[0, width) by (key descending, index ascending); width a
// power of two <= kCand. Every thread calls it.
__device__ __forceinline__ void bitonic(Shared& sh, int width) {
  for (int size = 2; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (width >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const uint32_t ka = sh.cand_key[lo], kb = sh.cand_key[hi];
        const int ia = sh.cand_idx[lo], ib = sh.cand_idx[hi];
        const bool up = (lo & size) == 0;
        if (up ? before(kb, ib, ka, ia) : before(ka, ia, kb, ib)) {
          sh.cand_key[lo] = kb;
          sh.cand_idx[lo] = ib;
          sh.cand_key[hi] = ka;
          sh.cand_idx[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, 4)
exact_topk_kernel(const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx,
                  int C, int k, int span) {
  extern __shared__ uint32_t keys[];  // [C]
  __shared__ Shared sh;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float* xr = x + b * C;
  uint32_t best;  // the largest key this thread loaded
  load_keys<V>(xr, keys, C, &best);
  if (tid == 0) sh.count = 0;

  // The least of the warps' ceil(k / 8)-th largest maxima.
  {
    int unused = 0;
    warp_sort(best, unused);
    const int m = (k + kWarps - 1) / kWarps;
    if (lane == m - 1) sh.warp_sums[warp] = best;
  }
  __syncthreads();
  uint32_t prefix = 0xffffffffu;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) prefix = min(prefix, sh.warp_sums[w]);
  uint32_t mask = 0xffffffffu;

  // Every key that reaches the threshold, in any order (the sort orders
  // them): a warp's slots taken by one atomic.
  {
    unsigned n = 0;
    for_loaded<V>(keys, C, [&](uint32_t key, int) { n += key >= prefix; });
    unsigned incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    unsigned base = 0;
    if (lane == 31) base = atomicAdd(&sh.count, incl);
    unsigned pos = __shfl_sync(0xffffffffu, base, 31) + incl - n;
    if (n)
      for_loaded<V>(keys, C, [&](uint32_t key, int c) {
        if (key >= prefix) {
          if (pos < kCand) {
            sh.cand_key[pos] = key;
            sh.cand_idx[pos] = c;
          }
          ++pos;
        }
      });
  }
  __syncthreads();
  unsigned total = sh.count;
  int width = 1;
  const int c0 = min(C, tid * span);
  const int c1 = min(C, c0 + span);
  if (total <= kCand) {
    while (width < static_cast<int>(total)) width <<= 1;
  } else {
    // The row's own k-th key: the threshold itself where fewer than k keys
    // pass it (ties at the top: a row of equal values), else by radix
    // select. The keys above it (k - need of them) in any order, then the
    // first `need` ties in index order.
    unsigned above = 0, ties = 0;
    for (int c = c0; c < c1; ++c) {
      above += keys[c] > prefix;
      ties += keys[c] == prefix;
    }
    unsigned pos = block_scan((above << 16) | ties, sh, &total);
    unsigned need = static_cast<unsigned>(k) - (total >> 16);
    if ((total >> 16) >= static_cast<unsigned>(k)) {
      select_kth(
          [&](int j, bool* valid) {
            *valid = c0 + j < c1;
            return *valid ? keys[c0 + j] : 0u;
          },
          span, static_cast<unsigned>(k), sh, &prefix, &mask, &need);
      above = ties = 0;
      for (int c = c0; c < c1; ++c) {
        const uint32_t km = keys[c] & mask;
        above += km > prefix;
        ties += km == prefix;
      }
      pos = block_scan((above << 16) | ties, sh, &total);
    }
    unsigned a_pos = pos >> 16, t_pos = pos & 0xffffu;
    const unsigned taken = static_cast<unsigned>(k) - need;
    for (int c = c0; c < c1 && (above | ties); ++c) {
      const uint32_t km = keys[c] & mask;
      if (km > prefix) {
        sh.cand_key[a_pos] = keys[c];
        sh.cand_idx[a_pos] = c;
        ++a_pos;
        --above;
      } else if (km == prefix) {
        if (t_pos < need) {
          sh.cand_key[taken + t_pos] = keys[c];
          sh.cand_idx[taken + t_pos] = c;
        }
        ++t_pos;
        --ties;
      }
    }
    total = k;
    while (width < k) width <<= 1;
  }
  __syncthreads();
  if (width <= 32) {  // one warp's shuffles
    if (warp == 0) {
      uint32_t key = lane < static_cast<int>(total) ? sh.cand_key[lane] : 0u;
      int i = lane < static_cast<int>(total) ? sh.cand_idx[lane] : kNoIndex;
      warp_sort(key, i);
      if (lane < k) {
        vals[b * k + lane] = value_of(key, xr, i);
        idx[b * k + lane] = i;
      }
    }
    return;
  }
  for (int i = total + tid; i < width; i += kThreads) {
    sh.cand_key[i] = 0u;
    sh.cand_idx[i] = kNoIndex;
  }
  __syncthreads();
  bitonic(sh, width);
  for (int j = tid; j < k; j += kThreads) {
    const int c = sh.cand_idx[j];
    vals[b * k + j] = value_of(sh.cand_key[j], xr, c);
    idx[b * k + j] = c;
  }
}

// Columns a thread owns: ceil(C / threads), made odd.
int span_of(int C) {
  const int s = (C + kThreads - 1) / kThreads;
  return s | 1;
}

}  // namespace

extern "C" int yt8m_exact_topk(const void* x, void* vals, void* idx, int B, int C, int k,
                               void* stream) {
  if (B <= 0 || C <= 0 || C > 0xffff || k <= 0 || k > kMaxK || k > C)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(C);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = vec ? exact_topk_kernel<4> : exact_topk_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(idx), C, k,
      span_of(C));
  return static_cast<int>(cudaGetLastError());
}

// The compiled kernel's plan for C columns: threads, the span a thread
// owns, dynamic shared memory (bytes), bins, loads a thread in flight,
// the first route's candidates at most, static shared memory (bytes).
extern "C" int yt8m_exact_topk_plan(int C, int* plan) {
  plan[0] = kThreads;
  plan[1] = span_of(C);
  plan[2] = static_cast<int>(sizeof(float)) * C;
  plan[3] = kBins;
  plan[4] = kLoads;
  plan[5] = kCand;
  plan[6] = static_cast<int>(sizeof(Shared));
  return static_cast<int>(cudaSuccess);
}

extern "C" const char* yt8m_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
