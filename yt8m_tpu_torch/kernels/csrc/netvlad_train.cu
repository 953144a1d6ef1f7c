// Trainable NetVLAD core for Hopper (sm_90a): a forward and a backward.
//
// Replaces yt8m_tpu/kernels/netvlad_train.py :: netvlad_core (its forward
// pallas_call at :135, its backward at :189). Per video b, with
// n = min(num_frames[b], F) live frames:
//
//   assign[f, k] = softmax_k(act[f, :])   for f < n, else 0          (f32)
//   forward:  vlad[k, d] = sum_f bf16(assign[f, k]) bf16(x[f, d])  (f32 sums)
//                          - a_sum[k] centers[k, d]
//             a_sum[k]   = sum_f assign[f, k]    (unrounded f32, frame order)
//   backward: dassign[f, k] = sum_d bf16(x[f, d]) bf16(dvlad[k, d]) - cdot[k]
//             cdot[k]       = sum_d centers[k, d] dvlad[k, d]            (f32)
//             dact[f, k]    = assign[f, k] (dassign[f, k] - sum_k' assign dassign)
//             dx[f, d]      = sum_k bf16(assign[f, k]) bf16(dvlad[k, d])
//
// The operands of the products are rounded to bf16 whatever the model's
// compute dtype, as in the TPU kernel; the softmax, a_sum, cdot and the
// softmax VJP stay in f32. dcenters = -sum_b a_sum[b] (x) dvlad[b] is a
// plain reduction outside (the wrapper).
//
// What bounds it: at B=256, F=300, K=256, D=1152 the forward reads the
// live rows of act and x and writes vlad (302 MB), the backward reads
// dvlad (302 MB) and the live rows of act and x and writes dact: device-
// memory bytes both ways (2 live K D FLOP a product is ~0.05 ms at the
// bf16 peak). So the design reads each of those bytes from device memory
// once, with TMA copies in flight, does each frame's softmax once in the
// forward, and runs the products on wgmma (the tensor cores' only full-
// rate path; mma.sync would also keep pace, but the shared header has the
// pipeline and the layouts).
//
// Forward, two launches:
//  1. vlad_assign_kernel, a block a video: its live frames R at a time
//     into shared memory (cp.async, double-buffered; R = 32, or as many
//     rows of K floats as two buffers fit above K = 890: 27 at K = 1024),
//     each row's max and sum of exp over all K (a warp a row),
//     then a thread a cluster walks the rows in frame order: a_sum (the
//     unrounded f32 sum, kept in shared memory across the chunks) and
//     bf16(assign) into a [B, F, Kp] buffer from
//     the wrapper (Kp = K rounded up to 8: TMA's 16-byte rows), with zero
//     rows from n to the next multiple of 64 (the product's last step).
//  2. vlad_fwd_kernel, persistent TMA + wgmma over tiles of (video, 256
//     clusters, 128 columns), the column tile fastest so a video's
//     assignment is read from device memory once and hits L2 for its
//     other column tiles. A stage is 64 frames: four assignment boxes
//     [64 frames][64 clusters] (A MN-major: the product takes it
//     transposed) and four f32 boxes of x [64 frames][32 columns]. Each
//     consumer warpgroup rounds its 64 columns of x to bf16 into the
//     swizzled MN-major B layout (frames past n as zeros), then runs four
//     m64n64k16 a 16-deep step (its 64 columns x 256 clusters, 128
//     accumulators). Only the live frames' steps are loaded. The epilogue
//     subtracts a_sum * centers (multiply and subtract each rounded, as
//     the plain version) and stores vlad in float2 from the registers
//     while the producer loads the next tile's stages. n = 0 gives vlad
//     = 0.
// Backward, two launches (three with dx):
//  1. vlad_bwd_prep_kernel, a warp a (video, cluster) row: dvlad read
//     once, bf16(dvlad) into a [B, K, Dp] buffer from the wrapper, and
//     cdot (f32). Every later read of dvlad is this bf16 copy.
//  2. vlad_bwd_kernel, persistent over tiles of (video, 64 frames), the
//     frame tile fastest (a video's bf16(dvlad) hits L2 after its first
//     tile). A stage is 64 deep: two f32 boxes of x [64 frames][32] and
//     bf16(dvlad) [2 Kh clusters][64 deep] (B K-major), a 4-stage ring at
//     Kh = 128; the two consumers round x to bf16 together (32 frames
//     each, K-major A, frames past n as zeros, three buffers so that a
//     buffer is written again only after both warpgroups' products on it
//     have completed) and each runs m64nKhk16 over its Kh = 128 (K <=
//     256) or 256 (K <= 512) clusters:
//     dassign for 64 frames x every cluster in the two warpgroups'
//     registers. The epilogue is the softmax VJP in f32 on those
//     registers: each row's max, sum of exp and sum of assign * dassign
//     over the row's quad of lanes and across the two warpgroups (shared
//     memory), dact = assign (dassign - cdot - t); frames past n get dact
//     = 0 and are never read. Its loads are unconditional (clamped, the
//     values selected away) and assign is exp(act - max) times the row's
//     reciprocal sum (within an ulp of the plain version's quotient): a
//     load or an IEEE division under a per-element branch ran the loads
//     one at a time, 0.40 ms of epilogue instead of ~0.1 (an H100). With
//     dx, bf16(assign) goes to a [B, F, Kp] buffer (zeros past n), and
//  3. dx = bf16(assign) @ bf16(dvlad) runs on hopper_product.cuh, a batch
//     a video (A K-major, dvlad MN-major, the TMA-store epilogue).
// K > 512: the two warpgroups' registers no longer hold a row's K
// clusters, and the softmax VJP needs the row's max, sum of exp and
// sum_k assign * dassign over all of them. So launch 2 becomes
// vlad_bwd_kernel's Wide instance, tiles of (video, 64 frames, 512
// clusters) with the cluster tile fastest (a frame tile's x comes from L2
// for its other cluster tiles), whose epilogue stores dassign = acc - cdot
// of the live rows into dact itself; then vlad_bwd_softmax_wide, a warp a
// row, recomputes the row's assignment from act over all K, forms t and
// dact = assign (dassign - t) in place (zeros past n), and bf16(assign)
// for dx. The extra traffic is a write and two reads of the live rows'
// [F, K] f32 rows beside the act reads the kernel already makes.
// x reaches both products as f32 (the model's frames): TMA brings its
// live rows in, the consumers round them once. D must be a multiple of 4
// (x's rows must be 16-byte strides for TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "hopper_product.cuh"
#include "input_affine.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxClusters = 512;  // K the backward's registers hold; above: the Wide pair
constexpr int kFrames = 64;  // frames a stage (forward) and a tile (backward)
constexpr int kF32Box = kFrames * hgemm::kF32BoxCols * 4;  // [64][32] f32: 8 KB
constexpr int kB16Box = kFrames * hgemm::kBoxCols * 2;     // [64][64] bf16: 8 KB

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Over the four lanes of a quad (a row of the wgmma accumulators).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ int live_frames(const int* num_frames, int b, int F) {
  return min(max(num_frames[b], 0), F);
}

// A consumer warpgroup rounds a [64 frames][64 columns] f32 tile, two
// swizzled boxes [64][32] at src, into one swizzled bf16 box [64][64] at
// dst (the layout of a K-major A and of an MN-major B alike). Frame rows
// f with first + f >= live become zeros and are not read. Each thread
// writes four 16-byte chunks (a frame's 8 columns); the reads and the
// writes hit every bank once a quarter-warp.
template <int Threads>
__device__ __forceinline__ void round_tile(const unsigned char* src, unsigned char* dst, int first,
                                          int live, int t) {
#pragma unroll
  for (int i = 0; i < 512 / Threads; ++i) {
    const int idx = t + Threads * i;
    const int f = idx >> 3;
    const int c8 = idx & 7;  // columns 8 c8 .. 8 c8 + 7
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (first + f < live) {
      const unsigned char* box = src + (c8 >> 2) * kF32Box;
      const int j = 2 * (c8 & 3);  // the box's 16-byte chunks j, j + 1
      const float4 lo = *reinterpret_cast<const float4*>(box + hgemm::swizzled(f, j));
      const float4 hi = *reinterpret_cast<const float4*>(box + hgemm::swizzled(f, j + 1));
      out.x = inaff::pack_bf16(lo.x, lo.y);
      out.y = inaff::pack_bf16(lo.z, lo.w);
      out.z = inaff::pack_bf16(hi.x, hi.y);
      out.w = inaff::pack_bf16(hi.z, hi.w);
    }
    *reinterpret_cast<uint4*>(dst + hgemm::swizzled(f, c8)) = out;
  }
}

// ---------------------------------------------------------------------------
// Forward 1: the assignment, a_sum and bf16(assign).
// ---------------------------------------------------------------------------

constexpr int kAsgThreads = 256;
constexpr int kAsgRows = 32;  // frames a chunk in shared memory, at most
constexpr int kAsgSmemLimit = 232448 - hgemm::kAlign;  // beside the static row stats

// Rows a chunk at K clusters: 32, or as many as two buffers of K floats
// leave room for beside the column sums; 0: K too large for a block.
inline int assign_rows(int K) {
  const long long r = (kAsgSmemLimit - 4LL * K) / (8LL * K);
  return r < kAsgRows ? static_cast<int>(r < 0 ? 0 : r) : kAsgRows;
}

// Two chunk buffers [R][K] f32, then the column sums [K].
inline int assign_smem(int K) { return (2 * assign_rows(K) + 1) * K * 4; }

__global__ void __launch_bounds__(kAsgThreads)
vlad_assign_kernel(const float* __restrict__ act, const int* __restrict__ num_frames,
                   bf16* __restrict__ assign, float* __restrict__ a_sum, int F, int K, int Kp,
                   int R) {
  extern __shared__ __align__(16) float s_act[];  // [2][R][K], then the column sums [K]
  __shared__ float s_max[kAsgRows];
  __shared__ float s_rcp[kAsgRows];
  float* s_col = s_act + 2 * R * K;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x;
  const int live = live_frames(num_frames, b, F);
  const float* act_v = act + static_cast<size_t>(b) * F * K;
  bf16* as_v = assign + static_cast<size_t>(b) * F * Kp;
  // A thread owns the column sums of its clusters k = tid + 256 i: it alone
  // writes and reads them, so they need no barrier.
  for (int k = tid; k < K; k += kAsgThreads) s_col[k] = 0.0f;

  // Rows f0 .. of the live frames into buffer buf: cp.async when the rows
  // are 16-byte aligned (K % 4 == 0), so the next chunk arrives while
  // this one is reduced; plain loads otherwise.
  auto fetch = [&](int f0, int buf) {
    const int n = min(R, live - f0) * K;
    const float* src = act_v + static_cast<size_t>(f0) * K;
    float* dst = s_act + buf * R * K;
    if (K % 4 == 0) {
      for (int i = 4 * tid; i < n; i += 4 * kAsgThreads) hgemm::cp_async16(dst + i, src + i, 16);
    } else {
      for (int i = tid; i < n; i += kAsgThreads) dst[i] = __ldg(src + i);
    }
    hgemm::cp_async_commit();
  };

  if (live > 0) fetch(0, 0);
  for (int f0 = 0, c = 0; f0 < live; f0 += R, ++c) {
    const int rows = min(R, live - f0);
    const float* cur = s_act + (c & 1) * R * K;
    if (f0 + R < live) {
      fetch(f0 + R, (c & 1) ^ 1);
      hgemm::cp_async_wait<1>();
    } else {
      hgemm::cp_async_wait<0>();
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kAsgThreads / 32) {
      const float* row = cur + r * K;
      float m = -INFINITY;
      for (int k = lane; k < K; k += 32) m = fmaxf(m, row[k]);
      m = warp_max(m);
      float s = 0.0f;
      for (int k = lane; k < K; k += 32) s += expf(__fsub_rn(row[k], m));
      s = warp_sum(s);
      if (lane == 0) {
        s_max[r] = m;
        s_rcp[r] = 1.0f / s;
      }
    }
    __syncthreads();
    // assign = exp(act - max) times the row's reciprocal sum (within an
    // ulp of the quotient; a division a value is a branch to its slow
    // path, and this loop is the launch's critical path).
    for (int k = tid; k < K; k += kAsgThreads) {
      float col = s_col[k];
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        const float p = expf(__fsub_rn(cur[r * K + k], s_max[r])) * s_rcp[r];
        col += p;
        as_v[static_cast<size_t>(f0 + r) * Kp + k] = __float2bfloat16_rn(p);
      }
      s_col[k] = col;
    }
    __syncthreads();
  }
  // Zero rows from n to the product's last frame step.
  const int zend = min(F, (live + kFrames - 1) / kFrames * kFrames);
  for (int i = tid; i < (zend - live) * K; i += kAsgThreads)
    as_v[static_cast<size_t>(live + i / K) * Kp + i % K] = __float2bfloat16_rn(0.0f);
  for (int k = tid; k < K; k += kAsgThreads) a_sum[static_cast<size_t>(b) * K + k] = s_col[k];
}

// ---------------------------------------------------------------------------
// Forward 2: vlad = bf16(assign)^T @ bf16(x) - a_sum (x) centers.
// ---------------------------------------------------------------------------

constexpr int kFwdClusters = 256;  // a tile: four m64 blocks
constexpr int kFwdCols = 128;      // a tile: 64 columns a consumer warpgroup
constexpr int kFwdStages = 3;
constexpr int kFwdStageBytes = 4 * kB16Box + 4 * kF32Box;  // 64 KB
constexpr int kFwdSmemBytes =
    kFwdStages * kFwdStageBytes + 2 * 2 * kB16Box + 2 * kFwdStages * 8;
constexpr int kFwdSmem = hgemm::smem_request(kFwdSmemBytes);
static_assert(kFwdSmem <= 232448, "shared memory a block");

__device__ __forceinline__ void fwd_coords(int t, int n_kt, int n_ct, int& b, int& kt, int& ct) {
  ct = t % n_ct;
  const int rest = t / n_ct;
  kt = rest % n_kt;
  b = rest / n_kt;
}

__global__ void __launch_bounds__(hgemm::kThreads, 1)
vlad_fwd_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_x,
                const int* __restrict__ num_frames, const float* __restrict__ centers,
                const float* __restrict__ a_sum, float* __restrict__ vlad, int B, int F, int D,
                int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  unsigned char* b16 = smem + kFwdStages * kFwdStageBytes;  // [2 warpgroups][2][64][64] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(b16 + 2 * 2 * kB16Box);
  uint64_t* empty = full + kFwdStages;

  const int n_ct = (D + kFwdCols - 1) / kFwdCols;
  const int n_kt = (K + kFwdClusters - 1) / kFwdClusters;
  const int tiles = B * n_kt * n_ct;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      hgemm::bar_init(&full[s], 1);
      hgemm::bar_init(&empty[s], hgemm::kConsumerWarps);
    }
    hgemm::bar_init_fence();
  }
  __syncthreads();

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* amap = &map_a;
  const CUtensorMap* xmap = &map_x;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int b, kt, ct;
        fwd_coords(t, n_kt, n_ct, b, kt, ct);
        const int nk = (live_frames(num_frames, b, F) + kFrames - 1) / kFrames;
        hgemm::produce<kFwdStages>(
            full, empty, ring, nk, kFwdStageBytes, [&](int s, uint64_t* bar, int ks) {
              unsigned char* st = smem + s * kFwdStageBytes;
#pragma unroll
              for (int i = 0; i < 4; ++i)
                hgemm::tma_3d(st + i * kB16Box, amap, bar, kt * kFwdClusters + 64 * i,
                              ks * kFrames, b);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                hgemm::tma_3d(st + 4 * kB16Box + i * kF32Box, xmap, bar,
                              ct * kFwdCols + hgemm::kF32BoxCols * i, ks * kFrames, b);
            });
      }
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int r = lane >> 2;
    const int t128 = threadIdx.x & 127;
    unsigned char* mine = b16 + wg * 2 * kB16Box;
    float acc[128];  // four m64n64 blocks: clusters 64 i + ..., acc[32 i + ...]
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int b, kt, ct;
      fwd_coords(t, n_kt, n_ct, b, kt, ct);
      const int live = live_frames(num_frames, b, F);
      const int nk = (live + kFrames - 1) / kFrames;
      hgemm::zero<128>(acc);
      hgemm::consume_prepared<kFwdStages, 128>(
          full, empty, ring, nk, acc,
          [&](int s, int ks) {
            const unsigned char* xs = smem + s * kFwdStageBytes + 4 * kB16Box + wg * 2 * kF32Box;
            round_tile<128>(xs, mine + (ks & 1) * kB16Box, ks * kFrames, live, t128);
            hgemm::fence_async_smem();
            hgemm::named_sync(1 + wg, 128);
          },
          [&](int s, int ks) {
            const uint32_t st = hgemm::smem_u32(smem + s * kFwdStageBytes);
            const uint32_t bb = hgemm::smem_u32(mine + (ks & 1) * kB16Box);
#pragma unroll
            for (int kk = 0; kk < kFrames / 16; ++kk)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                hgemm::mma<64, 1, 1>(acc + 32 * i, hgemm::desc_a_mn(st + i * kB16Box, kk),
                                     hgemm::desc_b(bb, kk));
          });
      // Epilogue: vlad[k, d] = acc - a_sum[k] * centers[k, d]. The loads
      // are unconditional (clamped to cluster K - 1 and column D - 2), so
      // they are all in flight at once; only the stores are masked.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = kt * kFwdClusters + 64 * i + 16 * warp + r + 8 * h;
          const int kk = min(k, K - 1);
          const float as = __ldg(a_sum + static_cast<size_t>(b) * K + kk);
          const float* cen = centers + static_cast<size_t>(kk) * D;
          float* dst = vlad + (static_cast<size_t>(b) * K + k) * D;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int d = ct * kFwdCols + 64 * wg + 8 * j + 2 * q;
            const float2 c = __ldg(reinterpret_cast<const float2*>(cen + min(d, D - 2)));
            const int a = 32 * i + 4 * j + 2 * h;
            if (k < K && d < D)
              *reinterpret_cast<float2*>(dst + d) =
                  make_float2(__fsub_rn(acc[a], __fmul_rn(as, c.x)),
                              __fsub_rn(acc[a + 1], __fmul_rn(as, c.y)));
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 1: bf16(dvlad) and cdot.
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 256;

__global__ void __launch_bounds__(kPrepThreads)
vlad_bwd_prep_kernel(const float* __restrict__ centers, const float* __restrict__ dvlad,
                     bf16* __restrict__ dv16, float* __restrict__ cdot, int rows, int D, int Dp,
                     int K) {
  const int row = blockIdx.x * (kPrepThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float4* v = reinterpret_cast<const float4*>(dvlad + static_cast<size_t>(row) * D);
  const float4* c = reinterpret_cast<const float4*>(centers + static_cast<size_t>(row % K) * D);
  uint2* o = reinterpret_cast<uint2*>(dv16 + static_cast<size_t>(row) * Dp);
  float s = 0.0f;
  for (int i = lane; i < D / 4; i += 32) {
    const float4 a = __ldg(v + i);
    const float4 cc = __ldg(c + i);
    s = __fadd_rn(s, __fmul_rn(cc.x, a.x));
    s = __fadd_rn(s, __fmul_rn(cc.y, a.y));
    s = __fadd_rn(s, __fmul_rn(cc.z, a.z));
    s = __fadd_rn(s, __fmul_rn(cc.w, a.w));
    o[i] = make_uint2(inaff::pack_bf16(a.x, a.y), inaff::pack_bf16(a.z, a.w));
  }
  s = warp_sum(s);
  if (lane == 0) cdot[row] = s;
}

// ---------------------------------------------------------------------------
// Backward 2: dassign on wgmma, the softmax VJP, dact (and bf16(assign)).
// ---------------------------------------------------------------------------

template <int Kh>  // clusters a consumer warpgroup: 128 (K <= 256) or 256 (K <= 512)
struct Bwd {
  static constexpr int kStages = Kh == 128 ? 4 : 2;
  static constexpr int kXBytes = 2 * kF32Box;       // [64 frames][64 deep] f32
  static constexpr int kVRows = 2 * Kh;             // bf16(dvlad) rows a stage
  static constexpr int kVBoxRows = 256;             // TMA's largest box
  static constexpr int kVBytes = kVRows * 128;      // [2 Kh][64 deep] bf16
  static constexpr int kStageBytes = kXBytes + kVBytes;
  static constexpr int kA16Bytes = 3 * kB16Box;  // [3][64][64] bf16, both warpgroups
  static constexpr int kRedFloats = 2 * 3 * 2 * kFrames;  // [tile parity][max, sum, t][warpgroup][row]
  static constexpr int kSmemBytes =
      kStages * kStageBytes + kA16Bytes + kRedFloats * 4 + 2 * kStages * 8;
  static constexpr int kSmem = hgemm::smem_request(kSmemBytes);
  static_assert(kSmem <= 232448, "shared memory a block");
  static_assert(kVRows % kVBoxRows == 0, "whole dvlad boxes");
};

// Wide (Kh = 256, K > 512): tiles of (video, 64 frames, 2 Kh clusters),
// the epilogue stores dassign = acc - cdot of the live rows into dact and
// vlad_bwd_softmax_wide finishes the rows.
template <int Kh, bool Wide = false>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
vlad_bwd_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_v,
                const float* __restrict__ act, const int* __restrict__ num_frames,
                const float* __restrict__ cdot, float* __restrict__ dact, bf16* __restrict__ p16,
                int B, int F, int D, int K, int Kp, int need_dx) {
  static_assert(!Wide || Kh == 256, "the wide tiles");
  using P = Bwd<Kh>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  unsigned char* a16 = smem + P::kStages * P::kStageBytes;
  float* red = reinterpret_cast<float*>(a16 + P::kA16Bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + P::kRedFloats);
  uint64_t* empty = full + P::kStages;

  const int n_ft = (F + kFrames - 1) / kFrames;
  const int n_kt = Wide ? (K + 2 * Kh - 1) / (2 * Kh) : 1;  // cluster tiles, the fastest
  const int tiles = B * n_ft * n_kt;
  const int nk = (D + hgemm::kDepth - 1) / hgemm::kDepth;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      hgemm::bar_init(&full[s], 1);
      hgemm::bar_init(&empty[s], hgemm::kConsumerWarps);
    }
    hgemm::bar_init_fence();
  }
  __syncthreads();

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* xmap = &map_x;
  const CUtensorMap* vmap = &map_v;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int kt = t % n_kt;
        const int b = t / n_kt / n_ft;
        const int f0 = (t / n_kt % n_ft) * kFrames;
        const int steps = f0 < live_frames(num_frames, b, F) ? nk : 0;
        hgemm::produce<P::kStages>(
            full, empty, ring, steps, P::kStageBytes, [&](int s, uint64_t* bar, int ks) {
              unsigned char* st = smem + s * P::kStageBytes;
#pragma unroll
              for (int i = 0; i < 2; ++i)
                hgemm::tma_3d(st + i * kF32Box, xmap, bar,
                              ks * hgemm::kDepth + hgemm::kF32BoxCols * i, f0, b);
#pragma unroll
              for (int i = 0; i < P::kVRows / P::kVBoxRows; ++i)
                hgemm::tma_3d(st + P::kXBytes + i * P::kVBoxRows * 128, vmap, bar,
                              ks * hgemm::kDepth, kt * P::kVRows + i * P::kVBoxRows, b);
            });
      }
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int r = lane >> 2;
    float acc[Kh / 2];
    int iter = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++iter) {
      const int kt = t % n_kt;
      const int b = t / n_kt / n_ft;
      const int f0 = (t / n_kt % n_ft) * kFrames;
      const int live = live_frames(num_frames, b, F);
      const int steps = f0 < live ? nk : 0;
      hgemm::zero<Kh / 2>(acc);
      hgemm::consume_prepared<P::kStages, Kh / 2>(
          full, empty, ring, steps, acc,
          [&](int s, int ks) {
            round_tile<256>(smem + s * P::kStageBytes, a16 + (ks % 3) * kB16Box, f0, live,
                            threadIdx.x);
            hgemm::fence_async_smem();
            hgemm::named_sync(4, 256);
          },
          [&](int s, int ks) {
            const uint32_t aa = hgemm::smem_u32(a16 + (ks % 3) * kB16Box);
            const uint32_t vv =
                hgemm::smem_u32(smem + s * P::kStageBytes + P::kXBytes) + wg * Kh * 128;
#pragma unroll
            for (int kk = 0; kk < hgemm::kDepth / 16; ++kk)
              hgemm::mma<Kh, 0, 0>(acc, hgemm::desc_a(aa, kk), hgemm::desc_b_k(vv, kk));
          });

      if constexpr (Wide) {
        // dassign = acc - cdot of the live rows, clusters kt 2 Kh + wg Kh +
        // 8 j + 2 q + e (loads clamped to K - 1, stores masked).
        const float* cdot_v = cdot + static_cast<size_t>(b) * K;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = f0 + 16 * warp + r + 8 * h;
          if (f >= live) continue;
          float* drow = dact + (static_cast<size_t>(b) * F + f) * K;
#pragma unroll
          for (int j = 0; j < Kh / 8; ++j) {
            const int k = kt * 2 * Kh + wg * Kh + 8 * j + 2 * q;
            const float g0 = __fsub_rn(acc[4 * j + 2 * h], __ldg(cdot_v + min(k, K - 1)));
            const float g1 = __fsub_rn(acc[4 * j + 2 * h + 1], __ldg(cdot_v + min(k + 1, K - 1)));
            if (k + 1 < K && K % 2 == 0) {
              *reinterpret_cast<float2*>(drow + k) = make_float2(g0, g1);
            } else {
              if (k < K) drow[k] = g0;
              if (k + 1 < K) drow[k + 1] = g1;
            }
          }
        }
        continue;
      }
      // The softmax VJP. Thread rows ff = 16 warp + r + 8 h of the tile;
      // clusters k = wg Kh + 8 j + 2 q + e in acc[4 j + 2 h + e]. Every
      // load is unconditional (a dead row reads the video's frame 0, live
      // in a live tile; a cluster past K reads cluster K - 1) and its
      // value is selected away: loads under per-element branches ran one
      // at a time. At Kh = 128 the thread's act values stay in registers
      // (then exp(act - max), then assign); at Kh = 256 they are read
      // again in each pass.
      float* rd = red + (iter & 1) * 3 * 2 * kFrames;
      const float* act_v = act + static_cast<size_t>(b) * F * K;
      const float* cdot_v = cdot + static_cast<size_t>(b) * K;
      bool lv[2];
      int f[2];
      const float* arow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        f[h] = f0 + 16 * warp + r + 8 * h;
        lv[h] = f[h] < live;
        arow[h] = act_v + (lv[h] ? static_cast<size_t>(f[h]) * K : 0);
      }
      auto kc = [&](int j, int e) { return min(wg * Kh + 8 * j + 2 * q + e, K - 1); };
      auto valid = [&](int h, int j, int e) { return lv[h] && wg * Kh + 8 * j + 2 * q + e < K; };
      constexpr bool kCached = Kh == 128;
      float av[kCached ? Kh / 2 : 1];
      auto act_at = [&](int h, int j, int e) {
        if constexpr (kCached) {
          return av[4 * j + 2 * h + e];
        } else {
          return __ldg(arow[h] + kc(j, e));
        }
      };
      // A tile past n reads nothing and writes zeros (both warpgroups
      // take the same branch, so the barriers below still pair up).
      // The loads sit in blocks with no branch inside (assign is exp
      // times the row's reciprocal sum: an IEEE division a value would
      // put a branch to its slow path between them), so they are in
      // flight together.
      const bool tile_live = f0 < live;
      if constexpr (kCached) {
        if (tile_live) {
#pragma unroll
          for (int j = 0; j < Kh / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) av[4 * j + 2 * h + e] = __ldg(arow[h] + kc(j, e));
        } else {
          hgemm::zero<Kh / 2>(av);
        }
      }
      // Across the quad, then across the two warpgroups: quantity w of
      // this tile (0 max, 1 sum, 2 t).
      auto across = [&](float (&v)[2], int w, bool is_max) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = is_max ? quad_max(v[h]) : quad_sum(v[h]);
          if (q == 0) rd[(w * 2 + wg) * kFrames + 16 * warp + r + 8 * h] = v[h];
        }
        hgemm::named_sync(3, 256);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float o = rd[(w * 2 + (wg ^ 1)) * kFrames + 16 * warp + r + 8 * h];
          v[h] = is_max ? fmaxf(v[h], o) : v[h] + o;
        }
      };
      float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.0f, 0.0f}, tt[2] = {0.0f, 0.0f};
      if (tile_live) {
#pragma unroll
        for (int j = 0; j < Kh / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = act_at(h, j, e);
              m[h] = valid(h, j, e) ? fmaxf(m[h], a) : m[h];
            }
        across(m, 0, true);
#pragma unroll
        for (int j = 0; j < Kh / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ex = valid(h, j, e) ? expf(__fsub_rn(act_at(h, j, e), m[h])) : 0.0f;
              s[h] += ex;
              if constexpr (kCached) av[4 * j + 2 * h + e] = ex;
            }
        across(s, 1, false);
#pragma unroll
        for (int h = 0; h < 2; ++h) s[h] = 1.0f / s[h];  // now the reciprocal sum
        // dassign = acc - cdot (kept in acc); t = sum_k assign * dassign;
        // assign kept in av at Kh = 128.
#pragma unroll
        for (int j = 0; j < Kh / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              float p;
              if constexpr (kCached) {
                p = av[i] * s[h];
              } else {
                p = expf(__fsub_rn(act_at(h, j, e), m[h])) * s[h];
              }
              p = valid(h, j, e) ? p : 0.0f;
              if constexpr (kCached) av[i] = p;
              acc[i] = __fsub_rn(acc[i], __ldg(cdot_v + kc(j, e)));
              tt[h] = __fadd_rn(tt[h], __fmul_rn(p, acc[i]));
            }
          }
        across(tt, 2, false);
      }
      // dact = assign (dassign - t); zeros past n. bf16(assign) for dx.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (f[h] >= F) continue;
        float* drow = dact + (static_cast<size_t>(b) * F + f[h]) * K;
#pragma unroll
        for (int j = 0; j < Kh / 8; ++j) {
          const int k = wg * Kh + 8 * j + 2 * q;  // k and k + 1
          float p[2], g[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            if constexpr (kCached) {
              p[e] = av[i];
            } else {
              p[e] = valid(h, j, e) ? expf(__fsub_rn(act_at(h, j, e), m[h])) * s[h] : 0.0f;
            }
            g[e] = valid(h, j, e) ? __fmul_rn(p[e], __fsub_rn(acc[i], tt[h])) : 0.0f;
          }
          if (k >= K) continue;
          if (K % 2 == 0) {
            *reinterpret_cast<float2*>(drow + k) = make_float2(g[0], g[1]);
          } else {
            drow[k] = g[0];
            if (k + 1 < K) drow[k + 1] = g[1];
          }
          // k + 1 < Kp: a pair always fits the padded row.
          if (need_dx)
            *reinterpret_cast<__nv_bfloat162*>(p16 + (static_cast<size_t>(b) * F + f[h]) * Kp + k) =
                __floats2bfloat162_rn(p[0], p[1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 2b (K > 512): the softmax VJP over a row's K clusters.
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 256;

// A warp a row (b, f): past n, dact = 0 (and bf16(assign) = 0); else the
// row's assignment from act (its max, sum of exp and reciprocal sum, as
// launch 2 computes them), t = sum_k assign * dassign with dassign the
// Wide tiles' dact, then dact = assign (dassign - t) in place.
__global__ void __launch_bounds__(kWideThreads)
vlad_bwd_softmax_wide(const float* __restrict__ act, const int* __restrict__ num_frames,
                      float* __restrict__ dact, bf16* __restrict__ p16, int B, int F, int K, int Kp,
                      int need_dx) {
  const long long row = static_cast<long long>(blockIdx.x) * (kWideThreads / 32) + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(B) * F) return;
  const int lane = threadIdx.x & 31;
  const int b = static_cast<int>(row / F);
  const int f = static_cast<int>(row % F);
  float* d = dact + row * K;
  bf16* pp = need_dx ? p16 + row * Kp : nullptr;
  if (f >= live_frames(num_frames, b, F)) {
    for (int k = lane; k < K; k += 32) {
      d[k] = 0.0f;
      if (need_dx) pp[k] = __float2bfloat16_rn(0.0f);
    }
    return;
  }
  const float* a = act + row * K;
  float m = -INFINITY;
  for (int k = lane; k < K; k += 32) m = fmaxf(m, __ldg(a + k));
  m = warp_max(m);
  float s = 0.0f;
  for (int k = lane; k < K; k += 32) s += expf(__fsub_rn(__ldg(a + k), m));
  const float rs = 1.0f / warp_sum(s);
  float t = 0.0f;
  for (int k = lane; k < K; k += 32)
    t = __fadd_rn(t, __fmul_rn(expf(__fsub_rn(__ldg(a + k), m)) * rs, d[k]));
  t = warp_sum(t);
  for (int k = lane; k < K; k += 32) {
    const float p = expf(__fsub_rn(__ldg(a + k), m)) * rs;
    d[k] = __fmul_rn(p, __fsub_rn(d[k], t));
    if (need_dx) pp[k] = __float2bfloat16_rn(p);
  }
}

template <int Kh, bool Wide = false>
cudaError_t launch_bwd(const void* act, const void* x, const void* num_frames, const void* dv16,
                       const void* cdot, void* dact, void* p16, int B, int F, int D, int K, int Kp,
                       int Dp, int need_dx, int sms, cudaStream_t st) {
  CUtensorMap map_x, map_v;
  cudaError_t err = hgemm::make_map_f32(&map_x, x, B, F, D, kFrames);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_v, dv16, B, K, D, Dp, Bwd<Kh>::kVBoxRows);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(vlad_bwd_kernel<Kh, Wide>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd<Kh>::kSmem);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(B) * ((F + kFrames - 1) / kFrames) *
                          (Wide ? (K + 2 * Kh - 1) / (2 * Kh) : 1);
  vlad_bwd_kernel<Kh, Wide><<<static_cast<int>(tiles < sms ? tiles : sms), hgemm::kThreads,
                              Bwd<Kh>::kSmem, st>>>(
      map_x, map_v, static_cast<const float*>(act), static_cast<const int*>(num_frames),
      static_cast<const float*>(cdot), static_cast<float*>(dact), static_cast<bf16*>(p16), B, F, D,
      K, Kp, need_dx);
  err = cudaGetLastError();
  if (err != cudaSuccess || !Wide) return err;
  const long long rows = static_cast<long long>(B) * F;
  constexpr int kRowsABlock = kWideThreads / 32;
  vlad_bwd_softmax_wide<<<static_cast<unsigned>((rows + kRowsABlock - 1) / kRowsABlock),
                          kWideThreads, 0, st>>>(
      static_cast<const float*>(act), static_cast<const int*>(num_frames), static_cast<float*>(dact),
      static_cast<bf16*>(p16), B, F, K, Kp, need_dx);
  return cudaGetLastError();
}

int pad8(int n) { return (n + 7) / 8 * 8; }

bool shapes_ok(int B, int F, int D, int K) {
  return B > 0 && B <= 65535 && F > 0 && D > 0 && D % 4 == 0 && K > 0 && assign_rows(K) > 0 &&
         static_cast<long long>(B) * F * (D > K ? D : K) < (1LL << 40) &&
         static_cast<long long>(B) * ((F + kFrames - 1) / kFrames) * ((K + 511) / 512) <
             (1LL << 31);
}

}  // namespace

// vlad [B, K, D] f32 and a_sum [B, K] f32 from act [B, F, K] f32, x [B, F,
// D] f32 (D a multiple of 4), num_frames [B] int32 and centers [K, D] f32;
// assign: a work buffer of B*F*Kp bf16 from the caller (Kp = K rounded up
// to 8).
extern "C" int yt8m_netvlad_core_forward(const void* act, const void* x, const void* num_frames,
                                         const void* centers, void* assign, void* vlad,
                                         void* a_sum, int B, int F, int D, int K, void* stream) {
  if (!shapes_ok(B, F, D, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Kp = pad8(K);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(vlad_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               assign_smem(K));
  if (err != cudaSuccess) return static_cast<int>(err);
  vlad_assign_kernel<<<B, kAsgThreads, assign_smem(K), st>>>(
      static_cast<const float*>(act), static_cast<const int*>(num_frames), static_cast<bf16*>(assign),
      static_cast<float*>(a_sum), F, K, Kp, assign_rows(K));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_x;
  err = hgemm::make_map_bf16(&map_a, assign, B, F, K, Kp, kFrames);
  if (err == cudaSuccess) err = hgemm::make_map_f32(&map_x, x, B, F, D, kFrames);
  int sms = 0;
  if (err == cudaSuccess) err = hgemm::sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(vlad_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = B * ((K + kFwdClusters - 1) / kFwdClusters) * ((D + kFwdCols - 1) / kFwdCols);
  vlad_fwd_kernel<<<tiles < sms ? tiles : sms, hgemm::kThreads, kFwdSmem, st>>>(
      map_a, map_x, static_cast<const int*>(num_frames), static_cast<const float*>(centers),
      static_cast<const float*>(a_sum), static_cast<float*>(vlad), B, F, D, K);
  return static_cast<int>(cudaGetLastError());
}

// dact [B, F, K] f32 and, when need_dx, dx [B, F, D] f32 from the forward's
// inputs and dvlad [B, K, D] f32. Work buffers from the caller: cdot [B, K]
// f32, dv16 B*K*Dp bf16 (Dp = D rounded up to 8) and, when need_dx, p16
// B*F*Kp bf16.
extern "C" int yt8m_netvlad_core_backward(const void* act, const void* x, const void* num_frames,
                                          const void* centers, const void* dvlad, void* cdot,
                                          void* dv16, void* p16, void* dact, void* dx, int B,
                                          int F, int D, int K, int need_dx, void* stream) {
  if (!shapes_ok(B, F, D, K) || (need_dx && (dx == nullptr || p16 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Kp = pad8(K);
  const int Dp = pad8(D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * K;
  const int per_block = kPrepThreads / 32;
  vlad_bwd_prep_kernel<<<(rows + per_block - 1) / per_block, kPrepThreads, 0, st>>>(
      static_cast<const float*>(centers), static_cast<const float*>(dvlad), static_cast<bf16*>(dv16),
      static_cast<float*>(cdot), rows, D, Dp, K);
  err = cudaGetLastError();
  int sms = 0;
  if (err == cudaSuccess) err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K <= 256)
    err = launch_bwd<128>(act, x, num_frames, dv16, cdot, dact, p16, B, F, D, K, Kp, Dp, need_dx,
                          sms, st);
  else if (K <= kMaxClusters)
    err = launch_bwd<256>(act, x, num_frames, dv16, cdot, dact, p16, B, F, D, K, Kp, Dp, need_dx,
                          sms, st);
  else
    err = launch_bwd<256, true>(act, x, num_frames, dv16, cdot, dact, p16, B, F, D, K, Kp, Dp,
                                need_dx, sms, st);
  if (err != cudaSuccess || !need_dx) return static_cast<int>(err);
  return static_cast<int>(
      hprod::launch_product(p16, dv16, static_cast<float*>(dx), B, F, D, K, Kp, Dp, st));
}

// The tiles: [frames a stage, forward clusters a tile, forward columns a
// tile, forward stages, forward shared bytes, backward stages and shared
// bytes at Kh = 128, the same at Kh = 256, assign rows a chunk, SMs].
extern "C" int yt8m_netvlad_core_plan(int* plan) {
  int sms = 0;
  const cudaError_t err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = kFrames;
  plan[1] = kFwdClusters;
  plan[2] = kFwdCols;
  plan[3] = kFwdStages;
  plan[4] = kFwdSmem;
  plan[5] = Bwd<128>::kStages;
  plan[6] = Bwd<128>::kSmem;
  plan[7] = Bwd<256>::kStages;
  plan[8] = Bwd<256>::kSmem;
  plan[9] = kAsgRows;
  plan[10] = sms;
  return static_cast<int>(cudaSuccess);
}
