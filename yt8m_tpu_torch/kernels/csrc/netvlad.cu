// Fused NetVLAD aggregation serving kernel for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/netvlad.py :: netvlad_aggregate. For frames
// x [B, F, D] (uint8 or float32), per video b with n = min(num_frames[b],
// F) live frames:
//
//   xb     = bf16(dequant(x))                  (dequant only for uint8)
//   act    = xb @ bf16(Wc) * act_scale + act_bias      [F, K] f32 sums
//   assign = softmax_K(act - max) * (t < n)            f32
//   vlad   = bf16(assign)^T @ xb - colsum(assign) (x) centers   [K, D]
//   vlad  /= max(||vlad||_D, 1e-6);  vlad /= max(||vlad||_KD, 1e-6)
//
// What bounds it: device-memory bytes. At B=512, F=300, D=1152, K=256
// with about half the frames live, the two products over the live frames
// are ~93 GFLOP (~0.09 ms at the bf16 peak), while the live f32 frames in
// (0.37 GB) and the f32 [B, K, D] out (0.60 GB) take ~0.29 ms at 3.35
// TB/s.
//
// Design. A video's [K, D] f32 sum (1.18 MB) and its frames exceed a
// block's shared memory, so the work is six launches on the caller's
// stream, each touching only live rows: a 64-frame chunk of a video is
// live when it holds a frame t < n, and no block or product step runs
// for another chunk.
//  0. nv_serve_scan, one block: the live chunks in video order, as a list
//     of (video, chunk) items and its length.
//  1. nv_serve_assign, persistent TMA + wgmma (hopper_gemm.cuh) over the
//     items. A stage is 64 deep: the chunk's 64 frames of x (f32 boxes
//     [64][32], or an unswizzled uint8 box [64][64 bytes]) and Wc [64
//     deep][K] (MN-major, the header's B layout). The consumers round x
//     to bf16 (uint8: the plain version's unfused dequant first) in place
//     into the K-major A layout, rows t >= n as zeros, and store the same
//     16 bytes to xb [B, F, D]: the live chunks' frames in bf16 for
//     launches 2 and 4, with no pass of its own. For K <= 256 each
//     consumer warpgroup owns one item (64 frames x K, one m64nK chain:
//     two chunks a block); for 256 < K <= 512 the two warpgroups share
//     one item and split K, joining each row's max and sum through
//     shared memory. The epilogue works in the accumulator registers:
//     the affine (multiply, then add, each rounded), the softmax (expf,
//     and a correctly rounded division: the plain version's rounding),
//     rows t >= n to 0, bf16(assign) to [B, F, K] (zeros from n to the
//     chunk's end), and the chunk's f32 column sums (a fold across the
//     lanes, then the four warps). nv_serve_asum then adds each video's
//     live chunk sums into a_sum.
//  2. nv_serve_aggregate<false>, persistent TMA + wgmma over tiles of
//     (video, 256 clusters, 128 columns). A block keeps one (cluster
//     tile, column tile), the column tile fastest across blocks, and
//     walks videos: that tile's centers [256][128] f32 (128 KB) are read
//     once into its shared memory instead of once a tile from L2 (0.6
//     GB a pass at B=512), and the blocks on a video's other column
//     tiles read its assignment at about the same time, from L2. A stage is 32 of the video's live frames: four
//     assignment boxes [32 frames][64 clusters] (A MN-major: the product
//     takes it transposed) and two xb boxes [32 frames][64 columns] (B
//     MN-major), 24 KB, in the 4 stages the centers leave room for (two
//     64-frame stages: 0.87 ms for the call against 0.81 at B=512 on an
//     H100, variants.py's agg_f64);
//     each consumer warpgroup runs two m64n128k16 a 16-frame step (its
//     128 clusters x the tile's 128 columns). The epilogue forms v = acc
//     - a_sum * centers (each rounded) and stores only each row's sum of
//     squares over the tile's columns. Each video's step count is read a
//     video ahead and a_sum before the mainloop, so neither load waits
//     at a tile's start.
//  3. nv_serve_norms, a block a video: the row norms and the global norm
//     from those sums, in the parent kernel's formulas.
//  4. nv_serve_aggregate<true>: launch 2 again, bit for bit the same v,
//     stored once as (v / n_k) / g (each division correctly rounded).
// Recomputing the product (one more ~47 GFLOP product over the live
// frames and a second read of the bf16 frames) replaces a second pass
// over the f32 output (1.2 GB read and written at B=512). A cluster of
// the D / 128 column tiles exchanging the sums over distributed shared
// memory would save that too, but it cannot span the two cluster tiles
// of K > 256 (one global norm a video) and would leave SMs idle (a
// cluster of 9 one-block SMs fits once or twice a GPC).
// n = 0 gives an exact zero descriptor: no step runs, a_sum = 0, v = 0.
//
// K > 512 (any K, a multiple of 8): one block no longer holds a row's K
// logits for its softmax, so launch 1 splits in two. 1a is
// nv_serve_assign's Logits instance: its tiles are (two live chunks, 256
// clusters), the cluster tile fastest so that a chunk pair's frames come
// from L2 for its other cluster tiles; the epilogue stores the affine
// logits of the live rows into an f32 scratch [B, F, K] (and the first
// cluster tile the frames to xb). 1b, nv_serve_softmax_wide, a block a
// live chunk: each row's max and sum of exp over all K (a warp a row),
// then a thread a cluster walks the chunk's rows: the same assignment
// (expf, the correctly rounded division), bf16(assign) with zeros from n
// to the chunk's end, and the chunk's column sum. Launches 2-4 already
// tile K by 256. The scratch costs a write and two reads of the live
// rows' logits (0.33 GB each at B=512, K=1024 and 80,819 live frames)
// beside the 2.4 GB f32 output.
//
// The f32 route (--compute_dtype=float32, Wc f32): the same function with
// nothing rounded, as the TPU kernel computes it at dtype=float32, both
// products in plain f32 FMAs (f32_product.cuh: no TF32), any D and any K
// with no padding. Bound by the f32 rate outside the tensor cores:
// twice 2 B F D K, 0.18 TFLOP at B=512, F=300, D=1152, K=256 (2.7 ms at
// 67 TFLOP/s on live frames). Five launches after launch 0 above (the
// live chunks), each on live rows only:
//  1. nv_f32_assign: act = x @ Wc * act_scale + act_bias (uint8: the
//     unfused dequant first) into an f32 scratch [B, F, K], a block per
//     two live 64-frame chunks of the list (the 128 rows of the
//     product's tile) and 128 clusters.
//  2. nv_f32_softmax: a warp per live row t < n, the softmax over K in
//     place (expf, a correctly rounded division): the assignment.
//  3. nv_f32_asum: a thread per (video, cluster), a_sum over t < n.
//  4. nv_f32_aggregate: v = assign^T x - a_sum (x) centers, a block per
//     (video, 128 clusters, 128 columns) over the video's t < n: the
//     assignment rows are the A panel as they lie (depth-major), the
//     frames the B panel. The epilogue stores v and each row's sum of
//     squares over the tile's columns.
//  5. nv_f32_normalize: a block a video, the row norms and the global
//     norm from those sums, then each element (v / n_k) / g in place
//     (the global sum of squares as sum_k ss_k / n_k^2, not from the
//     rounded quotients: a difference in the last bits). The norms stay
//     in shared memory up to K = 512 and above it in the video's a_sum
//     row, which launch 4 has finished with.
// The two products run two blocks an SM (128 registers a thread, a few
// spills): 4.11-4.14 ms for the call against 4.33 with one block an SM
// (an H100 at 700 W, the same call).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "f32_product.cuh"
#include "hopper_gemm.cuh"
#include "input_affine.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kDeqScale = static_cast<float>(4.0 / 255.0);
constexpr float kDeqBias = static_cast<float>(4.0 / 512.0 - 2.0);
constexpr float kNormEps = 1e-6f;

constexpr int kMaxClusters = 512;  // K one assignment block holds (launch 1); wider K: 1a + 1b
constexpr int kChunk = 64;                   // frames a chunk (a warpgroup's m64; a step of launch 2)
constexpr int kCols = 128;                   // columns of a launch-2 tile; D a multiple of it
constexpr int kB16Box = 64 * 64 * 2;         // [64][64] bf16: 8 KB
constexpr int kF32Box = kChunk * hgemm::kF32BoxCols * 4;  // [64 frames][32] f32: 8 KB

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

__device__ __forceinline__ int live_chunks(const int* num_frames, int b, int F) {
  return (live_frames(num_frames, b, F) + kChunk - 1) / kChunk;
}

// One step of a sum over rows: lanes `Bit` apart exchange halves of
// v[0, 2 Half), each keeping the sum of the half its lane bit selects in
// v[0, Half) (the fold of dbof.cu's max, constant trip counts).
template <int Half, int Bit>
__device__ __forceinline__ void fold_sum(float* v, int lane) {
  const bool upper = lane & Bit;
#pragma unroll
  for (int i = 0; i < Half; ++i) {
    const float keep = hgemm::select(upper, v[Half + i], v[i]);
    const float send = hgemm::select(upper, v[i], v[Half + i]);
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, Bit);
  }
}

// a / b rounded to nearest from rb = 1 / b, itself an IEEE division done
// once for every quotient by b: q = a rb, then one correction by the
// exact residual a - b q (an fma). With rb correctly rounded and q within
// an ulp of a / b, the result is the correctly rounded quotient
// (Markstein's theorem), away from overflow and underflow. Three
// instructions: IEEE divisions a value cost 0.18 ms of the store pass
// and 0.03 of the assignment at B=512 on an H100 (variants.py's
// ieee_div).
__device__ __forceinline__ float div_by(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

// ---------------------------------------------------------------------------
// Launch 0: the live chunks.
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 1024;

// items[0] = the number of live chunks; items[1 + i] = b * chunks + c for
// the i-th live chunk (c < ceil(n_b / 64)), videos in order.
__global__ void __launch_bounds__(kScanThreads)
nv_serve_scan(const int* __restrict__ num_frames, int* __restrict__ items, int B, int F,
              int chunks) {
  __shared__ int totals[32];
  __shared__ int carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int b0 = 0; b0 < B; b0 += kScanThreads) {
    const int b = b0 + tid;
    const int n = b < B ? live_chunks(num_frames, b, F) : 0;
    int v = n;  // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) totals[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = totals[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      totals[lane] = w;
    }
    __syncthreads();
    const int start = carry + (warp > 0 ? totals[warp - 1] : 0) + v - n;
    for (int c = 0; c < n; ++c) items[1 + start + c] = b * chunks + c;
    __syncthreads();
    if (tid == 0) carry += totals[31];
    __syncthreads();
  }
  if (tid == 0) items[0] = carry;
}

// ---------------------------------------------------------------------------
// Launch 1: the assignment.
// ---------------------------------------------------------------------------

// A consumer's share of a stage's x tile (64 frames x 64 features) in
// registers: f32 from two swizzled boxes [64][32] at src, or uint8 from
// an unswizzled box [64][64 bytes] through the plain version's dequant
// (multiply, then add, each rounded). Item idx is frame idx / 8, features
// 8 (idx % 8) ..; frames with first + f >= live are zeros and are not
// read.
template <typename T>
__device__ __forceinline__ void load_frames(const unsigned char* src, int idx, int first, int live,
                                            float (&v)[8]) {
  const int f = idx >> 3;
  const int c8 = idx & 7;
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = 0.0f;
  if (first + f >= live) return;
  if constexpr (std::is_same<T, float>::value) {
    const unsigned char* box = src + (c8 >> 2) * kF32Box;
    const int j = 2 * (c8 & 3);  // the box's 16-byte chunks j, j + 1
    const float4 lo = *reinterpret_cast<const float4*>(box + hgemm::swizzled(f, j));
    const float4 hi = *reinterpret_cast<const float4*>(box + hgemm::swizzled(f, j + 1));
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(src + f * 64 + c8 * 8);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = inaff::affine(static_cast<float>((q.x >> (8 * k)) & 0xffu), kDeqScale, kDeqBias);
      v[4 + k] = inaff::affine(static_cast<float>((q.y >> (8 * k)) & 0xffu), kDeqScale, kDeqBias);
    }
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(inaff::pack_bf16(v[0], v[1]), inaff::pack_bf16(v[2], v[3]),
                    inaff::pack_bf16(v[4], v[5]), inaff::pack_bf16(v[6], v[7]));
}

// The assignment launch's shared memory for frames T, W clusters a
// warpgroup (128 or 256), and Split (the two warpgroups share an item and
// split K <= 512) or not (an item a warpgroup, K <= W). A stage's x tile
// is rounded to bf16 in place (the K-major A layout, [64][64] bf16 over
// the tile's first 8 KB), so a stage holds max(x bytes, 8 KB) for each
// tile; as many stages as fit, up to 4.
template <typename T, int W, bool Split>
struct Asg {
  static constexpr int kXLoad = std::is_same<T, float>::value ? 2 * kF32Box : kChunk * 64;
  static constexpr int kXBytes = kXLoad > kB16Box ? kXLoad : kB16Box;
  static constexpr int kXTiles = Split ? 1 : 2;                // x tiles a stage
  static constexpr int kWBoxes = Split ? 2 * W / 64 : W / 64;  // Wc boxes a stage
  static constexpr int kStageBytes = kXTiles * kXBytes + kWBoxes * kB16Box;
  static constexpr int kColFloats = 2 * 4 * W;                      // [warpgroup][warp][W]
  static constexpr int kRowFloats = Split ? 2 * 2 * 2 * kChunk : 0;  // [parity][max, sum][wg][row]
  static constexpr int kVecFloats = 2 * kMaxClusters;               // act_scale, act_bias
  static constexpr int kFixed = (kColFloats + kRowFloats + kVecFloats) * 4 + 2 * 4 * 8;
  static constexpr int kFit = (232448 - hgemm::kAlign - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmemBytes = kStages * kStageBytes + kFixed;
  static constexpr int kSmem = hgemm::smem_request(kSmemBytes);
  static_assert(kStageBytes % hgemm::kAlign == 0, "stages 1024-byte aligned");
  static_assert(kStages >= 2 && kSmem <= 232448, "shared memory a block");
  static_assert(W == 128 || W == 256, "clusters a warpgroup");
};

// Logits (W = 256, not Split): tiles of (two live chunks, 256 clusters),
// the affine logits of the live rows into `logits` [B, F, K] f32 and
// nothing else (launch 1a of K > 512).
template <typename T, int W, bool Split, bool Logits = false>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
nv_serve_assign(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                const int* __restrict__ items, const int* __restrict__ num_frames,
                const float* __restrict__ act_scale, const float* __restrict__ act_bias,
                bf16* __restrict__ xb, bf16* __restrict__ assign, float* __restrict__ colsum,
                float* __restrict__ logits, int F, int D, int K, int chunks) {
  static_assert(!Logits || (W == 256 && !Split), "the logits tiles");
  using P = Asg<T, W, Split>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  float* colred = reinterpret_cast<float*>(smem + P::kStages * P::kStageBytes);
  float* rowred = colred + P::kColFloats;
  float* s_scale = rowred + P::kRowFloats;
  float* s_bias = s_scale + kMaxClusters;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_bias + kMaxClusters);
  uint64_t* empty = full + P::kStages;

  const int count = items[0];
  const int n_kt = Logits ? (K + W - 1) / W : 1;  // cluster tiles, the fastest
  const int tiles = (Split ? count : (count + 1) / 2) * n_kt;
  const int nk = D / hgemm::kDepth;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      hgemm::bar_init(&full[s], 1);
      hgemm::bar_init(&empty[s], hgemm::kConsumerWarps);
    }
    hgemm::bar_init_fence();
  }
  if (!Logits) {
    for (int k = threadIdx.x; k < K; k += hgemm::kThreads) {
      s_scale[k] = act_scale[k];
      s_bias[k] = act_bias[k];
    }
  }
  __syncthreads();

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* xmap = &map_x;
  const CUtensorMap* wmap = &map_w;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int kt = t % n_kt;
        int vb[P::kXTiles], vf[P::kXTiles];
        uint32_t bytes = P::kWBoxes * kB16Box;
#pragma unroll
        for (int w2 = 0; w2 < P::kXTiles; ++w2) {
          const int i = P::kXTiles * (t / n_kt) + w2;
          vb[w2] = -1;
          vf[w2] = 0;
          if (i < count) {
            const int id = items[1 + i];
            vb[w2] = id / chunks;
            vf[w2] = (id - vb[w2] * chunks) * kChunk;
            bytes += P::kXLoad;
          }
        }
        hgemm::produce<P::kStages>(
            full, empty, ring, nk, bytes, [&](int s, uint64_t* bar, int ks) {
              unsigned char* st = smem + s * P::kStageBytes;
#pragma unroll
              for (int w2 = 0; w2 < P::kXTiles; ++w2) {
                if (vb[w2] < 0) continue;
                unsigned char* xs = st + w2 * P::kXBytes;
                hgemm::tma_3d(xs, xmap, bar, ks * hgemm::kDepth, vf[w2], vb[w2]);
                if constexpr (std::is_same<T, float>::value)
                  hgemm::tma_3d(xs + kF32Box, xmap, bar, ks * hgemm::kDepth + hgemm::kF32BoxCols,
                                vf[w2], vb[w2]);
              }
#pragma unroll
              for (int i = 0; i < P::kWBoxes; ++i)
                hgemm::tma_2d(st + P::kXTiles * P::kXBytes + i * kB16Box, wmap, bar,
                              kt * W + i * hgemm::kBoxCols, ks * hgemm::kDepth);
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
    // Split: both warpgroups round the shared tile (barrier 3 over 256
    // threads); else each its own (barrier 1 + wg).
    constexpr int kPrepThreads = Split ? 256 : 128;
    constexpr int kItems = 512 / kPrepThreads;  // 16-byte chunks of the bf16 tile a thread
    const int prep_bar = Split ? 3 : 1 + wg;
    const int prep_t = Split ? static_cast<int>(threadIdx.x) : t128;
    const int col0 = Split ? W * wg : 0;  // the warpgroup's first cluster
    float acc[W / 2];
    int iter = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++iter) {
      const int kt = t % n_kt;
      const int i = Split ? t : 2 * (t / n_kt) + wg;
      const bool have = i < count;
      int b = 0, c = 0, live = 0;
      if (have) {
        const int id = items[1 + i];
        b = id / chunks;
        c = id - b * chunks;
        live = live_frames(num_frames, b, F);
      }
      const int f0 = c * kChunk;
      hgemm::zero<W / 2>(acc);
      hgemm::consume_prepared<P::kStages, W / 2>(
          full, empty, ring, nk, acc,
          [&](int s, int ks) {
            // Round the tile in place: every read before any write, then
            // bf16 into the A layout and, for the rows inside F, to xb
            // (16 bytes a thread, eight threads a 128-byte row).
            unsigned char* xs = smem + s * P::kStageBytes + (Split ? 0 : wg * P::kXBytes);
            float v[kItems][8];
#pragma unroll
            for (int it = 0; it < kItems; ++it)
              load_frames<T>(xs, prep_t + kPrepThreads * it, f0, live, v[it]);
            hgemm::named_sync(prep_bar, kPrepThreads);
#pragma unroll
            for (int it = 0; it < kItems; ++it) {
              const int idx = prep_t + kPrepThreads * it;
              const int f = idx >> 3;
              const int c8 = idx & 7;
              const uint4 o = pack8(v[it]);
              *reinterpret_cast<uint4*>(xs + hgemm::swizzled(f, c8)) = o;
              if (have && f0 + f < F && kt == 0)
                *reinterpret_cast<uint4*>(xb + (static_cast<size_t>(b) * F + f0 + f) * D +
                                          ks * hgemm::kDepth + 8 * c8) = o;
            }
            hgemm::fence_async_smem();
            hgemm::named_sync(prep_bar, kPrepThreads);
          },
          [&](int s, int) {
            const uint32_t st = hgemm::smem_u32(smem + s * P::kStageBytes);
            const uint32_t aa = st + (Split ? 0 : wg * P::kXBytes);
            const uint32_t ww =
                st + P::kXTiles * P::kXBytes + (Split ? wg * (W / 64) * kB16Box : 0);
#pragma unroll
            for (int kk = 0; kk < hgemm::kDepth / 16; ++kk) hgemm::chain<W>(acc, aa, ww, kk);
          });

      // Epilogue. Thread rows ff = 16 warp + r + 8 h of the chunk;
      // clusters col0 + 8 j + 2 q + e in acc[4 j + 2 h + e].
      bool lv[2];
      int f[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        f[h] = f0 + 16 * warp + r + 8 * h;
        lv[h] = f[h] < live;
      }
      if constexpr (Logits) {
        // The affine (multiply, then add, each rounded) of the live rows,
        // clusters kt W + 8 j + 2 q + e.
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          const int k = kt * W + 8 * j + 2 * q;  // k + 1 < K with k: K % 8 == 0
          const int kc = min(k, K - 2);
          const float2 sc = __ldg(reinterpret_cast<const float2*>(act_scale + kc));
          const float2 bi = __ldg(reinterpret_cast<const float2*>(act_bias + kc));
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (have && lv[h] && k < K)
              *reinterpret_cast<float2*>(logits + (static_cast<size_t>(b) * F + f[h]) * K + k) =
                  make_float2(__fadd_rn(__fmul_rn(acc[4 * j + 2 * h], sc.x), bi.x),
                              __fadd_rn(__fmul_rn(acc[4 * j + 2 * h + 1], sc.y), bi.y));
        }
        continue;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = col0 + 8 * j + 2 * q + e;
          const int kc = min(k, K - 1);
          const float sc = s_scale[kc];
          const float bi = s_bias[kc];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float a = __fadd_rn(__fmul_rn(acc[4 * j + 2 * h + e], sc), bi);
            acc[4 * j + 2 * h + e] = a;
            mx[h] = k < K ? fmaxf(mx[h], a) : mx[h];
          }
        }
      float* rd = rowred + (iter & 1) * 2 * 2 * kChunk;
      // Split: a row's two halves meet in shared memory (quantity w).
      auto across = [&](float (&v)[2], int w, bool is_max) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = is_max ? quad_max(v[h]) : quad_sum(v[h]);
          if (Split && q == 0) rd[(w * 2 + wg) * kChunk + 16 * warp + r + 8 * h] = v[h];
        }
        if constexpr (Split) {
          hgemm::named_sync(4, 256);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float o = rd[(w * 2 + (wg ^ 1)) * kChunk + 16 * warp + r + 8 * h];
            v[h] = is_max ? fmaxf(v[h], o) : v[h] + o;
          }
        }
      };
      across(mx, 0, true);
      float sm[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int a = 4 * j + 2 * h + e;
            const float ex = col0 + 8 * j + 2 * q + e < K ? expf(__fsub_rn(acc[a], mx[h])) : 0.0f;
            acc[a] = ex;
            sm[h] += ex;
          }
      across(sm, 1, false);
      // assign = exp / sum (correctly rounded, as the plain version's
      // division), 0 past n; bf16(assign) for the rows of the chunk inside
      // F.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* dst = assign + (static_cast<size_t>(b) * F + min(f[h], F - 1)) * K;
        const float rs = 1.0f / sm[h];
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          const int k = col0 + 8 * j + 2 * q;
          const float p0 = lv[h] ? div_by(acc[4 * j + 2 * h], sm[h], rs) : 0.0f;
          const float p1 = lv[h] ? div_by(acc[4 * j + 2 * h + 1], sm[h], rs) : 0.0f;
          acc[4 * j + 2 * h] = p0;
          acc[4 * j + 2 * h + 1] = p1;
          if (have && f[h] < F && k < K)
            *reinterpret_cast<__nv_bfloat162*>(dst + k) = __floats2bfloat162_rn(p0, p1);
        }
      }
      // The chunk's column sums of the unrounded assignment: the thread's
      // two rows, the warp's 16 (lane l ends with clusters col0 + 8 (r
      // W / 64 + t) + 2q + e in v[2t + e], t < W / 64), then the four
      // warps in shared memory.
      float v[W / 4];
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) v[2 * j + e] = acc[4 * j + e] + acc[4 * j + 2 + e];
      fold_sum<W / 8, 16>(v, lane);
      fold_sum<W / 16, 8>(v, lane);
      fold_sum<W / 32, 4>(v, lane);
      float* cr = colred + wg * 4 * W;
#pragma unroll
      for (int t4 = 0; t4 < W / 64; ++t4)
        *reinterpret_cast<float2*>(cr + warp * W + 8 * (r * (W / 64) + t4) + 2 * q) =
            make_float2(v[2 * t4], v[2 * t4 + 1]);
      hgemm::named_sync(1 + wg, 128);
      if (have) {
#pragma unroll
        for (int m = 0; m < W / 128; ++m) {
          const int kl = t128 + 128 * m;
          const float total = ((cr[kl] + cr[W + kl]) + cr[2 * W + kl]) + cr[3 * W + kl];
          if (col0 + kl < K)
            colsum[(static_cast<size_t>(b) * chunks + c) * K + col0 + kl] = total;
        }
      }
      hgemm::named_sync(1 + wg, 128);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 1b: a_sum, the live chunks' column sums added in chunk order.
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads)
nv_serve_asum(const int* __restrict__ num_frames, const float* __restrict__ colsum,
              float* __restrict__ a_sum, int F, int K, int chunks) {
  const int b = blockIdx.x;
  const int nch = live_chunks(num_frames, b, F);
  const float* cs = colsum + static_cast<size_t>(b) * chunks * K;
  for (int k = threadIdx.x; k < K; k += kSumThreads) {
    float a = 0.0f;
    for (int c = 0; c < nch; ++c) a += cs[static_cast<size_t>(c) * K + k];
    a_sum[static_cast<size_t>(b) * K + k] = a;
  }
}

// ---------------------------------------------------------------------------
// Launch 1b (K > 512): the assignment of each live chunk from its logits.
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 256;

// A block a live chunk (grid-stride over the list): each live row's max
// and sum of exp over K (a warp a row), then a thread a cluster walks the
// chunk's rows inside F: assign = exp(l - max) / sum (correctly rounded)
// on rows t < n, 0 after; bf16(assign) to [B, F, K] and the unrounded
// column sum to colsum, as launch 1's epilogue writes them.
__global__ void __launch_bounds__(kWideThreads)
nv_serve_softmax_wide(const int* __restrict__ items, const int* __restrict__ num_frames,
                      const float* __restrict__ logits, bf16* __restrict__ assign,
                      float* __restrict__ colsum, int F, int K, int chunks) {
  __shared__ float s_max[kChunk];
  __shared__ float s_sum[kChunk];
  __shared__ float s_rcp[kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int count = items[0];
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const int id = items[1 + i];
    const int b = id / chunks;
    const int c = id - b * chunks;
    const int f0 = c * kChunk;
    const int rows = min(kChunk, live_frames(num_frames, b, F) - f0);  // live rows, > 0
    const int end = min(kChunk, F - f0);                                // rows inside F
    const float* lg = logits + (static_cast<size_t>(b) * F + f0) * K;
    for (int r = warp; r < rows; r += kWideThreads / 32) {
      const float* row = lg + static_cast<size_t>(r) * K;
      float m = -INFINITY;
      for (int k = lane; k < K; k += 32) m = fmaxf(m, row[k]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sm = 0.0f;
      for (int k = lane; k < K; k += 32) sm += expf(__fsub_rn(row[k], m));
      sm = warp_sum(sm);
      if (lane == 0) {
        s_max[r] = m;
        s_sum[r] = sm;
        s_rcp[r] = 1.0f / sm;
      }
    }
    __syncthreads();
    bf16* dst = assign + (static_cast<size_t>(b) * F + f0) * K;
    for (int k = threadIdx.x; k < K; k += kWideThreads) {
      float total = 0.0f;
      for (int r = 0; r < end; ++r) {
        const float p =
            r < rows ? div_by(expf(__fsub_rn(lg[static_cast<size_t>(r) * K + k], s_max[r])),
                              s_sum[r], s_rcp[r])
                     : 0.0f;
        dst[static_cast<size_t>(r) * K + k] = __float2bfloat16_rn(p);
        total += p;
      }
      colsum[(static_cast<size_t>(b) * chunks + c) * K + k] = total;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Launches 2 and 4: vlad = bf16(assign)^T @ xb - a_sum (x) centers, then
// its sums of squares (Store = false) or (v / n_k) / g (Store = true).
// ---------------------------------------------------------------------------

constexpr int kAggClusters = 256;  // a tile: two m64 blocks a consumer warpgroup
constexpr int kAggFrames = 32;     // frames a stage: [32][64] bf16 boxes of 4 KB
constexpr int kAggBox = kAggFrames * 128;
constexpr int kAggStages = 4;      // what the centers tile leaves of shared memory
constexpr int kAggStageBytes = (kAggClusters / 64 + kCols / 64) * kAggBox;  // 24 KB
constexpr int kCenBox = kAggClusters * hgemm::kF32BoxCols * 4;     // [256][32] f32: 32 KB
constexpr int kCenBytes = (kCols / hgemm::kF32BoxCols) * kCenBox;  // the tile's centers: 128 KB
constexpr int kAggSmem =
    hgemm::smem_request(kAggStages * kAggStageBytes + kCenBytes + (2 * kAggStages + 1) * 8);
static_assert(kAggSmem <= 232448, "shared memory a block");

// The aggregation's steps for video b: its live frames in steps of 32
// (rows from n to the step's end are zeros in both operands).
__device__ __forceinline__ int agg_steps(const int* num_frames, int b, int F) {
  return (live_frames(num_frames, b, F) + kAggFrames - 1) / kAggFrames;
}

// The walk: block j keeps combination j % C of (cluster tile kt, column
// tile ct), the column tile fastest, C = n_kt n_ct, and takes the videos
// j / C, j / C + P, ... with P blocks a combination. The combination's
// centers [256][128] stay in shared memory for the block's life.
__host__ __device__ inline int agg_blocks_per_combo(int B, int combos, int sms) {
  const int p = sms / combos;
  return p < 1 ? 1 : (p < B ? p : B);
}

template <bool Store>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
nv_serve_aggregate(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_xb,
                   const __grid_constant__ CUtensorMap map_c, const int* __restrict__ num_frames,
                   const float* __restrict__ a_sum, float* __restrict__ sumsq,
                   const float* __restrict__ norms, const float* __restrict__ gnorm,
                   float* __restrict__ out, int B, int F, int D, int K, int per_combo) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  unsigned char* cen = smem + kAggStages * kAggStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(cen + kCenBytes);
  uint64_t* empty = full + kAggStages;
  uint64_t* cbar = empty + kAggStages;

  const int n_ct = D / kCols;
  const int combos = ((K + kAggClusters - 1) / kAggClusters) * n_ct;
  const int combo = blockIdx.x % combos;
  const int kt = combo / n_ct;
  const int ct = combo % n_ct;
  const int first = blockIdx.x / combos;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kAggStages; ++s) {
      hgemm::bar_init(&full[s], 1);
      hgemm::bar_init(&empty[s], hgemm::kConsumerWarps);
    }
    hgemm::bar_init(cbar, 1);
    hgemm::bar_init_fence();
  }
  __syncthreads();

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* amap = &map_a;
  const CUtensorMap* xmap = &map_xb;
  const CUtensorMap* cmap = &map_c;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      hgemm::bar_expect(cbar, kCenBytes);
#pragma unroll
      for (int i = 0; i < kCols / hgemm::kF32BoxCols; ++i)
        hgemm::tma_3d(cen + i * kCenBox, cmap, cbar, ct * kCols + hgemm::kF32BoxCols * i,
                      kt * kAggClusters, 0);
      // Each video's step count is read a video ahead.
      int nst = first < B ? agg_steps(num_frames, first, F) : 0;
      for (int b = first; b < B; b += per_combo) {
        const int nst_next = b + per_combo < B ? agg_steps(num_frames, b + per_combo, F) : 0;
        hgemm::produce<kAggStages>(
            full, empty, ring, nst, kAggStageBytes,
            [&](int s, uint64_t* bar, int ks) {
              unsigned char* st = smem + s * kAggStageBytes;
#pragma unroll
              for (int i = 0; i < kAggClusters / 64; ++i)
                hgemm::tma_3d(st + i * kAggBox, amap, bar, kt * kAggClusters + 64 * i,
                              ks * kAggFrames, b);
#pragma unroll
              for (int i = 0; i < kCols / 64; ++i)
                hgemm::tma_3d(st + (kAggClusters / 64 + i) * kAggBox, xmap, bar,
                              ct * kCols + 64 * i, ks * kAggFrames, b);
            });
        nst = nst_next;
      }
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int r = lane >> 2;
    hgemm::bar_wait(cbar, 0);
    float acc[128];  // two m64n128 blocks: clusters 128 wg + 64 i + ..., acc[64 i + ...]
    int nst = first < B ? agg_steps(num_frames, first, F) : 0;
    for (int b = first; b < B; b += per_combo) {
      const int nst_next = b + per_combo < B ? agg_steps(num_frames, b + per_combo, F) : 0;
      // The thread's rows k = kt 256 + 128 wg + 64 i + 16 warp + r + 8 h
      // (clamped to K - 1 for the loads) and their a_sum, loaded before
      // the mainloop and first used after it.
      int kc[2][2];
      float as[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          kc[i][h] = min(kt * kAggClusters + 128 * wg + 64 * i + 16 * warp + r + 8 * h, K - 1);
          as[i][h] = __ldg(a_sum + static_cast<size_t>(b) * K + kc[i][h]);
        }
      hgemm::zero<128>(acc);
      hgemm::consume<kAggStages, 128>(full, empty, ring, nst, acc, [&](int s) {
        const uint32_t st = hgemm::smem_u32(smem + s * kAggStageBytes);
        const uint32_t xs = st + (kAggClusters / 64) * kAggBox;
#pragma unroll
        for (int kk = 0; kk < kAggFrames / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            // B MN-major over two [32][64] boxes: the next 64 columns one
            // box (LBO) on; a 16-deep step moves the start 2 KB.
            hgemm::mma<128, 1, 1>(acc + 64 * i, hgemm::desc_a_mn(st + (2 * wg + i) * kAggBox, kk),
                                  hgemm::desc(xs + kk * 2048, kAggBox, 1024));
      });
      // Epilogue: v[k, d] = acc - a_sum[k] * centers[k, d] (multiply and
      // subtract each rounded, as the plain version), the centers from
      // the tile in shared memory (swizzled [256][32] boxes: the 8 rows of
      // a quarter-warp's float2 reads fall in distinct banks). Only the
      // stores are masked.
      const float gn = Store ? __ldg(gnorm + b) : 1.0f;
      const float rg = 1.0f / gn;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kl = 128 * wg + 64 * i + 16 * warp + r + 8 * h;  // row of the tile
          const int k = kt * kAggClusters + kl;
          const float nrm = Store ? __ldg(norms + static_cast<size_t>(b) * K + kc[i][h]) : 1.0f;
          const float rn = 1.0f / nrm;
          float* dst = out + (static_cast<size_t>(b) * K + k) * D + ct * kCols + 2 * q;
          float ss = 0.0f;
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j) {
            // Columns 8j + 2q, +1: box j / 4, 16-byte chunk 2 (j % 4) + q / 2.
            const float2 cc = *reinterpret_cast<const float2*>(
                cen + (j / 4) * kCenBox + hgemm::swizzled(kl, 2 * (j % 4) + q / 2) + (q & 1) * 8);
            const int a = 64 * i + 4 * j + 2 * h;
            const float v0 = __fsub_rn(acc[a], __fmul_rn(as[i][h], cc.x));
            const float v1 = __fsub_rn(acc[a + 1], __fmul_rn(as[i][h], cc.y));
            if constexpr (Store) {
              if (k < K)
                *reinterpret_cast<float2*>(dst + 8 * j) =
                    make_float2(div_by(div_by(v0, nrm, rn), gn, rg),
                                div_by(div_by(v1, nrm, rn), gn, rg));
            } else {
              ss += v0 * v0;
              ss += v1 * v1;
            }
          }
          if constexpr (!Store) {
            ss = quad_sum(ss);
            if (q == 0 && k < K) sumsq[(static_cast<size_t>(b) * n_ct + ct) * K + k] = ss;
          }
        }
      }
      nst = nst_next;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 3: the norms of a video.
// ---------------------------------------------------------------------------

constexpr int kNormThreads = 256;

// norms[b, k] = max(||vlad_k||, 1e-6) from the column tiles' sums of
// squares (summed in tile order); gnorm[b] = max(sqrt(sum_k ss_k / n_k^2),
// 1e-6), the norm of the intra-normalised rows.
__global__ void __launch_bounds__(kNormThreads)
nv_serve_norms(const float* __restrict__ sumsq, float* __restrict__ norms, float* __restrict__ gnorm,
               int K, int n_ct) {
  __shared__ float part[kNormThreads / 32];
  const int b = blockIdx.x;
  const float* sq = sumsq + static_cast<size_t>(b) * n_ct * K;
  float g = 0.0f;
  for (int k = threadIdx.x; k < K; k += kNormThreads) {
    float ss = 0.0f;
    for (int t = 0; t < n_ct; ++t) ss += sq[static_cast<size_t>(t) * K + k];
    const float n = fmaxf(sqrtf(ss), kNormEps);
    norms[static_cast<size_t>(b) * K + k] = n;
    g += ss / (n * n);
  }
  g = warp_sum(g);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = g;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kNormThreads / 32; ++w) total += part[w];
    gnorm[b] = fmaxf(sqrtf(total), kNormEps);
  }
}

// ---------------------------------------------------------------------------
// Host.
// ---------------------------------------------------------------------------

template <typename T, int W, bool Split, bool Logits = false>
cudaError_t launch_assign(const CUtensorMap& map_x, const CUtensorMap& map_w, const int* items,
                          const int* num_frames, const float* act_scale, const float* act_bias,
                          bf16* xb, bf16* assign, float* colsum, float* logits, int B, int F,
                          int D, int K, int chunks, int sms, cudaStream_t st) {
  using P = Asg<T, W, Split>;
  cudaError_t err = cudaFuncSetAttribute(nv_serve_assign<T, W, Split, Logits>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  // The live chunks are counted on the card: the grid covers the most
  // there can be, and a block past the count finds no tile.
  const long long most = (Split ? static_cast<long long>(B) * chunks
                                : (static_cast<long long>(B) * chunks + 1) / 2) *
                         (Logits ? (K + W - 1) / W : 1);
  const int grid = most < sms ? static_cast<int>(most) : sms;
  nv_serve_assign<T, W, Split, Logits><<<grid, hgemm::kThreads, P::kSmem, st>>>(
      map_x, map_w, items, num_frames, act_scale, act_bias, xb, assign, colsum, logits, F, D, K,
      chunks);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* num_frames, const void* wc, const void* act_scale,
           const void* act_bias, const void* centers, void* xb, void* assign, void* colsum,
           void* items, void* work, void* logits, void* out, int B, int F, int D, int K,
           void* stream) {
  if (B <= 0 || F <= 0 || D <= 0 || D % kCols != 0 || K < 8 || K % 8 != 0 ||
      (K > kMaxClusters && logits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (F + kChunk - 1) / kChunk;
  if (static_cast<long long>(B) * chunks * ((K + 255) / 256) >= (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ct = D / kCols;
  float* sumsq = static_cast<float*>(work);                     // [B, D / 128, K]
  float* norms = sumsq + static_cast<size_t>(B) * n_ct * K;     // [B, K]
  float* a_sum = norms + static_cast<size_t>(B) * K;            // [B, K]
  float* gnorm = a_sum + static_cast<size_t>(B) * K;            // [B]
  const int* nf = static_cast<const int*>(num_frames);
  int* it = static_cast<int*>(items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  nv_serve_scan<<<1, kScanThreads, 0, st>>>(nf, it, B, F, chunks);
  err = cudaGetLastError();
  CUtensorMap map_x, map_w, map_xb, map_a;
  if (err == cudaSuccess) {
    if constexpr (std::is_same<T, float>::value)
      err = hgemm::make_map_f32(&map_x, x, B, F, D, kChunk);
    else
      err = hgemm::make_map_u8(&map_x, x, B, F, D, D, kChunk, hgemm::kDepth,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) err = hgemm::make_map_2d(&map_w, wc, D, K, K, hgemm::kDepth);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_xb, xb, B, F, D, D, kAggFrames);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_a, assign, B, F, K, K, kAggFrames);
  int sms = 0;
  if (err == cudaSuccess) err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* scale = static_cast<const float*>(act_scale);
  const float* bias = static_cast<const float*>(act_bias);
  bf16* asg = static_cast<bf16*>(assign);
  bf16* x16 = static_cast<bf16*>(xb);
  float* cs = static_cast<float*>(colsum);
  float* lg = static_cast<float*>(logits);
  if (K <= 128) {
    err = launch_assign<T, 128, false>(map_x, map_w, it, nf, scale, bias, x16, asg, cs, lg, B, F,
                                       D, K, chunks, sms, st);
  } else if (K <= 256) {
    err = launch_assign<T, 256, false>(map_x, map_w, it, nf, scale, bias, x16, asg, cs, lg, B, F,
                                       D, K, chunks, sms, st);
  } else if (K <= kMaxClusters) {
    err = launch_assign<T, 256, true>(map_x, map_w, it, nf, scale, bias, x16, asg, cs, lg, B, F,
                                      D, K, chunks, sms, st);
  } else {
    err = launch_assign<T, 256, false, true>(map_x, map_w, it, nf, scale, bias, x16, asg, cs, lg,
                                             B, F, D, K, chunks, sms, st);
    if (err == cudaSuccess) {
      const long long most = static_cast<long long>(B) * chunks;
      nv_serve_softmax_wide<<<static_cast<unsigned>(most < 65535 ? most : 65535), kWideThreads, 0,
                              st>>>(it, nf, lg, asg, cs, F, K, chunks);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  nv_serve_asum<<<B, kSumThreads, 0, st>>>(nf, cs, a_sum, F, K, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int combos = ((K + kAggClusters - 1) / kAggClusters) * n_ct;
  const int per_combo = agg_blocks_per_combo(B, combos, sms);
  const int grid = per_combo * combos;
  CUtensorMap map_c;
  err = hgemm::make_map_f32(&map_c, centers, 1, K, D, kAggClusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* o = static_cast<float*>(out);
  err = cudaFuncSetAttribute(nv_serve_aggregate<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kAggSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nv_serve_aggregate<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kAggSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nv_serve_aggregate<false><<<grid, hgemm::kThreads, kAggSmem, st>>>(
      map_a, map_xb, map_c, nf, a_sum, sumsq, norms, gnorm, o, B, F, D, K, per_combo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nv_serve_norms<<<B, kNormThreads, 0, st>>>(sumsq, norms, gnorm, K, n_ct);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nv_serve_aggregate<true><<<grid, hgemm::kThreads, kAggSmem, st>>>(
      map_a, map_xb, map_c, nf, a_sum, sumsq, norms, gnorm, o, B, F, D, K, per_combo);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The f32 route.
// ---------------------------------------------------------------------------

template <typename T, bool Vec>
struct F32Rows;
template <bool Vec>
struct F32Rows<uint8_t, Vec> {
  using Load = f32p::BytesA<Vec, f32p::ConstAffine>;
};
template <bool Vec>
struct F32Rows<float, Vec> {
  using Load = f32p::RowsA<Vec, f32p::Same>;
};

template <typename T, bool Vec>
__device__ __forceinline__ void set_elem(typename F32Rows<T, Vec>::Load& l) {
  if constexpr (std::is_same<T, uint8_t>::value) l.f = f32p::ConstAffine{kDeqScale, kDeqBias};
}

// Launch 1. Block (i, j): live chunks 2 i and 2 i + 1 of the list (rows
// 0..63 and 64..127 of the tile) x clusters 128 j ..; act [B, F, K].
// VecX: D allows the operand's vector loads; VecK: K % 4 == 0 (cp.async
// of Wc, float4 stores of act).
template <typename T, bool VecX, bool VecK>
__global__ void __launch_bounds__(f32p::kThreads, 2)
nv_f32_assign(const T* __restrict__ x, const int* __restrict__ items,
              const float* __restrict__ wc, const float* __restrict__ act_scale,
              const float* __restrict__ act_bias, float* __restrict__ act, int F, int D, int K,
              int chunks) {
  extern __shared__ __align__(16) float fsmem[];
  const int count = items[0];
  const int i0 = 2 * blockIdx.x;
  if (i0 >= count) return;
  const int k0 = blockIdx.y * f32p::kCols;
  const int r = threadIdx.x & (f32p::kRows - 1);
  const int it = i0 + r / kChunk < count ? items[1 + i0 + r / kChunk] : -1;
  const int t = it < 0 ? F : (it % chunks) * kChunk + r % kChunk;
  typename F32Rows<T, VecX>::Load la;
  la.row = t < F ? x + (static_cast<size_t>(it / chunks) * F + t) * D : nullptr;
  la.depth = D;
  set_elem<T, VecX>(la);
  f32p::PanelB<VecK> lb;
  lb.base = wc;
  lb.depth = D;
  lb.cols = K;
  lb.ld = K;
  lb.n0 = k0;
  float acc[8][8];
  f32p::product(la, lb, D, fsmem, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = f32p::row_of(i);
    const int item = i0 + row / kChunk;
    if (item >= count) continue;
    const int id = items[1 + item];
    const int tt = (id % chunks) * kChunk + row % kChunk;
    if (tt >= F) continue;
    float* dst = act + (static_cast<size_t>(id / chunks) * F + tt) * K;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + f32p::col_of(4 * h);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = k + e < K ? __fadd_rn(__fmul_rn(acc[i][4 * h + e], __ldg(act_scale + k + e)),
                                     __ldg(act_bias + k + e))
                         : 0.0f;
      if (VecK) {
        if (k < K) *reinterpret_cast<float4*>(dst + k) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < K) dst[k + e] = v[e];
      }
    }
  }
}

// Launch 2: a warp a row (b, t) of act, t < n: the softmax over K in
// place.
__global__ void __launch_bounds__(256)
nv_f32_softmax(const int* __restrict__ num_frames, float* __restrict__ act, int B, int F, int K) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(B) * F) return;
  const int b = static_cast<int>(row / F);
  const int t = static_cast<int>(row % F);
  if (t >= live_frames(num_frames, b, F)) return;
  const int lane = threadIdx.x & 31;
  float* a = act + row * K;
  float m = -INFINITY;
  for (int k = lane; k < K; k += 32) m = fmaxf(m, a[k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const float e = expf(a[k] - m);
    a[k] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int k = lane; k < K; k += 32) a[k] = a[k] / sum;
}

// Launch 3: a_sum [B, K] over each video's rows t < n.
__global__ void __launch_bounds__(256)
nv_f32_asum(const int* __restrict__ num_frames, const float* __restrict__ assign,
            float* __restrict__ a_sum, int B, int F, int K) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * K) return;
  const int b = static_cast<int>(i / K);
  const int k = static_cast<int>(i % K);
  const int n = live_frames(num_frames, b, F);
  const float* a = assign + static_cast<size_t>(b) * F * K + k;
  float s = 0.0f;
  for (int t = 0; t < n; ++t) s += a[static_cast<size_t>(t) * K];
  a_sum[i] = s;
}

// The uint8 frames as the B panel: rows t of [depth = n][D] bytes,
// columns n0 .. n0 + 127, dequantized as they are stored; thread t takes
// 16 bytes of panel row t / 8 (one 16-byte load when Vec: D % 16 == 0).
template <bool Vec>
struct BytesPanel {
  const uint8_t* base;
  int depth, cols, n0;
  uint32_t w[4];
  int d_row;

  __device__ __forceinline__ void fetch(int d0, float*) {
    const int rr = threadIdx.x >> 3;
    const int c = n0 + (threadIdx.x & 7) * 16;
    d_row = d0 + rr;
    const uint8_t* p = base + static_cast<size_t>(d_row) * cols;
    const bool row_ok = d_row < depth;
    if (Vec) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (row_ok && c < cols) q = __ldg(reinterpret_cast<const uint4*>(p + c));
      w[0] = q.x;
      w[1] = q.y;
      w[2] = q.z;
      w[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = c + 4 * i + e;
          if (row_ok && cc < cols) word |= static_cast<uint32_t>(__ldg(p + cc)) << (8 * e);
        }
        w[i] = word;
      }
    }
  }

  __device__ __forceinline__ void store(float* panel) {
    const int rr = threadIdx.x >> 3;
    const int cl = (threadIdx.x & 7) * 16;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float u = static_cast<float>((w[e >> 2] >> (8 * (e & 3))) & 0xffu);
      panel[rr * f32p::kCols + cl + e] = d_row < depth && n0 + cl + e < cols
                                             ? __fadd_rn(__fmul_rn(u, kDeqScale), kDeqBias)
                                             : 0.0f;
    }
  }
};

template <typename T, bool VecX>
struct FramePanel;
template <bool VecX>
struct FramePanel<uint8_t, VecX> {
  using Load = BytesPanel<VecX>;
};
template <bool VecX>
struct FramePanel<float, VecX> {
  using Load = f32p::PanelB<VecX>;
};

// Launch 4. Block: video b, clusters 128 kt .., columns 128 dt .. (the
// column tile fastest, then the cluster tile); out [B, K, D] gets v,
// sumsq [B, ceil(D / 128), K] each row's sum of squares over the tile.
template <typename T, bool VecX, bool VecK>
__global__ void __launch_bounds__(f32p::kThreads, 2)
nv_f32_aggregate(const T* __restrict__ x, const int* __restrict__ num_frames,
                 const float* __restrict__ assign, const float* __restrict__ a_sum,
                 const float* __restrict__ centers, float* __restrict__ out,
                 float* __restrict__ sumsq, int F, int D, int K) {
  extern __shared__ __align__(16) float fsmem[];
  const int n_dt = (D + f32p::kCols - 1) / f32p::kCols;
  const int n_kt = (K + f32p::kRows - 1) / f32p::kRows;
  const int dt = blockIdx.x % n_dt;
  const int kt = (blockIdx.x / n_dt) % n_kt;
  const int b = blockIdx.x / (n_dt * n_kt);
  const int d0 = dt * f32p::kCols;
  const int k0 = kt * f32p::kRows;
  const int n = live_frames(num_frames, b, F);
  f32p::PanelB<VecK> la;  // assign^T: the rows t of [n][K] as they lie
  la.base = assign + static_cast<size_t>(b) * F * K;
  la.depth = n;
  la.cols = K;
  la.ld = K;
  la.n0 = k0;
  typename FramePanel<T, VecX>::Load lb;
  lb.base = x + static_cast<size_t>(b) * F * D;
  lb.depth = n;
  lb.cols = D;
  if constexpr (std::is_same<T, float>::value) lb.ld = D;
  lb.n0 = d0;
  float acc[8][8];
  f32p::product(la, lb, n, fsmem, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + f32p::row_of(i);
    const bool row_ok = k < K;
    const float as = row_ok ? a_sum[static_cast<size_t>(b) * K + k] : 0.0f;
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + f32p::col_of(j);
      if (row_ok && d < D) {
        const float v =
            __fsub_rn(acc[i][j], __fmul_rn(as, centers[static_cast<size_t>(k) * D + d]));
        out[(static_cast<size_t>(b) * K + k) * D + d] = v;
        ss += __fmul_rn(v, v);
      }
    }
    // The row's 16 threads are lanes tx of one half-warp.
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((threadIdx.x & 15) == 0 && row_ok)
      sumsq[(static_cast<size_t>(b) * n_dt + dt) * K + k] = ss;
  }
}

// Launch 5: a block a video: n_k = sqrt(max(sum_d v^2, eps^2)), g =
// sqrt(max(sum_k sum_d (v / n_k)^2, eps^2)) from the rows' sums, then
// out = (v / n_k) / g in place.
__global__ void __launch_bounds__(256)
nv_f32_normalize(const float* __restrict__ sumsq, float* a_sum, float* __restrict__ out, int D,
                 int K) {
  __shared__ float s_norms[kMaxClusters];
  __shared__ float part[8];
  const int b = blockIdx.x;
  // Above 512 clusters the norms go to the video's a_sum row (launch 4 is
  // done with it); __syncthreads orders the block's writes and reads.
  float* norms = K <= kMaxClusters ? s_norms : a_sum + static_cast<size_t>(b) * K;
  const int n_dt = (D + f32p::kCols - 1) / f32p::kCols;
  float g = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float ss = 0.0f;
    for (int dt = 0; dt < n_dt; ++dt) ss += sumsq[(static_cast<size_t>(b) * n_dt + dt) * K + k];
    const float nk = sqrtf(fmaxf(ss, kNormEps * kNormEps));
    norms[k] = nk;
    g += ss / (nk * nk);
  }
  g = warp_sum(g);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = g;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < 8; ++w) total += part[w];
  const float gn = sqrtf(fmaxf(total, kNormEps * kNormEps));
  float* o = out + static_cast<size_t>(b) * K * D;
  const size_t n = static_cast<size_t>(K) * D;
  for (size_t e = threadIdx.x; e < n; e += blockDim.x) o[e] = (o[e] / norms[e / D]) / gn;
}

template <typename T, bool VecX, bool VecK>
cudaError_t launch_f32_products(const T* x, const int* nf, const int* items, const float* wc,
                                const float* scale, const float* bias, const float* centers,
                                float* act, float* a_sum, float* sumsq, float* out, int B, int F,
                                int D, int K, int chunks, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(nv_f32_assign<T, VecX, VecK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         f32p::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nv_f32_aggregate<T, VecX, VecK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, f32p::kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long pairs = (static_cast<long long>(B) * chunks + 1) / 2;
  const dim3 grid_a(static_cast<unsigned>(pairs), (K + f32p::kCols - 1) / f32p::kCols);
  nv_f32_assign<T, VecX, VecK><<<grid_a, f32p::kThreads, f32p::kSmemBytes, st>>>(
      x, items, wc, scale, bias, act, F, D, K, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(B) * F;
  nv_f32_softmax<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(nf, act, B, F, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long bk = static_cast<long long>(B) * K;
  nv_f32_asum<<<static_cast<unsigned>((bk + 255) / 256), 256, 0, st>>>(nf, act, a_sum, B, F, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(B) * ((K + f32p::kRows - 1) / f32p::kRows) *
                          ((D + f32p::kCols - 1) / f32p::kCols);
  nv_f32_aggregate<T, VecX, VecK><<<static_cast<unsigned>(tiles), f32p::kThreads,
                                    f32p::kSmemBytes, st>>>(x, nf, act, a_sum, centers, out,
                                                            sumsq, F, D, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nv_f32_normalize<<<B, 256, 0, st>>>(sumsq, a_sum, out, D, K);
  return cudaGetLastError();
}

template <typename T>
int launch_f32(const void* x, const void* num_frames, const void* wc, const void* act_scale,
               const void* act_bias, const void* centers, void* items, void* act, void* a_sum,
               void* sumsq, void* out, int B, int F, int D, int K, void* stream) {
  if (B <= 0 || F <= 0 || D <= 0 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (F + kChunk - 1) / kChunk;
  if (static_cast<long long>(B) * chunks >= (1LL << 31) - 1 ||
      static_cast<long long>(B) * K * (D > 1 ? D : 1) >= (1LL << 40) ||
      (K + f32p::kCols - 1) / f32p::kCols > 65535 ||
      static_cast<long long>(B) * F >= (1LL << 34) ||
      static_cast<long long>(B) * ((K + 127) / 128) * ((D + 127) / 128) >= (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* nf = static_cast<const int*>(num_frames);
  int* it = static_cast<int*>(items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nv_serve_scan<<<1, kScanThreads, 0, st>>>(nf, it, B, F, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_x = std::is_same<T, float>::value ? D % 4 == 0 : D % 16 == 0;
  const bool vec_k = K % 4 == 0;
  const T* xt = static_cast<const T*>(x);
  const float* w = static_cast<const float*>(wc);
  const float* sc = static_cast<const float*>(act_scale);
  const float* bi = static_cast<const float*>(act_bias);
  const float* cen = static_cast<const float*>(centers);
  float* ac = static_cast<float*>(act);
  float* as = static_cast<float*>(a_sum);
  float* ss = static_cast<float*>(sumsq);
  float* o = static_cast<float*>(out);
  if (vec_x)
    err = vec_k ? launch_f32_products<T, true, true>(xt, nf, it, w, sc, bi, cen, ac, as, ss, o, B,
                                                     F, D, K, chunks, st)
                : launch_f32_products<T, true, false>(xt, nf, it, w, sc, bi, cen, ac, as, ss, o,
                                                      B, F, D, K, chunks, st);
  else
    err = vec_k ? launch_f32_products<T, false, true>(xt, nf, it, w, sc, bi, cen, ac, as, ss, o,
                                                      B, F, D, K, chunks, st)
                : launch_f32_products<T, false, false>(xt, nf, it, w, sc, bi, cen, ac, as, ss, o,
                                                       B, F, D, K, chunks, st);
  return static_cast<int>(err);
}

}  // namespace

// Scratch from the caller: xb [B, F, D] bf16 and assign [B, F, K] bf16
// (written on the live chunks' rows), colsum [B, ceil(F/64), K] f32
// (the live chunks' column sums), items 1 + B ceil(F/64) int32, work
// B (D/128 + 2) K + B f32 and, for K > 512, logits [B, F, K] f32 (else
// null).
extern "C" int yt8m_netvlad_aggregate_u8(const void* x, const void* num_frames, const void* wc,
                                         const void* act_scale, const void* act_bias,
                                         const void* centers, void* xb, void* assign,
                                         void* colsum, void* items, void* work, void* logits,
                                         void* out, int B, int F, int D, int K, void* stream) {
  return launch<uint8_t>(x, num_frames, wc, act_scale, act_bias, centers, xb, assign, colsum,
                         items, work, logits, out, B, F, D, K, stream);
}

extern "C" int yt8m_netvlad_aggregate_f32(const void* x, const void* num_frames, const void* wc,
                                          const void* act_scale, const void* act_bias,
                                          const void* centers, void* xb, void* assign,
                                          void* colsum, void* items, void* work, void* logits,
                                          void* out, int B, int F, int D, int K, void* stream) {
  return launch<float>(x, num_frames, wc, act_scale, act_bias, centers, xb, assign, colsum,
                       items, work, logits, out, B, F, D, K, stream);
}

// The f32 route: x [B, F, D] uint8 or f32, wc [D, K] f32 (any K and D); items: 1 + B * ceil(F / 64) ints; act: B * F * K floats; a_sum: B *
// K floats; sumsq: B * ceil(D / 128) * K floats; out [B, K, D].
extern "C" int yt8m_netvlad_aggregate_f32w_u8(const void* x, const void* num_frames,
                                             const void* wc, const void* act_scale,
                                             const void* act_bias, const void* centers,
                                             void* items, void* act, void* a_sum, void* sumsq,
                                             void* out, int B, int F, int D, int K,
                                             void* stream) {
  return launch_f32<uint8_t>(x, num_frames, wc, act_scale, act_bias, centers, items, act, a_sum,
                             sumsq, out, B, F, D, K, stream);
}

extern "C" int yt8m_netvlad_aggregate_f32w_f32(const void* x, const void* num_frames,
                                              const void* wc, const void* act_scale,
                                              const void* act_bias, const void* centers,
                                              void* items, void* act, void* a_sum, void* sumsq,
                                              void* out, int B, int F, int D, int K,
                                              void* stream) {
  return launch_f32<float>(x, num_frames, wc, act_scale, act_bias, centers, items, act, a_sum,
                           sumsq, out, B, F, D, K, stream);
}

// The tiles: [frames a chunk, assignment stages, the assignment's shared
// bytes for (f32, 128 clusters a warpgroup), (f32, 256), (f32, split
// 512), (uint8, 128), (uint8, 256), (uint8, split 512), aggregation
// clusters a tile, columns a tile, stages, shared bytes, SMs].
extern "C" int yt8m_netvlad_plan(int* plan) {
  int sms = 0;
  const cudaError_t err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = kChunk;
  plan[1] = Asg<float, 256, false>::kStages;
  plan[2] = Asg<float, 128, false>::kSmem;
  plan[3] = Asg<float, 256, false>::kSmem;
  plan[4] = Asg<float, 256, true>::kSmem;
  plan[5] = Asg<uint8_t, 128, false>::kSmem;
  plan[6] = Asg<uint8_t, 256, false>::kSmem;
  plan[7] = Asg<uint8_t, 256, true>::kSmem;
  plan[8] = kAggClusters;
  plan[9] = kCols;
  plan[10] = kAggStages;
  plan[11] = kAggSmem;
  plan[12] = sms;
  return static_cast<int>(cudaSuccess);
}
