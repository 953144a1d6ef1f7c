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
// nothing rounded to bf16, as the TPU kernel computes it at dtype=float32,
// on the TF32 tensor cores as 3xTF32 products (hopper_gemm.cuh): each
// operand v split into big = tf32(v) and small = tf32(v - big), a product
// summed as a_small b_big + a_big b_small + a_big b_big, about 2^-21 of
// each product from the f32 product. At B=512, F=300, D=1152, K=256 over
// 80,819 live frames both products are 2 x 47.7 GFLOP: three TF32
// products each at 494.7 TFLOP/s take 0.58 ms, one f32 product each at
// the 67 TFLOP/s outside the tensor cores 1.42 ms. The same live chunks
// (launch 0), then:
//  1. nv_serve_assign's F32 instances: the bf16 launch's tiles, walk and
//     epilogue on a ring of 32-deep stages. A stage holds each
//     warpgroup's x tile [64 frames][32] (f32 by TMA straight into the
//     K-major A layout, or a raw uint8 tile [64][32 bytes] through the
//     plain version's dequant), which the consumers split into its two
//     tf32 halves (rows t >= n as zeros), and both halves of the rows of
//     Wc's split copy [2][K][D] (kernels/tf32.py :: split_weights, a
//     serving constant of the model: TF32's wgmma reads B K-major only).
//     hgemm::stage3 multiplies them, each stage summed in fresh
//     accumulators and the stages added on the FMA units (one chain of
//     wgmma sums over D rounds toward zero and drifts: PERF.md §6). Up to
//     K = 256 the softmax runs in the registers, as on the bf16 route,
//     and writes the assignment's tf32 halves cluster-major, [2][B][K][fp]
//     (fp: F rounded up to 4; zeros from n to the chunk's end), and the
//     chunks' column sums; above 256 (a stage of 512 clusters' halves
//     leaves room for no second stage) the Logits instance and
//     nv_serve_softmax_wide<float> do. nv_serve_asum adds the column sums
//     into a_sum.
//  2. nv_f32_aggregate: the bf16 route's tiles (video, 256 clusters, 128
//     columns) and walk, on stages of 32 frames: both halves of the
//     tile's clusters' rows of the split assignment ([256][32] f32 each,
//     K-major: TF32's wgmma reads shared memory K-major only) and the
//     frames' boxes, 80 KB, two stages (the centers stay in device
//     memory). The product contracts over frames, and the frames lie
//     depth-major, so each warpgroup computes v^T, its 64 columns x 256
//     clusters: A = x^T from registers (each thread loads its fragments
//     from the frames' boxes and splits them; frames t >= n as zeros), B
//     the assignment's halves, wgmma m64n64k8 in 3xTF32 over windows of 64
//     clusters, each stage summed in fresh registers and added on the FMA
//     units. The epilogue stores v = acc - a_sum * centers (each rounded)
//     and each cluster's sum of squares over the tile's columns.
//  3. nv_serve_norms, as on the bf16 route.
//  4. nv_f32_scale: each element (v / n_k) / g in place, a warp a row.
// One product pass and the scale (0.6 GB read and written at B=512) in
// place of the bf16 route's second product pass: at 3xTF32 the product is
// three times the bf16 route's work. (A first design ran the aggregation
// on mma.sync m16n8k8 with the threads' fragments of the assignment and
// the frames: 1.68 ms at B=512 with f32 frames on an H100 at 700 W,
// against 1.47 for the FMA kernel it replaced, in the same serving step.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  static constexpr int kWLoad = kWBoxes * kB16Box;  // Wc's bytes a stage
  static_assert(kStageBytes % hgemm::kAlign == 0, "stages 1024-byte aligned");
  static_assert(kStages >= 2 && kSmem <= 232448, "shared memory a block");
  static_assert(W == 128 || W == 256, "clusters a warpgroup");
};

constexpr int kF32Clusters = 256;  // K the f32 assignment's registers hold; wider: logits
constexpr int kU8Tile = kChunk * hgemm::kTf32Depth;  // a raw uint8 x tile [64][32 bytes]

// The f32 route's assignment (F32, never Split): 32-deep stages of both
// tf32 halves of the two x tiles in the K-major A layout ([2][128 rows][128
// bytes]: the big halves, then the small ones, the warpgroups' 64 rows
// each), both halves of the W rows of Wc's split copy ([2][W][128 bytes]),
// and for uint8 frames the two raw tiles; as many stages as fit, up to 4.
template <typename T, int W>
struct AsgF32 {
  static constexpr bool kU8 = std::is_same<T, uint8_t>::value;
  static constexpr int kXTiles = 2;                        // a warpgroup's each
  static constexpr int kXLoad = kU8 ? kU8Tile : kF32Box;  // an x tile's TMA bytes
  static constexpr int kWLoad = 2 * W * hgemm::kTf32RowBytes;
  static constexpr int kU8Off = 2 * hgemm::kTf32ABytes + kWLoad;
  static constexpr int kStageBytes =
      (kU8Off + (kU8 ? 2 * kU8Tile : 0) + hgemm::kAlign - 1) / hgemm::kAlign * hgemm::kAlign;
  static constexpr int kColFloats = 2 * 4 * W;
  static constexpr int kRowFloats = 0;
  static constexpr int kVecFloats = 2 * kMaxClusters;
  static constexpr int kFixed = (kColFloats + kRowFloats + kVecFloats) * 4 + 2 * 4 * 8;
  static constexpr int kFit = (232448 - hgemm::kAlign - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmemBytes = kStages * kStageBytes + kFixed;
  static constexpr int kSmem = hgemm::smem_request(kSmemBytes);
  static_assert(kStages >= 2 && kSmem <= 232448, "shared memory a block");
  static_assert(W == 128 || W == 256, "clusters a warpgroup");
};

// The f32 route: the warpgroup's x tile of a 32-deep stage (its 64 frames
// from `first`) split into its tf32 halves in the A layout, the big half
// at st + wg * 8 KB and the small one 16 KB on: f32 frames in place (TMA
// wrote them there, swizzled as the layout is), uint8 frames from their
// raw tile at st + U8Off + wg * 2 KB through the plain version's dequant
// (multiply, then add, each rounded). Frames first + f >= live are zeros.
template <typename T, int U8Off>
__device__ __forceinline__ void split_tile(unsigned char* st, int wg, int t128, int first,
                                           int live) {
  unsigned char* big = st + wg * kF32Box;
  unsigned char* small = big + hgemm::kTf32ABytes;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = t128 + 128 * it;  // 16-byte chunk c of row f
    const int f = idx >> 3;
    const int c = idx & 7;
    const int off = hgemm::swizzled(f, c);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (first + f < live) {
      if constexpr (std::is_same<T, float>::value) {
        const float4 q = *reinterpret_cast<const float4*>(big + off);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(st + U8Off + wg * kU8Tile + f * 32 + 4 * c);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = inaff::affine(static_cast<float>((w >> (8 * k)) & 0xffu), kDeqScale, kDeqBias);
      }
    }
    float b[4], s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) hgemm::tf32_split(v[k], b[k], s[k]);
    *reinterpret_cast<float4*>(big + off) = make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4*>(small + off) = make_float4(s[0], s[1], s[2], s[3]);
  }
}

// Logits (W = 256, not Split): tiles of (two live chunks, 256 clusters),
// the affine logits of the live rows into `logits` [B, F, K] f32 and
// nothing else (launch 1a of K > 512; of K > 256 on the f32 route). F32:
// the f32 route (3xTF32 on Wc's split copy; no xb; the assignment's tf32
// halves to assign32 [2][B][K][fp], cluster-major, the small half `half`
// floats on).
template <typename T, int W, bool Split, bool Logits = false, bool F32 = false>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
nv_serve_assign(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                const int* __restrict__ items, const int* __restrict__ num_frames,
                const float* __restrict__ act_scale, const float* __restrict__ act_bias,
                bf16* __restrict__ xb, bf16* __restrict__ assign, float* __restrict__ assign32,
                float* __restrict__ colsum, float* __restrict__ logits, int F, int D, int K,
                int chunks, int fp, long long half) {
  static_assert(!Logits || (W == 256 && !Split), "the logits tiles");
  static_assert(!F32 || !Split, "the f32 route's tiles");
  using P = std::conditional_t<F32, AsgF32<T, W>, Asg<T, W, Split>>;
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
  const int nk = D / (F32 ? hgemm::kTf32Depth : hgemm::kDepth);
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
        uint32_t bytes = P::kWLoad;
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
              if constexpr (F32) {
                // x tiles (f32 into the big halves' rows; uint8 raw), then
                // both halves of W rows of the split copy.
#pragma unroll
                for (int w2 = 0; w2 < P::kXTiles; ++w2) {
                  if (vb[w2] < 0) continue;
                  unsigned char* xs = std::is_same<T, float>::value
                                          ? st + w2 * kF32Box
                                          : st + P::kU8Off + w2 * kU8Tile;
                  hgemm::tma_3d(xs, xmap, bar, ks * hgemm::kTf32Depth, vf[w2], vb[w2]);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  hgemm::tma_3d(st + 2 * hgemm::kTf32ABytes + h * W * hgemm::kTf32RowBytes, wmap,
                                bar, ks * hgemm::kTf32Depth, kt * W, h);
              } else {
#pragma unroll
                for (int w2 = 0; w2 < P::kXTiles; ++w2) {
                  if (vb[w2] < 0) continue;
                  unsigned char* xs = st + w2 * P::kXBytes;
                  hgemm::tma_3d(xs, xmap, bar, ks * hgemm::kDepth, vf[w2], vb[w2]);
                  if constexpr (std::is_same<T, float>::value)
                    hgemm::tma_3d(xs + kF32Box, xmap, bar,
                                  ks * hgemm::kDepth + hgemm::kF32BoxCols, vf[w2], vb[w2]);
                }
#pragma unroll
                for (int i = 0; i < P::kWBoxes; ++i)
                  hgemm::tma_2d(st + P::kXTiles * P::kXBytes + i * kB16Box, wmap, bar,
                                kt * W + i * hgemm::kBoxCols, ks * hgemm::kDepth);
              }
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
      if constexpr (F32) {
        // acc: the stages' sums (hgemm::stage3), laid out as the bf16
        // chain's accumulators; win: a window's products of one stage.
        float win[hgemm::kWindow / 2];
        for (int ks = 0; ks < nk; ++ks) {
          hgemm::bar_wait(&full[ring.stage], ring.phase);
          unsigned char* st = smem + ring.stage * P::kStageBytes;
          split_tile<T, P::kU8Off>(st, wg, t128, f0, live);
          hgemm::fence_async_smem();
          hgemm::named_sync(1 + wg, 128);
          hgemm::stage3<W, 0>(acc, win, hgemm::smem_u32(st), wg * kF32Box);
          if (lane == 0) hgemm::bar_arrive(&empty[ring.stage]);
          ring.template next<P::kStages>();
        }
      } else {
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
      }

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
      // division), 0 past n; bf16(assign) (F32: its tf32 halves) for the
      // rows of the chunk inside F.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = (static_cast<size_t>(b) * F + min(f[h], F - 1)) * K;
        const float rs = 1.0f / sm[h];
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          const int k = col0 + 8 * j + 2 * q;
          const float p0 = lv[h] ? div_by(acc[4 * j + 2 * h], sm[h], rs) : 0.0f;
          const float p1 = lv[h] ? div_by(acc[4 * j + 2 * h + 1], sm[h], rs) : 0.0f;
          acc[4 * j + 2 * h] = p0;
          acc[4 * j + 2 * h + 1] = p1;
          if (have && f[h] < F && k < K) {
            if constexpr (F32) {
              float b0, s0, b1, s1;
              hgemm::tf32_split(p0, b0, s0);
              hgemm::tf32_split(p1, b1, s1);
              float* dst = assign32 + (static_cast<size_t>(b) * K + k) * fp + f[h];
              dst[0] = b0;
              dst[fp] = b1;
              dst[half] = s0;
              dst[half + fp] = s1;
            } else {
              *reinterpret_cast<__nv_bfloat162*>(assign + row + k) = __floats2bfloat162_rn(p0, p1);
            }
          }
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
// on rows t < n, 0 after; bf16(assign) to [B, F, K] (A = float, the f32
// route: its tf32 halves to [2][B][K][fp], `half` floats apart, through a
// transposing tile of 32 clusters) and the unrounded column sum to colsum,
// as launch 1's epilogue writes them.
template <typename A>
__global__ void __launch_bounds__(kWideThreads)
nv_serve_softmax_wide(const int* __restrict__ items, const int* __restrict__ num_frames,
                      const float* __restrict__ logits, A* __restrict__ assign,
                      float* __restrict__ colsum, int F, int K, int chunks, int fp,
                      long long half) {
  __shared__ float s_max[kChunk];
  __shared__ float s_sum[kChunk];
  __shared__ float s_rcp[kChunk];
  __shared__ float tile[std::is_same<A, float>::value ? kChunk : 1][33];  // f32: [rows][32 + 1]
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
    if constexpr (std::is_same<A, float>::value) {
      // Tiles of 32 clusters through shared memory: read along the
      // logits' rows, written along the cluster-major halves' rows.
      for (int k0 = 0; k0 < K; k0 += 32) {
        for (int idx = threadIdx.x; idx < kChunk * 32; idx += kWideThreads) {
          const int r = idx >> 5;
          const int k = k0 + (idx & 31);
          tile[r][idx & 31] =
              r < rows && k < K
                  ? div_by(expf(__fsub_rn(lg[static_cast<size_t>(r) * K + k], s_max[r])),
                           s_sum[r], s_rcp[r])
                  : 0.0f;
        }
        __syncthreads();
        for (int idx = threadIdx.x; idx < kChunk * 32; idx += kWideThreads) {
          const int r = idx & (kChunk - 1);
          const int k = k0 + idx / kChunk;
          if (r < end && k < K) {
            float big, small;
            hgemm::tf32_split(tile[r][idx / kChunk], big, small);
            float* dst = assign + (static_cast<size_t>(b) * K + k) * fp + f0 + r;
            dst[0] = big;
            dst[half] = small;
          }
        }
        if (threadIdx.x < 32 && k0 + static_cast<int>(threadIdx.x) < K) {
          float total = 0.0f;
          for (int r = 0; r < end; ++r) total += tile[r][threadIdx.x];
          colsum[(static_cast<size_t>(b) * chunks + c) * K + k0 + threadIdx.x] = total;
        }
        __syncthreads();
      }
    } else {
      for (int k = threadIdx.x; k < K; k += kWideThreads) {
        float total = 0.0f;
        for (int r = 0; r < end; ++r) {
          const float p =
              r < rows ? div_by(expf(__fsub_rn(lg[static_cast<size_t>(r) * K + k], s_max[r])),
                                s_sum[r], s_rcp[r])
                       : 0.0f;
          assign[(static_cast<size_t>(b) * F + f0 + r) * K + k] = __float2bfloat16_rn(p);
          total += p;
        }
        colsum[(static_cast<size_t>(b) * chunks + c) * K + k] = total;
      }
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

template <typename T, int W, bool Split, bool Logits = false, bool F32 = false>
cudaError_t launch_assign(const CUtensorMap& map_x, const CUtensorMap& map_w, const int* items,
                          const int* num_frames, const float* act_scale, const float* act_bias,
                          bf16* xb, bf16* assign, float* assign32, float* colsum, float* logits,
                          int B, int F, int D, int K, int chunks, int sms, cudaStream_t st,
                          int fp = 0, long long half = 0) {
  using P = std::conditional_t<F32, AsgF32<T, W>, Asg<T, W, Split>>;
  auto kernel = nv_serve_assign<T, W, Split, Logits, F32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  // The live chunks are counted on the card: the grid covers the most
  // there can be, and a block past the count finds no tile.
  const long long most = (Split ? static_cast<long long>(B) * chunks
                                : (static_cast<long long>(B) * chunks + 1) / 2) *
                         (Logits ? (K + W - 1) / W : 1);
  const int grid = most < sms ? static_cast<int>(most) : sms;
  kernel<<<grid, hgemm::kThreads, P::kSmem, st>>>(map_x, map_w, items, num_frames, act_scale,
                                                   act_bias, xb, assign, assign32, colsum, logits,
                                                   F, D, K, chunks, fp, half);
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
    err = launch_assign<T, 128, false>(map_x, map_w, it, nf, scale, bias, x16, asg, nullptr, cs, lg,
                                       B, F, D, K, chunks, sms, st);
  } else if (K <= 256) {
    err = launch_assign<T, 256, false>(map_x, map_w, it, nf, scale, bias, x16, asg, nullptr, cs, lg,
                                       B, F, D, K, chunks, sms, st);
  } else if (K <= kMaxClusters) {
    err = launch_assign<T, 256, true>(map_x, map_w, it, nf, scale, bias, x16, asg, nullptr, cs, lg,
                                      B, F, D, K, chunks, sms, st);
  } else {
    err = launch_assign<T, 256, false, true>(map_x, map_w, it, nf, scale, bias, x16, asg, nullptr,
                                             cs, lg, B, F, D, K, chunks, sms, st);
    if (err == cudaSuccess) {
      const long long most = static_cast<long long>(B) * chunks;
      nv_serve_softmax_wide<bf16><<<static_cast<unsigned>(most < 65535 ? most : 65535), kWideThreads, 0,
                              st>>>(it, nf, lg, asg, cs, F, K, chunks, 0, 0);
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
// The f32 route (3xTF32).
// ---------------------------------------------------------------------------

// Launch 2 of the f32 route: v = assign^T x - a_sum (x) centers over
// tiles (video, 256 clusters, 128 columns), the walk of the bf16 route's
// launch 2 (agg_blocks_per_combo), on stages of 32 frames: both tf32
// halves of the tile's clusters' rows of the split assignment [2][B][K]
// [fp] (K-major: B of the wgmma, [256][32] f32 each, 32 KB), then the
// frames' [32][32] f32 boxes (4) or [32][128 bytes] uint8 box, swizzled;
// 80 KB, two stages. Each consumer warpgroup computes v^T for its 64
// columns x 256 clusters: A = x^T from registers (a thread's fragments of
// the stage's four k8 steps, loaded from the frames' boxes, frames t >= n
// zeroed, split), B the assignment's halves, wgmma m64n64k8 in 3xTF32 over
// four windows of 64 clusters, each stage summed in fresh registers and
// added on the FMA units. The epilogue reads a_sum and the centers from
// device memory (L2), stores v itself and each cluster's sum of squares
// over the tile's columns (the rows of v^T: a fold over the lanes, then
// the 8 warps in shared memory).
constexpr int kF32AggFrames = 32;  // frames a stage: 4 k8 steps
constexpr int kF32AggStages = 2;
constexpr int kF32AggHalf = kAggClusters * hgemm::kTf32RowBytes;  // [256][32] f32: 32 KB
constexpr int kF32AggXBox = kF32AggFrames * 128;                  // [32][32] f32: 4 KB
constexpr int kF32AggStageBytes = 2 * kF32AggHalf + (kCols / 32) * kF32AggXBox;  // 80 KB
constexpr int kF32AggRed = 8 * kAggClusters;  // the warps' sums of squares: [8][256] f32
constexpr int kF32AggSmem = hgemm::smem_request(kF32AggStages * kF32AggStageBytes +
                                                kF32AggRed * 4 + 2 * kF32AggStages * 8);
static_assert(kF32AggSmem <= 232448, "shared memory a block");

// Frame t, column c of a stage's frames as f32 (uint8: the plain
// version's dequant).
template <typename T>
__device__ __forceinline__ float agg_frame(const unsigned char* xs, int t, int c) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float*>(xs + (c >> 5) * kF32AggXBox + t * 128 +
                                           ((((c >> 2) & 7) ^ (t & 7)) << 4) + (c & 3) * 4);
  } else {
    const unsigned char u = xs[t * 128 + (((c >> 4) ^ (t & 7)) << 4) + (c & 15)];
    return inaff::affine(static_cast<float>(u), kDeqScale, kDeqBias);
  }
}

template <typename T>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
nv_f32_aggregate(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_x,
                 const int* __restrict__ num_frames, const float* __restrict__ a_sum,
                 const float* __restrict__ centers, float* __restrict__ sumsq,
                 float* __restrict__ out, int B, int F, int D, int K, int per_combo) {
  constexpr bool kF32X = std::is_same<T, float>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  float* red = reinterpret_cast<float*>(smem + kF32AggStages * kF32AggStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kF32AggRed);
  uint64_t* empty = full + kF32AggStages;

  const int n_ct = D / kCols;
  const int combos = ((K + kAggClusters - 1) / kAggClusters) * n_ct;
  const int combo = blockIdx.x % combos;
  const int kt = combo / n_ct;
  const int ct = combo % n_ct;
  const int first = blockIdx.x / combos;
  auto steps = [&](int v) {
    return (live_frames(num_frames, v, F) + kF32AggFrames - 1) / kF32AggFrames;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32AggStages; ++s) {
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
      constexpr uint32_t kBytes = 2 * kF32AggHalf + (kF32X ? kCols / 32 : 1) * kF32AggXBox;
      for (int b = first; b < B; b += per_combo) {
        hgemm::produce<kF32AggStages>(
            full, empty, ring, steps(b), kBytes, [&](int s, uint64_t* bar, int ks) {
              unsigned char* st = smem + s * kF32AggStageBytes;
#pragma unroll
              for (int h = 0; h < 2; ++h)
                hgemm::tma_4d(st + h * kF32AggHalf, amap, bar, ks * kF32AggFrames,
                              kt * kAggClusters, b, h);
#pragma unroll
              for (int i = 0; i < (kF32X ? kCols / 32 : 1); ++i)
                hgemm::tma_3d(st + 2 * kF32AggHalf + i * kF32AggXBox, xmap, bar,
                              ct * kCols + 32 * i, ks * kF32AggFrames, b);
            });
      }
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int r = lane >> 2;
    const int cl = 64 * wg + 16 * warp + r;  // the thread's tile columns cl, cl + 8
    // acc: v^T's sums, rows (columns of v) cl + 8 h, clusters 8 j + 2 q + e
    // in acc[4 j + 2 h + e]; win: a window's products of one stage.
    float acc[kAggClusters / 2];
    float win[32];
    for (int b = first; b < B; b += per_combo) {
      const int live = live_frames(num_frames, b, F);
      const int nst = steps(b);
      hgemm::zero<kAggClusters / 2>(acc);
      for (int ks = 0; ks < nst; ++ks) {
        hgemm::bar_wait(&full[ring.stage], ring.phase);
        const unsigned char* st = smem + ring.stage * kF32AggStageBytes;
        const uint32_t sb = hgemm::smem_u32(st);
        // A = x^T for the four k8 steps: (column cl (+8), frame 8 kk + q
        // (+4)) in a[kk][e], e = 2 (frame half) + (column half).
        float ab[4][4], as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 8 * kk + q + 4 * (e >> 1);
            const float v = ks * kF32AggFrames + t < live
                                ? agg_frame<T>(st + 2 * kF32AggHalf, t, cl + 8 * (e & 1))
                                : 0.0f;
            hgemm::tf32_split(v, ab[kk][e], as[kk][e]);
          }
#pragma unroll
        for (int w = 0; w < kAggClusters / 64; ++w) {
          hgemm::fence_regs<32>(win);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            hgemm::fence_regs<4>(ab[kk]);
            hgemm::fence_regs<4>(as[kk]);
          }
          hgemm::mma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t bb = hgemm::desc_b_k(sb + w * 64 * hgemm::kTf32RowBytes, kk);
            const uint64_t bs =
                hgemm::desc_b_k(sb + kF32AggHalf + w * 64 * hgemm::kTf32RowBytes, kk);
            hgemm::mma_tf32_rs64(win, as[kk], bb, kk > 0);
            hgemm::mma_tf32_rs64(win, ab[kk], bs);
            hgemm::mma_tf32_rs64(win, ab[kk], bb);
          }
          hgemm::mma_commit();
          hgemm::mma_wait<0>();
          hgemm::fence_regs<32>(win);
#pragma unroll
          for (int j = 0; j < 32; ++j) acc[32 * w + j] += win[j];
        }
        if (lane == 0) hgemm::bar_arrive(&empty[ring.stage]);
        ring.template next<kF32AggStages>();
      }

      // Epilogue: v[k, d] = acc - a_sum[k] * centers[k, d] (multiply and
      // subtract each rounded, as the plain version), stored; each
      // cluster's sum of squares over the thread's two columns, then the
      // tile's (lane l ends with clusters 8 (4 r + t) + 2 q + e in ss[2 t
      // + e], t < 4), then the 8 warps'.
      // Eight clusters' columns (32 loads of the centers) at a time: all
      // 128 in flight at once spilled registers.
      float ss[kAggClusters / 4];
      const int d = ct * kCols + cl;
#pragma unroll
      for (int j0 = 0; j0 < kAggClusters / 8; j0 += 8) {
        float c[8][2][2];
        float2 a2[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int kc = min(kt * kAggClusters + 8 * (j0 + jj) + 2 * q, K - 2);
          a2[jj] = __ldg(reinterpret_cast<const float2*>(a_sum + static_cast<size_t>(b) * K + kc));
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              c[jj][e][h] = __ldg(centers + static_cast<size_t>(kc + e) * D + d + 8 * h);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j0 + jj;
          const int k = kt * kAggClusters + 8 * j + 2 * q;  // k + 1 < K with k: K % 8 == 0
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float sq = 0.0f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = __fsub_rn(acc[4 * j + 2 * h + e],
                                        __fmul_rn(e ? a2[jj].y : a2[jj].x, c[jj][e][h]));
              if (k < K) out[(static_cast<size_t>(b) * K + k + e) * D + d + 8 * h] = v;
              sq += v * v;
            }
            ss[2 * j + e] = sq;
          }
        }
        __syncwarp();
      }
      fold_sum<kAggClusters / 8, 16>(ss, lane);
      fold_sum<kAggClusters / 16, 8>(ss, lane);
      fold_sum<kAggClusters / 32, 4>(ss, lane);
      float* rw = red + (4 * wg + warp) * kAggClusters;
#pragma unroll
      for (int t4 = 0; t4 < kAggClusters / 64; ++t4)
        *reinterpret_cast<float2*>(rw + 8 * (r * (kAggClusters / 64) + t4) + 2 * q) =
            make_float2(ss[2 * t4], ss[2 * t4 + 1]);
      hgemm::named_sync(1, 256);
      {
        const int kl = threadIdx.x;  // 0 .. 255: a cluster of the tile
        float total = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < 8; ++w8) total += red[w8 * kAggClusters + kl];
        const int k = kt * kAggClusters + kl;
        if (k < K) sumsq[(static_cast<size_t>(b) * n_ct + ct) * K + k] = total;
      }
      hgemm::named_sync(1, 256);
    }
  }
}

constexpr int kScaleThreads = 256;

// Launch 4 of the f32 route: out = (v / n_k) / g in place over [B, K, D]
// (D % 4 == 0), a warp a row (b, k): both quotients correctly rounded, as
// the bf16 route's store pass divides.
__global__ void __launch_bounds__(kScaleThreads)
nv_f32_scale(const float* __restrict__ norms, const float* __restrict__ gnorm,
             float* __restrict__ out, int K, int D, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kScaleThreads / 32);
  for (long long row = (static_cast<long long>(blockIdx.x) * kScaleThreads + threadIdx.x) / 32;
       row < rows; row += warps) {
    const float nrm = norms[row];
    const float gn = gnorm[row / K];
    const float rn = 1.0f / nrm;
    const float rg = 1.0f / gn;
    float4* o = reinterpret_cast<float4*>(out + row * D);
    for (int c = lane; c < D / 4; c += 32) {
      float4 v = o[c];
      v.x = div_by(div_by(v.x, nrm, rn), gn, rg);
      v.y = div_by(div_by(v.y, nrm, rn), gn, rg);
      v.z = div_by(div_by(v.z, nrm, rn), gn, rg);
      v.w = div_by(div_by(v.w, nrm, rn), gn, rg);
      o[c] = v;
    }
  }
}

template <typename T>
int launch_f32(const void* x, const void* num_frames, const void* w_split, const void* act_scale,
               const void* act_bias, const void* centers, void* assign, void* colsum, void* items,
               void* work, void* logits, void* out, int B, int F, int D, int K, int split_rows,
               int split_depth, void* stream) {
  if (B <= 0 || F <= 0 || D <= 0 || D % kCols != 0 || K < 8 || K % 8 != 0 || split_rows < 1 ||
      split_rows > K || split_depth < 1 || split_depth > D || split_depth % 4 != 0 ||
      (K > kF32Clusters && logits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (F + kChunk - 1) / kChunk;
  if (static_cast<long long>(B) * chunks * ((K + 255) / 256) >= (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ct = D / kCols;
  float* sumsq = static_cast<float*>(work);                  // [B, D / 128, K]
  float* norms = sumsq + static_cast<size_t>(B) * n_ct * K;  // [B, K]
  float* a_sum = norms + static_cast<size_t>(B) * K;         // [B, K]
  float* gnorm = a_sum + static_cast<size_t>(B) * K;         // [B]
  const int* nf = static_cast<const int*>(num_frames);
  int* it = static_cast<int*>(items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  nv_serve_scan<<<1, kScanThreads, 0, st>>>(nf, it, B, F, chunks);
  err = cudaGetLastError();
  // Launch 1 reads x in tiles [64 frames][32] and Wc's split copy in rows
  // of 32 deep; launch 2 the assignment's halves [2][B][K][fp] (frames
  // past F read as zeros) in rows of 32 frames and x in tiles of 32 frames.
  constexpr bool kF32X = std::is_same<T, float>::value;
  const int w_rows = K <= 128 ? 128 : 256;
  const int fp = (F + 3) / 4 * 4;
  const long long half = static_cast<long long>(B) * K * fp;
  CUtensorMap map_x, map_w, map_a, map_x2;
  if (err == cudaSuccess)
    err = kF32X ? hgemm::make_map_f32(&map_x, x, B, F, D, kChunk)
                : hgemm::make_map_u8(&map_x, x, B, F, D, D, kChunk, hgemm::kTf32Depth,
                                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess) err = hgemm::make_map_split(&map_w, w_split, split_rows, split_depth, w_rows);
  if (err == cudaSuccess) {
    const uint64_t dims[4] = {static_cast<uint64_t>(F), static_cast<uint64_t>(K),
                              static_cast<uint64_t>(B), 2};
    const uint64_t strides[3] = {static_cast<uint64_t>(fp) * 4,
                                 static_cast<uint64_t>(K) * fp * 4,
                                 static_cast<uint64_t>(half) * 4};
    const uint32_t box[4] = {static_cast<uint32_t>(kF32AggFrames), kAggClusters, 1, 1};
    err = hgemm::make_map(&map_a, assign, 4, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  }
  if (err == cudaSuccess)
    err = kF32X ? hgemm::make_map_3d(&map_x2, x, B, F, D, D, 4, kF32AggFrames,
                                     hgemm::kF32BoxCols, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)
                : hgemm::make_map_u8(&map_x2, x, B, F, D, D, kF32AggFrames, 128);
  int sms = 0;
  if (err == cudaSuccess) err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* scale = static_cast<const float*>(act_scale);
  const float* bias = static_cast<const float*>(act_bias);
  float* asg = static_cast<float*>(assign);
  float* cs = static_cast<float*>(colsum);
  float* lg = static_cast<float*>(logits);
  if (K <= 128) {
    err = launch_assign<T, 128, false, false, true>(map_x, map_w, it, nf, scale, bias, nullptr,
                                                    nullptr, asg, cs, lg, B, F, D, K, chunks,
                                                    sms, st, fp, half);
  } else if (K <= kF32Clusters) {
    err = launch_assign<T, 256, false, false, true>(map_x, map_w, it, nf, scale, bias, nullptr,
                                                    nullptr, asg, cs, lg, B, F, D, K, chunks,
                                                    sms, st, fp, half);
  } else {
    err = launch_assign<T, 256, false, true, true>(map_x, map_w, it, nf, scale, bias, nullptr,
                                                   nullptr, asg, cs, lg, B, F, D, K, chunks, sms,
                                                   st);
    if (err == cudaSuccess) {
      const long long most = static_cast<long long>(B) * chunks;
      nv_serve_softmax_wide<float><<<static_cast<unsigned>(most < 65535 ? most : 65535),
                                     kWideThreads, 0, st>>>(it, nf, lg, asg, cs, F, K, chunks, fp,
                                                            half);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  nv_serve_asum<<<B, kSumThreads, 0, st>>>(nf, cs, a_sum, F, K, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int combos = ((K + kAggClusters - 1) / kAggClusters) * n_ct;
  const int per_combo = agg_blocks_per_combo(B, combos, sms);
  auto aggregate = nv_f32_aggregate<T>;
  err = cudaFuncSetAttribute(aggregate, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32AggSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* o = static_cast<float*>(out);
  aggregate<<<per_combo * combos, hgemm::kThreads, kF32AggSmem, st>>>(
      map_a, map_x2, nf, a_sum, static_cast<const float*>(centers), sumsq, o, B, F, D, K,
      per_combo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nv_serve_norms<<<B, kNormThreads, 0, st>>>(sumsq, norms, gnorm, K, n_ct);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * K;
  const long long blocks = (rows + kScaleThreads / 32 - 1) / (kScaleThreads / 32);
  nv_f32_scale<<<static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16), kScaleThreads, 0,
                 st>>>(norms, gnorm, o, K, D, rows);
  return static_cast<int>(cudaGetLastError());
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

// The f32 route: x [B, F, D] uint8 or f32 (D a multiple of 128), w_split
// [2][split_rows][split_depth] f32 (kernels/tf32.py :: split_weights of Wc
// [split_depth rounded down, split_rows]: split_rows <= K, split_depth a
// multiple of 4 <= D; the rows and depth past them read as zeros), K a
// multiple of 8; scratch from the caller: assign [B, F, K] f32 (written on
// the live chunks' rows), colsum [B, ceil(F/64), K] f32, items 1 + B
// ceil(F/64) int32, work B (D/128 + 2) K + B f32 and, for K > 256, logits
// [B, F, K] f32 (else null); out [B, K, D].
extern "C" int yt8m_netvlad_aggregate_f32w_u8(const void* x, const void* num_frames,
                                             const void* w_split, const void* act_scale,
                                             const void* act_bias, const void* centers,
                                             void* assign, void* colsum, void* items, void* work,
                                             void* logits, void* out, int B, int F, int D, int K,
                                             int split_rows, int split_depth, void* stream) {
  return launch_f32<uint8_t>(x, num_frames, w_split, act_scale, act_bias, centers, assign, colsum,
                             items, work, logits, out, B, F, D, K, split_rows, split_depth,
                             stream);
}

extern "C" int yt8m_netvlad_aggregate_f32w_f32(const void* x, const void* num_frames,
                                              const void* w_split, const void* act_scale,
                                              const void* act_bias, const void* centers,
                                              void* assign, void* colsum, void* items, void* work,
                                              void* logits, void* out, int B, int F, int D, int K,
                                              int split_rows, int split_depth, void* stream) {
  return launch_f32<float>(x, num_frames, w_split, act_scale, act_bias, centers, assign, colsum,
                           items, work, logits, out, B, F, D, K, split_rows, split_depth, stream);
}

// The tiles: [frames a chunk, assignment stages, the assignment's shared
// bytes for (f32, 128 clusters a warpgroup), (f32, 256), (f32, split
// 512), (uint8, 128), (uint8, 256), (uint8, split 512), aggregation
// clusters a tile, columns a tile, stages, shared bytes, SMs, then the
// f32 route's: the assignment's stages (f32 frames, 256) and shared bytes
// for (f32, 128), (f32, 256), (uint8, 128), (uint8, 256), the clusters
// its registers hold, frames a stage of the aggregation, its shared
// bytes].
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
  plan[13] = AsgF32<float, 256>::kStages;
  plan[14] = AsgF32<float, 128>::kSmem;
  plan[15] = AsgF32<float, 256>::kSmem;
  plan[16] = AsgF32<uint8_t, 128>::kSmem;
  plan[17] = AsgF32<uint8_t, 256>::kSmem;
  plan[18] = kF32Clusters;
  plan[19] = kF32AggFrames;
  plan[20] = kF32AggSmem;
  return static_cast<int>(cudaSuccess);
}
