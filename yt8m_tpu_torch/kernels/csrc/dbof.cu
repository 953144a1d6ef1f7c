// Fused DBoF cluster + max-pool serving kernel for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/dbof.py :: dbof_cluster_maxpool_v2, and with
// it dbof_cluster_maxpool (v1: the same function, an f32 W rounded to
// bf16 on every call by yt8m_round_bf16) and dbof_sampled_cluster_maxpool
// (the frame gather fused into launch 1 below). For sampled frames
// x [B, S, D] (uint8 or float32):
//
//   xa   = bf16(x * in_scale + in_bias)        (dequant + input BN, f32)
//   act  = xa @ W                              (bf16 in, f32 accumulate)
//   out  = max_s relu(act * act_scale + act_bias)     [B, K] f32
//
// What bounds it: the product. At B=2048, S=30, D=1152, K=8192 it is
// 1.16 TFLOP against ~90 MB of input, far above the card's ridge point,
// so the bound is the bf16 tensor-core rate (1.17 ms at 989 TFLOP/s).
//
// Design. Two launches on the caller's stream:
//  1. input_affine (input_affine.cuh): xa = bf16(x * in_scale + in_bias)
//     for every sampled frame, once, into a [B*S, D] bf16 buffer from the
//     wrapper.
//     This is the TPU kernel's "dequant + affine once per video block":
//     fused into the product it would run once per cluster tile, 32
//     times over, and cost as many instructions as the tensor cores.
//     The sampled variant (dbof_sampled_input_affine) reads row idx[b, s]
//     of the full frames [B, F, D] of video b, and a zero frame for an
//     index outside [0, F), as the TPU kernel's one-hot select does.
//  2. dbof_cluster_maxpool: a bf16 product on hopper_gemm.cuh's TMA +
//     wgmma mainloop whose epilogue is the BN affine, the ReLU and the
//     max over frames. A tile is 4 videos x 256 clusters. TMA reads xa as
//     [B, S, D] in boxes of 4 videos x 32 frames x 64 deep: the frames
//     past S and the videos past B arrive as zeros, so 4 videos land as
//     128 rows at a pitch of 32 and device memory holds no padding. W
//     comes in boxes of 64 deep x 64 clusters. Each consumer warpgroup
//     runs m64n256k16 on its two videos. The grid is persistent (a block
//     an SM walking the tiles, cluster tile fastest, so W's 18.9 MB stay
//     in L2 while xa streams once); the producer fills the 4-stage ring
//     with the next tile's stages while the consumers run the epilogue.
//     The epilogue works in the accumulator registers: the affine, rows
//     s >= S set to -inf (a zero row would give relu(act_bias), which can
//     exceed every real row), the max over a warp's 16 rows by shuffles
//     (each step halves the columns a lane keeps), the video's two warps
//     joined through shared memory, the clamp at 0, one store per (video,
//     cluster). The [B*S, K] activations never reach device memory.
//     Rows 1, 4 and 6 of the kernel table all run this launch.
//     Each fold step has a constant trip count: a trip count that depends
//     on the step put the 64 partial maxima in local memory, and the
//     product took 2.31 ms instead of 1.65 at B=2048 (an H100). A cluster
//     of two blocks sharing W's stages by TMA multicast took 3.79 ms in
//     the same call, and is not used.
//
// The f32 route (--compute_dtype=float32, W f32): the same function with
// nothing rounded to bf16, as the TPU kernel computes it at
// dtype=float32, on the tensor cores as a 3xTF32 product
// (hopper_gemm.cuh :: consume3): both operands split into tf32 halves,
// big = tf32(v) and small = tf32(v - big), and act = A_small W_big +
// A_big W_small + A_big W_big, about 2^-21 of each product from the f32
// product. The tensor core sums one 32-deep stage at a time, in windows
// of 128 clusters; the stages' sums add up in registers on the FMA
// units, so the wgmmas' rounding toward zero never accumulates over D
// (one chain of wgmmas over D drifted linearly in D on the card: 3.8e-5
// at D = 1152 and 6.3e-4 at D = 16384, where the f32 matmul's error was
// 1.4e-6 and 4.9e-6; PERF.md §6). At B=2048, S=30, D=1152, K=8192 it
// is 3 x 1.16 TFLOP at the TF32 rate (494.7 TFLOP/s): 7.03 ms at the
// bound, against 17.3 ms for one f32 product at the 67 TFLOP/s outside
// the tensor cores.
// Two launches, as the bf16 route:
//  1. input_affine_split (input_affine.cuh): xa = x * in_scale + in_bias
//     in f32 (multiply, then add, each rounded, as the plain version),
//     split into its halves, into a [2][B*S][D] f32 buffer from the
//     wrapper (566 MB at the serving shape, read about four times: the
//     split is done once, not once per cluster tile).
//  2. the product launch's F32 instance: the same tiles (4 videos x 256
//     clusters, rows s >= S zero-filled and kept out of the max), a
//     persistent walk, the same epilogue, on a ring of 32-deep
//     stages: A's two halves [2][128 rows][32] from a 4-D tensor map over
//     [2][B][S][D], W's two halves [2][256 clusters][32] from the split
//     copy [2][K][D] that the model builds once per weight version
//     (kernels/tf32.py :: split_weights: K-major, since TF32's wgmma
//     reads B K-major only). A stage is 96 KB: two stages. W's halves are
//     75.5 MB, past the 50 MB L2, so the tiles walk in groups of 8
//     cluster tiles (18.9 MB of W), the video tiles of a group before the
//     next group, the cluster tile fastest within it: each group's W stays
//     in L2 while xa's halves stream once a group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "input_affine.cuh"

namespace {

constexpr int kVideos = 4;                 // videos a tile
constexpr int kPitch = 32;                 // rows a video: S <= 32, zero-filled past S
constexpr int kBN = 256;                   // clusters a tile
constexpr int kPoolFloats = 2 * kVideos * kBN;  // the warps' partial maxima, two tiles
constexpr int kF32Group = 8;               // cluster tiles a group of the f32 walk
static_assert(kVideos * kPitch == hgemm::kRows, "a tile is the block's 128 A rows");

// The ring of each route: bf16, 64-deep stages of the A tile and W's four
// MN-major boxes (48 KB); F32, 32-deep stages of both halves of the A
// tile and of W's K-major rows (96 KB).
template <bool F32>
struct Layout {
  static constexpr int kDepth = F32 ? hgemm::kTf32Depth : hgemm::kDepth;
  static constexpr int kStages = F32 ? 2 : 4;
  static constexpr int kBBytes = F32 ? 2 * kBN * hgemm::kTf32RowBytes
                                     : hgemm::boxes(kBN) * hgemm::kBoxBytes;
  static constexpr int kStageBytes = (F32 ? 2 * hgemm::kTf32ABytes : hgemm::kABytes) + kBBytes;
  static constexpr int kSmemRequest =
      hgemm::smem_request(kStages * kStageBytes + kPoolFloats * 4 + 2 * kStages * 8);
  static_assert(kSmemRequest <= 232448, "shared memory a block");
};

using inaff::affine;

// The gathering variant: xa[b*S + s, d] = bf16(x[b, idx[b*S + s], d] *
// in_scale[d] + in_bias[d]) over x [B, F, D] uint8, a zero frame where the
// index is outside [0, F).
__global__ void __launch_bounds__(256)
dbof_sampled_input_affine(const uint8_t* __restrict__ x, const int* __restrict__ idx,
                          const float* __restrict__ in_scale, const float* __restrict__ in_bias,
                          __nv_bfloat16* __restrict__ xa, size_t n8, int d8, int S, int F) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / d8;
    const int d0 = static_cast<int>(i % d8) * 8;
    const int f = idx[r];
    float v[8];
    if (f >= 0 && f < F) {
      inaff::load8(x + ((r / S) * F + f) * (static_cast<size_t>(d8) * 8) + d0, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.0f;
    }
    reinterpret_cast<uint4*>(xa)[i] = inaff::affine8(v, in_scale, in_bias, d0);
  }
}

// One step of the epilogue's max over rows: lanes `bit` apart exchange
// halves of v[0, 2 Half), each keeping the max of the half its lane bit
// selects in v[0, Half). (A constant trip count: the array stays in
// registers.)
template <int Half, int Bit>
__device__ __forceinline__ void fold(float* v, int lane) {
  const bool upper = lane & Bit;
#pragma unroll
  for (int i = 0; i < Half; ++i) {
    const float keep = hgemm::select(upper, v[Half + i], v[i]);
    const float send = hgemm::select(upper, v[i], v[Half + i]);
    v[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, Bit));
  }
}

// Tile t of the walk in groups of `group` cluster tiles (the last group
// may be narrower): each group's video tiles in order, the cluster tile
// fastest within a group. group >= n_ct is one group: video tile t / n_ct,
// cluster tile t % n_ct.
__host__ __device__ __forceinline__ void tile_coords(int t, int n_ct, int n_rt, int group,
                                                     int& rt, int& ct) {
  const int g = t / (group * n_rt);
  const int rest = t - g * group * n_rt;
  const int width = n_ct - g * group < group ? n_ct - g * group : group;
  rt = rest / width;
  ct = g * group + rest - rt * width;
}

// The product over xa [B, S, D] (bf16; F32: its tf32 halves [2][B][S][D])
// and W [D, K] (bf16 MN-major boxes; F32: its K-major halves [2][K][D]).
template <bool F32>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
dbof_cluster_maxpool_kernel(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_w,
                            const float* __restrict__ act_scale,
                            const float* __restrict__ act_bias, float* __restrict__ out, int B,
                            int S, int D, int K) {
  using R = Layout<F32>;
  constexpr int kStages = R::kStages;
  constexpr int kStageBytes = R::kStageBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  float* pool = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(pool + kPoolFloats);
  uint64_t* empty = full + kStages;

  const int nk = (D + R::kDepth - 1) / R::kDepth;
  const int n_ct = (K + kBN - 1) / kBN;
  const int n_rt = (B + kVideos - 1) / kVideos;
  const int group = F32 ? kF32Group : n_ct;
  const int tiles = n_ct * n_rt;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hgemm::bar_init(&full[s], 1);
      hgemm::bar_init(&empty[s], hgemm::kConsumerWarps);
    }
    hgemm::bar_init_fence();
  }
  __syncthreads();

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* xmap = &map_x;  // the parameter itself (TMA reads it there)
  const CUtensorMap* wmap = &map_w;
  if (wg == 2) {
    // Producer: one thread walks the block's tiles and their k-steps.
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int rt, ct;
        tile_coords(t, n_ct, n_rt, group, rt, ct);
        hgemm::produce<kStages>(
            full, empty, ring, nk, kStageBytes, [&](int s, uint64_t* bar, int kt) {
              unsigned char* st = smem + s * kStageBytes;
              const int k0 = kt * R::kDepth;
              if constexpr (F32) {
                unsigned char* wb = st + 2 * hgemm::kTf32ABytes;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  hgemm::tma_4d(st + h * hgemm::kTf32ABytes, xmap, bar, k0, 0, rt * kVideos, h);
                  hgemm::tma_3d(wb + h * kBN * hgemm::kTf32RowBytes, wmap, bar, k0, ct * kBN, h);
                }
              } else {
                hgemm::tma_3d(st, xmap, bar, k0, 0, rt * kVideos);
#pragma unroll
                for (int i = 0; i < kBN / hgemm::kBoxCols; ++i)
                  hgemm::tma_2d(st + hgemm::kABytes + i * hgemm::kBoxBytes, wmap, bar,
                                ct * kBN + i * hgemm::kBoxCols, k0);
              }
            });
      }
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;  // warp of the warpgroup
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int r = lane >> 2;
    // Rows r and r + 8 of the warp's 16: frames s0 and s0 + 8 of video
    // 2 wg + warp / 2 of the tile.
    const int s0 = 16 * (warp & 1) + r;
    const bool live0 = s0 < S;
    const bool live1 = s0 + 8 < S;
    const int video = 2 * wg + (warp >> 1);
    const uint32_t a_off = wg * 64 * 128;  // the warpgroup's 64 rows of 128 bytes
    float acc[kBN / 2];
    int iter = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++iter) {
      int rt, ct;
      tile_coords(t, n_ct, n_rt, group, rt, ct);
      const int n0 = ct * kBN;
      hgemm::zero<kBN / 2>(acc);
      if constexpr (F32) {
        // acc holds the stages' sums, added on the FMA units; win one
        // window's products of a stage.
        float win[hgemm::kWindow / 2];
        hgemm::consume3<kStages, kBN, 0>(full, empty, ring, nk, acc, win,
                                         hgemm::smem_u32(smem), kStageBytes, a_off);
      } else {
        hgemm::consume<kStages, kBN / 2>(full, empty, ring, nk, acc, [&](int s) {
          const uint32_t st = hgemm::smem_u32(smem + s * kStageBytes);
#pragma unroll
          for (int kk = 0; kk < hgemm::kDepth / 16; ++kk)
            hgemm::chain<kBN>(acc, st + a_off, st + hgemm::kABytes, kk);
        });
      }

      // Epilogue. The BN affine on every element, frames s >= S to -inf
      // (a zero row would give relu(act_bias)), the max of the thread's
      // two rows; columns 8j + 2q + e in v[2j + e].
      float v[kBN / 4];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        float2 sc = make_float2(0.0f, 0.0f), bi = make_float2(0.0f, 0.0f);
        if (n < K) {
          sc = __ldg(reinterpret_cast<const float2*>(act_scale + n));
          bi = __ldg(reinterpret_cast<const float2*>(act_bias + n));
        }
        v[2 * j] = fmaxf(live0 ? affine(acc[4 * j], sc.x, bi.x) : -INFINITY,
                         live1 ? affine(acc[4 * j + 2], sc.x, bi.x) : -INFINITY);
        v[2 * j + 1] = fmaxf(live0 ? affine(acc[4 * j + 1], sc.y, bi.y) : -INFINITY,
                             live1 ? affine(acc[4 * j + 3], sc.y, bi.y) : -INFINITY);
      }
      // The max over the warp's 16 rows (lane bits 2-4), halving the
      // columns a lane keeps at each step: lane l ends with columns
      // 32 (l / 4) + 8 t + 2q + e in v[2t + e], t < 4.
      fold<kBN / 8, 16>(v, lane);
      fold<kBN / 16, 8>(v, lane);
      fold<kBN / 32, 4>(v, lane);
      // The video's two warps meet in shared memory (double-buffered by
      // tile); the even warp clamps at 0 and stores.
      float* slot = pool + ((iter & 1) * kVideos + video) * kBN + 32 * r + 2 * q;
      if (warp & 1) {
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4)
          *reinterpret_cast<float2*>(slot + 8 * t4) = make_float2(v[2 * t4], v[2 * t4 + 1]);
      }
      hgemm::named_sync(1 + video, 64);
      const int b = rt * kVideos + video;
      if (!(warp & 1) && b < B) {
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4) {
          const int n = n0 + 32 * r + 8 * t4 + 2 * q;
          const float2 o = *reinterpret_cast<const float2*>(slot + 8 * t4);
          if (n < K)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(b) * K + n) =
                make_float2(fmaxf(fmaxf(v[2 * t4], o.x), 0.0f),
                            fmaxf(fmaxf(v[2 * t4 + 1], o.y), 0.0f));
        }
      }
    }
  }
}

bool bad_shape(int B, int S, int D, int K) {
  return B <= 0 || S <= 0 || S > kPitch || D <= 0 || D % 8 != 0 || K <= 0 || K % 8 != 0;
}

// Launch 2 over the affined rows xa [B*S, D] (F32: their halves [2][B*S][D]
// and W's [2][K][D]): as many blocks as SMs (or tiles), each walking tiles
// blockIdx.x, + gridDim.x, ...
template <bool F32>
int launch_gemm(const void* xa, const void* w, const void* act_scale, const void* act_bias,
                void* out, int B, int S, int D, int K, cudaStream_t st) {
  using R = Layout<F32>;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_x, map_w;
  // xa viewed as [B, S, D] (F32: [2][B][S][D]): a box is 4 videos x 32
  // frames x 128 bytes of depth (of one half); the frames past S and the
  // videos past B read as zeros.
  const uint64_t e = F32 ? 4 : 2;
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B), 2};
  const uint64_t strides[3] = {D * e, static_cast<uint64_t>(S) * D * e,
                               static_cast<uint64_t>(B) * S * D * e};
  const uint32_t box[4] = {static_cast<uint32_t>(R::kDepth), kPitch, kVideos, 1};
  if constexpr (F32) {
    err = hgemm::make_map(&map_x, xa, 4, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err == cudaSuccess) err = hgemm::make_map_split(&map_w, w, K, D, kBN);
  } else {
    err = hgemm::make_map(&map_x, xa, 3, dims, strides, box);
    if (err == cudaSuccess) err = hgemm::make_map_2d(&map_w, w, D, K, K, hgemm::kDepth);
  }
  int sms = 0;
  if (err == cudaSuccess) err = hgemm::sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dbof_cluster_maxpool_kernel<F32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemRequest);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((K + kBN - 1) / kBN) * ((B + kVideos - 1) / kVideos);
  const int grid = tiles < sms ? tiles : sms;
  dbof_cluster_maxpool_kernel<F32><<<grid, hgemm::kThreads, R::kSmemRequest, st>>>(
      map_x, map_w, static_cast<const float*>(act_scale), static_cast<const float*>(act_bias),
      static_cast<float*>(out), B, S, D, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* in_scale, const void* in_bias, const void* w,
           const void* act_scale, const void* act_bias, void* xa, void* out, int B, int S,
           int D, int K, void* stream) {
  if (bad_shape(B, S, D, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = inaff::launch_input_affine(
      static_cast<const T*>(x), static_cast<const float*>(in_scale),
      static_cast<const float*>(in_bias), static_cast<__nv_bfloat16*>(xa),
      static_cast<size_t>(B) * S, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gemm<false>(xa, w, act_scale, act_bias, out, B, S, D, K, st);
}

// The f32 route: xs [2][B*S][D] f32 from the caller, w_split [2][K][D].
template <typename T>
int launch_f32(const void* x, const void* in_scale, const void* in_bias, const void* w_split,
               const void* act_scale, const void* act_bias, void* xs, void* out, int B, int S,
               int D, int K, void* stream) {
  if (bad_shape(B, S, D, K) || D % hgemm::kTf32Depth != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = inaff::launch_input_affine_split(
      static_cast<const T*>(x), static_cast<const float*>(in_scale),
      static_cast<const float*>(in_bias), static_cast<float*>(xs), static_cast<size_t>(B) * S, D,
      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gemm<true>(xs, w_split, act_scale, act_bias, out, B, S, D, K, st);
}

}  // namespace

// xa: a work buffer of B*S*D bf16 from the caller.
extern "C" int yt8m_dbof_cluster_maxpool_u8(const void* x, const void* in_scale,
                                            const void* in_bias, const void* w,
                                            const void* act_scale, const void* act_bias,
                                            void* xa, void* out, int B, int S, int D, int K,
                                            void* stream) {
  return launch<uint8_t>(x, in_scale, in_bias, w, act_scale, act_bias, xa, out, B, S, D, K,
                         stream);
}

extern "C" int yt8m_dbof_cluster_maxpool_f32(const void* x, const void* in_scale,
                                             const void* in_bias, const void* w,
                                             const void* act_scale, const void* act_bias,
                                             void* xa, void* out, int B, int S, int D, int K,
                                             void* stream) {
  return launch<float>(x, in_scale, in_bias, w, act_scale, act_bias, xa, out, B, S, D, K,
                       stream);
}

// The f32 route: x [B, S <= 32, D] uint8 or f32 (D % 32 == 0), w_split
// [2][K][D] f32 (kernels/tf32.py :: split_weights), xs a work buffer of
// 2 * B*S*D f32 from the caller, out [B, K].
extern "C" int yt8m_dbof_cluster_maxpool_f32w_u8(const void* x, const void* in_scale,
                                                const void* in_bias, const void* w_split,
                                                const void* act_scale, const void* act_bias,
                                                void* xs, void* out, int B, int S, int D, int K,
                                                void* stream) {
  return launch_f32<uint8_t>(x, in_scale, in_bias, w_split, act_scale, act_bias, xs, out, B, S,
                             D, K, stream);
}

extern "C" int yt8m_dbof_cluster_maxpool_f32w_f32(const void* x, const void* in_scale,
                                                 const void* in_bias, const void* w_split,
                                                 const void* act_scale, const void* act_bias,
                                                 void* xs, void* out, int B, int S, int D, int K,
                                                 void* stream) {
  return launch_f32<float>(x, in_scale, in_bias, w_split, act_scale, act_bias, xs, out, B, S, D,
                           K, stream);
}

// x: the full frames [B, F, D] uint8; idx: [B, S] int32 sampled indices;
// xa: a work buffer of B*S*D bf16 from the caller.
extern "C" int yt8m_dbof_sampled_cluster_maxpool(const void* x, const void* idx,
                                                 const void* in_scale, const void* in_bias,
                                                 const void* w, const void* act_scale,
                                                 const void* act_bias, void* xa, void* out,
                                                 int B, int F, int S, int D, int K,
                                                 void* stream) {
  if (F <= 0 || bad_shape(B, S, D, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n8 = static_cast<size_t>(B) * S * D / 8;
  dbof_sampled_input_affine<<<inaff::blocks(n8), inaff::kThreads, 0, st>>>(
      static_cast<const uint8_t*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(in_scale), static_cast<const float*>(in_bias),
      static_cast<__nv_bfloat16*>(xa), n8, D / 8, S, F);
  return launch_gemm<false>(xa, w, act_scale, act_bias, out, B, S, D, K, st);
}

// w [rows, cols] f32 -> w16 [rows, ld] bf16 (round to nearest even), the
// columns past cols zero: the W rounding of v1 and of the sampled kernel.
extern "C" int yt8m_round_bf16(const void* w, void* w16, int rows, int cols, int ld,
                               void* stream) {
  if (rows <= 0 || cols <= 0 || ld < cols) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(inaff::launch_round_bf16(
      static_cast<const float*>(w), static_cast<__nv_bfloat16*>(w16), static_cast<size_t>(rows),
      cols, ld, static_cast<cudaStream_t>(stream)));
}

// The product's tile: [videos a tile, rows a video, K clusters a tile,
// stages, shared bytes requested a block, SMs (the persistent grid's
// cap), the f32 route's stages, its shared bytes, its cluster tiles a
// group].
extern "C" int yt8m_dbof_plan(int* plan) {
  int sms = 0;
  const cudaError_t err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = kVideos;
  plan[1] = kPitch;
  plan[2] = kBN;
  plan[3] = Layout<false>::kStages;
  plan[4] = Layout<false>::kSmemRequest;
  plan[5] = sms;
  plan[6] = Layout<true>::kStages;
  plan[7] = Layout<true>::kSmemRequest;
  plan[8] = kF32Group;
  return static_cast<int>(cudaSuccess);
}
