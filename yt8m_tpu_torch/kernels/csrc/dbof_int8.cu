// DBoF cluster + max-pool on the int8 tensor cores, for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/dbof.py :: dbof_cluster_maxpool_int8, the
// opt-in serving path (--dbof_int8_serving). For raw sampled frames
// x [B, S, D] uint8 and the constants that the wrapper's
// int8_serving_constants builds from the f32 cluster kernel and the
// folded affines (w8, per-column symmetric int8, here as its transpose
// w8t [K, D]; a_col, b_col [K] f32):
//
//   acc  = (x - 128) @ w8                      (int32, exact)
//   out  = max_s relu(f32(acc) * a_col + b_col)        [B, K] f32
//
// What bounds it: the product. At B=2048, S=30, D=1152, K=8192 it is
// 1.16 T int8 operations (0.586 ms at the card's 1,979 dense TOPS)
// against 71 MB of frames, 9.4 MB of w8 and 67 MB of output (0.044 ms),
// so the bound is the int8 tensor-core rate.
//
// Design: one launch, csrc/dbof.cu's persistent TMA + wgmma product
// (hopper_gemm.cuh) with the integer wgmma.
//  * The raw bytes are the A operand. wgmma multiplies unsigned bytes by
//    signed ones (m64n256k32.s32.u8.s8), so x needs no shifted copy:
//    acc_u = x @ w8 = acc + 128 colsum8[k] exactly, colsum8[k] = sum_d
//    w8[d, k] (the wrapper's int32 column sums; |acc_u| <= 255 * 127 * D
//    < 2^31 for D < 66,000). The correction is applied once per (video,
//    cluster), after the max.
//  * A tile is 4 videos x 256 clusters. TMA reads x as [B, S, D] in boxes
//    of 4 videos x 32 frames x 128 bytes (the frames past S and the
//    videos past B arrive as zeros) and w8t in boxes of 256 clusters x
//    128 bytes; both K-major (the only layout of the integer wgmma), a
//    128-byte stage is four k32 steps. 48 KB a stage, 4 stages. Each
//    consumer warpgroup runs m64n256k32 on its two videos, 128 int32
//    accumulators a thread. The grid is persistent, the cluster tile
//    fastest (w8t's 9.4 MB stay in L2), and the producer fills the next
//    tile's stages while the consumers run the epilogue.
//  * The epilogue converts once per (video, cluster), not once per frame.
//    Every step of f32(acc) -> * a_col (rounded) -> + b_col (rounded) ->
//    relu is monotone: non-decreasing where a_col >= 0, non-increasing
//    where a_col < 0. So max_s relu(f32(acc_s) a + b) = relu(f32(max_s
//    acc_s) a + b) for a >= 0 and relu(f32(min_s acc_s) a + b) for a < 0,
//    exactly. The epilogue takes an integer max of acc (of -acc where
//    a_col < 0) over the video's rows, frames s >= S set to INT_MIN (a
//    zero row is a real value, the raw byte 0, and can exceed every real
//    row), folded across the lanes as csrc/dbof.cu's epilogue folds its
//    f32 maxima (constant trip counts), the video's two warps joined in
//    shared memory; then the sign back, minus 128 colsum8, one
//    conversion, the affine and the clamp at 0. The result equals the
//    plain version's bit for bit. The epilogue does not overlap the
//    products: 0.23 of the kernel's 1.04 ms at B=2048 on an H100
//    (variants.py's int8_no_epilogue).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int kVideos = 4;   // videos a tile
constexpr int kPitch = 32;   // rows a video: S <= 32, zero-filled past S
constexpr int kBN = 256;     // clusters a tile
constexpr int kDepth = 128;  // bytes (int8 values) of depth a stage
constexpr int kStages = 4;
constexpr int kABytes = hgemm::kRows * kDepth;  // 16 KB
constexpr int kBBytes = kBN * kDepth;           // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;  // 48 KB
constexpr int kPoolInts = 2 * kVideos * kBN;    // the odd warps' partial maxima, two tiles
constexpr int kSmemBytes = kStages * kStageBytes + kPoolInts * 4 + 2 * kStages * 8;
constexpr int kSmemRequest = hgemm::smem_request(kSmemBytes);
static_assert(kVideos * kPitch == hgemm::kRows, "a tile is the block's 128 A rows");
static_assert(kStageBytes % hgemm::kAlign == 0, "stages 1024-byte aligned");
static_assert(kSmemRequest <= 232448, "shared memory a block");

// p ? a : b on registers (a select of addresses would put v in local
// memory; hgemm::select's int32 twin).
__device__ __forceinline__ int select_int(bool p, int a, int b) {
  int r;
  asm("{\n.reg .pred q;\nsetp.ne.u32 q, %3, 0;\nselp.b32 %0, %1, %2, q;\n}\n"
      : "=r"(r)
      : "r"(a), "r"(b), "r"(static_cast<uint32_t>(p)));
  return r;
}

// One step of the max over rows: lanes `Bit` apart exchange halves of
// v[0, 2 Half), each keeping the max of the half its lane bit selects in
// v[0, Half) (dbof.cu's fold, on int32).
template <int Half, int Bit>
__device__ __forceinline__ void fold(int* v, int lane) {
  const bool upper = lane & Bit;
#pragma unroll
  for (int i = 0; i < Half; ++i) {
    const int keep = select_int(upper, v[Half + i], v[i]);
    const int send = select_int(upper, v[i], v[Half + i]);
    v[i] = max(keep, __shfl_xor_sync(0xffffffffu, send, Bit));
  }
}

// -1 where a_col < 0 (its sign bit), else 0: (v ^ m) - m is then -v or v.
__device__ __forceinline__ int neg_mask(float a) { return __float_as_int(a) >> 31; }

__device__ __forceinline__ int signed_by(int v, int m) { return (v ^ m) - m; }

// Tile t: video tile t / n_ct, cluster tile t % n_ct (the fastest).
__device__ __forceinline__ void tile_coords(int t, int n_ct, int& rt, int& ct) {
  rt = t / n_ct;
  ct = t - rt * n_ct;
}

__global__ void __launch_bounds__(hgemm::kThreads, 1)
dbof_int8_cluster_maxpool(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const int* __restrict__ colsum8, const float* __restrict__ a_col,
                          const float* __restrict__ b_col, float* __restrict__ out, int B, int S,
                          int D, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  int* pool = reinterpret_cast<int*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(pool + kPoolInts);
  uint64_t* empty = full + kStages;

  const int nk = (D + kDepth - 1) / kDepth;
  const int n_ct = (K + kBN - 1) / kBN;
  const int tiles = n_ct * ((B + kVideos - 1) / kVideos);
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
  const CUtensorMap* xmap = &map_x;
  const CUtensorMap* wmap = &map_w;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int rt, ct;
        tile_coords(t, n_ct, rt, ct);
        hgemm::produce<kStages>(full, empty, ring, nk, kStageBytes,
                                [&](int s, uint64_t* bar, int kt) {
                                  unsigned char* st = smem + s * kStageBytes;
                                  hgemm::tma_3d(st, xmap, bar, kt * kDepth, 0, rt * kVideos);
                                  hgemm::tma_3d(st + kABytes, wmap, bar, kt * kDepth, ct * kBN, 0);
                                });
      }
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int r = lane >> 2;
    // Rows r and r + 8 of the warp's 16: frames s0 and s0 + 8 of video
    // 2 wg + warp / 2 of the tile.
    const int s0 = 16 * (warp & 1) + r;
    const bool live0 = s0 < S;
    const bool live1 = s0 + 8 < S;
    const int video = 2 * wg + (warp >> 1);
    const uint32_t a_off = wg * 64 * kDepth;
    int acc[kBN / 2];
    int iter = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++iter) {
      int rt, ct;
      tile_coords(t, n_ct, rt, ct);
      const int n0 = ct * kBN;
      hgemm::zero<kBN / 2>(acc);
      hgemm::consume<kStages, kBN / 2>(full, empty, ring, nk, acc, [&](int s) {
        const uint32_t st = hgemm::smem_u32(smem + s * kStageBytes);
#pragma unroll
        for (int kk = 0; kk < kDepth / 32; ++kk)
          hgemm::mma_u8s8_256(acc, hgemm::desc_a(st + a_off, kk), hgemm::desc_b_k(st + kABytes, kk));
      });

      // Epilogue. Each column's sums in the sign of its a_col (so that a
      // max picks the row the affine ranks highest), frames s >= S to
      // INT_MIN, the max of the thread's two rows; columns 8j + 2q + e
      // in v[2j + e]. The loads of a_col are unconditional (clamped to
      // column K - 1).
      int v[kBN / 4];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        const int m0 = neg_mask(__ldg(a_col + min(n, K - 1)));
        const int m1 = neg_mask(__ldg(a_col + min(n + 1, K - 1)));
        v[2 * j] = max(live0 ? signed_by(acc[4 * j], m0) : INT_MIN,
                       live1 ? signed_by(acc[4 * j + 2], m0) : INT_MIN);
        v[2 * j + 1] = max(live0 ? signed_by(acc[4 * j + 1], m1) : INT_MIN,
                           live1 ? signed_by(acc[4 * j + 3], m1) : INT_MIN);
      }
      // The max over the warp's 16 rows: lane l ends with columns
      // 32 (l / 4) + 8 t + 2q + e in v[2t + e], t < 4.
      fold<kBN / 8, 16>(v, lane);
      fold<kBN / 16, 8>(v, lane);
      fold<kBN / 32, 4>(v, lane);
      int* slot = pool + ((iter & 1) * kVideos + video) * kBN + 32 * r + 2 * q;
      if (warp & 1) {
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4)
          *reinterpret_cast<int2*>(slot + 8 * t4) = make_int2(v[2 * t4], v[2 * t4 + 1]);
      }
      hgemm::named_sync(1 + video, 64);
      const int b = rt * kVideos + video;
      if (!(warp & 1) && b < B) {
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4) {
          const int2 o = *reinterpret_cast<const int2*>(slot + 8 * t4);
          const int pair[2] = {max(v[2 * t4], o.x), max(v[2 * t4 + 1], o.y)};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 32 * r + 8 * t4 + 2 * q + e;
            const int nc = min(n, K - 1);
            const float a = __ldg(a_col + nc);
            const int x = signed_by(pair[e], neg_mask(a)) - 128 * __ldg(colsum8 + nc);
            const float y = __fadd_rn(__fmul_rn(__int2float_rn(x), a), __ldg(b_col + nc));
            if (n < K) out[static_cast<size_t>(b) * K + n] = fmaxf(y, 0.0f);
          }
        }
      }
    }
  }
}

bool bad_shape(int B, int S, int D, int K) {
  return B <= 0 || S <= 0 || S > kPitch || D <= 0 || D % 16 != 0 || K <= 0;
}

}  // namespace

// x [B, S, D] uint8 (D a multiple of 16, S <= 32); w8t [K, D] int8;
// colsum8 [K] int32, the column sums of w8; a_col, b_col [K] f32; out
// [B, K] f32.
extern "C" int yt8m_dbof_cluster_maxpool_int8(const void* x, const void* w8t, const void* colsum8,
                                              const void* a_col, const void* b_col, void* out,
                                              int B, int S, int D, int K, void* stream) {
  if (bad_shape(B, S, D, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_x, map_w;
  // x as [B, S, D]: a box is 4 videos x 32 frames x 128 bytes.
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S) * D};
  const uint32_t box[3] = {kDepth, kPitch, kVideos};
  err = hgemm::make_map(&map_x, x, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == cudaSuccess) err = hgemm::make_map_u8(&map_w, w8t, 1, K, D, D, kBN, kDepth);
  int sms = 0;
  if (err == cudaSuccess) err = hgemm::sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dbof_int8_cluster_maxpool,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemRequest);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((K + kBN - 1) / kBN) * ((B + kVideos - 1) / kVideos);
  dbof_int8_cluster_maxpool<<<tiles < sms ? tiles : sms, hgemm::kThreads, kSmemRequest, st>>>(
      map_x, map_w, static_cast<const int*>(colsum8), static_cast<const float*>(a_col),
      static_cast<const float*>(b_col), static_cast<float*>(out), B, S, D, K);
  return static_cast<int>(cudaGetLastError());
}

// The product's tile: [videos a tile, rows a video, clusters a tile,
// bytes of depth a stage, stages, shared bytes requested a block, SMs].
extern "C" int yt8m_dbof_int8_plan(int* plan) {
  int sms = 0;
  const cudaError_t err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = kVideos;
  plan[1] = kPitch;
  plan[2] = kBN;
  plan[3] = kDepth;
  plan[4] = kStages;
  plan[5] = kSmemRequest;
  plan[6] = sms;
  return static_cast<int>(cudaSuccess);
}
