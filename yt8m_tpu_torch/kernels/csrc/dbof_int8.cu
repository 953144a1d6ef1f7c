// DBoF cluster + max-pool on the int8 tensor cores, for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/dbof.py :: dbof_cluster_maxpool_int8, the
// opt-in serving path (--dbof_int8_serving). For raw sampled frames
// x [B, S, D] uint8 and the constants that the wrapper's
// int8_serving_constants builds from the f32 cluster kernel and the
// folded affines (w8, per-column symmetric int8, here as its transpose
// w8t [K, D]; a_col, b_col [K] f32):
//
//   xi   = x XOR 0x80, as int8                 (x - 128, exact)
//   acc  = xi @ w8                             (int32, exact)
//   out  = max_s relu(f32(acc) * a_col + b_col)        [B, K] f32
//
// What bounds it: the product. At B=2048, S=30, D=1152, K=8192 it is
// 1.16 T int8 operations (0.586 ms at the card's 1,979 dense TOPS)
// against 71 MB of frames, 9.4 MB of w8 and 67 MB of output (0.044 ms),
// so the bound is the int8 tensor-core rate.
//
// Design: csrc/dbof.cu's two launches on the caller's stream.
//  1. dbof_int8_shift: xi = x ^ 0x80 for every sampled frame, once, into
//     a [B*S, D] int8 buffer from the wrapper (16 bytes a thread).
//  2. dbof_int8_cluster_maxpool: an int8 GEMM on mma.sync m16n8k32
//     (int8 operands, int32 sums in registers) whose epilogue converts
//     each sum to f32 (round to nearest, as the plain version's single
//     conversion), then multiplies by a_col and adds b_col unfused (the
//     plain version's two roundings), and takes the ReLU and the max over
//     the video's frames. Both operands lie k-contiguous (xi rows, w8t
//     rows), the layout the int8 mma takes, so ldmatrix loads both
//     fragments without a transpose. (A first design on wmma's 16 x 16 x
//     16 int8 fragments with w8 [D, K] ran no faster than the bf16
//     kernel: half the depth of the int8 mma an instruction, and a byte
//     transpose of each B fragment.) A block computes 8 videos x 128
//     clusters; each warp holds two videos' 64 rows (S padded to 32 a
//     video, the padding rows zero-filled) x 64 clusters in 128 int32
//     registers. Padded rows are masked out of the max: a zero int8 row
//     is the raw byte 128 and gives relu(b_col), which can exceed every
//     real row. The max over a video's 32 rows is taken in registers and
//     across the 8 lanes that share a column (shuffles), so the sums
//     never reach memory. Tiles of xi and w8t stream 128 bytes of depth a
//     stage through a 3-stage cp.async ring; rows are padded to 144 bytes
//     so that the 8 rows an ldmatrix reads fall in distinct banks.
// This is the simple first kernel: mma.sync, not wgmma/TMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "input_affine.cuh"

namespace {

constexpr int kVideos = 8;           // videos per block (two per warp)
constexpr int kRowsPerVideo = 32;    // S padded to 32
constexpr int kBM = kVideos * kRowsPerVideo;
constexpr int kBN = 128;
constexpr int kBK = 128;             // bytes of depth a stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kLd = kBK + 16;        // bytes per shared row (bank spread)
constexpr int kStageA = kBM * kLd;   // bytes per ring slot
constexpr int kStageB = kBN * kLd;
constexpr int kSmemBytes = kStages * (kStageA + kStageB);

// xi = x ^ 0x80 over n16 chunks of 16 bytes.
__global__ void __launch_bounds__(256)
dbof_int8_shift(const uint4* __restrict__ x, uint4* __restrict__ xi, size_t n16) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n16;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    uint4 q = __ldg(x + i);
    q.x ^= 0x80808080u;
    q.y ^= 0x80808080u;
    q.z ^= 0x80808080u;
    q.w ^= 0x80808080u;
    xi[i] = q;
  }
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 16-byte matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 32 int8, row) * b (32 x 8 int8, col), int32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Unfused multiply and add: the plain version's two roundings.
__device__ __forceinline__ float affine(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// xi [B*S, D] int8, w8t [K, D] int8, out [B, K] f32.
__global__ void __launch_bounds__(kThreads, 1)
dbof_int8_cluster_maxpool(const int8_t* __restrict__ xi, const int8_t* __restrict__ w8t,
                          const float* __restrict__ a_col, const float* __restrict__ b_col,
                          float* __restrict__ out, int B, int S, int D, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sA = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sB = sA + kStages * kStageA;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;  // videos 2*wm, 2*wm+1 of the block
  const int wn = warp & 1;   // which 64 of the block's 128 clusters
  const int n0 = blockIdx.x * kBN;
  const int b0 = blockIdx.y * kVideos;

  // A: 256 rows x 8 chunks of 16 bytes a stage; each thread copies 8.
  // B: 128 rows x 8 chunks; each thread copies 4. Thread t takes chunk
  // t % 8 of rows r + 32 j, r = t / 8: frame r of the block's video j,
  // cluster n0 + r + 32 j.
  const int chunk = (tid & 7) * 16;
  const int r = tid >> 3;
  const int8_t* a_src = xi + (static_cast<size_t>(b0) * S + r) * D + chunk;
  const size_t a_step = static_cast<size_t>(S) * D;  // one video
  const int8_t* b_src = w8t + static_cast<size_t>(n0 + r) * D + chunk;
  const size_t b_step = static_cast<size_t>(32) * D;  // 32 clusters
  const uint32_t dst = r * kLd + chunk;
  auto load_stage = [&](int slot, int kt) {
    const int d0 = kt * kBK;
    const bool in_depth = d0 + chunk < D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = in_depth && r < S && b0 + j < B;
      cp_async16(sA + slot * kStageA + dst + 32 * j * kLd, ok ? a_src + j * a_step + d0 : xi,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = in_depth && n0 + r + 32 * j < K;
      cp_async16(sB + slot * kStageB + dst + 32 * j * kLd, ok ? b_src + j * b_step + d0 : w8t,
                 ok ? 16 : 0);
    }
  };

  // ldmatrix lane addresses within a stage. A m-tile i: matrices (rows
  // 0-7, k 0-15), (rows 8-15, k 0-15), (rows 0-7, k 16-31), (rows 8-15,
  // k 16-31) = a0..a3. B n-tiles j, j+1: (n 0-7, k 0-15), (n 0-7, k
  // 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31) = b0, b1 of j, of j+1.
  const int lr = lane & 7;
  const int lm = lane >> 3;
  const uint32_t a_lane = (wm * 64 + lr + (lm & 1) * 8) * kLd + (lm >> 1) * 16;
  const uint32_t b_lane = (wn * 64 + lr + (lm >> 1) * 8) * kLd + (lm & 1) * 16;

  int acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int nk = (D + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) load_stage(next % kStages, next);
    cp_async_commit();
    const int slot = kt % kStages;
    const uint32_t tA = sA + slot * kStageA + a_lane;
    const uint32_t tB = sB + slot * kStageB + b_lane;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[4][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], tA + i * 16 * kLd + ks);
#pragma unroll
      for (int j = 0; j < 4; ++j) ldmatrix_x4(b[j], tB + j * 16 * kLd + ks);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_s8(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma_s8(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }
  cp_async_wait<0>();

  // Epilogue. Lane (g = lane / 4, t = lane % 4) holds, in m-tile i and
  // n-tile j, rows g and g + 8 of columns 2t and 2t + 1; m-tiles 0-1 are
  // the warp's first video (rows 0-31), 2-3 its second. The max over a
  // video's real rows (row < S) in registers, then across the 8 lanes of
  // a column (xor 4, 8, 16); lanes 0-3 write.
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int b = b0 + wm * 2 + v;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = n0 + wn * 64 + j * 8 + 2 * t + c;
        const float sc = n < K ? __ldg(a_col + n) : 0.0f;
        const float bi = n < K ? __ldg(b_col + n) : 0.0f;
        float m = -INFINITY;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int row = h * 16 + q * 8 + g;
            if (row < S) m = fmaxf(m, affine(acc[2 * v + h][j][2 * q + c], sc, bi));
          }
        }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        if (g == 0 && n < K && b < B) out[static_cast<size_t>(b) * K + n] = fmaxf(m, 0.0f);
      }
    }
  }
}

}  // namespace

// x [B, S, D] uint8 (D a multiple of 16, S <= 32); w8t [K, D] int8;
// xi: a work buffer of B*S*D bytes from the caller.
extern "C" int yt8m_dbof_cluster_maxpool_int8(const void* x, const void* w8t, const void* a_col,
                                              const void* b_col, void* xi, void* out, int B,
                                              int S, int D, int K, void* stream) {
  if (B <= 0 || S <= 0 || S > kRowsPerVideo || D <= 0 || D % 16 != 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n16 = static_cast<size_t>(B) * S * D / 16;
  dbof_int8_shift<<<inaff::blocks(n16), inaff::kThreads, 0, st>>>(static_cast<const uint4*>(x), static_cast<uint4*>(xi),
                                          n16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dbof_int8_cluster_maxpool,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + kBN - 1) / kBN, (B + kVideos - 1) / kVideos);
  dbof_int8_cluster_maxpool<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const int8_t*>(xi), static_cast<const int8_t*>(w8t),
      static_cast<const float*>(a_col), static_cast<const float*>(b_col),
      static_cast<float*>(out), B, S, D, K);
  return static_cast<int>(cudaGetLastError());
}
