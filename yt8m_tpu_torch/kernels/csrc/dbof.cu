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
// so the bound is the bf16 tensor-core rate.
//
// Design. Two launches on the caller's stream:
//  1. input_affine (input_affine.cuh): xa = bf16(x * in_scale + in_bias)
//     for every sampled frame, once, into a [B*S, D] bf16 buffer from the
//     wrapper.
//     This is the TPU kernel's "dequant + affine once per video block":
//     fused into the product it would run once per 128-cluster tile, 64
//     times over, and cost as many instructions as the tensor cores.
//     The sampled variant (dbof_sampled_input_affine) reads row idx[b, s]
//     of the full frames [B, F, D] of video b, and a zero frame for an
//     index outside [0, F), as the TPU kernel's one-hot select does.
//  2. dbof_cluster_maxpool: a bf16 GEMM whose epilogue is the BN affine,
//     the ReLU and the max over frames. A block computes 8 videos x 128
//     clusters; each warp holds two videos' 64 rows (S padded to 32 per
//     video, the padding rows zero-filled) x 64 clusters in WMMA
//     accumulators — a 64 x 64 warp tile, so each fragment read from
//     shared memory feeds four products (shared-memory bandwidth, not the
//     tensor cores, limited a 32 x 64 warp tile). The [B*S, K]
//     activations never reach device memory: the block writes [8, 128]
//     pooled values. Padded rows (s >= S) are masked out of the max: a
//     zero row would give relu(act_bias), which can exceed every real
//     row. Tiles of xa and W stream through a 3-stage cp.async ring.
// This is the simple first kernel: wmma fragments, not wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "input_affine.cuh"

using namespace nvcuda;

namespace {

constexpr int kVideos = 8;           // videos per block (two per warp)
constexpr int kRowsPerVideo = 32;    // S padded to 32
constexpr int kBM = kVideos * kRowsPerVideo;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;        // bf16 elements per smem row of A
constexpr int kLdB = kBN + 8;        // bf16 elements per smem row of B
constexpr int kLdS = 16 + 4;         // floats per row of the epilogue stage
constexpr int kStageA = kBM * kLdA;  // elements per ring slot
constexpr int kStageB = kBK * kLdB;
constexpr int kSmemBytes = kStages * (kStageA + kStageB) * 2;
static_assert(8 * 64 * kLdS * 4 <= kSmemBytes, "epilogue stage must fit");

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

// 16-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads, 1)
dbof_cluster_maxpool_kernel(const __nv_bfloat16* __restrict__ xa,
                            const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ act_scale,
                            const float* __restrict__ act_bias, float* __restrict__ out,
                            int B, int S, int D, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kStages * kStageA;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;  // videos 2*wm, 2*wm+1 of the block
  const int wn = warp & 1;   // which 64 of the block's 128 clusters
  const int n0 = blockIdx.x * kBN;
  const int b0 = blockIdx.y * kVideos;

  // A: 256 rows x 32 bf16 = 4 x 16 B per row; each thread copies 4.
  // B: 32 rows x 128 bf16 = 16 x 16 B per row; each thread copies 2.
  const __nv_bfloat16* a_src[4];
  int a_dst[4], a_bytes[4];
  const __nv_bfloat16* b_src[2];
  int b_dst[2], b_bytes[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int seg = tid + j * kThreads;
    const int row = seg >> 2;
    const int col = (seg & 3) * 8;
    const int b = b0 + row / kRowsPerVideo;
    const int s = row % kRowsPerVideo;
    const bool ok = b < B && s < S;
    a_src[j] = xa + (static_cast<size_t>(ok ? b : 0) * S + (ok ? s : 0)) * D + col;
    a_dst[j] = row * kLdA + col;
    a_bytes[j] = ok ? 16 : 0;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int seg = tid + j * kThreads;
    const int brow = seg >> 4;
    const int bcol = (seg & 15) * 8;
    const bool bok = n0 + bcol < K;
    b_src[j] = w + static_cast<size_t>(brow) * K + (bok ? n0 + bcol : 0);
    b_dst[j] = brow * kLdB + bcol;
    b_bytes[j] = bok ? 16 : 0;
  }
  auto load_stage = [&](int slot, int kt) {
    const int d0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cp_async16(sA + slot * kStageA + a_dst[j], a_src[j] + d0, a_bytes[j]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      cp_async16(sB + slot * kStageB + b_dst[j], b_src[j] + static_cast<size_t>(d0) * K,
                 b_bytes[j]);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = D / kBK;
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
    const __nv_bfloat16* tA = sA + slot * kStageA;
    const __nv_bfloat16* tB = sB + slot * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], tA + (wm * 64 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], tB + kk * kLdB + wn * 64 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: per warp, one 64-row x 16-cluster strip at a time through
  // shared memory; lanes 0-15 take the first video's 32 rows and lanes
  // 16-31 the second's, one cluster per lane.
  float* stage = reinterpret_cast<float*>(smem) + warp * 64 * kLdS;
  const int col = lane & 15;
  const int v = lane >> 4;
  const int b = b0 + wm * 2 + v;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::store_matrix_sync(stage + i * 16 * kLdS, acc[i][j], kLdS, wmma::mem_row_major);
    __syncwarp();
    const int n = n0 + wn * 64 + j * 16 + col;
    if (n < K && b < B) {
      const float sc = act_scale[n];
      const float bi = act_bias[n];
      const float* rows = stage + v * kRowsPerVideo * kLdS + col;
      float m = -INFINITY;
      for (int s = 0; s < S; ++s) m = fmaxf(m, affine(rows[s * kLdS], sc, bi));
      out[static_cast<size_t>(b) * K + n] = fmaxf(m, 0.0f);
    }
    __syncwarp();
  }
}

bool bad_shape(int B, int S, int D, int K) {
  return B <= 0 || S <= 0 || S > kRowsPerVideo || D <= 0 || D % kBK != 0 || K <= 0 || K % 8 != 0;
}

// Launch 2 over the affined rows xa [B*S, D].
int launch_gemm(const void* xa, const void* w, const void* act_scale, const void* act_bias,
                void* out, int B, int S, int D, int K, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dbof_cluster_maxpool_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + kBN - 1) / kBN, (B + kVideos - 1) / kVideos);
  dbof_cluster_maxpool_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(xa), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(act_scale), static_cast<const float*>(act_bias),
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
  return launch_gemm(xa, w, act_scale, act_bias, out, B, S, D, K, st);
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
  return launch_gemm(xa, w, act_scale, act_bias, out, B, S, D, K, st);
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
