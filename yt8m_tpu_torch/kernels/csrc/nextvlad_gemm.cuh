// The block product shared by the NeXtVLAD kernels (nextvlad.cu and
// nextvlad_train.cu), for Hopper (sm_90a).
//
// A block of 256 threads (8 warps, 2 along the rows x 4 along the
// columns) computes an f32 tile C[BM, BN] = A[BM, depth] B[depth, BN] on
// the tensor cores (wmma 16 x 16 x 16, bf16 operands, f32 fragments in
// registers), stepping the depth 32 at a time through a 3-stage ring of
// shared-memory tiles filled with cp.async. Each operand tile is stored
// as it lies in device memory: A row-major (A[m][k]) or, with A_COL, as
// its transpose At[k][m]; B row-major (B[k][n]) or, with B_COL, as
// Bt[n][k]. The caller's source functors give the address of each
// 16-byte chunk (8 bf16) of a stage, or mark it as zeros: ragged edges,
// frames past num_frames and padding are zero-filled, never read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace nxv {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;
constexpr int kStages = 3;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Eight f32 values from shared memory, rounded to bf16, as one 16-byte
// store.
__device__ __forceinline__ void store8_bf16(bf16* dst, const float* s) {
  uint4 v;
  v.x = pack_bf16(s[0], s[1]);
  v.y = pack_bf16(s[2], s[3]);
  v.z = pack_bf16(s[4], s[5]);
  v.w = pack_bf16(s[6], s[7]);
  *reinterpret_cast<uint4*>(dst) = v;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ int live_frames(const int* num_frames, int b, int F) {
  return min(max(num_frames[b], 0), F);
}

__device__ __forceinline__ void unpack8_bf16(const uint4& q, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The live frames of all videos packed one after another: row_off[b] is
// the first packed row of video b (row_off[B] the count). The video of
// packed row r, skipping videos with no live frame.
__device__ __forceinline__ int video_of(const int* row_off, int B, int r) {
  int lo = 0;
  int hi = B;  // row_off[lo] <= r < row_off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (row_off[mid] <= r) lo = mid;
    else hi = mid;
  }
  return lo;
}

// s_row[i] = b * F + f of packed row r0 + i, or -1 past the last live
// row; ends with the block synchronised.
template <int ROWS>
__device__ __forceinline__ void packed_rows(const int* row_off, int B, int F, int r0, int* s_row) {
  const int total = row_off[B];
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x) {
    const int r = r0 + i;
    int v = -1;
    if (r < total) {
      const int b = video_of(row_off, B, r);
      v = b * F + (r - row_off[b]);
    }
    s_row[i] = v;
  }
  __syncthreads();
}

template <int BM, int BN, bool A_COL, bool B_COL>
struct BlockMma {
  static constexpr int kLdA = A_COL ? BM + 8 : kBK + 8;  // bf16 elements
  static constexpr int kStageA = A_COL ? kBK * kLdA : BM * kLdA;
  static constexpr int kLdB = B_COL ? kBK + 8 : BN + 8;
  static constexpr int kStageB = B_COL ? BN * kLdB : kBK * kLdB;
  static constexpr int kPipeBytes = kStages * (kStageA + kStageB) * 2;
  static constexpr int kWN = 4;
  static constexpr int kTM = BM / 2;    // a warp's rows
  static constexpr int kTN = BN / kWN;  // a warp's columns
  static constexpr int FM = kTM / 16;
  static constexpr int FN = kTN / 16;
  static constexpr int kLdS = BN + 4;   // the f32 staging tile
  static constexpr int kStagingBytes = BM * kLdS * 4;
  static constexpr int kBytes = kPipeBytes > kStagingBytes ? kPipeBytes : kStagingBytes;
  static_assert(FM * 16 == kTM && FN * 16 == kTN, "tile not whole fragments");

  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  using LayoutA = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;

  // The copies of one stage into ring slot `slot`. src_a(r, c, ok) and
  // src_b(r, c, ok) map the chunk at row r, column c (a multiple of 8) of
  // the tile as stored to its address, with ok = false for zeros (the
  // address is then not read).
  template <class SrcA, class SrcB>
  __device__ static void load(bf16* sA, bf16* sB, int slot, SrcA src_a, SrcB src_b) {
    constexpr int a_cols = (A_COL ? BM : kBK) / 8;
    constexpr int b_cols = (B_COL ? kBK : BN) / 8;
    constexpr int a_chunks = BM * kBK / 8;
    constexpr int b_chunks = BN * kBK / 8;
#pragma unroll
    for (int c = threadIdx.x; c < a_chunks; c += kThreads) {
      const int r = c / a_cols;
      const int col = (c % a_cols) * 8;
      bool ok;
      const bf16* src = src_a(r, col, ok);
      cp_async16(sA + slot * kStageA + r * kLdA + col, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int c = threadIdx.x; c < b_chunks; c += kThreads) {
      const int r = c / b_cols;
      const int col = (c % b_cols) * 8;
      bool ok;
      const bf16* src = src_b(r, col, ok);
      cp_async16(sB + slot * kStageB + r * kLdB + col, src, ok ? 16 : 0);
    }
  }

  // acc = the product over `nsteps` depth steps; load(slot, step) issues
  // a stage's copies (in step order). Ends with the ring drained and the
  // block synchronised.
  template <class Load>
  __device__ static void run(Acc (&acc)[FM][FN], const bf16* sA, const bf16* sB, int nsteps,
                             Load load) {
    const int warp = threadIdx.x >> 5;
    const int wm = warp / kWN;
    const int wn = warp % kWN;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nsteps) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nsteps; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int next = kt + kStages - 1;
      if (next < nsteps) load(next % kStages, next);
      cp_async_commit();
      const int slot = kt % kStages;
      const bf16* tA = sA + slot * kStageA;
      const bf16* tB = sB + slot * kStageB;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          const int m = wm * kTM + i * 16;
          wmma::load_matrix_sync(fa[i], A_COL ? tA + kk * kLdA + m : tA + m * kLdA + kk, kLdA);
        }
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const int n = wn * kTN + j * 16;
          wmma::load_matrix_sync(fb[j], B_COL ? tB + n * kLdB + kk : tB + kk * kLdB + n, kLdB);
        }
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // The accumulators into the f32 staging tile S[BM][kLdS].
  __device__ static void store(Acc (&acc)[FM][FN], float* S) {
    const int warp = threadIdx.x >> 5;
    const int wm = warp / kWN;
    const int wn = warp % kWN;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(S + (wm * kTM + i * 16) * kLdS + wn * kTN + j * 16, acc[i][j],
                                kLdS, wmma::mem_row_major);
  }
};

// Sets a kernel's dynamic shared memory and returns the CUDA error.
template <class Kernel>
inline cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace nxv
