// Trainable NetVLAD core for Hopper (sm_90a): a forward and a backward
// kernel.
//
// Replaces yt8m_tpu/kernels/netvlad_train.py :: netvlad_core (its forward
// pallas_call at :135, its backward at :189). Per video b, with
// n = min(num_frames[b], F) live frames:
//
//   assign[f, k] = softmax_k(act[f, :])   for f < n, else 0          (f32)
//   forward:  vlad[k, d] = sum_f bf16(assign[f, k]) bf16(x[f, d])  (f32 sums)
//                          - a_sum[k] centers[k, d]
//             a_sum[k]   = sum_f assign[f, k]              (unrounded f32)
//   backward: dassign[f, k] = sum_d bf16(x[f, d]) bf16(dvlad[k, d]) - cdot[k]
//             cdot[k]       = sum_d centers[k, d] dvlad[k, d]            (f32)
//             dact[f, k]    = assign[f, k] (dassign[f, k] - sum_k' assign dassign)
//             dx[f, d]      = sum_k bf16(assign[f, k]) bf16(dvlad[k, d])
//
// The operands of both products are rounded to bf16 whatever the model's
// compute dtype, as in the TPU kernel; the softmax, a_sum, cdot and the
// softmax VJP stay in f32. dcenters = -sum_b a_sum[b] (x) dvlad[b] is a
// plain reduction outside (the wrapper).
//
// What bounds it: at B=256, F=300, K=256, D=1152 the forward reads act
// (79 MB) and x (354 MB) and writes vlad (302 MB): 0.22 ms at 3.35 TB/s
// against 0.05 ms of bf16 products; the backward also reads dvlad and
// writes dact and dx (1.17 GB, 0.35 ms): device-memory bytes both ways.
//
// Design. One video's [F, K] assignment (300 KB in f32) exceeds a block's
// shared memory, and the softmax is per frame row, so both kernels tile
// over F and recompute the softmax rows they need; the assignment never
// reaches device memory (the TPU kernel keeps a whole video in VMEM
// instead).
//  * Forward, a block per (128 feature columns, video, 256 clusters):
//    for each tile of 32 live frames, the rows' max and sum over all K
//    (a warp a row), then bf16(assign) of the block's clusters and
//    bf16(x) of its columns into shared memory, and assign^T @ x on the
//    tensor cores (wmma, f32 fragments of a 256 x 128 tile in registers).
//    Each thread owns one cluster's a_sum, summed in frame order. The
//    blocks of one video run side by side, so their re-reads of act hit
//    L2.
//  * Backward, a cdot launch (a warp a cluster row), then a block per
//    (64 frames, video): dassign = x @ dvlad^T for the block's rows over
//    every cluster (K <= 512) into shared memory; then, a warp a row, the
//    softmax row, the row sum of assign * dassign and dact, with
//    bf16(assign) kept in shared memory; then dx = assign @ dvlad in
//    tiles of 128 columns (skipped when the caller needs no dx).
// Frames past n are never read: their tiles are zero-filled, and their
// dact and dx rows are written as zeros. Loads are plain (no cp.async
// pipeline), products wmma; TMA + wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClusters = 512;
constexpr int kClusterTile = 256;

// Forward tiles.
constexpr int kFwdRows = 32;   // frames a tile
constexpr int kFwdCols = 128;  // feature columns a block
constexpr int kFwdLdA = kClusterTile + 8;  // As[f][k], bf16
constexpr int kFwdLdX = kFwdCols + 8;      // Xs[f][d], bf16

// Backward tiles.
constexpr int kBwdRows = 64;  // frames a block
constexpr int kBK = 32;       // depth step of both products
constexpr int kLdXb = kBK + 8;   // Xs[f][d], 64 x 32 bf16
constexpr int kLdVb = kBK + 8;   // Vs[k][d], 256 x 32 bf16 (read as a column-major B)
constexpr int kDxCols = 128;
constexpr int kLdV2 = kDxCols + 8;  // V2[k][d], 32 x 128 bf16
constexpr int kXsBytes = kBwdRows * kLdXb * 2;
constexpr int kVsBytes = kClusterTile * kLdVb * 2;
constexpr int kV2Bytes = kBK * kLdV2 * 2;
constexpr int kStageBytes = kWarps * 16 * 16 * 4;
constexpr int kBufBytes = (kXsBytes + kVsBytes) > (kV2Bytes + kStageBytes)
                              ? (kXsBytes + kVsBytes)
                              : (kV2Bytes + kStageBytes);

__host__ __device__ inline int bwd_ld_s(int ktiles) { return ktiles * kClusterTile + 4; }
__host__ __device__ inline int bwd_ld_a(int ktiles) { return ktiles * kClusterTile + 8; }
// Dynamic shared memory of the backward: S f32 [64][ld_s], As bf16
// [64][ld_a], cdot f32 [ktiles * 256], then the product buffers.
__host__ __device__ inline int bwd_s_bytes(int ktiles) { return kBwdRows * bwd_ld_s(ktiles) * 4; }
__host__ __device__ inline int bwd_a_bytes(int ktiles) { return kBwdRows * bwd_ld_a(ktiles) * 2; }
__host__ __device__ inline int bwd_cdot_bytes(int ktiles) { return ktiles * kClusterTile * 4; }
inline int bwd_smem(int ktiles) {
  return bwd_s_bytes(ktiles) + bwd_a_bytes(ktiles) + bwd_cdot_bytes(ktiles) + kBufBytes;
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

// max and sum of exp(a - max) over one act row, in the warp.
__device__ __forceinline__ void softmax_row_stats(const float* row, int K, int lane, float& m,
                                                  float& s) {
  m = -INFINITY;
  for (int k = lane; k < K; k += 32) m = fmaxf(m, row[k]);
  m = warp_max(m);
  s = 0.0f;
  for (int k = lane; k < K; k += 32) s += expf(__fsub_rn(row[k], m));
  s = warp_sum(s);
}

__device__ __forceinline__ float softmax_value(float a, float m, float s) {
  return expf(__fsub_rn(a, m)) / s;
}

// Forward. Grid (ceil(D / 128), B, ceil(K / 256)). Warps 4 (clusters) x
// 2 (columns), a 64 x 64 tile each.
__global__ void __launch_bounds__(kThreads, 1)
vlad_core_fwd_kernel(const float* __restrict__ act, const float* __restrict__ x,
                     const int* __restrict__ num_frames, const float* __restrict__ centers,
                     float* __restrict__ vlad, float* __restrict__ a_sum, int F, int D, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[kFwdRows * kFwdLdA];
  __shared__ __align__(128) __nv_bfloat16 Xs[kFwdRows * kFwdLdX];
  __shared__ __align__(128) float stage[kWarps][16 * 16];
  __shared__ float s_max[kFwdRows];
  __shared__ float s_sum[kFwdRows];
  __shared__ float s_asum[kClusterTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int d0 = blockIdx.x * kFwdCols;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kClusterTile;
  const int live = min(max(num_frames[b], 0), F);
  const float* act_v = act + static_cast<size_t>(b) * F * K;
  const float* x_v = x + static_cast<size_t>(b) * F * D;
  const int kc = k0 + tid;  // this thread's cluster of the a_sum
  const bool k_ok = kc < K;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  float colsum = 0.0f;

  for (int f0 = 0; f0 < live; f0 += kFwdRows) {
    // The tile's softmax rows over all K; rows past n are not read.
    for (int r = warp; r < kFwdRows; r += kWarps) {
      float m = 0.0f, s = 1.0f;
      if (f0 + r < live) softmax_row_stats(act_v + static_cast<size_t>(f0 + r) * K, K, lane, m, s);
      if (lane == 0) {
        s_max[r] = m;
        s_sum[r] = s;
      }
    }
    __syncthreads();
    // bf16(assign) of the block's clusters; the f32 value into a_sum.
#pragma unroll 8
    for (int r = 0; r < kFwdRows; ++r) {
      const int f = f0 + r;
      float p = 0.0f;
      if (k_ok && f < live) p = softmax_value(act_v[static_cast<size_t>(f) * K + kc], s_max[r], s_sum[r]);
      colsum += p;
      As[r * kFwdLdA + tid] = __float2bfloat16_rn(p);
    }
    // bf16(x) of the block's columns; zeros past n and past D.
#pragma unroll 4
    for (int i = tid; i < kFwdRows * kFwdCols; i += kThreads) {
      const int r = i / kFwdCols;
      const int c = i % kFwdCols;
      const int f = f0 + r;
      const int d = d0 + c;
      float v = 0.0f;
      if (f < live && d < D) v = x_v[static_cast<size_t>(f) * D + d];
      Xs[r * kFwdLdX + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFwdRows; kk += 16) {
      // A[k, f] = As[f][k]: the assignment tile read column-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * kFwdLdA + wm * 64 + i * 16, kFwdLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Xs + kk * kFwdLdX + wn * 64 + j * 16, kFwdLdX);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  s_asum[tid] = colsum;
  if (blockIdx.x == 0 && k_ok) a_sum[static_cast<size_t>(b) * K + kc] = colsum;
  __syncthreads();

  // Epilogue through a per-warp 16 x 16 stage: vlad = sum - a_sum * centers,
  // multiply and subtract each rounded, as the plain version.
  float* st = stage[warp];
  const int sr = lane >> 1;
  const int sc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int kl = wm * 64 + i * 16 + sr;
      const int k = k0 + kl;
      if (k < K) {
        const float as = s_asum[kl];
        const float* cen = centers + static_cast<size_t>(k) * D;
        float* dst = vlad + (static_cast<size_t>(b) * K + k) * D;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int d = d0 + wn * 64 + j * 16 + sc + c;
          if (d < D) dst[d] = __fsub_rn(st[sr * 16 + sc + c], __fmul_rn(as, cen[d]));
        }
      }
      __syncwarp();
    }
  }
}

// cdot[b, k] = sum_d centers[k, d] * dvlad[b, k, d]. Grid (B); a warp a
// cluster row.
__global__ void __launch_bounds__(kThreads)
vlad_core_cdot_kernel(const float* __restrict__ centers, const float* __restrict__ dvlad,
                      float* __restrict__ cdot, int D, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  for (int k = warp; k < K; k += kWarps) {
    const float* c = centers + static_cast<size_t>(k) * D;
    const float* v = dvlad + (static_cast<size_t>(b) * K + k) * D;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = __fadd_rn(s, __fmul_rn(c[d], v[d]));
    s = warp_sum(s);
    if (lane == 0) cdot[static_cast<size_t>(b) * K + k] = s;
  }
}

// Backward. Grid (ceil(F / 64), B).
__global__ void __launch_bounds__(kThreads, 1)
vlad_core_bwd_kernel(const float* __restrict__ act, const float* __restrict__ x,
                     const int* __restrict__ num_frames, const float* __restrict__ dvlad,
                     const float* __restrict__ cdot, float* __restrict__ dact,
                     float* __restrict__ dx, int F, int D, int K, int need_dx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ktiles = (K + kClusterTile - 1) / kClusterTile;
  const int ld_s = bwd_ld_s(ktiles);
  const int ld_a = bwd_ld_a(ktiles);
  float* S = reinterpret_cast<float*>(smem);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + bwd_s_bytes(ktiles));
  float* s_cdot = reinterpret_cast<float*>(smem + bwd_s_bytes(ktiles) + bwd_a_bytes(ktiles));
  unsigned char* buf = smem + bwd_s_bytes(ktiles) + bwd_a_bytes(ktiles) + bwd_cdot_bytes(ktiles);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(buf);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(buf + kXsBytes);
  __nv_bfloat16* V2 = reinterpret_cast<__nv_bfloat16*>(buf);
  float* stage = reinterpret_cast<float*>(buf + kV2Bytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // 2 warps along the 64 rows
  const int wn = warp & 3;   // 4 along the columns
  const int f0 = blockIdx.x * kBwdRows;
  const int b = blockIdx.y;
  const int live = min(max(num_frames[b], 0), F);
  const int rows = min(kBwdRows, F - f0);
  const float* act_v = act + static_cast<size_t>(b) * F * K;
  const float* x_v = x + static_cast<size_t>(b) * F * D;
  const float* dv_v = dvlad + static_cast<size_t>(b) * K * D;
  float* dact_v = dact + static_cast<size_t>(b) * F * K;
  float* dx_v = need_dx ? dx + static_cast<size_t>(b) * F * D : nullptr;

  if (f0 >= live) {  // every row of the tile is past n: zeros, nothing read
    for (int i = tid; i < rows * K; i += kThreads) dact_v[static_cast<size_t>(f0) * K + i] = 0.0f;
    if (need_dx)
      for (int i = tid; i < rows * D; i += kThreads) dx_v[static_cast<size_t>(f0) * D + i] = 0.0f;
    return;
  }

  for (int k = tid; k < ktiles * kClusterTile; k += kThreads)
    s_cdot[k] = k < K ? cdot[static_cast<size_t>(b) * K + k] : 0.0f;

  // 1. dassign (before cdot) = bf16(x) @ bf16(dvlad)^T, 256 clusters at a
  //    time, into S. Warps 2 (rows) x 4 (clusters), a 32 x 64 tile each.
  for (int kt = 0; kt < ktiles; ++kt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int dd = 0; dd < D; dd += kBK) {
#pragma unroll
      for (int i = tid; i < kBwdRows * kBK; i += kThreads) {
        const int r = i / kBK;
        const int c = i % kBK;
        const int f = f0 + r;
        const int d = dd + c;
        float v = 0.0f;
        if (f < live && d < D) v = x_v[static_cast<size_t>(f) * D + d];
        Xs[r * kLdXb + c] = __float2bfloat16_rn(v);
      }
#pragma unroll 8
      for (int i = tid; i < kClusterTile * kBK; i += kThreads) {
        const int r = i / kBK;
        const int c = i % kBK;
        const int k = kt * kClusterTile + r;
        const int d = dd + c;
        float v = 0.0f;
        if (k < K && d < D) v = dv_v[static_cast<size_t>(k) * D + d];
        Vs[r * kLdVb + c] = __float2bfloat16_rn(v);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        // B[d, k] = Vs[k][d]: the dvlad tile read column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], Xs + (wm * 32 + i * 16) * kLdXb + kk, kLdXb);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], Vs + (wn * 64 + j * 16) * kLdVb + kk, kLdVb);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(S + (wm * 32 + i * 16) * ld_s + kt * kClusterTile + wn * 64 + j * 16,
                                acc[i][j], ld_s, wmma::mem_row_major);
  }
  __syncthreads();

  // 2. A warp a row: the softmax row, dassign -= cdot, the row sum of
  //    assign * dassign, dact, and bf16(assign) into As (zeros past n and
  //    past K, for the dx product).
  const int kpad = ktiles * kClusterTile;
  for (int r = warp; r < kBwdRows; r += kWarps) {
    const int f = f0 + r;
    __nv_bfloat16* arow = As + r * ld_a;
    if (f >= live) {
      for (int k = lane; k < kpad; k += 32) arow[k] = __float2bfloat16_rn(0.0f);
      if (f < F)
        for (int k = lane; k < K; k += 32) dact_v[static_cast<size_t>(f) * K + k] = 0.0f;
      continue;
    }
    const float* row = act_v + static_cast<size_t>(f) * K;
    float* srow = S + r * ld_s;
    float m, s;
    softmax_row_stats(row, K, lane, m, s);
    float t = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float p = softmax_value(row[k], m, s);
      const float da = __fsub_rn(srow[k], s_cdot[k]);
      srow[k] = da;
      arow[k] = __float2bfloat16_rn(p);
      t = __fadd_rn(t, __fmul_rn(p, da));
    }
    for (int k = K + lane; k < kpad; k += 32) arow[k] = __float2bfloat16_rn(0.0f);
    t = warp_sum(t);
    for (int k = lane; k < K; k += 32) {
      const float p = softmax_value(row[k], m, s);
      dact_v[static_cast<size_t>(f) * K + k] = __fmul_rn(p, __fsub_rn(srow[k], t));
    }
  }
  if (!need_dx) return;
  __syncthreads();

  // 3. dx = bf16(assign) @ bf16(dvlad), 128 columns at a time. Warps 2
  //    (rows) x 4 (columns), a 32 x 32 tile each.
  float* st = stage + warp * 256;
  const int sr = lane >> 1;
  const int sc = (lane & 1) * 8;
  for (int dt = 0; dt < D; dt += kDxCols) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int kb = 0; kb < K; kb += kBK) {
#pragma unroll 4
      for (int i = tid; i < kBK * kDxCols; i += kThreads) {
        const int r = i / kDxCols;
        const int c = i % kDxCols;
        const int k = kb + r;
        const int d = dt + c;
        float v = 0.0f;
        if (k < K && d < D) v = dv_v[static_cast<size_t>(k) * D + d];
        V2[r * kLdV2 + c] = __float2bfloat16_rn(v);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * ld_a + kb + kk, ld_a);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], V2 + kk * kLdV2 + wn * 32 + j * 16, kLdV2);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int f = f0 + wm * 32 + i * 16 + sr;
        if (f < F) {
          float* dst = dx_v + static_cast<size_t>(f) * D;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int d = dt + wn * 32 + j * 16 + sc + c;
            if (d < D) dst[d] = f < live ? st[sr * 16 + sc + c] : 0.0f;
          }
        }
        __syncwarp();
      }
    }
  }
}

bool shapes_ok(int B, int F, int D, int K) {
  return B > 0 && B <= 65535 && F > 0 && D > 0 && K > 0 && K <= kMaxClusters;
}

}  // namespace

// vlad [B, K, D] f32 and a_sum [B, K] f32 from act [B, F, K] f32, x [B, F,
// D] f32, num_frames [B] int32 and centers [K, D] f32.
extern "C" int yt8m_netvlad_core_forward(const void* act, const void* x, const void* num_frames,
                                         const void* centers, void* vlad, void* a_sum, int B,
                                         int F, int D, int K, void* stream) {
  if (!shapes_ok(B, F, D, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + kFwdCols - 1) / kFwdCols, B, (K + kClusterTile - 1) / kClusterTile);
  vlad_core_fwd_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(act), static_cast<const float*>(x),
      static_cast<const int*>(num_frames), static_cast<const float*>(centers),
      static_cast<float*>(vlad), static_cast<float*>(a_sum), F, D, K);
  return static_cast<int>(cudaGetLastError());
}

// dact [B, F, K] f32 and, when need_dx, dx [B, F, D] f32 from the forward's
// inputs and dvlad [B, K, D] f32; cdot [B, K] f32 is scratch from the
// caller.
extern "C" int yt8m_netvlad_core_backward(const void* act, const void* x, const void* num_frames,
                                          const void* centers, const void* dvlad, void* cdot,
                                          void* dact, void* dx, int B, int F, int D, int K,
                                          int need_dx, void* stream) {
  if (!shapes_ok(B, F, D, K) || (need_dx && dx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  vlad_core_cdot_kernel<<<B, kThreads, 0, st>>>(static_cast<const float*>(centers),
                                                static_cast<const float*>(dvlad),
                                                static_cast<float*>(cdot), D, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ktiles = (K + kClusterTile - 1) / kClusterTile;
  const int bytes = bwd_smem(ktiles);
  err = cudaFuncSetAttribute(vlad_core_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  vlad_core_bwd_kernel<<<dim3((F + kBwdRows - 1) / kBwdRows, B), kThreads, bytes, st>>>(
      static_cast<const float*>(act), static_cast<const float*>(x),
      static_cast<const int*>(num_frames), static_cast<const float*>(dvlad),
      static_cast<const float*>(cdot), static_cast<float*>(dact), static_cast<float*>(dx), F, D,
      K, need_dx);
  return static_cast<int>(cudaGetLastError());
}
