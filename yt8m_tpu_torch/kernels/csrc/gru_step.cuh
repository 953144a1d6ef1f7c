// One GRU time step for Hopper (sm_90a): the trainable recurrence's
// forward (gru_train.cu), and the block product that the trainable
// backward (gru_train.cu) shares with it. The serving recurrence (gru.cu)
// is one persistent launch instead (recurrence_persist.cuh).
//
// Every step t runs (TF1 GRUCell)
//
//   r, u   = split(sigmoid(bf16(h) @ W_hg + xg_t + bg))        (f32 sums)
//   c      = tanh(bf16(r * h) @ W_hc + xc_t + bc)
//   h'     = u * h + (1 - u) * c
//   h      = h' where num_frames > orig_t, else unchanged
//   out[t] = bf16(h)
//
// and also writes the step's post-sigmoid gates bf16([r, u]) [B, 2H] and
// the candidate bf16(c) [B, H] for the backward.
//
// Design. The TPU kernel keeps W_hg and W_hc (6 MiB in bf16 at H=1024)
// resident in VMEM and runs both products of a step back to back. On
// Hopper the step is two launches: the candidate product needs r * h
// over all H units, and r comes out of the gate product, so every block's
// gate epilogue must be done before any block starts its candidate
// product, and the launch boundary is that grid-wide barrier.
//   (a) gru_gate_kernel: a block owns 64 batch rows x 32 hidden units and
//       computes the 64 columns of r and u for them (bf16 h = out[t-1],
//       the previous step's output, times the gathered W_hg columns); its
//       epilogue writes u (f32) and bf16(r * h) [B, H] with h the f32
//       state.
//   (b) gru_cand_kernel: a block owns 64 rows x 64 units of the candidate
//       (bf16(r * h) times W_hc's columns); its epilogue updates h in f32,
//       freezes it past num_frames and writes out[t] = bf16(h), the next
//       step's product operand.
// Both products are wmma bf16 with f32 sums over a 4-stage cp.async ring
// of 64-deep tiles (four warps, 32 x 32 each); W_hg and W_hc stream from
// the 50 MB L2, where they stay across steps. Each element of the f32
// state, u and bf16(r * h) is written by the one block that owns it. What
// this simple design pays: 2F launches a layer, and L2 re-reads of the
// weights (one per batch tile per step). A persistent kernel with a
// grid-wide barrier between the two products can remove the launches; the
// serving recurrence's does, and the trainable forward is the next to
// follow it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace gru_step {

using namespace nvcuda;

constexpr int kThreads = 128;  // four warps, 2 (rows) x 2 (columns)
constexpr int kRows = 64;      // batch rows a block
constexpr int kCols = 64;      // product columns a block
constexpr int kBK = 64;        // depth tile
constexpr int kStages = 4;
constexpr int kLdA = kBK + 8;
constexpr int kLdB = kCols + 8;  // [kBK][kCols] row-major or [kCols][kBK] column-major
static_assert(kBK == kCols, "one B stage shape serves both layouts");
constexpr int kStageA = kRows * kLdA;
constexpr int kStageB = kBK * kLdB;
constexpr int kLdS = kCols + 4;
constexpr int kSmem = kStages * (kStageA + kStageB) * 2;
static_assert(kRows * kLdS * 4 <= kSmem, "the product's f32 tile reuses the ring");
constexpr int kGateUnits = kCols / 2;  // units of r and of u a gate block

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float bf2f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ __nv_bfloat16 f2bf(float x) { return __float2bfloat16_rn(x); }

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

// The block's product tile, left in shared memory as f32 S[kRows][kLdS]
// (aliasing the ring; the caller reads it after this returns):
//
//   S = A[b0 : b0 + 64, 0 : K] @ Bop        (bf16 operands, f32 sums)
//
// A: bf16 rows of stride lda; rows at or past B read as zeros.
// kTransB false: Bop[k][n] = W[k * ldw + col(n)], the block's columns of
//   each of kGates gate blocks of width H: col(n) = (n / (64 / kGates)) * H
//   + j0 + n % (64 / kGates).
// kTransB true: Bop[k][n] = W[(j0 + n) * ldw + k]: the W rows of the
//   block's units read as a column-major operand (a product with W^T,
//   nothing transposed in memory).
// K, lda, ldw, H and j0 are multiples of 64 (j0 of 32 with two gates).
template <int kGates, bool kTransB>
__device__ __forceinline__ void block_product(const __nv_bfloat16* __restrict__ A, int lda,
                                              int K, const __nv_bfloat16* __restrict__ W,
                                              int ldw, int H, int j0, int b0, int B,
                                              unsigned char* smem) {
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kStages * kStageA;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  constexpr int kUnits = kCols / kGates;

  // Each operand's stage is 64 rows x 8 copies of 16 B: four a thread.
  const __nv_bfloat16* a_src[4];
  int a_dst[4], a_bytes[4];
  const __nv_bfloat16* b_src[4];
  int b_dst[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int seg = tid + j * kThreads;
    const int row = seg >> 3;
    const int col = (seg & 7) * 8;
    const bool ok = b0 + row < B;
    a_src[j] = A + static_cast<size_t>(ok ? b0 + row : 0) * lda + col;
    a_dst[j] = row * kLdA + col;
    a_bytes[j] = ok ? 16 : 0;
    b_dst[j] = row * kLdB + col;
    if constexpr (kTransB) {
      b_src[j] = W + static_cast<size_t>(j0 + row) * ldw + col;  // unit row, depth col
    } else {
      const int g = col / kUnits;
      b_src[j] = W + static_cast<size_t>(row) * ldw + static_cast<size_t>(g) * H + j0 +
                 col % kUnits;  // depth row, product col
    }
  }
  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cp_async16(sA + slot * kStageA + a_dst[j], a_src[j] + k0, a_bytes[j]);
      cp_async16(sB + slot * kStageB + b_dst[j],
                 kTransB ? b_src[j] + k0 : b_src[j] + static_cast<size_t>(k0) * ldw, 16);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[i][n], 0.0f);

  const int nk = K / kBK;
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], tA + (wm * 32 + i * 16) * kLdA + kk, kLdA);
      if constexpr (kTransB) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          wmma::load_matrix_sync(fb[n], tB + (wn * 32 + n * 16) * kLdB + kk, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n) wmma::mma_sync(acc[i][n], fa[i], fb[n], acc[i][n]);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          wmma::load_matrix_sync(fb[n], tB + kk * kLdB + wn * 32 + n * 16, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n) wmma::mma_sync(acc[i][n], fa[i], fb[n], acc[i][n]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* S = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      wmma::store_matrix_sync(S + (wm * 32 + i * 16) * kLdS + wn * 32 + n * 16, acc[i][n], kLdS,
                              wmma::mem_row_major);
  __syncthreads();
}

// (a) The gate product and its epilogue. Grid (H / 32, ceil(B / 64)).
__global__ void __launch_bounds__(kThreads)
gru_gate_kernel(const __nv_bfloat16* __restrict__ h_prev, const __nv_bfloat16* __restrict__ xg_t,
                const __nv_bfloat16* __restrict__ whg, const float* __restrict__ bg,
                const float* __restrict__ h_state, float* __restrict__ u_buf,
                __nv_bfloat16* __restrict__ rh_buf, __nv_bfloat16* __restrict__ gates_t, int B,
                int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int j0 = blockIdx.x * kGateUnits;
  const int b0 = blockIdx.y * kRows;
  block_product<2, false>(h_prev, H, H, whg, 2 * H, H, j0, b0, B, smem);
  const float* S = reinterpret_cast<const float*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = j0 + lane;
  const size_t G = 2 * static_cast<size_t>(H);
  const float br = bg[j];
  const float bu = bg[H + j];
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int b = b0 + r;
    if (b >= B) break;
    const __nv_bfloat16* x = xg_t + static_cast<size_t>(b) * G;
    // (h @ W_hg + xg_t) + bg, in the plain version's order.
    const float zr = __fadd_rn(__fadd_rn(S[r * kLdS + lane], bf2f(x[j])), br);
    const float zu = __fadd_rn(__fadd_rn(S[r * kLdS + kGateUnits + lane], bf2f(x[H + j])), bu);
    const float sr = sigmoid(zr);
    const float su = sigmoid(zu);
    const size_t o = static_cast<size_t>(b) * H + j;
    u_buf[o] = su;
    rh_buf[o] = f2bf(__fmul_rn(sr, h_state[o]));
    gates_t[static_cast<size_t>(b) * G + j] = f2bf(sr);
    gates_t[static_cast<size_t>(b) * G + H + j] = f2bf(su);
  }
}

// (b) The candidate product and the state update. Grid (H / 64,
// ceil(B / 64)).
__global__ void __launch_bounds__(kThreads)
gru_cand_kernel(const __nv_bfloat16* __restrict__ rh, const __nv_bfloat16* __restrict__ xc_t,
                const __nv_bfloat16* __restrict__ whc, const float* __restrict__ bc,
                const int* __restrict__ num_frames, const float* __restrict__ u_buf,
                float* __restrict__ h_state, __nv_bfloat16* __restrict__ out_t,
                __nv_bfloat16* __restrict__ cand_t, int B, int H, int orig_t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int j0 = blockIdx.x * kCols;
  const int b0 = blockIdx.y * kRows;
  block_product<1, false>(rh, H, H, whc, H, H, j0, b0, B, smem);
  const float* S = reinterpret_cast<const float*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int b = b0 + r;
    if (b >= B) break;
    const bool live = num_frames[b] > orig_t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = half * 32 + lane;
      const int j = j0 + n;
      const size_t o = static_cast<size_t>(b) * H + j;
      const float c = tanhf(__fadd_rn(__fadd_rn(S[r * kLdS + n], bf2f(xc_t[o])), bc[j]));
      const float h0 = h_state[o];
      const float u = u_buf[o];
      float h1 = __fadd_rn(__fmul_rn(u, h0), __fmul_rn(__fsub_rn(1.0f, u), c));
      if (!live) h1 = h0;  // past the video's last frame: freeze
      h_state[o] = h1;
      out_t[o] = f2bf(h1);
      cand_t[o] = f2bf(c);
    }
  }
}

// The forward over F steps on `stream`: xg [F, B, 2H], xc [F, B, H]
// bf16; h0 [B, H] bf16 (the first step's product operand); h [B, H] f32,
// the initial state on entry and the final state on return; u [B, H]
// f32 and rh [B, H] bf16 scratch (the last step's on return); out
// [F, B, H] bf16; gates [F, B, 2H] and cand [F, B, H] bf16. 2F
// launches.
inline int run_forward(const void* xg, const void* xc, const void* num_frames, const void* whg,
                const void* whc, const void* bg, const void* bc, const void* h0, void* h,
                void* u, void* rh, void* out, void* gates, void* cand, int F, int B, int H,
                int reverse, void* stream) {
  if (F <= 0 || B <= 0 || H <= 0 || H % kBK != 0 || (B + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gru_gate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gru_cand_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (B + kRows - 1) / kRows;
  const dim3 grid_gate(H / kGateUnits, row_tiles);
  const dim3 grid_cand(H / kCols, row_tiles);
  const size_t step_g = static_cast<size_t>(B) * 2 * H;
  const size_t step_h = static_cast<size_t>(B) * H;
  const __nv_bfloat16* xgp = static_cast<const __nv_bfloat16*>(xg);
  const __nv_bfloat16* xcp = static_cast<const __nv_bfloat16*>(xc);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  __nv_bfloat16* g = static_cast<__nv_bfloat16*>(gates);
  __nv_bfloat16* c = static_cast<__nv_bfloat16*>(cand);
  float* hs = static_cast<float*>(h);
  float* us = static_cast<float*>(u);
  __nv_bfloat16* rhs = static_cast<__nv_bfloat16*>(rh);
  for (int t = 0; t < F; ++t) {
    const __nv_bfloat16* h_prev =
        t == 0 ? static_cast<const __nv_bfloat16*>(h0) : o + (t - 1) * step_h;
    gru_gate_kernel<<<grid_gate, kThreads, kSmem, st>>>(
        h_prev, xgp + t * step_g, static_cast<const __nv_bfloat16*>(whg),
        static_cast<const float*>(bg), hs, us, rhs, g + t * step_g, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gru_cand_kernel<<<grid_cand, kThreads, kSmem, st>>>(
        rhs, xcp + t * step_h, static_cast<const __nv_bfloat16*>(whc),
        static_cast<const float*>(bc), static_cast<const int*>(num_frames), us, hs,
        o + t * step_h, c + t * step_h, B, H, reverse ? F - 1 - t : t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace gru_step
