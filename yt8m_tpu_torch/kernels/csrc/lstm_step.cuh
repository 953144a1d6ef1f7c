// One LSTM time step for Hopper (sm_90a): the trainable recurrence's
// forward (lstm_train.cu). The serving recurrence (lstm.cu) is one
// persistent launch instead (recurrence_persist.cuh).
//
// Every step t runs
//
//   z      = bf16(h) @ bf16(W_h) + X'_t + bias              (f32 sums)
//   i,j,f,o = z[:, 0:H], z[:, H:2H], z[:, 2H:3H], z[:, 3H:4H]   (TF order)
//   c'     = c * sigmoid(f + 1) + sigmoid(i) * tanh(j)
//   h'     = tanh(c') * sigmoid(o)
//   (c, h) = (c', h') where num_frames > orig_t, else unchanged
//   out[t] = bf16(h)
//
// and also writes the step's post-activation gates (sigmoid i, tanh j,
// sigmoid(f + 1), sigmoid o) [B, 4H] and bf16(c) [B, H] for the
// backward.
//
// Design. The TPU kernel keeps W_h (8 MiB in bf16 at H=1024) resident in
// VMEM for the whole sequence; one Hopper SM has 227 KB of shared
// memory. So the recurrence is one launch per step, all F launched from
// one C call. A block owns 128 batch rows x 32 hidden units and computes
// the 128 columns g*H + j of all four gates for them (wmma bf16 products
// with f32 sums over a 4-stage cp.async ring of 64-deep tiles, three
// tiles, 107 KB, in flight while one is multiplied), so the cell update
// and the freeze run in the epilogue of the block's own product; the
// epilogue's X'_t, c and h tiles are copied to shared memory while the
// product runs. W_h streams from the 50 MB L2, where it stays resident
// across steps. The bf16 h the next step multiplies is out[t-1] itself;
// c and h in f32 are updated in place, each element by the one block
// that owns it. The step launches (F per layer) and the L2 re-reads of
// W_h (one per batch tile per step) are what this simple design pays; a
// persistent kernel with a grid-wide barrier between steps can remove
// the launches; the serving recurrence's persistent kernel does, and the
// trainable forward is the next to follow it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace lstm_step {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kRows = 128;   // batch rows a block
constexpr int kUnits = 32;   // hidden units a block, times four gates
constexpr int kCols = 4 * kUnits;
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr int kLdA = kBK + 8;
constexpr int kLdB = kCols + 8;
constexpr int kStageA = kRows * kLdA;
constexpr int kStageB = kBK * kLdB;
constexpr int kLdS = kCols + 4;
constexpr int kPipeBytes = kStages * (kStageA + kStageB) * 2;
constexpr int kEpiBytes = kRows * kLdS * 4;
constexpr int kMainBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;
// The step's X'_t tile [128 rows][4 gates x 32 units] bf16 and the c, h
// tiles [128][32] f32, copied in while the product runs.
constexpr int kCellBytes = kRows * kCols * 2 + 2 * kRows * kUnits * 4;
constexpr int kSmem = kMainBytes + kCellBytes;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

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

// One time step. Grid (H / 32, ceil(B / 128)). Warps 4 (rows) x 2
// (columns), a 32 x 64 warp tile each.
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const __nv_bfloat16* __restrict__ h_prev, const __nv_bfloat16* __restrict__ xp_t,
                 const __nv_bfloat16* __restrict__ wh, const float* __restrict__ bias,
                 const int* __restrict__ num_frames, float* __restrict__ c_state,
                 float* __restrict__ h_state, __nv_bfloat16* __restrict__ out_t,
                 __nv_bfloat16* __restrict__ gates_t, __nv_bfloat16* __restrict__ cs_t, int B,
                 int H, int orig_t) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kStages * kStageA;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const size_t G = 4 * static_cast<size_t>(H);

  // A: 128 rows of h x 64 = 8 x 16 B a row; B: 64 rows of W_h x (4 gates
  // x 32 units) = 16 x 16 B a row. Four copies of each a thread.
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
    a_src[j] = h_prev + static_cast<size_t>(ok ? b0 + row : 0) * H + col;
    a_dst[j] = row * kLdA + col;
    a_bytes[j] = ok ? 16 : 0;
    const int brow = seg >> 4;
    const int q = seg & 15;
    const int g = q >> 2;
    const int u = (q & 3) * 8;
    b_src[j] = wh + static_cast<size_t>(brow) * G + static_cast<size_t>(g) * H + j0 + u;
    b_dst[j] = brow * kLdB + g * kUnits + u;
  }
  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cp_async16(sA + slot * kStageA + a_dst[j], a_src[j] + k0, a_bytes[j]);
      cp_async16(sB + slot * kStageB + b_dst[j], b_src[j] + static_cast<size_t>(k0) * G, 16);
    }
  };

  // The cell update's inputs, in their own (oldest) cp.async group:
  // X'_t 128 rows x 4 gates x 64 B, c and h 128 rows x 128 B each.
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem + kMainBytes);
  float* sC = reinterpret_cast<float*>(smem + kMainBytes + kRows * kCols * 2);
  float* sH = sC + kRows * kUnits;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int seg = tid + j * kThreads;
    const int row = seg >> 4;
    const int g = (seg >> 2) & 3;
    const int u = (seg & 3) * 8;
    const bool ok = b0 + row < B;
    cp_async16(sX + row * kCols + g * kUnits + u,
               xp_t + static_cast<size_t>(ok ? b0 + row : 0) * G + static_cast<size_t>(g) * H +
                   j0 + u,
               ok ? 16 : 0);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int seg = tid + j * kThreads;
    const int row = seg >> 3;
    const int u = (seg & 7) * 4;
    const bool ok = b0 + row < B;
    const size_t o = static_cast<size_t>(ok ? b0 + row : 0) * H + j0 + u;
    cp_async16(sC + row * kUnits + u, c_state + o, ok ? 16 : 0);
    cp_async16(sH + row * kUnits + u, h_state + o, ok ? 16 : 0);
  }
  cp_async_commit();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = H / kBK;
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
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], tA + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], tB + kk * kLdB + wn * 64 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* S = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(S + (wm * 32 + i * 16) * kLdS + wn * 64 + j * 16, acc[i][j], kLdS,
                              wmma::mem_row_major);
  __syncthreads();

  // Cell update: each warp takes rows warp, warp + 8, ...; lane = unit.
  const int j = j0 + lane;
  const float bi = bias[j];
  const float bj = bias[H + j];
  const float bf = bias[2 * H + j];
  const float bo = bias[3 * H + j];
  for (int r = warp; r < kRows; r += 8) {
    const int b = b0 + r;
    if (b >= B) break;
    const __nv_bfloat16* x = sX + r * kCols + lane;
    const float* z = S + r * kLdS + lane;
    // (h @ W_h + X'_t) + bias, in the plain version's order.
    const float zi = __fadd_rn(__fadd_rn(z[0], __bfloat162float(x[0])), bi);
    const float zj = __fadd_rn(__fadd_rn(z[kUnits], __bfloat162float(x[kUnits])), bj);
    const float zf = __fadd_rn(__fadd_rn(z[2 * kUnits], __bfloat162float(x[2 * kUnits])), bf);
    const float zo = __fadd_rn(__fadd_rn(z[3 * kUnits], __bfloat162float(x[3 * kUnits])), bo);
    const size_t o = static_cast<size_t>(b) * H + j;
    const float c0 = sC[r * kUnits + lane];
    const float h0 = sH[r * kUnits + lane];
    const float si = sigmoid(zi);
    const float tj = tanhf(zj);
    const float sf = sigmoid(__fadd_rn(zf, 1.0f));
    const float so = sigmoid(zo);
    float c1 = __fadd_rn(__fmul_rn(c0, sf), __fmul_rn(si, tj));
    float h1 = __fmul_rn(tanhf(c1), so);
    if (num_frames[b] <= orig_t) {  // past the video's last frame: freeze
      c1 = c0;
      h1 = h0;
    }
    c_state[o] = c1;
    h_state[o] = h1;
    out_t[o] = __float2bfloat16_rn(h1);
    __nv_bfloat16* g = gates_t + static_cast<size_t>(b) * G + j;
    g[0] = __float2bfloat16_rn(si);
    g[H] = __float2bfloat16_rn(tj);
    g[2 * static_cast<size_t>(H)] = __float2bfloat16_rn(sf);
    g[3 * static_cast<size_t>(H)] = __float2bfloat16_rn(so);
    cs_t[o] = __float2bfloat16_rn(c1);
  }
}

// The forward over F steps on `stream`: xp [F, B, 4H] bf16; h0 [B, H]
// bf16 (the first step's h); c, h [B, H] f32, the initial state on
// entry and the final state on return; out [F, B, H] bf16; gates
// [F, B, 4H] and cs [F, B, H] bf16.
inline int run_forward(const void* xp, const void* num_frames, const void* wh, const void* bias,
                const void* h0, void* c, void* h, void* out, void* gates, void* cs, int F, int B,
                int H, int reverse, void* stream) {
  if (F <= 0 || B <= 0 || H <= 0 || H % kBK != 0 || (B + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(lstm_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H / kUnits, (B + kRows - 1) / kRows);
  const size_t step_in = static_cast<size_t>(B) * 4 * H;
  const size_t step_out = static_cast<size_t>(B) * H;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(xp);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  __nv_bfloat16* g = static_cast<__nv_bfloat16*>(gates);
  __nv_bfloat16* s = static_cast<__nv_bfloat16*>(cs);
  for (int t = 0; t < F; ++t) {
    const __nv_bfloat16* h_prev =
        t == 0 ? static_cast<const __nv_bfloat16*>(h0) : o + (t - 1) * step_out;
    lstm_step_kernel<<<grid, kThreads, kSmem, st>>>(
        h_prev, x + t * step_in, static_cast<const __nv_bfloat16*>(wh),
        static_cast<const float*>(bias), static_cast<const int*>(num_frames),
        static_cast<float*>(c), static_cast<float*>(h), o + t * step_out,
        g + t * step_in, s + t * step_out, B, H,
        reverse ? F - 1 - t : t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace lstm_step
