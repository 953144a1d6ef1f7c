// Trainable LSTM recurrence for Hopper (sm_90a): forward with residuals
// and a reverse-time backward that emits dZ.
//
// Replaces yt8m_tpu/kernels/lstm_train.py :: lstm_recurrence_trainable
// (its forward pallas_call at :119 and its backward at :272).
//
// Forward: the serving step of lstm_step.cuh, whose epilogue also writes
// the post-activation gates (sigmoid i, tanh j, sigmoid(f + 1), sigmoid
// o) as bf16 [F, B, 4H] and bf16(c_t) [F, B, H].
//
// Backward, one launch per step t = F-1 .. 0 (BPTT of the TF1
// BasicLSTMCell, the forget bias folded into the saved sigmoid f):
//
//   dh   = (t < F-1 and live(t+1) ? dZ_{t+1} @ W_h^T : dh_carry) + dout_t
//   dc   = dc_carry
//   do   = dh * tanh(c_t) * o (1 - o)
//   dc  += dh * o * (1 - tanh(c_t)^2)
//   di   = dc * j * i (1 - i);  dj = dc * i (1 - j^2);  df = dc * c_{t-1} * f (1 - f)
//   dZ_t = live(t) ? bf16([di, dj, df, do]) : 0
//   dh_carry = dh;  dc_carry = live(t) ? dc * f : dc
//
// with c_{-1} = 0, live(t) = num_frames > orig_t, and dout the upstream
// cotangent of the outputs rounded to bf16. A frozen step passes dh and dc
// through unchanged and emits dZ = 0. dW_h = H_prev^T dZ, db = sum dZ and
// dx_proj = dZ are plain products outside the kernel.
//
// What bounds it: the backward's products are those of the forward,
// 2 F B H 4H (644 GFLOP a layer at B=256, F=300, H=1024, 0.65 ms at the
// bf16 peak), against ~1.7 GB of residuals, dout and dZ (0.52 ms at
// 3.35 TB/s): the tensor-core rate, as in the forward.
//
// Design. dZ_t of one batch row needs dh_t over all H units, which no
// block holds, and W_h^T (8 MiB in bf16 at H=1024) does not fit a block:
// so, as in the forward, the step boundary is a launch boundary, all F
// launched from one C call. A block owns 128 batch rows x 32 hidden
// units: it forms dh[rows, units] = dZ_{t+1}[rows, 0:4H] @ W_h^T[:, units]
// (wmma bf16 products with f32 sums, depth 4H; the W_h rows of its units
// are read as a column-major B operand, so nothing is transposed in
// memory; the eight warps split the rows four ways and the depth two
// ways), then computes its units' four gate columns of dZ_t in the
// epilogue from the residuals. The dh and dc carries live in f32 [B, H]
// buffers, each element updated by the one block that owns it.

#include "lstm_step.cuh"

namespace {

using namespace nvcuda;
using lstm_step::cp_async16;
using lstm_step::cp_async_commit;
using lstm_step::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kRows = 128;   // batch rows a block
constexpr int kUnits = 32;   // hidden units a block
constexpr int kBK = 64;      // depth tile over 4H
constexpr int kStages = 4;
constexpr int kLdA = kBK + 8;
constexpr int kLdB = kBK + 8;  // W_h rows of the block's units, [32][kBK]
constexpr int kStageA = kRows * kLdA;
constexpr int kStageB = kUnits * kLdB;
constexpr int kLdP = kUnits + 4;
constexpr int kPipeBytes = kStages * (kStageA + kStageB) * 2;
constexpr int kEpiBytes = 2 * kRows * kLdP * 4;  // one partial product per depth half
constexpr int kSmem = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float one_minus(float a) { return __fsub_rn(1.0f, a); }

// One reverse step. Grid (H / 32, ceil(B / 128)). Warps 4 (rows) x 2
// (depth halves), a 32 x 32 warp tile each. dz_next is null at t = F-1,
// cs_prev at t = 0.
__global__ void __launch_bounds__(kThreads)
lstm_bptt_step_kernel(const __nv_bfloat16* __restrict__ dz_next,
                      const __nv_bfloat16* __restrict__ wh, const __nv_bfloat16* __restrict__ dout_t,
                      const __nv_bfloat16* __restrict__ gates_t,
                      const __nv_bfloat16* __restrict__ cs_t,
                      const __nv_bfloat16* __restrict__ cs_prev,
                      const int* __restrict__ num_frames, float* __restrict__ dh_state,
                      float* __restrict__ dc_state, __nv_bfloat16* __restrict__ dz_t, int B, int H,
                      int orig_t, int orig_next) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kStages * kStageA;
  float* P = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;
  const int wk = warp & 1;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const size_t G = 4 * static_cast<size_t>(H);

  if (dz_next != nullptr) {
    // A: 128 rows of dZ_{t+1} x 64 = 8 x 16 B a row, four copies a
    // thread; B: 32 W_h rows x 64 = 8 x 16 B a row, one copy a thread.
    const __nv_bfloat16* a_src[4];
    int a_dst[4], a_bytes[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int seg = tid + j * kThreads;
      const int row = seg >> 3;
      const int col = (seg & 7) * 8;
      const bool ok = b0 + row < B;
      a_src[j] = dz_next + static_cast<size_t>(ok ? b0 + row : 0) * G + col;
      a_dst[j] = row * kLdA + col;
      a_bytes[j] = ok ? 16 : 0;
    }
    const int brow = tid >> 3;
    const int bcol = (tid & 7) * 8;
    const __nv_bfloat16* b_src = wh + static_cast<size_t>(j0 + brow) * G + bcol;
    const int b_dst = brow * kLdB + bcol;
    auto load_stage = [&](int slot, int kt) {
      const int k0 = kt * kBK;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async16(sA + slot * kStageA + a_dst[j], a_src[j] + k0, a_bytes[j]);
      cp_async16(sB + slot * kStageB + b_dst, b_src + k0, 16);
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[i][n], 0.0f);

    const int nk = static_cast<int>(G / kBK);
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
      for (int kk = wk * 32; kk < wk * 32 + 32; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        // B[k][u] = W_h[j0 + u][k]: the block's W_h rows read column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], tA + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          wmma::load_matrix_sync(fb[n], tB + (n * 16) * kLdB + kk, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n) wmma::mma_sync(acc[i][n], fa[i], fb[n], acc[i][n]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wmma::store_matrix_sync(P + wk * kRows * kLdP + (wm * 32 + i * 16) * kLdP + n * 16,
                                acc[i][n], kLdP, wmma::mem_row_major);
    __syncthreads();
  }

  // Epilogue: each warp takes rows warp, warp + 8, ...; lane = unit.
  const int j = j0 + lane;
  for (int r = warp; r < kRows; r += 8) {
    const int b = b0 + r;
    if (b >= B) break;
    const size_t o = static_cast<size_t>(b) * H + j;
    const int n = num_frames[b];
    float dh = dh_state[o];
    if (dz_next != nullptr && n > orig_next)
      dh = __fadd_rn(P[r * kLdP + lane], P[kRows * kLdP + r * kLdP + lane]);
    dh = add(dh, __bfloat162float(dout_t[o]));
    const float dc = dc_state[o];
    const __nv_bfloat16* g = gates_t + static_cast<size_t>(b) * G + j;
    const float si = __bfloat162float(g[0]);
    const float tj = __bfloat162float(g[H]);
    const float sf = __bfloat162float(g[2 * static_cast<size_t>(H)]);
    const float so = __bfloat162float(g[3 * static_cast<size_t>(H)]);
    const float c_t = __bfloat162float(cs_t[o]);
    const float c_p = cs_prev != nullptr ? __bfloat162float(cs_prev[o]) : 0.0f;
    const float tc = tanhf(c_t);
    const float d_o = mul(mul(mul(dh, tc), so), one_minus(so));
    const float dcf = add(dc, mul(mul(dh, so), one_minus(mul(tc, tc))));
    const float d_i = mul(mul(mul(dcf, tj), si), one_minus(si));
    const float d_j = mul(mul(dcf, si), one_minus(mul(tj, tj)));
    const float d_f = mul(mul(mul(dcf, c_p), sf), one_minus(sf));
    const bool live = n > orig_t;
    __nv_bfloat16* dz = dz_t + static_cast<size_t>(b) * G + j;
    dz[0] = __float2bfloat16_rn(live ? d_i : 0.0f);
    dz[H] = __float2bfloat16_rn(live ? d_j : 0.0f);
    dz[2 * static_cast<size_t>(H)] = __float2bfloat16_rn(live ? d_f : 0.0f);
    dz[3 * static_cast<size_t>(H)] = __float2bfloat16_rn(live ? d_o : 0.0f);
    dh_state[o] = dh;
    dc_state[o] = live ? mul(dcf, sf) : dc;
  }
}

}  // namespace

// Forward: xp [F, B, 4H] bf16; h0 [B, H] bf16 (the first step's h); c, h
// [B, H] f32, the initial state on entry and the final state on return;
// out [F, B, H], gates [F, B, 4H] and cs [F, B, H] bf16.
extern "C" int yt8m_lstm_train_forward(const void* xp, const void* num_frames, const void* wh,
                                       const void* bias, const void* h0, void* c, void* h,
                                       void* out, void* gates, void* cs, int F, int B, int H,
                                       int reverse, void* stream) {
  return lstm_step::run_forward(xp, num_frames, wh, bias, h0, c, h, out, gates, cs, F, B, H,
                                reverse, stream);
}

// Backward: dout [F, B, H], gates [F, B, 4H] and cs [F, B, H] bf16; wh
// [H, 4H] bf16; dh, dc [B, H] f32 holding the cotangents of the final h
// and c on entry (the carries after step 0 on return); dz [F, B, 4H]
// bf16 out. Launches F step kernels on `stream`, t = F-1 first.
extern "C" int yt8m_lstm_train_backward(const void* dout, const void* gates, const void* cs,
                                        const void* num_frames, const void* wh, void* dh,
                                        void* dc, void* dz, int F, int B, int H, int reverse,
                                        void* stream) {
  if (F <= 0 || B <= 0 || H <= 0 || H % kUnits != 0 || (4 * H) % kBK != 0 ||
      (B + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(lstm_bptt_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H / kUnits, (B + kRows - 1) / kRows);
  const size_t step_g = static_cast<size_t>(B) * 4 * H;
  const size_t step_h = static_cast<size_t>(B) * H;
  const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(dout);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(gates);
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(cs);
  __nv_bfloat16* z = static_cast<__nv_bfloat16*>(dz);
  for (int t = F - 1; t >= 0; --t) {
    lstm_bptt_step_kernel<<<grid, kThreads, kSmem, st>>>(
        t < F - 1 ? z + (t + 1) * step_g : nullptr, static_cast<const __nv_bfloat16*>(wh),
        d + t * step_h, g + t * step_g, s + t * step_h, t > 0 ? s + (t - 1) * step_h : nullptr,
        static_cast<const int*>(num_frames), static_cast<float*>(dh), static_cast<float*>(dc),
        z + t * step_g, B, H, reverse ? F - 1 - t : t, reverse ? F - 2 - t : t + 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
