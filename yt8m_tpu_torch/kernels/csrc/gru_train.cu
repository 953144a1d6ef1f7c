// Trainable GRU recurrence for Hopper (sm_90a): forward with residuals
// and a reverse-time backward that emits dA_g and dA_c.
//
// Replaces yt8m_tpu/kernels/gru_train.py :: gru_recurrence_trainable
// (its forward pallas_call at :104 and its backward at :235).
//
// Forward: the serving step of gru_step.cuh, whose epilogues also write
// the post-sigmoid gates bf16([r, u]) [F, B, 2H] and the candidate
// bf16(c) [F, B, H].
//
// Backward, each step t = F-1 .. 0 (BPTT of the TF1 GRUCell, the dh
// carry in f32, hprev = outs[t-1] in bf16, 0 at t = 0):
//
//   dh    = dh_carry + bf16(dout_t)
//   da_u  = dh (hprev - c) u (1 - u)
//   da_c  = dh (1 - u) (1 - c^2)
//   drh   = bf16(da_c) @ W_hc^T
//   da_r  = drh hprev r (1 - r)
//   dA_g  = bf16([da_r, da_u]),  dA_c = bf16(da_c)   (0 where frozen)
//   dh_carry = live ? dh u + drh r + dA_g @ W_hg^T : dh
//
// with live = num_frames > orig_t. dW_hg = hprev^T dA_g, dW_hc =
// bf16(r hprev)^T dA_c, the bias gradients (sums of dA) and dxg = dA_g,
// dxc = dA_c are plain products outside the kernel.
//
// What bounds it: each direction's products are 2 F B H 3H (483 GFLOP a
// layer at B=256, F=300, H=1024, 0.49 ms at the bf16 peak); the forward
// moves ~1.10 GB (xg and xc read, outputs and residuals written; 0.33 ms
// at 3.35 TB/s), the backward ~1.26 GB (0.38 ms): the tensor-core rate.
//
// Design. Each step of the backward has two dependent products, as the
// forward has: drh needs da_c over all H units, and the dh carry needs
// dA_g over all 2H gate columns, which no block holds. So a step is two
// launches, all 2F from one C call (block shape and product as in
// gru_step.cuh; the W rows of a block's units are read as a column-major
// operand, so nothing is transposed in memory):
//   (a) gru_bptt_h_kernel (step t): dA_g[t+1] @ W_hg^T over the block's
//       64 units (depth 2H), then the carry, dh, da_u and da_c; writes
//       dh (f32), dA_c[t] and the u half of dA_g[t];
//   (b) gru_bptt_r_kernel (step t): dA_c[t] @ W_hc^T (depth H), then
//       da_r; writes the r half of dA_g[t] and drh (f32) for (a) of
//       step t-1.
// (b) multiplies the masked dA_c where the JAX kernel multiplies da_c
// before its mask: the two differ only on a frozen row, whose drh reaches
// nothing (da_r is masked there, and the carry is dh).

#include "gru_step.cuh"

namespace {

using namespace gru_step;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float one_minus(float a) { return __fsub_rn(1.0f, a); }

// (a) Grid (H / 64, ceil(B / 64)). dag_next and gates_next are null at
// t = F-1, hprev_t at t = 0.
__global__ void __launch_bounds__(kThreads)
gru_bptt_h_kernel(const __nv_bfloat16* __restrict__ dag_next,
                  const __nv_bfloat16* __restrict__ gates_next,
                  const __nv_bfloat16* __restrict__ whg, const __nv_bfloat16* __restrict__ dout_t,
                  const __nv_bfloat16* __restrict__ gates_t,
                  const __nv_bfloat16* __restrict__ cand_t,
                  const __nv_bfloat16* __restrict__ hprev_t, const int* __restrict__ num_frames,
                  const float* __restrict__ drh_state, float* __restrict__ dh_state,
                  __nv_bfloat16* __restrict__ dag_t, __nv_bfloat16* __restrict__ dac_t, int B,
                  int H, int orig_t, int orig_next) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int j0 = blockIdx.x * kCols;
  const int b0 = blockIdx.y * kRows;
  if (dag_next != nullptr) block_product<1, true>(dag_next, 2 * H, 2 * H, whg, 2 * H, H, j0, b0, B, smem);
  const float* S = reinterpret_cast<const float*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t G = 2 * static_cast<size_t>(H);
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int b = b0 + r;
    if (b >= B) break;
    const int n = num_frames[b];
    const bool live = n > orig_t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * 32 + lane;
      const int j = j0 + c;
      const size_t o = static_cast<size_t>(b) * H + j;
      const size_t og = static_cast<size_t>(b) * G + j;
      float dh = dh_state[o];  // dh of step t+1, or the final state's cotangent
      if (dag_next != nullptr && n > orig_next) {
        const float r1 = bf2f(gates_next[og]);
        const float u1 = bf2f(gates_next[og + H]);
        dh = add(add(mul(dh, u1), mul(drh_state[o], r1)), S[r * kLdS + c]);
      }
      dh = add(dh, bf2f(dout_t[o]));
      const float u = bf2f(gates_t[og + H]);
      const float cd = bf2f(cand_t[o]);
      const float hp = hprev_t != nullptr ? bf2f(hprev_t[o]) : 0.0f;
      const float da_u = mul(mul(mul(dh, sub(hp, cd)), u), one_minus(u));
      const float da_c = mul(mul(dh, one_minus(u)), one_minus(mul(cd, cd)));
      dag_t[og + H] = f2bf(live ? da_u : 0.0f);
      dac_t[o] = f2bf(live ? da_c : 0.0f);
      dh_state[o] = dh;
    }
  }
}

// (b) Grid (H / 64, ceil(B / 64)). hprev_t is null at t = 0.
__global__ void __launch_bounds__(kThreads)
gru_bptt_r_kernel(const __nv_bfloat16* __restrict__ dac_t, const __nv_bfloat16* __restrict__ whc,
                  const __nv_bfloat16* __restrict__ gates_t,
                  const __nv_bfloat16* __restrict__ hprev_t, const int* __restrict__ num_frames,
                  float* __restrict__ drh_state, __nv_bfloat16* __restrict__ dag_t, int B, int H,
                  int orig_t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int j0 = blockIdx.x * kCols;
  const int b0 = blockIdx.y * kRows;
  block_product<1, true>(dac_t, H, H, whc, H, H, j0, b0, B, smem);
  const float* S = reinterpret_cast<const float*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t G = 2 * static_cast<size_t>(H);
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int b = b0 + r;
    if (b >= B) break;
    const bool live = num_frames[b] > orig_t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * 32 + lane;
      const int j = j0 + c;
      const size_t o = static_cast<size_t>(b) * H + j;
      const float drh = S[r * kLdS + c];
      const float rr = bf2f(gates_t[static_cast<size_t>(b) * G + j]);
      const float hp = hprev_t != nullptr ? bf2f(hprev_t[o]) : 0.0f;
      const float da_r = mul(mul(mul(drh, hp), rr), one_minus(rr));
      dag_t[static_cast<size_t>(b) * G + j] = f2bf(live ? da_r : 0.0f);
      drh_state[o] = drh;
    }
  }
}

}  // namespace

// Forward: xg [F, B, 2H], xc [F, B, H] bf16; whg [H, 2H], whc [H, H]
// bf16; bg [2H], bc [H] f32; h0 [B, H] bf16 (the first step's product
// operand); h [B, H] f32, the initial state on entry and the final state
// on return; u [B, H] f32 and rh [B, H] bf16 scratch; out [F, B, H],
// gates [F, B, 2H] and cand [F, B, H] bf16. 2F launches on `stream`.
extern "C" int yt8m_gru_train_forward(const void* xg, const void* xc, const void* num_frames,
                                      const void* whg, const void* whc, const void* bg,
                                      const void* bc, const void* h0, void* h, void* u, void* rh,
                                      void* out, void* gates, void* cand, int F, int B, int H,
                                      int reverse, void* stream) {
  return gru_step::run_forward(xg, xc, num_frames, whg, whc, bg, bc, h0, h, u, rh, out, gates,
                               cand, F, B, H, reverse, stream);
}

// Backward: dout [F, B, H], gates [F, B, 2H], cand [F, B, H] and outs
// [F, B, H] bf16 (the forward's); whg [H, 2H], whc [H, H] bf16; dh
// [B, H] f32 holding the final h's cotangent on entry (the carry into
// step 0 on return); drh [B, H] f32 scratch; dag [F, B, 2H] and dac
// [F, B, H] bf16 out. 2F launches on `stream`, t = F-1 first.
extern "C" int yt8m_gru_train_backward(const void* dout, const void* gates, const void* cand,
                                       const void* outs, const void* num_frames, const void* whg,
                                       const void* whc, void* dh, void* drh, void* dag,
                                       void* dac, int F, int B, int H, int reverse,
                                       void* stream) {
  if (F <= 0 || B <= 0 || H <= 0 || H % kBK != 0 || (B + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gru_bptt_h_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gru_bptt_r_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H / kCols, (B + kRows - 1) / kRows);
  const size_t step_g = static_cast<size_t>(B) * 2 * H;
  const size_t step_h = static_cast<size_t>(B) * H;
  const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(dout);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(gates);
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(cand);
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(outs);
  const int* nf = static_cast<const int*>(num_frames);
  __nv_bfloat16* ag = static_cast<__nv_bfloat16*>(dag);
  __nv_bfloat16* ac = static_cast<__nv_bfloat16*>(dac);
  float* dhs = static_cast<float*>(dh);
  float* drhs = static_cast<float*>(drh);
  for (int t = F - 1; t >= 0; --t) {
    const bool last = t == F - 1;
    const __nv_bfloat16* hprev = t > 0 ? o + (t - 1) * step_h : nullptr;
    const int orig_t = reverse ? F - 1 - t : t;
    gru_bptt_h_kernel<<<grid, kThreads, kSmem, st>>>(
        last ? nullptr : ag + (t + 1) * step_g, last ? nullptr : g + (t + 1) * step_g,
        static_cast<const __nv_bfloat16*>(whg), d + t * step_h, g + t * step_g, c + t * step_h,
        hprev, nf, drhs, dhs, ag + t * step_g, ac + t * step_h, B, H, orig_t,
        reverse ? F - 2 - t : t + 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gru_bptt_r_kernel<<<grid, kThreads, kSmem, st>>>(
        ac + t * step_h, static_cast<const __nv_bfloat16*>(whc), g + t * step_g, hprev, nf, drhs,
        ag + t * step_g, B, H, orig_t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
