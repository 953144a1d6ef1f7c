// Trainable LSTM recurrence for Hopper (sm_90a): the reverse-time backward
// that emits dZ. (The forward with residuals is lstm.cu's persistent
// kernel with its Residuals flag: yt8m_lstm_train_forward.)
//
// Replaces yt8m_tpu/kernels/lstm_train.py :: lstm_recurrence_trainable
// (its forward pallas_call at :119 and its backward at :272).
//
// Backward, steps t = F-1 .. 0 (BPTT of the TF1 BasicLSTMCell, the forget
// bias folded into the saved sigmoid f):
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
// 2 H 4H a live (video, step) pair (322 GFLOP a layer at B=256, F=300,
// H=1024 with half the pairs live, 0.33 ms at the bf16 peak), against
// ~1.7 GB of residuals, dout and dZ (0.52 ms at 3.35 TB/s): the bytes,
// behind the serial chain of F steps.
//
// Design: recurrence_persist.cuh, one cooperative launch a call, rows in
// the forward's live-row order. A unit tile is W_h's rows of 16 units,
// [16, 4H] bf16 (128 KB at H=1024, resident): the B operand of dh =
// dZ_{t+1} @ W_h^T over the tile's units, read with plain ldmatrix. A warp
// multiplies a 32-row chunk of dZ_{t+1} (depth 4H through its ring of
// 64-deep stages) and each thread then computes the four gate columns of
// dZ_t of the cells whose dh it holds. One barrier a step among a row
// group's blocks: the next step's product reads dZ_t of every unit.
//   * Rows: step t computes the rows live at t (the prefix live[t] of the
//     order); of those, the rows also live at t+1 take dh from the
//     product, the others (turning live at t, forward only) from the
//     carry. A row live at t+1 but not at t (reverse only) would carry dh
//     into the initial state alone, which no caller reads: it is skipped.
//   * Frozen steps (backward_frozen_steps, before the first step): dZ = 0
//     there, and, forward, the row's bf16(dout_t) of its frozen steps
//     added to the dh carry one at a time, t = F-1 down, as the steps
//     would add them; dc passes them unchanged.
// The dh and dc carries live in f32 [B, H] buffers, each element read and
// written by the one thread that owns its (row, unit) at every step.

#include "recurrence_persist.cuh"

namespace {

using namespace persist;

constexpr int kGates = 4;
constexpr int kCols = kGates * kUnits;  // the forward's tile columns: the same bytes

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float one_minus(float a) { return __fsub_rn(1.0f, a); }

struct LstmBwdArgs {
  const __nv_bfloat16* dout;   // [F, B, H]
  const __nv_bfloat16* gates;  // [F, B, 4H]
  const __nv_bfloat16* cs;     // [F, B, H]
  const int* num_frames;       // [B]
  const int* order;            // [B] rows by num_frames, descending
  const int* live;             // [F] live rows at each step
  const __nv_bfloat16* wh;     // [H, 4H]
  float* dh;                   // [B, H] final h's cotangent in, the carry
  float* dc;                   // [B, H] final c's cotangent in, the carry
  __nv_bfloat16* dz;           // [F, B, 4H]
  unsigned int* barrier;       // a counter a row group, 0 at launch
  int F, B, H;
  int reverse;
  BwdPlan plan;
  int skip_work;  // 1: barriers and schedule only (measures the barriers)
};

// One backward step t of one unit tile (units j0 ..): the row group's
// chunks of the n rows live at t, a ring warp a chunk, in rounds of
// ring_warps; the first np of them take dh from the product.
__device__ __forceinline__ void lstm_bwd_tile_step(const LstmBwdArgs& a, int t, int n, int np,
                                                   int mine, int j0, int group, uint32_t w_tile,
                                                   uint32_t ring, int kw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = a.H;
  const size_t G = 4 * static_cast<size_t>(H);
  const size_t step_h = static_cast<size_t>(a.B) * H;
  const __nv_bfloat16* dz_next = a.dz + (t + 1) * 4 * step_h;  // read only when np > 0
  const __nv_bfloat16* dout_t = a.dout + t * step_h;
  const __nv_bfloat16* gates_t = a.gates + t * 4 * step_h;
  const __nv_bfloat16* cs_t = a.cs + t * step_h;
  const __nv_bfloat16* cs_p = t > 0 ? a.cs + (t - 1) * step_h : nullptr;
  __nv_bfloat16* dz_t = a.dz + t * 4 * step_h;
  const int rw = a.plan.ring_warps;
  for (int r0 = 0; r0 < mine; r0 += rw) {
    const bool mine_chunk = warp < rw && r0 + warp < mine;
    const int c = group + a.plan.p.groups * (r0 + warp);
    const ChunkRows rows = chunk_rows(a.order, c, mine_chunk ? n : 0);
    ChunkRows prow = rows;
    bool prod[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      prod[j] = c * kChunk + (lane >> 2) + 8 * j < np;
      prow.ok[j] = rows.ok[j] && prod[j];
    }
    // The cells' residuals, dout and carries, all loaded before the
    // product (this thread alone reads and writes the carries).
    __nv_bfloat162 dv[4][2], gv[4][2][4], cv[4][2], pv[4][2];
    float2 dhv[4][2], dcv[4][2];
    if (mine_chunk) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          if (!rows.ok[j]) continue;
          const size_t o = static_cast<size_t>(rows.b[j]) * H + j0 + hq * 8 + (lane & 3) * 2;
          const size_t og = static_cast<size_t>(rows.b[j]) * G + j0 + hq * 8 + (lane & 3) * 2;
          dv[j][hq] = *reinterpret_cast<const __nv_bfloat162*>(dout_t + o);
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gv[j][hq][g] = *reinterpret_cast<const __nv_bfloat162*>(gates_t + og +
                                                                    static_cast<size_t>(g) * H);
          cv[j][hq] = *reinterpret_cast<const __nv_bfloat162*>(cs_t + o);
          pv[j][hq] = cs_p != nullptr ? *reinterpret_cast<const __nv_bfloat162*>(cs_p + o)
                                      : __floats2bfloat162_rn(0.0f, 0.0f);
          dcv[j][hq] = *reinterpret_cast<const float2*>(a.dc + o);
          dhv[j][hq] = prod[j] ? make_float2(0.0f, 0.0f)
                               : *reinterpret_cast<const float2*>(a.dh + o);
        }
    }
    float acc[2][2][4];
    chunk_product_wt(acc, mine_chunk && c * kChunk < np, dz_next, static_cast<int>(G), prow,
                     static_cast<int>(G), ring, a.plan.stages, w_tile, !a.plan.p.resident, kw,
                     [&](int k0, int kn) { load_wt_tile(w_tile, a.wh, 4 * H, j0, k0, kn, kw); });
    if (!mine_chunk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!rows.ok[j]) continue;
      const int mi = j >> 1;
      const int hf = j & 1;
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int unit = j0 + hq * 8 + (lane & 3) * 2;
        float dz[4][2], dhn[2], dcn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float dh = prod[j] ? acc[mi][hq][hf * 2 + e] : (e ? dhv[j][hq].y : dhv[j][hq].x);
          dh = add(dh, e ? __high2float(dv[j][hq]) : __low2float(dv[j][hq]));
          const float dc = e ? dcv[j][hq].y : dcv[j][hq].x;
          const float si = e ? __high2float(gv[j][hq][0]) : __low2float(gv[j][hq][0]);
          const float tj = e ? __high2float(gv[j][hq][1]) : __low2float(gv[j][hq][1]);
          const float sf = e ? __high2float(gv[j][hq][2]) : __low2float(gv[j][hq][2]);
          const float so = e ? __high2float(gv[j][hq][3]) : __low2float(gv[j][hq][3]);
          const float c_t = e ? __high2float(cv[j][hq]) : __low2float(cv[j][hq]);
          const float c_p = e ? __high2float(pv[j][hq]) : __low2float(pv[j][hq]);
          const float tc = tanhf(c_t);
          dz[3][e] = mul(mul(mul(dh, tc), so), one_minus(so));
          const float dcf = add(dc, mul(mul(dh, so), one_minus(mul(tc, tc))));
          dz[0][e] = mul(mul(mul(dcf, tj), si), one_minus(si));
          dz[1][e] = mul(mul(dcf, si), one_minus(mul(tj, tj)));
          dz[2][e] = mul(mul(mul(dcf, c_p), sf), one_minus(sf));
          dhn[e] = dh;
          dcn[e] = mul(dcf, sf);
        }
        const size_t o = static_cast<size_t>(rows.b[j]) * H + unit;
        const size_t og = static_cast<size_t>(rows.b[j]) * G + unit;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          *reinterpret_cast<__nv_bfloat162*>(dz_t + og + static_cast<size_t>(g) * H) =
              __floats2bfloat162_rn(dz[g][0], dz[g][1]);
        *reinterpret_cast<float2*>(a.dh + o) = make_float2(dhn[0], dhn[1]);
        *reinterpret_cast<float2*>(a.dc + o) = make_float2(dcn[0], dcn[1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_persist_kernel(LstmBwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t w_tile = smem_u32(smem);
  const int H = a.H;
  const int K = 4 * H;
  const int w_bytes = a.plan.p.resident ? kUnits * K * 2 : kWBytes;
  const int warp = threadIdx.x >> 5;
  const uint32_t ring = smem_u32(smem + w_bytes) +
                        (warp < a.plan.ring_warps ? warp : 0) * a.plan.stages * kStageBytesT;
  const int lanes = a.plan.p.lanes;
  const int lane_id = blockIdx.x % lanes;
  const int group = blockIdx.x / lanes;
  const int groups = a.plan.p.groups;
  const int tiles = H / kUnits;
  const int kw = kWBytes / (kUnits * 2) < K ? kWBytes / (kUnits * 2) : K;

  if (a.plan.p.resident && !a.skip_work) {
    load_wt_tile(w_tile, a.wh, K, lane_id * kUnits, 0, K, K);
    cp_async_commit();
    cp_async_wait<0>();
  }
  if (!a.skip_work)
    backward_frozen_steps(a.order, a.num_frames, a.F, a.B, H, a.reverse, group, groups,
                          lane_id, lanes, a.dout, a.dh, a.dz, kGates, nullptr);
  __syncthreads();  // the weights, and the carries written by other threads
  unsigned int* barrier = a.barrier + group;
  unsigned int target = 0;
  for (int t = a.F - 1; t >= 0; --t) {
    const int n = __ldg(a.live + t);
    const int n_next = t + 1 < a.F ? __ldg(a.live + t + 1) : 0;
    const int np = n < n_next ? n : n_next;
    const int chunks = (n + kChunk - 1) / kChunk;
    const int mine = chunks > group ? (chunks - group + groups - 1) / groups : 0;
    for (int u = lane_id; u < tiles && !a.skip_work; u += lanes) {
      lstm_bwd_tile_step(a, t, n, np, mine, u * kUnits, group, w_tile, ring, kw);
    }
    if (t > 0) group_barrier(barrier, target, lanes);
  }
}

cudaError_t lstm_bwd_plan(int B, int H, BwdPlan* plan) {
  return make_bwd_plan(lstm_bwd_persist_kernel, B, H, kCols, plan);
}

}  // namespace

// The backward's launch plan at B rows and H units: [grid, lanes, groups,
// resident, shared bytes a block, ring warps, ring stages] into
// plan[0..6].
extern "C" int yt8m_lstm_train_plan(int B, int H, int* plan) {
  if (B <= 0 || H <= 0 || H % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdPlan p;
  const cudaError_t err = lstm_bwd_plan(B, H, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = p.p.grid;
  plan[1] = p.p.lanes;
  plan[2] = p.p.groups;
  plan[3] = p.p.resident;
  plan[4] = p.p.smem;
  plan[5] = p.ring_warps;
  plan[6] = p.stages;
  return static_cast<int>(cudaSuccess);
}

// Backward: dout [F, B, H], gates [F, B, 4H] and cs [F, B, H] bf16 (the
// forward's residuals); num_frames [B], order [B] and live [F] int32 (the
// forward's live-row schedule); wh [H, 4H] bf16; dh, dc [B, H] f32
// holding the cotangents of the final h and c on entry (the carries,
// scratch, on return); dz [F, B, 4H] bf16 out; barrier kMaxGroups uint32,
// 0. One cooperative launch on `stream`; skip_work = 1 runs the schedule
// and the barriers alone.
extern "C" int yt8m_lstm_train_backward(const void* dout, const void* gates, const void* cs,
                                        const void* num_frames, const void* order,
                                        const void* live, const void* wh, void* dh, void* dc,
                                        void* dz, void* barrier, int F, int B, int H,
                                        int reverse, int skip_work, void* stream) {
  if (F <= 0 || B <= 0 || H <= 0 || H % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  LstmBwdArgs a;
  cudaError_t err = lstm_bwd_plan(B, H, &a.plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.gates = static_cast<const __nv_bfloat16*>(gates);
  a.cs = static_cast<const __nv_bfloat16*>(cs);
  a.num_frames = static_cast<const int*>(num_frames);
  a.order = static_cast<const int*>(order);
  a.live = static_cast<const int*>(live);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.dh = static_cast<float*>(dh);
  a.dc = static_cast<float*>(dc);
  a.dz = static_cast<__nv_bfloat16*>(dz);
  a.barrier = static_cast<unsigned int*>(barrier);
  a.F = F;
  a.B = B;
  a.H = H;
  a.reverse = reverse;
  a.skip_work = skip_work;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lstm_bwd_persist_kernel),
                                    dim3(a.plan.p.grid), dim3(kThreads), args, a.plan.p.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
