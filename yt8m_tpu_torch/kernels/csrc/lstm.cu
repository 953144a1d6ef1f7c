// LSTM recurrence kernel for Hopper (sm_90a): serving, and the trainable
// forward (its Residuals instance).
//
// Replaces yt8m_tpu/kernels/lstm.py :: lstm_recurrence, and the forward
// pallas_call of yt8m_tpu/kernels/lstm_train.py :: lstm_recurrence_trainable
// (:119; the backward is lstm_train.cu). Given the input
// projection X' [F, B, 4H] (bf16, computed outside), every step t runs
//
//   z      = bf16(h) @ bf16(W_h) + X'_t + bias              (f32 sums)
//   i,j,f,o = z[:, 0:H], z[:, H:2H], z[:, 2H:3H], z[:, 3H:4H]   (TF order)
//   c'     = c * sigmoid(f + 1) + sigmoid(i) * tanh(j)
//   h'     = tanh(c') * sigmoid(o)
//   (c, h) = (c', h') where num_frames > orig_t, else unchanged
//   out[t] = bf16(h)
//
// with orig_t = F-1-t under `reverse` (X' comes flipped in time).
//
// What bounds it: per layer at B=512, F=300, H=1024 the products of the
// live (video, step) pairs are about 0.64 TFLOP (0.65 ms at the bf16
// peak, half the pairs live with num_frames uniform in 1..300) against
// about 0.95 GB of live X' and outputs (0.28 ms at 3.35 TB/s): the
// tensor-core rate, behind the serial chain of F steps.
//
// Design: recurrence_persist.cuh, one launch a call. A unit tile is 16
// units x 4 gates = 64 columns of W_h (128 KB at H=1024, resident); a warp
// multiplies a 32-row chunk of the live prefix by them, and each thread
// then updates the cells whose four gate sums it holds. One barrier a step
// among a row group's blocks: the next step's product reads out[t]
// of every unit. The Residuals instance (yt8m_lstm_train_forward) also
// stores, from the same thread's registers, the step's post-activation
// gates (sigmoid i, tanh j, sigmoid(f + 1), sigmoid o) [F, B, 4H] and
// bf16(c_t) [F, B, H] for the backward; at a row's frozen steps it writes
// gates 0 and c_t the frozen carry (write_frozen_steps).

#include "recurrence_persist.cuh"

namespace {

using namespace persist;

constexpr int kGates = 4;
constexpr int kCols = kGates * kUnits;  // a tile's columns

struct LstmArgs {
  const __nv_bfloat16* xp;  // [F, B, 4H]
  const int* order;         // [B] rows by num_frames, descending
  const int* live;          // [F] live rows at each step
  const __nv_bfloat16* wh;  // [H, 4H]
  const float* bias;        // [4H]
  const __nv_bfloat16* h0;  // [B, H] the first step's product operand
  float* c;                 // [B, H] state in, final state out
  float* h;                 // [B, H]
  __nv_bfloat16* out;       // [F, B, H]
  __nv_bfloat16* gates;     // [F, B, 4H] residuals (trainable forward), else null
  __nv_bfloat16* cs;        // [F, B, H] residuals (trainable forward), else null
  const int* num_frames;    // [B]
  unsigned int* barrier;    // a counter a row group, 0 at launch
  int F, B, H;
  int reverse;
  Plan plan;
  int skip_work;  // 1: barriers and schedule only (measures the barriers)
};

// One step of one unit tile (units j0 ..): the row group's live chunks,
// a warp a chunk, in rounds of kWarps. kResiduals: the cell update also
// stores the step's post-activation gates and bf16(c).
template <bool kResiduals>
__device__ __forceinline__ void lstm_tile_step(const LstmArgs& a, const __nv_bfloat16* hsrc,
                                               const __nv_bfloat16* x_t,
                                               __nv_bfloat16* out_t, __nv_bfloat16* gates_t,
                                               __nv_bfloat16* cs_t, int n, int mine, int j0,
                                               int group, uint32_t w_tile, uint32_t ring,
                                               int kw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = a.H;
  const size_t G = 4 * static_cast<size_t>(H);
  for (int r0 = 0; r0 < mine; r0 += kWarps) {
    const bool active = r0 + warp < mine;
    const ChunkRows rows =
        chunk_rows(a.order, group + a.plan.groups * (r0 + warp), active ? n : 0);
    // X' of the thread's cells (rows j = 2 mi + hf, unit halves hq), from
    // device memory: loaded before the product, used after it.
    __nv_bfloat162 x[4][2][4];
    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hq = 0; hq < 2; ++hq)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            if (rows.ok[j])
              x[j][hq][g] = *reinterpret_cast<const __nv_bfloat162*>(
                  x_t + static_cast<size_t>(rows.b[j]) * G + static_cast<size_t>(g) * H + j0 +
                  hq * 8 + (lane & 3) * 2);
    }
    float acc[2][2 * kGates][4];
    chunk_product<kGates>(acc, active, hsrc, rows, H, ring, w_tile, !a.plan.resident, kw,
                               [&](int k0, int rows_k) {
                                 load_w_tile<kGates>(w_tile, a.wh, 4 * H, H, j0, k0, rows_k);
                               });
    if (!active) continue;
    // The cells' c, all loaded before any store; the four gates' sums of
    // a cell are acc[mi][hq * 4 + g].
    float2 c0[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hq = 0; hq < 2; ++hq)
        if (rows.ok[j])
          c0[j][hq] = *reinterpret_cast<const float2*>(
              a.c + static_cast<size_t>(rows.b[j]) * H + j0 + hq * 8 + (lane & 3) * 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!rows.ok[j]) continue;
      const int mi = j >> 1;
      const int hf = j & 1;
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int unit = j0 + hq * 8 + (lane & 3) * 2;
        float cn[2], hn[2], act[4][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // (h @ W_h + X'_t) + bias, in the plain version's order.
          float z[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float xv = e ? __high2float(x[j][hq][g]) : __low2float(x[j][hq][g]);
            z[g] = __fadd_rn(__fadd_rn(acc[mi][hq * kGates + g][hf * 2 + e], xv),
                             __ldg(a.bias + g * H + unit + e));
          }
          const float si = sigmoid(z[0]);
          const float tj = tanhf(z[1]);
          const float sf = sigmoid(__fadd_rn(z[2], 1.0f));
          const float so = sigmoid(z[3]);
          cn[e] = __fadd_rn(__fmul_rn(e ? c0[j][hq].y : c0[j][hq].x, sf), __fmul_rn(si, tj));
          hn[e] = __fmul_rn(tanhf(cn[e]), so);
          act[0][e] = si;
          act[1][e] = tj;
          act[2][e] = sf;
          act[3][e] = so;
        }
        const size_t o = static_cast<size_t>(rows.b[j]) * H + unit;
        *reinterpret_cast<float2*>(a.c + o) = make_float2(cn[0], cn[1]);
        *reinterpret_cast<float2*>(a.h + o) = make_float2(hn[0], hn[1]);
        *reinterpret_cast<__nv_bfloat162*>(out_t + o) = __floats2bfloat162_rn(hn[0], hn[1]);
        if constexpr (kResiduals) {
          const size_t og = static_cast<size_t>(rows.b[j]) * G + unit;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            *reinterpret_cast<__nv_bfloat162*>(gates_t + og + static_cast<size_t>(g) * H) =
                __floats2bfloat162_rn(act[g][0], act[g][1]);
          *reinterpret_cast<__nv_bfloat162*>(cs_t + o) = __floats2bfloat162_rn(cn[0], cn[1]);
        }
      }
    }
  }
}

// kResiduals: the trainable forward (also the gates and bf16(c) of every
// step; 0 gates and the frozen carry's c at frozen steps).
template <bool kResiduals>
__global__ void __launch_bounds__(kThreads, 1) lstm_persist_kernel(LstmArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t w_tile = smem_u32(smem);
  const int w_bytes = a.plan.resident ? a.H * kCols * 2 : kWBytes;
  const uint32_t ring = smem_u32(smem + w_bytes) + (threadIdx.x >> 5) * kWarpRingBytes;
  const int lane_id = blockIdx.x % a.plan.lanes;
  const int group = blockIdx.x / a.plan.lanes;
  const int groups = a.plan.groups;
  const int H = a.H;
  const size_t step_h = static_cast<size_t>(a.B) * H;
  const int tiles = H / kUnits;
  const int kw = kWBytes / (kCols * 2) < H ? kWBytes / (kCols * 2) : H;

  if (a.plan.resident && !a.skip_work) {
    load_w_tile<kGates>(w_tile, a.wh, 4 * H, H, lane_id * kUnits, 0, H);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  FrozenResiduals res;
  if constexpr (kResiduals) res = {a.c, a.cs, a.gates, kGates};
  if (a.reverse && !a.skip_work)
    write_frozen_steps(a.order, a.num_frames, a.F, a.B, H, true, group, groups, lane_id,
                       a.plan.lanes, a.h, a.out, res);
  unsigned int* barrier = a.barrier + group;
  unsigned int target = 0;
  for (int t = 0; t < a.F; ++t) {
    const int n = __ldg(a.live + t);
    const __nv_bfloat16* hsrc = t == 0 ? a.h0 : a.out + (t - 1) * step_h;
    __nv_bfloat16* out_t = a.out + t * step_h;
    const __nv_bfloat16* x_t = a.xp + t * 4 * step_h;
    const int chunks = (n + kChunk - 1) / kChunk;
    const int mine = chunks > group ? (chunks - group + groups - 1) / groups : 0;
    __nv_bfloat16* gates_t = kResiduals ? a.gates + t * 4 * step_h : nullptr;
    __nv_bfloat16* cs_t = kResiduals ? a.cs + t * step_h : nullptr;
    for (int u = lane_id; u < tiles && !a.skip_work; u += a.plan.lanes) {
      lstm_tile_step<kResiduals>(a, hsrc, x_t, out_t, gates_t, cs_t, n, mine, u * kUnits,
                                 group, w_tile, ring, kw);
    }
    if (t + 1 < a.F) group_barrier(barrier, target, a.plan.lanes);
  }
  __syncthreads();  // the last step's state, written by other threads
  if (!a.reverse && !a.skip_work)
    write_frozen_steps(a.order, a.num_frames, a.F, a.B, H, false, group, groups, lane_id,
                       a.plan.lanes, a.h, a.out, res);
}

template <bool kResiduals>
cudaError_t lstm_plan(int B, int H, Plan* plan) {
  return make_plan(lstm_persist_kernel<kResiduals>, B, H, kCols, plan);
}

template <bool kResiduals>
int launch(const void* xp, const void* num_frames, const void* order, const void* live,
           const void* wh, const void* bias, const void* h0, void* c, void* h, void* out,
           void* gates, void* cs, void* barrier, int F, int B, int H, int reverse,
           int skip_work, void* stream) {
  if (F <= 0 || B <= 0 || H <= 0 || H % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  LstmArgs a;
  cudaError_t err = lstm_plan<kResiduals>(B, H, &a.plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.xp = static_cast<const __nv_bfloat16*>(xp);
  a.num_frames = static_cast<const int*>(num_frames);
  a.order = static_cast<const int*>(order);
  a.live = static_cast<const int*>(live);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.h0 = static_cast<const __nv_bfloat16*>(h0);
  a.c = static_cast<float*>(c);
  a.h = static_cast<float*>(h);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.gates = static_cast<__nv_bfloat16*>(gates);
  a.cs = static_cast<__nv_bfloat16*>(cs);
  a.barrier = static_cast<unsigned int*>(barrier);
  a.F = F;
  a.B = B;
  a.H = H;
  a.reverse = reverse;
  a.skip_work = skip_work;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lstm_persist_kernel<kResiduals>),
                                    dim3(a.plan.grid), dim3(kThreads), args, a.plan.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan at B rows and H units: [grid, lanes, groups, resident,
// shared bytes a block] into plan[0..4].
extern "C" int yt8m_lstm_plan(int B, int H, int* plan) {
  if (B <= 0 || H <= 0 || H % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = lstm_plan<false>(B, H, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = p.grid;
  plan[1] = p.lanes;
  plan[2] = p.groups;
  plan[3] = p.resident;
  plan[4] = p.smem;
  return static_cast<int>(cudaSuccess);
}

// xp [F, B, 4H] bf16; num_frames [B], order [B] and live [F] int32 (the
// live-row schedule); wh [H, 4H] bf16; bias [4H] f32; h0 [B, H] bf16 (the
// first step's product operand); c, h [B, H] f32, the initial state on
// entry (zeros for a sequence) and the final state on return; out
// [F, B, H] bf16; barrier kMaxGroups uint32, 0. One cooperative launch on
// `stream`; skip_work = 1 runs the schedule and the barriers alone.
extern "C" int yt8m_lstm_recurrence(const void* xp, const void* num_frames, const void* order,
                                    const void* live, const void* wh, const void* bias,
                                    const void* h0, void* c, void* h, void* out, void* barrier,
                                    int F, int B, int H, int reverse, int skip_work,
                                    void* stream) {
  return launch<false>(xp, num_frames, order, live, wh, bias, h0, c, h, out, nullptr, nullptr,
                       barrier, F, B, H, reverse, skip_work, stream);
}

// The trainable forward: as yt8m_lstm_recurrence, and also the residuals
// gates [F, B, 4H] (sigmoid i, tanh j, sigmoid(f + 1), sigmoid o; 0 at a
// row's frozen steps) and cs [F, B, H] (bf16(c_t); the frozen carry at
// frozen steps), both bf16.
extern "C" int yt8m_lstm_train_forward(const void* xp, const void* num_frames,
                                       const void* order, const void* live, const void* wh,
                                       const void* bias, const void* h0, void* c, void* h,
                                       void* out, void* gates, void* cs, void* barrier, int F,
                                       int B, int H, int reverse, int skip_work,
                                       void* stream) {
  return launch<true>(xp, num_frames, order, live, wh, bias, h0, c, h, out, gates, cs,
                      barrier, F, B, H, reverse, skip_work, stream);
}
