// GRU recurrence kernel for Hopper (sm_90a): serving, and the trainable
// forward (its Residuals instance).
//
// Replaces yt8m_tpu/kernels/gru.py :: gru_recurrence, and the forward
// pallas_call of yt8m_tpu/kernels/gru_train.py :: gru_recurrence_trainable
// (:104; the backward is gru_train.cu). Given the input
// projections xg [F, B, 2H] and xc [F, B, H] (bf16, computed outside),
// every step t runs the TF1 GRUCell
//
//   r, u   = split(sigmoid(bf16(h) @ W_hg + xg_t + bg))        (f32 sums)
//   c      = tanh(bf16(r * h) @ W_hc + xc_t + bc)
//   h'     = u * h + (1 - u) * c
//   h      = h' where num_frames > orig_t, else unchanged
//   out[t] = bf16(h)
//
// with orig_t = F-1-t under `reverse` (xg and xc come flipped in time).
//
// What bounds it: per layer at B=512, F=300, H=1024 the products of the
// live (video, step) pairs are about 0.48 TFLOP (0.49 ms at the bf16
// peak, half the pairs live) against about 0.79 GB of live xg, xc and
// outputs (0.24 ms at 3.35 TB/s): the tensor-core rate, behind the serial
// chain of 2F dependent products.
//
// Design: recurrence_persist.cuh, one launch a call. A unit tile is 16
// units: 32 columns of W_hg (r and u) and 16 of W_hc, 96 KB at H=1024,
// resident. A step has two phases, each followed by a barrier among the
// blocks of a row group: the candidate product needs bf16(r * h) over all
// H units, which every block's gate phase makes, and the next step's gate
// product needs out[t] of every unit.
//   (a) gate phase: a warp multiplies a 32-row chunk of bf16(h) = out[t-1]
//       by the tile's W_hg columns; each thread writes u (f32) and bf16(r
//       * h) [B, H] of its cells.
//   (b) candidate phase: the same chunk of bf16(r * h) times the tile's
//       W_hc columns; each thread updates h (f32) of the same cells and
//       writes out[t] = bf16(h).
// A (row, unit) is updated by the same thread in both phases of every
// step, so u and the state need no barrier of their own. The Residuals
// instance (yt8m_gru_train_forward) also stores bf16(r), bf16(u) [F, B,
// 2H] in (a) and the candidate bf16(c) [F, B, H] in (b) for the backward;
// 0 at a row's frozen steps (write_frozen_steps).

#include "recurrence_persist.cuh"

namespace {

using namespace persist;

constexpr int kGateCols = 2 * kUnits;  // r and u of a tile's units
constexpr int kCandCols = kUnits;

struct GruArgs {
  const __nv_bfloat16* xg;  // [F, B, 2H]
  const __nv_bfloat16* xc;  // [F, B, H]
  const int* order;         // [B] rows by num_frames, descending
  const int* live;          // [F] live rows at each step
  const __nv_bfloat16* whg;  // [H, 2H]
  const __nv_bfloat16* whc;  // [H, H]
  const float* bg;           // [2H]
  const float* bc;           // [H]
  const __nv_bfloat16* h0;   // [B, H] the first step's product operand
  float* h;                  // [B, H] state in, final state out
  float* u;                  // [B, H] scratch (the last step's on return)
  __nv_bfloat16* rh;         // [B, H] scratch (the last step's on return)
  __nv_bfloat16* out;        // [F, B, H]
  __nv_bfloat16* gates;      // [F, B, 2H] residuals (trainable forward), else null
  __nv_bfloat16* cand;       // [F, B, H] residuals (trainable forward), else null
  const int* num_frames;     // [B]
  unsigned int* barrier;     // a counter a row group, 0 at launch
  int F, B, H;
  int reverse;
  Plan plan;
  int skip_work;  // 1: barriers and schedule only (measures the barriers)
};

// (a) The gate phase of one step of one unit tile (units j0 ..): the row
// group's live chunks, a warp a chunk, in rounds of kWarps. kResiduals:
// also stores bf16(r) and bf16(u) of the step.
template <bool kResiduals>
__device__ __forceinline__ void gru_gate_step(const GruArgs& a, const __nv_bfloat16* hsrc,
                                              const __nv_bfloat16* xg_t,
                                              __nv_bfloat16* gates_t, int n, int mine, int j0,
                                              int group, uint32_t gate_tile, uint32_t ring,
                                              int kw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = a.H;
  const size_t G2 = 2 * static_cast<size_t>(H);
  for (int r0 = 0; r0 < mine; r0 += kWarps) {
    const bool active = r0 + warp < mine;
    const ChunkRows rows =
        chunk_rows(a.order, group + a.plan.groups * (r0 + warp), active ? n : 0);
    // xg of the thread's cells, from device memory: loaded before the
    // product, used after it.
    __nv_bfloat162 x[4][2][2];
    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hq = 0; hq < 2; ++hq)
#pragma unroll
          for (int g = 0; g < 2; ++g)
            if (rows.ok[j])
              x[j][hq][g] = *reinterpret_cast<const __nv_bfloat162*>(
                  xg_t + static_cast<size_t>(rows.b[j]) * G2 + static_cast<size_t>(g) * H + j0 +
                  hq * 8 + (lane & 3) * 2);
    }
    float acc[2][4][4];
    chunk_product<2>(acc, active, hsrc, rows, H, ring, gate_tile, !a.plan.resident, kw,
                          [&](int k0, int rows_k) {
                            load_w_tile<2>(gate_tile, a.whg, 2 * H, H, j0, k0, rows_k);
                          });
    if (!active) continue;
    // The cells' h, all loaded before any store; r and u of a cell are
    // acc[mi][hq * 2 + 0, 1].
    float2 h0[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hq = 0; hq < 2; ++hq)
        if (rows.ok[j])
          h0[j][hq] = *reinterpret_cast<const float2*>(
              a.h + static_cast<size_t>(rows.b[j]) * H + j0 + hq * 8 + (lane & 3) * 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!rows.ok[j]) continue;
      const int mi = j >> 1;
      const int hf = j & 1;
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int unit = j0 + hq * 8 + (lane & 3) * 2;
        float su[2], sr[2], rhv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // (h @ W_hg + xg_t) + bg, in the plain version's order.
          const float xr = e ? __high2float(x[j][hq][0]) : __low2float(x[j][hq][0]);
          const float xu = e ? __high2float(x[j][hq][1]) : __low2float(x[j][hq][1]);
          const float zr =
              __fadd_rn(__fadd_rn(acc[mi][hq * 2][hf * 2 + e], xr), __ldg(a.bg + unit + e));
          const float zu = __fadd_rn(__fadd_rn(acc[mi][hq * 2 + 1][hf * 2 + e], xu),
                                     __ldg(a.bg + H + unit + e));
          su[e] = sigmoid(zu);
          sr[e] = sigmoid(zr);
          rhv[e] = __fmul_rn(sr[e], e ? h0[j][hq].y : h0[j][hq].x);
        }
        const size_t o = static_cast<size_t>(rows.b[j]) * H + unit;
        *reinterpret_cast<float2*>(a.u + o) = make_float2(su[0], su[1]);
        *reinterpret_cast<__nv_bfloat162*>(a.rh + o) = __floats2bfloat162_rn(rhv[0], rhv[1]);
        if constexpr (kResiduals) {
          const size_t og = static_cast<size_t>(rows.b[j]) * G2 + unit;
          *reinterpret_cast<__nv_bfloat162*>(gates_t + og) = __floats2bfloat162_rn(sr[0], sr[1]);
          *reinterpret_cast<__nv_bfloat162*>(gates_t + og + H) =
              __floats2bfloat162_rn(su[0], su[1]);
        }
      }
    }
  }
}

// (b) The candidate phase of one step of one unit tile, the same chunks.
// kResiduals: also stores bf16(c) of the step.
template <bool kResiduals>
__device__ __forceinline__ void gru_cand_step(const GruArgs& a, const __nv_bfloat16* xc_t,
                                              __nv_bfloat16* out_t, __nv_bfloat16* cand_t,
                                              int n, int mine, int j0, int group,
                                              uint32_t cand_tile, uint32_t ring, int kw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = a.H;
  for (int r0 = 0; r0 < mine; r0 += kWarps) {
    const bool active = r0 + warp < mine;
    const ChunkRows rows =
        chunk_rows(a.order, group + a.plan.groups * (r0 + warp), active ? n : 0);
    // xc of the thread's cells, from device memory: loaded before the
    // product, used after it.
    __nv_bfloat162 x[4][2];
    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hq = 0; hq < 2; ++hq)
          if (rows.ok[j])
            x[j][hq] = *reinterpret_cast<const __nv_bfloat162*>(
                xc_t + static_cast<size_t>(rows.b[j]) * H + j0 + hq * 8 + (lane & 3) * 2);
    }
    float acc[2][2][4];
    chunk_product<1>(acc, active, a.rh, rows, H, ring, cand_tile, !a.plan.resident, kw,
                          [&](int k0, int rows_k) {
                            load_w_tile<1>(cand_tile, a.whc, H, H, j0, k0, rows_k);
                          });
    if (!active) continue;
    // The cells' h and u, all loaded before any store.
    float2 h0[4][2], uu[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hq = 0; hq < 2; ++hq)
        if (rows.ok[j]) {
          const size_t o = static_cast<size_t>(rows.b[j]) * H + j0 + hq * 8 + (lane & 3) * 2;
          h0[j][hq] = *reinterpret_cast<const float2*>(a.h + o);
          uu[j][hq] = *reinterpret_cast<const float2*>(a.u + o);
        }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!rows.ok[j]) continue;
      const int mi = j >> 1;
      const int hf = j & 1;
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int unit = j0 + hq * 8 + (lane & 3) * 2;
        float hn[2], cv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xv = e ? __high2float(x[j][hq]) : __low2float(x[j][hq]);
          const float c =
              tanhf(__fadd_rn(__fadd_rn(acc[mi][hq][hf * 2 + e], xv), __ldg(a.bc + unit + e)));
          const float hp = e ? h0[j][hq].y : h0[j][hq].x;
          const float uv = e ? uu[j][hq].y : uu[j][hq].x;
          hn[e] = __fadd_rn(__fmul_rn(uv, hp), __fmul_rn(__fsub_rn(1.0f, uv), c));
          cv[e] = c;
        }
        const size_t o = static_cast<size_t>(rows.b[j]) * H + unit;
        *reinterpret_cast<float2*>(a.h + o) = make_float2(hn[0], hn[1]);
        *reinterpret_cast<__nv_bfloat162*>(out_t + o) = __floats2bfloat162_rn(hn[0], hn[1]);
        if constexpr (kResiduals)
          *reinterpret_cast<__nv_bfloat162*>(cand_t + o) = __floats2bfloat162_rn(cv[0], cv[1]);
      }
    }
  }
}

// kResiduals: the trainable forward (also the gates and the candidate of
// every step; 0 at frozen steps).
template <bool kResiduals>
__global__ void __launch_bounds__(kThreads, 1) gru_persist_kernel(GruArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int H = a.H;
  const bool streamed = !a.plan.resident;
  // Resident: the gate tile [H][32] then the candidate tile [H][16].
  // Streamed: each phase's K chunks in turn at the start of the area.
  const uint32_t gate_tile = smem_u32(smem);
  const uint32_t cand_tile = streamed ? gate_tile : gate_tile + H * kGateCols * 2;
  const int w_bytes = streamed ? kWBytes : H * (kGateCols + kCandCols) * 2;
  const uint32_t ring = smem_u32(smem + w_bytes) + (threadIdx.x >> 5) * kWarpRingBytes;
  const int lane_id = blockIdx.x % a.plan.lanes;
  const int group = blockIdx.x / a.plan.lanes;
  const int groups = a.plan.groups;
  const size_t step_h = static_cast<size_t>(a.B) * H;
  const int tiles = H / kUnits;
  const int kw_gate = kWBytes / (kGateCols * 2) < H ? kWBytes / (kGateCols * 2) : H;
  const int kw_cand = kWBytes / (kCandCols * 2) < H ? kWBytes / (kCandCols * 2) : H;

  if (a.plan.resident && !a.skip_work) {
    const int j0 = lane_id * kUnits;
    load_w_tile<2>(gate_tile, a.whg, 2 * H, H, j0, 0, H);
    load_w_tile<1>(cand_tile, a.whc, H, H, j0, 0, H);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  FrozenResiduals res;
  if constexpr (kResiduals) res = {nullptr, a.cand, a.gates, 2};
  if (a.reverse && !a.skip_work)
    write_frozen_steps(a.order, a.num_frames, a.F, a.B, H, true, group, groups, lane_id,
                       a.plan.lanes, a.h, a.out, res);
  unsigned int* barrier = a.barrier + group;
  unsigned int target = 0;
  for (int t = 0; t < a.F; ++t) {
    const int n = __ldg(a.live + t);
    const __nv_bfloat16* hsrc = t == 0 ? a.h0 : a.out + (t - 1) * step_h;
    __nv_bfloat16* out_t = a.out + t * step_h;
    const __nv_bfloat16* xg_t = a.xg + t * 2 * step_h;
    const __nv_bfloat16* xc_t = a.xc + t * step_h;
    const int chunks = (n + kChunk - 1) / kChunk;
    const int mine = chunks > group ? (chunks - group + groups - 1) / groups : 0;
    __nv_bfloat16* gates_t = kResiduals ? a.gates + t * 2 * step_h : nullptr;
    __nv_bfloat16* cand_t = kResiduals ? a.cand + t * step_h : nullptr;
    for (int u = lane_id; u < tiles && !a.skip_work; u += a.plan.lanes) {
      gru_gate_step<kResiduals>(a, hsrc, xg_t, gates_t, n, mine, u * kUnits, group, gate_tile,
                                ring, kw_gate);
    }
    group_barrier(barrier, target, a.plan.lanes);
    for (int u = lane_id; u < tiles && !a.skip_work; u += a.plan.lanes) {
      gru_cand_step<kResiduals>(a, xc_t, out_t, cand_t, n, mine, u * kUnits, group, cand_tile,
                                ring, kw_cand);
    }
    if (t + 1 < a.F) group_barrier(barrier, target, a.plan.lanes);
  }
  __syncthreads();  // the last step's state, written by other threads
  if (!a.reverse && !a.skip_work)
    write_frozen_steps(a.order, a.num_frames, a.F, a.B, H, false, group, groups, lane_id,
                       a.plan.lanes, a.h, a.out, res);
}

template <bool kResiduals>
cudaError_t gru_plan(int B, int H, Plan* plan) {
  return make_plan(gru_persist_kernel<kResiduals>, B, H, kGateCols + kCandCols, plan);
}

template <bool kResiduals>
int launch(const void* xg, const void* xc, const void* num_frames, const void* order,
           const void* live, const void* whg, const void* whc, const void* bg, const void* bc,
           const void* h0, void* h, void* u, void* rh, void* out, void* gates, void* cand,
           void* barrier, int F, int B, int H, int reverse, int skip_work, void* stream) {
  if (F <= 0 || B <= 0 || H <= 0 || H % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  GruArgs a;
  cudaError_t err = gru_plan<kResiduals>(B, H, &a.plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.xg = static_cast<const __nv_bfloat16*>(xg);
  a.xc = static_cast<const __nv_bfloat16*>(xc);
  a.num_frames = static_cast<const int*>(num_frames);
  a.order = static_cast<const int*>(order);
  a.live = static_cast<const int*>(live);
  a.whg = static_cast<const __nv_bfloat16*>(whg);
  a.whc = static_cast<const __nv_bfloat16*>(whc);
  a.bg = static_cast<const float*>(bg);
  a.bc = static_cast<const float*>(bc);
  a.h0 = static_cast<const __nv_bfloat16*>(h0);
  a.h = static_cast<float*>(h);
  a.u = static_cast<float*>(u);
  a.rh = static_cast<__nv_bfloat16*>(rh);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.gates = static_cast<__nv_bfloat16*>(gates);
  a.cand = static_cast<__nv_bfloat16*>(cand);
  a.barrier = static_cast<unsigned int*>(barrier);
  a.F = F;
  a.B = B;
  a.H = H;
  a.reverse = reverse;
  a.skip_work = skip_work;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gru_persist_kernel<kResiduals>),
                                    dim3(a.plan.grid), dim3(kThreads), args, a.plan.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan at B rows and H units: [grid, lanes, groups, resident,
// shared bytes a block] into plan[0..4].
extern "C" int yt8m_gru_plan(int B, int H, int* plan) {
  if (B <= 0 || H <= 0 || H % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = gru_plan<false>(B, H, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = p.grid;
  plan[1] = p.lanes;
  plan[2] = p.groups;
  plan[3] = p.resident;
  plan[4] = p.smem;
  return static_cast<int>(cudaSuccess);
}

// xg [F, B, 2H], xc [F, B, H] bf16; num_frames [B], order [B] and live
// [F] int32 (the live-row schedule); whg [H, 2H], whc [H, H] bf16; bg
// [2H], bc [H] f32; h0 [B, H] bf16 (the first step's product operand); h
// [B, H] f32, the initial state on entry (zeros for a sequence) and the
// final state on return; u [B, H] f32 and rh [B, H] bf16 scratch (the
// last step's live rows on return); out [F, B, H] bf16; barrier
// kMaxGroups uint32, 0. One cooperative launch on `stream`; skip_work = 1
// runs the schedule and the barriers alone.
extern "C" int yt8m_gru_recurrence(const void* xg, const void* xc, const void* num_frames,
                                   const void* order, const void* live, const void* whg,
                                   const void* whc, const void* bg, const void* bc,
                                   const void* h0, void* h, void* u, void* rh, void* out,
                                   void* barrier, int F, int B, int H, int reverse,
                                   int skip_work, void* stream) {
  return launch<false>(xg, xc, num_frames, order, live, whg, whc, bg, bc, h0, h, u, rh, out,
                       nullptr, nullptr, barrier, F, B, H, reverse, skip_work, stream);
}

// The trainable forward: as yt8m_gru_recurrence, and also the residuals
// gates [F, B, 2H] (bf16 of sigmoid r and u) and cand [F, B, H] (bf16 of
// the candidate), both 0 at a row's frozen steps.
extern "C" int yt8m_gru_train_forward(const void* xg, const void* xc, const void* num_frames,
                                      const void* order, const void* live, const void* whg,
                                      const void* whc, const void* bg, const void* bc,
                                      const void* h0, void* h, void* u, void* rh, void* out,
                                      void* gates, void* cand, void* barrier, int F, int B,
                                      int H, int reverse, int skip_work, void* stream) {
  return launch<true>(xg, xc, num_frames, order, live, whg, whc, bg, bc, h0, h, u, rh, out,
                      gates, cand, barrier, F, B, H, reverse, skip_work, stream);
}
