// Trainable GRU recurrence for Hopper (sm_90a): the reverse-time backward
// that emits dA_g and dA_c. (The forward with residuals is gru.cu's
// persistent kernel with its Residuals flag: yt8m_gru_train_forward.)
//
// Replaces yt8m_tpu/kernels/gru_train.py :: gru_recurrence_trainable
// (its forward pallas_call at :104 and its backward at :235).
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
// What bounds it: the products are 2 H 3H a live (video, step) pair (242
// GFLOP a layer at B=256, F=300, H=1024 with half the pairs live, 0.24 ms
// at the bf16 peak); dout, the residuals and dA move ~1.26 GB (0.38 ms at
// 3.35 TB/s): the bytes, behind the serial chain of 2F products.
//
// Design: recurrence_persist.cuh, one cooperative launch a call, rows in
// the forward's live-row order. A unit tile is W_hg's rows of its 16
// units, [16, 2H] (64 KB at H=1024), and W_hc's, [16, H] (32 KB): 96 KB,
// resident, the B operands of the two products with W^T, read with plain
// ldmatrix. Each step has two dependent products, as the forward has, each
// followed by a barrier among a row group's blocks:
//   (a) dA_g[t+1] @ W_hg^T over the tile's units (depth 2H), then the
//       carry, dh, da_u and da_c: writes dA_c[t], the u half of dA_g[t]
//       and dh (f32);
//   (b) dA_c[t] @ W_hc^T (depth H) needs da_c over all H units, then
//       da_r: writes the r half of dA_g[t] and drh (f32) for (a) of step
//       t-1, which needs dA_g[t] over all 2H columns.
// Rows as in lstm_train.cu: step t computes the rows live at t; (a) takes
// the product for the rows also live at t+1 and the carry for the others
// (turning live at t, forward only); a row live at t+1 but not at t
// (reverse only) would carry dh into the initial state alone: skipped.
// Frozen steps (backward_frozen_steps): dA = 0 there, and, forward, the
// bf16(dout_t) of a row's frozen steps added to its dh carry one at a
// time, t = F-1 down. (b) multiplies dA_c, which is 0 where frozen, where
// the JAX kernel multiplies da_c before its mask: the two differ only on a
// frozen row, whose drh reaches nothing (da_r is masked there, and the
// carry is dh). The dh and drh carries live in f32 [B, H] buffers, each
// element read and written by the one thread that owns its (row, unit).

#include "recurrence_persist.cuh"

namespace {

using namespace persist;

constexpr int kGateCols = 2 * kUnits;  // the forward's tile columns: the same bytes
constexpr int kCandCols = kUnits;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float one_minus(float a) { return __fsub_rn(1.0f, a); }
__device__ __forceinline__ float lo(__nv_bfloat162 v, int e) {
  return e ? __high2float(v) : __low2float(v);
}

struct GruBwdArgs {
  const __nv_bfloat16* dout;   // [F, B, H]
  const __nv_bfloat16* gates;  // [F, B, 2H]
  const __nv_bfloat16* cand;   // [F, B, H]
  const __nv_bfloat16* outs;   // [F, B, H]
  const int* num_frames;       // [B]
  const int* order;            // [B] rows by num_frames, descending
  const int* live;             // [F] live rows at each step
  const __nv_bfloat16* whg;    // [H, 2H]
  const __nv_bfloat16* whc;    // [H, H]
  float* dh;                   // [B, H] final h's cotangent in, the carry
  float* drh;                  // [B, H] scratch
  __nv_bfloat16* dag;          // [F, B, 2H]
  __nv_bfloat16* dac;          // [F, B, H]
  unsigned int* barrier;       // a counter a row group, 0 at launch
  int F, B, H;
  int reverse;
  BwdPlan plan;
  int skip_work;  // 1: barriers and schedule only (measures the barriers)
};

// (a) of step t for one unit tile (units j0 ..): the row group's chunks of
// the n rows live at t, a ring warp a chunk, in rounds of ring_warps; the
// first np of them take the product.
__device__ __forceinline__ void gru_bwd_h_step(const GruBwdArgs& a, int t, int n, int np,
                                               int mine, int j0, int group, uint32_t w_tile,
                                               uint32_t ring, int kw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = a.H;
  const size_t G2 = 2 * static_cast<size_t>(H);
  const size_t step_h = static_cast<size_t>(a.B) * H;
  const __nv_bfloat16* dag_next = a.dag + (t + 1) * 2 * step_h;  // read only when np > 0
  const __nv_bfloat16* gates_next = a.gates + (t + 1) * 2 * step_h;
  const __nv_bfloat16* dout_t = a.dout + t * step_h;
  const __nv_bfloat16* gates_t = a.gates + t * 2 * step_h;
  const __nv_bfloat16* cand_t = a.cand + t * step_h;
  const __nv_bfloat16* hprev = t > 0 ? a.outs + (t - 1) * step_h : nullptr;
  __nv_bfloat16* dag_t = a.dag + t * 2 * step_h;
  __nv_bfloat16* dac_t = a.dac + t * step_h;
  const int rw = a.plan.ring_warps;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
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
    // dout, residuals and carries, all loaded before the product.
    __nv_bfloat162 dv[4][2], uv[4][2], cv[4][2], hv[4][2], r1[4][2], u1[4][2];
    float2 dhv[4][2], drv[4][2];
    if (mine_chunk) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          if (!rows.ok[j]) continue;
          const int unit = j0 + hq * 8 + (lane & 3) * 2;
          const size_t o = static_cast<size_t>(rows.b[j]) * H + unit;
          const size_t og = static_cast<size_t>(rows.b[j]) * G2 + unit;
          dv[j][hq] = *reinterpret_cast<const __nv_bfloat162*>(dout_t + o);
          uv[j][hq] = *reinterpret_cast<const __nv_bfloat162*>(gates_t + og + H);
          cv[j][hq] = *reinterpret_cast<const __nv_bfloat162*>(cand_t + o);
          hv[j][hq] = hprev != nullptr ? *reinterpret_cast<const __nv_bfloat162*>(hprev + o)
                                       : zero;
          dhv[j][hq] = *reinterpret_cast<const float2*>(a.dh + o);
          if (prod[j]) {
            r1[j][hq] = *reinterpret_cast<const __nv_bfloat162*>(gates_next + og);
            u1[j][hq] = *reinterpret_cast<const __nv_bfloat162*>(gates_next + og + H);
            drv[j][hq] = *reinterpret_cast<const float2*>(a.drh + o);
          }
        }
    }
    float acc[2][2][4];
    chunk_product_wt(acc, mine_chunk && c * kChunk < np, dag_next, static_cast<int>(G2), prow,
                     static_cast<int>(G2), ring, a.plan.stages, w_tile, !a.plan.p.resident, kw,
                     [&](int k0, int kn) {
                       load_wt_tile(w_tile, a.whg, 2 * H, j0, k0, kn, kw);
                     });
    if (!mine_chunk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!rows.ok[j]) continue;
      const int mi = j >> 1;
      const int hf = j & 1;
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int unit = j0 + hq * 8 + (lane & 3) * 2;
        float dau[2], dac[2], dhn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float dh = e ? dhv[j][hq].y : dhv[j][hq].x;
          if (prod[j])
            dh = add(add(mul(dh, lo(u1[j][hq], e)), mul(e ? drv[j][hq].y : drv[j][hq].x,
                                                         lo(r1[j][hq], e))),
                     acc[mi][hq][hf * 2 + e]);
          dh = add(dh, lo(dv[j][hq], e));
          const float u = lo(uv[j][hq], e);
          const float cd = lo(cv[j][hq], e);
          const float hp = lo(hv[j][hq], e);
          dau[e] = mul(mul(mul(dh, sub(hp, cd)), u), one_minus(u));
          dac[e] = mul(mul(dh, one_minus(u)), one_minus(mul(cd, cd)));
          dhn[e] = dh;
        }
        const size_t o = static_cast<size_t>(rows.b[j]) * H + unit;
        *reinterpret_cast<__nv_bfloat162*>(dag_t + static_cast<size_t>(rows.b[j]) * G2 + H +
                                           unit) = __floats2bfloat162_rn(dau[0], dau[1]);
        *reinterpret_cast<__nv_bfloat162*>(dac_t + o) = __floats2bfloat162_rn(dac[0], dac[1]);
        *reinterpret_cast<float2*>(a.dh + o) = make_float2(dhn[0], dhn[1]);
      }
    }
  }
}

// (b) of step t for one unit tile: the same chunks, every row a product.
__device__ __forceinline__ void gru_bwd_r_step(const GruBwdArgs& a, int t, int n, int mine,
                                               int j0, int group, uint32_t w_tile,
                                               uint32_t ring, int kw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = a.H;
  const size_t G2 = 2 * static_cast<size_t>(H);
  const size_t step_h = static_cast<size_t>(a.B) * H;
  const __nv_bfloat16* dac_t = a.dac + t * step_h;
  const __nv_bfloat16* gates_t = a.gates + t * 2 * step_h;
  const __nv_bfloat16* hprev = t > 0 ? a.outs + (t - 1) * step_h : nullptr;
  __nv_bfloat16* dag_t = a.dag + t * 2 * step_h;
  const int rw = a.plan.ring_warps;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
  for (int r0 = 0; r0 < mine; r0 += rw) {
    const bool mine_chunk = warp < rw && r0 + warp < mine;
    const ChunkRows rows =
        chunk_rows(a.order, group + a.plan.p.groups * (r0 + warp), mine_chunk ? n : 0);
    __nv_bfloat162 rv[4][2], hv[4][2];
    if (mine_chunk) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          if (!rows.ok[j]) continue;
          const int unit = j0 + hq * 8 + (lane & 3) * 2;
          const size_t o = static_cast<size_t>(rows.b[j]) * H + unit;
          rv[j][hq] = *reinterpret_cast<const __nv_bfloat162*>(
              gates_t + static_cast<size_t>(rows.b[j]) * G2 + unit);
          hv[j][hq] = hprev != nullptr ? *reinterpret_cast<const __nv_bfloat162*>(hprev + o)
                                       : zero;
        }
    }
    float acc[2][2][4];
    chunk_product_wt(acc, mine_chunk, dac_t, H, rows, H, ring, a.plan.stages, w_tile,
                     !a.plan.p.resident, kw, [&](int k0, int kn) {
                       load_wt_tile(w_tile, a.whc, H, j0, k0, kn, kw);
                     });
    if (!mine_chunk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!rows.ok[j]) continue;
      const int mi = j >> 1;
      const int hf = j & 1;
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int unit = j0 + hq * 8 + (lane & 3) * 2;
        float dar[2], drh[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          drh[e] = acc[mi][hq][hf * 2 + e];
          const float r = lo(rv[j][hq], e);
          dar[e] = mul(mul(mul(drh[e], lo(hv[j][hq], e)), r), one_minus(r));
        }
        *reinterpret_cast<__nv_bfloat162*>(dag_t + static_cast<size_t>(rows.b[j]) * G2 +
                                           unit) = __floats2bfloat162_rn(dar[0], dar[1]);
        *reinterpret_cast<float2*>(a.drh + static_cast<size_t>(rows.b[j]) * H + unit) =
            make_float2(drh[0], drh[1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) gru_bwd_persist_kernel(GruBwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int H = a.H;
  const bool streamed = !a.plan.p.resident;
  // Resident: the W_hg tile [16][2H] then the W_hc tile [16][H].
  // Streamed: each product's K chunks in turn at the start of the area.
  const uint32_t g_tile = smem_u32(smem);
  const uint32_t c_tile = streamed ? g_tile : g_tile + kUnits * 2 * H * 2;
  const int w_bytes = streamed ? kWBytes : kUnits * 3 * H * 2;
  const int warp = threadIdx.x >> 5;
  const uint32_t ring = smem_u32(smem + w_bytes) +
                        (warp < a.plan.ring_warps ? warp : 0) * a.plan.stages * kStageBytesT;
  const int lanes = a.plan.p.lanes;
  const int lane_id = blockIdx.x % lanes;
  const int group = blockIdx.x / lanes;
  const int groups = a.plan.p.groups;
  const int tiles = H / kUnits;
  const int kw_max = kWBytes / (kUnits * 2);
  const int kw_g = kw_max < 2 * H ? kw_max : 2 * H;
  const int kw_c = kw_max < H ? kw_max : H;

  if (!streamed && !a.skip_work) {
    const int j0 = lane_id * kUnits;
    load_wt_tile(g_tile, a.whg, 2 * H, j0, 0, 2 * H, 2 * H);
    load_wt_tile(c_tile, a.whc, H, j0, 0, H, H);
    cp_async_commit();
    cp_async_wait<0>();
  }
  if (!a.skip_work)
    backward_frozen_steps(a.order, a.num_frames, a.F, a.B, H, a.reverse, group, groups,
                          lane_id, lanes, a.dout, a.dh, a.dag, 2, a.dac);
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
      gru_bwd_h_step(a, t, n, np, mine, u * kUnits, group, g_tile, ring, kw_g);
    }
    group_barrier(barrier, target, lanes);
    for (int u = lane_id; u < tiles && !a.skip_work; u += lanes) {
      gru_bwd_r_step(a, t, n, mine, u * kUnits, group, c_tile, ring, kw_c);
    }
    if (t > 0) group_barrier(barrier, target, lanes);
  }
}

cudaError_t gru_bwd_plan(int B, int H, BwdPlan* plan) {
  return make_bwd_plan(gru_bwd_persist_kernel, B, H, kGateCols + kCandCols, plan);
}

}  // namespace

// The backward's launch plan at B rows and H units: [grid, lanes, groups,
// resident, shared bytes a block, ring warps, ring stages] into
// plan[0..6].
extern "C" int yt8m_gru_train_plan(int B, int H, int* plan) {
  if (B <= 0 || H <= 0 || H % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdPlan p;
  const cudaError_t err = gru_bwd_plan(B, H, &p);
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

// Backward: dout [F, B, H], gates [F, B, 2H], cand [F, B, H] and outs
// [F, B, H] bf16 (the forward's); num_frames [B], order [B] and live [F]
// int32 (the forward's live-row schedule); whg [H, 2H], whc [H, H] bf16;
// dh [B, H] f32 holding the final h's cotangent on entry (the carry,
// scratch, on return); drh [B, H] f32 scratch; dag [F, B, 2H] and dac
// [F, B, H] bf16 out; barrier kMaxGroups uint32, 0. One cooperative
// launch on `stream`; skip_work = 1 runs the schedule and the barriers
// alone.
extern "C" int yt8m_gru_train_backward(const void* dout, const void* gates, const void* cand,
                                       const void* outs, const void* num_frames,
                                       const void* order, const void* live, const void* whg,
                                       const void* whc, void* dh, void* drh, void* dag,
                                       void* dac, void* barrier, int F, int B, int H,
                                       int reverse, int skip_work, void* stream) {
  if (F <= 0 || B <= 0 || H <= 0 || H % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  GruBwdArgs a;
  cudaError_t err = gru_bwd_plan(B, H, &a.plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.gates = static_cast<const __nv_bfloat16*>(gates);
  a.cand = static_cast<const __nv_bfloat16*>(cand);
  a.outs = static_cast<const __nv_bfloat16*>(outs);
  a.num_frames = static_cast<const int*>(num_frames);
  a.order = static_cast<const int*>(order);
  a.live = static_cast<const int*>(live);
  a.whg = static_cast<const __nv_bfloat16*>(whg);
  a.whc = static_cast<const __nv_bfloat16*>(whc);
  a.dh = static_cast<float*>(dh);
  a.drh = static_cast<float*>(drh);
  a.dag = static_cast<__nv_bfloat16*>(dag);
  a.dac = static_cast<__nv_bfloat16*>(dac);
  a.barrier = static_cast<unsigned int*>(barrier);
  a.F = F;
  a.B = B;
  a.H = H;
  a.reverse = reverse;
  a.skip_work = skip_work;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gru_bwd_persist_kernel),
                                    dim3(a.plan.p.grid), dim3(kThreads), args, a.plan.p.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
