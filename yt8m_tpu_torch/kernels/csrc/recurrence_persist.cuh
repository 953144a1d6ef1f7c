// The persistent design shared by the recurrences for Hopper (sm_90a):
// the serving LSTM and GRU (lstm.cu, gru.cu), their trainable forwards
// (the same kernels' Residuals instances) and the trainable backwards
// (lstm_train.cu, gru_train.cu). One launch a call, weights resident in
// shared memory, live rows only.
//
// A step of a recurrence is a short product, bf16(h) [B, H] times the
// recurrent weights [H, G] (G = 4H for the LSTM; 2H and then H for the
// GRU's two products), and an element-wise cell update; a backward step
// multiplies the next step's bf16 cotangents by W^T. One launch a step
// pays a launch and re-reads the weights from L2 every step; a step that
// multiplies every batch row pays for rows whose video has ended. Here:
//
// * One launch a call. The grid is at most one co-resident wave (sized
//   with cudaOccupancyMaxActiveBlocksPerMultiprocessor, launched with
//   cudaLaunchCooperativeKernel, which refuses a grid that cannot be
//   co-resident rather than hang). Every block loops over all F steps;
//   a barrier (a counter in global memory, release/acquire) among the
//   blocks of a row group separates a step's product from the next step's
//   read of its output, and the GRU's gate product from its candidate
//   product: a row group's blocks read and write only its rows.
// * Live rows only. The wrapper passes the rows sorted by num_frames,
//   descending and stable (`order`), and the live count of each step
//   (`live`): the live rows of step t are the first live[t] of that order
//   (a prefix that shrinks, or grows under `reverse`). The kernel reads
//   its inputs, and writes the outputs and the state, through `order`, in
//   the caller's row order; no input is copied. It multiplies 32-row
//   chunks of the live prefix only; a row past it keeps its state, and
//   its out[t] = bf16(h), the frozen carry, is written outside the steps
//   (write_frozen_steps; the backward's counterpart is
//   backward_frozen_steps).
// * Weights resident. The hidden units are cut into tiles of 16 (kUnits):
//   a tile's columns of every gate, [H, 16 x gates] bf16, are 128 KB for
//   the LSTM at H=1024 (64 columns) and 96 KB for the GRU (32 gate and 16
//   candidate columns); the backward's tile, W's rows of the same units,
//   holds the same bytes. Block b owns unit tile b % lanes and the row
//   chunks c with c % groups == b / lanes; at H=1024 that is 64 tiles x 2
//   row groups = 128 blocks, one an SM, each loading its weights once a
//   call. Where a tile does not fit the 128 KB area (LSTM H=2048), or a
//   block owns several tiles (more tiles than co-resident blocks), the
//   same kernel streams the weights through that area instead, in K
//   chunks, once per round of rows.
// * Tensor cores through ldmatrix + mma.sync m16n8k16 (bf16 operands, f32
//   sums). A warp owns a 32-row chunk and all of the tile's columns; it
//   streams its rows of h through its own 3-stage cp.async ring (32 deep,
//   2 KB a stage, two in flight; six stages ran slower on the card, their
//   larger shared-memory carve-out leaving less L1 to the epilogue) and
//   reads the resident weights with ldmatrix.trans. Both shared tiles use
//   the 128-byte XOR swizzle, so ldmatrix is free of bank conflicts
//   without padding. The depth is summed in ascending 16-deep steps into
//   one accumulator, as the wmma step kernels this design replaced summed
//   it. (The backward's ring differs: chunk_product_wt.)
// * The thread that holds a (row, unit)'s products of every gate in its
//   accumulators updates that cell, so the epilogue needs no shared
//   memory. It loads the step's X' / xg / xc (device memory) before the
//   product, and the state after it, every load before any store: a load
//   that followed a store to the state could not be hoisted above it, and
//   the epilogue's loads would wait in turn.
//
// What this pays: each block reads its rows of h from L2 every step
// (unit tiles x live rows x H x 2 bytes a product, 64 MiB a step at B=512,
// H=1024 with every row live; the backward reads rows 4H deep, 2H and H
// for the GRU), a row group's barrier a step (two for the GRU), and a
// round trip to L2 at the start of each round of rows. On the card a
// step is latency-bound: one warp's chain of ring stages, mma and
// epilogue over its chunk, then the barrier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace persist {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnits = 16;   // hidden units of a unit tile
constexpr int kChunk = 32;   // rows of a warp's chunk
constexpr int kKc = 32;      // depth of a ring stage
constexpr int kStages = 3;
constexpr int kStageBytes = kChunk * kKc * 2;
constexpr int kWarpRingBytes = kStages * kStageBytes;
constexpr int kRingBytes = kWarps * kWarpRingBytes;  // 48 KB
constexpr int kWBytes = 128 * 1024;                  // the weight area
constexpr int kMaxGroups = 256;  // barrier counters the caller provides
static_assert(kStageBytes % 1024 == 0, "the swizzle repeats every 1 KB");
static_assert(kKc == 32, "a stage row is 64 bytes: four lanes of 16 bytes");

// Byte offset -> swizzled byte offset: the 16-byte chunk index (bits 4-6)
// XOR the 128-byte line index (bits 7-9). Eight ldmatrix rows of 32, 64
// or 128 bytes at one logical chunk land in eight distinct bank groups.
__device__ __forceinline__ uint32_t swz(uint32_t o) { return o ^ (((o >> 7) & 7) << 4); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global (L2) -> shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// D += A (16 x 16, row) * B (16 x 8, col); bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The `blocks` blocks that share `counter` meet here (a row group: its
// blocks read and write only its rows). `target` counts the arrivals this
// block waits for: it grows by `blocks` a barrier, and the counter (0 at
// launch) by one an arriving block, so one counter serves every barrier of
// the call. The fences make each block's global writes visible to the
// blocks that pass the barrier after it.
__device__ __forceinline__ void group_barrier(unsigned int* counter, unsigned int& target,
                                              int blocks) {
  target += blocks;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned int seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= target) break;
      __nanosleep(32);  // fewer polls of the counter's L2 slice
    }
    __threadfence();
  }
  __syncthreads();
}

// Where a block works: unit tiles lane, lane + lanes, ... and the row
// chunks c with c % groups == group.
struct Plan {
  int grid;      // blocks, lanes x groups, at most one co-resident wave
  int lanes;     // blocks that share a row group, one unit tile lane each
  int groups;    // row groups
  int resident;  // 1: each block's weight tiles stay in shared memory
  int smem;      // dynamic shared memory a block
};

// The plan of a kernel whose unit tile has `cols` weight columns in all
// (64 for the LSTM, 32 + 16 for the GRU), at B rows and H units.
template <typename Kernel>
cudaError_t make_plan(Kernel kernel, int B, int H, int cols, Plan* plan) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = H / kUnits;
  const int chunks = (B + kChunk - 1) / kChunk;
  const long long w_bytes = static_cast<long long>(H) * cols * 2;
  for (int resident = w_bytes <= kWBytes ? 1 : 0; resident >= 0; --resident) {
    const int smem = (resident ? static_cast<int>(w_bytes) : kWBytes) + kRingBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    const int wave = per_sm * sms;
    if (wave <= 0) return cudaErrorInvalidConfiguration;
    if (resident && tiles > wave) continue;  // a block would own several tiles
    plan->lanes = tiles < wave ? tiles : wave;
    int groups = wave / plan->lanes;
    groups = groups < chunks ? groups : chunks;
    plan->groups = groups < kMaxGroups ? groups : kMaxGroups;
    plan->grid = plan->lanes * plan->groups;
    plan->resident = resident;
    plan->smem = smem;
    return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

// Copies rows k0 .. k0 + kw - 1 of a unit tile's G gates into the
// swizzled tile [kw][16 G] at `tile`. Column n = uh * 8 G + g * 8 + v of
// the tile is column g * gate_stride + j0 + uh * 8 + v of W (ldw columns a
// row): the 8-column tile q = uh * G + g holds 8 units of one gate, and a
// half of the unit tile (uh) has its G column tiles side by side. Every
// thread of the block takes part; the caller waits and synchronises.
template <int G>
__device__ __forceinline__ void load_w_tile(uint32_t tile, const __nv_bfloat16* __restrict__ W,
                                            int ldw, int gate_stride, int j0, int k0, int kw) {
  constexpr int kChunksRow = 2 * G;  // 16-byte chunks a row of the tile
  for (int idx = threadIdx.x; idx < kw * kChunksRow; idx += kThreads) {
    const int k = idx / kChunksRow;
    const int ch = idx % kChunksRow;
    const __nv_bfloat16* src = W + static_cast<size_t>(k0 + k) * ldw +
                               static_cast<size_t>(ch % G) * gate_stride + j0 + (ch / G) * 8;
    cp_async16(tile + swz(static_cast<uint32_t>(k * kChunksRow * 16 + ch * 16)), src, 16);
  }
}

// The rows of a warp's 32-row chunk c: the lane's four rows (lane / 4 +
// 8 j) by position in the order, their caller rows, and whether they are
// live (before the live count n).
struct ChunkRows {
  int b[4];
  bool ok[4];
};

__device__ __forceinline__ ChunkRows chunk_rows(const int* __restrict__ order, int c, int n) {
  ChunkRows r;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = c * kChunk + (lane >> 2) + 8 * j;
    r.ok[j] = p < n;
    r.b[j] = r.ok[j] ? __ldg(order + p) : 0;
  }
  return r;
}

// acc[mi][q][e]: row mi * 16 + (lane / 4) + 8 (e / 2) of the chunk,
// column q * 8 + (lane % 4) * 2 + (e % 2) of the unit tile, of
//
//   acc = A[rows, 0:H] @ Wtile[0:H, 0:16 G]
//
// A's rows are `rows` (caller rows, each H bf16 wide; rows not ok read as
// zeros). The depth runs through the warp's ring in 32-deep stages, in
// ascending 16-deep steps into one accumulator. Resident: the whole tile
// lies at `w_tile`. Streamed: before each K chunk of kw rows the block
// synchronises and load_w(k0, rows) fills `w_tile`; every warp of the
// block must call this then, `active` false for a warp without a chunk.
template <int G, typename LoadW>
__device__ __forceinline__ void chunk_product(float (&acc)[2][2 * G][4], bool active,
                                              const __nv_bfloat16* __restrict__ A,
                                              const ChunkRows& rows, int H, uint32_t ring,
                                              uint32_t w_tile, bool streamed, int kw,
                                              LoadW load_w) {
  constexpr int NC = 16 * G;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int q = 0; q < 2 * G; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][q][e] = 0.0f;

  const __nv_bfloat16* src[4];
  uint32_t dst[4];
  int bytes[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = (lane >> 2) + 8 * j;
    src[j] = A + static_cast<size_t>(rows.b[j]) * H + (lane & 3) * 8;
    dst[j] = swz(static_cast<uint32_t>(row * kKc * 2 + (lane & 3) * 16));
    bytes[j] = rows.ok[j] ? 16 : 0;
  }
  auto load_a = [&](int slot, int kt) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cp_async16(ring + slot * kStageBytes + dst[j], src[j] + kt * kKc, bytes[j]);
  };
  // ldmatrix lane addresses within a stage (A) and within 16 rows of the
  // weight tile (B, two 8-column tiles an x4).
  constexpr int kK16 = kKc / 16;  // 16-deep steps a stage
  uint32_t a_off[2][kK16];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int kk = 0; kk < kK16; ++kk)
      a_off[mi][kk] = swz(static_cast<uint32_t>((mi * 16 + (lane & 15)) * kKc * 2 +
                                                (kk * 2 + (lane >> 4)) * 16));
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (lane >> 4) * 8;

  const int nk = H / kKc;
  if (active) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_a(s, s);
      cp_async_commit();
    }
  }
  const int kwt = streamed ? kw / kKc : nk;
  for (int kc = 0; kc < nk; kc += kwt) {
    const int kend = kc + kwt < nk ? kc + kwt : nk;
    if (streamed) {
      __syncthreads();  // every warp is done with the previous chunk
      load_w(kc * kKc, (kend - kc) * kKc);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    for (int kt = kc; kt < kend; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncwarp();
      const int next = kt + kStages - 1;
      if (next < nk) load_a(next % kStages, next);
      cp_async_commit();
      const uint32_t stage = ring + (kt % kStages) * kStageBytes;
#pragma unroll
      for (int kk = 0; kk < kK16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) ldmatrix_x4(stage + a_off[mi][kk], a[mi]);
        const int k = (kt - kc) * kKc + kk * 16 + b_row;
#pragma unroll
        for (int nb = 0; nb < G; ++nb) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              w_tile + swz(static_cast<uint32_t>(k * NC * 2 + (nb * 16 + b_col) * 2)), b);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * nb], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * nb + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
  }
  if (active) cp_async_wait<0>();
  __syncwarp();
}

// Residuals of the trainable forward at the steps where a row is frozen:
// cs = bf16(c), the frozen cell carry (zeros where c is null), and zeros
// for the `ngates` gate blocks of `gates`. All null for serving.
struct FrozenResiduals {
  const float* c = nullptr;        // [B, H] the carry's cell state
  __nv_bfloat16* cs = nullptr;     // [F, B, H]
  __nv_bfloat16* gates = nullptr;  // [F, B, ngates H]
  int ngates = 0;
};

// Calls fn(b, o, nf) for each (caller row b, unit pair at offset o = b * H
// + unit) that the block owns: row group `group`'s chunks of the order and
// unit tiles lane_id, lane_id + lanes, ...; nf is the row's num_frames
// clamped to 0..F (a caller input).
template <typename Fn>
__device__ __forceinline__ void for_owned_pairs(const int* __restrict__ order,
                                                const int* __restrict__ num_frames, int F, int B,
                                                int H, int group, int groups, int lane_id,
                                                int lanes, Fn fn) {
  const int tiles = H / kUnits;
  const int my_tiles = lane_id < tiles ? (tiles - lane_id + lanes - 1) / lanes : 0;
  const int chunks = (B + kChunk - 1) / kChunk;
  const int my_chunks = chunks > group ? (chunks - group + groups - 1) / groups : 0;
  const int items = my_chunks * kChunk * my_tiles * (kUnits / 2);
  for (int idx = threadIdx.x; idx < items; idx += kThreads) {
    const int pair = idx % (kUnits / 2);
    const int tile = lane_id + lanes * ((idx / (kUnits / 2)) % my_tiles);
    const int row = idx / (kUnits / 2) / my_tiles;
    const int p = (group + groups * (row / kChunk)) * kChunk + row % kChunk;
    if (p >= B) continue;
    const int b = __ldg(order + p);
    const int nf = min(max(__ldg(num_frames + b), 0), F);
    fn(b, static_cast<size_t>(b) * H + tile * kUnits + pair * 2, nf);
  }
}

// The steps at which a row's video has no frame hold its carry: forward,
// the steps from num_frames on hold the final state; reverse, the steps
// before F - num_frames hold the initial one. For the block's rows (row
// group `group`) and unit tiles, out[t] = bf16(h) at those steps, and the
// residuals `res` (trainable forward): called with the initial state
// before the first step under `reverse`, with the final state after the
// last step otherwise. These writes need no step's barrier: the block owns
// these rows and units.
__device__ __forceinline__ void write_frozen_steps(const int* __restrict__ order,
                                                   const int* __restrict__ num_frames, int F,
                                                   int B, int H, bool reverse, int group,
                                                   int groups, int lane_id, int lanes,
                                                   const float* __restrict__ h,
                                                   __nv_bfloat16* __restrict__ out,
                                                   const FrozenResiduals& res = {}) {
  const size_t step = static_cast<size_t>(B) * H;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
  for_owned_pairs(order, num_frames, F, B, H, group, groups, lane_id, lanes,
                  [&](int b, size_t o, int nf) {
    const int t0 = reverse ? 0 : nf;
    const int t1 = reverse ? F - nf : F;
    if (t0 >= t1) return;
    const float2 v = *reinterpret_cast<const float2*>(h + o);
    const __nv_bfloat162 hv = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 cv = zero;
    if (res.c != nullptr) {
      const float2 cc = *reinterpret_cast<const float2*>(res.c + o);
      cv = __floats2bfloat162_rn(cc.x, cc.y);
    }
    const size_t og = static_cast<size_t>(b) * res.ngates * H + (o - static_cast<size_t>(b) * H);
    for (int t = t0; t < t1; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(out + t * step + o) = hv;
      if (res.cs != nullptr) *reinterpret_cast<__nv_bfloat162*>(res.cs + t * step + o) = cv;
      for (int g = 0; g < res.ngates; ++g)
        *reinterpret_cast<__nv_bfloat162*>(res.gates + t * step * res.ngates + og +
                                           static_cast<size_t>(g) * H) = zero;
    }
  });
}

// ---------------------------------------------------------------------------
// The trainable backward: products with W^T.
// ---------------------------------------------------------------------------
//
// A backward step multiplies bf16 cotangents [rows, K] (K = 4H for the
// LSTM; 2H and H for the GRU's two products) by W^T, where W is [H, K]:
// the B operand of a unit tile is W's rows of its 16 units, [16, K] bf16,
// read with plain ldmatrix (W's rows are B's columns, contiguous in the
// depth). A K four times the forward's makes a step's A stream four times
// as long, so its ring takes 64-deep stages (4 KB for 32 rows) and as
// many of them as the shared memory left beside the weights holds, given
// to the warps that own row chunks (ring_warps; the other warps of the
// block idle): at B=256 four warps own a chunk each.

constexpr int kKcT = 64;                       // depth of a backward ring stage
constexpr int kStageBytesT = kChunk * kKcT * 2;  // 4 KB
constexpr int kMaxStagesT = 8;
constexpr int kMaxSmem = 232448;               // a block's shared memory, at most

// cp.async.wait_group takes an immediate: the ring's runtime depth picks one.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// Copies depth k0 .. k0 + kw - 1 of W's rows j0 .. j0 + 15 (ldw columns a
// row) into the tile [16][stride] at `tile`: row n is stride * 2 bytes
// (stride >= kw, a multiple of 64), its 16-byte chunk ch stored at chunk
// ch ^ (n % 8), so that the eight rows an ldmatrix reads at one depth land
// in eight bank groups. Every thread of the block takes part; the caller
// waits and synchronises.
__device__ __forceinline__ void load_wt_tile(uint32_t tile, const __nv_bfloat16* __restrict__ W,
                                             int ldw, int j0, int k0, int kw, int stride) {
  const int per_row = kw / 8;
  for (int idx = threadIdx.x; idx < kUnits * per_row; idx += kThreads) {
    const int n = idx / per_row;
    const int ch = idx % per_row;
    cp_async16(tile + static_cast<uint32_t>(n * stride * 2 + ((ch ^ (n & 7)) << 4)),
               W + static_cast<size_t>(j0 + n) * ldw + k0 + ch * 8, 16);
  }
}

// acc[mi][q][e]: row mi * 16 + (lane / 4) + 8 (e / 2) of the chunk, unit
// q * 8 + (lane % 4) * 2 + (e % 2) of the tile, of
//
//   acc = A[rows, 0:K] @ Wt[0:K, 0:16]     (Wt[k][n] = W[j0 + n][k])
//
// A's rows are `rows` (each lda bf16 apart; rows not ok read as zeros).
// The depth runs through the warp's ring of `stages` 64-deep stages (at
// `ring`), in ascending 16-deep steps into one accumulator. Resident: the
// whole [16][K] tile lies at `w_tile`. Streamed: before each K chunk of kw
// the block synchronises and load_w(k0, n) fills `w_tile` (depth k0 .. k0
// + n - 1 as [16][kw]);
// every warp of the block must call this then, `active` false for a warp
// without a chunk.
template <typename LoadW>
__device__ __forceinline__ void chunk_product_wt(float (&acc)[2][2][4], bool active,
                                                 const __nv_bfloat16* __restrict__ A, int lda,
                                                 const ChunkRows& rows, int K, uint32_t ring,
                                                 int stages, uint32_t w_tile, bool streamed,
                                                 int kw, LoadW load_w) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][q][e] = 0.0f;

  // The lane copies 32 bytes of each of its four rows a stage.
  const __nv_bfloat16* src[4];
  uint32_t dst[4][2];
  int bytes[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = (lane >> 2) + 8 * j;
    src[j] = A + static_cast<size_t>(rows.b[j]) * lda + (lane & 3) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      dst[j][h] = swz(static_cast<uint32_t>(row * kKcT * 2 + ((lane & 3) * 2 + h) * 16));
    bytes[j] = rows.ok[j] ? 16 : 0;
  }
  auto load_a = [&](int slot, int kt) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        cp_async16(ring + slot * kStageBytesT + dst[j][h], src[j] + kt * kKcT + h * 8,
                   bytes[j]);
  };
  constexpr int kK16 = kKcT / 16;
  uint32_t a_off[2][kK16];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int kk = 0; kk < kK16; ++kk)
      a_off[mi][kk] = swz(static_cast<uint32_t>((mi * 16 + (lane & 15)) * kKcT * 2 +
                                                (kk * 2 + (lane >> 4)) * 16));
  // ldmatrix.x4 of B: matrices (units 0-7, depth 0-7), (0-7, 8-15),
  // (8-15, 0-7), (8-15, 8-15), one 8-unit row a lane.
  const int b_n = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int b_ch = (lane >> 3) & 1;

  const int nk = K / kKcT;
  if (active) {
    for (int s = 0; s < stages - 1; ++s) {
      if (s < nk) load_a(s, s);
      cp_async_commit();
    }
  }
  const int kwt = streamed ? kw / kKcT : nk;
  const int row_bytes = (streamed ? kw : K) * 2;
  for (int kc = 0; kc < nk; kc += kwt) {
    const int kend = kc + kwt < nk ? kc + kwt : nk;
    if (streamed) {
      __syncthreads();  // every warp is done with the previous chunk
      load_w(kc * kKcT, (kend - kc) * kKcT);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    const uint32_t b_row = w_tile + static_cast<uint32_t>(b_n * row_bytes);
    for (int kt = kc; kt < kend; ++kt) {
      cp_async_wait_dyn(stages - 2);
      __syncwarp();
      const int next = kt + stages - 1;
      if (next < nk) load_a(next % stages, next);
      cp_async_commit();
      const uint32_t stage = ring + (kt % stages) * kStageBytesT;
#pragma unroll
      for (int kk = 0; kk < kK16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) ldmatrix_x4(stage + a_off[mi][kk], a[mi]);
        const int ch = ((kt - kc) * kKcT + kk * 16) / 8 + b_ch;
        uint32_t b[4];
        ldmatrix_x4(b_row + static_cast<uint32_t>((ch ^ (b_n & 7)) << 4), b);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][0], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  if (active) cp_async_wait<0>();
  __syncwarp();
}

// The backward's plan: the forward's grid (make_plan), then its ring: the
// warps that own a chunk of the largest live prefix (at most kWarps), and
// the most 64-deep stages a warp (2 .. kMaxStagesT) that keep the grid
// co-resident.
struct BwdPlan {
  Plan p;
  int ring_warps;
  int stages;
};

template <typename Kernel>
cudaError_t make_bwd_plan(Kernel kernel, int B, int H, int cols, BwdPlan* plan) {
  cudaError_t err = make_plan(kernel, B, H, cols, &plan->p);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int chunks = (B + kChunk - 1) / kChunk;
  const int mine = (chunks + plan->p.groups - 1) / plan->p.groups;
  plan->ring_warps = mine < kWarps ? mine : kWarps;
  const int w_bytes = plan->p.smem - kRingBytes;
  for (int stages = kMaxStagesT; stages >= 2; --stages) {
    const int smem = w_bytes + plan->ring_warps * stages * kStageBytesT;
    if (smem > kMaxSmem) continue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm * sms < plan->p.grid) continue;
    plan->stages = stages;
    plan->p.smem = smem;
    return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

// The backward's frozen steps, before its first step: for the block's rows
// and units, the cotangents of every frozen step (0 there: a frozen step
// has no product) into `zero` ([F, B, nzero H], the gate cotangents of
// the step) and, if given, `zero_h` ([F, B, H]). Forward, the frozen steps
// (num_frames on) come first in the backward and pass dh through: dh
// (f32 [B, H], the final h's cotangent on entry) takes their bf16(dout_t)
// one at a time, t = F-1 down, as the steps would add them. Reverse, the
// frozen steps come last and their carry reaches only the initial state,
// which no caller reads: only the zeros.
__device__ __forceinline__ void backward_frozen_steps(
    const int* __restrict__ order, const int* __restrict__ num_frames, int F, int B, int H,
    bool reverse, int group, int groups, int lane_id, int lanes,
    const __nv_bfloat16* __restrict__ dout, float* __restrict__ dh, __nv_bfloat16* zero,
    int nzero, __nv_bfloat16* zero_h) {
  const size_t step = static_cast<size_t>(B) * H;
  const __nv_bfloat162 z = __floats2bfloat162_rn(0.0f, 0.0f);
  for_owned_pairs(order, num_frames, F, B, H, group, groups, lane_id, lanes,
                  [&](int b, size_t o, int nf) {
    const int t0 = reverse ? 0 : nf;
    const int t1 = reverse ? F - nf : F;
    if (t0 >= t1) return;
    const size_t og = static_cast<size_t>(b) * nzero * H + (o - static_cast<size_t>(b) * H);
    for (int t = t0; t < t1; ++t) {
      for (int g = 0; g < nzero; ++g)
        *reinterpret_cast<__nv_bfloat162*>(zero + t * step * nzero + og +
                                           static_cast<size_t>(g) * H) = z;
      if (zero_h != nullptr) *reinterpret_cast<__nv_bfloat162*>(zero_h + t * step + o) = z;
    }
    if (reverse) return;
    float2 d = *reinterpret_cast<const float2*>(dh + o);
    for (int t = F - 1; t >= nf; --t) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(dout + t * step + o);
      d.x = __fadd_rn(d.x, __low2float(v));
      d.y = __fadd_rn(d.y, __high2float(v));
    }
    *reinterpret_cast<float2*>(dh + o) = d;
  });
}

}  // namespace persist
