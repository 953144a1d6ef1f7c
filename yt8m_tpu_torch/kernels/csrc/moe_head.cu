// Fused mixture-of-experts head serving kernel for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/moe_head.py :: moe_head_serving. For hidden
// activations x [B, H] f32 and a per-class mixture of M experts:
//
//   G = bf16(x) @ Wg          [B, C*(M+1)]   class-major: column c*(M+1)+m
//   E = bf16(x) @ We + be     [B, C*M]       column c*M+m
//   eg = exp(clamp(G, -80, 80))
//   probs[b, c] = sum_{m<M} eg[c, m] * sigmoid(E[c, m]) / sum_{m<=M} eg[c, m]
//
// The softmax is in ratio form with clamped logits, as the TPU kernel
// computes it; the dummy expert (m = M) adds to the denominator only.
//
// What bounds it: the two products, 2 B H C (2M + 1) operations: 49.4
// GFLOP at B=512, H=2048, C=4716, M=2 (0.050 ms at 989 TFLOP/s) against
// 96.6 MB of bf16 weights (0.029 ms at 3.35 TB/s), and 98.9 GFLOP at
// B=2048, H=1024. So the bf16 tensor-core rate, with the weights read
// from device memory once.
//
// Design. Two launches on the caller's stream:
//  1. A = bf16(x), round to nearest even, into a [B, H] buffer from the
//     wrapper (input_affine.cuh's rounding launch).
//  2. moe_head_kernel, on hopper_gemm.cuh's TMA + wgmma mainloop. A block
//     takes 128 videos x NC classes: the gate chain (wgmma width NC*(M+1),
//     columns c0*(M+1)..) and the expert chain (NC*M, columns c0*M..) run
//     on the same A stage, from the boxes of 64 columns that cover each
//     (M=2: NC=48, chains of 144 and 96 columns, 3 + 2 boxes). Blocks of one class tile are neighbours in launch order
//     (the row tile is blockIdx.x), so each weight tile comes from device
//     memory once and from L2 for the other row tiles: 96.6 MB at H=2048
//     exceeds the 50 MB L2, and the class-fastest order read the weights
//     once per row tile. The epilogue stages the accumulators over the
//     ring in shared memory, then one thread per (video, class) combines
//     its M+1 gates and M experts, so neither the [B, C, M+1] softmax nor
//     the [B, C, M] sigmoid reaches device memory. The TPU kernel's 0/1
//     selection matmul, a workaround for strided VMEM access, is not
//     needed here. C=4716 is not a multiple of NC: the last tile masks its
//     classes, and TMA reads the columns past the weights as zeros.
//
// Any H: the rounded x is stored at a row pitch of H rounded up to 8 (a
// TMA row stride is a multiple of 16 bytes), and the mainloop's last
// 64-deep stage reads the columns of x and the rows of the weights past H
// as TMA's zero fill; zero terms leave the sums exact.
//
// The f32 route (--compute_dtype=float32, f32 weights), one launch:
// moe_f32_kernel, the same function with nothing rounded, as the TPU
// kernel computes it at dtype=float32, the products in plain f32 FMAs
// (f32_product.cuh: no TF32). Bound by the f32 rate outside the tensor
// cores: 49.4 GFLOP at B=512, H=2048, C=4716, M=2, 0.74 ms at 67
// TFLOP/s, against 193 MB of f32 weights (0.06 ms). A block takes 128
// videos x NC = floor(128 / (2M + 1)) classes (M=2: 25): the 128 columns
// of its B panel are the NC classes' gate columns, then their expert
// columns, loaded from the two weights by scalar loads (a warp's 32
// neighbouring columns are neighbours in device memory). The row tile
// runs fastest, so the blocks of a class tile read its weights about at
// once, from device memory once. The epilogue stages the sums in shared
// memory and one thread a (video, class) combines them with expf and
// true divisions. One block an SM: with two (128 registers a thread)
// ptxas spilled 104-256 bytes and the call took 2.26 ms against 1.59 (an
// H100 at 700 W, the same call).
//
// TMA needs row strides that are multiples of 16 bytes: the weights come
// as views whose row stride is padded to a multiple of 8 columns
// (kernels/moe_head.py :: pitched), C*(M+1) = 14,148 being no multiple of 8.
//
// M in {1, 2, 4} is a template argument; any other M up to 121 is taken
// at run time by one more instantiation (M = 0) with chains of 136 and
// 128 columns. TMA starts a box only at a column that is a multiple of 8
// (16 bytes): a box whose start is not hangs the stage's barrier (found on
// the card: the bf16 kernel trapped at its 10 s wait from M = 3 with 34
// classes a block, whose expert columns start at 102). The M = 0 tile
// therefore loads from the tile's first gate and expert columns rounded
// down to 8 and reads its columns r = start % 8 further on, which leaves
// room for NC = min(129 / (M + 1), 121 / M) classes (M = 32: 3 classes,
// 99 and 96 columns). The template tiles' starts are multiples of 8.
// Chain widths are multiples of 8 up to 256 and split at box edges
// (hopper_gemm.cuh :: chain). The accumulators of a tile stay near 128
// registers a thread: with 160 (NC=64 at M=2) ptxas spilled them and
// serialized the wgmma chains.
//
// M > 121 (the M = -1 instantiation): a block takes 128 videos x one
// class and loops over chunks of 120 mixtures, a whole mainloop over H a
// chunk on the same ring (3 stages): gates 120 j .. of the class (and the
// last chunk's dummy gate M) in the 136-column chain, experts 120 j .. in
// the 128-column one, each from its start rounded down to 8. The clamp
// keeps every exp finite, so the ratio form's numerator and denominator
// are plain sums across chunks, kept in registers for the thread's two
// rows. A gate and the expert of the same mixture sit r_e - r_g columns
// apart in the two chains, so each warp stages its 8 rows' exp(gate)
// values in a slot of its own beside the ring, [8][136] f32, read back by
// the thread holding the expert; the quad's four lanes join the sums, and
// one lane divides after the last chunk (a true division: (M + 1) e^80
// passes 2^126 at M > 1542, where the fast division gives 0). The slots
// lie outside the ring, so the next chunk loads while a chunk is combined.
//
// The f32 route takes NC = floor(128 / (2M + 1)) classes up to M = 63;
// above, a block takes one class and loops over chunks of 63 mixtures (at
// most 64 gate and 63 expert columns of the 128-column B panel), the
// combine of each chunk added into the row's sums in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_product.cuh"
#include "hopper_gemm.cuh"
#include "input_affine.cuh"

namespace {

constexpr int kRingStages = 4;  // ring stages of the M >= 0 tiles
constexpr int kRuntimeGate = 136;   // the run-time tiles' chain widths
constexpr int kRuntimeExpert = 128;
constexpr int kChunkMixtures = 120;  // mixtures a chunk of M > 128: 120 + 7 <= 128 columns
constexpr int kAlignCols = 8;  // TMA box starts: multiples of 16 bytes
// M = 0 takes M <= 121 (one class past a 7-column offset); M = -1 above.
constexpr int kMaxRuntimeMixtures = kRuntimeExpert - kAlignCols + 1;

// The tile of M mixtures (M = 0: the run-time instantiation, M = -1: the
// chunked one): classes a block and the widths of its gate and expert
// chains. The chains' 2 B accumulators a column stay under ~130
// registers a thread (two wgmma chains in flight beside them within the
// consumers' 232). The run-time tiles' classes are runtime_classes(m).
struct Tile {
  int nc, gate, expert;
};
__host__ __device__ constexpr Tile tile_of(int m) {
  return m == 1 ? Tile{80, 160, 80}
                : m == 2 ? Tile{48, 144, 96}
                         : m == 4 ? Tile{16, 80, 64} : Tile{1, kRuntimeGate, kRuntimeExpert};
}

// Classes a block of the run-time tile at m <= 121 mixtures: as many as
// both chains cover past an offset of up to 7 columns (so the bias slot's
// NC m <= 128 floats).
__host__ __device__ constexpr int runtime_classes(int m) {
  return (kRuntimeGate - kAlignCols + 1) / (m + 1) < (kRuntimeExpert - kAlignCols + 1) / m
             ? (kRuntimeGate - kAlignCols + 1) / (m + 1)
             : (kRuntimeExpert - kAlignCols + 1) / m;
}

// The instantiation that takes m mixtures.
__host__ __device__ constexpr int instance_of(int m) {
  return m == 1 || m == 2 || m == 4 ? m : m <= kMaxRuntimeMixtures ? 0 : -1;
}

// Classes a block at m mixtures (1 for the chunked instantiation).
__host__ __device__ constexpr int classes_of(int m) {
  return instance_of(m) > 0 ? tile_of(m).nc : instance_of(m) == 0 ? runtime_classes(m) : 1;
}

// Mixture chunks a block walks at m mixtures.
__host__ __device__ constexpr int chunks_of(int m) {
  return instance_of(m) < 0 ? (m + kChunkMixtures - 1) / kChunkMixtures : 1;
}

// Floats a row of the epilogue's stage: the chains' columns padded to 8
// more than a multiple of 32 (the float2 stores of a warp hit 32 banks).
__host__ __device__ constexpr int stage_ld(int cols) { return cols + (8 - cols % 32 + 32) % 32; }

// The ring and shared memory of M's tile: a stage holds the A tile, then
// the gate chain's boxes, then the expert chain's.
template <int M>
struct Layout {
  static constexpr Tile kTile = tile_of(M);
  static constexpr int kStages = M < 0 ? 3 : kRingStages;  // the chunks' slots take a stage's room
  static constexpr int kGateBoxes = hgemm::boxes(kTile.gate);
  static constexpr int kExpertBoxes = hgemm::boxes(kTile.expert);
  static constexpr int kStageBytes =
      hgemm::kABytes + (kGateBoxes + kExpertBoxes) * hgemm::kBoxBytes;
  // The chunks' per-warp slots of exp(gate), [8 warps][8 rows][gate].
  static constexpr int kSlotFloats = M < 0 ? hgemm::kConsumerWarps * 8 * kTile.gate : 0;
  // The ring, its barriers, then the tile's expert bias (NC*M <= 128), then
  // the slots.
  static constexpr int kSmemRequest = hgemm::smem_request(kStages * kStageBytes + 2 * kStages * 8 +
                                                          128 * 4 + kSlotFloats * 4);
  static constexpr int kLd = stage_ld(kTile.gate + kTile.expert);
  static_assert(kSmemRequest <= 232448, "shared memory a block");
  static_assert(hgemm::kRows * kLd * 4 <= kStages * kStageBytes, "the staged tile fits the ring");
  static_assert(M <= 0 || kTile.nc * M <= 128, "the bias fits its slot");
  static_assert(M <= 0 || (kTile.nc * (M + 1) <= kTile.gate && kTile.nc * M <= kTile.expert),
                "the chains cover the tile's classes");
  static_assert(M > 0 || (kTile.gate == kRuntimeGate && kTile.expert == kRuntimeExpert),
                "the run-time tiles");
  static_assert(kChunkMixtures + 1 + kAlignCols - 1 <= kRuntimeGate &&
                    kChunkMixtures + kAlignCols - 1 <= kRuntimeExpert,
                "a chunk's gates (and the dummy) and experts fit the chains past an offset");
};

template <int M>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
moe_head_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_g,
                const __grid_constant__ CUtensorMap map_e, const float* __restrict__ be,
                float* __restrict__ out, int B, int H, int C, int runtime_m) {
  using L = Layout<M>;
  constexpr Tile kT = L::kTile;
  constexpr int kAcc = (kT.gate + kT.expert) / 2;
  constexpr int kLd = L::kLd;
  constexpr int kStageBytes = L::kStageBytes;
  constexpr int kS = L::kStages;
  const int m_ = M > 0 ? M : runtime_m;
  const int nc = M > 0 ? kT.nc : M == 0 ? runtime_classes(m_) : 1;
  const int n_chunks = M < 0 ? (m_ + kChunkMixtures - 1) / kChunkMixtures : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kS * kStageBytes);
  uint64_t* empty = full + kS;
  const int nk = (H + hgemm::kDepth - 1) / hgemm::kDepth;
  const int b0 = blockIdx.x * hgemm::kRows;
  const int c0 = blockIdx.y * nc;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      hgemm::bar_init(&full[s], 1);
      hgemm::bar_init(&empty[s], hgemm::kConsumerWarps);
    }
    hgemm::bar_init_fence();
  }
  __syncthreads();
  // The first gate and expert columns of chunk j of the tile, and their
  // TMA starts (rounded down to 8; the template tiles' are multiples of 8).
  auto gate0 = [&](int j) { return c0 * (m_ + 1) + j * kChunkMixtures; };
  auto expert0 = [&](int j) { return c0 * m_ + j * kChunkMixtures; };
  auto start = [](int col) { return M > 0 ? col : col & ~(kAlignCols - 1); };

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* xmap = &map_x;  // the parameter itself (TMA reads it there)
  const CUtensorMap* gmap = &map_g;
  const CUtensorMap* emap = &map_e;
  // The stage's gate and expert chains into acc.
  auto mma_stage = [&](int s, float* acc) {
    const uint32_t st = hgemm::smem_u32(smem + s * Layout<M>::kStageBytes);
    const uint32_t gates = st + hgemm::kABytes;
    const uint32_t a_off = wg * 64 * hgemm::kDepth * 2;
#pragma unroll
    for (int kk = 0; kk < hgemm::kDepth / 16; ++kk) {
      hgemm::chain<Layout<M>::kTile.gate>(acc, st + a_off, gates, kk);
      hgemm::chain<Layout<M>::kTile.expert>(acc + Layout<M>::kTile.gate / 2, st + a_off,
                                            gates + Layout<M>::kGateBoxes * hgemm::kBoxBytes, kk);
    }
  };
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int j = 0; j < n_chunks; ++j) {
        const int g0 = start(gate0(j));
        const int e0 = start(expert0(j));
        hgemm::produce<kS>(full, empty, ring, nk, kStageBytes, [&](int s, uint64_t* bar, int kt) {
          unsigned char* st = smem + s * L::kStageBytes + hgemm::kABytes;
          const int k0 = kt * hgemm::kDepth;
          hgemm::tma_2d(st - hgemm::kABytes, xmap, bar, k0, b0);
#pragma unroll
          for (int i = 0; i < L::kGateBoxes; ++i)
            hgemm::tma_2d(st + i * hgemm::kBoxBytes, gmap, bar, g0 + i * hgemm::kBoxCols, k0);
#pragma unroll
          for (int i = 0; i < L::kExpertBoxes; ++i)
            hgemm::tma_2d(st + (L::kGateBoxes + i) * hgemm::kBoxBytes, emap, bar,
                          e0 + i * hgemm::kBoxCols, k0);
        });
      }
    }
  } else if constexpr (M >= 0) {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    // The tile's expert bias, read once (the combine below reads it per
    // (video, class)); the first named barrier orders it.
    float* bias = reinterpret_cast<float*>(empty + kS);
    for (int i = threadIdx.x; i < nc * m_; i += 256)
      bias[i] = c0 * m_ + i < C * m_ ? be[static_cast<size_t>(c0) * m_ + i] : 0.0f;
    // Gate columns in acc[0, gate/2), expert columns after them.
    float acc[kAcc];
    hgemm::zero<kAcc>(acc);
    hgemm::consume<kS, kAcc>(full, empty, ring, nk, acc, [&](int s) { mma_stage(s, acc); });
    // Where the tile's first gate and expert columns sit in the chains.
    const int r_g = gate0(0) - start(gate0(0));
    const int r_e = expert0(0) - start(expert0(0));

    // Both warpgroups are past the ring and every load has landed: stage
    // the accumulators over it, [128 rows][gate columns, expert columns].
    hgemm::named_sync(1, 256);
    float* stage = reinterpret_cast<float*>(smem);
    const int lane = threadIdx.x & 31;
    const int row = wg * 64 + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(stage + (row + 8 * h) * kLd + 8 * j + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    hgemm::named_sync(1, 256);

    // One thread per (video, class) combines its M+1 gates and M experts,
    // with the fast exponential and division (~1e-6 relative, well inside
    // the 1e-3 * max|ref| bound).
    for (int p = threadIdx.x; p < hgemm::kRows * nc; p += 256) {
      const int r = p / nc;
      const int c = p - r * nc;
      const int b = b0 + r;
      const int cls = c0 + c;
      if (b >= B || cls >= C) continue;
      const float* g = stage + r * kLd + r_g + c * (m_ + 1);
      const float* e = stage + r * kLd + kT.gate + r_e + c * m_;
      float den = 0.0f;
      float num = 0.0f;
      auto term = [&](int m) {
        const float eg = __expf(fminf(fmaxf(g[m], -80.0f), 80.0f));
        den += eg;
        if (m < m_) {
          const float logit = e[m] + bias[c * m_ + m];
          num += eg * __frcp_rn(1.0f + __expf(-logit));
        }
      };
      if constexpr (M > 0) {
#pragma unroll
        for (int m = 0; m <= M; ++m) term(m);
      } else {
        for (int m = 0; m <= m_; ++m) term(m);
      }
      // den <= 129 exp(80) < 2^126, where __fdividef is within 2 ulp.
      out[static_cast<size_t>(b) * C + cls] = __fdividef(num, den);
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    // M > 128: one class, chunks of 120 mixtures. Thread rows wg 64 + 16
    // warp + lane / 4 + 8 h; chain column t = 8 j + 2 (lane % 4) + e holds
    // gate column start(gate0) + t in acc[4 j + 2 h + e] and expert column
    // start(expert0) + t in acc[kT.gate / 2 + ...].
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int rl = lane >> 2;  // the row's place among the warp's 8
    const float* be_c = be + static_cast<size_t>(c0) * m_;
    float* slot = reinterpret_cast<float*>(empty + kS) + 128 + (threadIdx.x / 32) * 8 * kT.gate;
    float num[2] = {0.0f, 0.0f};
    float den[2] = {0.0f, 0.0f};
    float acc[kAcc];
    for (int j = 0; j < n_chunks; ++j) {
      hgemm::zero<kAcc>(acc);
      hgemm::consume<kS, kAcc>(full, empty, ring, nk, acc, [&](int s) { mma_stage(s, acc); });
      const int mix0 = j * kChunkMixtures;
      const bool last = j == n_chunks - 1;
      const int r_g = gate0(j) - start(gate0(j));
      const int r_e = expert0(j) - start(expert0(j));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // The chunk's gates are mixtures mix0 + u, u < 120, and the dummy
        // (u = 120 on the last chunk); exp(clamped gate) to the row's slot.
#pragma unroll
        for (int jj = 0; jj < kT.gate / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 8 * jj + 2 * q + e;
            const int u = t - r_g;
            const bool ok = u >= 0 && mix0 + u <= m_ && (u < kChunkMixtures || last);
            const float eg =
                ok ? __expf(fminf(fmaxf(acc[4 * jj + 2 * h + e], -80.0f), 80.0f)) : 0.0f;
            den[h] += eg;
            slot[rl * kT.gate + t] = eg;
          }
        __syncwarp();
        // Expert mixture mix0 + u at column t = u + r_e, its gate at u + r_g.
#pragma unroll
        for (int jj = 0; jj < kT.expert / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 8 * jj + 2 * q + e;
            const int u = t - r_e;
            if (u >= 0 && u < kChunkMixtures && mix0 + u < m_) {
              const float logit = acc[kT.gate / 2 + 4 * jj + 2 * h + e] + __ldg(be_c + mix0 + u);
              num[h] += slot[rl * kT.gate + u + r_g] * __frcp_rn(1.0f + __expf(-logit));
            }
          }
        __syncwarp();
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      num[h] += __shfl_xor_sync(0xffffffffu, num[h], 1);
      num[h] += __shfl_xor_sync(0xffffffffu, num[h], 2);
      den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
      den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
      const int b = b0 + wg * 64 + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2) + 8 * h;
      if (q == 0 && b < B) out[static_cast<size_t>(b) * C + c0] = num[h] / den[h];
    }
  }
}

// M > 0: the instantiation for that M; M = 0: the one taking m at run time.
// The row pitch of the rounded x: H rounded up to 8 (16-byte rows).
inline int x_pitch(int H) { return (H + 7) / 8 * 8; }

template <int M>
int launch(const void* x, const void* wg, const void* we, const void* be, void* xa, void* out,
           int B, int H, int C, int m, int ldg, int lde, cudaStream_t st) {
  using L = Layout<M>;
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = inaff::launch_round_bf16(static_cast<const float*>(x), static_cast<__nv_bfloat16*>(xa),
                                   static_cast<size_t>(B), H, x_pitch(H), st);
  CUtensorMap map_x, map_g, map_e;
  if (err == cudaSuccess)
    err = hgemm::make_map_2d(&map_x, xa, B, H, x_pitch(H), hgemm::kRows);
  if (err == cudaSuccess) err = hgemm::make_map_2d(&map_g, wg, H, C * (m + 1), ldg, hgemm::kDepth);
  if (err == cudaSuccess) err = hgemm::make_map_2d(&map_e, we, H, C * m, lde, hgemm::kDepth);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(moe_head_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kSmemRequest);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = classes_of(m);
  const dim3 grid((B + hgemm::kRows - 1) / hgemm::kRows, (C + nc - 1) / nc);
  moe_head_kernel<M><<<grid, hgemm::kThreads, L::kSmemRequest, st>>>(
      map_x, map_g, map_e, static_cast<const float*>(be), static_cast<float*>(out), B, H, C, m);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The f32 route.
// ---------------------------------------------------------------------------

// Classes a tile of the f32 route: their gate and expert columns fill at
// most the 128 columns of the product's B panel; 0 (M >= 64): a block
// takes one class in chunks of kF32ChunkMixtures mixtures, whose gates
// (and the last chunk's dummy) and experts fill at most 64 + 63 columns.
__host__ __device__ constexpr int f32_classes(int m) { return f32p::kCols / (2 * m + 1); }
constexpr int kF32ChunkMixtures = (f32p::kCols - 1) / 2;  // 63
__host__ __device__ constexpr int f32_class_tiles(int C, int m) {
  return f32_classes(m) > 0 ? (C + f32_classes(m) - 1) / f32_classes(m) : C;
}

// The B panel of a class tile: column j < NC (M+1) is gate column
// c0 (M+1) + j, the next NC M columns are expert columns c0 M + ..., the
// rest (and the columns of classes past C, and the depth past H) zeros.
struct MoeColumns {
  const float* wg;
  const float* we;
  int ldg, lde, H;
  int gate_cols, expert_cols;  // NC (M+1), NC M
  int g0, e0;                  // c0 (M+1), c0 M
  int g_end, e_end;            // C (M+1), C M
  float v[16];

  __device__ __forceinline__ const float* column(int* ld) const {
    const int c = threadIdx.x & (f32p::kCols - 1);
    if (c < gate_cols) {
      *ld = ldg;
      return g0 + c < g_end ? wg + g0 + c : nullptr;
    }
    const int e = c - gate_cols;
    *ld = lde;
    return e < expert_cols && e0 + e < e_end ? we + e0 + e : nullptr;
  }

  __device__ __forceinline__ void fetch(int d0, float*) {
    int ld = 0;
    const float* p = column(&ld);
    const int r0 = d0 + (threadIdx.x >> 7) * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = p != nullptr && r0 + i < H ? __ldg(p + static_cast<size_t>(r0 + i) * ld) : 0.0f;
  }

  __device__ __forceinline__ void store(float* panel) {
    const int c = threadIdx.x & (f32p::kCols - 1);
    const int r0 = (threadIdx.x >> 7) * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i) panel[(r0 + i) * f32p::kCols + c] = v[i];
  }
};

// probs [B, C] from x [B, H] f32, wg [H, C*(M+1)] and we [H, C*M] f32 at
// row strides ldg and lde, be [C*M] f32; all in f32.
template <bool VecX>
__global__ void __launch_bounds__(f32p::kThreads)
moe_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
               const float* __restrict__ we, const float* __restrict__ be,
               float* __restrict__ out, int B, int H, int C, int m, int ldg, int lde) {
  extern __shared__ __align__(16) float fsmem[];
  const int nc = f32_classes(m);
  const int b0 = blockIdx.x * f32p::kRows;
  const int c0 = blockIdx.y * (nc > 0 ? nc : 1);
  const int r = threadIdx.x & (f32p::kRows - 1);
  f32p::RowsA<VecX, f32p::Same> la;
  la.row = b0 + r < B ? x + static_cast<size_t>(b0 + r) * H : nullptr;
  la.depth = H;
  MoeColumns lb;
  lb.wg = wg;
  lb.we = we;
  lb.ldg = ldg;
  lb.lde = lde;
  lb.H = H;
  lb.g_end = C * (m + 1);
  lb.e_end = C * m;
  float acc[8][8];
  float* stage = fsmem;
  if (nc == 0) {
    // M >= 64: class c0, chunks of kF32ChunkMixtures mixtures; thread r <
    // 128 keeps its row's sums across chunks.
    float num = 0.0f;
    float den = 0.0f;
    const int n_chunks = (m + kF32ChunkMixtures - 1) / kF32ChunkMixtures;
    for (int j = 0; j < n_chunks; ++j) {
      const int mix0 = j * kF32ChunkMixtures;
      const int ne = min(kF32ChunkMixtures, m - mix0);
      const int ng = j == n_chunks - 1 ? m + 1 - mix0 : kF32ChunkMixtures;
      lb.gate_cols = ng;
      lb.expert_cols = ne;
      lb.g0 = c0 * (m + 1) + mix0;
      lb.e0 = c0 * m + mix0;
      f32p::product(la, lb, H, fsmem, acc);
      f32p::stage_tile(acc, stage);
      __syncthreads();
      if (threadIdx.x < f32p::kRows) {
        const float* g = stage + threadIdx.x * f32p::kCols;
        const float* e = g + ng;
        const float* bias = be + static_cast<size_t>(c0) * m + mix0;
        for (int k = 0; k < ng; ++k) {
          const float eg = expf(fminf(fmaxf(g[k], -80.0f), 80.0f));
          den += eg;
          if (k < ne) num += eg * (1.0f / (1.0f + expf(-(e[k] + __ldg(bias + k)))));
        }
      }
      __syncthreads();  // the stage is read before the next chunk's product
    }
    if (threadIdx.x < f32p::kRows && b0 + static_cast<int>(threadIdx.x) < B)
      out[static_cast<size_t>(b0 + threadIdx.x) * C + c0] = num / den;
    return;
  }
  lb.gate_cols = nc * (m + 1);
  lb.expert_cols = nc * m;
  lb.g0 = c0 * (m + 1);
  lb.e0 = c0 * m;
  f32p::product(la, lb, H, fsmem, acc);
  f32p::stage_tile(acc, stage);
  __syncthreads();
  for (int p = threadIdx.x; p < f32p::kRows * nc; p += f32p::kThreads) {
    const int row = p / nc;
    const int c = p - row * nc;
    const int b = b0 + row;
    const int cls = c0 + c;
    if (b >= B || cls >= C) continue;
    const float* g = stage + row * f32p::kCols + c * (m + 1);
    const float* e = stage + row * f32p::kCols + nc * (m + 1) + c * m;
    float den = 0.0f;
    float num = 0.0f;
    for (int k = 0; k <= m; ++k) {
      const float eg = expf(fminf(fmaxf(g[k], -80.0f), 80.0f));
      den += eg;
      if (k < m) {
        const float logit = e[k] + __ldg(be + static_cast<size_t>(cls) * m + k);
        num += eg * (1.0f / (1.0f + expf(-logit)));
      }
    }
    out[static_cast<size_t>(b) * C + cls] = num / den;
  }
}

template <bool VecX>
int launch_f32(const void* x, const void* wg, const void* we, const void* be, void* out, int B,
               int H, int C, int m, int ldg, int lde, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(moe_f32_kernel<VecX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               f32p::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + f32p::kRows - 1) / f32p::kRows, f32_class_tiles(C, m));
  moe_f32_kernel<VecX><<<grid, f32p::kThreads, f32p::kSmemBytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg), static_cast<const float*>(we),
      static_cast<const float*>(be), static_cast<float*>(out), B, H, C, m, ldg, lde);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H] f32; wg [H, C*(M+1)] and we [H, C*M] bf16 with row strides ldg
// and lde (multiples of 8); be [C*M] f32; xa a [B, H rounded up to 8]
// bf16 work buffer from the caller; out [B, C] f32.
extern "C" int yt8m_moe_head_serving(const void* x, const void* wg, const void* we,
                                     const void* be, void* xa, void* out, int B, int H, int C,
                                     int M, int ldg, int lde, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || M < 1 || static_cast<long long>(C) * (M + 1) > 0x7fffffff ||
      ldg < C * (M + 1) || ldg % 8 != 0 || lde < C * M || lde % 8 != 0 ||
      (C + classes_of(M) - 1) / classes_of(M) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (instance_of(M)) {
    case 1:
      return launch<1>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde, st);
    case 2:
      return launch<2>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde, st);
    case 4:
      return launch<4>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde, st);
    case 0:  // M <= 128, taken at run time
      return launch<0>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde, st);
    default:  // M > 128: chunks of 128 mixtures
      return launch<-1>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde, st);
  }
}

// The f32 route: x [B, H] f32; wg [H, C*(M+1)] and we [H, C*M] f32 with
// row strides ldg and lde; be [C*M] f32; out [B, C] f32. vec_x: H % 4 ==
// 0 and x 16-byte aligned (float4 loads of x).
extern "C" int yt8m_moe_head_serving_f32(const void* x, const void* wg, const void* we,
                                         const void* be, void* out, int B, int H, int C, int M,
                                         int ldg, int lde, int vec_x, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || M < 1 || static_cast<long long>(C) * (M + 1) > 0x7fffffff ||
      ldg < C * (M + 1) || lde < C * M || f32_class_tiles(C, M) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec_x ? launch_f32<true>(x, wg, we, be, out, B, H, C, M, ldg, lde, st)
               : launch_f32<false>(x, wg, we, be, out, B, H, C, M, ldg, lde, st);
}

// The tile at M mixtures: [classes a block, gate chain width, expert chain
// width, stages, shared bytes requested a block, floats a staged row,
// mixture chunks a block, the f32 route's classes a block (0: chunks of
// 63 mixtures)].
extern "C" int yt8m_moe_plan(int M, int* plan) {
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int inst = instance_of(M);
  const Tile t = tile_of(inst);
  const int smem[] = {Layout<-1>::kSmemRequest, Layout<0>::kSmemRequest, Layout<1>::kSmemRequest,
                      Layout<2>::kSmemRequest, 0, Layout<4>::kSmemRequest};
  const int stages[] = {Layout<-1>::kStages, Layout<0>::kStages, Layout<1>::kStages,
                        Layout<2>::kStages, 0, Layout<4>::kStages};
  plan[0] = classes_of(M);
  plan[1] = t.gate;
  plan[2] = t.expert;
  plan[3] = stages[inst + 1];
  plan[4] = smem[inst + 1];
  plan[5] = stage_ld(t.gate + t.expert);
  plan[6] = chunks_of(M);
  plan[7] = f32_classes(M);
  return static_cast<int>(cudaSuccess);
}
