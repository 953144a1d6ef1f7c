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
// The f32 route (--compute_dtype=float32, f32 weights): the same function
// with nothing rounded to bf16, as the TPU kernel computes it at
// dtype=float32, on the tensor cores as a 3xTF32 product (hopper_gemm.cuh
// :: consume3): x and the weights split into tf32 halves, big = tf32(v)
// and small = tf32(v - big), each logit summed as x_small W_big + x_big
// W_small + x_big W_big (about 2^-21 of each product from the f32
// product), the tensor core's sums one 32-deep stage at a time and the
// stages' added on the FMA units, rounded to nearest. 3 x 49.4 GFLOP at
// B=512, H=2048, C=4716, M=2 against the TF32 rate (494.7 TFLOP/s): 0.30
// ms at the bound, where one f32 product outside the tensor cores is
// 0.74 ms.
// Two launches, as the bf16 route: the split of x into a [2][B][H
// rounded up to 4] f32 buffer from the wrapper (input_affine.cuh ::
// split_tf32), then moe_head_kernel's F32 instance on the same tiles as
// the bf16 route (below), on a ring of 32-deep stages of both halves of
// the x tile and of each chain's weight rows. The weights arrive as split
// copies [2][C(M+1)][Hp] and [2][CM][Hp], K-major (TF32's wgmma reads B
// K-major only), which the model builds once per weight version
// (kernels/tf32.py :: split_weights): 2 x 193 MB at M=2. A K-major box
// may start at any column, so the F32 tiles load their exact first
// columns, with no offset.

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
// The F32 instances run the same tiles on 32-deep stages of 3xTF32 chains:
// M in {1, 2, 4} the template tiles, M <= 121 the run-time chains of 136
// and 128 columns, min(136 / (M + 1), 128 / M) classes a block (no offset
// to leave room for), above it chunks of 120 mixtures in chains of 128
// (the chunk's gates and the dummy) and 120 columns, on two stages beside
// the exp(gate) slots. A stage holds 2 x (128 + gate + expert) rows of 128
// bytes (92-98 KB at M = 1, 2, the run-time and the chunked tiles: two
// stages; 68 KB at M = 4: three).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// The F32 chunked tile starts its chains at the chunk's own columns: 121
// gates (the last chunk's dummy among them) in 128, 120 experts in 120.
struct Tile {
  int nc, gate, expert;
};
__host__ __device__ constexpr Tile tile_of(int m, bool f32 = false) {
  return m == 1 ? Tile{80, 160, 80}
                : m == 2 ? Tile{48, 144, 96}
                         : m == 4 ? Tile{16, 80, 64}
                                  : m < 0 && f32 ? Tile{1, 128, kChunkMixtures}
                                                 : Tile{1, kRuntimeGate, kRuntimeExpert};
}

// Columns a run-time tile's chains lose to the offset of a start rounded
// down to 8 (bf16: TMA starts a box of MN-major columns at a multiple of
// 16 bytes; F32 loads K-major rows from any column).
__host__ __device__ constexpr int lost_cols(bool f32) { return f32 ? 0 : kAlignCols - 1; }

// Classes a block of the run-time tile at m <= 121 mixtures: as many as
// both chains cover past the offset (so the bias slot's NC m <= 128
// floats).
__host__ __device__ constexpr int runtime_classes(int m, bool f32 = false) {
  return (kRuntimeGate - lost_cols(f32)) / (m + 1) < (kRuntimeExpert - lost_cols(f32)) / m
             ? (kRuntimeGate - lost_cols(f32)) / (m + 1)
             : (kRuntimeExpert - lost_cols(f32)) / m;
}

// The instantiation that takes m mixtures.
__host__ __device__ constexpr int instance_of(int m) {
  return m == 1 || m == 2 || m == 4 ? m : m <= kMaxRuntimeMixtures ? 0 : -1;
}

// Classes a block at m mixtures (1 for the chunked instantiation).
__host__ __device__ constexpr int classes_of(int m, bool f32 = false) {
  return instance_of(m) > 0    ? tile_of(m).nc
         : instance_of(m) == 0 ? runtime_classes(m, f32)
                               : 1;
}

// Mixture chunks a block walks at m mixtures.
__host__ __device__ constexpr int chunks_of(int m) {
  return instance_of(m) < 0 ? (m + kChunkMixtures - 1) / kChunkMixtures : 1;
}

// Floats a row of the epilogue's stage: the chains' columns padded to 8
// more than a multiple of 32 (the float2 stores of a warp hit 32 banks).
__host__ __device__ constexpr int stage_ld(int cols) { return cols + (8 - cols % 32 + 32) % 32; }

// The ring and shared memory of M's tile: a stage holds the A tile, then
// the gate chain's boxes, then the expert chain's (F32: both halves of the
// A tile, of the gate rows, then of the expert rows; as many stages as
// fit, up to 4).
template <int M, bool F32>
struct Layout {
  static constexpr Tile kTile = tile_of(M, F32);
  static constexpr int kDepth = F32 ? hgemm::kTf32Depth : hgemm::kDepth;
  static constexpr int kGateBoxes = hgemm::boxes(kTile.gate);
  static constexpr int kExpertBoxes = hgemm::boxes(kTile.expert);
  static constexpr int kStageBytes =
      F32 ? 2 * (hgemm::kTf32ABytes + (kTile.gate + kTile.expert) * hgemm::kTf32RowBytes)
          : hgemm::kABytes + (kGateBoxes + kExpertBoxes) * hgemm::kBoxBytes;
  // The chunks' per-warp slots of exp(gate), [8 warps][8 rows][gate].
  static constexpr int kSlotFloats = M < 0 ? hgemm::kConsumerWarps * 8 * kTile.gate : 0;
  static constexpr int kFixedBytes = 128 * 4 + kSlotFloats * 4 + 2 * 4 * 8 + hgemm::kAlign;
  static constexpr int kFit = (232448 - kFixedBytes) / kStageBytes;
  static constexpr int kStages =
      F32 ? (kFit < kRingStages ? kFit : kRingStages)
          : (M < 0 ? 3 : kRingStages);  // the chunks' slots take a stage's room
  // The ring, its barriers, then the tile's expert bias (NC*M <= 128), then
  // the slots.
  static constexpr int kSmemRequest = hgemm::smem_request(kStages * kStageBytes + 2 * kStages * 8 +
                                                          128 * 4 + kSlotFloats * 4);
  static constexpr int kLd = stage_ld(kTile.gate + kTile.expert);
  static_assert(kStages >= 2, "a ring of two stages at least");
  static_assert(kSmemRequest <= 232448, "shared memory a block");
  static_assert(hgemm::kRows * kLd * 4 <= kStages * kStageBytes, "the staged tile fits the ring");
  static_assert(M <= 0 || kTile.nc * M <= 128, "the bias fits its slot");
  static_assert(M <= 0 || (kTile.nc * (M + 1) <= kTile.gate && kTile.nc * M <= kTile.expert),
                "the chains cover the tile's classes");
  static_assert(M != 0 || (kTile.gate == kRuntimeGate && kTile.expert == kRuntimeExpert),
                "the run-time tiles");
  static_assert(M >= 0 || (kChunkMixtures + 1 + lost_cols(F32) <= kTile.gate &&
                           kChunkMixtures + lost_cols(F32) <= kTile.expert),
                "a chunk's gates (and the dummy) and experts fit the chains past an offset");
  static_assert(kTile.gate % 8 == 0 && kTile.expert % 8 == 0, "chain widths");
};

// F32: x, wg and we are the maps of the split operands ([2][B][Hp],
// [2][C(M+1)][Hp], [2][CM][Hp]); H is Hp.
template <int M, bool F32>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
moe_head_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_g,
                const __grid_constant__ CUtensorMap map_e, const float* __restrict__ be,
                float* __restrict__ out, int B, int H, int C, int runtime_m) {
  using L = Layout<M, F32>;
  constexpr Tile kT = L::kTile;
  constexpr int kAcc = (kT.gate + kT.expert) / 2;
  constexpr int kLd = L::kLd;
  constexpr int kStageBytes = L::kStageBytes;
  constexpr int kS = L::kStages;
  const int m_ = M > 0 ? M : runtime_m;
  const int nc = M > 0 ? kT.nc : M == 0 ? runtime_classes(m_, F32) : 1;
  const int n_chunks = M < 0 ? (m_ + kChunkMixtures - 1) / kChunkMixtures : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kS * kStageBytes);
  uint64_t* empty = full + kS;
  const int nk = (H + L::kDepth - 1) / L::kDepth;
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
  // TMA starts (rounded down to 8; the template tiles' are multiples of 8;
  // F32 starts at them).
  auto gate0 = [&](int j) { return c0 * (m_ + 1) + j * kChunkMixtures; };
  auto expert0 = [&](int j) { return c0 * m_ + j * kChunkMixtures; };
  auto start = [](int col) { return M > 0 || F32 ? col : col & ~(kAlignCols - 1); };

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* xmap = &map_x;  // the parameter itself (TMA reads it there)
  const CUtensorMap* gmap = &map_g;
  const CUtensorMap* emap = &map_e;
  const uint32_t a_off = wg * 64 * 128;  // the warpgroup's 64 rows of 128 bytes
  // The tile's products over H into acc: bf16, the stage's gate and expert
  // chains; F32, consume3 on stages of [x big, x small, gate big, gate
  // small, expert big, expert small] rows of 128 bytes, acc the stages'
  // sums.
  auto product = [&](float* acc) {
    hgemm::zero<kAcc>(acc);
    if constexpr (F32) {
      float win[hgemm::kWindow / 2];
      hgemm::consume3<kS, L::kTile.gate, L::kTile.expert>(
          full, empty, ring, nk, acc, win, hgemm::smem_u32(smem), kStageBytes, a_off);
    } else {
      hgemm::consume<kS, kAcc>(full, empty, ring, nk, acc, [&](int s) {
        const uint32_t st = hgemm::smem_u32(smem + s * L::kStageBytes);
        const uint32_t gates = st + hgemm::kABytes;
#pragma unroll
        for (int kk = 0; kk < hgemm::kDepth / 16; ++kk) {
          hgemm::chain<L::kTile.gate>(acc, st + a_off, gates, kk);
          hgemm::chain<L::kTile.expert>(acc + L::kTile.gate / 2, st + a_off,
                                        gates + L::kGateBoxes * hgemm::kBoxBytes, kk);
        }
      });
    }
  };
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int j = 0; j < n_chunks; ++j) {
        const int g0 = start(gate0(j));
        const int e0 = start(expert0(j));
        hgemm::produce<kS>(full, empty, ring, nk, kStageBytes, [&](int s, uint64_t* bar, int kt) {
          unsigned char* st = smem + s * L::kStageBytes;
          const int k0 = kt * L::kDepth;
          if constexpr (F32) {
            unsigned char* gates = st + 2 * hgemm::kTf32ABytes;
            unsigned char* experts = gates + 2 * L::kTile.gate * hgemm::kTf32RowBytes;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              hgemm::tma_3d(st + h * hgemm::kTf32ABytes, xmap, bar, k0, b0, h);
              hgemm::tma_3d(gates + h * L::kTile.gate * hgemm::kTf32RowBytes, gmap, bar, k0, g0,
                            h);
              hgemm::tma_3d(experts + h * L::kTile.expert * hgemm::kTf32RowBytes, emap, bar, k0,
                            e0, h);
            }
          } else {
            st += hgemm::kABytes;
            hgemm::tma_2d(st - hgemm::kABytes, xmap, bar, k0, b0);
#pragma unroll
            for (int i = 0; i < L::kGateBoxes; ++i)
              hgemm::tma_2d(st + i * hgemm::kBoxBytes, gmap, bar, g0 + i * hgemm::kBoxCols, k0);
#pragma unroll
            for (int i = 0; i < L::kExpertBoxes; ++i)
              hgemm::tma_2d(st + (L::kGateBoxes + i) * hgemm::kBoxBytes, emap, bar,
                            e0 + i * hgemm::kBoxCols, k0);
          }
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
    product(acc);
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
      product(acc);
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
// The row pitch of the rounded x: H rounded up to 8 (16-byte rows); of
// the split x and weights: H rounded up to 4.
inline int x_pitch(int H) { return (H + 7) / 8 * 8; }
inline int split_pitch(int H) { return (H + 3) / 4 * 4; }

// bf16: wg, we [H, cols] at row strides ldg, lde; xa a [B, x_pitch(H)]
// bf16 buffer. F32: wg, we the split weights [2][cols][split_pitch(H)];
// xa a [2][B][split_pitch(H)] f32 buffer.
template <int M, bool F32>
int launch(const void* x, const void* wg, const void* we, const void* be, void* xa, void* out,
           int B, int H, int C, int m, int ldg, int lde, cudaStream_t st) {
  using L = Layout<M, F32>;
  cudaError_t err = cudaGetLastError();
  CUtensorMap map_x, map_g, map_e;
  const int hp = split_pitch(H);
  if constexpr (F32) {
    if (err == cudaSuccess)
      err = inaff::launch_split_tf32(static_cast<const float*>(x), static_cast<float*>(xa),
                                     static_cast<size_t>(B), H, hp, st);
    if (err == cudaSuccess) err = hgemm::make_map_split(&map_x, xa, B, hp, hgemm::kRows);
    if (err == cudaSuccess) err = hgemm::make_map_split(&map_g, wg, C * (m + 1), hp, L::kTile.gate);
    if (err == cudaSuccess) err = hgemm::make_map_split(&map_e, we, C * m, hp, L::kTile.expert);
  } else {
    if (err == cudaSuccess)
      err = inaff::launch_round_bf16(static_cast<const float*>(x), static_cast<__nv_bfloat16*>(xa),
                                     static_cast<size_t>(B), H, x_pitch(H), st);
    if (err == cudaSuccess)
      err = hgemm::make_map_2d(&map_x, xa, B, H, x_pitch(H), hgemm::kRows);
    if (err == cudaSuccess)
      err = hgemm::make_map_2d(&map_g, wg, H, C * (m + 1), ldg, hgemm::kDepth);
    if (err == cudaSuccess) err = hgemm::make_map_2d(&map_e, we, H, C * m, lde, hgemm::kDepth);
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(moe_head_kernel<M, F32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemRequest);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = classes_of(m, F32);
  const dim3 grid((B + hgemm::kRows - 1) / hgemm::kRows, (C + nc - 1) / nc);
  moe_head_kernel<M, F32><<<grid, hgemm::kThreads, L::kSmemRequest, st>>>(
      map_x, map_g, map_e, static_cast<const float*>(be), static_cast<float*>(out), B,
      F32 ? hp : H, C, m);
  return static_cast<int>(cudaGetLastError());
}

template <bool F32>
int launch_any(const void* x, const void* wg, const void* we, const void* be, void* xa, void* out,
               int B, int H, int C, int M, int ldg, int lde, cudaStream_t st) {
  switch (instance_of(M)) {
    case 1:
      return launch<1, F32>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde, st);
    case 2:
      return launch<2, F32>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde, st);
    case 4:
      return launch<4, F32>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde, st);
    case 0:  // M <= 121, taken at run time
      return launch<0, F32>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde, st);
    default:  // M > 121: chunks of 120 mixtures
      return launch<-1, F32>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde, st);
  }
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
  return launch_any<false>(x, wg, we, be, xa, out, B, H, C, M, ldg, lde,
                           static_cast<cudaStream_t>(stream));
}

// The f32 route: x [B, H] f32; wg_split [2][C*(M+1)][Hp] and we_split
// [2][C*M][Hp] f32 (Hp = H rounded up to 4; kernels/tf32.py ::
// split_weights); be [C*M] f32; xs a [2][B][Hp] f32 work buffer from the
// caller; out [B, C] f32.
extern "C" int yt8m_moe_head_serving_f32(const void* x, const void* wg_split,
                                         const void* we_split, const void* be, void* xs,
                                         void* out, int B, int H, int C, int M, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || M < 1 || static_cast<long long>(C) * (M + 1) > 0x7fffffff ||
      (C + classes_of(M, true) - 1) / classes_of(M, true) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_any<true>(x, wg_split, we_split, be, xs, out, B, H, C, M, 0, 0,
                          static_cast<cudaStream_t>(stream));
}

// The tile of a route at M mixtures: [classes a block, gate chain width,
// expert chain width, stages, shared bytes requested a block, floats a
// staged row, mixture chunks a block].
extern "C" int yt8m_moe_plan(int M, int f32, int* plan) {
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int inst = instance_of(M);
  const Tile t = tile_of(inst, f32 != 0);
  const int smem[2][6] = {
      {Layout<-1, false>::kSmemRequest, Layout<0, false>::kSmemRequest,
       Layout<1, false>::kSmemRequest, Layout<2, false>::kSmemRequest, 0,
       Layout<4, false>::kSmemRequest},
      {Layout<-1, true>::kSmemRequest, Layout<0, true>::kSmemRequest,
       Layout<1, true>::kSmemRequest, Layout<2, true>::kSmemRequest, 0,
       Layout<4, true>::kSmemRequest}};
  const int stages[2][6] = {
      {Layout<-1, false>::kStages, Layout<0, false>::kStages, Layout<1, false>::kStages,
       Layout<2, false>::kStages, 0, Layout<4, false>::kStages},
      {Layout<-1, true>::kStages, Layout<0, true>::kStages, Layout<1, true>::kStages,
       Layout<2, true>::kStages, 0, Layout<4, true>::kStages}};
  const int r = f32 != 0;
  plan[0] = classes_of(M, r);
  plan[1] = t.gate;
  plan[2] = t.expert;
  plan[3] = stages[r][inst + 1];
  plan[4] = smem[r][inst + 1];
  plan[5] = stage_ld(t.gate + t.expert);
  plan[6] = chunks_of(M);
  return static_cast<int>(cudaSuccess);
}
