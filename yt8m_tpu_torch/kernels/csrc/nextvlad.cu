// Fused NeXtVLAD aggregation serving kernel for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/nextvlad.py :: nextvlad_aggregate. For frames
// x [B, F, D] (uint8 or float32), per video with n = min(num_frames, F)
// live frames (G groups, K clusters, P = De / G features a group):
//
//   xb     = bf16(dequant(x))                         (dequant only for uint8)
//   xe     = bf16(xb @ We)                            [F, De]   f32 sums
//   alpha  = sigmoid(xe @ Wa + ab)                    [F, G]    f32 sums
//   sm     = softmax_K(xe @ Wc), per group            [F, G, K] f32 sums
//   assign = sm * alpha * (f < n)
//   vlad   = sum_{f,g} bf16(assign)^T xg - a_sum (x) centers   [K, P]
//   out    = vlad / sqrt(max(sum_P vlad^2, 1e-12))
//
// with xg[f, g] = xe[f, g*P:(g+1)*P] and a_sum the f32 sum of the
// unrounded assignment over frames and groups.
//
// What bounds it: at B=512, F=300, D=1152, De=2304, G=8, K=128, P=288 the
// three products are 2 B F (D De + De G K + G K P) = 1.63 TFLOP over all
// frames (1.65 ms at the bf16 peak; about half for the live frames when
// num_frames is uniform in [1, 300]), against 177 MB of uint8 frames
// (0.05 ms at 3.35 TB/s): operations. So every product runs on the TMA +
// wgmma mainloop of hopper_gemm.cuh (the tensor cores' full-rate path),
// over the packed row layout of nextvlad_hopper.cuh (each video's live
// frames contiguous, its run padded with zero rows to a multiple of R
// frames): frames past n are neither read nor computed, and every product
// reads its operands as plain 2-D TMA boxes. Launches, on the caller's
// stream:
//  0. nxv_pack_frames, a block per 32 rows of a video's run: xb = bf16(dequant(x)) into the
//     packed rows (zeros for the run's pad rows and past the total to the
//     last tile's end) and the rows' info.
//  1. nxv_row_product (nextvlad_hopper.cuh): xe = bf16(xb @ We), tiles of
//     128 packed rows x 256 columns, persistent, rounded once and stored
//     by TMA.
//  2. nxv_cluster_kernel, persistent over (128 packed rows, the groups of
//     256 columns of Wc): the logits xe @ Wc over all of De in the two
//     consumers' registers, and beside them the tile's attention dots
//     xe @ Wa (one m64n8k16 a 16-deep step on a K-major box of wa's
//     rows; a separate attention launch, a warp a row on the CUDA cores,
//     took 0.42 of 5.70 ms on an H100 at B=512); the epilogue takes alpha
//     and each row's softmax over a group's K columns with quad shuffles
//     (a row's columns sit in the four lanes of a quad), writes
//     bf16(assign) (and, for the backward, the f32 softmax and alpha),
//     and sums each column over the rows of every 8-row block (a block is
//     one video's: a reduce-scatter over the block's eight lanes) and then over
//     the blocks of each video in a consumer's 64 rows (in order, in
//     shared memory): one f32 partial a (video, 64-row half tile), no
//     float atomics.
//  3. nxv_aggregate_kernel, persistent over (video, 128 clusters, 288
//     columns of P), the longest videos first: assign^T @ xg over the
//     video's n_pad G (frame, group) rows in 64-deep stages (A MN-major:
//     the assignment read as A[k][row]; B MN-major: xe seen as [rows G,
//     Pp]; one m64n256k16 and one m64n32k16 a 16-deep step), a_sum from
//     the partials in a fixed order, and an epilogue that subtracts a_sum
//     (x) centers and, when one tile holds all of P, takes the intra-norm
//     over each cluster row's quad: out directly, no pre-norm scratch.
//  4. nxv_norm_kernel, only when P is wider than one column tile: the
//     intra-norm from the tiles' partial sums of squares.
// Above 256 clusters (Kp > 256, "wide") a block's registers no longer
// hold a group's logits, so launch 2 is two launches:
//  2a. nxv_logits_kernel, persistent over (128 packed rows, a group, 256
//      of its clusters), the cluster tile fastest: the logits xe @ Wc in
//      the consumers' registers, written as f32 into a [cap, G Kp]
//      scratch (the training forward's sm, normalised there in place),
//      and in the first cluster tile of each group the attention dots
//      and alpha, as launch 2's;
//  2b. nxv_softmax_wide, a block a (64-row half tile, group): each row's
//      max and sum of exponentials over all K (a warp a row), then a
//      thread a cluster down the 64 rows in order: sm, bf16(assign),
//      zeros past K and on the rows that are not live, and the column
//      sums of each video's rows, one partial a (video, half tile) as
//      launch 2 writes them.
//  Launches 3 and 4 tile K already (128 clusters a tile). What this costs
//  beyond launch 2: the f32 logits written once and read twice, ~9 bytes
//  a (live row, group, cluster) (3.1 GB at B=512, F=300, G=8, K=520).
// Scratch from the caller (B=512): xb 354 MB, xe 708 MB and the bf16
// assignment 315 MB at most (written for the packed rows only), the a_sum
// partials 12.6 MB.

#include <type_traits>

#include "hopper_gemm.cuh"
#include "nextvlad_hopper.cuh"

// The file's kernels sit in nxv's anonymous namespace with the header's.
namespace nxv {
namespace {

constexpr float kDeqScale = static_cast<float>(4.0 / 255.0);
constexpr float kDeqBias = static_cast<float>(4.0 / 512.0 - 2.0);
constexpr float kNormEpsSq = 1e-12f;
constexpr int kMaxClusters = 256;   // K launch 2's registers hold; above: 2a + 2b
constexpr int kSimpleThreads = 256;  // the element-wise launches
constexpr int kSimpleWarps = kSimpleThreads / 32;
constexpr int kPackRows = 32;        // packed rows a block of the frames pass

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void load8(const uint8_t* p, float (&v)[8]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = static_cast<float>((q.x >> (8 * i)) & 0xffu);
    v[4 + i] = static_cast<float>((q.y >> (8 * i)) & 0xffu);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Launch 0. Grid (B + 1, ceil(round_up(F, R) / 32)): block (b < B, y)
// packs rows [32 y, 32 y + 32) of video b's run (its n live frames, then
// zeros to n_pad), blocks (B, y) zero the rows from the packed total to
// the end of its 128-row tile. D8 % 8 == 0.
template <typename T>
__global__ void __launch_bounds__(kSimpleThreads)
nxv_pack_frames(const T* __restrict__ x, const int* __restrict__ num_frames,
                const int* __restrict__ poff, bf16* __restrict__ xb, int* __restrict__ info, int B,
                int F, int D8) {
  const int b = blockIdx.x;
  const int r0 = poff[b];
  const int run = b < B ? poff[b + 1] - r0 : round_up(r0, kRows) - r0;
  const int f0 = blockIdx.y * kPackRows;
  const int rows = min(run - f0, kPackRows);
  if (rows <= 0) return;
  const int n = b < B ? live_frames(num_frames, b, F) : 0;
  const int chunks = D8 / 8;
  const T* src = x + static_cast<size_t>(b < B ? b : 0) * F * D8;
  for (int i = threadIdx.x; i < rows * chunks; i += kSimpleThreads) {
    const int f = f0 + i / chunks;
    const int c = i % chunks;
    float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (f < n) {
      load8(src + static_cast<size_t>(f) * D8 + 8 * c, v);
      if (std::is_same<T, uint8_t>::value) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(__fmul_rn(v[j], kDeqScale), kDeqBias);
      }
    }
    uint4 q;
    q.x = pack_bf16(v[0], v[1]);
    q.y = pack_bf16(v[2], v[3]);
    q.z = pack_bf16(v[4], v[5]);
    q.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(xb + static_cast<size_t>(r0 + f) * D8 + 8 * c) = q;
  }
  for (int f = f0 + threadIdx.x; f < f0 + rows; f += kSimpleThreads)
    info[r0 + f] = b < B ? (f < n ? b : -1 - b) : -1 - B;
}

// ---------------------------------------------------------------------------
// Launch 2: the cluster product, the attention, the softmax and the
// column sums.
// ---------------------------------------------------------------------------

// One halving exchange of a reduce-scatter over the eight lanes r of a
// quad column (lanes 4 << STEP apart): of acc[0, LEN), a lane keeps the
// half its bit names (upper: [LEN / 2, LEN)) summed with its partner's,
// in acc[0, LEN / 2).
template <int LEN, int STEP>
__device__ __forceinline__ void reduce_scatter_step(float* acc, bool upper) {
#pragma unroll
  for (int i = 0; i < LEN / 2; ++i) {
    const float sent = hgemm::select(upper, acc[i], acc[i + LEN / 2]);
    const float kept = hgemm::select(upper, acc[i + LEN / 2], acc[i]);
    acc[i] = kept + __shfl_xor_sync(0xffffffffu, sent, 4 << STEP);
  }
}

template <int Kp>  // the padded clusters of a group: 64, 128, 192 or 256
struct Clu {
  static constexpr int kGroups = Kp == 64 ? 4 : Kp == 128 ? 2 : 1;  // groups a tile
  static constexpr int kN = kGroups * Kp;                            // 256 or 192
  static constexpr int kJ = Kp / 8;  // accumulator column blocks a group
  static constexpr int kStages = 4;
  static constexpr int kBBytes = hgemm::boxes(kN) * hgemm::kBoxBytes;
  static constexpr int kWaBytes = 8 * hgemm::kDepth * 2;  // wa: [8 groups][64 deep], 1 KB
  static constexpr int kStageBytes = hgemm::kABytes + kBBytes + kWaBytes;
  static constexpr int kAcc = kN / 2 + 4;  // the logits, then the attention's m64n8
  static constexpr int kRedBytes = 2 * 8 * kN * 4;  // [warpgroup][8 row blocks][kN] f32
  static constexpr int kInfoBytes = 2 * kRows * 4;  // [tile parity][128] int
  static constexpr int kSmemBytes = kStages * kStageBytes + kRedBytes + kInfoBytes + 2 * kStages * 8;
  static constexpr int kSmem = hgemm::smem_request(kSmemBytes);
  static_assert(kSmem <= 232448, "shared memory a block");
};

template <int Kp>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
nxv_cluster_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_wa, const int* __restrict__ poff,
                   const int* __restrict__ info, const float* __restrict__ ab,
                   float* __restrict__ alpha, bf16* __restrict__ assign,
                   float* __restrict__ sm_out, float* __restrict__ asum_part, int B, int G, int K,
                   int GP, int J) {
  using C = Clu<Kp>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  float* red = reinterpret_cast<float*>(smem + C::kStages * C::kStageBytes);
  int* s_info = reinterpret_cast<int*>(red + 2 * 8 * C::kN);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_info + 2 * kRows);
  uint64_t* empty = full + C::kStages;
  const int n_rt = ceil_div(poff[B], kRows);
  const int n_gt = ceil_div(G, C::kGroups);
  const int tiles = n_rt * n_gt;
  const int nk = ceil_div(GP, hgemm::kDepth);
  init_ring(full, empty, C::kStages);

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* xmap = &map_x;
  const CUtensorMap* wmap = &map_w;
  const CUtensorMap* amap = &map_wa;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int rt = t / n_gt;
        const int gt = t % n_gt;
        hgemm::produce<C::kStages>(
            full, empty, ring, nk, C::kStageBytes, [&](int s, uint64_t* bar, int kt) {
              unsigned char* st = smem + s * C::kStageBytes;
              hgemm::tma_3d(st, xmap, bar, kt * hgemm::kDepth, rt * kRows, 0);
#pragma unroll
              for (int i = 0; i < hgemm::boxes(C::kN); ++i)
                hgemm::tma_3d(st + hgemm::kABytes + i * hgemm::kBoxBytes, wmap, bar,
                              gt * C::kN + i * hgemm::kBoxCols, kt * hgemm::kDepth, 0);
              hgemm::tma_3d(st + hgemm::kABytes + C::kBBytes, amap, bar, kt * hgemm::kDepth,
                            gt * C::kGroups, 0);
            });
      }
    }
    return;
  }
  hgemm::set_regs_inc<hgemm::kConsumerRegs>();
  const Lane ln;
  const int t256 = threadIdx.x;  // 0..255: the consumers
  const int t128 = threadIdx.x & 127;
  const uint32_t a_off = wg * 64 * hgemm::kDepth * 2;
  float* my_red = red + wg * 8 * C::kN;
  const int GKp = G * Kp;
  float acc[C::kAcc];  // the logits in [0, kN / 2), the attention dots after
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int rt = t / n_gt;
    const int gt = t % n_gt;
    int* si = s_info + (it & 1) * kRows;
    if (t256 < kRows) si[t256] = info[rt * kRows + t256];
    hgemm::zero<C::kAcc>(acc);
    hgemm::consume<C::kStages, C::kAcc>(full, empty, ring, nk, acc, [&](int s) {
      const uint32_t st = hgemm::smem_u32(smem + s * C::kStageBytes);
#pragma unroll
      for (int kk = 0; kk < hgemm::kDepth / 16; ++kk) {
        hgemm::chain<C::kN>(acc, st + a_off, st + hgemm::kABytes, kk);
        // The attention dots xe . Wa[:, g] of the tile's groups: wa's rows
        // as a K-major B of 8 columns.
        hgemm::mma<8, 0, 0>(acc + C::kN / 2, hgemm::desc_a(st + a_off, kk),
                            hgemm::desc_b_k(st + hgemm::kABytes + C::kBBytes, kk));
      }
    });
    hgemm::named_sync(3, 256);  // si written

    // The softmax of each (row, group): columns 8j + 2q + e of group gi
    // are acc[4 j + 2 h + e] for j in [gi kJ, (gi + 1) kJ). Loads are
    // unconditional (clamped), values selected.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = 64 * wg + ln.row(h);
      const int row = rt * kRows + lr;
      const bool live = si[lr] >= 0;
#pragma unroll
      for (int gi = 0; gi < C::kGroups; ++gi) {
        const int g = gt * C::kGroups + gi;
        // Group gi's dot is column gi of the m64n8: lane gi / 2 of the quad.
        const float dot = __shfl_sync(0xffffffffu, acc[C::kN / 2 + 2 * h + (gi & 1)],
                                      (threadIdx.x & 28) | (gi >> 1));
        const float al = 1.0f / (1.0f + expf(-__fadd_rn(dot, __ldg(ab + min(g, G - 1)))));
        if (alpha != nullptr && ln.q == 0 && g < G) alpha[static_cast<size_t>(row) * G + g] = al;
        float m = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < C::kJ; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * jj + 2 * ln.q + e;
            const float v = acc[4 * (gi * C::kJ + jj) + 2 * h + e];
            m = k < K ? fmaxf(m, v) : m;
          }
        m = quad_max(m);
        float s = 0.0f;
#pragma unroll
        for (int jj = 0; jj < C::kJ; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * jj + 2 * ln.q + e;
            float& v = acc[4 * (gi * C::kJ + jj) + 2 * h + e];
            v = k < K ? __expf(__fsub_rn(v, m)) : 0.0f;  // ex2.approx: within ~1e-6
            s += v;
          }
        s = quad_sum(s);
        const float rs = 1.0f / s;  // within an ulp of the quotient
        const bool valid = live && g < G;
        bf16* arow = assign + static_cast<size_t>(row) * GKp + min(g, G - 1) * Kp;
        float* srow = sm_out + static_cast<size_t>(row) * GKp + min(g, G - 1) * Kp;
#pragma unroll
        for (int jj = 0; jj < C::kJ; ++jj) {
          const int a = 4 * (gi * C::kJ + jj) + 2 * h;
          const int k = 8 * jj + 2 * ln.q;
          const float p0 = hgemm::select(valid, acc[a] * rs, 0.0f);
          const float p1 = hgemm::select(valid, acc[a + 1] * rs, 0.0f);
          acc[a] = __fmul_rn(p0, al);
          acc[a + 1] = __fmul_rn(p1, al);
          if (g < G) {
            *reinterpret_cast<uint32_t*>(arow + k) = pack_bf16(acc[a], acc[a + 1]);
            if (sm_out != nullptr) *reinterpret_cast<float2*>(srow + k) = make_float2(p0, p1);
          }
        }
      }
    }

    // Column sums: over each 8-row block (one video's), then over the
    // blocks of this consumer's 64 rows, a video's run at a time, in order.
    // A block's rows are the eight lanes r of a quad column: a
    // reduce-scatter over them (three halving exchanges, lanes 4, 8 and 16
    // apart) leaves each lane an eighth of the warp's sums, acc[i] for
    // accumulator index i + off, in a fixed order.
    constexpr int L = C::kN / 2;
    reduce_scatter_step<L, 0>(acc, ln.r & 1);
    reduce_scatter_step<L / 2, 1>(acc, (ln.r >> 1) & 1);
    reduce_scatter_step<L / 4, 2>(acc, (ln.r >> 2) & 1);
    const int off = (ln.r & 1) * (L / 2) + ((ln.r >> 1) & 1) * (L / 4) + ((ln.r >> 2) & 1) * (L / 8);
#pragma unroll
    for (int i = 0; i < L / 8; ++i) {
      const int a = i + off;  // acc[4 j + 2 h + e]: column 8 j + 2 q + e of block 2 warp + h
      my_red[(2 * ln.warp + ((a >> 1) & 1)) * C::kN + 8 * (a >> 2) + 2 * ln.q + (a & 1)] = acc[i];
    }
    hgemm::named_sync(1 + wg, 128);
    const int half = 2 * rt + wg;  // this consumer's 64-row half tile
    for (int c = t128; c < C::kN; c += 128) {
      const int g = gt * C::kGroups + c / Kp;
      if (g >= G) break;
      const int k = c % Kp;
      int cur = -1;
      float tsum = 0.0f;
      auto flush = [&]() {
        if (cur >= 0 && cur < B) {
          const int slot = half - poff[cur] / 64;
          asum_part[((static_cast<size_t>(cur) * J + slot) * G + g) * Kp + k] = tsum;
        }
      };
#pragma unroll
      for (int bi = 0; bi < 8; ++bi) {
        const int v = info_video(si[64 * wg + 8 * bi]);
        if (v != cur) {
          flush();
          cur = v;
          tsum = 0.0f;
        }
        tsum += my_red[bi * C::kN + c];
      }
      flush();
    }
  }
}

// ---------------------------------------------------------------------------
// Launches 2a and 2b (Kp > 256): the logits, then the softmax over all K.
// ---------------------------------------------------------------------------

namespace wide {
constexpr int kN = 256;  // clusters a tile of 2a
constexpr int kStages = 4;
constexpr int kBBytes = hgemm::boxes(kN) * hgemm::kBoxBytes;
constexpr int kWaBytes = 8 * hgemm::kDepth * 2;
constexpr int kStageBytes = hgemm::kABytes + kBBytes + kWaBytes;
constexpr int kAcc = kN / 2 + 4;
constexpr int kSmem = hgemm::smem_request(kStages * kStageBytes + 2 * kStages * 8);
static_assert(kSmem <= 232448, "shared memory a block");
constexpr int kHalf = 64;  // packed rows a block of 2b
}  // namespace wide

__global__ void __launch_bounds__(hgemm::kThreads, 1)
nxv_logits_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_wa, const int* __restrict__ poff,
                  const float* __restrict__ ab, float* __restrict__ alpha,
                  float* __restrict__ logits, int B, int G, int K, int Kp, int GP) {
  using namespace wide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int n_kt = ceil_div(Kp, kN);
  const int tiles = ceil_div(poff[B], kRows) * G * n_kt;
  const int nk = ceil_div(GP, hgemm::kDepth);
  init_ring(full, empty, kStages);

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* xmap = &map_x;
  const CUtensorMap* wmap = &map_w;
  const CUtensorMap* amap = &map_wa;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int rt = t / (G * n_kt);
        const int g = (t / n_kt) % G;
        const int ct = t % n_kt;
        hgemm::produce<kStages>(full, empty, ring, nk, kStageBytes, [&](int s, uint64_t* bar, int kt) {
          unsigned char* st = smem + s * kStageBytes;
          hgemm::tma_3d(st, xmap, bar, kt * hgemm::kDepth, rt * kRows, 0);
#pragma unroll
          for (int i = 0; i < hgemm::boxes(kN); ++i)
            hgemm::tma_3d(st + hgemm::kABytes + i * hgemm::kBoxBytes, wmap, bar,
                          g * Kp + ct * kN + i * hgemm::kBoxCols, kt * hgemm::kDepth, 0);
          hgemm::tma_3d(st + hgemm::kABytes + kBBytes, amap, bar, kt * hgemm::kDepth, g, 0);
        });
      }
    }
    return;
  }
  hgemm::set_regs_inc<hgemm::kConsumerRegs>();
  const Lane ln;
  const uint32_t a_off = wg * 64 * hgemm::kDepth * 2;
  const size_t GKp = static_cast<size_t>(G) * Kp;
  float acc[kAcc];  // the logits in [0, kN / 2), the attention dots after
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = t / (G * n_kt);
    const int g = (t / n_kt) % G;
    const int ct = t % n_kt;
    hgemm::zero<kAcc>(acc);
    hgemm::consume<kStages, kAcc>(full, empty, ring, nk, acc, [&](int s) {
      const uint32_t st = hgemm::smem_u32(smem + s * kStageBytes);
#pragma unroll
      for (int kk = 0; kk < hgemm::kDepth / 16; ++kk) {
        hgemm::chain<kN>(acc, st + a_off, st + hgemm::kABytes, kk);
        hgemm::mma<8, 0, 0>(acc + kN / 2, hgemm::desc_a(st + a_off, kk),
                            hgemm::desc_b_k(st + hgemm::kABytes + kBBytes, kk));
      }
    });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rt * kRows + 64 * wg + ln.row(h);
      if (ct == 0) {
        // Group g's dot is column 0 of the m64n8: lane 0 of the quad.
        const float dot = __shfl_sync(0xffffffffu, acc[kN / 2 + 2 * h], threadIdx.x & 28);
        if (ln.q == 0)
          alpha[static_cast<size_t>(row) * G + g] =
              1.0f / (1.0f + expf(-__fadd_rn(dot, __ldg(ab + g))));
      }
      float* lrow = logits + row * GKp + g * Kp + ct * kN;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int c = 8 * j + 2 * ln.q;
        const int k = ct * kN + c;
        if (k + 1 < K)
          *reinterpret_cast<float2*>(lrow + c) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        else if (k < K)
          lrow[c] = acc[4 * j + 2 * h];
      }
    }
  }
}

// Launch 2b. Grid (ceil(cap / 64), G); blocks past the last row tile
// return. logits and sm may be one buffer (each value is read, then
// overwritten, by the same thread); sm may be null (serving).
__global__ void __launch_bounds__(kSimpleThreads)
nxv_softmax_wide(const int* __restrict__ poff, const int* __restrict__ info,
                 const float* __restrict__ alpha, const float* logits, float* sm_out,
                 bf16* __restrict__ assign, float* __restrict__ asum_part, int B, int G, int K,
                 int Kp, int J) {
  using wide::kHalf;
  __shared__ float s_max[kHalf], s_rs[kHalf], s_al[kHalf];
  __shared__ int s_info[kHalf];
  const int hf = blockIdx.x;
  const int g = blockIdx.y;
  if (hf >= 2 * ceil_div(poff[B], kRows)) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t GKp = static_cast<size_t>(G) * Kp;
  const size_t base = static_cast<size_t>(hf) * kHalf * GKp + static_cast<size_t>(g) * Kp;
  for (int r = warp; r < kHalf; r += kSimpleWarps) {
    const int row = hf * kHalf + r;
    const int in = info[row];
    float m = -INFINITY, s = 0.0f;
    if (in >= 0) {  // the logits of rows that are not live are not read
      const float* lr = logits + base + r * GKp;
      for (int k = lane; k < K; k += 32) m = fmaxf(m, lr[k]);
      m = warp_max(m);
      for (int k = lane; k < K; k += 32) s += __expf(__fsub_rn(lr[k], m));
      s = warp_sum(s);
    }
    if (lane == 0) {
      s_info[r] = in;
      s_max[r] = m;
      s_rs[r] = in >= 0 ? 1.0f / s : 0.0f;
      s_al[r] = in >= 0 ? alpha[static_cast<size_t>(row) * G + g] : 0.0f;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < Kp; k += kSimpleThreads) {
    int cur = -1;
    float tsum = 0.0f;
    auto flush = [&]() {
      if (cur >= 0 && cur < B) {
        const int slot = hf - poff[cur] / kHalf;
        asum_part[((static_cast<size_t>(cur) * J + slot) * G + g) * Kp + k] = tsum;
      }
    };
    for (int r = 0; r < kHalf; ++r) {
      const int v = info_video(s_info[r]);
      if (v != cur) {
        flush();
        cur = v;
        tsum = 0.0f;
      }
      const size_t o = base + r * GKp + k;
      float p = 0.0f;
      if (s_info[r] >= 0 && k < K) p = __expf(__fsub_rn(logits[o], s_max[r])) * s_rs[r];
      const float a = __fmul_rn(p, s_al[r]);
      assign[o] = __float2bfloat16_rn(a);
      if (sm_out != nullptr) sm_out[o] = p;
      tsum += a;
    }
    flush();
  }
}

// ---------------------------------------------------------------------------
// Launch 3: the aggregation, the centers term and the intra-norm.
// ---------------------------------------------------------------------------

// Tile `it` of a block's walk over `tiles` tiles, or -1 past the end:
// blocks take rounds of gridDim.x tiles, every other round in reverse, so
// that over tiles sorted longest first each block's sum is about even.
__device__ __forceinline__ int snake_tile(int it, int tiles) {
  const int t = it * gridDim.x + ((it & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return t < tiles ? t : -1;
}

namespace agg {
constexpr int kStages = 4;
constexpr int kStageBytes = hgemm::kABytes + kWideBoxes * hgemm::kBoxBytes;  // 56 KB
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kRows * 4 + 2 * kStages * 8;
constexpr int kSmem = hgemm::smem_request(kSmemBytes);
static_assert(kSmem <= 232448, "shared memory a block");
}  // namespace agg

__global__ void __launch_bounds__(hgemm::kThreads, 1)
nxv_aggregate_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_x,
                     const int* __restrict__ poff, const int* __restrict__ order,
                     const float* __restrict__ asum_part, const float* __restrict__ centers,
                     float* __restrict__ vlad, float* __restrict__ sumsq,
                     float* __restrict__ a_sum, float* __restrict__ out, int B, int G, int K,
                     int P, int Pp, int Kp, int J) {
  using namespace agg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  float* s_asum = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // [2][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_asum + 2 * kRows);
  uint64_t* empty = full + kStages;
  const int n_ct = ceil_div(Kp, kRows);
  const int n_pt = ceil_div(Pp, kWideCols);
  const int tiles = B * n_ct * n_pt;
  init_ring(full, empty, kStages);

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* amap = &map_a;
  const CUtensorMap* xmap = &map_x;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int it = 0, t; (t = snake_tile(it, tiles)) >= 0; ++it) {
        const int b = order[t / (n_ct * n_pt)];
        const int ct = (t / n_pt) % n_ct;
        const int pt = t % n_pt;
        const int d0 = poff[b] * G;
        const int nk = (poff[b + 1] - poff[b]) * G / hgemm::kDepth;
        hgemm::produce<kStages>(full, empty, ring, nk, kStageBytes, [&](int s, uint64_t* bar, int kt) {
          unsigned char* st = smem + s * kStageBytes;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            hgemm::tma_3d(st + i * hgemm::kBoxBytes, amap, bar, ct * kRows + 64 * i,
                          d0 + kt * hgemm::kDepth, 0);
#pragma unroll
          for (int i = 0; i < kWideBoxes; ++i)
            hgemm::tma_3d(st + hgemm::kABytes + i * hgemm::kBoxBytes, xmap, bar,
                          pt * kWideCols + i * hgemm::kBoxCols, d0 + kt * hgemm::kDepth, 0);
        });
      }
    }
    return;
  }
  hgemm::set_regs_inc<hgemm::kConsumerRegs>();
  const Lane ln;
  const int t256 = threadIdx.x;
  float acc[kWideCols / 2];
  int it = 0;
  for (int t; (t = snake_tile(it, tiles)) >= 0; ++it) {
    const int b = order[t / (n_ct * n_pt)];
    const int ct = (t / n_pt) % n_ct;
    const int pt = t % n_pt;
    const int r0 = poff[b];
    const int np = poff[b + 1] - r0;
    const int nk = np * G / hgemm::kDepth;
    // a_sum of the tile's clusters: the video's partials, slot by slot,
    // group by group.
    float* sa = s_asum + (it & 1) * kRows;
    if (t256 < kRows) {
      const int k = ct * kRows + t256;
      const int slots = np > 0 ? (r0 + np - 1) / 64 - r0 / 64 + 1 : 0;
      float tsum = 0.0f;
      if (k < Kp)
        for (int j = 0; j < slots; ++j)
          for (int g0 = 0; g0 < G; g0 += 8) {  // eight loads in flight, added in order
            const float* src = asum_part + ((static_cast<size_t>(b) * J + j) * G + g0) * Kp + k;
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = g0 + u < G ? __ldg(src + u * Kp) : 0.0f;
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (g0 + u < G) tsum += v[u];
          }
      sa[t256] = tsum;
      if (a_sum != nullptr && pt == 0 && k < Kp) a_sum[static_cast<size_t>(b) * Kp + k] = tsum;
    }
    hgemm::zero<kWideCols / 2>(acc);
    hgemm::consume<kStages, kWideCols / 2>(full, empty, ring, nk, acc, [&](int s) {
      const uint32_t st = hgemm::smem_u32(smem + s * kStageBytes);
      const uint32_t xs = st + hgemm::kABytes;
#pragma unroll
      for (int kk = 0; kk < hgemm::kDepth / 16; ++kk) {
        const uint64_t a = hgemm::desc_a_mn(st + wg * hgemm::kBoxBytes, kk);
        hgemm::mma<256, 1, 1>(acc, a, hgemm::desc_b(xs, kk));
        hgemm::mma<32, 1, 1>(acc + 128, a, hgemm::desc_b(xs + 4 * hgemm::kBoxBytes, kk));
      }
    });
    hgemm::named_sync(3, 256);  // sa written

    // vlad = acc - a_sum (x) centers (multiply and subtract each rounded,
    // as the plain version); the row's sum of squares over its quad.
    // Loads unconditional (clamped to cluster K - 1 and, in a tile past
    // P's end, column P - 1).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lk = 64 * wg + ln.row(h);
      const int k = ct * kRows + lk;
      const float as = sa[lk];
      const float* cen = centers + static_cast<size_t>(min(k, K - 1)) * P;
      float ss = 0.0f;
      if ((pt + 1) * kWideCols <= P) {
        // Every column of the tile is one of P's: loads at fixed offsets
        // from the row's first column, no clamp.
        const float* c0 = cen + pt * kWideCols + 2 * ln.q;
#pragma unroll
        for (int j = 0; j < kWideCols / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = acc[4 * j + 2 * h + e];
            v = hgemm::select(k < K, __fsub_rn(v, __fmul_rn(as, __ldg(c0 + 8 * j + e))), 0.0f);
            ss = fmaf(v, v, ss);
          }
      } else {
#pragma unroll
        for (int j = 0; j < kWideCols / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = pt * kWideCols + 8 * j + 2 * ln.q + e;
            const float c = __ldg(cen + min(p, P - 1));
            float& v = acc[4 * j + 2 * h + e];
            v = hgemm::select(k < K && p < P, __fsub_rn(v, __fmul_rn(as, c)), 0.0f);
            ss = fmaf(v, v, ss);
          }
      }
      ss = quad_sum(ss);
      if (k >= K) continue;
      const size_t o = (static_cast<size_t>(b) * K + k) * P;
      const float rn = n_pt == 1 ? 1.0f / sqrtf(fmaxf(ss, kNormEpsSq)) : 0.0f;
      if ((pt + 1) * kWideCols <= P && P % 2 == 0) {
        const size_t o0 = o + pt * kWideCols + 2 * ln.q;
#pragma unroll
        for (int j = 0; j < kWideCols / 8; ++j) {
          const int a = 4 * j + 2 * h;
          if (n_pt == 1)
            *reinterpret_cast<float2*>(out + o0 + 8 * j) = make_float2(acc[a] * rn, acc[a + 1] * rn);
          if (vlad != nullptr)
            *reinterpret_cast<float2*>(vlad + o0 + 8 * j) = make_float2(acc[a], acc[a + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kWideCols / 8; ++j) {
          const int p = pt * kWideCols + 8 * j + 2 * ln.q;
          const int a = 4 * j + 2 * h;
          if (p >= P) continue;
          if (P % 2 == 0) {
            if (n_pt == 1)
              *reinterpret_cast<float2*>(out + o + p) = make_float2(acc[a] * rn, acc[a + 1] * rn);
            if (vlad != nullptr)
              *reinterpret_cast<float2*>(vlad + o + p) = make_float2(acc[a], acc[a + 1]);
          } else {
            if (n_pt == 1) out[o + p] = acc[a] * rn;
            if (vlad != nullptr) vlad[o + p] = acc[a];
            if (p + 1 < P) {
              if (n_pt == 1) out[o + p + 1] = acc[a + 1] * rn;
              if (vlad != nullptr) vlad[o + p + 1] = acc[a + 1];
            }
          }
        }
      }
      if (n_pt > 1 && ln.q == 0) sumsq[(static_cast<size_t>(b) * n_pt + pt) * K + k] = ss;
    }
  }
}

// Launch 4 (P wider than a column tile only). Grid (ceil(K / 8), B): a
// warp a row, out = vlad / n.
__global__ void __launch_bounds__(kSimpleThreads)
nxv_norm_kernel(const float* __restrict__ vlad, const float* __restrict__ sumsq,
                float* __restrict__ out, int K, int P, int ptiles) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int k = blockIdx.x * kSimpleWarps + warp;
  if (k >= K) return;
  float ss = 0.0f;
  for (int t = 0; t < ptiles; ++t) ss += sumsq[(static_cast<size_t>(b) * ptiles + t) * K + k];
  const float rn = 1.0f / sqrtf(fmaxf(ss, kNormEpsSq));
  const size_t o = (static_cast<size_t>(b) * K + k) * P;
  for (int p = lane; p < P; p += 32) out[o + p] = vlad[o + p] * rn;
}

template <int Kp>
cudaError_t launch_cluster(int sms, cudaStream_t st, const void* xe, const void* wc, const void* wa,
                           const int* poff, const int* info, const float* ab, float* alpha,
                           bf16* assign, float* sm, float* asum_part, int B, int G, int K, int GP,
                           int cap, int J) {
  using C = Clu<Kp>;
  CUtensorMap map_x, map_w, map_wa;
  cudaError_t err = hgemm::make_map_bf16(&map_x, xe, 1, cap, GP, GP, kRows);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_w, wc, 1, GP, G * Kp, G * Kp, hgemm::kDepth);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_wa, wa, 1, G, GP, GP, 8);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nxv_cluster_kernel<Kp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
  if (err != cudaSuccess) return err;
  const int most = ceil_div(cap, kRows) * ceil_div(G, C::kGroups);
  nxv_cluster_kernel<Kp><<<most < sms ? most : sms, hgemm::kThreads, C::kSmem, st>>>(
      map_x, map_w, map_wa, poff, info, ab, alpha, assign, sm, asum_part, B, G, K, GP, J);
  return cudaGetLastError();
}

cudaError_t launch_logits(int sms, cudaStream_t st, const void* xe, const void* wc, const void* wa,
                          const int* poff, const float* ab, float* alpha, float* logits, int B,
                          int G, int K, int Kp, int GP, int cap) {
  CUtensorMap map_x, map_w, map_wa;
  cudaError_t err = hgemm::make_map_bf16(&map_x, xe, 1, cap, GP, GP, kRows);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_w, wc, 1, GP, G * Kp, G * Kp, hgemm::kDepth);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_wa, wa, 1, G, GP, GP, 8);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nxv_logits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wide::kSmem);
  if (err != cudaSuccess) return err;
  const long long most = static_cast<long long>(ceil_div(cap, kRows)) * G * ceil_div(Kp, wide::kN);
  nxv_logits_kernel<<<most < sms ? static_cast<int>(most) : sms, hgemm::kThreads, wide::kSmem, st>>>(
      map_x, map_w, map_wa, poff, ab, alpha, logits, B, G, K, Kp, GP);
  return cudaGetLastError();
}

// cap G max(Pp, Kp, 256) < 2^31: the packed rows' widest row tensor
// indexes in int (kernels/nextvlad.py :: max_clusters).
bool shapes_ok(int B, int F, int D8, int G, int K, int P, int cap) {
  const long long Pp = round_up(P, 8);
  const long long Kp = round_up(K, 64);
  const long long widest = Pp > Kp ? (Pp > 256 ? Pp : 256) : (Kp > 256 ? Kp : 256);
  return B > 0 && B <= 65535 && F > 0 && D8 > 0 && D8 % 8 == 0 && G > 0 && G <= 65535 && K > 0 &&
         P > 0 && cap >= static_cast<long long>(B) * round_up(F, run_frames(G)) + kRows &&
         static_cast<long long>(cap) * G * widest < (1LL << 31);
}

template <typename T>
int launch(const void* x, const void* num_frames, const void* poff_v, const void* order_v,
           const void* we, const void* wc, const void* wa, const void* ab, const void* centers,
           void* xb, void* info_v, void* xe, void* alpha, void* assign, void* sm, void* logits,
           void* asum_part, void* a_sum, void* vlad, void* sumsq, void* out, int B, int F, int D8,
           int G, int K, int P, int cap, void* stream) {
  if (!shapes_ok(B, F, D8, G, K, P, cap)) return static_cast<int>(cudaErrorInvalidValue);
  const int Pp = round_up(P, 8);
  const int Kp = round_up(K, 64);
  const int GP = G * Pp;
  const int J = ceil_div(round_up(F, run_frames(G)), 64) + 1;
  const int n_pt = ceil_div(Pp, kWideCols);
  if (n_pt > 1 && (vlad == nullptr || sumsq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* poff = static_cast<const int*>(poff_v);
  int* info = static_cast<int*>(info_v);
  cudaError_t err = cudaGetLastError();
  int sms = 0;
  if (err == cudaSuccess) err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 pack_grid(B + 1, ceil_div(max(round_up(F, run_frames(G)), kRows), kPackRows));
  nxv_pack_frames<T><<<pack_grid, kSimpleThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(num_frames), poff, static_cast<bf16*>(xb),
      info, B, F, D8);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_row_product(xb, we, xe, nullptr, poff, info, B, cap, GP, D8, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* abp = static_cast<const float*>(ab);
  float* alp = static_cast<float*>(alpha);
  bf16* asg = static_cast<bf16*>(assign);
  float* smp = static_cast<float*>(sm);
  float* part = static_cast<float*>(asum_part);
  if (Kp > kMaxClusters) {
    // The training forward normalises its logits in place into sm.
    float* lg = smp != nullptr ? smp : static_cast<float*>(logits);
    if (lg == nullptr || alp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_logits(sms, st, xe, wc, wa, poff, abp, alp, lg, B, G, K, Kp, GP, cap);
    if (err == cudaSuccess) {
      nxv_softmax_wide<<<dim3(ceil_div(cap, wide::kHalf), G), kSimpleThreads, 0, st>>>(
          poff, info, alp, lg, smp, asg, part, B, G, K, Kp, J);
      err = cudaGetLastError();
    }
  } else switch (Kp / 64) {
    case 1: err = launch_cluster<64>(sms, st, xe, wc, wa, poff, info, abp, alp, asg, smp, part, B, G, K, GP, cap, J); break;
    case 2: err = launch_cluster<128>(sms, st, xe, wc, wa, poff, info, abp, alp, asg, smp, part, B, G, K, GP, cap, J); break;
    case 3: err = launch_cluster<192>(sms, st, xe, wc, wa, poff, info, abp, alp, asg, smp, part, B, G, K, GP, cap, J); break;
    default: err = launch_cluster<256>(sms, st, xe, wc, wa, poff, info, abp, alp, asg, smp, part, B, G, K, GP, cap, J); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap map_a, map_x;
  err = hgemm::make_map_bf16(&map_a, assign, 1, cap * G, Kp, Kp, hgemm::kDepth);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_x, xe, 1, cap * G, Pp, Pp, hgemm::kDepth);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nxv_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               agg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = B * ceil_div(Kp, kRows) * n_pt;
  nxv_aggregate_kernel<<<tiles < sms ? tiles : sms, hgemm::kThreads, agg::kSmem, st>>>(
      map_a, map_x, poff, static_cast<const int*>(order_v), part,
      static_cast<const float*>(centers), static_cast<float*>(vlad), static_cast<float*>(sumsq),
      static_cast<float*>(a_sum), static_cast<float*>(out), B, G, K, P, Pp, Kp, J);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_pt == 1) return static_cast<int>(err);
  nxv_norm_kernel<<<dim3(ceil_div(K, kSimpleWarps), B), kSimpleThreads, 0, st>>>(
      static_cast<const float*>(vlad), static_cast<const float*>(sumsq), static_cast<float*>(out),
      K, P, n_pt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace nxv

using namespace nxv;

// poff [B + 1] int32: the packed offsets (nextvlad_hopper.cuh; poff[B] the
// packed total); order [B] int32: the videos, longest first. Weights in
// the wrapper's padded bf16 layout (kernels/nextvlad.py :: kernel_layout):
// we [D8, G Pp], wc [G Pp, G Kp], wa [G, G Pp]; ab [G] and centers [K, P]
// f32. Scratch over cap >= B round_up(F, R) + 128 packed rows: xb [cap,
// D8], xe [cap, G Pp], assign [cap, G Kp] bf16; info [cap] int32; alpha
// [cap, G] f32 (needed for the backward and when Kp > 256);
// asum_part [B, J, G, Kp] f32 (J = ceil(round_up(F, R) / 64)
// + 1). When not null: sm [cap, G Kp] f32 (the backward's residual),
// a_sum [B, Kp] and vlad [B, K, P] f32 (the pre-norm residual; needed,
// with sumsq [B, ceil(Pp / 288), K], when Pp > 288). logits [cap, G Kp]
// f32, the wide path's scratch when Kp > 256 and sm is null (with sm, sm
// holds the logits). out [B, K, P] f32.
extern "C" int yt8m_nextvlad_aggregate_u8(
    const void* x, const void* num_frames, const void* poff, const void* order, const void* we,
    const void* wc, const void* wa, const void* ab, const void* centers, void* xb, void* info,
    void* xe, void* alpha, void* assign, void* sm, void* logits, void* asum_part, void* a_sum,
    void* vlad, void* sumsq, void* out, int B, int F, int D8, int G, int K, int P, int cap,
    void* stream) {
  return launch<uint8_t>(x, num_frames, poff, order, we, wc, wa, ab, centers, xb, info, xe, alpha,
                         assign, sm, logits, asum_part, a_sum, vlad, sumsq, out, B, F, D8, G, K,
                         P, cap, stream);
}

extern "C" int yt8m_nextvlad_aggregate_f32(
    const void* x, const void* num_frames, const void* poff, const void* order, const void* we,
    const void* wc, const void* wa, const void* ab, const void* centers, void* xb, void* info,
    void* xe, void* alpha, void* assign, void* sm, void* logits, void* asum_part, void* a_sum,
    void* vlad, void* sumsq, void* out, int B, int F, int D8, int G, int K, int P, int cap,
    void* stream) {
  return launch<float>(x, num_frames, poff, order, we, wc, wa, ab, centers, xb, info, xe, alpha,
                       assign, sm, logits, asum_part, a_sum, vlad, sumsq, out, B, F, D8, G, K, P,
                       cap, stream);
}

// The forward's tiles: [rows a tile, the row product's columns, the wide
// column tile, the row product's stages and shared bytes, the cluster
// product's stages, its shared bytes at Kp = 64, 128, 192, 256, the
// aggregation's stages and shared bytes, SMs, the logits launch's (Kp >
// 256) clusters a tile, stages and shared bytes].
extern "C" int yt8m_nextvlad_plan(int* plan) {
  int sms = 0;
  const cudaError_t err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = kRows;
  plan[1] = kCols;
  plan[2] = kWideCols;
  plan[3] = rowprod::kStages;
  plan[4] = rowprod::kSmem;
  plan[5] = Clu<128>::kStages;
  plan[6] = Clu<64>::kSmem;
  plan[7] = Clu<128>::kSmem;
  plan[8] = Clu<192>::kSmem;
  plan[9] = Clu<256>::kSmem;
  plan[10] = agg::kStages;
  plan[11] = agg::kSmem;
  plan[12] = sms;
  plan[13] = wide::kN;
  plan[14] = wide::kStages;
  plan[15] = wide::kSmem;
  return static_cast<int>(cudaSuccess);
}
