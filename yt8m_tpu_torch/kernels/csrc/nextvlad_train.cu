// Trainable NeXtVLAD aggregation for Hopper (sm_90a): the backward.
//
// Replaces the backward pallas_call of yt8m_tpu/kernels/nextvlad_train.py
// :: nextvlad_aggregate_train (the forward is nextvlad.cu's kernel, which
// also keeps the residuals below). Per video with n live frames, from the
// forward's xb, xe, bf16(assign), f32 softmax sm and alpha, pre-norm vlad
// v and a_sum, and the cotangent dy of out = v / nrm:
//
//   dv       = ss > 1e-12 ? (dy - out sum_P(out dy)) / nrm : dy / nrm
//   cdot     = sum_P centers dv,   dcenters = -sum_b a_sum (x) dv
//   d_assign = xg @ bf16(dv)^T - cdot                 (f32 sums)
//   d_alpha  = sum_K d_assign sm,  d_sm = d_assign alpha      (live rows)
//   d_act    = sm (d_sm - sum_K sm d_sm),  d_pre = d_alpha alpha (1 - alpha)
//   d_xg     = bf16(assign) @ bf16(dv)
//   d_xe     = d_xg + [bf16(d_act) | bf16(d_pre)] @ [Wc | Wa]^T
//   [dWc | dWa] = sum xe^T [bf16(d_act) | bf16(d_pre)],  dab = sum d_pre
//   dWe      = sum xb^T bf16(d_xe)
//
// What bounds it: at B=256, F=300 and the reference widths the products
// are 2 B F (2 G K P + De (G K + G) + 2 De (G K + G) / 2 + D De) ~ 1.26
// TFLOP over all frames (1.3 ms at the bf16 peak; about half for the live
// frames), against ~1.4 GB of residuals and cotangents (0.4 ms at 3.35
// TB/s): operations. So every product runs on the TMA + wgmma mainloop
// of hopper_gemm.cuh, over the forward's packed row layout
// (nextvlad_hopper.cuh: each video's run of live frames contiguous and
// padded with zero rows, every row tensor a plain row-major matrix).
//
// Design. The TPU backward runs its grid in order and adds each video's
// five weight gradients into resident VMEM accumulators; CUDA blocks run
// at once, so the weight gradients here are split-K products: a split is
// an equal range of packed rows, its block tiles write f32 partials, and
// a second pass adds the partials in split order. No atomics: two runs
// give the same bits. Launches, on the caller's stream:
//  1. nxv_dv_kernel (a warp a cluster row: dv, bf16(dv) padded to
//     [Kp, Pp], cdot; one more row of blocks zeros d_act's rows past the
//     packed total to the end of their 128-row tile) and
//     nxv_dcenters_kernel (a thread a (k, p), the videos in order);
//  2. nxv_dassign_kernel, persistent over (video, 128 of its (frame,
//     group) rows): d_assign on wgmma (A K-major: xe seen as [rows G, Pp];
//     B K-major: the video's bf16(dv) [Kp][64 deep] boxes), then the
//     softmax and sigmoid VJPs in the registers (a row's clusters over
//     its quad): bf16(d_act) and bf16(d_pre) into one [rows, G Kp + KA]
//     operand, f32 d_pre;
//  3. nxv_dxg_kernel, the same walk: d_xg = bf16(assign) @ bf16(dv) (A
//     K-major: the assignment seen as [rows G, Kp]; B MN-major: bf16(dv)
//     in [64][64] boxes; 288 columns a tile, one m64n256k16 and one
//     m64n32k16 a 16-deep step), f32 into [rows G, Pp];
//  4. nxv_row_product (nextvlad_hopper.cuh): d_xe = bf16(d_xg + [d_act |
//     d_pre] @ wext) over the packed rows, rounded once, zeros on the pad
//     rows;
//  5. nxv_wgrad_kernel twice (xe^T [d_act | d_pre], then xb^T d_xe), a
//     block per (split, 128 x 256 output tile), A and B both MN-major
//     over the split's packed rows (pad rows are exact zeros), and
//     nxv_reduce_kernel for each;
//  6. nxv_dab_kernel (a block a group, a fixed-order tree).
// Above 256 clusters (Kp > 256) a row's d_assign no longer fits the
// registers of launch 2, which becomes two launches: 2a,
// nxv_dassign_wide_kernel, the same walk over (128 rows, 256 clusters)
// tiles, the cluster tile fastest, writing f32 d_assign - cdot into a
// [rows G, Kp] scratch; 2b, nxv_vjp_wide_kernel, a warp a (frame, group)
// row: the softmax and sigmoid VJPs over the row's K, into the same
// operand and d_pre as launch 2. Launches 3-6 tile K already.
// Frames past n are never read. Scratch from the caller (B=256): dv,
// bf16(dv), d_act 159 MB, d_xg 708 MB (f32), d_xe 354 MB at most, the
// partials 8 x (9.5 + 10.6) MB (8 splits: 16 read 0.09 ms more on an H100).

#include "hopper_gemm.cuh"
#include "nextvlad_hopper.cuh"

// The file's kernels sit in nxv's anonymous namespace with the header's.
namespace nxv {
namespace {

constexpr float kNormEpsSq = 1e-12f;
constexpr int kMaxClusters = 256;  // K launch 2's registers hold; above: 2a + 2b
constexpr int kSimpleThreads = 256;
constexpr int kSimpleWarps = kSimpleThreads / 32;

// dv, its bf16 copy padded to [Kp, Pp] (zeros past K and P), cdot [B, Kp].
// Grid (Kp / 8, B + 1): a warp a cluster row; the blocks at y = B zero
// d_act's rows from the packed total to the end of their 128-row tile.
__global__ void __launch_bounds__(kSimpleThreads)
nxv_dv_kernel(const float* __restrict__ vlad, const float* __restrict__ dy,
              const float* __restrict__ centers, const int* __restrict__ poff,
              float* __restrict__ dv, bf16* __restrict__ dvb, float* __restrict__ cdot,
              bf16* __restrict__ dact, int B, int K, int P, int Pp, int Kp, int Kx) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (b == B) {
    const int r0 = poff[B];
    const int n = (round_up(r0, kRows) - r0) * Kx;
    bf16* d = dact + static_cast<size_t>(r0) * Kx;
    for (int i = blockIdx.x * kSimpleThreads + threadIdx.x; i < n; i += gridDim.x * kSimpleThreads)
      d[i] = __float2bfloat16_rn(0.0f);
    return;
  }
  const int k = blockIdx.x * kSimpleWarps + warp;
  if (k >= Kp) return;
  bf16* drow = dvb + (static_cast<size_t>(b) * Kp + k) * Pp;
  if (k >= K) {
    for (int p = lane; p < Pp; p += 32) drow[p] = __float2bfloat16_rn(0.0f);
    if (lane == 0) cdot[static_cast<size_t>(b) * Kp + k] = 0.0f;
    return;
  }
  const size_t o = (static_cast<size_t>(b) * K + k) * P;
  const float* v = vlad + o;
  const float* g = dy + o;
  float ss = 0.0f;
  for (int p = lane; p < P; p += 32) ss = fmaf(v[p], v[p], ss);
  ss = warp_sum(ss);
  const float nrm = sqrtf(fmaxf(ss, kNormEpsSq));
  float t = 0.0f;
  for (int p = lane; p < P; p += 32) t = __fadd_rn(t, __fmul_rn(v[p] / nrm, g[p]));
  t = warp_sum(t);
  const bool clamped = !(ss > kNormEpsSq);
  float c = 0.0f;
  for (int p = lane; p < P; p += 32) {
    const float d = clamped ? g[p] / nrm : __fsub_rn(g[p], __fmul_rn(v[p] / nrm, t)) / nrm;
    dv[o + p] = d;
    drow[p] = __float2bfloat16_rn(d);
    c = __fadd_rn(c, __fmul_rn(centers[static_cast<size_t>(k) * P + p], d));
  }
  for (int p = P + lane; p < Pp; p += 32) drow[p] = __float2bfloat16_rn(0.0f);
  c = warp_sum(c);
  if (lane == 0) cdot[static_cast<size_t>(b) * Kp + k] = c;
}

// dcenters[k, p] = sum_b -a_sum[b, k] dv[b, k, p], the videos in order.
__global__ void __launch_bounds__(kSimpleThreads)
nxv_dcenters_kernel(const float* __restrict__ a_sum, const float* __restrict__ dv,
                    float* __restrict__ dcenters, int B, int K, int P, int Kp) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kSimpleThreads + threadIdx.x;
  if (i >= static_cast<size_t>(K) * P) return;
  const int k = static_cast<int>(i / P);
  float acc = 0.0f;
  for (int b = 0; b < B; ++b)
    acc = __fadd_rn(acc, __fmul_rn(-a_sum[static_cast<size_t>(b) * Kp + k],
                                   dv[static_cast<size_t>(b) * K * P + i]));
  dcenters[i] = acc;
}

// The video of per-video tile t: toff[b] <= t < toff[b + 1] (toff [B + 1],
// the prefix sums of each video's tiles; a video with none is skipped).
__device__ __forceinline__ int video_of(const int* toff, int B, int t) {
  int lo = 0;
  int hi = B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (toff[mid] <= t) lo = mid;
    else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// d_assign and the VJPs.
// ---------------------------------------------------------------------------

template <int Kp>
struct Asg {
  static constexpr int kStages = 4;
  static constexpr int kStageBytes = hgemm::kABytes + Kp * hgemm::kDepth * 2;  // A + [Kp][64] dv
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8;
  static constexpr int kSmem = hgemm::smem_request(kSmemBytes);
  static_assert(kSmem <= 232448, "shared memory a block");
};

template <int Kp>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
nxv_dassign_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_v,
                   const int* __restrict__ poff, const int* __restrict__ toff,
                   const int* __restrict__ info, const float* __restrict__ sm,
                   const float* __restrict__ alpha, const float* __restrict__ cdot,
                   bf16* __restrict__ dact, float* __restrict__ dpre, int B, int G, int Pp,
                   int Kx) {
  using A = Asg<Kp>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + A::kStages * A::kStageBytes);
  uint64_t* empty = full + A::kStages;
  const int tiles = toff[B];
  const int nk = ceil_div(Pp, hgemm::kDepth);
  init_ring(full, empty, A::kStages);

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* xmap = &map_x;
  const CUtensorMap* vmap = &map_v;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int b = video_of(toff, B, t);
        const int row0 = poff[b] * G + (t - toff[b]) * kRows;
        hgemm::produce<A::kStages>(full, empty, ring, nk, A::kStageBytes, [&](int s, uint64_t* bar, int kt) {
          unsigned char* st = smem + s * A::kStageBytes;
          hgemm::tma_3d(st, xmap, bar, kt * hgemm::kDepth, row0, 0);
          hgemm::tma_3d(st + hgemm::kABytes, vmap, bar, kt * hgemm::kDepth, 0, b);
        });
      }
    }
    return;
  }
  hgemm::set_regs_inc<hgemm::kConsumerRegs>();
  const Lane ln;
  const uint32_t a_off = wg * 64 * hgemm::kDepth * 2;
  const int GKp = G * Kp;
  float acc[Kp / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = video_of(toff, B, t);
    const int run0 = poff[b] * G;
    const int run_end = poff[b + 1] * G;
    const int row0 = run0 + (t - toff[b]) * kRows;
    hgemm::zero<Kp / 2>(acc);
    hgemm::consume<A::kStages, Kp / 2>(full, empty, ring, nk, acc, [&](int s) {
      const uint32_t st = hgemm::smem_u32(smem + s * A::kStageBytes);
      const uint32_t vv = st + hgemm::kABytes;
#pragma unroll
      for (int kk = 0; kk < hgemm::kDepth / 16; ++kk) {
        const uint64_t a = hgemm::desc_a(st + a_off, kk);
        if constexpr (Kp == 192) {
          hgemm::mma<128, 0, 0>(acc, a, hgemm::desc_b_k(vv, kk));
          hgemm::mma<64, 0, 0>(acc + 64, a, hgemm::desc_b_k(vv + 128 * 128, kk));
        } else {
          hgemm::mma<Kp, 0, 0>(acc, a, hgemm::desc_b_k(vv, kk));
        }
      }
    });
    // The VJPs of a (frame, group) row rr: clusters 8j + 2q + e in
    // acc[4 j + 2 h + e]. sm and cdot are zeros past K (the forward's and
    // dv's launches write them so), so the pairs load unmasked and add
    // exact zeros there. A row past the run is another video's: its loads
    // read the run's first row and it is not written.
    const float* cd = cdot + static_cast<size_t>(b) * Kp + 2 * ln.q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row0 + 64 * wg + ln.row(h);
      const bool in_run = rr < run_end;
      const int rc = in_run ? rr : run0;
      const int fp = rc / G;
      const int g = rc - fp * G;
      const bool live = in_run && __ldg(info + fp) >= 0;
      const float al = __ldg(alpha + rc);
      const float* smr = sm + static_cast<size_t>(rc) * Kp + 2 * ln.q;
      float dal = 0.0f, tt = 0.0f;
#pragma unroll
      for (int j = 0; j < Kp / 8; ++j) {
        const float2 s = __ldg(reinterpret_cast<const float2*>(smr + 8 * j));
        const float2 c = __ldg(reinterpret_cast<const float2*>(cd + 8 * j));
        float* d = acc + 4 * j + 2 * h;
        const float da0 = __fsub_rn(d[0], c.x);
        const float da1 = __fsub_rn(d[1], c.y);
        d[0] = __fmul_rn(da0, al);
        d[1] = __fmul_rn(da1, al);
        dal = __fadd_rn(__fadd_rn(dal, __fmul_rn(da0, s.x)), __fmul_rn(da1, s.y));
        tt = __fadd_rn(__fadd_rn(tt, __fmul_rn(s.x, d[0])), __fmul_rn(s.y, d[1]));
      }
      dal = quad_sum(dal);
      tt = quad_sum(tt);
      if (!in_run) continue;
      bf16* drow = dact + static_cast<size_t>(fp) * Kx;
#pragma unroll
      for (int j = 0; j < Kp / 8; ++j) {
        const float2 s = __ldg(reinterpret_cast<const float2*>(smr + 8 * j));
        const float* d = acc + 4 * j + 2 * h;
        const float d0 = hgemm::select(live, __fmul_rn(s.x, __fsub_rn(d[0], tt)), 0.0f);
        const float d1 = hgemm::select(live, __fmul_rn(s.y, __fsub_rn(d[1], tt)), 0.0f);
        *reinterpret_cast<uint32_t*>(drow + g * Kp + 8 * j + 2 * ln.q) = pack_bf16(d0, d1);
      }
      if (ln.q == 0) {
        const float d = hgemm::select(live, __fmul_rn(__fmul_rn(dal, al), __fsub_rn(1.0f, al)), 0.0f);
        dpre[rr] = d;
        drow[GKp + g] = __float2bfloat16_rn(d);
      }
      if (g == 0)  // the operand's pad columns
        for (int c = GKp + G + ln.q; c < Kx; c += 4) drow[c] = __float2bfloat16_rn(0.0f);
    }
  }
}

// Launch 2a (Kp > 256): d_assign - cdot, f32, into dasg [rows G, Kp] on
// each run's rows, tiles of (128 rows, 256 clusters).
__global__ void __launch_bounds__(hgemm::kThreads, 1)
nxv_dassign_wide_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_v, const int* __restrict__ poff,
                        const int* __restrict__ toff, const float* __restrict__ cdot,
                        float* __restrict__ dasg, int B, int G, int Pp, int Kp) {
  using A = Asg<256>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + A::kStages * A::kStageBytes);
  uint64_t* empty = full + A::kStages;
  const int n_kt = ceil_div(Kp, 256);
  const int tiles = toff[B] * n_kt;
  const int nk = ceil_div(Pp, hgemm::kDepth);
  init_ring(full, empty, A::kStages);

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* xmap = &map_x;
  const CUtensorMap* vmap = &map_v;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int vt = t / n_kt;
        const int ct = t % n_kt;
        const int b = video_of(toff, B, vt);
        const int row0 = poff[b] * G + (vt - toff[b]) * kRows;
        hgemm::produce<A::kStages>(full, empty, ring, nk, A::kStageBytes, [&](int s, uint64_t* bar, int kt) {
          unsigned char* st = smem + s * A::kStageBytes;
          hgemm::tma_3d(st, xmap, bar, kt * hgemm::kDepth, row0, 0);
          hgemm::tma_3d(st + hgemm::kABytes, vmap, bar, kt * hgemm::kDepth, ct * 256, b);
        });
      }
    }
    return;
  }
  hgemm::set_regs_inc<hgemm::kConsumerRegs>();
  const Lane ln;
  const uint32_t a_off = wg * 64 * hgemm::kDepth * 2;
  float acc[128];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int vt = t / n_kt;
    const int ct = t % n_kt;
    const int b = video_of(toff, B, vt);
    const int run_end = poff[b + 1] * G;
    const int row0 = poff[b] * G + (vt - toff[b]) * kRows;
    hgemm::zero<128>(acc);
    hgemm::consume<A::kStages, 128>(full, empty, ring, nk, acc, [&](int s) {
      const uint32_t st = hgemm::smem_u32(smem + s * A::kStageBytes);
#pragma unroll
      for (int kk = 0; kk < hgemm::kDepth / 16; ++kk)
        hgemm::mma<256, 0, 0>(acc, hgemm::desc_a(st + a_off, kk),
                              hgemm::desc_b_k(st + hgemm::kABytes, kk));
    });
    const float* cd = cdot + static_cast<size_t>(b) * Kp + ct * 256;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row0 + 64 * wg + ln.row(h);
      if (rr >= run_end) continue;
      float* drow = dasg + static_cast<size_t>(rr) * Kp + ct * 256;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 8 * j + 2 * ln.q;
        if (ct * 256 + c >= Kp) continue;
        const float2 cc = __ldg(reinterpret_cast<const float2*>(cd + c));
        *reinterpret_cast<float2*>(drow + c) = make_float2(__fsub_rn(acc[4 * j + 2 * h], cc.x),
                                                           __fsub_rn(acc[4 * j + 2 * h + 1], cc.y));
      }
    }
  }
}

// Launch 2b (Kp > 256). Grid (ceil(cap G / 8)): a warp a (frame, group)
// row below poff[B] G, launch 2's VJPs over the row's Kp clusters (sm and
// d_assign are zeros past K).
__global__ void __launch_bounds__(kSimpleThreads)
nxv_vjp_wide_kernel(const int* __restrict__ poff, const int* __restrict__ info,
                    const float* __restrict__ sm, const float* __restrict__ alpha,
                    const float* __restrict__ dasg, bf16* __restrict__ dact,
                    float* __restrict__ dpre, int B, int G, int Kp, int Kx) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rr = blockIdx.x * kSimpleWarps + warp;
  if (rr >= poff[B] * G) return;
  const int fp = rr / G;
  const int g = rr - fp * G;
  const bool live = __ldg(info + fp) >= 0;
  const float al = __ldg(alpha + rr);
  const float* da = dasg + static_cast<size_t>(rr) * Kp;
  const float* s = sm + static_cast<size_t>(rr) * Kp;
  float dal = 0.0f, tt = 0.0f;
  for (int k = lane; k < Kp; k += 32) {
    const float a = __ldg(da + k);
    const float sv = __ldg(s + k);
    dal = __fadd_rn(dal, __fmul_rn(a, sv));
    tt = __fadd_rn(tt, __fmul_rn(sv, __fmul_rn(a, al)));
  }
  dal = warp_sum(dal);
  tt = warp_sum(tt);
  bf16* drow = dact + static_cast<size_t>(fp) * Kx;
  for (int k = lane; k < Kp; k += 32) {
    const float d = __fmul_rn(__ldg(da + k), al);
    const float v = hgemm::select(live, __fmul_rn(__ldg(s + k), __fsub_rn(d, tt)), 0.0f);
    drow[g * Kp + k] = __float2bfloat16_rn(v);
  }
  if (lane == 0) {
    const float d = hgemm::select(live, __fmul_rn(__fmul_rn(dal, al), __fsub_rn(1.0f, al)), 0.0f);
    dpre[rr] = d;
    drow[G * Kp + g] = __float2bfloat16_rn(d);
  }
  if (g == 0)  // the operand's pad columns
    for (int c = G * Kp + G + lane; c < Kx; c += 32) drow[c] = __float2bfloat16_rn(0.0f);
}

// ---------------------------------------------------------------------------
// d_xg = bf16(assign) @ bf16(dv).
// ---------------------------------------------------------------------------

namespace dxg {
constexpr int kStages = 4;
constexpr int kStageBytes = hgemm::kABytes + kWideBoxes * hgemm::kBoxBytes;  // 56 KB
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8;
constexpr int kSmem = hgemm::smem_request(kSmemBytes);
static_assert(kSmem <= 232448, "shared memory a block");
}  // namespace dxg

__global__ void __launch_bounds__(hgemm::kThreads, 1)
nxv_dxg_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_v,
               const int* __restrict__ poff, const int* __restrict__ toff, float* __restrict__ out,
               int B, int G, int Pp, int Kp) {
  using namespace dxg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int n_pt = ceil_div(Pp, kWideCols);
  const int tiles = toff[B] * n_pt;
  const int nk = Kp / hgemm::kDepth;
  init_ring(full, empty, kStages);

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* amap = &map_a;
  const CUtensorMap* vmap = &map_v;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int vt = t / n_pt;
        const int pt = t % n_pt;
        const int b = video_of(toff, B, vt);
        const int row0 = poff[b] * G + (vt - toff[b]) * kRows;
        hgemm::produce<kStages>(full, empty, ring, nk, kStageBytes, [&](int s, uint64_t* bar, int kt) {
          unsigned char* st = smem + s * kStageBytes;
          hgemm::tma_3d(st, amap, bar, kt * hgemm::kDepth, row0, 0);
#pragma unroll
          for (int i = 0; i < kWideBoxes; ++i)
            hgemm::tma_3d(st + hgemm::kABytes + i * hgemm::kBoxBytes, vmap, bar,
                          pt * kWideCols + i * hgemm::kBoxCols, kt * hgemm::kDepth, b);
        });
      }
    }
    return;
  }
  hgemm::set_regs_inc<hgemm::kConsumerRegs>();
  const Lane ln;
  const uint32_t a_off = wg * 64 * hgemm::kDepth * 2;
  float acc[kWideCols / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int vt = t / n_pt;
    const int pt = t % n_pt;
    const int b = video_of(toff, B, vt);
    const int run_end = poff[b + 1] * G;
    const int row0 = poff[b] * G + (vt - toff[b]) * kRows;
    hgemm::zero<kWideCols / 2>(acc);
    hgemm::consume<kStages, kWideCols / 2>(full, empty, ring, nk, acc, [&](int s) {
      const uint32_t st = hgemm::smem_u32(smem + s * kStageBytes);
      const uint32_t vv = st + hgemm::kABytes;
#pragma unroll
      for (int kk = 0; kk < hgemm::kDepth / 16; ++kk) {
        const uint64_t a = hgemm::desc_a(st + a_off, kk);
        hgemm::mma<256, 0, 1>(acc, a, hgemm::desc_b(vv, kk));
        hgemm::mma<32, 0, 1>(acc + 128, a, hgemm::desc_b(vv + 4 * hgemm::kBoxBytes, kk));
      }
    });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row0 + 64 * wg + ln.row(h);
      if (rr >= run_end) continue;
      float* orow = out + static_cast<size_t>(rr) * Pp;
#pragma unroll
      for (int j = 0; j < kWideCols / 8; ++j) {
        const int p = pt * kWideCols + 8 * j + 2 * ln.q;
        if (p < Pp)
          *reinterpret_cast<float2*>(orow + p) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The weight gradients: part[s] = X^T Y over split s's packed rows.
// ---------------------------------------------------------------------------

namespace wgrad {
constexpr int kStages = 4;
constexpr int kStageBytes = hgemm::kABytes + hgemm::boxes(kCols) * hgemm::kBoxBytes;  // 48 KB
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8;
constexpr int kSmem = hgemm::smem_request(kSmemBytes);
static_assert(kSmem <= 232448, "shared memory a block");
}  // namespace wgrad

// X [cap, M] and Y [cap, N] bf16 row-major; part [splits, M, N] f32. A
// split is an equal range of the packed rows below round_up(poff[B], 64),
// a multiple of 64 of them.
__global__ void __launch_bounds__(hgemm::kThreads, 1)
nxv_wgrad_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_y,
                 const int* __restrict__ poff, float* __restrict__ part, int B, int M, int N,
                 int splits) {
  using namespace wgrad;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int rows = round_up(poff[B], hgemm::kDepth);
  const int per = round_up(ceil_div(rows, splits), hgemm::kDepth);
  const int n_mt = ceil_div(M, kRows);
  const int n_nt = ceil_div(N, kCols);
  const int tiles = splits * n_mt * n_nt;
  init_ring(full, empty, kStages);

  auto coords = [&](int t, int& s, int& mt, int& nt, int& d0, int& nk) {
    nt = t % n_nt;
    mt = (t / n_nt) % n_mt;
    s = t / (n_nt * n_mt);
    d0 = s * per;
    const int d1 = min(rows, d0 + per);
    nk = d1 > d0 ? (d1 - d0) / hgemm::kDepth : 0;
  };
  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* xmap = &map_x;
  const CUtensorMap* ymap = &map_y;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int s, mt, nt, d0, nk;
        coords(t, s, mt, nt, d0, nk);
        hgemm::produce<kStages>(full, empty, ring, nk, kStageBytes, [&](int sl, uint64_t* bar, int kt) {
          unsigned char* st = smem + sl * kStageBytes;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            hgemm::tma_3d(st + i * hgemm::kBoxBytes, xmap, bar, mt * kRows + 64 * i,
                          d0 + kt * hgemm::kDepth, 0);
#pragma unroll
          for (int i = 0; i < kCols / hgemm::kBoxCols; ++i)
            hgemm::tma_3d(st + hgemm::kABytes + i * hgemm::kBoxBytes, ymap, bar,
                          nt * kCols + i * hgemm::kBoxCols, d0 + kt * hgemm::kDepth, 0);
        });
      }
    }
    return;
  }
  hgemm::set_regs_inc<hgemm::kConsumerRegs>();
  const Lane ln;
  float acc[kCols / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int s, mt, nt, d0, nk;
    coords(t, s, mt, nt, d0, nk);
    hgemm::zero<kCols / 2>(acc);
    hgemm::consume<kStages, kCols / 2>(full, empty, ring, nk, acc, [&](int sl) {
      const uint32_t st = hgemm::smem_u32(smem + sl * kStageBytes);
#pragma unroll
      for (int kk = 0; kk < hgemm::kDepth / 16; ++kk)
        hgemm::mma<256, 1, 1>(acc, hgemm::desc_a_mn(st + wg * hgemm::kBoxBytes, kk),
                              hgemm::desc_b(st + hgemm::kABytes, kk));
    });
    float* dst = part + static_cast<size_t>(s) * M * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * kRows + 64 * wg + ln.row(h);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int n = nt * kCols + 8 * j + 2 * ln.q;
        if (n < N)
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(m) * N + n) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// out[i] = sum_s part[s][i], the splits in order (n % 4 == 0).
__global__ void __launch_bounds__(kSimpleThreads)
nxv_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, size_t n, int splits) {
  const size_t n4 = n / 4;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 acc = reinterpret_cast<const float4*>(part)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v = reinterpret_cast<const float4*>(part + static_cast<size_t>(s) * n)[i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  }
}

// dab[g] = sum over the packed rows of d_pre (zeros on the pad rows).
// Grid (G): each thread a strided set of rows in order, then a fixed tree.
__global__ void __launch_bounds__(kSimpleThreads)
nxv_dab_kernel(const float* __restrict__ dpre, const int* __restrict__ poff,
               float* __restrict__ dab, int B, int G) {
  __shared__ float s[kSimpleThreads];
  const int g = blockIdx.x;
  const int total = poff[B];
  float acc = 0.0f;
  for (int r = threadIdx.x; r < total; r += kSimpleThreads)
    acc += dpre[static_cast<size_t>(r) * G + g];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int o = kSimpleThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s[threadIdx.x] += s[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) dab[g] = s[0];
}

template <int Kp>
cudaError_t launch_dassign(int sms, cudaStream_t st, const void* xe, const void* dvb,
                           const int* poff, const int* toff, const int* info, const float* sm,
                           const float* alpha, const float* cdot, bf16* dact, float* dpre, int B,
                           int G, int Pp, int Kx, int cap) {
  CUtensorMap map_x, map_v;
  cudaError_t err = hgemm::make_map_bf16(&map_x, xe, 1, cap * G, Pp, Pp, kRows);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_v, dvb, B, Kp, Pp, Pp, Kp);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nxv_dassign_kernel<Kp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Asg<Kp>::kSmem);
  if (err != cudaSuccess) return err;
  nxv_dassign_kernel<Kp><<<sms, hgemm::kThreads, Asg<Kp>::kSmem, st>>>(
      map_x, map_v, poff, toff, info, sm, alpha, cdot, dact, dpre, B, G, Pp, Kx);
  return cudaGetLastError();
}

cudaError_t launch_dassign_wide(int sms, cudaStream_t st, const void* xe, const void* dvb,
                                const int* poff, const int* toff, const float* cdot, float* dasg,
                                int B, int G, int Pp, int Kp, int cap) {
  CUtensorMap map_x, map_v;
  cudaError_t err = hgemm::make_map_bf16(&map_x, xe, 1, cap * G, Pp, Pp, kRows);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_v, dvb, B, Kp, Pp, Pp, 256);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nxv_dassign_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Asg<256>::kSmem);
  if (err != cudaSuccess) return err;
  nxv_dassign_wide_kernel<<<sms, hgemm::kThreads, Asg<256>::kSmem, st>>>(
      map_x, map_v, poff, toff, cdot, dasg, B, G, Pp, Kp);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(int sms, cudaStream_t st, const void* x, const void* y, const int* poff,
                         float* part, float* out, int B, int M, int N, int cap, int splits) {
  CUtensorMap map_x, map_y;
  cudaError_t err = hgemm::make_map_bf16(&map_x, x, 1, cap, M, M, hgemm::kDepth);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_y, y, 1, cap, N, N, hgemm::kDepth);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nxv_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wgrad::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = splits * ceil_div(M, kRows) * ceil_div(N, kCols);
  nxv_wgrad_kernel<<<tiles < sms ? tiles : sms, hgemm::kThreads, wgrad::kSmem, st>>>(
      map_x, map_y, poff, part, B, M, N, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(M) * N;
  const size_t want = (n / 4 + kSimpleThreads - 1) / kSimpleThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  nxv_reduce_kernel<<<blocks, kSimpleThreads, 0, st>>>(part, out, n, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nxv

using namespace nxv;

// The backward from the forward's residuals (nextvlad.cu's scratch with sm,
// alpha, a_sum and vlad): poff [B + 1] and toff [B + 1] int32 (toff the
// prefix sums of each video's ceil(n_pad G / 128) tiles), info [cap]
// int32; xb [cap, D8], xe [cap, G Pp], assign [cap, G Kp] bf16; sm [cap,
// G Kp], alpha [cap, G], vlad [B, K, P], a_sum [B, Kp] f32; dy [B, K, P]
// f32, centers [K, P] f32, wext [Kx, G Pp] bf16 (Kx = G Kp + round_up(G,
// 8)). Scratch: dv [B, K, P] f32, dvb [B, Kp, Pp] bf16, cdot [B, Kp] f32,
// dact [cap, Kx] bf16, dpre [cap, G] f32, dxg [cap, G Pp] f32, dxe [cap, G
// Pp] bf16, part_ext [splits, G Pp, Kx] and part_we [splits, D8, G Pp]
// f32; dasg [cap G, Kp] f32 when Kp > 256 (else may be null). Outputs
// (f32): dwe [D8, G Pp], dwext [G Pp, Kx], dab [G], dcenters [K, P].
extern "C" int yt8m_nextvlad_train_backward(
    const void* poff_v, const void* toff_v, const void* info_v, const void* xb, const void* xe,
    const void* assign, const void* sm, const void* alpha, const void* vlad, const void* a_sum,
    const void* dy, const void* centers, const void* wext, void* dv, void* dvb, void* cdot,
    void* dact, void* dpre, void* dxg, void* dxe, void* part_ext, void* part_we, void* dasg,
    void* dwe, void* dwext, void* dab, void* dcenters, int B, int F, int D8, int G, int K, int P,
    int cap, int splits, void* stream) {
  const long long Pp_ = round_up(P, 8), Kp_ = round_up(K, 64);
  const long long widest = Pp_ > Kp_ ? (Pp_ > 256 ? Pp_ : 256) : (Kp_ > 256 ? Kp_ : 256);
  if (B <= 0 || B > 65535 || F <= 0 || D8 <= 0 || D8 % 8 != 0 || G <= 0 || G > 65535 ||
      K <= 0 || P <= 0 || splits <= 0 ||
      cap < static_cast<long long>(B) * round_up(F, run_frames(G)) + kRows ||
      static_cast<long long>(cap) * G * widest >= (1LL << 31) ||
      (Kp_ > kMaxClusters && dasg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Pp = round_up(P, 8);
  const int Kp = round_up(K, 64);
  const int GP = G * Pp;
  const int Kx = G * Kp + round_up(G, 8);
  const int* poff = static_cast<const int*>(poff_v);
  const int* toff = static_cast<const int*>(toff_v);
  const int* info = static_cast<const int*>(info_v);
  float* dvp = static_cast<float*>(dv);
  bf16* dactp = static_cast<bf16*>(dact);
  float* dprep = static_cast<float*>(dpre);
  cudaError_t err = cudaGetLastError();
  int sms = 0;
  if (err == cudaSuccess) err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);

  nxv_dv_kernel<<<dim3(Kp / kSimpleWarps, B + 1), kSimpleThreads, 0, st>>>(
      static_cast<const float*>(vlad), static_cast<const float*>(dy),
      static_cast<const float*>(centers), poff, dvp, static_cast<bf16*>(dvb),
      static_cast<float*>(cdot), dactp, B, K, P, Pp, Kp, Kx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nxv_dcenters_kernel<<<static_cast<unsigned>((static_cast<size_t>(K) * P + kSimpleThreads - 1) /
                                               kSimpleThreads),
                        kSimpleThreads, 0, st>>>(
      static_cast<const float*>(a_sum), dvp, static_cast<float*>(dcenters), B, K, P, Kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* smp = static_cast<const float*>(sm);
  const float* alp = static_cast<const float*>(alpha);
  const float* cdp = static_cast<const float*>(cdot);
  if (Kp > kMaxClusters) {
    float* dasgp = static_cast<float*>(dasg);
    err = launch_dassign_wide(sms, st, xe, dvb, poff, toff, cdp, dasgp, B, G, Pp, Kp, cap);
    if (err == cudaSuccess) {
      const long long rows = static_cast<long long>(cap) * G;
      nxv_vjp_wide_kernel<<<static_cast<unsigned>((rows + kSimpleWarps - 1) / kSimpleWarps),
                            kSimpleThreads, 0, st>>>(poff, info, smp, alp, dasgp, dactp, dprep, B,
                                                     G, Kp, Kx);
      err = cudaGetLastError();
    }
  } else switch (Kp / 64) {
    case 1: err = launch_dassign<64>(sms, st, xe, dvb, poff, toff, info, smp, alp, cdp, dactp, dprep, B, G, Pp, Kx, cap); break;
    case 2: err = launch_dassign<128>(sms, st, xe, dvb, poff, toff, info, smp, alp, cdp, dactp, dprep, B, G, Pp, Kx, cap); break;
    case 3: err = launch_dassign<192>(sms, st, xe, dvb, poff, toff, info, smp, alp, cdp, dactp, dprep, B, G, Pp, Kx, cap); break;
    default: err = launch_dassign<256>(sms, st, xe, dvb, poff, toff, info, smp, alp, cdp, dactp, dprep, B, G, Pp, Kx, cap); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap map_a, map_v;
  err = hgemm::make_map_bf16(&map_a, assign, 1, cap * G, Kp, Kp, kRows);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_v, dvb, B, Kp, Pp, Pp, hgemm::kDepth);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nxv_dxg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dxg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nxv_dxg_kernel<<<sms, hgemm::kThreads, dxg::kSmem, st>>>(map_a, map_v, poff, toff,
                                                            static_cast<float*>(dxg), B, G, Pp, Kp);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_row_product(dact, wext, dxe, static_cast<const float*>(dxg), poff, info, B, cap,
                             GP, Kx, st);
  if (err == cudaSuccess)
    err = launch_wgrad(sms, st, xe, dact, poff, static_cast<float*>(part_ext),
                       static_cast<float*>(dwext), B, GP, Kx, cap, splits);
  if (err == cudaSuccess)
    err = launch_wgrad(sms, st, xb, dxe, poff, static_cast<float*>(part_we),
                       static_cast<float*>(dwe), B, D8, GP, cap, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  nxv_dab_kernel<<<G, kSimpleThreads, 0, st>>>(dprep, poff, static_cast<float*>(dab), B, G);
  return static_cast<int>(cudaGetLastError());
}

// The backward's tiles: [stages and shared bytes of the d_assign launch at
// Kp = 64, 128, 192, 256 (stages once; its wide instance, Kp > 256, is
// the one of 256), the d_xg launch's stages and shared bytes, the weight
// gradients' stages and shared bytes].
extern "C" int yt8m_nextvlad_train_plan(int* plan) {
  plan[0] = Asg<128>::kStages;
  plan[1] = Asg<64>::kSmem;
  plan[2] = Asg<128>::kSmem;
  plan[3] = Asg<192>::kSmem;
  plan[4] = Asg<256>::kSmem;
  plan[5] = dxg::kStages;
  plan[6] = dxg::kSmem;
  plan[7] = wgrad::kStages;
  plan[8] = wgrad::kSmem;
  return static_cast<int>(cudaSuccess);
}
