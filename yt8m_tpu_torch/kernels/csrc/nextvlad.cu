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
// (0.05 ms at 3.35 TB/s): operations.
//
// Design. The TPU kernel holds a video in VMEM (x, xe and the f32 logits,
// ~3 MB); a Hopper block has 227 KB of shared memory, so the work is cut
// into six launches on the caller's stream, every product a tiled
// tensor-core product (nextvlad_gemm.cuh). The live frames of all videos
// are packed one after another (row_off, the prefix sums of the live
// counts): the frame-row products tile the packed rows, so a short video
// wastes no tile and frames past n are neither read nor computed.
//  0. nxv_frames_to_bf16: xb = bf16(dequant(x)) for the live frames.
//  1. nxv_expand_kernel, a block per (128 columns of De, 128 packed
//     rows): xe = xb @ We, rounded to bf16 once.
//  2. nxv_alpha_kernel, a warp a packed row: the G attention dots
//     xe . Wa[:, g] (length De, bf16 operands, f32 sums on the CUDA cores,
//     Wa in shared memory) and alpha; bound by reading xe.
//  3. nxv_cluster_kernel, a block per (group, 128 packed rows): the
//     group's Kp cluster columns of xe @ Wc over all of De, so that the
//     epilogue holds whole softmax rows: the softmax, bf16(assign), and
//     the f32 column sums of the assignment of each video's run of rows
//     in the tile (and, for training, the f32 softmax).
//  4. nxv_aggregate_kernel, a block per (128 columns of P, 128 clusters,
//     video): assign^T @ xg over the video's n G rows (xe seen as
//     [F G, Pp] is row-major, the assignment tile is read column-major),
//     minus a_sum (x) centers, with each row's partial sum of squares.
//  5. nxv_norm_kernel: the intra-norm.
// Scratch from the caller (B=512): xb 354 MB, xe 708 MB, the bf16
// assignment 315 MB, vlad 75 MB (each written for the live frames only).
// wgmma + TMA and keeping xe on chip are later work.

#include "nextvlad_gemm.cuh"

using namespace nxv;

namespace {

constexpr float kDeqScale = static_cast<float>(4.0 / 255.0);
constexpr float kDeqBias = static_cast<float>(4.0 / 512.0 - 2.0);
constexpr float kNormEpsSq = 1e-12f;
constexpr int kTile = 128;  // rows and columns of a block tile
constexpr int kMaxClusters = 256;
constexpr int kAlphaRows = 64;  // packed rows a block of the attention launch
constexpr int kMaxAlphaSmem = 200 * 1024;

using Expand = BlockMma<kTile, kTile, false, false>;
using Aggregate = BlockMma<kTile, kTile, true, false>;
template <int FNW>
using Cluster = BlockMma<kTile, 64 * FNW, false, false>;

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

// Launch 0: xb = bf16(dequant(x)) for the live rows, eight values a
// thread (D8 % 8 == 0). Rows past n are not written.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nxv_frames_to_bf16(const T* __restrict__ x, const int* __restrict__ num_frames,
                   bf16* __restrict__ xb, int B, int F, int D8) {
  const size_t row_chunks = D8 / 8;
  const size_t n8 = static_cast<size_t>(B) * F * row_chunks;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / row_chunks;
    const int b = static_cast<int>(row / F);
    const int f = static_cast<int>(row % F);
    if (f >= live_frames(num_frames, b, F)) continue;
    float v[8];
    load8(x + i * 8, v);
    if (std::is_same<T, uint8_t>::value) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(__fmul_rn(v[j], kDeqScale), kDeqBias);
    }
    store8_bf16(xb + i * 8, v);
  }
}

// Launch 1. Grid (ceil(GP / 128), ceil(B F / 128)).
__global__ void __launch_bounds__(kThreads, 2)
nxv_expand_kernel(const bf16* __restrict__ xb, const int* __restrict__ row_off,
                  const bf16* __restrict__ we, bf16* __restrict__ xe, int B, int F, int D8,
                  int GP) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_row[kTile];
  const int n0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;
  if (r0 >= row_off[B]) return;
  packed_rows<kTile>(row_off, B, F, r0, s_row);
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * Expand::kStageA;
  auto load = [&](int slot, int step) {
    const int k0 = step * kBK;
    Expand::load(
        sA, sB, slot,
        [&](int r, int c, bool& ok) {
          ok = s_row[r] >= 0 && k0 + c < D8;
          return ok ? xb + static_cast<size_t>(s_row[r]) * D8 + k0 + c : xb;
        },
        [&](int r, int c, bool& ok) {
          ok = k0 + r < D8 && n0 + c < GP;
          return ok ? we + static_cast<size_t>(k0 + r) * GP + n0 + c : we;
        });
  };
  Expand::Acc acc[Expand::FM][Expand::FN];
  Expand::run(acc, sA, sB, (D8 + kBK - 1) / kBK, load);
  float* S = reinterpret_cast<float*>(smem);
  Expand::store(acc, S);
  __syncthreads();
  for (int c = threadIdx.x; c < kTile * (kTile / 8); c += kThreads) {
    const int r = c / (kTile / 8);
    const int col = (c % (kTile / 8)) * 8;
    const int n = n0 + col;
    if (s_row[r] >= 0 && n < GP)
      store8_bf16(xe + static_cast<size_t>(s_row[r]) * GP + n, S + r * Expand::kLdS + col);
  }
}

// Launch 2. Grid (ceil(B F / 64)); dynamic shared memory G GP bf16.
__global__ void __launch_bounds__(kThreads)
nxv_alpha_kernel(const bf16* __restrict__ xe, const int* __restrict__ row_off,
                 const bf16* __restrict__ wa, const float* __restrict__ ab,
                 float* __restrict__ alpha, int B, int F, int G, int GP) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int total = row_off[B];
  const int r0 = blockIdx.x * kAlphaRows;
  if (r0 >= total) return;
  const int chunks = GP / 8;
  uint4* s_wa = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < G * chunks; i += kThreads)
    s_wa[i] = __ldg(reinterpret_cast<const uint4*>(wa) + i);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r_end = min(total, r0 + kAlphaRows);
  for (int r = r0 + warp; r < r_end; r += kWarps) {
    const int b = video_of(row_off, B, r);
    const size_t row = static_cast<size_t>(b) * F + (r - row_off[b]);
    const uint4* xr = reinterpret_cast<const uint4*>(xe + row * GP);
    for (int g0 = 0; g0 < G; g0 += 8) {
      float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int c = lane; c < chunks; c += 32) {
        float xv[8];
        unpack8_bf16(xr[c], xv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (g0 + j < G) {
            float wv[8];
            unpack8_bf16(s_wa[(g0 + j) * chunks + c], wv);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[j] = fmaf(xv[i], wv[i], acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s = warp_sum(acc[j]);
        if (lane == 0 && g0 + j < G)
          alpha[row * G + g0 + j] = 1.0f / (1.0f + expf(-__fadd_rn(s, ab[g0 + j])));
      }
    }
  }
}

// Launch 3. Grid (G, ceil(B F / 128)). Kp = 64 FNW cluster columns;
// asum_part [B, J, G, Kp] gets, for each video with rows in the tile, the
// column sums of those rows at j = tile - row_off[b] / 128.
template <int FNW>
__global__ void __launch_bounds__(kThreads, FNW <= 2 ? 2 : 1)
nxv_cluster_kernel(const bf16* __restrict__ xe, const int* __restrict__ row_off,
                   const bf16* __restrict__ wc, const float* __restrict__ alpha,
                   bf16* __restrict__ assign, float* __restrict__ asum_part,
                   float* __restrict__ sm_out, int B, int F, int G, int K, int GP, int J) {
  using M = Cluster<FNW>;
  constexpr int Kp = 64 * FNW;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_row[kTile];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = blockIdx.x;
  const int tile = blockIdx.y;
  const int r0 = tile * kTile;
  if (r0 >= row_off[B]) return;
  packed_rows<kTile>(row_off, B, F, r0, s_row);
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * M::kStageA;
  const bf16* wcg = wc + g * Kp;
  const int ldw = G * Kp;
  auto load = [&](int slot, int step) {
    const int k0 = step * kBK;
    M::load(
        sA, sB, slot,
        [&](int r, int c, bool& ok) {
          ok = s_row[r] >= 0 && k0 + c < GP;
          return ok ? xe + static_cast<size_t>(s_row[r]) * GP + k0 + c : xe;
        },
        [&](int r, int c, bool& ok) {
          ok = k0 + r < GP;
          return ok ? wcg + static_cast<size_t>(k0 + r) * ldw + c : wc;
        });
  };
  typename M::Acc acc[M::FM][M::FN];
  M::run(acc, sA, sB, (GP + kBK - 1) / kBK, load);
  float* S = reinterpret_cast<float*>(smem);
  M::store(acc, S);
  __syncthreads();

  // A warp a row: the softmax over the K real clusters and the
  // assignment sm * alpha (f32 back into S for the column sums).
  for (int r = warp; r < kTile; r += kWarps) {
    const int sr = s_row[r];
    if (sr < 0) break;
    float* row = S + r * M::kLdS;
    float m = -INFINITY;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, row[k]);
    m = warp_max(m);
    float s = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float e = expf(__fsub_rn(row[k], m));
      row[k] = e;
      s += e;
    }
    s = warp_sum(s);
    const float al = alpha[static_cast<size_t>(sr) * G + g];
    const size_t o = (static_cast<size_t>(sr) * G + g) * Kp;
    for (int k = lane; k < Kp; k += 32) {
      const float p = k < K ? row[k] / s : 0.0f;
      const float a = __fmul_rn(p, al);
      row[k] = a;
      assign[o + k] = __float2bfloat16_rn(a);
      if (sm_out != nullptr) sm_out[o + k] = p;
    }
  }
  __syncthreads();
  // Column sums, a video's run of rows at a time, rows in order.
  if (tid < Kp) {
    int cur = -1;
    float t = 0.0f;
    for (int r = 0; r < kTile && s_row[r] >= 0; ++r) {
      const int b = s_row[r] / F;
      if (b != cur) {
        if (cur >= 0)
          asum_part[((static_cast<size_t>(cur) * J + tile - row_off[cur] / kTile) * G + g) * Kp +
                    tid] = t;
        cur = b;
        t = 0.0f;
      }
      t += S[r * M::kLdS + tid];
    }
    if (cur >= 0)
      asum_part[((static_cast<size_t>(cur) * J + tile - row_off[cur] / kTile) * G + g) * Kp + tid] =
          t;
  }
}

// Launch 4. Grid (ceil(Pp / 128), ceil(Kp / 128), B).
__global__ void __launch_bounds__(kThreads, 2)
nxv_aggregate_kernel(const bf16* __restrict__ assign, const bf16* __restrict__ xe,
                     const int* __restrict__ row_off, const float* __restrict__ asum_part,
                     const float* __restrict__ centers, float* __restrict__ vlad,
                     float* __restrict__ sumsq, float* __restrict__ a_sum, int F, int G, int K,
                     int P, int Pp, int Kp, int J) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_asum[kTile];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * Aggregate::kStageA;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const int live = row_off[b + 1] - row_off[b];
  const int rows = live * G;  // the (frame, group) rows to sum
  const bf16* av = assign + static_cast<size_t>(b) * F * G * Kp;
  const bf16* xv = xe + static_cast<size_t>(b) * F * G * Pp;
  auto load = [&](int slot, int step) {
    const int k0 = step * kBK;
    Aggregate::load(
        sA, sB, slot,
        [&](int r, int c, bool& ok) {
          ok = k0 + r < rows && m0 + c < Kp;
          return ok ? av + static_cast<size_t>(k0 + r) * Kp + m0 + c : assign;
        },
        [&](int r, int c, bool& ok) {
          ok = k0 + r < rows && n0 + c < Pp;
          return ok ? xv + static_cast<size_t>(k0 + r) * Pp + n0 + c : xe;
        });
  };
  Aggregate::Acc acc[Aggregate::FM][Aggregate::FN];
  Aggregate::run(acc, sA, sB, (rows + kBK - 1) / kBK, load);
  float* S = reinterpret_cast<float*>(smem);
  Aggregate::store(acc, S);
  // The tiles holding the video's rows, in order.
  const int j_end = live > 0 ? (row_off[b + 1] - 1) / kTile - row_off[b] / kTile + 1 : 0;
  for (int m = tid; m < kTile; m += kThreads) {
    const int k = m0 + m;
    float t = 0.0f;
    if (k < Kp)
      for (int j = 0; j < j_end; ++j)
        for (int gg = 0; gg < G; ++gg)
          t += asum_part[((static_cast<size_t>(b) * J + j) * G + gg) * Kp + k];
    s_asum[m] = t;
    if (blockIdx.x == 0 && k < Kp) a_sum[static_cast<size_t>(b) * Kp + k] = t;
  }
  __syncthreads();
  // A warp a cluster row: vlad = sum - a_sum * centers (multiply and
  // subtract each rounded, as the plain version), the row's partial sum
  // of squares over the block's columns.
  for (int m = warp; m < kTile; m += kWarps) {
    const int k = m0 + m;
    if (k >= K) break;
    const float as = s_asum[m];
    float ss = 0.0f;
    for (int c = lane; c < kTile; c += 32) {
      const int p = n0 + c;
      if (p < P) {
        const float v = __fsub_rn(S[m * Aggregate::kLdS + c],
                                  __fmul_rn(as, centers[static_cast<size_t>(k) * P + p]));
        vlad[(static_cast<size_t>(b) * K + k) * P + p] = v;
        ss = fmaf(v, v, ss);
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) sumsq[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * K + k] = ss;
  }
}

// Launch 5. Grid (ceil(K / 8), B): a warp a row, out = vlad / n.
__global__ void __launch_bounds__(kThreads)
nxv_norm_kernel(const float* __restrict__ vlad, const float* __restrict__ sumsq,
                float* __restrict__ out, int K, int P, int ptiles) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= K) return;
  float ss = 0.0f;
  for (int t = 0; t < ptiles; ++t) ss += sumsq[(static_cast<size_t>(b) * ptiles + t) * K + k];
  const float n = sqrtf(fmaxf(ss, kNormEpsSq));
  const size_t o = (static_cast<size_t>(b) * K + k) * P;
  for (int p = lane; p < P; p += 32) out[o + p] = vlad[o + p] / n;
}

template <int FNW>
cudaError_t launch_cluster(dim3 grid, cudaStream_t st, const bf16* xe, const int* row_off,
                           const bf16* wc, const float* alpha, bf16* assign, float* asum_part,
                           float* sm, int B, int F, int G, int K, int GP, int J) {
  constexpr int bytes = Cluster<FNW>::kBytes;
  cudaError_t err = set_smem(nxv_cluster_kernel<FNW>, bytes);
  if (err != cudaSuccess) return err;
  nxv_cluster_kernel<FNW><<<grid, kThreads, bytes, st>>>(xe, row_off, wc, alpha, assign,
                                                          asum_part, sm, B, F, G, K, GP, J);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* num_frames, const void* row_off_v, const void* we,
           const void* wc, const void* wa, const void* ab, const void* centers, void* xb,
           void* xe, void* assign, void* asum_part, void* alpha, void* vlad, void* sumsq,
           void* a_sum, void* sm, void* out, int B, int F, int D8, int G, int K, int P,
           void* stream) {
  const int Pp = round_up(P, 8);
  const int Kp = round_up(K, 64);
  const int GP = G * Pp;
  const size_t alpha_smem = static_cast<size_t>(G) * GP * 2;
  if (B <= 0 || B > 65535 || F <= 0 || D8 <= 0 || D8 % 8 != 0 || G <= 0 || K <= 0 ||
      K > kMaxClusters || P <= 0 || alpha_smem > kMaxAlphaSmem ||
      (static_cast<size_t>(B) * F + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int J = (F + kTile - 1) / kTile + 1;
  const int ptiles = (Pp + kTile - 1) / kTile;
  const int row_tiles = static_cast<int>((static_cast<size_t>(B) * F + kTile - 1) / kTile);
  const int* nf = static_cast<const int*>(num_frames);
  const int* row_off = static_cast<const int*>(row_off_v);
  bf16* xbp = static_cast<bf16*>(xb);
  bf16* xep = static_cast<bf16*>(xe);
  bf16* asg = static_cast<bf16*>(assign);
  float* part = static_cast<float*>(asum_part);
  float* alp = static_cast<float*>(alpha);

  const size_t n8 = static_cast<size_t>(B) * F * D8 / 8;
  const size_t want = (n8 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  nxv_frames_to_bf16<T><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x), nf, xbp, B, F, D8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = set_smem(nxv_expand_kernel, Expand::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  nxv_expand_kernel<<<dim3((GP + kTile - 1) / kTile, row_tiles), kThreads, Expand::kBytes, st>>>(
      xbp, row_off, static_cast<const bf16*>(we), xep, B, F, D8, GP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = set_smem(nxv_alpha_kernel, static_cast<int>(alpha_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nxv_alpha_kernel<<<static_cast<int>((static_cast<size_t>(B) * F + kAlphaRows - 1) / kAlphaRows),
                     kThreads, alpha_smem, st>>>(xep, row_off, static_cast<const bf16*>(wa),
                                                 static_cast<const float*>(ab), alp, B, F, G, GP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 cgrid(G, row_tiles);
  const bf16* wcp = static_cast<const bf16*>(wc);
  float* smp = static_cast<float*>(sm);
  switch (Kp / 64) {
    case 1: err = launch_cluster<1>(cgrid, st, xep, row_off, wcp, alp, asg, part, smp, B, F, G, K, GP, J); break;
    case 2: err = launch_cluster<2>(cgrid, st, xep, row_off, wcp, alp, asg, part, smp, B, F, G, K, GP, J); break;
    case 3: err = launch_cluster<3>(cgrid, st, xep, row_off, wcp, alp, asg, part, smp, B, F, G, K, GP, J); break;
    default: err = launch_cluster<4>(cgrid, st, xep, row_off, wcp, alp, asg, part, smp, B, F, G, K, GP, J); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  err = set_smem(nxv_aggregate_kernel, Aggregate::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  nxv_aggregate_kernel<<<dim3(ptiles, (Kp + kTile - 1) / kTile, B), kThreads, Aggregate::kBytes,
                         st>>>(asg, xep, row_off, part, static_cast<const float*>(centers),
                               static_cast<float*>(vlad), static_cast<float*>(sumsq),
                               static_cast<float*>(a_sum), F, G, K, P, Pp, Kp, J);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  nxv_norm_kernel<<<dim3((K + kWarps - 1) / kWarps, B), kThreads, 0, st>>>(
      static_cast<const float*>(vlad), static_cast<const float*>(sumsq),
      static_cast<float*>(out), K, P, ptiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row_off [B + 1] int32: the prefix sums of min(max(num_frames, 0), F).
// Weights in the wrapper's padded bf16 layout (kernels/nextvlad.py ::
// kernel_layout): we [D8, G Pp], wc [G Pp, G Kp], wa [G, G Pp]; ab [G] and
// centers [K, P] f32. Scratch: xb [B, F, D8], xe [B, F, G Pp], assign
// [B, F, G, Kp] bf16; asum_part [B, ceil(F/128) + 1, G, Kp], alpha
// [B, F, G], vlad [B, K, P], sumsq [B, ceil(Pp/128), K], a_sum [B, Kp]
// f32. sm [B, F, G, Kp] f32 is written when not null (with alpha, the
// backward's residuals). out [B, K, P] f32.
extern "C" int yt8m_nextvlad_aggregate_u8(const void* x, const void* num_frames,
                                          const void* row_off, const void* we, const void* wc,
                                          const void* wa, const void* ab, const void* centers,
                                          void* xb, void* xe, void* assign, void* asum_part,
                                          void* alpha, void* vlad, void* sumsq, void* a_sum,
                                          void* sm, void* out, int B, int F, int D8, int G,
                                          int K, int P, void* stream) {
  return launch<uint8_t>(x, num_frames, row_off, we, wc, wa, ab, centers, xb, xe, assign,
                         asum_part, alpha, vlad, sumsq, a_sum, sm, out, B, F, D8, G, K, P,
                         stream);
}

extern "C" int yt8m_nextvlad_aggregate_f32(const void* x, const void* num_frames,
                                           const void* row_off, const void* we, const void* wc,
                                           const void* wa, const void* ab, const void* centers,
                                           void* xb, void* xe, void* assign, void* asum_part,
                                           void* alpha, void* vlad, void* sumsq, void* a_sum,
                                           void* sm, void* out, int B, int F, int D8, int G,
                                           int K, int P, void* stream) {
  return launch<float>(x, num_frames, row_off, we, wc, wa, ab, centers, xb, xe, assign,
                       asum_part, alpha, vlad, sumsq, a_sum, sm, out, B, F, D8, G, K, P,
                       stream);
}
