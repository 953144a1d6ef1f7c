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
// TB/s): operations.
//
// Design. The TPU backward runs its grid in order and adds each video's
// five weight gradients into resident VMEM accumulators; CUDA blocks run
// at once, so the weight gradients here are split-K products: a split is
// a run of videos, its block tiles write f32 partials, and a second pass
// adds the partials in split order. No atomics: two runs give the same
// bits. Launches, on the caller's stream:
//  1. nxv_dv_kernel (a warp a cluster row: dv, bf16(dv) padded to
//     [Kp, Pp], cdot) and nxv_dcenters_kernel (a thread a (k, p), the
//     videos in order);
//  2. nxv_rows_kernel, a block per (128 (frame, group) rows, video):
//     d_assign on the tensor cores (xe seen as [F G, Pp] against bf16(dv)
//     read column-major), a warp a row for the softmax and sigmoid VJPs
//     (bf16(d_act) and bf16(d_pre) into one [F, G Kp + KA] operand, f32
//     d_pre), then d_xg = bf16(assign) @ bf16(dv), 128 columns at a time;
//  3. nxv_dxe_kernel, a block per (128 columns of De, 128 packed live
//     rows, as nextvlad.cu packs them): [d_act | d_pre] @ wext, plus
//     d_xg, rounded to bf16 once;
//  4. nxv_wgrad_kernel twice (xe^T [d_act | d_pre], then xb^T d_xe), a
//     block per (128 x 128 output tile, split), over the split's live
//     frames, and nxv_reduce_kernel for each;
//  5. nxv_dab_kernel (a block a group, a fixed-order tree).
// Rows past n are never read (zero-filled). Scratch from the caller
// (B=256): dv, bf16(dv), d_act 159 MB, d_xg 708 MB, d_xe 354 MB, the
// partials 16 x 19.6 MB.

#include "nextvlad_gemm.cuh"

using namespace nxv;

namespace {

constexpr float kNormEpsSq = 1e-12f;
constexpr int kTile = 128;
constexpr int kMaxClusters = 256;

template <int FNW>
using Assign = BlockMma<kTile, 64 * FNW, false, true>;  // xg @ dv^T
using Square = BlockMma<kTile, kTile, false, false>;    // d_xg, d_xe
using Wgrad = BlockMma<kTile, kTile, true, false>;      // A^T B over frames

template <int FNW>
constexpr int rows_smem() {
  constexpr int a = Assign<FNW>::kBytes;
  return a > Square::kBytes ? a : Square::kBytes;
}

// dv, its bf16 copy padded to [Kp, Pp] (zeros past K and P), cdot [B, Kp].
// Grid (Kp / 8, B): a warp a cluster row.
__global__ void __launch_bounds__(kThreads)
nxv_dv_kernel(const float* __restrict__ vlad, const float* __restrict__ dy,
              const float* __restrict__ centers, float* __restrict__ dv,
              bf16* __restrict__ dvb, float* __restrict__ cdot, int K, int P, int Pp, int Kp) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int k = blockIdx.x * kWarps + warp;
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
__global__ void __launch_bounds__(kThreads)
nxv_dcenters_kernel(const float* __restrict__ a_sum, const float* __restrict__ dv,
                    float* __restrict__ dcenters, int B, int K, int P, int Kp) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= K * P) return;
  const int k = i / P;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b)
    acc = __fadd_rn(acc, __fmul_rn(-a_sum[static_cast<size_t>(b) * Kp + k],
                                   dv[static_cast<size_t>(b) * K * P + i]));
  dcenters[i] = acc;
}

// Grid (ceil(F G / 128), B). Kp = 64 FNW.
template <int FNW>
__global__ void __launch_bounds__(kThreads)
nxv_rows_kernel(const bf16* __restrict__ xe, const bf16* __restrict__ assign,
                const float* __restrict__ sm, const float* __restrict__ alpha,
                const int* __restrict__ num_frames, const bf16* __restrict__ dvb,
                const float* __restrict__ cdot, bf16* __restrict__ dact,
                float* __restrict__ dpre, float* __restrict__ dxg, int F, int G, int K, int Pp,
                int Kx) {
  using M1 = Assign<FNW>;
  constexpr int Kp = 64 * FNW;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = blockIdx.x * kTile;
  const int b = blockIdx.y;
  const int live = live_frames(num_frames, b, F);
  const int rows = live * G;
  if (r0 >= rows) return;
  const int all_rows = F * G;
  const bf16* xv = xe + static_cast<size_t>(b) * all_rows * Pp;
  const bf16* av = assign + static_cast<size_t>(b) * all_rows * Kp;
  const bf16* dvv = dvb + static_cast<size_t>(b) * Kp * Pp;
  const float* cd = cdot + static_cast<size_t>(b) * Kp;

  // 1. d_assign (before cdot) = xg @ bf16(dv)^T over Pp.
  {
    bf16* sA = reinterpret_cast<bf16*>(smem);
    bf16* sB = sA + kStages * M1::kStageA;
    auto load = [&](int slot, int step) {
      const int k0 = step * kBK;
      M1::load(
          sA, sB, slot,
          [&](int r, int c, bool& ok) {
            ok = r0 + r < rows && k0 + c < Pp;
            return ok ? xv + static_cast<size_t>(r0 + r) * Pp + k0 + c : xe;
          },
          [&](int r, int c, bool& ok) {  // Bt[k][p] = bf16(dv)[k][p]
            ok = k0 + c < Pp;
            return ok ? dvv + static_cast<size_t>(r) * Pp + k0 + c : dvb;
          });
    };
    typename M1::Acc acc[M1::FM][M1::FN];
    M1::run(acc, sA, sB, (Pp + kBK - 1) / kBK, load);
    M1::store(acc, reinterpret_cast<float*>(smem));
  }
  __syncthreads();

  // 2. A warp a row (f, g): the softmax and sigmoid VJPs.
  float* S = reinterpret_cast<float*>(smem);
  const int nrows = min(kTile, all_rows - r0);
  for (int m = warp; m < nrows; m += kWarps) {
    const int r = r0 + m;
    const int f = r / G;
    const int g = r % G;
    bf16* drow = dact + (static_cast<size_t>(b) * F + f) * Kx;
    const size_t pre_at = (static_cast<size_t>(b) * F + f) * G + g;
    if (g == 0)
      for (int j = G * Kp + G + lane; j < Kx; j += 32) drow[j] = __float2bfloat16_rn(0.0f);
    if (r >= rows) {  // a frame past n: zeros
      for (int k = lane; k < Kp; k += 32) drow[g * Kp + k] = __float2bfloat16_rn(0.0f);
      if (lane == 0) {
        dpre[pre_at] = 0.0f;
        drow[G * Kp + g] = __float2bfloat16_rn(0.0f);
      }
      continue;
    }
    float* srow = S + m * M1::kLdS;
    const float* smr = sm + (static_cast<size_t>(b) * all_rows + r) * Kp;
    const float al = alpha[pre_at];
    float dal = 0.0f;
    float t = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float s = smr[k];
      const float da = __fsub_rn(srow[k], cd[k]);
      const float dsm = __fmul_rn(da, al);
      srow[k] = dsm;
      dal = __fadd_rn(dal, __fmul_rn(da, s));
      t = __fadd_rn(t, __fmul_rn(s, dsm));
    }
    dal = warp_sum(dal);
    t = warp_sum(t);
    for (int k = lane; k < Kp; k += 32) {
      const float d = k < K ? __fmul_rn(smr[k], __fsub_rn(srow[k], t)) : 0.0f;
      drow[g * Kp + k] = __float2bfloat16_rn(d);
    }
    if (lane == 0) {
      const float d = __fmul_rn(__fmul_rn(dal, al), __fsub_rn(1.0f, al));
      dpre[pre_at] = d;
      drow[G * Kp + g] = __float2bfloat16_rn(d);
    }
  }
  __syncthreads();

  // 3. d_xg = bf16(assign) @ bf16(dv), 128 columns at a time.
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * Square::kStageA;
  for (int n0 = 0; n0 < Pp; n0 += kTile) {
    auto load = [&](int slot, int step) {
      const int k0 = step * kBK;
      Square::load(
          sA, sB, slot,
          [&](int r, int c, bool& ok) {
            ok = r0 + r < rows;
            return ok ? av + static_cast<size_t>(r0 + r) * Kp + k0 + c : assign;
          },
          [&](int r, int c, bool& ok) {
            ok = n0 + c < Pp;
            return ok ? dvv + static_cast<size_t>(k0 + r) * Pp + n0 + c : dvb;
          });
    };
    Square::Acc acc[Square::FM][Square::FN];
    Square::run(acc, sA, sB, Kp / kBK, load);
    Square::store(acc, S);
    __syncthreads();
    for (int c = tid; c < kTile * (kTile / 4); c += kThreads) {
      const int m = c / (kTile / 4);
      const int col = (c % (kTile / 4)) * 4;
      if (m < nrows && n0 + col < Pp) {
        const float* s = S + m * Square::kLdS + col;
        float* dst = dxg + (static_cast<size_t>(b) * all_rows + r0 + m) * Pp + n0 + col;
        if (n0 + col + 4 <= Pp) {
          *reinterpret_cast<float4*>(dst) = make_float4(s[0], s[1], s[2], s[3]);
        } else {
          for (int i = 0; n0 + col + i < Pp; ++i) dst[i] = s[i];
        }
      }
    }
    __syncthreads();
  }
}

// d_xe = bf16(d_xg + [d_act | d_pre] @ wext) for the packed live rows.
// Grid (ceil(GP / 128), ceil(B F / 128)).
__global__ void __launch_bounds__(kThreads, 2)
nxv_dxe_kernel(const bf16* __restrict__ dact, const bf16* __restrict__ wext,
               const float* __restrict__ dxg, const int* __restrict__ row_off,
               bf16* __restrict__ dxe, int B, int F, int GP, int Kx) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_row[kTile];
  const int n0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;
  if (r0 >= row_off[B]) return;
  packed_rows<kTile>(row_off, B, F, r0, s_row);
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * Square::kStageA;
  auto load = [&](int slot, int step) {
    const int k0 = step * kBK;
    Square::load(
        sA, sB, slot,
        [&](int r, int c, bool& ok) {
          ok = s_row[r] >= 0 && k0 + c < Kx;
          return ok ? dact + static_cast<size_t>(s_row[r]) * Kx + k0 + c : dact;
        },
        [&](int r, int c, bool& ok) {
          ok = k0 + r < Kx && n0 + c < GP;
          return ok ? wext + static_cast<size_t>(k0 + r) * GP + n0 + c : wext;
        });
  };
  Square::Acc acc[Square::FM][Square::FN];
  Square::run(acc, sA, sB, (Kx + kBK - 1) / kBK, load);
  float* S = reinterpret_cast<float*>(smem);
  Square::store(acc, S);
  __syncthreads();
  for (int c = threadIdx.x; c < kTile * (kTile / 8); c += kThreads) {
    const int r = c / (kTile / 8);
    const int col = (c % (kTile / 8)) * 8;
    const int n = n0 + col;
    if (s_row[r] < 0 || n >= GP) continue;
    const size_t o = static_cast<size_t>(s_row[r]) * GP + n;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(dxg[o + i], S[r * Square::kLdS + col + i]);
    store8_bf16(dxe + o, v);
  }
}

// part[s] = sum over the live frames of videos [s per, (s + 1) per) of
// A^T B: A [B, F, M] and Bm [B, F, N] bf16 row-major. Grid (ceil(M / 128),
// ceil(N / 128), splits).
__global__ void __launch_bounds__(kThreads, 2)
nxv_wgrad_kernel(const bf16* __restrict__ a, const bf16* __restrict__ bm,
                 const int* __restrict__ num_frames, float* __restrict__ part, int B, int F,
                 int M, int N, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * Wgrad::kStageA;
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int s = blockIdx.z;
  const int b_begin = s * per;
  const int b_end = min(B, b_begin + per);
  int nsteps = 0;
  for (int b = b_begin; b < b_end; ++b) nsteps += (live_frames(num_frames, b, F) + kBK - 1) / kBK;
  // The (video, first frame) of the next stage to load; stages are loaded
  // in step order.
  int cb = b_begin;
  int cf = 0;
  while (cb < b_end && live_frames(num_frames, cb, F) == 0) ++cb;
  auto load = [&](int slot, int) {
    const int lb = live_frames(num_frames, cb, F);
    const bf16* av = a + static_cast<size_t>(cb) * F * M;
    const bf16* bv = bm + static_cast<size_t>(cb) * F * N;
    const int f0 = cf;
    Wgrad::load(
        sA, sB, slot,
        [&](int r, int c, bool& ok) {
          ok = f0 + r < lb && m0 + c < M;
          return ok ? av + static_cast<size_t>(f0 + r) * M + m0 + c : a;
        },
        [&](int r, int c, bool& ok) {
          ok = f0 + r < lb && n0 + c < N;
          return ok ? bv + static_cast<size_t>(f0 + r) * N + n0 + c : bm;
        });
    cf += kBK;
    if (cf >= lb) {
      cf = 0;
      ++cb;
      while (cb < b_end && live_frames(num_frames, cb, F) == 0) ++cb;
    }
  };
  Wgrad::Acc acc[Wgrad::FM][Wgrad::FN];
  Wgrad::run(acc, sA, sB, nsteps, load);
  float* S = reinterpret_cast<float*>(smem);
  Wgrad::store(acc, S);
  __syncthreads();
  float* dst = part + static_cast<size_t>(s) * M * N;
  for (int c = threadIdx.x; c < kTile * (kTile / 4); c += kThreads) {
    const int r = c / (kTile / 4);
    const int col = (c % (kTile / 4)) * 4;
    if (m0 + r < M && n0 + col < N) {
      const float* v = S + r * Wgrad::kLdS + col;
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(m0 + r) * N + n0 + col) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// out[i] = sum_s part[s][i], the splits in order (n % 4 == 0).
__global__ void __launch_bounds__(kThreads)
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

// dab[g] = sum over videos and live frames of d_pre. Grid (G): each thread
// a strided set of videos in order, then a fixed tree.
__global__ void __launch_bounds__(kThreads)
nxv_dab_kernel(const float* __restrict__ dpre, const int* __restrict__ num_frames,
               float* __restrict__ dab, int B, int F, int G) {
  __shared__ float s[kThreads];
  const int g = blockIdx.x;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const int live = live_frames(num_frames, b, F);
    for (int f = 0; f < live; ++f) acc += dpre[(static_cast<size_t>(b) * F + f) * G + g];
  }
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s[threadIdx.x] += s[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) dab[g] = s[0];
}

template <int FNW>
cudaError_t launch_rows(dim3 grid, cudaStream_t st, const bf16* xe, const bf16* assign,
                        const float* sm, const float* alpha, const int* nf, const bf16* dvb,
                        const float* cdot, bf16* dact, float* dpre, float* dxg, int F, int G,
                        int K, int Pp, int Kx) {
  constexpr int bytes = rows_smem<FNW>();
  cudaError_t err = set_smem(nxv_rows_kernel<FNW>, bytes);
  if (err != cudaSuccess) return err;
  nxv_rows_kernel<FNW><<<grid, kThreads, bytes, st>>>(xe, assign, sm, alpha, nf, dvb, cdot, dact,
                                                       dpre, dxg, F, G, K, Pp, Kx);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(cudaStream_t st, const bf16* a, const bf16* bm, const int* nf,
                         float* part, float* out, int B, int F, int M, int N, int per,
                         int splits) {
  nxv_wgrad_kernel<<<dim3((M + kTile - 1) / kTile, (N + kTile - 1) / kTile, splits), kThreads,
                     Wgrad::kBytes, st>>>(a, bm, nf, part, B, F, M, N, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(M) * N;
  const size_t want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  nxv_reduce_kernel<<<blocks, kThreads, 0, st>>>(part, out, n, splits);
  return cudaGetLastError();
}

}  // namespace

// The backward from the forward's residuals (nextvlad.cu's scratch with
// sm): row_off [B + 1] int32, xb [B, F, D8], xe [B, F, G Pp], assign [B, F, G, Kp]
// bf16; sm [B, F, G, Kp], alpha [B, F, G], vlad [B, K, P], a_sum [B, Kp]
// f32; dy [B, K, P] f32, centers [K, P] f32, wext [Kx, G Pp] bf16 (Kx =
// G Kp + round_up(G, 8)). Scratch: dv [B, K, P] f32, dvb [B, Kp, Pp] bf16,
// cdot [B, Kp] f32, dact [B, F, Kx] bf16, dpre [B, F, G] f32, dxg [B, F,
// G Pp] f32, dxe [B, F, G Pp] bf16, part_ext [splits, G Pp, Kx] and
// part_we [splits, D8, G Pp] f32 with splits = ceil(B / per). Outputs
// (f32): dwe [D8, G Pp], dwext [G Pp, Kx], dab [G], dcenters [K, P].
extern "C" int yt8m_nextvlad_train_backward(
    const void* num_frames, const void* row_off, const void* xb, const void* xe, const void* assign, const void* sm,
    const void* alpha, const void* vlad, const void* a_sum, const void* dy, const void* centers,
    const void* wext, void* dv, void* dvb, void* cdot, void* dact, void* dpre, void* dxg,
    void* dxe, void* part_ext, void* part_we, void* dwe, void* dwext, void* dab, void* dcenters,
    int B, int F, int D8, int G, int K, int P, int per, void* stream) {
  if (B <= 0 || B > 65535 || F <= 0 || D8 <= 0 || D8 % 8 != 0 || G <= 0 || G > 65535 ||
      K <= 0 || K > kMaxClusters || P <= 0 || per <= 0 ||
      (static_cast<size_t>(B) * F + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Pp = round_up(P, 8);
  const int Kp = round_up(K, 64);
  const int GP = G * Pp;
  const int Kx = G * Kp + round_up(G, 8);
  const int splits = (B + per - 1) / per;
  const int* nf = static_cast<const int*>(num_frames);
  float* dvp = static_cast<float*>(dv);
  bf16* dvbp = static_cast<bf16*>(dvb);
  float* cdotp = static_cast<float*>(cdot);
  bf16* dactp = static_cast<bf16*>(dact);
  float* dprep = static_cast<float*>(dpre);
  float* dxgp = static_cast<float*>(dxg);
  bf16* dxep = static_cast<bf16*>(dxe);

  nxv_dv_kernel<<<dim3(Kp / kWarps, B), kThreads, 0, st>>>(
      static_cast<const float*>(vlad), static_cast<const float*>(dy),
      static_cast<const float*>(centers), dvp, dvbp, cdotp, K, P, Pp, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nxv_dcenters_kernel<<<(K * P + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(a_sum), dvp, static_cast<float*>(dcenters), B, K, P, Kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 rgrid((F * G + kTile - 1) / kTile, B);
  const bf16* xep = static_cast<const bf16*>(xe);
  const bf16* asg = static_cast<const bf16*>(assign);
  const float* smp = static_cast<const float*>(sm);
  const float* alp = static_cast<const float*>(alpha);
  switch (Kp / 64) {
    case 1: err = launch_rows<1>(rgrid, st, xep, asg, smp, alp, nf, dvbp, cdotp, dactp, dprep, dxgp, F, G, K, Pp, Kx); break;
    case 2: err = launch_rows<2>(rgrid, st, xep, asg, smp, alp, nf, dvbp, cdotp, dactp, dprep, dxgp, F, G, K, Pp, Kx); break;
    case 3: err = launch_rows<3>(rgrid, st, xep, asg, smp, alp, nf, dvbp, cdotp, dactp, dprep, dxgp, F, G, K, Pp, Kx); break;
    default: err = launch_rows<4>(rgrid, st, xep, asg, smp, alp, nf, dvbp, cdotp, dactp, dprep, dxgp, F, G, K, Pp, Kx); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  err = set_smem(nxv_dxe_kernel, Square::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = static_cast<int>((static_cast<size_t>(B) * F + kTile - 1) / kTile);
  nxv_dxe_kernel<<<dim3((GP + kTile - 1) / kTile, row_tiles), kThreads, Square::kBytes, st>>>(
      dactp, static_cast<const bf16*>(wext), dxgp, static_cast<const int*>(row_off), dxep, B, F,
      GP, Kx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = set_smem(nxv_wgrad_kernel, Wgrad::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_wgrad(st, xep, dactp, nf, static_cast<float*>(part_ext),
                     static_cast<float*>(dwext), B, F, GP, Kx, per, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_wgrad(st, static_cast<const bf16*>(xb), dxep, nf, static_cast<float*>(part_we),
                     static_cast<float*>(dwe), B, F, D8, GP, per, splits);
  if (err != cudaSuccess) return static_cast<int>(err);

  nxv_dab_kernel<<<G, kThreads, 0, st>>>(dprep, nf, static_cast<float*>(dab), B, F, G);
  return static_cast<int>(cudaGetLastError());
}
