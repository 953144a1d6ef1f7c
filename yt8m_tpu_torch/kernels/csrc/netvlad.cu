// Fused NetVLAD aggregation serving kernel for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/netvlad.py :: netvlad_aggregate. For frames
// x [B, F, D] (uint8 or float32), per video:
//
//   xb     = bf16(dequant(x))                  (dequant only for uint8)
//   act    = xb @ bf16(Wc) * act_scale + act_bias      [F, K] f32 sums
//   assign = softmax_K(act - max) * (t < num_frames)   f32
//   vlad   = bf16(assign)^T @ xb - colsum(assign) (x) centers   [K, D]
//   vlad  /= max(||vlad||_D, 1e-6);  vlad /= max(||vlad||_KD, 1e-6)
//
// What bounds it: at B=512, F=300, D=1152, K=256 the two products are
// 181 GFLOP (0.18 ms at the bf16 peak) while the f32 frames in and the
// f32 [B, K, D] out are 1.3 GB (0.39 ms at 3.35 TB/s): device-memory
// bytes.
//
// Design. The TPU kernel keeps a whole video in VMEM; on Hopper one
// video's frames (690 KB in bf16), Wc (590 KB) and its [K, D] f32 sum
// (1.18 MB) each exceed a block's 227 KB of shared memory, so the work
// is cut into four launches on the caller's stream:
//  0. vlad_frames_to_bf16: xb = bf16(dequant(x)) once, into a [B, F, D]
//     buffer from the wrapper; both products read it.
//  1. vlad_assign_kernel, a block per (video, 64 frames): the [64, K]
//     assignment product on the tensor cores (wmma, 3-stage cp.async
//     ring), one 256-cluster tile after another into a [64, K] f32 tile
//     in shared memory (K <= 512), then per row the affine, the f32
//     softmax with the max subtracted and the frame mask; writes
//     bf16(assign) to a [B, F64, K] scratch (zeros past F) and the
//     chunk's f32 column sums.
//  2. vlad_aggregate_kernel, a block per (video, 128 feature columns,
//     256 clusters):
//     assign^T @ xb over all frames (the assignment tile is read as a
//     column-major A operand, so nothing is transposed in memory), minus
//     colsum (x) centers; writes the unnormalised rows and each row's
//     partial sum of squares over the block's columns.
//  3. vlad_norm_kernel, a block per (video, 32 clusters): every block of
//     a video forms the same global norm from the partial sums, in one
//     order; then both divisions in place.
// The [B, F, K] assignment round trip (84 MB at B=512) and the output's
// second pass are what this simple design pays; thread-block clusters
// with distributed shared memory can remove both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr float kDeqScale = static_cast<float>(4.0 / 255.0);
constexpr float kDeqBias = static_cast<float>(4.0 / 512.0 - 2.0);
constexpr float kNormEps = 1e-6f;

constexpr int kThreads = 256;
constexpr int kBK = 32;
constexpr int kStages = 3;

// Launch 1: 64 frames x 256 clusters a product tile, K <= 512 (two
// tiles) a block.
constexpr int kAsgRows = 64;
constexpr int kAsgCols = 256;
constexpr int kMaxClusters = 2 * kAsgCols;
constexpr int kAsgLdA = kBK + 8;
constexpr int kAsgLdB = kAsgCols + 8;
constexpr int kAsgStageA = kAsgRows * kAsgLdA;
constexpr int kAsgStageB = kBK * kAsgLdB;
constexpr int kAsgPipeBytes = kStages * (kAsgStageA + kAsgStageB) * 2;

// The [64, ktiles * 256] f32 activation tile, row stride ld_s: it shares
// the pipeline's memory when one cluster tile covers K, else follows it.
__host__ __device__ inline int asg_ld_s(int ktiles) { return ktiles * kAsgCols + 4; }
__host__ __device__ inline int asg_s_offset(int ktiles) { return ktiles == 1 ? 0 : kAsgPipeBytes; }
inline int asg_smem(int ktiles) {
  const int s_bytes = kAsgRows * asg_ld_s(ktiles) * 4;
  return ktiles == 1 ? (s_bytes > kAsgPipeBytes ? s_bytes : kAsgPipeBytes)
                     : kAsgPipeBytes + s_bytes;
}

// Launch 2: 256 clusters (masked) x 128 feature columns a block.
constexpr int kAggRows = 256;
constexpr int kAggCols = 128;
constexpr int kAggLdA = kAggRows + 8;  // assign tile As[f][k]
constexpr int kAggLdB = kAggCols + 8;  // frame tile Xs[f][d]
constexpr int kAggStageA = kBK * kAggLdA;
constexpr int kAggStageB = kBK * kAggLdB;
constexpr int kAggLdS = kAggCols + 4;
constexpr int kAggPipeBytes = kStages * (kAggStageA + kAggStageB) * 2;
constexpr int kAggEpiBytes = kAggRows * kAggLdS * 4;
constexpr int kAggSmem = kAggPipeBytes > kAggEpiBytes ? kAggPipeBytes : kAggEpiBytes;

// Launch 3: 32 clusters of one video a block.
constexpr int kNormRows = 32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Unfused multiply and add: the plain version's two roundings.
__device__ __forceinline__ float affine(float x, float s, float b) {
  return __fadd_rn(__fmul_rn(x, s), b);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Launch 0: xb = bf16(dequant(x)), eight inputs a thread (D % 8 == 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
vlad_frames_to_bf16(const T* __restrict__ x, __nv_bfloat16* __restrict__ xb, size_t n8) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v[8];
    load8(x + i * 8, v);
    if (std::is_same<T, uint8_t>::value) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = affine(v[j], kDeqScale, kDeqBias);
    }
    uint4 out;
    out.x = pack_bf16(v[0], v[1]);
    out.y = pack_bf16(v[2], v[3]);
    out.z = pack_bf16(v[4], v[5]);
    out.w = pack_bf16(v[6], v[7]);
    reinterpret_cast<uint4*>(xb)[i] = out;
  }
}

// Launch 1. Grid (chunks, B). Warps 2 (rows) x 4 (columns), a 32 x 64
// warp tile each.
__global__ void __launch_bounds__(kThreads)
vlad_assign_kernel(const __nv_bfloat16* __restrict__ xb, const int* __restrict__ num_frames,
                   const __nv_bfloat16* __restrict__ wc, const float* __restrict__ act_scale,
                   const float* __restrict__ act_bias, __nv_bfloat16* __restrict__ assign,
                   float* __restrict__ colsum, int F, int D, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kStages * kAsgStageA;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int chunk = blockIdx.x;
  const int chunks = gridDim.x;
  const int b = blockIdx.y;
  const int f0 = chunk * kAsgRows;
  const __nv_bfloat16* xv = xb + static_cast<size_t>(b) * F * D;

  // A: 64 rows x 32 bf16 = 4 x 16 B a row, one copy a thread.
  const int a_row = tid >> 2;
  const int a_col = (tid & 3) * 8;
  const bool a_ok = f0 + a_row < F;
  const __nv_bfloat16* a_src = xv + static_cast<size_t>(a_ok ? f0 + a_row : 0) * D + a_col;
  const int a_dst = a_row * kAsgLdA + a_col;
  const int a_bytes = a_ok ? 16 : 0;
  // B: 32 rows x 256 clusters = 32 x 16 B a row, four copies a thread.
  const int ktiles = (K + kAsgCols - 1) / kAsgCols;
  const int ld_s = asg_ld_s(ktiles);
  float* S = reinterpret_cast<float*>(smem + asg_s_offset(ktiles));
  for (int kc = 0; kc < ktiles; ++kc) {
    const __nv_bfloat16* b_src[4];
    int b_dst[4], b_bytes[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int seg = tid + j * kThreads;
      const int row = seg >> 5;
      const int col = kc * kAsgCols + (seg & 31) * 8;
      const bool ok = col < K;
      b_src[j] = wc + static_cast<size_t>(row) * K + (ok ? col : 0);
      b_dst[j] = row * kAsgLdB + (seg & 31) * 8;
      b_bytes[j] = ok ? 16 : 0;
    }
    auto load_stage = [&](int slot, int kt) {
      const int d0 = kt * kBK;
      cp_async16(sA + slot * kAsgStageA + a_dst, a_src + d0, a_bytes);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async16(sB + slot * kAsgStageB + b_dst[j], b_src[j] + static_cast<size_t>(d0) * K,
                   b_bytes[j]);
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    const int nk = D / kBK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_stage(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int next = kt + kStages - 1;
      if (next < nk) load_stage(next % kStages, next);
      cp_async_commit();
      const int slot = kt % kStages;
      const __nv_bfloat16* tA = sA + slot * kAsgStageA;
      const __nv_bfloat16* tB = sB + slot * kAsgStageB;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], tA + (wm * 32 + i * 16) * kAsgLdA + kk, kAsgLdA);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], tB + kk * kAsgLdB + wn * 64 + j * 16, kAsgLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(S + (wm * 32 + i * 16) * ld_s + kc * kAsgCols + wn * 64 + j * 16,
                                acc[i][j], ld_s, wmma::mem_row_major);
    __syncthreads();
  }

  // Softmax: each warp takes 8 rows; lane l holds clusters l + 32c. The
  // affine, then exp(a - max), then the probability go back into S.
  const int live_rows = min(num_frames[b], F);
  const size_t arow0 = static_cast<size_t>(b) * chunks * kAsgRows;
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const int t = f0 + r;
    float* row = S + r * ld_s;
    float m = -INFINITY;
    for (int col = lane; col < K; col += 32) {
      const float a = affine(row[col], act_scale[col], act_bias[col]);
      row[col] = a;
      m = fmaxf(m, a);
    }
    m = warp_max(m);
    float s = 0.0f;
    for (int col = lane; col < K; col += 32) {
      const float e = expf(__fsub_rn(row[col], m));
      row[col] = e;
      s += e;
    }
    s = warp_sum(s);
    const bool live = t < live_rows;
    __nv_bfloat16* dst = assign + (arow0 + t) * K;
    for (int col = lane; col < K; col += 32) {
      const float p = live ? row[col] / s : 0.0f;
      row[col] = p;
      dst[col] = __float2bfloat16_rn(p);
    }
  }
  __syncthreads();
  // Column sums over the 64 rows: each warp's 8 rows, then the 8 warps.
  for (int col = tid; col < K; col += kThreads) {
    float total = 0.0f;
    for (int w = 0; w < 8; ++w) {
      float part = 0.0f;
      for (int r = w * 8; r < w * 8 + 8; ++r) part += S[r * ld_s + col];
      total += part;
    }
    colsum[(static_cast<size_t>(b) * chunks + chunk) * K + col] = total;
  }
}

// Launch 2. Grid (D / 128, B, ceil(K / 256)). Warps 4 (clusters) x 2
// (columns), a 64 x 64 warp tile each.
__global__ void __launch_bounds__(kThreads, 1)
vlad_aggregate_kernel(const __nv_bfloat16* __restrict__ xb,
                      const __nv_bfloat16* __restrict__ assign,
                      const float* __restrict__ colsum, const float* __restrict__ centers,
                      float* __restrict__ out, float* __restrict__ sumsq, int F, int D, int K,
                      int chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kStages * kAggStageA;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int tile = blockIdx.x;
  const int d0 = tile * kAggCols;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kAggRows;
  const int fa_rows = chunks * kAsgRows;  // rows of the assign scratch
  const __nv_bfloat16* av = assign + static_cast<size_t>(b) * fa_rows * K;
  const __nv_bfloat16* xv = xb + static_cast<size_t>(b) * F * D + d0;

  auto load_stage = [&](int slot, int kt) {
    const int f0 = kt * kBK;
    // A: 32 frames x 256 clusters, four 16-byte copies a thread.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int seg = tid + j * kThreads;
      const int row = seg >> 5;
      const int col = (seg & 31) * 8;
      const bool ok = k0 + col < K;
      cp_async16(sA + slot * kAggStageA + row * kAggLdA + col,
                 av + static_cast<size_t>(f0 + row) * K + (ok ? k0 + col : 0), ok ? 16 : 0);
    }
    // B: 32 frames x 128 columns, two copies a thread; frames >= F are 0.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int seg = tid + j * kThreads;
      const int row = seg >> 4;
      const int col = (seg & 15) * 8;
      const bool ok = f0 + row < F;
      cp_async16(sB + slot * kAggStageB + row * kAggLdB + col,
                 xv + static_cast<size_t>(ok ? f0 + row : 0) * D + col, ok ? 16 : 0);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (F + kBK - 1) / kBK;  // assign rows up to F64 exist and are 0 past F
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) load_stage(next % kStages, next);
    cp_async_commit();
    const int slot = kt % kStages;
    const __nv_bfloat16* tA = sA + slot * kAggStageA;
    const __nv_bfloat16* tB = sB + slot * kAggStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A[k, f] = As[f][k]: the assignment tile read column-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], tA + kk * kAggLdA + wm * 64 + i * 16, kAggLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], tB + kk * kAggLdB + wn * 64 + j * 16, kAggLdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* S = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(S + (wm * 64 + i * 16) * kAggLdS + wn * 64 + j * 16, acc[i][j],
                              kAggLdS, wmma::mem_row_major);
  __syncthreads();

  // Each warp takes 32 clusters; lanes run along the 128 columns.
  const int tiles = gridDim.x;
  for (int r = warp * 32; r < warp * 32 + 32 && k0 + r < K; ++r) {
    const int k = k0 + r;
    float a_sum = 0.0f;
    for (int c = 0; c < chunks; ++c) a_sum += colsum[(static_cast<size_t>(b) * chunks + c) * K + k];
    const float* cen = centers + static_cast<size_t>(k) * D + d0;
    float* dst = out + (static_cast<size_t>(b) * K + k) * D + d0;
    float ss = 0.0f;
#pragma unroll
    for (int c = lane; c < kAggCols; c += 32) {
      const float v = __fsub_rn(S[r * kAggLdS + c], __fmul_rn(a_sum, cen[c]));
      dst[c] = v;
      ss += v * v;
    }
    ss = warp_sum(ss);
    if (lane == 0) sumsq[(static_cast<size_t>(b) * tiles + tile) * K + k] = ss;
  }
}

// Launch 3. Grid (ceil(K / 32), B): intra-norm, then the global norm,
// in place.
__global__ void __launch_bounds__(kThreads)
vlad_norm_kernel(float* __restrict__ out, const float* __restrict__ sumsq, int D, int K,
                 int tiles) {
  __shared__ float s_gnorm;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const float* sq = sumsq + static_cast<size_t>(b) * tiles * K;
  auto row_norm = [&](int k) {
    float ss = 0.0f;
    for (int t = 0; t < tiles; ++t) ss += sq[static_cast<size_t>(t) * K + k];
    return ss;
  };
  if (warp == 0) {
    // ||v / n_k||^2 summed over the rows = sum_k ss_k / n_k^2.
    float g = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float ss = row_norm(k);
      const float n = fmaxf(sqrtf(ss), kNormEps);
      g += ss / (n * n);
    }
    g = warp_sum(g);
    if (lane == 0) s_gnorm = fmaxf(sqrtf(g), kNormEps);
  }
  __syncthreads();
  const float gnorm = s_gnorm;
  const int k0 = blockIdx.x * kNormRows + warp * (kNormRows / 8);
  for (int k = k0; k < k0 + kNormRows / 8 && k < K; ++k) {
    const float n = fmaxf(sqrtf(row_norm(k)), kNormEps);
    float4* row = reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * K + k) * D);
    for (int i = lane; i < D / 4; i += 32) {
      float4 v = row[i];
      v.x = (v.x / n) / gnorm;
      v.y = (v.y / n) / gnorm;
      v.z = (v.z / n) / gnorm;
      v.w = (v.w / n) / gnorm;
      row[i] = v;
    }
  }
}

template <typename T>
int launch(const void* x, const void* num_frames, const void* wc, const void* act_scale,
           const void* act_bias, const void* centers, void* xb, void* assign, void* colsum,
           void* sumsq, void* out, int B, int F, int D, int K, void* stream) {
  if (B <= 0 || B > 65535 || F <= 0 || D <= 0 || D % kAggCols != 0 || K < 8 || K % 8 != 0 ||
      K > kMaxClusters)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (F + kAsgRows - 1) / kAsgRows;
  const int tiles = D / kAggCols;
  const size_t n8 = static_cast<size_t>(B) * F * D / 8;
  const size_t want = (n8 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  __nv_bfloat16* xbp = static_cast<__nv_bfloat16*>(xb);
  vlad_frames_to_bf16<T><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x), xbp, n8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int ktiles = (K + kAsgCols - 1) / kAsgCols;
  const int asg_bytes = asg_smem(ktiles);
  err = cudaFuncSetAttribute(vlad_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             asg_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  vlad_assign_kernel<<<dim3(chunks, B), kThreads, asg_bytes, st>>>(
      xbp, static_cast<const int*>(num_frames), static_cast<const __nv_bfloat16*>(wc),
      static_cast<const float*>(act_scale), static_cast<const float*>(act_bias),
      static_cast<__nv_bfloat16*>(assign), static_cast<float*>(colsum), F, D, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(vlad_aggregate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kAggSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vlad_aggregate_kernel<<<dim3(tiles, B, ktiles), kThreads, kAggSmem, st>>>(
      xbp, static_cast<const __nv_bfloat16*>(assign), static_cast<const float*>(colsum),
      static_cast<const float*>(centers), static_cast<float*>(out), static_cast<float*>(sumsq),
      F, D, K, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  vlad_norm_kernel<<<dim3((K + kNormRows - 1) / kNormRows, B), kThreads, 0, st>>>(
      static_cast<float*>(out), static_cast<const float*>(sumsq), D, K, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch from the caller: xb [B, F, D] bf16, assign [B, ceil(F/64)*64, K]
// bf16, colsum [B, ceil(F/64), K] f32, sumsq [B, D/128, K] f32.
extern "C" int yt8m_netvlad_aggregate_u8(const void* x, const void* num_frames, const void* wc,
                                         const void* act_scale, const void* act_bias,
                                         const void* centers, void* xb, void* assign,
                                         void* colsum, void* sumsq, void* out, int B, int F,
                                         int D, int K, void* stream) {
  return launch<uint8_t>(x, num_frames, wc, act_scale, act_bias, centers, xb, assign, colsum,
                         sumsq, out, B, F, D, K, stream);
}

extern "C" int yt8m_netvlad_aggregate_f32(const void* x, const void* num_frames, const void* wc,
                                          const void* act_scale, const void* act_bias,
                                          const void* centers, void* xb, void* assign,
                                          void* colsum, void* sumsq, void* out, int B, int F,
                                          int D, int K, void* stream) {
  return launch<float>(x, num_frames, wc, act_scale, act_bias, centers, xb, assign, colsum,
                       sumsq, out, B, F, D, K, stream);
}
