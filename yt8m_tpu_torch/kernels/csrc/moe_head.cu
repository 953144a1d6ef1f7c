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
// What bounds it: at B=2048, H=1024, C=4716, M=2 the two products are
// ~99 GFLOP against ~58 MB of bf16 weights and activations, above the
// ridge point, so the bf16 tensor-core rate. The design computes one
// (128 videos x 32 classes) tile per block: the block's gate columns
// (32*(M+1)) and expert columns (32*M) are one combined WMMA product,
// and the per-class combine runs from a shared-memory copy of the
// accumulators, so neither the [B, C, M+1] softmax nor the [B, C, M]
// sigmoid reaches device memory. The TPU kernel's 0/1 selection matmul,
// a workaround for strided VMEM access, is not needed here. C=4716 is
// not a multiple of 32: the last tile masks its columns; the weights are
// never padded. Weight tiles move 4 bf16 (8 bytes) per load where the
// row strides allow it (C*(M+1) and C*M multiples of 4), else one by
// one. Simple first kernel: wmma fragments, register double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBM = 128;      // videos per block
constexpr int kNC = 32;       // classes per block
constexpr int kBK = 32;       // reduction chunk
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Weight elements moved per load: 4 (8 bytes) when every weight row
// starts 8-byte aligned (C*(M+1) and C*M multiples of 4, as for C=4716),
// else 1.
template <int W>
struct Vec;
template <>
struct Vec<4> {
  using T = uint2;
};
template <>
struct Vec<1> {
  using T = unsigned short;
};

template <int M, int W>
struct Tile {
  static constexpr int kGateCols = kNC * (M + 1);
  static constexpr int kExpertCols = kNC * M;
  static constexpr int kCols = kGateCols + kExpertCols;  // gate then expert columns
  static constexpr int kWarpFrags = kCols / 16 / 2;       // 16-col fragments per warp
  static constexpr int kLdB = kCols + 8;
  static constexpr int kLdS = kCols + 4;
  static constexpr int kStageA = kBM * kLdA;
  static constexpr int kStageB = kBK * kLdB;
  static constexpr int kGateVecs = kBK * kGateCols / W;   // per chunk
  static constexpr int kPerThreadB = kBK * kCols / W / kThreads;
  static constexpr size_t kMainBytes = 2 * (kStageA + kStageB) * 2;
  static constexpr size_t kEpilogueBytes = static_cast<size_t>(kBM) * kLdS * 4;
  static constexpr size_t kSmemBytes = kMainBytes > kEpilogueBytes ? kMainBytes : kEpilogueBytes;
  static_assert(kBK * kCols % (W * kThreads) == 0, "B tile must split evenly");
};

// Row and column (within the block's combined tile) of weight vector v.
template <int M, int W>
__device__ __forceinline__ void vec_coords(int v, int& row, int& col, bool& gate) {
  using T = Tile<M, W>;
  gate = v < T::kGateVecs;
  if (gate) {
    row = v / (T::kGateCols / W);
    col = (v % (T::kGateCols / W)) * W;
  } else {
    const int e = v - T::kGateVecs;
    row = e / (T::kExpertCols / W);
    col = T::kGateCols + (e % (T::kExpertCols / W)) * W;
  }
}

template <int M, int W>
__global__ void __launch_bounds__(kThreads)
moe_head_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
                const __nv_bfloat16* __restrict__ we, const float* __restrict__ be,
                float* __restrict__ out, int B, int H, int C) {
  using T = Tile<M, W>;
  using VT = typename Vec<W>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + 2 * T::kStageA;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // rows wm*32 .. +32
  const int wn = warp & 1;   // fragments wn*kWarpFrags .. +kWarpFrags
  const int c0 = blockIdx.x * kNC;
  const int b0 = blockIdx.y * kBM;
  const size_t gate_stride = static_cast<size_t>(C) * (M + 1);
  const size_t expert_stride = static_cast<size_t>(C) * M;

  // A tile: 128 rows x 32 of x (f32 -> bf16); 16 per thread.
  const int a_row = tid >> 1;
  const int a_q = tid & 1;
  const bool a_ok = b0 + a_row < B;
  const float* a_src = x + static_cast<size_t>(a_ok ? b0 + a_row : 0) * H + a_q * 16;

  float4 ra[4];
  VT rb[T::kPerThreadB];
  auto global_load = [&](int k0) {
    if (a_ok) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ra[j] = __ldg(reinterpret_cast<const float4*>(a_src + k0) + j);
    }
#pragma unroll
    for (int i = 0; i < T::kPerThreadB; ++i) {
      int row, col;
      bool gate;
      vec_coords<M, W>(tid + i * kThreads, row, col, gate);
      const __nv_bfloat16* src;
      bool ok;
      if (gate) {
        const int gc = c0 * (M + 1) + col;
        ok = gc < C * (M + 1);
        src = wg + (k0 + row) * gate_stride + gc;
      } else {
        const int ec = c0 * M + (col - T::kGateCols);
        ok = ec < C * M;
        src = we + (k0 + row) * expert_stride + ec;
      }
      rb[i] = ok ? __ldg(reinterpret_cast<const VT*>(src)) : VT{};
    }
  };
  auto shared_store = [&](int buf) {
    uint4* dst = reinterpret_cast<uint4*>(sA + buf * T::kStageA + a_row * kLdA + a_q * 16);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      dst[j] = a_ok ? make_uint4(pack_bf16(ra[2 * j].x, ra[2 * j].y),
                                 pack_bf16(ra[2 * j].z, ra[2 * j].w),
                                 pack_bf16(ra[2 * j + 1].x, ra[2 * j + 1].y),
                                 pack_bf16(ra[2 * j + 1].z, ra[2 * j + 1].w))
                    : make_uint4(0, 0, 0, 0);
    }
    __nv_bfloat16* tb = sB + buf * T::kStageB;
#pragma unroll
    for (int i = 0; i < T::kPerThreadB; ++i) {
      int row, col;
      bool gate;
      vec_coords<M, W>(tid + i * kThreads, row, col, gate);
      *reinterpret_cast<VT*>(tb + row * T::kLdB + col) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][T::kWarpFrags];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < T::kWarpFrags; ++f) wmma::fill_fragment(acc[i][f], 0.0f);

  const int nk = H / kBK;
  global_load(0);
  shared_store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) global_load((kt + 1) * kBK);
    const __nv_bfloat16* tA = sA + cur * T::kStageA;
    const __nv_bfloat16* tB = sB + cur * T::kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], tA + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int f = 0; f < T::kWarpFrags; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, tB + kk * T::kLdB + (wn * T::kWarpFrags + f) * 16, T::kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][f], fa[i], fb, acc[i][f]);
      }
    }
    if (kt + 1 < nk) shared_store(cur ^ 1);
    __syncthreads();
  }

  // Epilogue: accumulators to shared memory, then one thread per
  // (video, class) combines its M+1 gates and M experts.
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < T::kWarpFrags; ++f)
      wmma::store_matrix_sync(stage + (wm * 32 + i * 16) * T::kLdS + (wn * T::kWarpFrags + f) * 16,
                              acc[i][f], T::kLdS, wmma::mem_row_major);
  __syncthreads();
  for (int p = tid; p < kBM * kNC; p += kThreads) {
    const int r = p / kNC;
    const int c = p % kNC;
    const int b = b0 + r;
    const int cls = c0 + c;
    if (b >= B || cls >= C) continue;
    const float* g = stage + r * T::kLdS + c * (M + 1);
    const float* e = stage + r * T::kLdS + T::kGateCols + c * M;
    float den = 0.0f;
    float num = 0.0f;
#pragma unroll
    for (int m = 0; m <= M; ++m) {
      const float eg = expf(fminf(fmaxf(g[m], -80.0f), 80.0f));
      den += eg;
      if (m < M) {
        const float logit = e[m] + be[static_cast<size_t>(cls) * M + m];
        num += eg * (1.0f / (1.0f + expf(-logit)));
      }
    }
    out[static_cast<size_t>(b) * C + cls] = num / den;
  }
}

template <int M, int W>
int launch(const void* x, const void* wg, const void* we, const void* be, void* out, int B,
           int H, int C, void* stream) {
  using T = Tile<M, W>;
  cudaError_t err = cudaFuncSetAttribute(moe_head_kernel<M, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kNC - 1) / kNC, (B + kBM - 1) / kBM);
  moe_head_kernel<M, W><<<grid, kThreads, T::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(we), static_cast<const float*>(be),
      static_cast<float*>(out), B, H, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int yt8m_moe_head_serving(const void* x, const void* wg, const void* we,
                                     const void* be, void* out, int B, int H, int C, int M,
                                     void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || H % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = (C * (M + 1)) % 4 == 0 && (C * M) % 4 == 0;
  switch (M) {
    case 1: return vec4 ? launch<1, 4>(x, wg, we, be, out, B, H, C, stream)
                        : launch<1, 1>(x, wg, we, be, out, B, H, C, stream);
    case 2: return vec4 ? launch<2, 4>(x, wg, we, be, out, B, H, C, stream)
                        : launch<2, 1>(x, wg, we, be, out, B, H, C, stream);
    case 4: return vec4 ? launch<4, 4>(x, wg, we, be, out, B, H, C, stream)
                        : launch<4, 1>(x, wg, we, be, out, B, H, C, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
