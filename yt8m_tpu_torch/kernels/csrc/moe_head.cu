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
//
// M in {1, 2, 4} is a template argument; any other M in 1..16 is taken
// at run time by one more instantiation (M = 0), whose tile and loop
// bounds come from M at run time and whose registers are sized for the
// largest tile. The block's combined tile has NC * (2M + 1) columns; NC
// is 32 classes for M <= 4 and halves as M grows (16 for M <= 8, 8 for
// M <= 16), so the tile stays within 288 columns, and the columns are
// padded up to a multiple of 32 (two warps of 16-column fragments).
// Padded columns are computed from whatever the shared memory holds and
// never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBM = 128;      // videos per block
constexpr int kBK = 32;       // reduction chunk
constexpr int kMaxMixtures = 16;
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

// The block's tile for M mixtures.
struct Shape {
  int m, nc, gate_cols, expert_cols, cols, pad_cols, warp_frags, ldb, lds;
  __host__ __device__ constexpr explicit Shape(int m_)
      : m(m_),
        nc(m_ <= 4 ? 32 : (m_ <= 8 ? 16 : 8)),  // classes per block
        gate_cols(nc * (m_ + 1)),
        expert_cols(nc * m_),
        cols(gate_cols + expert_cols),  // gate then expert columns
        pad_cols((cols + 31) / 32 * 32),
        warp_frags(pad_cols / 16 / 2),  // 16-col fragments per warp
        ldb(pad_cols + 8),
        lds(pad_cols + 4) {}
  __host__ __device__ constexpr int stage_b() const { return kBK * ldb; }
  __host__ __device__ constexpr size_t smem_bytes() const {
    const size_t main = static_cast<size_t>(2) * (kBM * kLdA + stage_b()) * 2;
    const size_t epilogue = static_cast<size_t>(kBM) * lds * 4;
    return main > epilogue ? main : epilogue;
  }
};

constexpr int kMaxCols = 288;  // Shape(m).pad_cols for every m in 1..16
constexpr int kStageA = kBM * kLdA;

// Per-thread register sizes: those of M's tile, or the largest (M = 0).
template <int M, int W>
struct Regs {
  static constexpr int kCols = M > 0 ? Shape(M).pad_cols : kMaxCols;
  static constexpr int kFrags = kCols / 16 / 2;
  static constexpr int kPerThreadB = (kBK * kCols / W + kThreads - 1) / kThreads;
  static_assert(M <= kMaxMixtures, "M above the supported range");
};

// Row and column (within the block's combined tile) of weight vector v.
template <int W>
__device__ __forceinline__ void vec_coords(const Shape& S, int v, int& row, int& col,
                                           bool& gate) {
  const int gate_vecs = kBK * S.gate_cols / W;
  gate = v < gate_vecs;
  if (gate) {
    row = v / (S.gate_cols / W);
    col = (v % (S.gate_cols / W)) * W;
  } else {
    const int e = v - gate_vecs;
    row = e / (S.expert_cols / W);
    col = S.gate_cols + (e % (S.expert_cols / W)) * W;
  }
}

template <int M, int W>
__global__ void __launch_bounds__(kThreads)
moe_head_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
                const __nv_bfloat16* __restrict__ we, const float* __restrict__ be,
                float* __restrict__ out, int B, int H, int C, int runtime_m) {
  using R = Regs<M, W>;
  using VT = typename Vec<W>::T;
  constexpr Shape kS(M > 0 ? M : 1);
  const Shape S = M > 0 ? kS : Shape(runtime_m);  // a constant when M > 0
  const int m_ = S.m;
  const int vecs_b = kBK * S.cols / W;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + 2 * kStageA;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // rows wm*32 .. +32
  const int wn = warp & 1;   // fragments wn*warp_frags .. +warp_frags
  const int nc = S.nc;
  const int c0 = blockIdx.x * nc;
  const int b0 = blockIdx.y * kBM;
  const size_t gate_stride = static_cast<size_t>(C) * (m_ + 1);
  const size_t expert_stride = static_cast<size_t>(C) * m_;

  // A tile: 128 rows x 32 of x (f32 -> bf16); 16 per thread.
  const int a_row = tid >> 1;
  const int a_q = tid & 1;
  const bool a_ok = b0 + a_row < B;
  const float* a_src = x + static_cast<size_t>(a_ok ? b0 + a_row : 0) * H + a_q * 16;

  float4 ra[4];
  VT rb[R::kPerThreadB];
  auto global_load = [&](int k0) {
    if (a_ok) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ra[j] = __ldg(reinterpret_cast<const float4*>(a_src + k0) + j);
    }
#pragma unroll
    for (int i = 0; i < R::kPerThreadB; ++i) {
      if (tid + i * kThreads >= vecs_b) break;
      int row, col;
      bool gate;
      vec_coords<W>(S, tid + i * kThreads, row, col, gate);
      const __nv_bfloat16* src;
      bool ok;
      if (gate) {
        const int gc = c0 * (m_ + 1) + col;
        ok = gc < C * (m_ + 1);
        src = wg + (k0 + row) * gate_stride + gc;
      } else {
        const int ec = c0 * m_ + (col - S.gate_cols);
        ok = ec < C * m_;
        src = we + (k0 + row) * expert_stride + ec;
      }
      rb[i] = ok ? __ldg(reinterpret_cast<const VT*>(src)) : VT{};
    }
  };
  auto shared_store = [&](int buf) {
    uint4* dst = reinterpret_cast<uint4*>(sA + buf * kStageA + a_row * kLdA + a_q * 16);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      dst[j] = a_ok ? make_uint4(pack_bf16(ra[2 * j].x, ra[2 * j].y),
                                 pack_bf16(ra[2 * j].z, ra[2 * j].w),
                                 pack_bf16(ra[2 * j + 1].x, ra[2 * j + 1].y),
                                 pack_bf16(ra[2 * j + 1].z, ra[2 * j + 1].w))
                    : make_uint4(0, 0, 0, 0);
    }
    __nv_bfloat16* tb = sB + buf * S.stage_b();
#pragma unroll
    for (int i = 0; i < R::kPerThreadB; ++i) {
      if (tid + i * kThreads >= vecs_b) break;
      int row, col;
      bool gate;
      vec_coords<W>(S, tid + i * kThreads, row, col, gate);
      *reinterpret_cast<VT*>(tb + row * S.ldb + col) = rb[i];
    }
  };

  const int frags = S.warp_frags;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][R::kFrags];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < R::kFrags; ++f) wmma::fill_fragment(acc[i][f], 0.0f);

  const int nk = H / kBK;
  global_load(0);
  shared_store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) global_load((kt + 1) * kBK);
    const __nv_bfloat16* tA = sA + cur * kStageA;
    const __nv_bfloat16* tB = sB + cur * S.stage_b();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], tA + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int f = 0; f < R::kFrags; ++f) {
        if (f >= frags) break;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, tB + kk * S.ldb + (wn * frags + f) * 16, S.ldb);
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
    for (int f = 0; f < R::kFrags; ++f) {
      if (f >= frags) break;
      wmma::store_matrix_sync(stage + (wm * 32 + i * 16) * S.lds + (wn * frags + f) * 16,
                              acc[i][f], S.lds, wmma::mem_row_major);
    }
  __syncthreads();
  for (int p = tid; p < kBM * nc; p += kThreads) {
    const int r = p / nc;
    const int c = p % nc;
    const int b = b0 + r;
    const int cls = c0 + c;
    if (b >= B || cls >= C) continue;
    const float* g = stage + r * S.lds + c * (m_ + 1);
    const float* e = stage + r * S.lds + S.gate_cols + c * m_;
    float den = 0.0f;
    float num = 0.0f;
#pragma unroll
    for (int m = 0; m <= (M > 0 ? M : kMaxMixtures); ++m) {
      if (m > m_) break;
      const float eg = expf(fminf(fmaxf(g[m], -80.0f), 80.0f));
      den += eg;
      if (m < m_) {
        const float logit = e[m] + be[static_cast<size_t>(cls) * m_ + m];
        num += eg * (1.0f / (1.0f + expf(-logit)));
      }
    }
    out[static_cast<size_t>(b) * C + cls] = num / den;
  }
}

// M > 0: the instantiation for that M; M = 0: the one taking m at run time.
template <int M, int W>
int launch(const void* x, const void* wg, const void* we, const void* be, void* out, int B,
           int H, int C, int m, void* stream) {
  const Shape S(m);
  const size_t smem = S.smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(moe_head_kernel<M, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + S.nc - 1) / S.nc, (B + kBM - 1) / kBM);
  moe_head_kernel<M, W><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(we), static_cast<const float*>(be),
      static_cast<float*>(out), B, H, C, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int yt8m_moe_head_serving(const void* x, const void* wg, const void* we,
                                     const void* be, void* out, int B, int H, int C, int M,
                                     void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || H % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = (C * (M + 1)) % 4 == 0 && (C * M) % 4 == 0;
  if (M < 1 || M > kMaxMixtures) return static_cast<int>(cudaErrorInvalidValue);
  switch (M) {
#define YT8M_MOE_CASE(m)                                                    \
  case m:                                                                   \
    return vec4 ? launch<m, 4>(x, wg, we, be, out, B, H, C, M, stream)      \
                : launch<m, 1>(x, wg, we, be, out, B, H, C, M, stream);
    YT8M_MOE_CASE(1) YT8M_MOE_CASE(2) YT8M_MOE_CASE(4)
#undef YT8M_MOE_CASE
    default:  // any other M, taken at run time
      return vec4 ? launch<0, 4>(x, wg, we, be, out, B, H, C, M, stream)
                  : launch<0, 1>(x, wg, we, be, out, B, H, C, M, stream);
  }
}
