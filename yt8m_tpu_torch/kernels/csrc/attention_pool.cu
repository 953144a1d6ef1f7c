// Masked attention pooling for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/attention_pool.py :: attention_pool. Per
// video b, with n = num_frames[b] and x the frames (uint8 dequantized as
// u * 4/255 + (4/512 - 2), or float32):
//
//   scores = bf16(x) @ bf16(Q)                    [F, H]  (f32 sums)
//   scores = -1e9 where t >= n
//   attn   = softmax over t of scores             (f32)
//   pooled = bf16(attn)^T @ bf16(x)               [H, D]  (f32 sums)
//
// A frame past n gets exp(-1e9 - max) = 0 exactly, so for n >= 1 only
// the first min(n, F) frames are read. For n = 0 every score is -1e9 and
// the softmax is uniform: attn = 1/F over all F frames, the mean that
// the JAX package's reference and the model's graph take (its TPU
// kernel pads F to a multiple of 8 and averages the padded rows too).
//
// What bounds it: the two products are tiny (H = 8 heads: 2 F D H
// operations each a video) and the frames are read from device memory
// once (~0.18 GB of uint8 at B=512, F=300, D=1152, 0.053 ms at 3.35
// TB/s): the bytes. The products' operands are bf16 values and their
// products exact in f32, so plain FMAs in f32 give the tensor cores'
// values; the work is 2 x 2.8 MFLOP a video against 0.35 MB.
//
// Design. One video's frames (345,600 bytes of uint8 at F=300, D=1152)
// do not fit a block's 227 KB of shared memory, and the softmax over F
// needs every frame's score before any frame can be pooled. So a block
// owns one video and reads its live frames twice: pass 1 (a warp a
// frame) forms the scores [F, H] in shared memory, the softmax runs
// there (a warp a head), and pass 2 (a thread per four columns of D, all
// H heads) streams the frames again, mostly from the 50 MB L2, and sums
// attn x into registers. Q lives in shared memory transposed, [H][D], so
// that a warp's reads of it are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 384;
// The dequantize affine in f32, as PyTorch takes the Python constants.
constexpr float kScale = static_cast<float>(4.0 / 255.0);
constexpr float kBias = static_cast<float>(4.0 / 512.0 - 2.0);

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Four consecutive frame values from column 4 * d4, as bf16 values in f32.
__device__ __forceinline__ void load4(const uint8_t* row, int d4, float v[4]) {
  const uchar4 q = reinterpret_cast<const uchar4*>(row)[d4];
  const uint8_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    v[c] = bf16_round(__fadd_rn(__fmul_rn(static_cast<float>(u[c]), kScale), kBias));
}
__device__ __forceinline__ void load4(const float* row, int d4, float v[4]) {
  const float4 q = reinterpret_cast<const float4*>(row)[d4];
  v[0] = bf16_round(q.x);
  v[1] = bf16_round(q.y);
  v[2] = bf16_round(q.z);
  v[3] = bf16_round(q.w);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Grid (B). Shared memory: Q [kH][D] f32 and the scores / attention
// [F][kH] f32. D a multiple of 4; out [B, kH, D].
template <typename T, int kH>
__global__ void __launch_bounds__(kMaxThreads)
attention_pool_kernel(const T* __restrict__ frames, const int* __restrict__ num_frames,
                      const __nv_bfloat16* __restrict__ query, float* __restrict__ out, int F,
                      int D) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;           // [kH][D]
  float* sP = smem + kH * D;  // [F][kH]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int D4 = D >> 2;
  const int n = num_frames[b];
  const int rows = n <= 0 ? F : min(n, F);
  const T* x = frames + static_cast<size_t>(b) * F * D;

  for (int i = tid; i < kH * D; i += blockDim.x) {
    const int h = i / D;
    const int d = i - h * D;
    sQ[i] = __bfloat162float(query[static_cast<size_t>(d) * kH + h]);
  }
  __syncthreads();

  // Pass 1: the live frames' scores, a warp a frame.
  if (n > 0) {
    for (int t = warp; t < rows; t += nwarps) {
      float acc[kH];
#pragma unroll
      for (int h = 0; h < kH; ++h) acc[h] = 0.0f;
      const T* row = x + static_cast<size_t>(t) * D;
      for (int d4 = lane; d4 < D4; d4 += 32) {
        float v[4];
        load4(row, d4, v);
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          const float4 q = reinterpret_cast<const float4*>(sQ + h * D)[d4];
          acc[h] = fmaf(v[0], q.x, acc[h]);  // bf16 x bf16 is exact in f32
          acc[h] = fmaf(v[1], q.y, acc[h]);
          acc[h] = fmaf(v[2], q.z, acc[h]);
          acc[h] = fmaf(v[3], q.w, acc[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < kH; ++h) acc[h] = warp_sum(acc[h]);
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < kH; ++h) sP[t * kH + h] = acc[h];
      }
    }
  }
  __syncthreads();

  // The softmax over the live frames, a warp a head; attn rounded to bf16.
  for (int h = warp; h < kH; h += nwarps) {
    if (n <= 0) {  // every score -1e9: exp(0) / F
      const float a = bf16_round(__fdiv_rn(1.0f, static_cast<float>(F)));
      for (int t = lane; t < F; t += 32) sP[t * kH + h] = a;
      continue;
    }
    float m = -INFINITY;
    for (int t = lane; t < rows; t += 32) m = fmaxf(m, sP[t * kH + h]);
    m = warp_max(m);
    float s = 0.0f;
    for (int t = lane; t < rows; t += 32) {
      const float e = expf(__fsub_rn(sP[t * kH + h], m));
      sP[t * kH + h] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int t = lane; t < rows; t += 32) sP[t * kH + h] = bf16_round(__fdiv_rn(sP[t * kH + h], s));
  }
  __syncthreads();

  // Pass 2: pooled[h][d] = sum_t attn[t][h] x[t][d], four columns a thread.
  for (int d4 = tid; d4 < D4; d4 += blockDim.x) {
    float acc[kH][4];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[h][c] = 0.0f;
    for (int t = 0; t < rows; ++t) {
      float v[4];
      load4(x + static_cast<size_t>(t) * D, d4, v);
      const float* a = sP + t * kH;
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[h][c] = fmaf(a[h], v[c], acc[h][c]);
    }
#pragma unroll
    for (int h = 0; h < kH; ++h)
      reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * kH + h) * D)[d4] =
          make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  }
}

template <typename T, int kH>
int launch(const void* frames, const void* num_frames, const void* query, void* out, int B,
           int F, int D, void* stream) {
  const size_t smem = (static_cast<size_t>(kH) * D + static_cast<size_t>(F) * kH) * 4;
  cudaError_t err = cudaFuncSetAttribute(attention_pool_kernel<T, kH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((D / 4 + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads : threads);
  attention_pool_kernel<T, kH><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(frames), static_cast<const int*>(num_frames),
      static_cast<const __nv_bfloat16*>(query), static_cast<float*>(out), F, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* frames, const void* num_frames, const void* query, void* out, int B,
             int F, int D, int H, void* stream) {
  if (B <= 0 || F <= 0 || D <= 0 || D % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (H) {
    case 1: return launch<T, 1>(frames, num_frames, query, out, B, F, D, stream);
    case 2: return launch<T, 2>(frames, num_frames, query, out, B, F, D, stream);
    case 4: return launch<T, 4>(frames, num_frames, query, out, B, F, D, stream);
    case 8: return launch<T, 8>(frames, num_frames, query, out, B, F, D, stream);
    case 16: return launch<T, 16>(frames, num_frames, query, out, B, F, D, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// frames [B, F, D] uint8 (or f32), num_frames [B] int32, query [D, H]
// bf16 with H in {1, 2, 4, 8, 16}, out [B, H, D] f32. One launch on
// `stream`.
extern "C" int yt8m_attention_pool_u8(const void* frames, const void* num_frames,
                                      const void* query, void* out, int B, int F, int D, int H,
                                      void* stream) {
  return dispatch<uint8_t>(frames, num_frames, query, out, B, F, D, H, stream);
}

extern "C" int yt8m_attention_pool_f32(const void* frames, const void* num_frames,
                                       const void* query, void* out, int B, int F, int D, int H,
                                       void* stream) {
  return dispatch<float>(frames, num_frames, query, out, B, F, D, H, stream);
}
