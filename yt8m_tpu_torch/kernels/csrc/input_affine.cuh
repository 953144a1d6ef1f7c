// The element-wise launches shared by the DBoF kernels (dbof.cu) and
// dequant_matmul.cu (netvlad_train.cu takes its pack_bf16, netvlad.cu
// its pack_bf16 and affine), for Hopper (sm_90a): the input
// affine xa = bf16(x * scale + bias) eight inputs a thread, the rounding
// of an f32 weight matrix to bf16, and the grid of such a launch; for
// the 3xTF32 routes (dbof.cu, moe_head.cu), the same affine in f32 split
// into its tf32 halves (input_affine_split) and the split of an f32
// matrix (split_tf32), each into a [2][rows][ld] buffer: big, then small.
//
// The affine multiplies and adds unfused (__fmul_rn, __fadd_rn): the
// plain versions' two roundings, so both round the same float to bf16
// (or split the same float).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace inaff {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr size_t kMaxBlocks = 132 * 16;  // 16 blocks on each of the 132 SMs

// Blocks of a grid-stride launch over n items, one a thread.
inline int blocks(size_t n) {
  const size_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float affine(float x, float s, float b) {
  return __fadd_rn(__fmul_rn(x, s), b);
}

// Eight consecutive inputs as floats.
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

// Eight inputs of features d0.. as eight bf16: bf16(v * scale + bias).
__device__ __forceinline__ uint4 affine8(const float (&v)[8], const float* __restrict__ scale,
                                         const float* __restrict__ bias, int d0) {
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + d0));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale + d0) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + d0));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + d0) + 1);
  uint4 out;
  out.x = pack_bf16(affine(v[0], s0.x, b0.x), affine(v[1], s0.y, b0.y));
  out.y = pack_bf16(affine(v[2], s0.z, b0.z), affine(v[3], s0.w, b0.w));
  out.z = pack_bf16(affine(v[4], s1.x, b1.x), affine(v[5], s1.y, b1.y));
  out.w = pack_bf16(affine(v[6], s1.z, b1.z), affine(v[7], s1.w, b1.w));
  return out;
}

// xa[r, d] = bf16(x[r, d] * scale[d] + bias[d]); one thread per 8
// consecutive inputs (D % 8 == 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
input_affine(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, bf16* __restrict__ xa, size_t n8, int d8) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v[8];
    load8(x + i * 8, v);
    reinterpret_cast<uint4*>(xa)[i] = affine8(v, scale, bias, static_cast<int>(i % d8) * 8);
  }
}

// w16[r, c] = bf16(w[r, c]) for c < cols, 0 for cols <= c < ld.
__global__ void __launch_bounds__(kThreads)
round_bf16(const float* __restrict__ w, bf16* __restrict__ w16, size_t n, int cols, int ld) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / ld;
    const int c = static_cast<int>(i % ld);
    w16[i] = __float2bfloat16_rn(c < cols ? w[r * cols + c] : 0.0f);
  }
}

// xs[0][r, d] and xs[1][r, d]: the tf32 halves of x[r, d] * scale[d] +
// bias[d] (rows * D inputs, `half` apart); eight consecutive inputs a
// thread (D % 8 == 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
input_affine_split(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ xs, size_t n8, int d8,
                   size_t half) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v[8];
    load8(x + i * 8, v);
    const int d0 = static_cast<int>(i % d8) * 8;
    float big[8], small[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      hgemm::tf32_split(affine(v[j], __ldg(scale + d0 + j), __ldg(bias + d0 + j)), big[j],
                        small[j]);
    float4* b4 = reinterpret_cast<float4*>(xs + i * 8);
    float4* s4 = reinterpret_cast<float4*>(xs + half + i * 8);
    b4[0] = make_float4(big[0], big[1], big[2], big[3]);
    b4[1] = make_float4(big[4], big[5], big[6], big[7]);
    s4[0] = make_float4(small[0], small[1], small[2], small[3]);
    s4[1] = make_float4(small[4], small[5], small[6], small[7]);
  }
}

// xs[0][r, c] and xs[1][r, c]: the tf32 halves of x[r, c] (x [rows, cols]
// f32) for c < cols, 0 for cols <= c < ld (n = rows * ld elements a
// half).
__global__ void __launch_bounds__(kThreads)
split_tf32(const float* __restrict__ x, float* __restrict__ xs, size_t n, int cols, int ld) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / ld;
    const int c = static_cast<int>(i % ld);
    float big = 0.0f, small = 0.0f;
    if (c < cols) hgemm::tf32_split(x[r * cols + c], big, small);
    xs[i] = big;
    xs[n + i] = small;
  }
}

// The affine over x [rows, D] into xa [rows, D] bf16.
template <typename T>
inline cudaError_t launch_input_affine(const T* x, const float* scale, const float* bias, bf16* xa,
                                       size_t rows, int D, cudaStream_t st) {
  const size_t n8 = rows * D / 8;
  input_affine<T><<<blocks(n8), kThreads, 0, st>>>(x, scale, bias, xa, n8, D / 8);
  return cudaGetLastError();
}

// The affine over x [rows, D] (D % 8 == 0) into its tf32 halves xs
// [2][rows][D] f32.
template <typename T>
inline cudaError_t launch_input_affine_split(const T* x, const float* scale, const float* bias,
                                             float* xs, size_t rows, int D, cudaStream_t st) {
  const size_t n8 = rows * D / 8;
  input_affine_split<T><<<blocks(n8), kThreads, 0, st>>>(x, scale, bias, xs, n8, D / 8,
                                                         rows * D);
  return cudaGetLastError();
}

// x [rows, cols] f32 -> its tf32 halves xs [2][rows][ld], the columns
// past cols zero.
inline cudaError_t launch_split_tf32(const float* x, float* xs, size_t rows, int cols, int ld,
                                     cudaStream_t st) {
  const size_t n = rows * ld;
  split_tf32<<<blocks(n), kThreads, 0, st>>>(x, xs, n, cols, ld);
  return cudaGetLastError();
}

// w [rows, cols] f32 -> w16 [rows, ld] bf16, the columns past cols zero.
inline cudaError_t launch_round_bf16(const float* w, bf16* w16, size_t rows, int cols, int ld,
                                     cudaStream_t st) {
  const size_t n = rows * ld;
  round_bf16<<<blocks(n), kThreads, 0, st>>>(w, w16, n, cols, ld);
  return cudaGetLastError();
}

}  // namespace
}  // namespace inaff
