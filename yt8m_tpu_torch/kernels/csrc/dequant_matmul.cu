// Fused dequantize + per-feature affine + matmul, for Hopper (sm_90a).
//
// Replaces yt8m_tpu/kernels/dequant_matmul.py :: dequant_affine_matmul:
//
//   y[M, N] = (x[M, D] * scale[D] + bias[D]) @ w[D, N]      x uint8, y f32
//
// in the TPU kernel's compute dtype: bf16 operands with f32 sums when
// D >= 512, f32 otherwise.
//
// What bounds it. At the flagship's first LSTM input projection over raw
// frames (M = 512 * 300, D = 1152, N = 4096) the product is 1.45 TFLOP,
// 1.47 ms at the card's bf16 tensor-core rate, against 177 MB of input
// and 2.5 GB of f32 output (0.8 ms): bound by operations. The f32 route
// (the 128 audio features, D = 128, N = 1024) is bound by the f32 rate
// outside the tensor cores.
//
// Design.
//  * bf16 route, three launches on the caller's stream: round_bf16
//    (input_affine.cuh) rounds w to bf16 into a [D, ldw] buffer from the
//    wrapper, the columns padded with zeros to a multiple of 8 (the TPU
//    kernel casts w in its body); input_affine (input_affine.cuh) writes
//    xa = bf16(x * scale + bias) (unfused multiply and add, the plain
//    version's two roundings) once into a [M, D] bf16 buffer from the
//    wrapper; then dequant_gemm_bf16 runs the block product of
//    nextvlad_gemm.cuh (128 x 128 tiles, wmma, a 3-stage cp.async ring;
//    ragged rows, columns and depth zero-filled) and stores the f32 tile
//    through shared memory, masked to [M, N]. Fused into the product the
//    affine would run once per 128-column tile, 32 times over at N = 4096.
//  * f32 route, one launch: dequant_gemm_f32, a tiled SIMT product (64 x
//    64 block tiles, 4 x 4 outputs a thread, depth 16 a step) whose tile
//    loads apply the affine to the uint8 frames in f32. Plain f32 FMAs,
//    not TF32: the TPU kernel computes in f32.
// This is the simple first kernel: wmma fragments, not wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "input_affine.cuh"
#include "nextvlad_gemm.cuh"

namespace {

using nxv::bf16;

constexpr int kBM = 128;
constexpr int kBN = 128;
using Mma = nxv::BlockMma<kBM, kBN, false, false>;

using inaff::affine;

// y [M, N] f32 = xa [M, D] bf16 @ w [D, ldw] bf16 (ldw >= N, a multiple
// of 8; the columns past N are not used).
__global__ void __launch_bounds__(nxv::kThreads)
dequant_gemm_bf16(const bf16* __restrict__ xa, const bf16* __restrict__ w,
                  float* __restrict__ y, int M, int D, int N, int ldw) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + nxv::kStages * Mma::kStageA;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  Mma::Acc acc[Mma::FM][Mma::FN];
  const int nsteps = (D + nxv::kBK - 1) / nxv::kBK;
  Mma::run(acc, sA, sB, nsteps, [&](int slot, int step) {
    const int d0 = step * nxv::kBK;
    Mma::load(
        sA, sB, slot,
        [&](int r, int c, bool& ok) -> const bf16* {
          ok = m0 + r < M && d0 + c < D;
          return ok ? xa + static_cast<size_t>(m0 + r) * D + d0 + c : xa;
        },
        [&](int r, int c, bool& ok) -> const bf16* {
          ok = d0 + r < D && n0 + c < ldw;
          return ok ? w + static_cast<size_t>(d0 + r) * ldw + n0 + c : w;
        });
  });
  float* S = reinterpret_cast<float*>(smem);
  Mma::store(acc, S);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += nxv::kThreads) {
    const int r = i / kBN;
    const int c = i % kBN;
    if (m0 + r < M && n0 + c < N) y[static_cast<size_t>(m0 + r) * N + n0 + c] = S[r * Mma::kLdS + c];
  }
}

constexpr int kFM = 64;   // f32 route: block rows
constexpr int kFN = 64;   // block columns
constexpr int kFK = 16;   // depth a step

// y [M, N] f32 = (x * scale + bias) [M, D] f32 @ w [D, N] f32; thread (ty,
// tx) of 16 x 16 holds rows ty + 16 i and columns tx + 16 j, i, j < 4.
__global__ void __launch_bounds__(256)
dequant_gemm_f32(const uint8_t* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ w,
                 float* __restrict__ y, int M, int D, int N) {
  __shared__ float sA[kFK][kFM];
  __shared__ float sB[kFK][kFN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kFM;
  const int n0 = blockIdx.x * kFN;
  float acc[4][4] = {};
  for (int d0 = 0; d0 < D; d0 += kFK) {
#pragma unroll
    for (int e = tid; e < kFM * kFK; e += 256) {
      const int r = e / kFK;
      const int c = e % kFK;
      const int m = m0 + r;
      const int d = d0 + c;
      sA[c][r] = m < M && d < D
                     ? affine(static_cast<float>(x[static_cast<size_t>(m) * D + d]), scale[d], bias[d])
                     : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < kFK * kFN; e += 256) {
      const int r = e / kFN;
      const int c = e % kFN;
      const int d = d0 + r;
      const int n = n0 + c;
      sB[r][c] = d < D && n < N ? w[static_cast<size_t>(d) * N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

bool bad_shape(int M, int D, int N) { return M <= 0 || D <= 0 || N <= 0; }

}  // namespace

// x [M, D] uint8 (D a multiple of 8); w [D, N] f32; w16: a work buffer
// of D*ldw bf16 from the caller (ldw >= N, a multiple of 8); xa: one of
// M*D bf16; y [M, N] f32.
extern "C" int yt8m_dequant_matmul_bf16(const void* x, const void* scale, const void* bias,
                                        const void* w, void* w16, void* xa, void* y, int M,
                                        int D, int N, int ldw, void* stream) {
  if (bad_shape(M, D, N) || D % 8 != 0 || ldw < N || ldw % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = inaff::launch_round_bf16(static_cast<const float*>(w), static_cast<bf16*>(w16),
                                             static_cast<size_t>(D), N, ldw, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = inaff::launch_input_affine(static_cast<const uint8_t*>(x),
                                   static_cast<const float*>(scale),
                                   static_cast<const float*>(bias), static_cast<bf16*>(xa),
                                   static_cast<size_t>(M), D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = nxv::set_smem(dequant_gemm_bf16, Mma::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dequant_gemm_bf16<<<grid, nxv::kThreads, Mma::kBytes, st>>>(
      static_cast<const bf16*>(xa), static_cast<const bf16*>(w16), static_cast<float*>(y), M, D,
      N, ldw);
  return static_cast<int>(cudaGetLastError());
}

// x [M, D] uint8; w [D, N] f32; y [M, N] f32.
extern "C" int yt8m_dequant_matmul_f32(const void* x, const void* scale, const void* bias,
                                       const void* w, void* y, int M, int D, int N,
                                       void* stream) {
  if (bad_shape(M, D, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
  dequant_gemm_f32<<<grid, 256, 0, st>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(w), static_cast<float*>(y), M,
      D, N);
  return static_cast<int>(cudaGetLastError());
}
