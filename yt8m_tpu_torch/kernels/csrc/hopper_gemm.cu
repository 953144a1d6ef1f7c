// A plain product on hopper_gemm.cuh's TMA + wgmma mainloop, for the card
// tests of the mainloop itself (its descriptors, the MN-major B, the
// chains and the zero fill at ragged edges):
//
//   c [M, N] f32 = a [M, K] bf16 @ b [K, N] bf16       (f32 accumulate)
//
// a is row-major (K-major), b row-major (MN-major, as the weights of
// dbof.cu and moe_head.cu); K and N multiples of 8 (TMA's 16-byte
// strides). A block computes 128 rows x BN columns, BN one of the chain
// widths the kernels use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int kStages = 4;

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return hgemm::kABytes + hgemm::boxes(BN) * hgemm::kBoxBytes;
}

template <int BN>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            float* __restrict__ c, int M, int N, int K) {
  constexpr int kStage = stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int nk = (K + hgemm::kDepth - 1) / hgemm::kDepth;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * hgemm::kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hgemm::bar_init(&full[s], 1);
      hgemm::bar_init(&empty[s], hgemm::kConsumerWarps);
    }
    hgemm::bar_init_fence();
  }
  __syncthreads();
  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* amap = &map_a;  // the parameter itself (TMA reads it there)
  const CUtensorMap* bmap = &map_b;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      hgemm::produce<kStages>(full, empty, ring, nk, kStage, [&](int s, uint64_t* bar, int kt) {
        unsigned char* st = smem + s * kStage;
        hgemm::tma_2d(st, amap, bar, kt * hgemm::kDepth, m0);
#pragma unroll
        for (int i = 0; i < hgemm::boxes(BN); ++i)
          hgemm::tma_2d(st + hgemm::kABytes + i * hgemm::kBoxBytes, bmap, bar,
                        n0 + i * hgemm::kBoxCols, kt * hgemm::kDepth);
      });
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    float acc[BN / 2];
    hgemm::zero<BN / 2>(acc);
    const uint32_t a_off = wg * 64 * hgemm::kDepth * 2;
    hgemm::consume<kStages, BN / 2>(full, empty, ring, nk, acc, [&](int s) {
      const uint32_t st = hgemm::smem_u32(smem + s * kStage);
#pragma unroll
      for (int kk = 0; kk < hgemm::kDepth / 16; ++kk)
        hgemm::chain<BN>(acc, st + a_off, st + hgemm::kABytes, kk);
    });
    const int lane = threadIdx.x & 31;
    const int row = m0 + wg * 64 + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if (row + 8 * h < M && n < N)
          *reinterpret_cast<float2*>(c + static_cast<size_t>(row + 8 * h) * N + n) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
}

template <int BN>
int launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t st) {
  constexpr int kSmem = hgemm::smem_request(kStages * stage_bytes<BN>() + 2 * kStages * 8);
  static_assert(kSmem <= 232448, "shared memory a block");
  CUtensorMap map_a, map_b;
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = hgemm::make_map_2d(&map_a, a, M, K, K, hgemm::kRows);
  if (err == cudaSuccess) err = hgemm::make_map_2d(&map_b, b, K, N, N, hgemm::kDepth);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + hgemm::kRows - 1) / hgemm::kRows);
  gemm_kernel<BN><<<grid, hgemm::kThreads, kSmem, st>>>(map_a, map_b, static_cast<float*>(c), M,
                                                          N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bn: the block's columns, 256 (DBoF's chain), 136 (128 + 8) or 96 (64 + 32).
extern "C" int yt8m_hopper_gemm(const void* a, const void* b, void* c, int M, int N, int K, int bn,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 256:
      return launch<256>(a, b, c, M, N, K, st);
    case 136:
      return launch<136>(a, b, c, M, N, K, st);
    case 96:
      return launch<96>(a, b, c, M, N, K, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
