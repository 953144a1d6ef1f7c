// Plain products on hopper_gemm.cuh's TMA + wgmma mainloop, for the card
// tests of the mainloop itself (its descriptors, the operand layouts, the
// chains, the zero fill at ragged edges and the TMA-store epilogue):
//
//   c [M, N] f32 = a [M, K] bf16 @ b [K, N] bf16       (f32 accumulate)
//
//  * yt8m_hopper_gemm: a row-major (K-major), b row-major (MN-major, as
//    the weights of dbof.cu and moe_head.cu); K and N multiples of 8
//    (TMA's 16-byte strides). A block computes 128 rows x BN columns, BN
//    one of the chain widths the kernels use.
//  * yt8m_hopper_gemm_layouts: the same kernel with a given as [K, M]
//    (MN-major, the VLAD forward's assignment) and/or b as [N, K]
//    (K-major, the VLAD backward's dvlad), 128 x 128 tiles, one
//    m64n128k16 a consumer.
//  * yt8m_hopper_product: hopper_product.cuh's batched product with its
//    TMA-store epilogue (the store from registers when N % 4 != 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "hopper_product.cuh"

namespace {

constexpr int kStages = 4;

// AMN: a stored [K][M] (MN-major), in [64 deep][64 rows] boxes, else [M][K]
// in [128 rows][64 deep]. BK: b stored [N][K] (K-major), in one [BN
// columns][64 deep] box, else [K][N] in [64 deep][64 columns] boxes.
template <int BN, bool BK>
__host__ __device__ constexpr int stage_bytes() {
  return hgemm::kABytes + (BK ? BN * hgemm::kDepth * 2 : hgemm::boxes(BN) * hgemm::kBoxBytes);
}

template <int BN, bool AMN, bool BK>
__global__ void __launch_bounds__(hgemm::kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            float* __restrict__ c, int M, int N, int K) {
  constexpr int kStage = stage_bytes<BN, BK>();
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
        const int k0 = kt * hgemm::kDepth;
        if (AMN) {
          for (int i = 0; i < 2; ++i)
            hgemm::tma_3d(st + i * hgemm::kBoxBytes, amap, bar, m0 + 64 * i, k0, 0);
        } else {
          hgemm::tma_3d(st, amap, bar, k0, m0, 0);
        }
        unsigned char* sb = st + hgemm::kABytes;
        if (BK) {
          hgemm::tma_3d(sb, bmap, bar, k0, n0, 0);
        } else {
#pragma unroll
          for (int i = 0; i < hgemm::boxes(BN); ++i)
            hgemm::tma_3d(sb + i * hgemm::kBoxBytes, bmap, bar, n0 + i * hgemm::kBoxCols, k0, 0);
        }
      });
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    float acc[BN / 2];
    hgemm::zero<BN / 2>(acc);
    // This consumer's 64 rows are 8 KB on in either A layout.
    const uint32_t a_off = wg * 64 * hgemm::kDepth * 2;
    hgemm::consume<kStages, BN / 2>(full, empty, ring, nk, acc, [&](int s) {
      const uint32_t st = hgemm::smem_u32(smem + s * kStage);
#pragma unroll
      for (int kk = 0; kk < hgemm::kDepth / 16; ++kk) {
        if constexpr (AMN || BK) {
          hgemm::mma<BN, AMN ? 1 : 0, BK ? 0 : 1>(
              acc, AMN ? hgemm::desc_a_mn(st + a_off, kk) : hgemm::desc_a(st + a_off, kk),
              BK ? hgemm::desc_b_k(st + hgemm::kABytes, kk)
                 : hgemm::desc_b(st + hgemm::kABytes, kk));
        } else {
          hgemm::chain<BN>(acc, st + a_off, st + hgemm::kABytes, kk);
        }
      }
    });
    const int lane = threadIdx.x & 31;
    const int row = m0 + wg * 64 + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + 2 * (lane & 3) + e;
          if (row + 8 * h < M && n < N)
            c[static_cast<size_t>(row + 8 * h) * N + n] = acc[4 * j + 2 * h + e];
        }
  }
}

template <int BN, bool AMN = false, bool BK = false>
int launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t st) {
  constexpr int kSmem = hgemm::smem_request(kStages * stage_bytes<BN, BK>() + 2 * kStages * 8);
  static_assert(kSmem <= 232448, "shared memory a block");
  CUtensorMap map_a, map_b;
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = AMN ? hgemm::make_map_bf16(&map_a, a, 1, K, M, M, hgemm::kDepth)
              : hgemm::make_map_bf16(&map_a, a, 1, M, K, K, hgemm::kRows);
  if (err == cudaSuccess)
    err = BK ? hgemm::make_map_bf16(&map_b, b, 1, N, K, K, BN)
             : hgemm::make_map_bf16(&map_b, b, 1, K, N, N, hgemm::kDepth);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<BN, AMN, BK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + hgemm::kRows - 1) / hgemm::kRows);
  gemm_kernel<BN, AMN, BK><<<grid, hgemm::kThreads, kSmem, st>>>(
      map_a, map_b, static_cast<float*>(c), M, N, K);
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

// c [M, N] f32 = a @ b with a stored [K, M] when a_mn (M a multiple of 8)
// else [M, K], and b stored [N, K] when b_k else [K, N] (N a multiple of
// 8); K a multiple of 8.
extern "C" int yt8m_hopper_gemm_layouts(const void* a, const void* b, void* c, int M, int N, int K,
                                        int a_mn, int b_k, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || (a_mn && M % 8 != 0) || (!b_k && N % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_mn)
    return b_k ? launch<128, true, true>(a, b, c, M, N, K, st)
               : launch<128, true, false>(a, b, c, M, N, K, st);
  return b_k ? launch<128, false, true>(a, b, c, M, N, K, st)
             : launch<128, false, false>(a, b, c, M, N, K, st);
}

// c [batch, M, N] f32 = a [batch, M, K] (rows lda apart) @ b [batch, K, N]
// (rows ldb apart), bf16: hopper_product.cuh's kernel.
extern "C" int yt8m_hopper_product(const void* a, const void* b, void* c, int batch, int M, int N,
                                   int K, int lda, int ldb, void* stream) {
  return static_cast<int>(hprod::launch_product(a, b, static_cast<float*>(c), batch, M, N, K, lda,
                                                ldb, static_cast<cudaStream_t>(stream)));
}
