// A batched bf16 product with f32 output on hopper_gemm.cuh's TMA + wgmma
// mainloop, with a TMA-store epilogue (sm_90a):
//
//   y[b, M, N] f32 = a[b, M, K] bf16 @ w[b, K, N] bf16       (f32 sums)
//
// a K-major (rows lda apart), w MN-major (rows ldw apart); lda and ldw
// multiples of 8 (TMA's 16-byte strides); the depth past K and the
// columns past N read as zeros. Used by dequant_matmul.cu (the bf16
// route, batch 1), netvlad_train.cu (dx = bf16(assign) @ bf16(dvlad), a
// batch a video) and hopper_gemm.cu (the card tests).
//
// What bounds it: at dequant_matmul's main shape (M = 153,600, K = 1152,
// N = 4096) the product is 1.45 TFLOP (1.47 ms at the bf16 peak) and the
// f32 output 2.5 GB (0.75 ms at 3.35 TB/s): the output store has to run
// under the products, not after them.
//
// Design. A tile is 128 rows x 256 columns: two consumer warpgroups, 64
// rows each, one m64n256k16 chain a 16-deep step (128 accumulators a
// thread); the producer warp fills a 3-stage ring of 48 KB (A 16 KB, W
// four 8 KB boxes). The grid is persistent (a block an SM walking the
// tiles, the column tile fastest: a 128-row tile of A is read from device
// memory once and its other column tiles hit L2; W stays in L2).
// Epilogue: each consumer stages its 64 x 256 accumulators a quarter (64
// columns, 16 KB: two f32 boxes of [64 rows][32 columns], the 128-byte
// swizzle, so the warps' float2 writes hit every bank once) at a time in
// two buffers of its own, and one thread stores each quarter by TMA
// (rows past M and columns past N are clipped by the map). A buffer is
// written again once its previous store has read it (bulk_wait_read<1>),
// so the stores drain while the next quarter is staged and while the
// next tile's mainloop runs. Shared memory: 3 x 48 KB of ring + 2 x 2 x
// 16 KB of staging = 208 KB; a fourth ring stage would not fit beside the
// staging (the ring cannot hold it: the producer fills the ring with the
// next tile during the epilogue). y's row stride is N * 4 bytes: an N
// that is no multiple of 4 cannot take a TMA store, and the tile is then
// stored from the registers, masked.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace hprod {
namespace {

constexpr int kBN = 256;                         // columns a tile
constexpr int kStages = 3;
constexpr int kStageBytes = hgemm::kABytes + hgemm::boxes(kBN) * hgemm::kBoxBytes;  // 48 KB
constexpr int kOutRows = 64;                     // a consumer's rows
constexpr int kOutBoxBytes = kOutRows * hgemm::kF32BoxCols * 4;  // 8 KB: [64][32] f32
constexpr int kQuarter = 64;                     // columns staged at a time
constexpr int kQuarterBytes = kOutRows * kQuarter * 4;          // 16 KB: two boxes
constexpr int kOutBytes = 2 * 2 * kQuarterBytes;  // two consumers x two buffers
constexpr int kSmemBytes = kStages * kStageBytes + kOutBytes + 2 * kStages * 8;
constexpr int kSmemRequest = hgemm::smem_request(kSmemBytes);
static_assert(kSmemRequest <= 232448, "shared memory a block");
static_assert(kBN == 4 * kQuarter, "four quarters a tile");

// Tile t: batch, row tile, column tile (the fastest).
__device__ __forceinline__ void tile_coords(int t, int n_rt, int n_ct, int& b, int& rt, int& ct) {
  ct = t % n_ct;
  const int rest = t / n_ct;
  rt = rest % n_rt;
  b = rest / n_rt;
}

__global__ void __launch_bounds__(hgemm::kThreads, 1)
product_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_y, float* __restrict__ y, int batch, int M,
               int N, int K, int tma_store) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  unsigned char* out = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + kOutBytes);
  uint64_t* empty = full + kStages;

  const int nk = (K + hgemm::kDepth - 1) / hgemm::kDepth;
  const int n_rt = (M + hgemm::kRows - 1) / hgemm::kRows;
  const int n_ct = (N + kBN - 1) / kBN;
  const int tiles = batch * n_rt * n_ct;
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
  const CUtensorMap* amap = &map_a;  // the parameters themselves (TMA reads them there)
  const CUtensorMap* wmap = &map_w;
  const CUtensorMap* ymap = &map_y;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int b, rt, ct;
        tile_coords(t, n_rt, n_ct, b, rt, ct);
        hgemm::produce<kStages>(
            full, empty, ring, nk, kStageBytes, [&](int s, uint64_t* bar, int kt) {
              unsigned char* st = smem + s * kStageBytes;
              hgemm::tma_3d(st, amap, bar, kt * hgemm::kDepth, rt * hgemm::kRows, b);
#pragma unroll
              for (int i = 0; i < kBN / hgemm::kBoxCols; ++i)
                hgemm::tma_3d(st + hgemm::kABytes + i * hgemm::kBoxBytes, wmap, bar,
                              ct * kBN + i * hgemm::kBoxCols, kt * hgemm::kDepth, b);
            });
      }
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int r = lane >> 2;
    const bool issuer = (threadIdx.x & 127) == 0;
    const uint32_t a_off = wg * 64 * hgemm::kDepth * 2;
    unsigned char* mine = out + wg * 2 * kQuarterBytes;
    float acc[kBN / 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int b, rt, ct;
      tile_coords(t, n_rt, n_ct, b, rt, ct);
      hgemm::zero<kBN / 2>(acc);
      hgemm::consume<kStages, kBN / 2>(full, empty, ring, nk, acc, [&](int s) {
        const uint32_t st = hgemm::smem_u32(smem + s * kStageBytes);
#pragma unroll
        for (int kk = 0; kk < hgemm::kDepth / 16; ++kk)
          hgemm::chain<kBN>(acc, st + a_off, st + hgemm::kABytes, kk);
      });
      const int row0 = rt * hgemm::kRows + wg * kOutRows;  // the consumer's first row
      const int n0 = ct * kBN;
      if (tma_store) {
#pragma unroll
        for (int qd = 0; qd < kBN / kQuarter; ++qd) {
          unsigned char* buf = mine + (qd & 1) * kQuarterBytes;
          if (issuer) hgemm::bulk_wait_read<1>();  // this buffer's last store has read it
          hgemm::named_sync(1 + wg, 128);
          // Columns 8j + 2q + e of the quarter: box (8j) / 32, its chunk
          // (8j % 32) / 4 + q / 2, the float2 at 8 (q & 1) bytes in it.
#pragma unroll
          for (int j = 0; j < kQuarter / 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 16 * warp + r + 8 * h;
              const int c = (8 * j) % hgemm::kF32BoxCols;
              unsigned char* p = buf + (8 * j / hgemm::kF32BoxCols) * kOutBoxBytes +
                                 hgemm::swizzled(row, c / 4 + q / 2) + 8 * (q & 1);
              const int a = 4 * (qd * kQuarter / 8 + j) + 2 * h;
              *reinterpret_cast<float2*>(p) = make_float2(acc[a], acc[a + 1]);
            }
          }
          hgemm::fence_async_smem();
          hgemm::named_sync(1 + wg, 128);
          if (issuer) {
            const int c0 = n0 + qd * kQuarter;
            if (row0 < M && c0 < N) {
              hgemm::tma_store_3d(ymap, buf, c0, row0, b);
              if (c0 + hgemm::kF32BoxCols < N)
                hgemm::tma_store_3d(ymap, buf + kOutBoxBytes, c0 + hgemm::kF32BoxCols, row0, b);
            }
            hgemm::bulk_commit();
          }
        }
      } else {
        float* yb = y + static_cast<size_t>(b) * M * N;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = row0 + 16 * warp + r + 8 * h;
              const int n = n0 + 8 * j + 2 * q + e;
              if (row < M && n < N) yb[static_cast<size_t>(row) * N + n] = acc[4 * j + 2 * h + e];
            }
      }
    }
    if (issuer) hgemm::bulk_wait_all();
  }
}

// y [batch, M, N] f32 = a [batch, M, K] (rows lda apart) @ w [batch, K, N]
// (rows ldw apart), bf16; as many blocks as SMs (or tiles).
inline cudaError_t launch_product(const void* a, const void* w, float* y, int batch, int M, int N,
                                  int K, int lda, int ldw, cudaStream_t st) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0 || lda < K || ldw < N || lda % 8 != 0 ||
      ldw % 8 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap map_a, map_w, map_y;
  const int tma_store = N % 4 == 0;
  err = hgemm::make_map_bf16(&map_a, a, batch, M, K, lda, hgemm::kRows);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_w, w, batch, K, N, ldw, hgemm::kDepth);
  // Without a TMA store the map is not used; it is made over a 4-column
  // view so that its stride is legal.
  if (err == cudaSuccess)
    err = hgemm::make_map_f32(&map_y, y, batch, M, tma_store ? N : 4, kOutRows);
  int sms = 0;
  if (err == cudaSuccess) err = hgemm::sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemRequest);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(batch) * ((M + hgemm::kRows - 1) / hgemm::kRows) *
                          ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  product_kernel<<<grid, hgemm::kThreads, kSmemRequest, st>>>(map_a, map_w, map_y, y, batch, M, N,
                                                               K, tma_store);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hprod
