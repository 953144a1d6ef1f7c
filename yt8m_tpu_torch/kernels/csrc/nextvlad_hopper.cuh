// What the NeXtVLAD kernels (nextvlad.cu, nextvlad_train.cu) share on
// hopper_gemm.cuh's TMA + wgmma mainloop (sm_90a): the packed row layout
// and the persistent row product.
//
// The packed row layout. The live frames of all videos are packed one
// after another, each video's run padded with zero rows to a multiple of
// R = max(8, 64 / gcd(G, 64)) frames: poff[b] (from the wrapper, the
// prefix sums of the padded run lengths) is video b's first packed row
// and poff[B] the packed total. Then
//  * every row tensor of the forward and backward (the bf16 frames xb, xe,
//    the bf16 assignment, the f32 softmax, alpha, d_act, d_xg, d_xe) is a
//    plain row-major [rows, width] matrix, so a frame-row product's A
//    operand is one 2-D TMA map over the packed rows;
//  * a video's (frame, group) rows, n_pad G of them, are a multiple of 64:
//    the per-video products (the aggregation assign^T @ xg and, in the
//    backward, xg @ dv^T and assign @ dv) read them as depth in whole
//    64-deep stages that never reach the next video;
//  * every 8-row block of packed rows belongs to one video, so the
//    cluster product sums a column over a block's rows across the eight
//    lanes that hold them in the wgmma accumulators, with no video test.
// info[r] (written by the frames pass) is b for a live frame of video b,
// -1 - b for a pad row of video b and -1 - B for the rows from poff[B] up
// to the next multiple of 128, the last row tile, which every writer
// fills with zeros. So every product reads exact zeros or live values
// wherever its 64-deep stages and 128-row tiles reach, and frames past
// num_frames are never read.
//
// The row product (expansion xe = bf16(xb @ We) and, in the backward,
// d_xe = bf16(d_xg + [d_act | d_pre] @ wext)): y [rows, N] bf16 = a [rows,
// K] bf16 (K-major) @ w [K, N] bf16 (MN-major) over the packed rows, f32
// sums rounded once, optionally plus an f32 addend on the live rows (the
// others become zeros). A tile is 128 packed rows x 256 columns; the
// grid is persistent (a block an SM, the column tile fastest: a row
// tile's A is read from device memory once and hits L2 for its other
// column tiles; w stays in L2); the tile count comes from poff[B] on the
// device. A 4-stage ring of 48 KB; the epilogue rounds each consumer's 64
// x 256 accumulators to bf16 a quarter (a [64][64] box, 8 KB) at a time
// into two buffers of its own and stores them by TMA while the next
// quarter is staged and the next tile's mainloop runs.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace nxv {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = hgemm::kRows;  // 128 rows a tile
constexpr int kCols = 256;           // a row product's column tile
constexpr int kRowBlock = 8;         // the packed rows a video's run is a multiple of, at least
constexpr int kWideCols = 288;       // the per-video products' column tile: 256 + 32
constexpr int kWideBoxes = hgemm::boxes(kWideCols);  // 5

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int ceil_div(int x, int m) { return (x + m - 1) / m; }
__host__ __device__ constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// R: a video's run of packed rows is a multiple of R frames.
__host__ __device__ constexpr int run_frames(int G) {
  return 64 / gcd(G, 64) > kRowBlock ? 64 / gcd(G, 64) : kRowBlock;
}

__device__ __forceinline__ int info_video(int info) { return info >= 0 ? info : -1 - info; }

__device__ __forceinline__ int live_frames(const int* num_frames, int b, int F) {
  return min(max(num_frames[b], 0), F);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Over the four lanes of a quad (a row of the wgmma accumulators).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Thread coordinates in a consumer warpgroup: warp 0..3, quad lane q, row r.
struct Lane {
  int warp, q, r;
  __device__ __forceinline__ Lane()
      : warp((threadIdx.x / 32) & 3), q(threadIdx.x & 3), r((threadIdx.x & 31) >> 2) {}
  // The warpgroup-local row of accumulator half h.
  __device__ __forceinline__ int row(int h) const { return 16 * warp + r + 8 * h; }
};

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hgemm::bar_init(&full[s], 1);
      hgemm::bar_init(&empty[s], hgemm::kConsumerWarps);
    }
    hgemm::bar_init_fence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The row product.
// ---------------------------------------------------------------------------

namespace rowprod {
constexpr int kStages = 4;
constexpr int kStageBytes = hgemm::kABytes + hgemm::boxes(kCols) * hgemm::kBoxBytes;  // 48 KB
constexpr int kOutBox = 64 * 64 * 2;  // [64 rows][64 columns] bf16: 8 KB
constexpr int kOutBytes = 2 * 2 * kOutBox;  // two consumers x two buffers
constexpr int kSmemBytes = kStages * kStageBytes + kOutBytes + 2 * kStages * 8;
constexpr int kSmem = hgemm::smem_request(kSmemBytes);
static_assert(kSmem <= 232448, "shared memory a block");
}  // namespace rowprod

__global__ void __launch_bounds__(hgemm::kThreads, 1)
nxv_row_product(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_y, const int* __restrict__ poff,
                const int* __restrict__ info, const float* __restrict__ add, int B, int N, int K) {
  using namespace rowprod;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  unsigned char* out = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + kOutBytes);
  uint64_t* empty = full + kStages;
  const int n_rt = ceil_div(poff[B], kRows);
  const int n_ct = ceil_div(N, kCols);
  const int tiles = n_rt * n_ct;
  const int nk = ceil_div(K, hgemm::kDepth);
  init_ring(full, empty, kStages);

  const int wg = hgemm::warpgroup();
  hgemm::Ring ring;
  const CUtensorMap* amap = &map_a;  // the parameters themselves (TMA reads them there)
  const CUtensorMap* wmap = &map_w;
  const CUtensorMap* ymap = &map_y;
  if (wg == 2) {
    hgemm::set_regs_dec<hgemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int rt = t / n_ct;
        const int ct = t % n_ct;
        hgemm::produce<kStages>(full, empty, ring, nk, kStageBytes, [&](int s, uint64_t* bar, int kt) {
          unsigned char* st = smem + s * kStageBytes;
          hgemm::tma_3d(st, amap, bar, kt * hgemm::kDepth, rt * kRows, 0);
#pragma unroll
          for (int i = 0; i < kCols / hgemm::kBoxCols; ++i)
            hgemm::tma_3d(st + hgemm::kABytes + i * hgemm::kBoxBytes, wmap, bar,
                          ct * kCols + i * hgemm::kBoxCols, kt * hgemm::kDepth, 0);
        });
      }
    }
  } else {
    hgemm::set_regs_inc<hgemm::kConsumerRegs>();
    const Lane ln;
    const bool issuer = (threadIdx.x & 127) == 0;
    const uint32_t a_off = wg * 64 * hgemm::kDepth * 2;
    unsigned char* mine = out + wg * 2 * kOutBox;
    float acc[kCols / 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int rt = t / n_ct;
      const int ct = t % n_ct;
      if (add != nullptr && threadIdx.x < kRows) {
        // The tile's addend into L2 while the mainloop runs: a row's 1 KB
        // a consumer thread (a bulk prefetch).
        const int n0 = ct * kCols;
        const uint32_t bytes = 4 * min(kCols, N - n0);
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                         add + static_cast<size_t>(rt * kRows + threadIdx.x) * N + n0),
                     "r"(bytes)
                     : "memory");
      }
      hgemm::zero<kCols / 2>(acc);
      hgemm::consume<kStages, kCols / 2>(full, empty, ring, nk, acc, [&](int s) {
        const uint32_t st = hgemm::smem_u32(smem + s * kStageBytes);
#pragma unroll
        for (int kk = 0; kk < hgemm::kDepth / 16; ++kk)
          hgemm::chain<kCols>(acc, st + a_off, st + hgemm::kABytes, kk);
      });
      const int row0 = rt * kRows + wg * 64;  // the consumer's first row
#pragma unroll
      for (int qd = 0; qd < kCols / 64; ++qd) {
        unsigned char* buf = mine + (qd & 1) * kOutBox;
        if (issuer) hgemm::bulk_wait_read<1>();  // this buffer's last store has read it
        hgemm::named_sync(1 + wg, 128);
        // Columns 8j + 2q of the quarter: chunk j of the row, 4q bytes in.
        // d_xe: + d_xg on the live rows, zeros elsewhere (pad rows and the
        // last tile's rows past the packed total); loads unconditional
        // (clamped to the quarter's first column), values selected.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + ln.row(h);
          float v[16];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int a = 4 * (8 * qd + j) + 2 * h;
            v[2 * j] = acc[a];
            v[2 * j + 1] = acc[a + 1];
          }
          if (add != nullptr) {
            const bool live = __ldg(info + row) >= 0;
            const float* arow = add + static_cast<size_t>(row) * N;
            float2 ad[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int n = ct * kCols + qd * 64 + 8 * j + 2 * ln.q;
              ad[j] = __ldg(reinterpret_cast<const float2*>(arow + (n < N ? n : 0)));
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              v[2 * j] = hgemm::select(live, __fadd_rn(ad[j].x, v[2 * j]), 0.0f);
              v[2 * j + 1] = hgemm::select(live, __fadd_rn(ad[j].y, v[2 * j + 1]), 0.0f);
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(buf + hgemm::swizzled(ln.row(h), j) + 4 * ln.q) =
                pack_bf16(v[2 * j], v[2 * j + 1]);
        }
        hgemm::fence_async_smem();
        hgemm::named_sync(1 + wg, 128);
        if (issuer) {
          const int c0 = ct * kCols + qd * 64;
          if (c0 < N) hgemm::tma_store_3d(ymap, buf, c0, row0, 0);
          hgemm::bulk_commit();
        }
      }
    }
    if (issuer) hgemm::bulk_wait_all();
  }
}

// y [cap, N] bf16 = a [cap, K] @ w [K, N] (+ add [cap, N] f32 on the live
// rows) for the packed rows below round_up(poff[B], 128) <= cap; N and K
// multiples of 8.
inline cudaError_t launch_row_product(const void* a, const void* w, void* y, const float* add,
                                      const int* poff, const int* info, int B, int cap, int N,
                                      int K, cudaStream_t st) {
  if (cap <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w, map_y;
  cudaError_t err = hgemm::make_map_bf16(&map_a, a, 1, cap, K, K, kRows);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_w, w, 1, K, N, N, hgemm::kDepth);
  if (err == cudaSuccess) err = hgemm::make_map_bf16(&map_y, y, 1, cap, N, N, 64);
  int sms = 0;
  if (err == cudaSuccess) err = hgemm::sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nxv_row_product, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               rowprod::kSmem);
  if (err != cudaSuccess) return err;
  const int most = ceil_div(cap, kRows) * ceil_div(N, kCols);  // tiles at most
  nxv_row_product<<<most < sms ? most : sms, hgemm::kThreads, rowprod::kSmem, st>>>(
      map_a, map_w, map_y, poff, info, add, B, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nxv
