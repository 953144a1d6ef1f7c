// The f32 product of netvlad.cu's --compute_dtype=float32 route, for
// Hopper (sm_90a): a block's [128 x 128] tile of A [M, depth] @ B
// [depth, N] in plain f32 FMAs with f32 sums.
//
// At --compute_dtype=float32 the TPU kernels that take a `dtype` round
// nothing: every product is f32 x f32 with f32 accumulation. NetVLAD's
// f32 route (row 8 of the kernel table) multiplies on the FMA units with
// this header, neither TF32 nor a bf16 split: the result is the f32
// product up to the order of the sums. The f32 routes of DBoF v2 and the
// MoE head (rows 1 and 2) moved to the tensor cores as a 3xTF32 product
// (hopper_gemm.cuh :: consume3), where this product lost to the f32 matmul
// graph; attention_pool.cu's products are [F, D] x [D, <= 16] and take
// their own loop.
//
// What bounds it: the card's f32 rate outside the tensor cores (67
// TFLOP/s on an H100 SXM). A chunk of 32 deep brings 2 x 128 x 32 floats
// into shared memory for 128 x 128 x 32 FMAs, 64 FMAs a float loaded, so
// the loads keep up from L2.
//
// Design (dequant_matmul.cu's f32 route, with the operands' loads made
// pluggable). 256 threads; thread (ty, tx) = (tid / 16, tid % 16) keeps
// 8 x 8 sums in registers: rows 4 ty + i and 64 + 4 ty + i, columns 4 tx
// + j and 64 + 4 tx + j (`row_of`, `col_of`), so the float4 reads of both
// panels are conflict-free. Both panels are depth-major in shared memory,
// A as [32 deep][128 rows] and B as [32 deep][128 columns], two buffers
// each (64 KB). A kernel hands `product` two loaders with
//
//   fetch(d0, panel): start the chunk at depth d0: into registers, or by
//                     cp.async straight into `panel` (the other buffer);
//   store(panel):     write what fetch left in registers into `panel`.
//
// The next chunk's fetch is issued before the current chunk's FMAs and
// its store after them, one __syncthreads a chunk. A loader zero-fills
// what lies past its operand's edges (rows, columns and depth), so the
// tile's sums there are exact zeros. After `product` returns every
// thread has passed the last chunk's barrier: the 64 KB may be reused.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32p {
namespace {

constexpr int kRows = 128;               // A rows (M) a tile
constexpr int kCols = 128;               // B columns (N) a tile
constexpr int kDepth = 32;               // depth a chunk
constexpr int kThreads = 256;
constexpr int kPanel = kDepth * kRows;   // floats of one panel (A or B)
constexpr int kSmemBytes = 4 * kPanel * 4;  // two buffers of A and of B: 64 KB

static_assert(kRows == kCols, "panels of one size");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared dst, the bytes past src_bytes zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Row of the tile that sum i of this thread belongs to (i < 8).
__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : 64) + 4 * (static_cast<int>(threadIdx.x) >> 4) + (i & 3);
}

// Column of the tile that sum j of this thread belongs to (j < 8).
__device__ __forceinline__ int col_of(int j) {
  return (j < 4 ? 0 : 64) + 4 * (static_cast<int>(threadIdx.x) & 15) + (j & 3);
}

// acc += a^T b over one chunk: a [kDepth][kRows], b [kDepth][kCols].
__device__ __forceinline__ void chunk_fma(const float* __restrict__ a, const float* __restrict__ b,
                                          float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * kRows + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * kRows + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * kCols + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(b + k * kCols + 64 + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc = A B over `depth` (any depth >= 0) for the block's tile; smem:
// kSmemBytes of shared memory, 16-byte aligned.
template <class LoadA, class LoadB>
__device__ __forceinline__ void product(LoadA& la, LoadB& lb, int depth, float* smem,
                                        float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float* sa = smem;
  float* sb = smem + 2 * kPanel;
  const int chunks = (depth + kDepth - 1) / kDepth;
  if (chunks == 0) return;
  la.fetch(0, sa);
  lb.fetch(0, sb);
  la.store(sa);
  lb.store(sb);
  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    float* a_next = sa + (buf ^ 1) * kPanel;
    float* b_next = sb + (buf ^ 1) * kPanel;
    if (c + 1 < chunks) {
      la.fetch((c + 1) * kDepth, a_next);
      lb.fetch((c + 1) * kDepth, b_next);
    }
    chunk_fma(sa + buf * kPanel, sb + buf * kPanel, acc);
    if (c + 1 < chunks) {
      la.store(a_next);
      lb.store(b_next);
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Loaders shared by the routes.
// ---------------------------------------------------------------------------

// A row-major f32 operand [rows, depth] whose tile row r (of kRows) is
// row row_ptr(r) (nullptr: a zero row), read as the depth-major A panel:
// thread t fetches 16 features of tile row t % 128 into registers
// (float4 loads when Vec: depth % 4 == 0 and 16-byte aligned rows) and
// stores them transposed, each through `f` (the element's affine, or
// none); features past the depth and zero rows store 0. Used for
// NetVLAD's frames.
template <bool Vec, class Elem>
struct RowsA {
  const float* row;  // this thread's row, or nullptr
  int depth;
  Elem f;            // f(value, feature) -> the A element
  float v[16];
  int d_next;

  __device__ __forceinline__ void fetch(int d0, float*) {
    const int d = d0 + (threadIdx.x >> 7) * 16;
    d_next = d;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (Vec) {
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row != nullptr && d + 4 * q < depth)
          x = __ldg(reinterpret_cast<const float4*>(row + d + 4 * q));
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dd = d + 4 * q + e;
          v[4 * q + e] = row != nullptr && dd < depth ? __ldg(row + dd) : 0.0f;
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* panel) {
    const int r = threadIdx.x & (kRows - 1);
    const int dl = (threadIdx.x >> 7) * 16;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int dd = d_next + e;
      panel[(dl + e) * kRows + r] = row != nullptr && dd < depth ? f(v[e], dd) : 0.0f;
    }
  }
};

// The same for uint8 rows: 16 bytes of tile row t % 128 in four
// registers (one 16-byte load when Vec: depth % 16 == 0), each byte
// through f(float(byte), feature) as it is stored; features past the
// depth and zero rows store 0.
template <bool Vec, class Elem>
struct BytesA {
  const uint8_t* row;
  int depth;
  Elem f;
  uint32_t w[4];
  int d_next;

  __device__ __forceinline__ void fetch(int d0, float*) {
    const int d = d0 + (threadIdx.x >> 7) * 16;
    d_next = d;
    if (Vec) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (row != nullptr && d < depth) q = __ldg(reinterpret_cast<const uint4*>(row + d));
      w[0] = q.x;
      w[1] = q.y;
      w[2] = q.z;
      w[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dd = d + 4 * i + e;
          if (row != nullptr && dd < depth) word |= static_cast<uint32_t>(__ldg(row + dd)) << (8 * e);
        }
        w[i] = word;
      }
    }
  }

  __device__ __forceinline__ void store(float* panel) {
    const int r = threadIdx.x & (kRows - 1);
    const int dl = (threadIdx.x >> 7) * 16;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int dd = d_next + e;
      const float x = static_cast<float>((w[e >> 2] >> (8 * (e & 3))) & 0xffu);
      panel[(dl + e) * kRows + r] = row != nullptr && dd < depth ? f(x, dd) : 0.0f;
    }
  }
};

// The element of f32 rows as it is.
struct Same {
  __device__ __forceinline__ float operator()(float x, int) const { return x; }
};

// x * scale + bias with one constant pair (the frames' dequantization),
// the multiply and the add each rounded (the plain version's two
// rounding points).
struct ConstAffine {
  float scale, bias;
  __device__ __forceinline__ float operator()(float x, int) const {
    return __fadd_rn(__fmul_rn(x, scale), bias);
  }
};

// A row-major f32 operand B [depth, ld] read as the B panel: columns n0 ..
// n0 + 127 (< cols) of depth rows d0 .. d0 + 31 (< depth). By cp.async
// (16 bytes, zero-filled past the edges; no registers held) when Vec:
// cols % 4 == 0, ld % 4 == 0, n0 % 4 == 0 and 16-byte aligned rows;
// else 16 scalar loads a thread into registers, stored after the FMAs.
template <bool Vec>
struct PanelB {
  const float* base;
  int depth, cols, ld, n0;
  float v[16];

  __device__ __forceinline__ void fetch(int d0, float* panel) {
    if (Vec) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = threadIdx.x + kThreads * i;  // float4 index in the panel
        const int rr = e / (kCols / 4);
        const int c = (e % (kCols / 4)) * 4;
        const bool ok = d0 + rr < depth && n0 + c < cols;
        cp_async16(panel + rr * kCols + c,
                   ok ? base + static_cast<size_t>(d0 + rr) * ld + n0 + c : base, ok ? 16 : 0);
      }
    } else {
      const int c = threadIdx.x & (kCols - 1);
      const int r0 = (threadIdx.x >> 7) * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int d = d0 + r0 + i;
        v[i] = d < depth && n0 + c < cols ? __ldg(base + static_cast<size_t>(d) * ld + n0 + c)
                                          : 0.0f;
      }
    }
  }

  __device__ __forceinline__ void store(float* panel) {
    if (!Vec) {
      const int c = threadIdx.x & (kCols - 1);
      const int r0 = (threadIdx.x >> 7) * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i) panel[(r0 + i) * kCols + c] = v[i];
    }
  }
};

// The 8 x 8 sums into a [kRows][kCols] f32 stage in shared memory (the
// product's 64 KB, after it returned), for epilogues that combine
// several threads' sums.
__device__ __forceinline__ void stage_tile(const float (&acc)[8][8], float* stage) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(stage + row_of(i) * kCols + col_of(4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
}

}  // namespace
}  // namespace f32p
