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
// and 2.5 GB of f32 output (0.75 ms at 3.35 TB/s): bound by operations,
// with an output large enough that storing it after the products would
// cost a third of the kernel. The f32 route (the 128 audio features,
// D = 128, N = 1024) is bound by the f32 rate outside the tensor cores
// (40 GFLOP, 0.60 ms at 67 TFLOP/s); its 629 MB of output take 0.19 ms.
//
// Design.
//  * bf16 route, three launches on the caller's stream: round_bf16
//    (input_affine.cuh) rounds w to bf16 into a [D, ldw] buffer from the
//    wrapper (the TPU kernel casts w in its body); input_affine
//    (input_affine.cuh) writes xa = bf16(x * scale + bias) (unfused
//    multiply and add, the plain version's two roundings) once into a
//    [M, D] bf16 buffer from the wrapper. Fused into the product the
//    affine would run once per column tile, 16 times over at N = 4096.
//    Then hopper_product.cuh's persistent TMA + wgmma product (128 x 256
//    tiles, the column tile fastest, a 3-stage ring, the f32 output
//    staged a quarter at a time and stored by TMA while the next tile's
//    mainloop runs; see there). A D that is no multiple of 64 is
//    zero-filled past D by both maps; an N that is no multiple of 4 (a
//    row stride TMA cannot store) is stored from the registers, masked.
//  * f32 route, one launch: dequant_gemm_f32, plain f32 FMAs (not TF32:
//    the TPU kernel computes in f32 and the route holds 1e-5). A block
//    computes 128 x 128 outputs, 8 x 8 a thread in registers (rows 4ty +
//    i and 64 + 4ty + i, columns 4tx + j and 64 + 4tx + j, so the float4
//    reads of both operands are conflict-free), over the depth in chunks
//    of 32. Each chunk's uint8 rows arrive as one 16-byte load a thread
//    (16 features of one row), the affine is applied once as they are
//    written to shared memory (transposed, a warp's 32 rows side by
//    side), and W's panel arrives by cp.async (16 bytes, zero-filled past
//    D and N; no registers held); the next chunk's copies are issued
//    before the current chunk's products (the uint8 into four registers,
//    written to the other of two shared buffers after them; one
//    __syncthreads a chunk). The output is stored in float4 rows. The
//    column tile runs fastest, so a row tile's uint8 is read from device
//    memory once and W (512 KB) stays in L2. A D or N that breaks the
//    16-byte loads takes the scalar loads of the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_product.cuh"
#include "input_affine.cuh"

namespace {

using bf16 = __nv_bfloat16;
using inaff::affine;

constexpr int kFM = 128;       // f32 route: block rows
constexpr int kFN = 128;       // block columns
constexpr int kFK = 32;        // depth a chunk
constexpr int kFThreads = 256;
constexpr int kFSmem = 2 * 2 * kFK * kFM * 4;  // two buffers of A and of W: 64 KB

using hgemm::cp_async16;

// Every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  hgemm::cp_async_commit();
  hgemm::cp_async_wait<0>();
}

// y [M, N] f32 = (x * scale + bias) [M, D] f32 @ w [D, N] f32. VecA:
// D % 16 == 0 (16-byte uint8 loads); VecW: N % 4 == 0 (float4 loads and
// stores).
template <bool VecA, bool VecW>
__global__ void __launch_bounds__(kFThreads, 2)
dequant_gemm_f32(const uint8_t* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ w,
                 float* __restrict__ y, int M, int D, int N) {
  extern __shared__ __align__(16) float fsmem[];
  float* sA = fsmem;                    // [2][kFK][kFM]: A transposed, rows contiguous
  float* sB = fsmem + 2 * kFK * kFM;    // [2][kFK][kFN]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_ct = (N + kFN - 1) / kFN;
  const int m0 = (blockIdx.x / n_ct) * kFM;
  const int n0 = (blockIdx.x % n_ct) * kFN;
  // A staging: row ar of the tile, features ad0 .. ad0 + 15 of the chunk.
  const int ar = tid & (kFM - 1);
  const int ad0 = (tid >> 7) * 16;
  const bool a_row = m0 + ar < M;
  const uint8_t* xrow = x + static_cast<size_t>(m0 + ar) * D;

  uint32_t pa[4];   // 16 uint8 of the next chunk

  auto load_a = [&](int d0) {
    const int d = d0 + ad0;
    if (VecA) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (a_row && d < D) v = __ldg(reinterpret_cast<const uint4*>(xrow + d));
      pa[0] = v.x; pa[1] = v.y; pa[2] = v.z; pa[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dd = d + 4 * i + e;
          if (a_row && dd < D) word |= static_cast<uint32_t>(__ldg(xrow + dd)) << (8 * e);
        }
        pa[i] = word;
      }
    }
  };

  // The affine once, as the 16 features are written (transposed) to the
  // buffer: four features at a time.
  auto store_a = [&](int d0, int buf) {
    float* a = sA + buf * kFK * kFM;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int d = d0 + ad0 + 4 * g;
      float4 sc = make_float4(0.0f, 0.0f, 0.0f, 0.0f), bi = sc;
      if (VecA) {
        if (d < D) {
          sc = __ldg(reinterpret_cast<const float4*>(scale + d));
          bi = __ldg(reinterpret_cast<const float4*>(bias + d));
        }
      } else {
        if (d < D) sc.x = __ldg(scale + d), bi.x = __ldg(bias + d);
        if (d + 1 < D) sc.y = __ldg(scale + d + 1), bi.y = __ldg(bias + d + 1);
        if (d + 2 < D) sc.z = __ldg(scale + d + 2), bi.z = __ldg(bias + d + 2);
        if (d + 3 < D) sc.w = __ldg(scale + d + 3), bi.w = __ldg(bias + d + 3);
      }
      const float s4[4] = {sc.x, sc.y, sc.z, sc.w};
      const float b4[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = static_cast<float>((pa[g] >> (8 * e)) & 0xffu);
        a[(ad0 + 4 * g + e) * kFM + ar] = a_row && d + e < D ? affine(v, s4[e], b4[e]) : 0.0f;
      }
    }
  };

  // W's [32][128] panel into a buffer: by cp.async (16 bytes, zero-filled
  // past D and N) when N % 4 == 0, else by scalar loads.
  auto copy_w = [&](int d0, int buf) {
    float* bb = sB + buf * kFK * kFN;
    if (VecW) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + kFThreads * i;  // float4 index in the panel
        const int rr = e / (kFN / 4);
        const int c = (e % (kFN / 4)) * 4;
        const bool ok = d0 + rr < D && n0 + c < N;
        cp_async16(bb + rr * kFN + c, ok ? w + static_cast<size_t>(d0 + rr) * N + n0 + c : w,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = 0; i < 16; ++i) {
        const int e = tid + kFThreads * i;
        const int rr = e / kFN;
        const int c = e % kFN;
        bb[e] = d0 + rr < D && n0 + c < N ? __ldg(w + static_cast<size_t>(d0 + rr) * N + n0 + c)
                                          : 0.0f;
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int chunks = (D + kFK - 1) / kFK;
  load_a(0);
  store_a(0, 0);
  copy_w(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) {
      load_a((c + 1) * kFK);
      copy_w((c + 1) * kFK, buf ^ 1);
    }
    const float* a = sA + buf * kFK * kFM;
    const float* bb = sB + buf * kFK * kFN;
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * kFM + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k * kFM + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bb + k * kFN + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bb + k * kFN + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (c + 1 < chunks) store_a((c + 1) * kFK, buf ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
    float* yrow = y + static_cast<size_t>(m) * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + 64 * half + 4 * tx;
      if (VecW) {
        if (n < N)
          *reinterpret_cast<float4*>(yrow + n) = make_float4(
              acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2], acc[i][4 * half + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) yrow[n + e] = acc[i][4 * half + e];
      }
    }
  }
}

template <bool VecA, bool VecW>
cudaError_t launch_f32(const void* x, const void* scale, const void* bias, const void* w, void* y,
                       int M, int D, int N, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(dequant_gemm_f32<VecA, VecW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((M + kFM - 1) / kFM) * ((N + kFN - 1) / kFN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dequant_gemm_f32<VecA, VecW><<<static_cast<unsigned>(blocks), kFThreads, kFSmem, st>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(w), static_cast<float*>(y), M, D,
      N);
  return cudaGetLastError();
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
  return static_cast<int>(
      hprod::launch_product(xa, w16, static_cast<float*>(y), 1, M, N, D, D, ldw, st));
}

// x [M, D] uint8; w [D, N] f32; y [M, N] f32.
extern "C" int yt8m_dequant_matmul_f32(const void* x, const void* scale, const void* bias,
                                       const void* w, void* y, int M, int D, int N,
                                       void* stream) {
  if (bad_shape(M, D, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_a = D % 16 == 0;
  const bool vec_w = N % 4 == 0;
  const cudaError_t err =
      vec_a ? (vec_w ? launch_f32<true, true>(x, scale, bias, w, y, M, D, N, st)
                     : launch_f32<true, false>(x, scale, bias, w, y, M, D, N, st))
            : (vec_w ? launch_f32<false, true>(x, scale, bias, w, y, M, D, N, st)
                     : launch_f32<false, false>(x, scale, bias, w, y, M, D, N, st));
  return static_cast<int>(err);
}

// The two routes' tiles: [bf16 rows a tile, bf16 columns a tile, bf16
// ring stages, bf16 shared bytes requested, f32 rows a tile, f32 columns
// a tile, f32 depth a chunk, f32 shared bytes, SMs (the bf16 persistent
// grid's cap)].
extern "C" int yt8m_dequant_plan(int* plan) {
  int sms = 0;
  const cudaError_t err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = hgemm::kRows;
  plan[1] = hprod::kBN;
  plan[2] = hprod::kStages;
  plan[3] = hprod::kSmemRequest;
  plan[4] = kFM;
  plan[5] = kFN;
  plan[6] = kFK;
  plan[7] = kFSmem;
  plan[8] = sms;
  return static_cast<int>(cudaSuccess);
}
