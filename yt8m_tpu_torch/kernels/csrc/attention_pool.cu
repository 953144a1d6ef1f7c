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
// the first min(n, F) frames are read. For n <= 0 every score is -1e9
// and the softmax is uniform: attn = 1/F over all F frames, the mean that
// the JAX package's reference and the model's graph take (its TPU kernel
// pads F to a multiple of 8 and averages the padded rows too).
//
// What bounds it: the bytes. At B=512, F=300, D=1152, H=8 the live
// uint8 frames are ~89 MB and the output 19 MB (0.034 ms at 3.35 TB/s);
// the two products are 2.8 GFLOP, 3 us on the tensor cores. The softmax
// over a video's frames needs every score before any frame is pooled, so
// the frames are read twice: the design keeps the second read on chip.
//  * A persistent grid, a block an SM: a block's first video is its
//    index, the next ones come from a counter in device memory (live
//    lengths run 1-300; a fixed order would leave SMs idle at the end),
//    each taken as soon as the last one's loads are issued. The block's
//    last producer resets the counter.
//  * One producer thread keeps a ring of 16-frame stages filled, one TMA
//    load a stage: a 4-D tensor map over the frames (128-byte lines, the
//    lines of a row, F rows, B videos) with the 128-byte swizzle, a box
//    of [16 rows][an odd number of lines][128 bytes] (a row's last line
//    past D reads as zeros). The swizzle XORs a line's 16-byte unit with
//    its index mod 8, and an odd line count puts eight rows' same bytes on
//    eight distinct units: the warps' fragment loads fall on distinct
//    banks. Rows past the video's end in its last tile are read and never
//    used. (On an H100 80GB HBM3 at 700 W, one bulk copy a row issued too
//    slowly: 0.1225 ms against 0.0956 for one unswizzled copy a stage with
//    its bank conflicts; 16-byte cp.async copies by a producer warp took
//    0.1988.)
//  * Pass 1 (scores), a consumer warp a 16-frame tile (the warp of the
//    tile's stage: at most 12 stages, one a warp), on mma.sync
//    m16n8k16 (bf16 in, f32 sums): the A fragments come straight from
//    the stage (16 bytes of a row a thread, dequantized with the affine's
//    own rounding points and rounded to bf16x2), the columns of a 64-wide
//    chunk taken in an order that gives each thread 16 contiguous bytes
//    (a sum's order is free: Q is laid out in shared memory in the same
//    order, once a block). 8 heads are one n8 tile, 16 two.
//  * The last `kept` tiles of pass 1 (as many as the ring holds) stay in
//    their stages; the softmax runs over the live rows in shared memory
//    (max, expf, sum, bf16(e / s)); pass 2 pools those tiles first, then
//    the ring brings the video's first tiles back, from L2: with one
//    video in flight an SM, at most ~45 MB of frames are live on the
//    card. A video of up to 16 * stages frames is read from device
//    memory once.
//  * Pass 2 (pooling), every consumer warp on its 32-column groups of
//    every tile: pooled^T [D, H] = x^T attn, mma.sync with the columns as
//    M (a thread's 4 bytes of 4 frames give two m16 tiles' fragments)
//    and the heads as N: the f32 sums stay in registers across the tiles
//    and go out as 16-byte stores.
//  * The producer takes the next video as soon as this one's loads are
//    issued and runs ahead into it while this one pools. (Prefetching a
//    video's rows into L2 when it is taken made the kernel slower on the
//    same card: uint8 0.1130 ms against 0.1071, f32 0.3668 against
//    0.2637.)
//
// The f32 route (--compute_dtype=float32, Q f32): the same function with
// nothing rounded to bf16, as the TPU kernel computes it at dtype=float32,
// in the same kernel (its F32 instance: the persistent grid, the ring,
// the walk, the kept tiles), both products on the TF32 tensor cores as
// 3xTF32 (mma.sync.m16n8k8; each operand v split into big = tf32(v) and
// small = tf32(v - big), a product summed as a_small b_big + a_big b_small
// + a_big b_big, about 2^-21 of each product from the f32 product).
// Bound by the bytes at the serving shape (B=512, D=1152, 8 heads): 4 x 8
// x 1152 FLOP a frame read, 3.0 GFLOP for 80,000 frames, three TF32
// products 0.018 ms at 494.7 TFLOP/s (one f32 product 0.044 ms at the 67
// TFLOP/s outside the tensor cores), the uint8 frames and the output
// 0.033 ms at 3.35 TB/s. What differs from the bf16 instance:
//  * Q f32 in fragment order (36 KB at D=1152, 8 heads), split into its
//    halves as a fragment is loaded (three instructions a value): both
//    halves would leave one stage of f32 frames at D=1152. Eight heads a
//    launch (a launch a group of 8 heads): two n8 tiles in f32 leave pass
//    2 short of registers and f32 frames at D=1152 one stage.
//  * Pass 1: a thread's 8 contiguous columns of a 32-column chunk (four
//    k8 steps) of its two rows, split in registers; each chunk summed in
//    fresh registers and added on the FMA units.
//  * The softmax in f32 (expf, a correctly rounded division), the
//    attention stored split, both halves f32 [heads][frames].
//  * Pass 2: a thread's 4 contiguous columns of four frames (two k8
//    steps) give both m16 tiles' fragments, each 16-frame tile summed in
//    fresh registers and added on the FMA units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using hgemm::bar_arrive;
using hgemm::bar_expect;
using hgemm::bar_init;
using hgemm::bar_init_fence;
using hgemm::bar_wait;
using hgemm::named_sync;
using hgemm::smem_u32;

constexpr int kRows = 16;       // frames a stage (an mma's M in pass 1, K in pass 2)
constexpr int kWarps = 12;      // consumer warps; one producer warp more
constexpr int kThreads = (kWarps + 1) * 32;
constexpr int kChunk = 64;      // columns a pass-1 step (4 k16 steps)
constexpr int kLine = 128;      // bytes a swizzled line
constexpr int kGroup = 32;      // columns a pass-2 group (2 m16 tiles)
constexpr int kMaxGroups = 6;   // groups a consumer warp pools: D <= 2304
constexpr int kMaxStages = kWarps;  // a stage's pass-1 tiles go to one warp
constexpr int kSmemLimit = 232448;
constexpr int kBarrierBytes = 24 * kMaxStages;  // full, empty, header a stage
constexpr int kAlign = 1024;    // the 128-byte swizzle's atom: a stage's alignment
// The dequantize affine in f32, as PyTorch takes the Python constants.
constexpr float kScale = static_cast<float>(4.0 / 255.0);
constexpr float kBias = static_cast<float>(4.0 / 512.0 - 2.0);
constexpr float kMagic = 8388608.0f;          // 2^23: 2^23 + u as a float's bits
constexpr float kMagicScale = kScale * kMagic;  // exact: kScale times a power of two

// The layout of a launch's shared memory (the host's plan and the
// kernel's pointers), from a 1024-byte aligned base: the stages, Q in
// fragment order, the scores, the bf16 attention, the barriers.
struct Layout {
  int lines;        // 128-byte lines a stage row: D * esize / 128, made odd
  int stage_bytes;
  int f16;          // F rounded up to 16: the scores' pitch (floats)
  int attn_pitch;   // a head's attention row: >= f16; bf16: 8 mod 64, f32: 4 mod 32
  int q_off;
  int scores_off;
  int attn_off;
  int bar_off;
  int stages;
  int smem;         // the request: the layout and the alignment's slack
};

// f32: the f32 route's layout (Q f32, the attention's two f32 halves).
__host__ __device__ inline Layout layout(int F, int D, int esize, int nt, bool f32) {
  Layout p;
  const int heads = 8 * nt;
  p.lines = (D * esize / kLine) | 1;
  p.stage_bytes = kRows * p.lines * kLine;
  p.f16 = (F + 15) / 16 * 16;
  p.attn_pitch = f32 ? p.f16 + ((4 - p.f16 % 32) + 32) % 32 : p.f16 + ((8 - p.f16 % 64) + 64) % 64;
  const int q_bytes = (f32 ? 32 : 16) * D * nt;
  const int attn_bytes = (f32 ? 8 : 2) * heads * p.attn_pitch;
  const int fixed = q_bytes + 4 * heads * p.f16 + attn_bytes + 8 + kBarrierBytes;
  const int room = (kSmemLimit - kAlign - fixed) / p.stage_bytes;
  p.stages = room < kMaxStages ? room : kMaxStages;
  p.q_off = p.stages * p.stage_bytes;
  p.scores_off = p.q_off + q_bytes;
  p.attn_off = p.scores_off + 4 * heads * p.f16;
  p.bar_off = (p.attn_off + attn_bytes + 7) / 8 * 8;
  p.smem = p.bar_off + kBarrierBytes + kAlign;
  return p;
}

// Byte b of row r in a stage: the row's lines are `lines` 128-byte lines,
// each line's 16-byte units XORed with the line's index mod 8.
__device__ __forceinline__ int swizzled(int r, int b, int lines) {
  const int line = r * lines + (b >> 7);
  return (line << 7) | ((((b >> 4) & 7) ^ (line & 7)) << 4) | (b & 15);
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// bf16x2 of (lo, hi), each rounded to nearest even: lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte e of w dequantized: fma(2^23 + u, s, -2^23 s) is u * s rounded
// once, as __fmul_rn(u, s); then + bias rounded (the plain version's two
// rounding points). The bf16 rounding follows in pack_bf16.
template <int E>
__device__ __forceinline__ float dequant(uint32_t w) {
  const float f = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | E));
  return __fadd_rn(__fmaf_rn(f, kScale, -kMagicScale), kBias);
}

__device__ __forceinline__ void dequant4(uint32_t w, float* x) {
  x[0] = dequant<0>(w);
  x[1] = dequant<1>(w);
  x[2] = dequant<2>(w);
  x[3] = dequant<3>(w);
}

// Columns 16 q .. 16 q + 15 of chunk j (64 columns) of stage row r, as
// f32 values.
__device__ __forceinline__ void cols16(const uint8_t*, const unsigned char* st, int r, int j,
                                       int q, int lines, float* x) {
  const uint4 w = *reinterpret_cast<const uint4*>(st + swizzled(r, 64 * j + 16 * q, lines));
  dequant4(w.x, x);
  dequant4(w.y, x + 4);
  dequant4(w.z, x + 8);
  dequant4(w.w, x + 12);
}
__device__ __forceinline__ void cols16(const float*, const unsigned char* st, int r, int j, int q,
                                       int lines, float* x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(
        st + swizzled(r, 4 * (64 * j + 16 * q) + 16 * i, lines));
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

// Columns c .. c + 3 of stage row r.
__device__ __forceinline__ void cols4(const uint8_t*, const unsigned char* st, int r, int c,
                                      int lines, float* x) {
  dequant4(*reinterpret_cast<const uint32_t*>(st + swizzled(r, c, lines)), x);
}
__device__ __forceinline__ void cols4(const float*, const unsigned char* st, int r, int c,
                                      int lines, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(st + swizzled(r, 4 * c, lines));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// Columns 32 j + 8 q .. 32 j + 8 q + 7 of stage row r (the f32 route's
// pass 1), as f32 values.
__device__ __forceinline__ void cols8(const uint8_t*, const unsigned char* st, int r, int j,
                                      int q, int lines, float* x) {
  const uint2 w = *reinterpret_cast<const uint2*>(st + swizzled(r, 32 * j + 8 * q, lines));
  dequant4(w.x, x);
  dequant4(w.y, x + 4);
}
__device__ __forceinline__ void cols8(const float*, const unsigned char* st, int r, int j, int q,
                                      int lines, float* x) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 v =
        *reinterpret_cast<const float4*>(st + swizzled(r, 128 * j + 32 * q + 16 * i, lines));
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
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

// Grid: min(B, SMs) persistent blocks of kThreads. frames: the 4-D map
// (D * sizeof(T) a multiple of 128); heads h0 .. h0 + H - 1 (H <= 8 * NT)
// of a query [D, hq] (bf16; F32: f32) and of out [B, hq, D]. counter: two
// zeros, left at zero.
template <typename T, int NT, bool F32>
__global__ void __launch_bounds__(kThreads, 1)
attention_pool_kernel(const __grid_constant__ CUtensorMap frames,
                      const int* __restrict__ num_frames, const void* __restrict__ query,
                      float* __restrict__ out, unsigned* __restrict__ counter, int B, int F, int D,
                      int H, int h0, int hq) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hgemm::aligned_smem(smem_raw);
  constexpr int kHeads = 8 * NT;
  const Layout p = layout(F, D, static_cast<int>(sizeof(T)), NT, F32);
  const int S = p.stages;
  unsigned char* stages = smem;
  const uint4* qf = reinterpret_cast<const uint4*>(smem + p.q_off);      // bf16
  const float4* qf32 = reinterpret_cast<const float4*>(smem + p.q_off);  // F32
  float* scores = reinterpret_cast<float*>(smem + p.scores_off);  // [kHeads][f16]
  __nv_bfloat16* attn = reinterpret_cast<__nv_bfloat16*>(smem + p.attn_off);
  float* attn_big = reinterpret_cast<float*>(smem + p.attn_off);  // F32: [kHeads][pitch] each
  float* attn_small = attn_big + kHeads * p.attn_pitch;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + kMaxStages;
  int2* header = reinterpret_cast<int2*>(empty + kMaxStages);  // the stage's video, its num_frames
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kWarps);
    }
    bar_init_fence();
  }
  if constexpr (F32) {
    // Q in fragment order: float r of thread l's float4 `half` of (chunk
    // j, n tile nt) is Q row (column of x) 32 j + 8 (l % 4) + 4 half + r,
    // which k8 step (4 half + r) / 2 reads as b0 (r even) or b1, for head
    // 8 nt + l / 4.
    float* qw = reinterpret_cast<float*>(smem + p.q_off);
    const float* qv = static_cast<const float*>(query);
    const int words = D / 32 * NT * 256;
    for (int i = threadIdx.x; i < words; i += kThreads) {
      const int r = i & 3, l = (i >> 2) & 31, half = (i >> 7) & 1, rest = i >> 8;
      const int j = rest / NT, nt = rest - j * NT;
      const int col = 32 * j + 8 * (l & 3) + 4 * half + r;
      const int h = 8 * nt + (l >> 2);
      qw[i] = h < H ? qv[static_cast<size_t>(col) * hq + h0 + h] : 0.0f;
    }
    for (int i = threadIdx.x; i < 2 * kHeads * p.attn_pitch; i += kThreads) attn_big[i] = 0.0f;
  } else {
    // Q in fragment order: word r of thread l's uint4 `half` of (chunk j,
    // n tile nt) holds the pair of Q rows (columns of x) that its k step
    // 2 half + r / 2 reads as b0 (r even) or b1, for head 8 nt + l / 4.
    uint32_t* qw = reinterpret_cast<uint32_t*>(smem + p.q_off);
    const __nv_bfloat16* qv = static_cast<const __nv_bfloat16*>(query);
    const int words = D / kChunk * NT * 256;
    for (int i = threadIdx.x; i < words; i += kThreads) {
      const int r = i & 3, l = (i >> 2) & 31, half = (i >> 7) & 1, rest = i >> 8;
      const int j = rest / NT, nt = rest - j * NT;
      const int col = kChunk * j + 16 * (l & 3) + 4 * (2 * half + (r >> 1)) + 2 * (r & 1);
      const int h = 8 * nt + (l >> 2);
      uint32_t lo = 0, hi = 0;
      if (h < H) {
        lo = __bfloat16_as_ushort(qv[static_cast<size_t>(col) * hq + h0 + h]);
        hi = __bfloat16_as_ushort(qv[static_cast<size_t>(col + 1) * hq + h0 + h]);
      }
      qw[i] = lo | (hi << 16);
    }
    for (int i = threadIdx.x; i < kHeads * p.attn_pitch; i += kThreads)
      attn[i] = __float2bfloat16_rn(0.0f);
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer
    if (lane == 0) {
      // A block's first video is blockIdx.x; the next ones come from the
      // counter, each taken as soon as the last one's loads are issued.
      uint32_t L = 0;  // loads issued
      int v = blockIdx.x, n = num_frames[v];
      while (v < B) {
        const int rows = n <= 0 ? F : min(n, F);
        const int tiles = (rows + kRows - 1) / kRows;
        const int p1 = n > 0 ? tiles : 0;            // pass 1's loads
        const int kept = n > 0 ? min(tiles, S) : 0;  // tiles pass 2 finds in place
        const int loads = p1 + tiles - kept;
        for (int j = 0; j < loads; ++j, ++L) {
          const int slot = L % S;
          bar_wait(&empty[slot], ((L / S) & 1) ^ 1);
          const int t = j < p1 ? j : j - p1;
          header[slot] = make_int2(v, n);
          bar_expect(&full[slot], p.stage_bytes);
          tma_4d(stages + slot * p.stage_bytes, &frames, &full[slot], 0, 0, kRows * t, v);
        }
        v = static_cast<int>(gridDim.x + atomicAdd(counter, 1u));
        n = v < B ? num_frames[v] : 0;
      }
      const int slot = L % S;  // none left: the consumers' stop
      bar_wait(&empty[slot], ((L / S) & 1) ^ 1);
      header[slot] = make_int2(-1, 0);
      bar_arrive(&full[slot]);
      __threadfence();
      if (atomicAdd(counter + 1, 1u) == gridDim.x - 1) {  // every block has taken its last
        atomicExch(counter, 0u);
        atomicExch(counter + 1, 0u);
      }
    }
    return;
  }

  // The consumers.
  const int ngroups = (D / kGroup - warp + kWarps - 1) / kWarps;  // pass 2's groups of this warp
  const T* none = nullptr;  // picks the loads for T
  uint32_t L = 0;  // the video's first load
  for (;;) {
    int slot = L % S;
    bar_wait(&full[slot], (L / S) & 1);
    const int2 video = header[slot];
    named_sync(1, kWarps * 32);  // every warp has it before a stage of it is released
    const int v = video.x, n = video.y;
    if (v < 0) break;
    const int rows = n <= 0 ? F : min(n, F);
    const int tiles = (rows + kRows - 1) / kRows;
    const int p1 = n > 0 ? tiles : 0;
    const int kept = n > 0 ? min(tiles, S) : 0;

    // Pass 1: a tile to the warp of its stage; scores[h][frame] for the
    // live frames. A stage's pass-1 loads always go to the same warp, so
    // the warp that waits on a load has waited on the stage's load before
    // it: an mbarrier's parity tells one phase from the next, not from the
    // one after (a wait two phases ahead would pass at once).
    for (int t = 0; t < p1; ++t) {
      const uint32_t lt = L + t;
      slot = lt % S;
      if (slot != warp) continue;
      bar_wait(&full[slot], (lt / S) & 1);
      const unsigned char* st = stages + slot * p.stage_bytes;
      float sc[NT][4];  // the scores: (frame g (+8), heads 2q, 2q + 1)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
      if constexpr (F32) {
        // A 32-column chunk (four k8 steps) summed in fresh registers,
        // added to sc on the FMA units. k8 step s reads the thread's
        // columns 2s (k = q) and 2s + 1 (k = q + 4) of its eight.
        for (int j = 0; j < D / 32; ++j) {
          float xa[8], xb[8];
          cols8(none, st, g, j, q, p.lines, xa);
          cols8(none, st, g + 8, j, q, p.lines, xb);
          float qv[NT][8];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float4 lo = qf32[((j * NT + nt) * 2) * 32 + lane];
            const float4 hi = qf32[((j * NT + nt) * 2 + 1) * 32 + lane];
            qv[nt][0] = lo.x; qv[nt][1] = lo.y; qv[nt][2] = lo.z; qv[nt][3] = lo.w;
            qv[nt][4] = hi.x; qv[nt][5] = hi.y; qv[nt][6] = hi.z; qv[nt][7] = hi.w;
          }
          float part[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[nt][e] = 0.0f;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float a[4] = {xa[2 * s], xb[2 * s], xa[2 * s + 1], xb[2 * s + 1]};
            float ab[4], as[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) hgemm::tf32_split(a[e], ab[e], as[e]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              float bb[2], bs[2];
              hgemm::tf32_split(qv[nt][2 * s], bb[0], bs[0]);
              hgemm::tf32_split(qv[nt][2 * s + 1], bb[1], bs[1]);
              hgemm::mma16x8_3xtf32(part[nt], ab, as, bb, bs);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[nt][e] += part[nt][e];
        }
      } else {
        float acc[4][NT][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.0f;
        for (int j = 0; j < D / kChunk; ++j) {
          float xa[16], xb[16];
          cols16(none, st, g, j, q, p.lines, xa);
          cols16(none, st, g + 8, j, q, p.lines, xb);
          uint4 bq[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            bq[nt][0] = qf[((j * NT + nt) * 2) * 32 + lane];
            bq[nt][1] = qf[((j * NT + nt) * 2 + 1) * 32 + lane];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t a0 = pack_bf16(xa[4 * i], xa[4 * i + 1]);
            const uint32_t a1 = pack_bf16(xb[4 * i], xb[4 * i + 1]);
            const uint32_t a2 = pack_bf16(xa[4 * i + 2], xa[4 * i + 3]);
            const uint32_t a3 = pack_bf16(xb[4 * i + 2], xb[4 * i + 3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint4 b = bq[nt][i >> 1];
              mma(acc[i][nt], a0, a1, a2, a3, (i & 1) ? b.z : b.x, (i & 1) ? b.w : b.y);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[nt][e] = (acc[0][nt][e] + acc[1][nt][e]) + (acc[2][nt][e] + acc[3][nt][e]);
      }
      __syncwarp();
      if (t < tiles - kept && lane < kWarps) bar_arrive(&empty[slot]);  // all kWarps arrivals
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 8 * nt + 2 * q + (e & 1);
          const int f = kRows * t + g + 8 * (e >> 1);
          if (h < H && f < rows) scores[h * p.f16 + f] = sc[nt][e];
        }
      }
    }
    named_sync(1, kWarps * 32);

    // The softmax over the live frames, a warp a head; attn rounded to
    // bf16 (F32: split into its tf32 halves), zero from `rows` to the last
    // tile's end.
    for (int h = warp; h < H; h += kWarps) {
      float* sc = scores + h * p.f16;
      __nv_bfloat16* at = attn + h * p.attn_pitch;
      float* ab = attn_big + h * p.attn_pitch;
      float* as = attn_small + h * p.attn_pitch;
      if (n <= 0) {  // every score -1e9: exp(0) / F
        const float u = __fdiv_rn(1.0f, static_cast<float>(F));
        float ub, us;
        hgemm::tf32_split(u, ub, us);
        for (int f = lane; f < kRows * tiles; f += 32) {
          if constexpr (F32) {
            ab[f] = f < F ? ub : 0.0f;
            as[f] = f < F ? us : 0.0f;
          } else {
            at[f] = __float2bfloat16_rn(f < F ? u : 0.0f);
          }
        }
        continue;
      }
      float m = -INFINITY;
      for (int f = lane; f < rows; f += 32) m = fmaxf(m, sc[f]);
      m = warp_max(m);
      float s = 0.0f;
      for (int f = lane; f < rows; f += 32) {
        const float e = expf(__fsub_rn(sc[f], m));
        sc[f] = e;
        s += e;
      }
      s = warp_sum(s);
      for (int f = lane; f < kRows * tiles; f += 32) {
        const float a = f < rows ? __fdiv_rn(sc[f], s) : 0.0f;
        if constexpr (F32)
          hgemm::tf32_split(a, ab[f], as[f]);
        else
          at[f] = __float2bfloat16_rn(a);
      }
    }
    named_sync(1, kWarps * 32);

    // Pass 2: every warp its 32-column groups of every tile, the kept
    // tiles first. acc[gi][m][nt]: columns 32 grp + 4 g + 2 m (+1 for the
    // second row half) x heads 8 nt + 2 q (+1).
    float acc[kMaxGroups][2][NT][4];
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gi][m][nt][e] = 0.0f;
    for (int i = 0; i < tiles; ++i) {
      const int t = i < kept ? tiles - kept + i : i - kept;
      const uint32_t lt = i < kept ? L + t : L + p1 + t;
      slot = lt % S;
      bar_wait(&full[slot], (lt / S) & 1);
      const unsigned char* st = stages + slot * p.stage_bytes;
      const bool partial = kRows * (t + 1) > rows;
      if constexpr (F32) {
        // B: the attention's halves at (frame 8 s + q (+4), head 8 nt + g);
        // A: x^T, the thread's columns col .. col + 3 of stage rows q + 4 m
        // (m = 2 s + frame half), the m16 tiles' rows g (columns + 2 mi)
        // and g + 8 (+ 2 mi + 1).
        float bb[2][NT][2], bs[2][NT][2];
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int at_i = (8 * nt + g) * p.attn_pitch + kRows * t + 8 * s2 + q + 4 * e;
              bb[s2][nt][e] = attn_big[at_i];
              bs[s2][nt][e] = attn_small[at_i];
            }
        const int f0 = kRows * t + q;  // this thread's frames: f0 + 4 m
#pragma unroll
        for (int gi = 0; gi < kMaxGroups; ++gi) {
          if (gi >= ngroups) break;
          const int col = kGroup * (warp + kWarps * gi) + 4 * g;
          float x[4][4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            cols4(none, st, q + 4 * m, col, p.lines, x[m]);
            if (partial && f0 + 4 * m >= rows) {  // rows past the video's end: zeros
#pragma unroll
              for (int e = 0; e < 4; ++e) x[m][e] = 0.0f;
            }
          }
          float part[2][NT][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[mi][nt][e] = 0.0f;
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const float a[4] = {x[2 * s2][2 * mi], x[2 * s2][2 * mi + 1], x[2 * s2 + 1][2 * mi],
                                  x[2 * s2 + 1][2 * mi + 1]};
              float ab[4], as[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) hgemm::tf32_split(a[e], ab[e], as[e]);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                hgemm::mma16x8_3xtf32(part[mi][nt], ab, as, bb[s2][nt], bs[s2][nt]);
            }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[gi][mi][nt][e] += part[mi][nt][e];
        }
      } else {
        uint32_t b0[NT], b1[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* at = attn + (8 * nt + g) * p.attn_pitch + kRows * t + 2 * q;
          b0[nt] = *reinterpret_cast<const uint32_t*>(at);
          b1[nt] = *reinterpret_cast<const uint32_t*>(at + 8);
        }
        const int f0 = kRows * t + 2 * q;  // this thread's frames: f0, +1, +8, +9
#pragma unroll
        for (int gi = 0; gi < kMaxGroups; ++gi) {
          if (gi >= ngroups) break;
          const int col = kGroup * (warp + kWarps * gi) + 4 * g;
          float x0[4], x1[4], x2[4], x3[4];
          cols4(none, st, 2 * q, col, p.lines, x0);
          cols4(none, st, 2 * q + 1, col, p.lines, x1);
          cols4(none, st, 2 * q + 8, col, p.lines, x2);
          cols4(none, st, 2 * q + 9, col, p.lines, x3);
          if (partial) {  // rows past the video's end: zeros
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              x0[e] = f0 < rows ? x0[e] : 0.0f;
              x1[e] = f0 + 1 < rows ? x1[e] : 0.0f;
              x2[e] = f0 + 8 < rows ? x2[e] : 0.0f;
              x3[e] = f0 + 9 < rows ? x3[e] : 0.0f;
            }
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const uint32_t a0 = pack_bf16(x0[2 * m], x1[2 * m]);
            const uint32_t a1 = pack_bf16(x0[2 * m + 1], x1[2 * m + 1]);
            const uint32_t a2 = pack_bf16(x2[2 * m], x3[2 * m]);
            const uint32_t a3 = pack_bf16(x2[2 * m + 1], x3[2 * m + 1]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma(acc[gi][m][nt], a0, a1, a2, a3, b0[nt], b1[nt]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[slot]);
    }
    float* ov = out + (static_cast<size_t>(v) * hq + h0) * D;
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      if (gi >= ngroups) break;
      const int col = kGroup * (warp + kWarps * gi) + 4 * g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int h = 8 * nt + 2 * q + e;
          if (h < H)
            *reinterpret_cast<float4*>(ov + static_cast<size_t>(h) * D + col) =
                make_float4(acc[gi][0][nt][e], acc[gi][0][nt][2 + e], acc[gi][1][nt][e],
                            acc[gi][1][nt][2 + e]);
        }
      }
    }
    L += p1 + tiles - kept;
  }
}

// The frames [B, F, D] as a 4-D map (128-byte lines, the lines of a row,
// F rows, B videos), boxes of [1 video][16 rows][lines][128 bytes] with
// the 128-byte swizzle; the box's odd line count may pass the row's end
// (read as zeros).
template <typename T>
cudaError_t frames_map(CUtensorMap* map, const void* frames, int B, int F, int D, int lines) {
  const hgemm::EncodeTiled encode = hgemm::encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const uint64_t row = static_cast<uint64_t>(D) * sizeof(T);
  const cuuint64_t dims[4] = {kLine / sizeof(T), row / kLine, static_cast<cuuint64_t>(F),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {kLine, row, row * F};
  const cuuint32_t box[4] = {kLine / sizeof(T), static_cast<cuuint32_t>(lines), kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
      const_cast<void*>(frames), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Heads h0 .. h0 + H - 1 of hq in one launch.
template <typename T, int NT, bool F32>
int launch(const void* frames, const void* num_frames, const void* query, void* out,
           void* counter, int B, int F, int D, int H, int h0, int hq, void* stream) {
  const Layout p = layout(F, D, static_cast<int>(sizeof(T)), NT, F32);
  if (p.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  cudaError_t err = frames_map<T>(&map, frames, B, F, D, p.lines);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = attention_pool_kernel<T, NT, F32>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B < sms ? B : sms, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const int*>(num_frames), query, static_cast<float*>(out),
      static_cast<unsigned*>(counter), B, F, D, H, h0, hq);
  return static_cast<int>(cudaGetLastError());
}

bool takes(int B, int F, int D, int esize, int H) {
  return B > 0 && F > 0 && D > 0 && D % kChunk == 0 && (D * esize) % kLine == 0 && H >= 1 &&
         H <= 16 && (D / kGroup + kWarps - 1) / kWarps <= kMaxGroups;
}

template <typename T>
int dispatch(const void* frames, const void* num_frames, const void* query, void* out,
             void* counter, int B, int F, int D, int H, void* stream) {
  if (!takes(B, F, D, static_cast<int>(sizeof(T)), H))
    return static_cast<int>(cudaErrorInvalidValue);
  if (H <= 8)
    return launch<T, 1, false>(frames, num_frames, query, out, counter, B, F, D, H, 0, H, stream);
  return launch<T, 2, false>(frames, num_frames, query, out, counter, B, F, D, H, 0, H, stream);
}

// The f32 route: eight heads a launch, the launches one after another on
// the stream (each leaves the counter at zero).
template <typename T>
int dispatch_f32(const void* frames, const void* num_frames, const void* query, void* out,
                 void* counter, int B, int F, int D, int H, void* stream) {
  if (!takes(B, F, D, static_cast<int>(sizeof(T)), H))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int h0 = 0; h0 < H; h0 += 8) {
    const int code = launch<T, 1, true>(frames, num_frames, query, out, counter, B, F, D,
                                        H - h0 < 8 ? H - h0 : 8, h0, H, stream);
    if (code != 0) return code;
  }
  return 0;
}

}  // namespace

// frames [B, F, D] uint8 with D a multiple of 128 (or f32, of 64), num_frames [B]
// int32, query [D, H] bf16 with H <= 16, out [B, H, D] f32, counter two
// unsigned zeros (left at zero when the launch ends). One launch on
// `stream`.
extern "C" int yt8m_attention_pool_u8(const void* frames, const void* num_frames,
                                      const void* query, void* out, void* counter, int B, int F,
                                      int D, int H, void* stream) {
  return dispatch<uint8_t>(frames, num_frames, query, out, counter, B, F, D, H, stream);
}

extern "C" int yt8m_attention_pool_f32(const void* frames, const void* num_frames,
                                       const void* query, void* out, void* counter, int B, int F,
                                       int D, int H, void* stream) {
  return dispatch<float>(frames, num_frames, query, out, counter, B, F, D, H, stream);
}

// The f32 route (query [D, H] f32, H <= 16): the same operands, a launch a
// group of 8 heads on `stream`.
extern "C" int yt8m_attention_pool_f32q_u8(const void* frames, const void* num_frames,
                                          const void* query, void* out, void* counter, int B,
                                          int F, int D, int H, void* stream) {
  return dispatch_f32<uint8_t>(frames, num_frames, query, out, counter, B, F, D, H, stream);
}

extern "C" int yt8m_attention_pool_f32q_f32(const void* frames, const void* num_frames,
                                           const void* query, void* out, void* counter, int B,
                                           int F, int D, int H, void* stream) {
  return dispatch_f32<float>(frames, num_frames, query, out, counter, B, F, D, H, stream);
}

// The compiled kernel's plan for frames [*, F, D] of `esize` bytes and H
// heads (f32: the f32 route's): the layout, the block and the card's SMs.
extern "C" int yt8m_attention_pool_plan(int F, int D, int H, int esize, int f32, int* plan) {
  const int nt = f32 || H <= 8 ? 1 : 2;
  const Layout p = layout(F, D, esize, nt, f32 != 0);
  int sms = 0;
  const cudaError_t err = hgemm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int values[] = {kRows, p.lines,  p.stage_bytes, p.stages,   p.smem,     p.f16,
                        p.attn_pitch, kWarps, kMaxGroups, kMaxStages, nt, sms};
  for (int i = 0; i < 12; ++i) plan[i] = values[i];
  return static_cast<int>(cudaSuccess);
}
