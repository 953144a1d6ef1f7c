// The shared TMA + wgmma mainloop of the port's Hopper products (sm_90a):
// dbof.cu (the DBoF cluster product, bf16 and 3xTF32), dbof_int8.cu (the
// same on the integer wgmma: uint8 x int8, int32 sums, mma_u8s8_256),
// moe_head.cu (the MoE head's gate and expert products, bf16 and 3xTF32),
// hopper_product.cuh (the
// plain product with a TMA-store epilogue: dequant_matmul.cu,
// netvlad_train.cu's dx), netvlad_train.cu (the VLAD core's forward and
// backward products), netvlad.cu (the serving VLAD's assignment and
// aggregation, and its f32 route's assignment), nextvlad.cu,
// nextvlad_train.cu and hopper_gemm.cu (the plain products of the card
// tests).
//
// A block is three warpgroups. Warpgroups 0 and 1 consume: each owns 64
// rows of the block's 128-row A tile and runs wgmma.mma_async (bf16 in,
// f32 accumulate in registers) on it against the stage's B tile.
// Warpgroup 2 produces: one thread issues the TMA loads
// (cp.async.bulk.tensor) of each stage against the stage's `full`
// mbarrier, which counts the bytes in. setmaxnreg gives the consumers 232
// registers a thread and leaves the producer 40.
//
// The ring. A stage is 64 deep (64 bf16 = 128 bytes, the 128-byte
// swizzle's row): the A tile, [128 rows][64] K-major, then the B boxes,
// each [64 deep][64 columns] MN-major (the weights are depth x columns
// with the columns contiguous), every piece 1024-byte aligned. TMA writes
// them with the 128-byte swizzle, which the wgmma descriptors name.
// A consumer warp releases a stage (arrives on its `empty` mbarrier, 8
// warps a phase) once the wgmma that read it has completed; one wgmma
// group stays in flight across stages.
//
// Descriptors. A is K-major: rows 128 bytes apart, 8-row groups 1024
// bytes apart (SBO); a 16-deep step moves the start 32 bytes. B is
// MN-major (wgmma's transposed-B form): a box's 64 depth rows are 128
// bytes apart, 8-deep groups 1024 bytes apart (SBO), the next 64
// columns one box (8 KB) on (LBO); a 16-deep step moves the start 2 KB.
// A chain of width N (a multiple of 8, up to 256) is one wgmma of the
// largest power-of-two width <= N, then the rest: 144 = 128 + 16, 136 =
// 128 + 8. Every piece starts at a multiple of 64 columns, a box edge,
// and its accumulators follow the last piece's, so the chain's registers
// are laid out as one wgmma of width N: thread (warp w, lane l) of a
// warpgroup holds rows 16w + l/4 (h = 0) and 16w + l/4 + 8 (h = 1) of
// columns 8j + 2(l%4) + e in d[4j + 2h + e].
//
// The other two operand layouts (the instruction's transpose immediates,
// mma<N, TA, TB>):
//  * A MN-major (TA = 1; desc_a_mn): A[m][k] stored with m contiguous, a
//    box of [64 deep][64 rows], 128-byte depth rows: SBO = 8 depth rows
//    (1024 bytes), LBO = the next 64 rows (one 8 KB box; a warpgroup's
//    m64 reads one box, so it is never followed); a 16-deep step moves
//    the start 2 KB. The mirror of B MN-major.
//  * B K-major (TB = 0; desc_b_k): B[k][n] stored as [n][64 deep],
//    128-byte rows of depth: SBO = 8 rows (1024 bytes), LBO unused (16);
//    a 16-deep step moves the start 32 bytes. The mirror of A K-major;
//    a box of up to 256 rows is one piece of n256.
//
// The 3xTF32 product (mma_tf32, window3, stage3, consume3; the f32 routes
// of dbof.cu, moe_head.cu and netvlad.cu's assignment; mma16x8_3xtf32 on
// mma.sync for netvlad.cu's aggregation and attention_pool.cu, whose
// operands lie depth-major): f32 operands on the TF32 tensor cores.
// Each operand x is split into big = tf32(x) and small = tf32(x - big)
// (tf32_round: cvt.rna, to nearest, ties away, a 10-bit mantissa), and a
// tile sums A_small B_big + A_big B_small + A_big B_big, the small terms
// first; the dropped A_small B_small and the rounding of the small parts
// are about 2^-21 of each product. A stage is 32 deep (32 f32 = the
// 128-byte swizzle's row): both halves of the A tile, [2][128 rows][32]
// K-major, then both halves of each chain's B rows, [2][N rows][32]
// K-major (B arrives K-major, as a [2][columns][depth] split copy of the
// weights: TF32's wgmma has no transpose immediate). The descriptors are
// desc_a and desc_b_k; a k8 step moves the start 32 bytes, as a bf16 k16
// step does, so a stage is four k8 steps. The tensor core's sums stay
// within one stage (a window of at most 128 columns at a time); the
// stages' sums add up on the FMA units (stage3's note says why).
//
// The TMA store (tma_store_3d, bulk_commit, bulk_wait_read): threads
// write a tile into shared memory, fence it to the async proxy
// (fence_async_smem), and one thread stores it by a tensor map; it waits
// for a group's reads (not its writes) before the buffer is written
// again, so the stores drain while the next tile's mainloop runs.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hgemm {
namespace {

constexpr int kDepth = 64;                    // bf16 a stage (128 bytes)
constexpr int kBoxCols = 64;                  // columns of a B box
constexpr int kBoxBytes = kDepth * kBoxCols * 2;  // 8 KB
constexpr int kRows = 128;                    // A rows a block (two consumers)
constexpr int kABytes = kRows * kDepth * 2;   // 16 KB
constexpr int kThreads = 384;                 // two consumer warpgroups + the producer
constexpr int kConsumerWarps = 8;
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kAlign = 1024;                  // the 128-byte swizzle's atom

__host__ __device__ constexpr int boxes(int cols) { return (cols + kBoxCols - 1) / kBoxCols; }

// ---------------------------------------------------------------------------
// Host: tensor maps.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no link
// against libcuda), looked up once.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// A tensor map (bf16 unless `type` says otherwise) with the 128-byte
// swizzle unless `swizzle` says otherwise: the box's inner extent must
// then be 128 bytes (unswizzled: a multiple of 16). dims and box
// innermost first; strides in bytes of dims 1.. (multiples of 16).
// Elements outside the tensor read as zeros and are not written by a
// store.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                            const uint64_t* strides, const uint32_t* box,
                            CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr || rank > 4) return cudaErrorNotSupported;
  cuuint64_t d[4], s[3];
  cuuint32_t b[4], e[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), d, s,
                            b, e, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major [rows, cols] bf16 matrix with row stride ld elements, as
// boxes of [box_rows][64 columns].
inline cudaError_t make_map_2d(CUtensorMap* map, const void* base, int rows, int cols, int ld,
                               int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(ld) * 2};
  const uint32_t box[2] = {kBoxCols, static_cast<uint32_t>(box_rows)};
  return make_map(map, base, 2, dims, strides, box);
}

// A [batch][rows][cols] tensor whose rows are ld elements apart (the
// batches rows * ld apart), as boxes of [1][box_rows][box_cols]; the
// columns past cols read as zeros even where ld > cols.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* base, int batch, int rows, int cols,
                               int ld, int elem_bytes, int box_rows, int box_cols,
                               CUtensorMapDataType type,
                               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const uint64_t dims[3] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[2] = {static_cast<uint64_t>(ld) * elem_bytes,
                               static_cast<uint64_t>(rows) * ld * elem_bytes};
  const uint32_t box[3] = {static_cast<uint32_t>(box_cols), static_cast<uint32_t>(box_rows), 1};
  return make_map(map, base, 3, dims, strides, box, type, swizzle);
}

inline cudaError_t make_map_bf16(CUtensorMap* map, const void* base, int batch, int rows, int cols,
                                 int ld, int box_rows) {
  return make_map_3d(map, base, batch, rows, cols, ld, 2, box_rows, kBoxCols,
                     CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// f32 boxes of [box_rows][32 columns] (128 bytes).
constexpr int kF32BoxCols = 32;
inline cudaError_t make_map_f32(CUtensorMap* map, const void* base, int batch, int rows, int cols,
                                int box_rows) {
  return make_map_3d(map, base, batch, rows, cols, cols, 4, box_rows, kF32BoxCols,
                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// A 3xTF32 operand: [2][rows][depth_p] f32 (the big half, then the small
// one), as boxes of [1][box_rows][32 deep] (128-byte rows, K-major); the
// depth past depth_p and the rows past `rows` read as zeros.
inline cudaError_t make_map_split(CUtensorMap* map, const void* base, int rows, int depth_p,
                                  int box_rows) {
  return make_map_3d(map, base, 2, rows, depth_p, depth_p, 4, box_rows, kF32BoxCols,
                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// Bytes (uint8 frames, int8 weights): [batch][rows][cols] with rows ld
// bytes apart, boxes of [1][box_rows][box_cols]. Swizzled boxes are 128
// bytes wide (128 int8 = a k32 wgmma's four steps); an unswizzled box is
// read by the consumers' own loads.
// TMA has no signed byte type: int8 is copied as its bytes.
inline cudaError_t make_map_u8(CUtensorMap* map, const void* base, int batch, int rows, int cols,
                               int ld, int box_rows, int box_cols,
                               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  return make_map_3d(map, base, batch, rows, cols, ld, 1, box_rows, box_cols,
                     CU_TENSOR_MAP_DATA_TYPE_UINT8, swizzle);
}

// Dynamic shared memory a kernel asks for: its layout plus the slack to
// align the base to 1024 bytes.
constexpr int smem_request(int bytes) { return bytes + kAlign; }

inline cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

// ---------------------------------------------------------------------------
// Device: barriers, TMA, wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

// The thread's warpgroup, broadcast from lane 0 so that the compiler sees
// a warp-uniform value: the role branches (and setmaxnreg in them) are
// then compiled per warpgroup.
__device__ __forceinline__ int warpgroup() { return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0); }

// p ? a : b on values in registers (a select the compiler cannot turn
// into a select of addresses, which would put an array in local memory).
__device__ __forceinline__ float select(bool p, float a, float b) {
  float r;
  asm("{\n.reg .pred q;\nsetp.ne.u32 q, %3, 0;\nselp.f32 %0, %1, %2, q;\n}\n"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<uint32_t>(p)));
  return r;
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

constexpr uint64_t kWaitLimitNs = 10000000000ull;  // 10 s

// Wait until the barrier's phase differs from `parity`. A wait that
// lasts 10 s (a load that never lands, a lost arrival) traps, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (bar_try(a, parity)) return;
  const uint64_t t0 = global_ns();
  while (!bar_try(a, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

// Named barrier over `threads` threads (ids 1..15; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared -> global by a tensor map: the box at (c0, c1, c2) from src.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed store groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until every committed store group has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before the async proxy's
// reads (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cp.async of 16 bytes global -> shared, zero-filled past src_bytes (0
// or 16), and its groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A 16-byte chunk's byte offset in a 128-byte-swizzled box: row `row`
// (128 bytes), chunk `chunk` (0..7) of it.
__device__ __forceinline__ int swizzled(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

template <int R>
__device__ __forceinline__ void set_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void set_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A 128-byte-swizzle descriptor: start, leading and stride byte offsets.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) | (static_cast<uint64_t>(1) << 62);
}

// A: 64 rows from `addr`, K-major; 16-deep step kk.
__device__ __forceinline__ uint64_t desc_a(uint32_t addr, int kk) {
  return desc(addr + kk * 32, 16, 1024);
}

// B: boxes from `addr`, MN-major; 16-deep step kk.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr, int kk) {
  return desc(addr + kk * 2048, kBoxBytes, 1024);
}

// A MN-major: a box of [64 deep][64 rows] from `addr`; 16-deep step kk.
__device__ __forceinline__ uint64_t desc_a_mn(uint32_t addr, int kk) {
  return desc(addr + kk * 2048, kBoxBytes, 1024);
}

// B K-major: rows of 64 deep from `addr`; 16-deep step kk.
__device__ __forceinline__ uint64_t desc_b_k(uint32_t addr, int kk) {
  return desc(addr + kk * 32, 16, 1024);
}

__device__ __forceinline__ void mma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of d across the wgmma fences.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int R, class Acc>
__device__ __forceinline__ void zero(Acc* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = Acc(0);
}

// d[0 .. N/2) += A(a) . B(b): one m64nNk16. TA and TB are the
// instruction's transpose immediates: TA = 0 reads A K-major (desc_a),
// TA = 1 MN-major (desc_a_mn); TB = 1 reads B MN-major (desc_b), TB = 0
// K-major (desc_b_k). DBoF and the MoE head use the defaults.
template <int N, int TA = 0, int TB = 1>
__device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
  static_assert((TA == 0 || TA == 1) && (TB == 0 || TB == 1), "transpose immediates");
  if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else {
    static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128 || N == 256, "wgmma width");
  }
}

// d[0 .. 128) += A(a) . B(b) in int32: one m64n256k32 of unsigned bytes
// (A, the raw uint8 frames) against signed bytes (B, int8 weights). The
// integer wgmma reads both operands K-major only (desc_a, desc_b_k): a
// 128-byte swizzled row is 128 deep, and a k32 step moves the start 32
// bytes, as a bf16 k16 step does. Exact: no saturation is reachable
// below 2^31.
__device__ __forceinline__ void mma_u8s8_256(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(1));
}

// d[0 .. N/2) = A(a) . B(b) + (scale_d ? d : 0) with tf32 operands: one
// m64nNk8. TF32 takes no transpose immediate: both operands are K-major
// (desc_a, desc_b_k), a 128-byte swizzled row 32 deep, a k8 step moving
// the start 32 bytes as a bf16 k16 step does. The tensor core reads the
// upper 19 bits of each 32-bit element; the operands come rounded
// (tf32_round).
template <int N>
__device__ __forceinline__ void mma_tf32(float* d, uint64_t a, uint64_t b, int scale_d = 1) {
  if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  } else {
    static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128 || N == 256, "wgmma width");
  }
}

// d[0 .. 32) = A B + (scale_d ? d : 0): one m64n64k8 with tf32 operands,
// A from registers (a[4]: warp w of the warpgroup holds rows 16w + g and
// + 8, k q and q + 4, as mma16x8_tf32's A, for lane 4g + q), B K-major
// from shared memory (desc_b_k). netvlad.cu's f32 aggregation, whose A
// (the frames, transposed) lies depth-major in shared memory. The
// registers of a stay unchanged until the wgmma has completed.
__device__ __forceinline__ void mma_tf32_rs64(float* d, const float (&a)[4], uint64_t b,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// The 3xTF32 product.
// ---------------------------------------------------------------------------

constexpr int kTf32Depth = 32;                      // f32 a stage (128 bytes)
constexpr int kTf32RowBytes = kTf32Depth * 4;       // a K-major row of a stage
constexpr int kTf32ABytes = kRows * kTf32RowBytes;  // one half of the A tile: 16 KB

// x rounded to tf32 (to nearest, ties away from zero; the low 13 bits 0).
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = big + small, both tf32 (x - big is exact in f32).
__device__ __forceinline__ void tf32_split(float x, float& big, float& small) {
  big = tf32_round(x);
  small = tf32_round(__fsub_rn(x, big));
}

__host__ __device__ constexpr int pow2_floor(int n) {
  return n >= 256 ? 256 : n >= 128 ? 128 : n >= 64 ? 64 : n >= 32 ? 32 : n >= 16 ? 16 : 8;
}

// A chain of width N over B boxes from b_addr, 16-deep step kk.
template <int N, int Col = 0>
__device__ __forceinline__ void chain(float* d, uint32_t a_addr, uint32_t b_addr, int kk) {
  constexpr int P = pow2_floor(N);
  static_assert(N % 8 == 0 && N <= 256 && P >= 8, "chain width");
  static_assert(Col % kBoxCols == 0, "a chain piece must start at a box edge");
  mma<P>(d, desc_a(a_addr, kk), desc_b(b_addr + (Col / kBoxCols) * kBoxBytes, kk));
  if constexpr (N > P) chain<N - P, Col + P>(d + P / 2, a_addr, b_addr, kk);
}

// The 3xTF32 consumer keeps its sums out of the tensor core. A wgmma
// adds its products to its f32 accumulators rounding toward zero, so a
// chain of 3 D / 8 of them drifts toward zero by about half an ulp of the
// running sum a wgmma, linear in D (on the card, values up to ~4.4:
// 3.8e-5 at D = 1152, 6.3e-4 at 16384, against the f32 matmul's 1.4e-6
// and 4.9e-6). So each stage's products go into fresh accumulators
// (scale-d 0 on a register's first wgmma) and are added to running sums
// on the FMA units, rounded to nearest: accumulators of at most kWindow
// columns (64 registers) a window, and the sums of the whole tile, laid
// out as one chain's registers.
constexpr int kWindow = 128;  // columns a window (its accumulators: 64 registers)

// A tile's columns are its G gate-chain columns, then E expert-chain
// columns (DBoF: G = 256, E = 0), each chain's K-major rows 128 bytes
// apart from big and small. window3 issues, for k8 step kk, the three
// products of columns [Lo, Hi) of the window starting at Base into d,
// cut into widths of wgmma (the largest power of two first); scale-d is
// 0 on a register's first product of the stage (kk = 0).
template <int G, int E, int Lo, int Hi, int Base>
__device__ __forceinline__ void window3(float* d, uint32_t a_big, uint32_t a_small, uint32_t g_big,
                                        uint32_t g_small, uint32_t e_big, uint32_t e_small,
                                        int kk) {
  if constexpr (Lo < Hi) {
    constexpr bool kGate = Lo < G;
    constexpr int kEnd = kGate && Hi > G ? G : Hi;
    constexpr int P = pow2_floor(kEnd - Lo);
    static_assert(Lo % 8 == 0 && (kEnd - Lo) % 8 == 0 && P <= kEnd - Lo, "wgmma widths");
    constexpr uint32_t kOff = (kGate ? Lo : Lo - G) * kTf32RowBytes;  // 1024-byte aligned
    const uint32_t bb = (kGate ? g_big : e_big) + kOff;
    const uint32_t bs = (kGate ? g_small : e_small) + kOff;
    float* dd = d + (Lo - Base) / 2;
    mma_tf32<P>(dd, desc_a(a_small, kk), desc_b_k(bb, kk), kk > 0);
    mma_tf32<P>(dd, desc_a(a_big, kk), desc_b_k(bs, kk));
    mma_tf32<P>(dd, desc_a(a_big, kk), desc_b_k(bb, kk));
    window3<G, E, Lo + P, Hi, Base>(d, a_big, a_small, g_big, g_small, e_big, e_small, kk);
  }
}

// One stage of a 3xTF32 tile, window by window from window W: its
// products into acc (waited for), then added to sum. The stage at `st`:
// A's halves [2][128 rows][128 bytes] (this warpgroup's rows at a_off),
// then the gate rows' halves [2][G][128 bytes], then the expert rows'
// [2][E][128 bytes].
template <int G, int E, int W = 0>
__device__ __forceinline__ void stage3(float* sum, float* acc, uint32_t st, uint32_t a_off) {
  constexpr int kLo = W * kWindow;
  if constexpr (kLo < G + E) {
    constexpr int kHi = kLo + kWindow < G + E ? kLo + kWindow : G + E;
    const uint32_t g = st + 2 * kTf32ABytes;
    const uint32_t e = g + 2 * G * kTf32RowBytes;
    fence_regs<kWindow / 2>(acc);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < kTf32Depth / 8; ++kk)
      window3<G, E, kLo, kHi, kLo>(acc, st + a_off, st + kTf32ABytes + a_off, g,
                                   g + G * kTf32RowBytes, e, e + E * kTf32RowBytes, kk);
    mma_commit();
    mma_wait<0>();
    fence_regs<kWindow / 2>(acc);
#pragma unroll
    for (int j = 0; j < (kHi - kLo) / 2; ++j) sum[kLo / 2 + j] += acc[j];
    stage3<G, E, W + 1>(sum, acc, st, a_off);
  }
}

// d += A B on mma.sync.m16n8k8 with tf32 operands in registers (the f32
// routes of netvlad.cu's aggregation and attention_pool.cu, whose
// fragments the threads load themselves): a[4] holds A (16 x 8) at (row
// g, col q), (g + 8, q), (g, q + 4), (g + 8, q + 4), b0 and b1 B (8 x 8)
// at (row q, col g) and (q + 4, g), d the sums at (g, 2q), (g, 2q + 1),
// (g + 8, 2q), (g + 8, 2q + 1), for lane 4g + q.
__device__ __forceinline__ void mma16x8_tf32(float* d, const float (&a)[4], float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// d += A B as the 3xTF32 product: A_small B_big + A_big B_small + A_big
// B_big, the small terms first, from the operands' halves (tf32_split).
__device__ __forceinline__ void mma16x8_3xtf32(float* d, const float (&a_big)[4],
                                               const float (&a_small)[4], const float (&b_big)[2],
                                               const float (&b_small)[2]) {
  mma16x8_tf32(d, a_small, b_big[0], b_big[1]);
  mma16x8_tf32(d, a_big, b_small[0], b_small[1]);
  mma16x8_tf32(d, a_big, b_big[0], b_big[1]);
}

// The ring's stage and phase, as each role walks it.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int S>
  __device__ __forceinline__ void next() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Producer: for each of nk stages, wait for the slot, announce `bytes`
// and issue load(slot, full barrier, k-step).
template <int S, class Load>
__device__ __forceinline__ void produce(uint64_t* full, uint64_t* empty, Ring& r, int nk,
                                        uint32_t bytes, Load load) {
  for (int kt = 0; kt < nk; ++kt) {
    bar_wait(&empty[r.stage], r.phase ^ 1);
    bar_expect(&full[r.stage], bytes);
    load(r.stage, &full[r.stage], kt);
    r.template next<S>();
  }
}

// Consumer warpgroup: for each of nk stages, wait for its bytes, run
// prep(slot, kt) (a stage the consumers complete themselves: they write an
// operand from it and fence it to the async proxy), issue mma_stage(slot,
// kt) (the stage's wgmma chains), and release the previous slot once its
// group has completed. Ends with every group complete and every slot
// released. R accumulator registers in d (f32, or int32 for the int8
// product).
template <int S, int R, class Acc, class Prep, class Mma>
__device__ __forceinline__ void consume_prepared(uint64_t* full, uint64_t* empty, Ring& r, int nk,
                                                 Acc* d, Prep prep, Mma mma_stage) {
  const bool leader = (threadIdx.x & 31) == 0;
  int prev = -1;
  fence_regs<R>(d);
  for (int kt = 0; kt < nk; ++kt) {
    bar_wait(&full[r.stage], r.phase);
    prep(r.stage, kt);
    mma_fence();
    mma_stage(r.stage, kt);
    mma_commit();
    mma_wait<1>();
    fence_regs<R>(d);
    if (prev >= 0 && leader) bar_arrive(&empty[prev]);
    prev = r.stage;
    r.template next<S>();
  }
  mma_wait<0>();
  fence_regs<R>(d);
  if (prev >= 0 && leader) bar_arrive(&empty[prev]);
}

// consume_prepared for stages that TMA fills whole: mma_stage(slot).
template <int S, int R, class Acc, class Mma>
__device__ __forceinline__ void consume(uint64_t* full, uint64_t* empty, Ring& r, int nk, Acc* d,
                                        Mma mma_stage) {
  consume_prepared<S, R>(
      full, empty, r, nk, d, [](int, int) {}, [&](int s, int) { mma_stage(s); });
}

// Consumer warpgroup of a 3xTF32 tile: for each of nk stages, wait for its
// bytes, run stage3 on it, release it. sum[(G + E) / 2] (zeroed by the
// caller) ends as the tile's products, laid out as one chain's
// accumulators; acc is the window's scratch (kWindow / 2 registers).
template <int S, int G, int E>
__device__ __forceinline__ void consume3(uint64_t* full, uint64_t* empty, Ring& r, int nk,
                                         float* sum, float* acc, uint32_t ring_base,
                                         int stage_bytes, uint32_t a_off) {
  const bool leader = (threadIdx.x & 31) == 0;
  for (int kt = 0; kt < nk; ++kt) {
    bar_wait(&full[r.stage], r.phase);
    stage3<G, E>(sum, acc, ring_base + r.stage * stage_bytes, a_off);
    if (leader) bar_arrive(&empty[r.stage]);
    r.template next<S>();
  }
}

}  // namespace
}  // namespace hgemm
