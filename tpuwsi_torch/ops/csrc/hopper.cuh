// Hopper building blocks that more than one kernel source uses
// (mha_qkv_fwd.cu, flash_fwd.cu, flash_bwd.cu, mlp_sm90.cu, dense_sm90.cuh):
// mbarriers, TMA loads through tensor maps (2-D ones also multicast to a
// thread-block cluster) and 2-D stores, the maps' encoding on the host,
// cluster barriers and remote arrivals, named barriers, wgmma descriptors for
// 128-byte swizzled tiles, and the wgmma shapes the attention kernels share.
// Every function is inline; sm_90a only (wgmma).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- mbarriers and TMA ---------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of the given parity to complete. A phase that never
// completes (a fault in the schedule) traps after 2^24 tries rather than
// hanging the card; a real wait is a few microseconds.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0; !mbar_try_wait(bar, parity); ++tries)
    if (tries == (1u << 24)) __trap();
}

// One box of a 3-D tensor map into shared memory, completing on `bar`:
// coordinates (col, row, batch) of its first element; elements past the
// map's extent arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

// The same through a 4-D tensor map: coordinates (col, row, head, batch).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// One box of a 2-D tensor map into shared memory, completing on `bar`:
// coordinates (col, row) of its first element; elements past the map's
// extent arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// The same box written to the same shared-memory offset in every block of the
// cluster named in `mask` (bit i: the block of rank i), each completing its
// bytes on its own mbarrier at offset `bar`. One read of device memory (or
// L2) feeds them all.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int col, int row,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "h"(mask)
      : "memory");
}

// One 2-D box of shared memory at `src` (128-byte swizzled as the map says) to
// the tensor map's coordinates (col, row); rows past the map's extent are not
// written. The store joins the issuing thread's bulk async-group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int col,
                                             int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's bulk groups still read their
// shared memory (which may then be written again) ...
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// ... or are still running at all.
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---- thread-block clusters -------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: what each wrote before (its
// mbarrier inits included) is visible to all after. Not .aligned: a warp may
// reach it divergent (a producer warp whose one thread issued the loads).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// Arrive on the mbarrier at shared-memory offset `bar` of the cluster's block
// of rank `cta` (this block's own included). The default release at CTA
// scope, as CUTLASS's cluster barrier has it: what it orders are this
// thread's wgmma reads of a stage, complete at their wait; a release at
// cluster scope waits for every earlier write of the thread to reach the
// cluster and cost microseconds an arrival.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// The value itself, hidden from the optimiser: what is computed from it
// stays next to its use inside the loop instead of being hoisted out of the
// loops into registers (ptxas would otherwise keep dozens of descriptors and
// addresses live across the whole tile, and spill).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory operand descriptor for a 128-byte swizzled tile of 128-byte
// rows: start address >> 4, leading offset 16 B (unused at this width),
// stride 1024 B between groups of 8 rows, layout type 1 (128-byte swizzle).
// The tiles start on 1024-byte boundaries, so the swizzle phase is the row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most kPending committed groups are still running.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from reading an accumulator, or reusing an operand's
// register, between an asynchronous wgmma and its wait.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}
__device__ __forceinline__ void reg_fence(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(r[c][e]);
}

// D(64 x 64) (+)= A(64 x 16) . B(16 x 64), A and B both from shared memory,
// K-major (m64n64k16); kScaleA = -1 negates A in the product.
template <int kScaleA = 1>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                       int accumulate) {
  static_assert(kScaleA == 1 || kScaleA == -1, "imm-scale-a is 1 or -1");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, %35, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kScaleA));
}

// P.V: D(64 x 64) (+)= A(64 x 16, registers: p) . B(16 keys x 64 dims of V),
// B MN-major (transposed B, which bf16 allows).
__device__ __forceinline__ void wgmma_n64_mn(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Fragment ownership (wgmma m64nN, PTX ISA): warp w of a warpgroup holds rows
// 16w..16w+15; lane = 4*g + t holds rows 16w+g and 16w+g+8, and of each
// 8-column group of an accumulator, columns 2t and 2t+1 (regs 4i, 4i+1 for row
// g; 4i+2, 4i+3 for row g+8). The register A operand of m64nNk16 has the
// layout of mma.m16n8k16's, so 16 columns of an accumulator rounded to bf16
// pairs are the A fragment of one k16 step of a following product.
//
// The 64 columns of this thread's accumulator rows as bf16 pairs: the A
// fragments of four k16 steps.
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[c][0] = pack_bf16(x[8 * c], x[8 * c + 1]);
    a[c][1] = pack_bf16(x[8 * c + 2], x[8 * c + 3]);
    a[c][2] = pack_bf16(x[8 * c + 4], x[8 * c + 5]);
    a[c][3] = pack_bf16(x[8 * c + 6], x[8 * c + 7]);
  }
}

// D(64 x 64) = A . B^T over 64 columns: A and B are 64-row tiles of 128-byte
// rows in shared memory (K-major); four k16 steps, 32 bytes (2 descriptor
// units) apart, the first overwriting D (a constant flag: a flag computed at
// run time makes ptxas serialise the wgmma, C7513).
__device__ __forceinline__ void wgmma_nt_k64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(d, desc_a + 2 * kk, desc_b + 2 * kk, kk);
}

// D(64 x 64) += A . B over 64 rows of B: A the four k16 fragments in
// registers (pack_a), B a 64-row tile of 128-byte rows read MN-major, 16 rows
// (2,048 bytes, 128 descriptor units) a step.
__device__ __forceinline__ void wgmma_rn_k64(float (&d)[32], const uint32_t (&a)[4][4],
                                            uint64_t desc_b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) wgmma_n64_mn(d, a[c], desc_b + 128 * c, 1);
}

// cuTensorMapEncodeTiled, handed out by the runtime (cudaGetDriverEntryPoint),
// so the library links no libcuda; null if the installed CUDA has none.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The encoding is a driver call and fails (CUDA_ERROR_INVALID_CONTEXT) in a
// thread with no current context: autograd's backward thread has none until
// some runtime call makes one current, which a caching allocator that serves
// every tensor from its cache never does. So the calling thread's device is
// made current first; a failure shows in the launch's cudaGetLastError.
inline EncodeTiledFn encode_tiled() {
  int device = 0;
  if (cudaGetDevice(&device) == cudaSuccess) cudaSetDevice(device);
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 2-D map over a row-major bf16 matrix of `rows` rows of `cols` values
// (cols a multiple of 8); boxes of 64 columns x box_rows rows, 128-byte
// swizzled. Rows past `rows` arrive as zeros.
inline bool encode_2d(CUtensorMap* map, EncodeTiledFn encode, const void* ptr, long long cols,
                      long long rows, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t bytes[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, bytes,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D map (64 columns, rows, heads, batch) over bf16 rows of 64 contiguous
// values at the given element strides {batch, head, row}; boxes of 64 columns
// x box_rows rows, 128-byte swizzled. Rows past `rows` arrive as zeros, never
// as the next head's.
inline bool encode_rows_4d(CUtensorMap* map, EncodeTiledFn encode, const void* ptr, int rows,
                           int heads, int batch, const long long* strides, int box_rows) {
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, bytes,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
