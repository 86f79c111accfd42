// Dense-layer building blocks on wgmma that more than one source shares
// (dense_sm90.cu, ln_gemm_sm90.cu, attn_block.cu): helpers for 128-byte
// swizzled 64 x 64 boxes and the wgmma shapes the row passes use, the row
// pass itself, LayerNorm (a pass of its own, and its backward as the row
// pass's epilogue: K8b's and K9b's dx), and the weight-gradient kernel of a
// dense layer whose input is 384 wide,
//   dW (384, n) = A^T . G,  db (n,) = the column sums of G,
// per (slice of 64 output columns, group of 64-row steps), into w_part in
// the fixed-order layout of the row-tiled kernels (dense_common.cuh), which
// sum_partials_kernel adds afterwards. K7's and K9d's dW and db at input
// width 384 (dense_sm90.cu) and K8b's two dW tails at D = 384 (attn_block.cu:
// LN(x)^T . dqkv and o^T . dy) launch the same code.
//
// The dW kernel: a block of 288 threads (two consumer warpgroups, a producer
// warp whose one thread fills a ring of three stages by TMA). A stage is one
// 64-row step: the step's A (64 rows x 384 = six 64 x 64 boxes) and G's 64
// columns of the slice. Warpgroup w owns dW rows 192 w .. + 191 of the slice
// (three m64n64 accumulators, A and G both read MN-major: 16 rows, 2,048
// bytes, a k16 step) and its warps sum the slice's columns of G over their
// eight rows of each step; the eight warps' column sums meet in shared memory
// in a fixed order. Every output element has one writer and the number of
// row groups is the caller's, a function of the shapes and the SM count: two
// launches give the same bits.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mlp_common.cuh"

namespace dense_sm90 {

using namespace hopper;

constexpr int kTile = 64;                     // rows of a row tile or a step; columns of a box
constexpr uint32_t kRowBytes = 128;           // one box row: 64 bf16, 128-byte swizzled
constexpr uint32_t kBox = kTile * kRowBytes;  // 8 KB
constexpr int kWidth = 384;                   // the dW kernel's input width, the row pass's output
constexpr int kPieces = kWidth / kTile;       // 64-column boxes across that width
constexpr uint32_t kSmemLimit = 232448;       // 227 KB a block
// setmaxnreg of a 384-thread block: 128 x 40 + 256 x 232 registers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// ---- shared memory ----------------------------------------------------------

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a 128-byte swizzled operand: 8-row groups 1,024 bytes apart
// (SBO); `lbo` bytes between 64-wide blocks of an MN-major operand wider than
// 64 (unused for K-major ones).
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// Byte offset of the bf16 pair at (row, col) of a 128-byte swizzled tile of
// 64 columns that starts on a 1,024-byte boundary: 16-byte chunk c of row r
// sits at chunk c ^ (r & 7).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return static_cast<uint32_t>(row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2);
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Byte offset of 16-byte chunk c (values 8c .. 8c + 7) of row r of a tile
// whose 64-column boxes lie kBox apart, 128-byte swizzled as TMA writes them.
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * kBox + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Each warp's lane 0 arrives once for the warp, after the warp's reads.
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// The full and empty mbarriers of a ring of kStages stages at `at`.
template <int kStages>
struct RingBars {
  uint32_t at;
  __device__ uint32_t full(int i) const { return at + 8u * i; }
  __device__ uint32_t empty(int i) const { return at + 8u * (kStages + i); }
};

// ---- wgmma --------------------------------------------------------------------
// Fragment ownership of an m64nN fp32 result (PTX ISA): warp w of the
// warpgroup holds rows 16w..16w+15; lane 4g + t4 holds rows 16w+g (a) and
// 16w+g+8 (b) and, of each 8-column group i, columns 8i+2t4 and 8i+2t4+1
// (regs 4i, 4i+1 of row a; 4i+2, 4i+3 of row b).

// D(64 x 64) (+)= A(64 x 16) . B(16 x 64), both from shared memory;
// kTransA / kTransB = 1 reads that operand MN-major.
template <int kTransA, int kTransB>
__device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// D(64 x 192) (+)= A(64 x 16) . B(16 x 192), both from shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void ss_n192(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// ---- the dW kernel ------------------------------------------------------------

constexpr int kDwThreads = 288;
constexpr int kDwStages = 3;
constexpr uint32_t kDwStage = (kPieces + 1) * kBox;  // A 64 rows x 384, G 64 x 64
constexpr uint32_t kDwOffRed = kDwStages * kDwStage;  // db partials [8 warps][32] pairs
constexpr uint32_t kDwOffBar = kDwOffRed + 8 * 32 * 8;
constexpr uint32_t kDwSmem = kDwOffBar + 8 * 2 * kDwStages;
static_assert(kDwSmem <= kSmemLimit, "227 KB a block");

struct DwParams {
  float* w_part;  // (groups, 384 n + n): dW (384, n) | db (n,) of each group of rows
  int n, n_steps, per_group, slices;
};

struct DwWork {
  int slice, grp, st0, steps;
};

__device__ __forceinline__ DwWork dw_work(const DwParams& prm) {
  DwWork w;
  w.slice = blockIdx.x % prm.slices;
  w.grp = blockIdx.x / prm.slices;
  w.st0 = w.grp * prm.per_group;
  w.steps = max(0, min(prm.per_group, prm.n_steps - w.st0));
  return w;
}

// Warpgroup kWg: rows 192 kWg .. + 191 of dW[:, slice], three m64n64 tiles.
template <int kWg>
__device__ __forceinline__ void dw_consumer(const DwParams& prm, uint32_t base, int tid) {
  const RingBars<kDwStages> bars{base + kDwOffBar};
  const DwWork wk = dw_work(prm);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  float acc0[32], acc1[32], acc2[32];
  zero(acc0);
  zero(acc1);
  zero(acc2);
  // db: this thread's column pair 2 lane, + 1 of the slice over the 8 rows
  // 32 kWg + 8 warp .. of each stage
  float db0 = 0.f, db1 = 0.f;
  for (int j = 0; j < wk.steps; ++j) {
    const int s = j % kDwStages;
    mbar_wait(bars.full(s), (j / kDwStages) & 1);
    const uint32_t st = base + s * kDwStage;
    const uint32_t gb = opaque(st) + kPieces * kBox;
    // A = the stage's rows of the layer's input read MN-major: 64 values of
    // the width a box row; B = G's 64 columns, MN-major; 16 rows (2,048
    // bytes) a k16 step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ss_n64<1, 1>(acc0, sw128(opaque(st) + (3 * kWg) * kBox + 2048 * kk), sw128(gb + 2048 * kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ss_n64<1, 1>(acc1, sw128(opaque(st) + (3 * kWg + 1) * kBox + 2048 * kk), sw128(gb + 2048 * kk),
                   1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ss_n64<1, 1>(acc2, sw128(opaque(st) + (3 * kWg + 2) * kBox + 2048 * kk), sw128(gb + 2048 * kk),
                   1);
    wgmma_commit();
#pragma unroll
    for (int r = 32 * kWg + 8 * warp; r < 32 * kWg + 8 * warp + 8; ++r) {
      const float2 f = mlp::unpack_bf16(ld_shared_u32(gb + swz(r, 2 * lane)));
      db0 += f.x;
      db1 += f.y;
    }
    wgmma_wait<0>();
    reg_fence(acc0);
    reg_fence(acc1);
    reg_fence(acc2);
    warp_arrive(bars.empty(s));
  }
  float* part =
      prm.w_part + static_cast<size_t>(wk.grp) * (static_cast<size_t>(kWidth) * prm.n + prm.n);
  const int col0 = kTile * wk.slice + 2 * t4;
  auto store = [&](const float (&acc)[32], int mt) {
    const int k = 192 * kWg + 64 * mt + 16 * warp + g;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float2*>(part + static_cast<size_t>(k) * prm.n + col0 + 8 * i) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(part + static_cast<size_t>(k + 8) * prm.n + col0 + 8 * i) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  };
  store(acc0, 0);
  store(acc1, 1);
  store(acc2, 2);
  // db: the eight warps' partials of each column pair, added in warp order
  const uint32_t red = base + kDwOffRed;
  st_shared_f2(red + 8 * (32 * (4 * kWg + warp) + lane), db0, db1);
  named_sync(1, 256);
  if (kWg == 0 && warp == 0) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const float2 v = ld_shared_f2(red + 8 * (32 * w + lane));
      s0 += v.x;
      s1 += v.y;
    }
    *reinterpret_cast<float2*>(part + static_cast<size_t>(kWidth) * prm.n + kTile * wk.slice +
                               2 * lane) = make_float2(s0, s1);
  }
}

// kK, the layer's input width, is 384: the template keeps one copy of the
// kernel however many sources include this header.
template <int kK>
__global__ void __launch_bounds__(kDwThreads, 1)
dense_dw_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap g_map,
          const DwParams prm) {
  static_assert(kK == kWidth, "the dW kernel is built for an input width of 384");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const RingBars<kDwStages> bars{base + kDwOffBar};
  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();
    for (int i = 0; i < kDwStages; ++i) {
      mbar_init(bars.full(i), 1);
      mbar_init(bars.empty(i), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    if (threadIdx.x != 256) return;
    const DwWork wk = dw_work(prm);
    for (int j = 0; j < wk.steps; ++j) {
      const int s = j % kDwStages;
      if (j >= kDwStages) mbar_wait(bars.empty(s), ((j / kDwStages) - 1) & 1);
      mbar_expect_tx(bars.full(s), kDwStage);
      const uint32_t dst = base + s * kDwStage;
      const int row = kTile * (wk.st0 + j);
      for (int b = 0; b < kPieces; ++b)
        tma_load_2d(dst + b * kBox, &a_map, bars.full(s), kTile * b, row);
      tma_load_2d(dst + kPieces * kBox, &g_map, bars.full(s), kTile * wk.slice, row);
    }
  } else if (role == 0) {
    dw_consumer<0>(prm, base, threadIdx.x);
  } else {
    dw_consumer<1>(prm, base, threadIdx.x - 128);
  }
}

// dW (384, n) and db (n,) of a layer whose input a (rows, 384) met the
// cotangent g (rows, n), per group of 64-row steps into w_part (groups,
// 384 n + n) fp32; n a multiple of 64, 1 <= groups <= ceil(rows / 64). Both
// inputs bf16, contiguous, 16-byte aligned. Launches on `stream`, returns a
// CUDA error code.
inline int dw(const void* a, const void* g, float* w_part, int rows, int n, int groups,
              cudaStream_t stream) {
  const int n_steps = (rows + kTile - 1) / kTile;
  if (rows < 1 || n < kTile || n % kTile || groups < 1 || groups > n_steps)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap a_map, g_map;
  if (!encode_2d(&a_map, encode, a, kWidth, rows, kTile) ||
      !encode_2d(&g_map, encode, g, n, rows, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      dense_dw_kernel<kWidth>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwParams prm{w_part, n, n_steps, (n_steps + groups - 1) / groups, n / kTile};
  dense_dw_kernel<kWidth><<<prm.slices * groups, kDwThreads, kDwSmem, stream>>>(a_map, g_map, prm);
  return static_cast<int>(cudaGetLastError());
}

// ---- the row pass -------------------------------------------------------------
// out (rows, 384) from A (rows, 64 n_chunks) and W, a 64-row tile at a time,
// with an epilogue of the caller's: dense_sm90.cu stores K7's dx and K9c's
// residual sum, `LnBackward` below runs the LayerNorm backward of K8b's dx
// tail (attn_block.cu) and of K9b (ln_gemm_sm90.cu).
// The design is dense_sm90.cu's head comment's: 384-thread blocks in
// clusters of kRowCluster that walk neighbouring tiles, two consumer
// warpgroups of 192 output columns (m64n192), a producer thread, a ring of
// kRowStages stages of an A box and a 64-wide chunk of W multicast to the
// cluster, and one more stage a tile for the epilogue.
//
// An epilogue type provides: `Params`, what its hooks read; `kLoadsRes`,
// whether the producer loads the tile's six boxes of res_map into the
// epilogue's stage; `kSmem`, bytes of its own at base + kRowOffEpi; and
// `epilogue<kWg>(acc, ep, out_map, io, base, tile, shape, tid)`, run with the
// tile's products in acc and its stage's six boxes at io, which it leaves
// free for the producer.

constexpr int kRowThreads = 384;  // two consumer warpgroups, a producer warpgroup
// blocks of a cluster, neighbouring row tiles sharing W: 4 ran 1-3% faster than 1 or 2
// (PERF.md)
constexpr int kRowCluster = 4;
constexpr uint16_t kRowMask = (1u << kRowCluster) - 1;
constexpr int kRowStages = 4;
constexpr uint32_t kRowStage = (1 + kPieces) * kBox;  // an A box and a W chunk (or the epilogue's)
constexpr uint32_t kRowOffBar = kRowStages * kRowStage;
constexpr uint32_t kRowOffEpi = kRowOffBar + 8 * 2 * kRowStages;  // the epilogue's own bytes
using RowBars = RingBars<kRowStages>;

struct RowShape {
  int rows, n_chunks, n_tiles, n_groups;  // n_groups = ceil(n_tiles / kRowCluster)
};

// Arrive on the barrier at offset `bar` of every block of the cluster: lane r
// of the warp signals the block of rank r, all at once.
template <int kBlocks = kRowCluster>
__device__ __forceinline__ void warp_arrive_cluster(uint32_t bar) {
  __syncwarp();
  const uint32_t lane = threadIdx.x & 31;
  if (lane < kBlocks) mbar_arrive_cluster(bar, lane);
}

// One thread: per row tile of this block, the chunks of the reduction, then
// the epilogue's stage. Each block loads the tile's A box itself and W's
// boxes p = rank, rank + kRowCluster, ... for all.
template <class Epi, bool kTransB>
__device__ __forceinline__ void row_producer(const CUtensorMap* a_map, const CUtensorMap* w_map,
                                             const CUtensorMap* res_map, const RowShape& shape,
                                             uint32_t base, int rank) {
  const RowBars bars{base + kRowOffBar};
  const int cluster = blockIdx.x / kRowCluster, n_clusters = gridDim.x / kRowCluster;
  uint32_t it = 0;
  for (int grp = cluster; grp < shape.n_groups; grp += n_clusters) {
    const int row0 = (grp * kRowCluster + rank) * kTile;
    for (int c = 0; c <= shape.n_chunks; ++c, ++it) {
      const int s = static_cast<int>(it % kRowStages);
      if (it >= kRowStages) mbar_wait(bars.empty(s), ((it / kRowStages) - 1) & 1);
      const uint32_t st = base + s * kRowStage;
      if (c < shape.n_chunks) {
        mbar_expect_tx(bars.full(s), kRowStage);  // own A box, every block's W boxes
        tma_load_2d(st, a_map, bars.full(s), kTile * c, row0);
        for (int p = rank; p < kPieces; p += kRowCluster) {
          // box p: outputs 64p.. of reduction chunk c, at (col, row) of W's map
          const int col = kTransB ? kTile * p : kTile * c;
          const int row = kTransB ? kTile * c : kTile * p;
          if constexpr (kRowCluster == 1)
            tma_load_2d(st + (1 + p) * kBox, w_map, bars.full(s), col, row);
          else
            tma_load_2d_multicast(st + (1 + p) * kBox, w_map, bars.full(s), col, row, kRowMask);
        }
      } else if constexpr (Epi::kLoadsRes) {
        mbar_expect_tx(bars.full(s), kPieces * kBox);
        for (int p = 0; p < kPieces; ++p)
          tma_load_2d(st + (1 + p) * kBox, res_map, bars.full(s), kTile * p, row0);
      } else {
        mbar_arrive(bars.full(s));  // the stage only gives the epilogue its room
      }
    }
  }
}

// One consumer warpgroup; kWg is a template argument so that every branch
// around a wgmma is uniform by construction.
template <class Epi, bool kTransB, int kWg>
__device__ __forceinline__ void row_consumer(const CUtensorMap* out_map, const RowShape& shape,
                                             const typename Epi::Params& ep, uint32_t base,
                                             int rank, int tid) {
  const RowBars bars{base + kRowOffBar};
  const int cluster = blockIdx.x / kRowCluster, n_clusters = gridDim.x / kRowCluster;
  uint32_t it = 0;
  for (int grp = cluster; grp < shape.n_groups; grp += n_clusters) {
    const int tile = grp * kRowCluster + rank;
    float acc[96];  // the tile's 64 rows x columns 192 kWg .. + 191
    zero(acc);
    // each chunk's products issued one group ahead of the wait that frees
    // the chunk before it
#pragma unroll 1
    for (int c = 0; c < shape.n_chunks; ++c) {
      const uint32_t i = it + c;
      mbar_wait(bars.full(i % kRowStages), (i / kRowStages) & 1);
      const uint32_t st = base + (i % kRowStages) * kRowStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // A: the tile's box, K-major, 32 bytes a k16 step. B: this
        // warpgroup's three boxes of W, MN-major (16 rows, 2,048 bytes a
        // step; 8 KB between 64-column blocks) or K-major (32 bytes a step)
        const uint32_t wb = opaque(st) + (1 + 3 * kWg) * kBox;
        if constexpr (kTransB)
          ss_n192<0, 1>(acc, sw128(opaque(st) + 32 * kk), sw128(wb + 2048 * kk, kBox), 1);
        else
          ss_n192<0, 0>(acc, sw128(opaque(st) + 32 * kk), sw128(wb + 32 * kk), 1);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        warp_arrive_cluster(bars.empty((i - 1) % kRowStages));
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
    it += shape.n_chunks;
    warp_arrive_cluster(bars.empty((it - 1) % kRowStages));
    mbar_wait(bars.full(it % kRowStages), (it / kRowStages) & 1);  // the epilogue's stage
    Epi::template epilogue<kWg>(acc, ep, out_map, base + (it % kRowStages) * kRowStage + kBox,
                                base, tile, shape, tid);
    warp_arrive_cluster(bars.empty(it % kRowStages));
    ++it;
  }
  if (tid == 0) bulk_wait<0>();  // this warpgroup's stores, if any, have landed
}

template <class Epi, bool kTransB>
__global__ void __launch_bounds__(kRowThreads, 1)
dense_row_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap res_map,
                 const __grid_constant__ CUtensorMap out_map, const RowShape shape,
                 const typename Epi::Params ep) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int rank = static_cast<int>(cluster_ctarank());
  const RowBars bars{base + kRowOffBar};
  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();  // the swizzled boxes need 1024-byte alignment
    for (int s = 0; s < kRowStages; ++s) {
      mbar_init(bars.full(s), 1);
      mbar_init(bars.empty(s), 8 * kRowCluster);  // every consumer warp of every block
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the peers' barriers exist before any multicast or remote arrival

  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256)
      row_producer<Epi, kTransB>(&a_map, &w_map, &res_map, shape, base, rank);
  } else if (role == 0) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    row_consumer<Epi, kTransB, 0>(&out_map, shape, ep, base, rank, threadIdx.x);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    row_consumer<Epi, kTransB, 1>(&out_map, shape, ep, base, rank, threadIdx.x - 128);
  }
  cluster_sync();  // no block leaves while a peer may still write to it or arrive on its barriers
}

template <class Epi>
constexpr uint32_t row_smem() {
  static_assert(kRowOffEpi + Epi::kSmem <= kSmemLimit, "227 KB a block");
  return kRowOffEpi + Epi::kSmem;
}

inline cudaLaunchConfig_t row_config(cudaLaunchAttribute* attr, int blocks, uint32_t smem,
                                     cudaStream_t stream, int cluster = kRowCluster) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kRowThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of a row kernel the card holds at once, asked once per kernel.
// `static`: each source that includes this header keeps its own cache, and
// so does each library built from a tree of them (a static local of a
// function with external linkage is one object per process, shared by every
// library loaded into it that instantiates the same template).
template <class Epi, bool kTransB>
static int row_clusters(int* clusters) {
  static int cached = 0;
  if (cached == 0) {
    auto kernel = dense_row_kernel<Epi, kTransB>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           row_smem<Epi>());
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = row_config(&attr, kRowCluster, row_smem<Epi>(), nullptr);
    err = cudaOccupancyMaxActiveClusters(&cached, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cached < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  *clusters = cached;
  return 0;
}

// The row pass over a (rows, 64 n_chunks) and W through `w_map` (boxes of
// 64 x 64; read MN-major with kTransB) into out (rows, 384); res (rows, 384)
// for an epilogue that loads it, else unread.
template <class Epi, bool kTransB>
int launch_rows(const void* a, const CUtensorMap& w_map, const void* res, void* out, int rows,
                int n_chunks, const typename Epi::Params& ep, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap a_map, res_map, out_map;
  if (!encode_2d(&a_map, encode, a, static_cast<long long>(kTile) * n_chunks, rows, kTile) ||
      !encode_2d(&out_map, encode, out, kWidth, rows, kTile) ||
      !encode_2d(&res_map, encode, Epi::kLoadsRes ? res : out, kWidth, rows, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  int clusters = 0;
  const int err0 = row_clusters<Epi, kTransB>(&clusters);
  if (err0 != 0) return err0;
  RowShape shape{rows, n_chunks, (rows + kTile - 1) / kTile, 0};
  shape.n_groups = (shape.n_tiles + kRowCluster - 1) / kRowCluster;
  if (clusters > shape.n_groups) clusters = shape.n_groups;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = row_config(&attr, clusters * kRowCluster, row_smem<Epi>(), stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, dense_row_kernel<Epi, kTransB>, a_map, w_map,
                                             res_map, out_map, shape, ep);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A map over W (384, n) (w_layout 0) or, as nn.Linear keeps it, (n, 384)
// (w_layout 1), in 64 x 64 boxes: a box at (col, row) of the map holds 64
// values of the stored rows' contiguous axis.
inline bool encode_w(CUtensorMap* map, EncodeTiledFn encode, const void* w, int w_layout, int n) {
  return w_layout == 0 ? encode_2d(map, encode, w, n, kWidth, kTile)
                       : encode_2d(map, encode, w, kWidth, n, kTile);
}

// ---- LayerNorm ------------------------------------------------------------------

// bf16(LN(x)) of every row of x (rows x kD) into `ln`: fp32 statistics with
// the fast variance E[x^2] - mean^2 clamped at 0, then bf16((x - mean) inv
// gamma + beta). One warp a row, 16-byte loads and stores, eight rows a
// block. attn_block.cu runs it once per image for both of its kernels, which
// take LN(x) as TMA boxes; ln_gemm_sm90.cu for K9b's dW kernel.
template <int kD>
__global__ void __launch_bounds__(256) ln_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                                      const float* __restrict__ gamma,
                                                      const float* __restrict__ beta, float eps,
                                                      long long rows,
                                                      __nv_bfloat16* __restrict__ ln) {
  constexpr int kPer = (kD / 8 + 31) / 32;  // 16-byte chunks a lane
  const long long row = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  uint4 v[kPer];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < kD / 8 ? *reinterpret_cast<const uint4*>(x + row * kD + 8 * c) : make_uint4(0, 0, 0, 0);
    const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = mlp::unpack_bf16(w[e]);
      sum += f.x + f.y;
      sq += f.x * f.x + f.y * f.y;
    }
  }
  const float mean = warp_sum(sum) * (1.f / kD);
  const float inv = rsqrtf(fmaxf(warp_sum(sq) * (1.f / kD) - mean * mean, 0.f) + eps);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    if (c >= kD / 8) continue;
    const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // gamma, beta: 8-byte aligned
      const float2 f = mlp::unpack_bf16(w[e]);
      const float2 gm = *reinterpret_cast<const float2*>(gamma + 8 * c + 2 * e);
      const float2 bt = *reinterpret_cast<const float2*>(beta + 8 * c + 2 * e);
      o[e] = pack_bf16((f.x - mean) * inv * gm.x + bt.x, (f.y - mean) * inv * gm.y + bt.y);
    }
    *reinterpret_cast<uint4*>(ln + row * kD + 8 * c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <int kD>
int ln_launch(const void* x, const void* gamma, const void* beta, void* ln, long long rows,
              float eps, cudaStream_t stream) {
  ln_rows_kernel<kD><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), eps, rows, static_cast<__nv_bfloat16*>(ln));
  return static_cast<int>(cudaGetLastError());
}

// ---- the LayerNorm backward as the row pass's epilogue ---------------------------
// dln = A . W^T from the row pass in acc; per 64-row tile
//   dx = [dy +] inv (dln gamma - mean(dln gamma) - xhat mean(dln gamma xhat))
// and the tile's dgamma = sum dln xhat, dbeta = sum dln column sums into
// row_part. K8b's dx tail (attn_block.cu) adds its cotangent dy (kResidual);
// K9b's (ln_gemm_sm90.cu) has none.
//
// The producer loads the tile's x (six 64 x 64 boxes, 48 KB) by TMA into the
// epilogue's stage, as K9c loads res (kLoadsRes): the row statistics and xhat
// come from shared memory, and dx is written back in place of x and leaves by
// TMA stores (rows past the end clipped). The stage's seventh box, A's slot,
// which the epilogue does not load, holds the column sums: 4 warps x 192
// columns x (dgamma, dbeta) of fp32 are 6 KB a warpgroup, 12 KB for both, so
// each warpgroup reduces its columns in two halves of 96 (3 KB each) through
// its own 3 KB of the box. The row sums of both warpgroups (1 KB) and the
// rows' (mean, 1 / sigma) (0.5 KB) take the epilogue's own bytes beyond the
// ring, of which 227 KB leave 2.9 KB. The arithmetic and its order are the
// ones of the epilogue that read x from device memory before it, so K8b gives
// the same bits: each row's statistics from the same lanes' 16-byte chunks
// in the same order, the column sums over the warps in warp order.

struct DxParams {
  const __nv_bfloat16* dy;  // kResidual: (rows, 384), added to dx
  const float* gamma;
  float* row_part;  // (n_tiles, 2, 384): dgamma | dbeta per 64-row tile
  float eps;
  int rows, n_tiles;
};

// mean and 1 / sigma (fast variance, clamped at 0) of four rows of the tile
// at `x` (rows[r] a row of the tile) by one warp, 16-byte chunks in lane
// order; a row at or past n gives (0, 0).
__device__ __forceinline__ void row_stats4(uint32_t x, const int (&rows)[4], int n, float eps,
                                           int lane, float (&mean)[4], float (&inv)[4]) {
  float sum[4], sq[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    sum[r] = 0.f;
    sq[r] = 0.f;
    if (rows[r] < n) {
#pragma unroll
      for (int c = lane; c < kWidth / 8; c += 32) {
        const uint4 v = ld_shared_v4(x + chunk_at(rows[r], c));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = mlp::unpack_bf16(w[e]);
          sum[r] += f.x + f.y;
          sq[r] += f.x * f.x + f.y * f.y;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float m = warp_sum(sum[r]) * (1.f / kWidth);
    const float var = warp_sum(sq[r]) * (1.f / kWidth) - m * m;
    const bool ok = rows[r] < n;
    mean[r] = ok ? m : 0.f;
    inv[r] = ok ? rsqrtf(fmaxf(var, 0.f) + eps) : 0.f;
  }
}

// The LayerNorm backward of the tile's rows row0 + ra, + rb (this thread's),
// columns 192 kWg + 8i + 2t4, + 1, from dln in acc and x at `io` (six boxes);
// each row's mean and 1 / sigma at `stats`; the two warpgroups' row halves
// meet at `row_red` (warpgroup 0's first), the warps' column sums at
// `col_red` (3 KB a warpgroup) in a fixed order. Rows past the end hold dln = 0
// and x = 0; they are not stored, nor are a tile's sums past the last.
template <bool kResidual, int kWg>
__device__ __forceinline__ void dx_epilogue(const float (&acc)[96], const DxParams& prm,
                                            const CUtensorMap* out_map, uint32_t io,
                                            uint32_t stats, uint32_t row_red, uint32_t col_red,
                                            int tile, int tid) {
  tid = static_cast<int>(opaque(static_cast<uint32_t>(tid)));
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = 16 * warp + g, rb = ra + 8, row0 = kTile * tile;
  const float2 sa = ld_shared_f2(stats + 8 * ra);
  const float2 sb = ld_shared_f2(stats + 8 * rb);
  auto at = [&](int r, int col) { return io + (col >> 6) * kBox + swz(r, col & 63); };
  col_red += kWg * (4 * 96 * 8);
  float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
  float* part = prm.row_part + static_cast<size_t>(tile) * 2 * kWidth + 192 * kWg;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int i = 12 * half; i < 12 * half + 12; ++i) {
      const int c = 8 * i + 2 * t4, col = 192 * kWg + c;
      const float2 gam = *reinterpret_cast<const float2*>(prm.gamma + col);
      const float2 xa = mlp::unpack_bf16(ld_shared_u32(at(ra, col)));
      const float2 xb = mlp::unpack_bf16(ld_shared_u32(at(rb, col)));
      const float ha0 = (xa.x - sa.x) * sa.y, ha1 = (xa.y - sa.x) * sa.y;
      const float hb0 = (xb.x - sb.x) * sb.y, hb1 = (xb.y - sb.x) * sb.y;
      const float da0 = acc[4 * i] * gam.x, da1 = acc[4 * i + 1] * gam.y;
      const float db0 = acc[4 * i + 2] * gam.x, db1 = acc[4 * i + 3] * gam.y;
      s1a += da0 + da1;
      s2a += da0 * ha0 + da1 * ha1;
      s1b += db0 + db1;
      s2b += db0 * hb0 + db1 * hb1;
      float pg0 = acc[4 * i] * ha0 + acc[4 * i + 2] * hb0;
      float pg1 = acc[4 * i + 1] * ha1 + acc[4 * i + 3] * hb1;
      float pb0 = acc[4 * i] + acc[4 * i + 2], pb1 = acc[4 * i + 1] + acc[4 * i + 3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        pg0 += __shfl_xor_sync(0xffffffffu, pg0, off);
        pg1 += __shfl_xor_sync(0xffffffffu, pg1, off);
        pb0 += __shfl_xor_sync(0xffffffffu, pb0, off);
        pb1 += __shfl_xor_sync(0xffffffffu, pb1, off);
      }
      if (g == 0) {
        const uint32_t dst = col_red + (warp * 96 + c - 96 * half) * 8;
        st_shared_f32(dst, pg0);
        st_shared_f32(dst + 4, pb0);
        st_shared_f32(dst + 8, pg1);
        st_shared_f32(dst + 12, pb1);
      }
    }
    named_sync(2 + kWg, 128);  // the four warps' sums of the half's 96 columns
    for (int c = tid; c < 96 && tile < prm.n_tiles; c += 128) {
      float dg = 0.f, db = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        dg += ld_shared_f32(col_red + (w * 96 + c) * 8);
        db += ld_shared_f32(col_red + (w * 96 + c) * 8 + 4);
      }
      part[96 * half + c] = dg;
      part[kWidth + 96 * half + c] = db;
    }
    named_sync(2 + kWg, 128);  // read before the next half, or the producer, writes there
  }
  s1a = quad_sum(s1a);
  s2a = quad_sum(s2a);
  s1b = quad_sum(s1b);
  s2b = quad_sum(s2b);
  if (t4 == 0) {
    st_shared_f32(row_red + (kWg * kTile + ra) * 8, s1a);
    st_shared_f32(row_red + (kWg * kTile + ra) * 8 + 4, s2a);
    st_shared_f32(row_red + (kWg * kTile + rb) * 8, s1b);
    st_shared_f32(row_red + (kWg * kTile + rb) * 8 + 4, s2b);
  }
  named_sync(1, 256);  // both halves of every row
  auto row_mean = [&](int r, int k) {
    return (ld_shared_f32(row_red + r * 8 + 4 * k) +
            ld_shared_f32(row_red + (kTile + r) * 8 + 4 * k)) * (1.f / kWidth);
  };
  const float m1a = row_mean(ra, 0), m2a = row_mean(ra, 1);
  const float m1b = row_mean(rb, 0), m2b = row_mean(rb, 1);
  // element offsets of the two rows in dy (rows x 3 D < 2^31); a row past the
  // end reads the last one's, and is not stored
  [[maybe_unused]] const int dy_a = min(row0 + ra, prm.rows - 1) * kWidth;
  [[maybe_unused]] const int dy_b = min(row0 + rb, prm.rows - 1) * kWidth;
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int col = 192 * kWg + 8 * i + 2 * t4;
    const float2 gam = *reinterpret_cast<const float2*>(prm.gamma + col);
    const uint32_t xa_at = at(ra, col), xb_at = at(rb, col);
    const float2 xa = mlp::unpack_bf16(ld_shared_u32(xa_at));
    const float2 xb = mlp::unpack_bf16(ld_shared_u32(xb_at));
    const float ha0 = (xa.x - sa.x) * sa.y, ha1 = (xa.y - sa.x) * sa.y;
    const float hb0 = (xb.x - sb.x) * sb.y, hb1 = (xb.y - sb.x) * sb.y;
    // one expression each, as the epilogue that read x from device memory wrote
    // them: the same contractions, the same bits
    if constexpr (kResidual) {
      const float2 dya = mlp::unpack_bf16(*reinterpret_cast<const uint32_t*>(prm.dy + dy_a + col));
      const float2 dyb = mlp::unpack_bf16(*reinterpret_cast<const uint32_t*>(prm.dy + dy_b + col));
      st_shared_u32(xa_at, pack_bf16(dya.x + sa.y * (acc[4 * i] * gam.x - m1a - ha0 * m2a),
                                     dya.y + sa.y * (acc[4 * i + 1] * gam.y - m1a - ha1 * m2a)));
      st_shared_u32(xb_at, pack_bf16(dyb.x + sb.y * (acc[4 * i + 2] * gam.x - m1b - hb0 * m2b),
                                     dyb.y + sb.y * (acc[4 * i + 3] * gam.y - m1b - hb1 * m2b)));
    } else {
      st_shared_u32(xa_at, pack_bf16(sa.y * (acc[4 * i] * gam.x - m1a - ha0 * m2a),
                                     sa.y * (acc[4 * i + 1] * gam.y - m1a - ha1 * m2a)));
      st_shared_u32(xb_at, pack_bf16(sb.y * (acc[4 * i + 2] * gam.x - m1b - hb0 * m2b),
                                     sb.y * (acc[4 * i + 3] * gam.y - m1b - hb1 * m2b)));
    }
  }
  fence_proxy_async();       // the generic stores, before TMA reads them
  named_sync(2 + kWg, 128);  // the warpgroup's three boxes, whole
  if (tid == 0 && tile < prm.n_tiles) {
    for (int j = 0; j < 3; ++j)
      tma_store_2d(out_map, io + (3 * kWg + j) * kBox, kTile * (3 * kWg + j), kTile * tile);
    bulk_commit();
    bulk_wait_read<0>();
  }
  named_sync(2 + kWg, 128);  // TMA has read the boxes: the stage may be refilled
}

// The hooks on the row pass. The epilogue first takes each row's statistics
// from x in the stage (each warp eight rows of the 64, four at a time), then
// runs dx_epilogue.
template <bool kResidual>
struct LnBackward {
  using Params = DxParams;
  static constexpr bool kLoadsRes = true;  // x, into the epilogue's stage
  // (mean, inv) of the tile's rows, then the row sums of both warpgroups
  static constexpr uint32_t kSmem = 3 * kTile * 8;

  template <int kWg>
  __device__ static void epilogue(const float (&acc)[96], const DxParams& prm,
                                  const CUtensorMap* out_map, uint32_t io, uint32_t base, int tile,
                                  const RowShape&, int tid) {
    const uint32_t stats = base + kRowOffEpi;
    {
      const int warp = static_cast<int>(opaque(static_cast<uint32_t>(tid))) >> 5, lane = tid & 31;
      const int r0 = 32 * kWg + 8 * warp;
      for (int j = 0; j < 8; j += 4) {
        int rows[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rows[r] = r0 + j + r;
        float mean[4], inv[4];
        row_stats4(io, rows, prm.rows - kTile * tile, prm.eps, lane, mean, inv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (lane == r) st_shared_f2(stats + 8 * (r0 + j + r), mean[r], inv[r]);
      }
    }
    named_sync(1, 256);  // every row's statistics
    dx_epilogue<kResidual, kWg>(acc, prm, out_map, io, stats, stats + kTile * 8, io - kBox, tile,
                                tid);
  }
};

// The entry points of dense_sm90.cu (dense.cu dispatches to them at width
// 384). bf16 tensors, contiguous and 16-byte aligned; each launches on
// `stream`, allocates nothing and returns a CUDA error code.
//
// The backward of y = x . W + b with x, dx (rows, 384), dy (rows, n), n a
// multiple of 64; W (384, n) (w_layout 0) or, as nn.Linear keeps it, (n, 384)
// (w_layout 1). grads (out): 384 n + n fp32 = dW (384, n) | db; w_part, fp32,
// contents undefined on entry: (groups, 384 n + n), 1 <= groups <= ceil(rows /
// 64).
int bwd(const void* x, const void* dy, const void* w, int w_layout, void* dx, void* grads,
        void* w_part, int rows, int n, int groups, cudaStream_t stream);
// y = res + bf16(a . w + b): res, y (rows, 384); a (rows, f); w (f, 384); b
// (384,); f 384 or 768.
int gemm_res_fwd(const void* res, const void* a, const void* w, const void* b, void* y, int rows,
                 int f, cudaStream_t stream);

// The entry points of ln_gemm_sm90.cu. y (rows, n) = bf16(LN(x)) . W + b: x
// (rows, 384); gamma, beta (384,) fp32; W as above by w_layout; b (n,); n a
// multiple of 64.
int ln_gemm_fwd(const void* x, const void* gamma, const void* beta, const void* w, int w_layout,
                const void* b, void* y, int rows, int n, float eps, cudaStream_t stream);
// Its gradients at dy (rows, n): dx (rows, 384); grads (out): 384 n + n + 2 x 384
// fp32 = dW | db | dgamma | dbeta. Workspaces, contents undefined on entry:
// w_part as bwd's, row_part (ceil(rows / 64), 2 x 384) fp32, ln_work (rows,
// 384) bf16.
int ln_gemm_bwd(const void* x, const void* dy, const void* gamma, const void* beta, const void* w,
                int w_layout, void* dx, void* grads, void* w_part, void* row_part, void* ln_work,
                int rows, int n, int groups, float eps, cudaStream_t stream);

}  // namespace dense_sm90
