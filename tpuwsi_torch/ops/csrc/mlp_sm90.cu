// Fused transformer MLP at D = 384 (ViT-S), forward and backward, alone and
// as the pre-norm sub-block, written for Hopper: every product a wgmma from
// 128-byte swizzled shared memory, every load a TMA issued by a producer
// thread into mbarrier-tracked stages, the operands that several blocks share
// multicast across a thread-block cluster, and a grid of at most one block
// per SM that walks its work.
//
// Replaces four TPU kernels of tpuwsi/ops/mlp.py (K5f, K5b, K6f, K6b):
//   `mlp_row_kernel<false, false>`  :83  `_mlp_fwd_kernel`  (pallas_call at :160)
//       y = bf16(bf16(gelu(x . W1 + b1)) . W2 + b2)
//   `mlp_row_kernel<true, false>` (dx), `mlp_dw_kernel<1>`, `mlp_dw_kernel<2>` (dW)
//                                   :100 `_mlp_bwd_kernel`  (pallas_call at :185)
//       u = x . W1 + b1 (fp32), h = bf16(gelu(u)), du = (dy . W2^T) * gelu'(u),
//       du_c = bf16(du); dx = bf16(du_c . W1^T); dW1 = x^T . du_c,
//       dW2 = h^T . dy, db1 = sum du, db2 = sum dy (fp32, over all rows)
//   `mlp_row_kernel<false, true>`   :485 `_mlp_block_fwd_kernel` (pallas_call at :584)
//       y = bf16(x + bf16(bf16(gelu(a . W1 + b1)) . W2 + b2)), a = bf16(LN(x))
//   `mlp_row_kernel<true, true>` (LN(x), dln, dx), `mlp_dw_kernel<1>`, `<2>` on a
//                                   :508 `_mlp_block_bwd_kernel` (pallas_call at :612)
//       K5b's arithmetic on a, whose dx is dln (fp32); with xhat = (x - mean)
//       inv and dxhat = dln gamma: dx = bf16(dy + inv (dxhat - mean(dxhat) -
//       xhat mean(dxhat xhat))), dgamma = sum dln xhat, dbeta = sum dln
// with the arithmetic of mlp_fwd.cu / mlp_bwd.cu: fp32 accumulation, the
// bias added in fp32, gelu in tanh or erf form (mlp_common.cuh), LayerNorm in
// fp32 with the fast variance E[x^2] - mean^2 clamped at 0. x, dy, y, dx:
// (rows, 384) bf16; W1 (384, F), W2 (F, 384), b1, b2 bf16; gamma, beta (384,)
// fp32; F a multiple of 64. Rows past the end read as zeros (TMA fills them)
// and are never written; a zero row of x still gives h = gelu(b1) (LN(x) =
// beta for the sub-block), and it is dy = 0 there that keeps the weight
// gradients clean. D = 768 keeps the kernels of mlp_fwd.cu and mlp_bwd.cu.
//
// What bounds them on an H100 (published peaks of the SXM part at 700 W:
// 989 TFLOP/s dense bf16, 3.35 TB/s) at the DINO step's student global views
// (rows, D, F) = (37,824, 384, 1,536): the forward's two products are
// 89 GFLOP, 0.090 ms at the dense bf16 peak, against 61 MB to move (0.018
// ms); the backward's five are 223 GFLOP, 0.226 ms, against 99 MB (0.030
// ms). The sub-block's LayerNorm (~10 operations an element) and residual
// (one more read of x, not counted: the bound counts x once) move neither:
// K6b is 223 GFLOP against 99 MB as well, and K6f at a 500-tile serving
// chunk (128,500 rows) 303 GFLOP, 0.307 ms, against 200 MB (0.060 ms). All
// four are bound by the tensor cores. What stands between a kernel and that
// bound on this card is not device memory but three things the TPU kernels
// never met: the register file, shared-memory bandwidth, and the L2 traffic
// of weights (or rows) that every block reads again.
//
// The reckoning behind the design:
//   - Registers. A (64 rows, 384) fp32 accumulator is 24,576 values: 192 a
//     thread of one warpgroup, 96 if two warpgroups split the columns. So a
//     block owns a row tile of 64 rows and two consumer warpgroups each own
//     192 output columns (96 accumulators), with room left for the chunk's
//     u^T and dh^T (16 each). A block is those two warpgroups and one
//     producer warp, 288 threads, which ptxas gives at most 168 registers a
//     thread (nine warps on the SM's four schedulers, three on one: 16,384
//     / 96 = 170); it uses 161-168 and spills nothing, with no slack left:
//     a value hoisted out of the tile loop spills (see ln_rows). (A
//     producer warpgroup with setmaxnreg 24/240 runs these kernels no
//     faster and spills in one of them: see PERF.md.)
//   - The products that rebuild the hidden activation are written transposed,
//     u^T = W1c^T . x^T (M = 64 hidden units, N = 32 rows of one warpgroup,
//     K = 384), so that M is the 64 that a wgmma needs while each warpgroup
//     takes only its own 32 rows and no product is computed twice. gelu(u)^T
//     (or du^T) goes to a (64 hidden, 64 rows) bf16 tile in shared memory,
//     swizzled as TMA would write it, and is the MN-major A operand (K-major
//     in the dW pass) of the product that follows.
//   - Shared memory. W1[:, chunk] and W2[chunk, :] (48 KB each per 64 hidden
//     units) do not fit beside the row tiles twice, so they stream in
//     half-stages of 24 KB (three 64 x 64 boxes) through a ring: six stages
//     forward, four in the dx pass; the dW passes keep their slice of W1
//     (and W2: 96 KB) and stream x and dy in stages of 32 rows (48 KB), two
//     or three of them.
//   - L2 traffic. Every 64-row tile needs all of W1 and W2 (2.36 MB): 591
//     tiles read 1.4 GB at this shape, as the old kernels did. A cluster of
//     four blocks takes four neighbouring row tiles and walks the same weight
//     stream: each block loads a quarter of every box (16 of its 64 rows) and
//     multicasts it to all four, so L2 serves 0.35 GB. In the dW pass the
//     four blocks of a cluster take four neighbouring hidden slices of the
//     same rows, and each loads three of the twelve boxes of an x/dy stage
//     for all: 6 slice clusters x 58 MB = 0.35 GB where the old 24 slices
//     read 1.4 GB.
//   - The grid. The forward and the dx pass launch as many clusters as the
//     card holds at once (cudaOccupancyMaxActiveClusters), each walking row
//     tiles; the result does not depend on the grid. The dW passes launch
//     groups x ceil(F / 256) clusters, groups = SMs / (4 ceil(F / 256)) (5
//     on 132 SMs at F = 1,536, at most one block per SM), each walking the
//     ~237 stages of its row group: the weight-gradient partials are 5 x 4.7
//     MB (the old kernel wrote 22, 104 MB). The caller computes groups from
//     the shapes and the SM count alone and sums the partials in a fixed
//     order afterwards, so two launches give the same bits.
//   - The backward is a dx pass and two dW passes (dW1 with db1, then dW2):
//     dx sums over hidden units and dW over rows, no block can hold both
//     accumulators, and one block cannot hold dW1 and dW2 of a slice either
//     (192 accumulators a thread). That is 8 products where one pass would
//     need 5 (u^T is rebuilt in all three passes, dh^T in two); the
//     alternative, atomics, sums in an order that changes between runs.
//   - What bounds these kernels now (PERF.md, PR 11): the bytes each SM
//     takes in. With every product and the GELU cut out, the forward keeps
//     44% of its time and the backward 61%: every 64-row tile still takes
//     in all of W1 and W2 (2.36 MB), every dW block all of x and dy, and
//     the parts that remain run one after the other rather than under the
//     loads.
//   - The sub-block (K6f, K6b) is the row kernel with a prologue and an
//     epilogue. Once the x tile has landed, each consumer warpgroup
//     normalises, in place, the 32 rows it alone reads as the B operand
//     (four threads a row, 16-byte chunks at their swizzled places), and
//     fences the generic stores for the async proxy before its first wgmma.
//     The forward's epilogue adds x, re-read from device memory: the tile
//     holds LN(x) and is released before the epilogue, and a second copy
//     does not fit beside the ring (208 of 227 KB). The dx pass also stores
//     LN(x) to a (rows, D) workspace, which the dW passes read in place of
//     x, and keeps each row's mean and 1/sigma; its epilogue turns dln (64
//     rows x 192 columns a warpgroup) into dx. The two row means that needs
//     meet across the warpgroups in shared memory, and dgamma, dbeta leave
//     as column sums per row tile beside db2, for the same fixed-order sums.
//
// Plain C++ entry points for mlp_fwd.cu and mlp_bwd.cu, which keep the C
// interface; they launch on the caller's stream, allocate nothing and return
// a CUDA error code. The tensor maps are encoded on the host at each launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mlp_common.cuh"

namespace {

using namespace hopper;

constexpr int kD = 384;
constexpr int kH = 64;              // hidden units of a chunk (forward, dx) or a slice (dW)
constexpr int kRows = 64;           // rows of a row tile (forward, dx)
constexpr int kStageRows = 32;      // rows of an x/dy stage (dW)
constexpr int kCluster = 4;         // blocks of a cluster
constexpr uint16_t kClusterMask = (1u << kCluster) - 1;
constexpr int kQuarter = 64 / kCluster;  // rows of a weight box each block of a cluster loads
constexpr uint32_t kBox = 64 * 128;      // 64 rows of 128 bytes (64 bf16)
constexpr uint32_t kHalf = 3 * kBox;     // a weight half-stage: three boxes
// two consumer warpgroups and one producer warp: 65,536 / 288 = 224 registers
// a thread (see the reckoning above)
constexpr int kThreads = 288;
constexpr int kConsumerThreads = 256;

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
// 64 columns: the 16-byte chunk c of row r sits at chunk c ^ (r & 7).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return static_cast<uint32_t>(row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2);
}

// Each warp's lane 0 arrives once for the warp, after the warp's reads.
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// The same on the barrier at offset `bar` of every block of the cluster:
// lane r signals the block of rank r, all at once.
__device__ __forceinline__ void warp_arrive_cluster(uint32_t bar) {
  __syncwarp();
  const uint32_t lane = threadIdx.x & 31;
  if (lane < kCluster) mbar_arrive_cluster(bar, lane);
}

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
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

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// wgmma m64nNk16, A and B both from shared memory: kTransA / kTransB = 1
// reads that operand MN-major (bf16 allows it), 0 K-major. Fragment
// ownership of the fp32 result (PTX ISA): warp w of the warpgroup holds rows
// 16w..16w+15; lane 4g + t holds rows 16w+g and 16w+g+8 and, of each 8-column
// group i, columns 8i+2t and 8i+2t+1 (regs 4i, 4i+1 for the first row, 4i+2,
// 4i+3 for the second).
template <int kTransA, int kTransB>
__device__ __forceinline__ void ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void ss_n192(float (&d)[96], uint64_t desc_a, uint64_t desc_b,
                                        int accumulate) {
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
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}


// ---------------------------------------------------------------------------
// The row kernels: the forward (K5f; K6f with kBlock) and the dx pass of the
// backward (K5b; K6b with kBlock)
// ---------------------------------------------------------------------------
// A block owns a tile of 64 rows at a time; its cluster takes four
// neighbouring tiles and shares their weight stream. Per chunk of 64 hidden
// units, warpgroup w (rows 32w..32w+31 of the tile for the products that
// build the chunk, output columns 192w..192w+191 for the one that uses it):
//   forward: u^T = W1c^T . x^T                       -> h^T tile
//            y[:, cols] += h . W2c[:, cols]
//   dx:      dh^T = W2c . dy^T, u^T = W1c^T . x^T     -> du^T tile
//            dx[:, cols] += du_c . W1c[cols, :]^T     (W1c rows = D)
// The chunk's four weight half-stages arrive in the order the products take
// them: W1 rows 0-191, 192-383 then W2 columns 0-191, 192-383 (forward);
// W2 first in the dx pass, so that W2 of the next chunk loads while this
// chunk's last product still holds W1. Each block waits and releases every
// half-stage, used or not, so that every stage's release counts are alike.
// With kBlock the x tile is normalised in place first (x then stands for
// LN(x) above), and the epilogue adds the residual (forward) or turns dln
// into the LayerNorm's dx (dx pass).

struct RowParams {
  const __nv_bfloat16* b1;  // (F,)
  const __nv_bfloat16* b2;  // (D,), forward
  __nv_bfloat16* out;       // y or dx, (rows, D)
  // dx pass: per row tile, the column sums of dy (db2) and, for the
  // sub-block, of dln xhat (dgamma) and dln (dbeta): (n_tiles, D) or
  // (n_tiles, 3, D), part_stride floats a tile
  float* row_part;
  // the sub-block (kBlock)
  const __nv_bfloat16* x;   // (rows, D), re-read by the epilogue
  const __nv_bfloat16* dy;  // (rows, D), dx pass: the residual's gradient
  const float* gamma;       // (D,)
  const float* beta;        // (D,)
  __nv_bfloat16* ln_out;    // dx pass: bf16 LN(x), (rows, D), for the dW passes
  float eps;
  int rows, f, n_tiles, n_groups;  // n_groups = ceil(n_tiles / kCluster)
  int part_stride;
};

template <bool kBwd>
struct RowLayout {
  static constexpr int kStages = kBwd ? 4 : 6;
  static constexpr uint32_t kOffDy = 6 * kBox;                 // dx pass
  static constexpr uint32_t kXBytes = (kBwd ? 12 : 6) * kBox;  // x (and dy) of a tile
  static constexpr uint32_t kOffT = kXBytes;                   // two h^T / du^T tiles
  static constexpr uint32_t kOffRing = kOffT + 2 * kBox;
  // the sub-block's dx pass: each row's mean and 1/sigma (float pairs, for
  // two tiles: one warpgroup may normalise the next tile while the other
  // still reads this one's), the row sums of both warpgroups (pairs) and the
  // column sums of their four warps (pairs, 192 columns a warpgroup)
  static constexpr uint32_t kOffStats = kOffRing + kStages * kHalf;
  static constexpr uint32_t kOffRowRed = kOffStats + (kBwd ? 2 * kRows * 8 : 0);
  static constexpr uint32_t kOffColRed = kOffRowRed + (kBwd ? 2 * kRows * 8 : 0);
  static constexpr uint32_t kOffBar = kOffColRed + (kBwd ? 2 * 4 * 192 * 8 : 0);
  // x full, x empty, stage full[kStages], stage empty[kStages]
  static constexpr uint32_t kSmem = kOffBar + 8 * (2 + 2 * kStages);
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
  __device__ static uint32_t x_full(uint32_t base) { return base + kOffBar; }
  __device__ static uint32_t x_empty(uint32_t base) { return base + kOffBar + 8; }
  __device__ static uint32_t full(uint32_t base, uint32_t s) { return base + kOffBar + 16 + 8 * s; }
  __device__ static uint32_t empty(uint32_t base, uint32_t s) {
    return base + kOffBar + 16 + 8 * (kStages + s);
  }
  __device__ static uint32_t stage(uint32_t base, uint32_t it) {
    return base + kOffRing + (it % kStages) * kHalf;
  }
  // whether half-stage q (0..3) of a chunk holds W1 (rows of D) or W2 (columns)
  __device__ static constexpr bool is_w1(int q) { return kBwd ? q >= 2 : q < 2; }
};

template <bool kBwd>
__device__ __forceinline__ void row_producer(const CUtensorMap* x_map, const CUtensorMap* dy_map,
                                             const CUtensorMap* w1_map,
                                             const CUtensorMap* w2_map, const RowParams& prm,
                                             uint32_t base, int rank) {
  using L = RowLayout<kBwd>;
  const int n_chunks = prm.f / kH;
  const int cluster = blockIdx.x / kCluster, n_clusters = gridDim.x / kCluster;
  uint32_t it = 0;
  int tc = 0;
  for (int grp = cluster; grp < prm.n_groups; grp += n_clusters, ++tc) {
    const int row0 = (grp * kCluster + rank) * kRows;
    if (tc > 0) mbar_wait(L::x_empty(base), (tc - 1) & 1);
    mbar_expect_tx(L::x_full(base), L::kXBytes);
    for (int j = 0; j < 6; ++j) {
      tma_load_2d(base + j * kBox, x_map, L::x_full(base), 64 * j, row0);
      if constexpr (kBwd) tma_load_2d(base + L::kOffDy + j * kBox, dy_map, L::x_full(base), 64 * j, row0);
    }
    for (int c = 0; c < n_chunks; ++c) {
      for (int q = 0; q < 4; ++q, ++it) {
        const uint32_t s = it % L::kStages;
        if (it >= L::kStages) mbar_wait(L::empty(base, s), ((it / L::kStages) - 1) & 1);
        mbar_expect_tx(L::full(base, s), kHalf);
        const uint32_t dst = L::stage(base, it) + rank * (kQuarter * 128);
        const int half = q & 1;
        for (int j = 0; j < 3; ++j) {
          if (L::is_w1(q))
            tma_load_2d_multicast(dst + j * kBox, w1_map, L::full(base, s), kH * c,
                                  192 * half + 64 * j + kQuarter * rank, kClusterMask);
          else
            tma_load_2d_multicast(dst + j * kBox, w2_map, L::full(base, s), 192 * half + 64 * j,
                                  kH * c + kQuarter * rank, kClusterMask);
        }
      }
    }
  }
}

// LayerNorm, in place, of the 32 rows of the x tile that warpgroup kWg reads
// as its B operand: four threads a row, each taking two 16-byte chunks of
// each of the six 64-column boxes. Of a row's eight (swizzled) chunks in a
// box, thread t takes the physical chunks t and t + 4, in the other order in
// an odd row, so that the eight threads of a quarter-warp (two rows) meet
// eight different chunks. The dx pass also stores the rows inside the batch
// to ln_out and each row's mean and 1/sigma to `stats`. Rows past the end
// hold TMA's zeros and normalise to beta. The thread's index passes through
// opaque() here and in the epilogues: what is computed from it stays inside
// the tile loop instead of being hoisted out of it into registers that the
// chunk loop would have to carry (ptxas spilled them at 168 registers).
template <bool kBwd, int kWg>
__device__ __forceinline__ void ln_rows(const RowParams& prm, uint32_t base, int row0, int tid,
                                        uint32_t stats) {
  tid = static_cast<int>(opaque(static_cast<uint32_t>(tid)));
  const int r = 32 * kWg + (tid >> 2), t = tid & 3;
  auto chunk = [&](int k) { return t + 4 * ((k & 1) ^ (r & 1)); };  // of box k >> 1
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const uint4 v = ld_shared_v4(base + (k >> 1) * kBox + r * 128 + (chunk(k) << 4));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = mlp::unpack_bf16(w[e]);
      sum += f.x + f.y;
      sq += f.x * f.x + f.y * f.y;
    }
  }
  const float mean = quad_sum(sum) * (1.f / kD);
  const float inv = rsqrtf(fmaxf(quad_sum(sq) * (1.f / kD) - mean * mean, 0.f) + prm.eps);
  const bool store = kBwd && row0 + r < prm.rows;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const uint32_t at = base + (k >> 1) * kBox + r * 128 + (chunk(k) << 4);
    const int col = 64 * (k >> 1) + 8 * (chunk(k) ^ (r & 7));
    const uint4 v = ld_shared_v4(at);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = mlp::unpack_bf16(w[e]);
      const float2 g = *reinterpret_cast<const float2*>(prm.gamma + col + 2 * e);
      const float2 b = *reinterpret_cast<const float2*>(prm.beta + col + 2 * e);
      o[e] = hopper::pack_bf16((f.x - mean) * inv * g.x + b.x, (f.y - mean) * inv * g.y + b.y);
    }
    const uint4 ln = make_uint4(o[0], o[1], o[2], o[3]);
    st_shared_v4(at, ln);
    if (store)
      *reinterpret_cast<uint4*>(prm.ln_out + static_cast<size_t>(row0 + r) * kD + col) = ln;
  }
  if (kBwd && t == 0) {
    st_shared_f32(stats + 8 * r, mean);
    st_shared_f32(stats + 8 * r + 4, inv);
  }
}

// The sub-block's dx pass, after the last chunk of the tc-th tile: acc holds
// dln at rows ra = 16 warp + g and rb = ra + 8 of the tile, columns 192 kWg +
// 8i + 2t and + 1. With xhat = (x - mean) inv (x re-read from device memory,
// mean and inv kept by the prologue) and dxhat = dln gamma:
//   dx = bf16(dy + inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)))
// and the tile's column sums dgamma = sum dln xhat, dbeta = sum dln. A row's
// two means need both warpgroups' columns: each sums its own over the quad's
// four threads, and the two halves meet in shared memory, added in the order
// warpgroup 0, 1. The column sums go over the warp's 16 rows by shuffles,
// then over the warpgroup's four warps in shared memory, in order. A row
// past the end has dln = 0 and reads the batch's last row of x in its place.
template <int kWg>
__device__ __forceinline__ void ln_backward_epilogue(const float (&acc)[96], const RowParams& prm,
                                                     uint32_t base, int tc, int tile, int row0,
                                                     int tid) {
  using L = RowLayout<true>;
  tid = static_cast<int>(opaque(static_cast<uint32_t>(tid)));
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;
  const uint32_t stats = base + L::kOffStats + (tc & 1) * (kRows * 8);
  const float mean_a = ld_shared_f32(stats + 8 * ra), inv_a = ld_shared_f32(stats + 8 * ra + 4);
  const float mean_b = ld_shared_f32(stats + 8 * rb), inv_b = ld_shared_f32(stats + 8 * rb + 4);
  // element offsets of the two rows (rows x D < 2^31)
  const int at_a = min(row0 + ra, prm.rows - 1) * kD, at_b = min(row0 + rb, prm.rows - 1) * kD;
  auto pair = [](const __nv_bfloat16* p, int at) {
    return mlp::unpack_bf16(*reinterpret_cast<const uint32_t*>(p + at));
  };
  const uint32_t col_red = base + L::kOffColRed + kWg * (4 * 192 * 8);
  const uint32_t row_red = base + L::kOffRowRed;
  float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int c = 8 * i + 2 * t, col = 192 * kWg + c;
    const float2 gam = *reinterpret_cast<const float2*>(prm.gamma + col);
    const float2 xa = pair(prm.x, at_a + col), xb = pair(prm.x, at_b + col);
    const float ha0 = (xa.x - mean_a) * inv_a, ha1 = (xa.y - mean_a) * inv_a;
    const float hb0 = (xb.x - mean_b) * inv_b, hb1 = (xb.y - mean_b) * inv_b;
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
      const uint32_t dst = col_red + (warp * 192 + c) * 8;
      st_shared_f32(dst, pg0);
      st_shared_f32(dst + 4, pb0);
      st_shared_f32(dst + 8, pg1);
      st_shared_f32(dst + 12, pb1);
    }
  }
  s1a = quad_sum(s1a);
  s2a = quad_sum(s2a);
  s1b = quad_sum(s1b);
  s2b = quad_sum(s2b);
  if (t == 0) {
    st_shared_f32(row_red + (kWg * kRows + ra) * 8, s1a);
    st_shared_f32(row_red + (kWg * kRows + ra) * 8 + 4, s2a);
    st_shared_f32(row_red + (kWg * kRows + rb) * 8, s1b);
    st_shared_f32(row_red + (kWg * kRows + rb) * 8 + 4, s2b);
  }
  named_sync(1, kConsumerThreads);  // both halves of every row; the four warps' column sums
  auto row_mean = [&](int r, int k) {
    const float half0 = ld_shared_f32(row_red + r * 8 + 4 * k);
    return (half0 + ld_shared_f32(row_red + (kRows + r) * 8 + 4 * k)) * (1.f / kD);
  };
  const float m1a = row_mean(ra, 0), m2a = row_mean(ra, 1);
  const float m1b = row_mean(rb, 0), m2b = row_mean(rb, 1);
  if (tile < prm.n_tiles) {
    float* part = prm.row_part + static_cast<size_t>(tile) * prm.part_stride + 192 * kWg;
    for (int c = tid; c < 192; c += 128) {
      float dg = 0.f, db = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        dg += ld_shared_f32(col_red + (w * 192 + c) * 8);
        db += ld_shared_f32(col_red + (w * 192 + c) * 8 + 4);
      }
      part[kD + c] = dg;
      part[2 * kD + c] = db;
    }
  }
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int col = 192 * kWg + 8 * i + 2 * t;
    const float2 gam = *reinterpret_cast<const float2*>(prm.gamma + col);
    if (row0 + ra < prm.rows) {
      const float2 xv = pair(prm.x, at_a + col), dyv = pair(prm.dy, at_a + col);
      const float h0 = (xv.x - mean_a) * inv_a, h1 = (xv.y - mean_a) * inv_a;
      *reinterpret_cast<uint32_t*>(prm.out + at_a + col) =
          hopper::pack_bf16(dyv.x + inv_a * (acc[4 * i] * gam.x - m1a - h0 * m2a),
                            dyv.y + inv_a * (acc[4 * i + 1] * gam.y - m1a - h1 * m2a));
    }
    if (row0 + rb < prm.rows) {
      const float2 xv = pair(prm.x, at_b + col), dyv = pair(prm.dy, at_b + col);
      const float h0 = (xv.x - mean_b) * inv_b, h1 = (xv.y - mean_b) * inv_b;
      *reinterpret_cast<uint32_t*>(prm.out + at_b + col) =
          hopper::pack_bf16(dyv.x + inv_b * (acc[4 * i + 2] * gam.x - m1b - h0 * m2b),
                            dyv.y + inv_b * (acc[4 * i + 3] * gam.y - m1b - h1 * m2b));
    }
  }
}

// One consumer warpgroup of a row kernel; kWg (0 or 1) is a template argument
// so that every branch around a wgmma is uniform by construction.
template <bool kBwd, bool kBlock, bool kApprox, int kWg>
__device__ __forceinline__ void row_consumer(const RowParams& prm, uint32_t base, int rank,
                                             int tid) {
  using L = RowLayout<kBwd>;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int hr = warp * 16 + g;  // this thread's first hidden row of a chunk (and hr + 8)
  const int n_chunks = prm.f / kH;
  const int cluster = blockIdx.x / kCluster, n_clusters = gridDim.x / kCluster;
  auto wait_stage = [&](uint32_t i) {
    mbar_wait(L::full(base, i % L::kStages), (i / L::kStages) & 1);
  };
  auto release = [&](uint32_t i) { warp_arrive_cluster(L::empty(base, i % L::kStages)); };

  uint32_t it = 0, cc = 0;  // half-stages and chunks taken so far
  int tc = 0;
  for (int grp = cluster; grp < prm.n_groups; grp += n_clusters, ++tc) {
    const int tile = grp * kCluster + rank;
    const int row0 = tile * kRows;
    mbar_wait(L::x_full(base), tc & 1);
    if constexpr (kBlock) {
      ln_rows<kBwd, kWg>(prm, base, row0, tid, base + L::kOffStats + (tc & 1) * (kRows * 8));
      fence_proxy_async();         // the generic stores, before a wgmma reads the tile
      named_sync(2 + kWg, 128);    // this warpgroup's 32 rows, whole
    }
    float acc[96];  // y or dx (dln): the tile's 64 rows x columns 192 kWg .. + 191
    zero(acc);
    for (int c = 0; c < n_chunks; ++c, ++cc, it += 4) {
      const uint32_t tbuf = base + L::kOffT + (cc & 1) * kBox;
      // this warpgroup's 32 rows of x (and dy) as the K-major B operand: one
      // box of 64 columns (8 KB) per four k16 steps, 32 bytes a step
      const uint32_t xb = opaque(base + kWg * 32 * 128);
      float u[16], dh[16];  // dh: dx pass only
      if constexpr (kBwd) {
        wait_stage(it);
        wait_stage(it + 1);
        const uint32_t w2a = opaque(L::stage(base, it)), w2b = opaque(L::stage(base, it + 1));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 24; ++kk) {
          const uint32_t a = opaque(kk < 12 ? w2a : w2b) + ((kk >> 2) % 3) * kBox + (kk & 3) * 32;
          ss_n32<0, 0>(dh, sw128(a), sw128(opaque(xb) + L::kOffDy + (kk >> 2) * kBox + (kk & 3) * 32),
                       kk);
        }
        wgmma_commit();
      }
      constexpr int kW1 = kBwd ? 2 : 0;  // W1's half-stages within the chunk
      wait_stage(it + kW1);
      wait_stage(it + kW1 + 1);
      {
        const uint32_t w1a = opaque(L::stage(base, it + kW1));
        const uint32_t w1b = opaque(L::stage(base, it + kW1 + 1));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 24; ++kk) {
          const uint32_t a = opaque(kk < 12 ? w1a : w1b) + (kk % 12) * 2048;  // 16 rows of D a step
          ss_n32<1, 0>(u, sw128(a), sw128(opaque(xb) + (kk >> 2) * kBox + (kk & 3) * 32), kk);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      reg_fence(u);
      if constexpr (kBwd) {
        reg_fence(dh);
        release(it);  // W2 of this chunk
        release(it + 1);
      } else {
        release(it);  // W1 of this chunk
        release(it + 1);
      }

      if (c == n_chunks - 1) {
        // x (and dy) of the tile are read for the last time by the products
        // above. The dx pass first takes the tile's column sums of dy (db2):
        // consumer thread i < 192 sums columns 2i, 2i+1 over the 64 rows.
        if constexpr (kBwd) {
          const int ct = kWg * 128 + static_cast<int>(opaque(static_cast<uint32_t>(tid)));
          if (ct < 192 && tile < prm.n_tiles) {
            const int col = 2 * ct;
            const uint32_t src = base + L::kOffDy + (col >> 6) * kBox;
            float s0 = 0.f, s1 = 0.f;
            for (int r = 0; r < kRows; ++r) {
              uint32_t v;
              asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(src + swz(r, col & 63)));
              const float2 f = mlp::unpack_bf16(v);
              s0 += f.x;
              s1 += f.y;
            }
            *reinterpret_cast<float2*>(prm.row_part + static_cast<size_t>(tile) * prm.part_stride +
                                       col) = make_float2(s0, s1);
          }
        }
        warp_arrive(L::x_empty(base));
      }

      // The chunk's elementwise step on this thread's hidden rows hr, hr + 8
      // and rows 8i + 2t, 8i + 2t + 1 of the warpgroup's 32; the bf16 pairs
      // go to the tile's columns 32 kWg + 8i + 2t (its 16-byte chunk 4 kWg + i).
      const float bias0 = bf16_at(prm.b1, kH * c + hr), bias1 = bf16_at(prm.b1, kH * c + hr + 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = u[4 * i + e] + ((e & 2) ? bias1 : bias0);
          if constexpr (kBwd) {
            float dg;
            mlp::gelu_and_grad(x, kApprox, &dg);
            v[e] = dh[4 * i + e] * dg;
          } else {
            v[e] = mlp::gelu(x, kApprox);
          }
        }
        const int col = 32 * kWg + 8 * i + 2 * t;
        st_shared_u32(tbuf + swz(hr, col), hopper::pack_bf16(v[0], v[1]));
        st_shared_u32(tbuf + swz(hr + 8, col), hopper::pack_bf16(v[2], v[3]));
      }
      fence_proxy_async();
      named_sync(1, kConsumerThreads);  // the tile holds both warpgroups' rows

      // acc[:, cols] += tile^T . (W2c[:, cols] or W1c[cols, :]^T): the tile is
      // the MN-major A operand (64 rows of 128 bytes, 16 hidden rows a step)
      if constexpr (!kBwd) {
        wait_stage(it + 2);
        wait_stage(it + 3);
      }
      {
        const uint32_t ta = opaque(tbuf);
        const uint32_t wb = opaque(L::stage(base, it + 2 + kWg));  // this warpgroup's half
        wgmma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          if constexpr (kBwd)  // W1c[cols, :]^T: K-major, 16 hidden columns (32 bytes) a step
            ss_n192<1, 0>(acc, sw128(opaque(ta) + k4 * 2048), sw128(opaque(wb) + k4 * 32), 1);
          else  // W2c[:, cols]: MN-major, three 64-column boxes 8 KB apart, 16 rows a step
            ss_n192<1, 1>(acc, sw128(opaque(ta) + k4 * 2048), sw128(opaque(wb) + k4 * 2048, kBox),
                          1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
      }
      release(it + 2);
      release(it + 3);
    }

    if constexpr (kBwd && kBlock) {
      ln_backward_epilogue<kWg>(acc, prm, base, tc, tile, row0, tid);
      continue;
    }
    // y = bf16(acc + b2) (kBlock: bf16(x + bf16(acc + b2))) or dx = bf16(acc),
    // rows past the end not written
    const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
    auto store = [&](int r, int col, float v0, float v1) {
      if (r >= prm.rows) return;
      const size_t at = static_cast<size_t>(r) * kD + col;
      if constexpr (kBlock) {  // the residual sum in bf16
        const float2 xv = mlp::unpack_bf16(*reinterpret_cast<const uint32_t*>(prm.x + at));
        v0 = xv.x + mlp::round_bf16(v0);
        v1 = xv.y + mlp::round_bf16(v1);
      }
      *reinterpret_cast<uint32_t*>(prm.out + at) = hopper::pack_bf16(v0, v1);
    };
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int col = 192 * kWg + 8 * i + 2 * t;
      float2 b = make_float2(0.f, 0.f);
      if constexpr (!kBwd) b = mlp::unpack_bf16(*reinterpret_cast<const uint32_t*>(prm.b2 + col));
      store(r0, col, acc[4 * i] + b.x, acc[4 * i + 1] + b.y);
      store(r1, col, acc[4 * i + 2] + b.x, acc[4 * i + 3] + b.y);
    }
  }
}

template <bool kBwd, bool kBlock, bool kApprox>
__global__ void __launch_bounds__(kThreads, 1)
mlp_row_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap dy_map,
           const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w2_map,
           const RowParams prm) {
  using L = RowLayout<kBwd>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int rank = static_cast<int>(cluster_ctarank());
  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();  // the swizzled tiles need 1024-byte alignment
    mbar_init(L::x_full(base), 1);
    mbar_init(L::x_empty(base), 8);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(L::full(base, s), 1);
      mbar_init(L::empty(base, s), 8 * kCluster);  // every warp of every block of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the peers' barriers exist before any multicast or remote arrival

  // warp 8 produces (one thread), warpgroups 0 and 1 consume
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    if (threadIdx.x == kConsumerThreads)
      row_producer<kBwd>(&x_map, &dy_map, &w1_map, &w2_map, prm, base, rank);
  } else if (role == 0) {
    row_consumer<kBwd, kBlock, kApprox, 0>(prm, base, rank, threadIdx.x);
  } else {
    row_consumer<kBwd, kBlock, kApprox, 1>(prm, base, rank, threadIdx.x - 128);
  }
  cluster_sync();  // no block leaves while a peer may still arrive on its barriers
}

// ---------------------------------------------------------------------------
// The dW passes of the backward
// ---------------------------------------------------------------------------
// A cluster of four blocks takes four neighbouring 64-unit hidden slices and
// one group of rows, and walks the group's rows in stages of 32 (x and dy,
// twelve boxes of 64 columns x 32 rows, of which each block loads three for
// the cluster). Each block keeps its slice of W1 (D x 64; and of W2, 64 x D,
// in part 1) in shared memory. Stage j is rebuilt by warpgroup j & 1:
//   part 1:  dh^T = W2s . dy^T, u^T = W1s^T . x^T   (m64n32, 24 k16 steps each)
//            du^T (bf16) -> columns 32 (j & 1) .. of a (64 hidden, 64 rows)
//            tile, db1 += du (fp32)
//   part 2:  u^T = W1s^T . x^T -> h^T (bf16) the same way
// and then both warpgroups add it, each to its own 192 columns of D:
//   part 1:  dW1[cols, slice]^T += du_c^T . x   (m64n192, K = the 32 rows)
//   part 2:  dW2[slice, cols]   += h^T . dy     (m64n192)
// Two parts, five products where one pass would take four (u^T is rebuilt in
// both), because one block cannot hold both: dW1[:, slice] and dW2[slice, :]
// are 2 x 24,576 fp32, 192 registers a thread of two consumer warpgroups,
// and with the ~70 that the rest of a part takes (ptxas: 162-168 a thread
// with 96 accumulators) that is more than the 224 a thread of a 288-thread
// block. Two tiles, double-buffered, let one warpgroup rebuild the next
// stage while both still add this one. A block whose slice lies past F (F
// not a multiple of 256) still loads and releases its share.

struct SliceParams {
  const __nv_bfloat16* b1;  // (F,)
  float* w_part;            // (groups, 2 D F + F): dW1 (D, F) | dW2 (F, D) | db1 (F,)
  int f, n_slices, n_sc;    // hidden slices, clusters of slices
  int n_stages, per_group;  // stages of 32 rows in all, and a row group's
};

// Shared memory of a dW part: its weight slices (W1s, and W2s in part 1),
// the ring of x/dy stages (two in part 1, three in part 2, which keeps no
// W2s), the two tiles, part 1's parking room for dh^T, the db1 sums.
template <int kPart>
struct SliceLayout {
  static constexpr int kStages = kPart == 1 ? 2 : 3;
  static constexpr uint32_t kOffW2 = 6 * kBox;
  static constexpr uint32_t kStageBytes = 12 * 4096;  // x then dy, boxes of 64 x 32
  static constexpr uint32_t kOffX = (kPart == 1 ? 12 : 6) * kBox;
  static constexpr uint32_t kOffT = kOffX + kStages * kStageBytes;
  static constexpr uint32_t kOffPark = kOffT + 2 * kBox;  // part 1, erf form: dh^T (fp32)
  static constexpr uint32_t kOffRed = kOffPark + (kPart == 1 ? 2 * kBox : 0);
  static constexpr uint32_t kOffBar = kOffRed + 2 * 64 * 4;
  // w full, x full[kStages], x empty[kStages], then per half of each tile
  // t full[4], t empty[4]
  static constexpr uint32_t kSmem = kOffBar + 8 * (9 + 2 * kStages);
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
  __device__ static uint32_t w_full(uint32_t base) { return base + kOffBar; }
  __device__ static uint32_t x_full(uint32_t base, int s) { return base + kOffBar + 8 + 8 * s; }
  __device__ static uint32_t x_empty(uint32_t base, int s) {
    return base + kOffBar + 8 + 8 * (kStages + s);
  }
  __device__ static uint32_t t_full(uint32_t base, int i) {
    return base + kOffBar + 8 + 16 * kStages + 8 * i;
  }
  __device__ static uint32_t t_empty(uint32_t base, int i) {
    return base + kOffBar + 40 + 16 * kStages + 8 * i;
  }
};

struct SliceWork {
  int slice, grp, st0, n;  // this block's slice, row group, first stage and stage count
  bool valid;              // the slice lies inside F
};

__device__ __forceinline__ SliceWork slice_work(const SliceParams& prm, int rank) {
  SliceWork w;
  const int cluster = blockIdx.x / kCluster;
  w.slice = (cluster % prm.n_sc) * kCluster + rank;
  w.grp = cluster / prm.n_sc;
  w.st0 = w.grp * prm.per_group;
  w.n = max(0, min(prm.per_group, prm.n_stages - w.st0));
  w.valid = w.slice < prm.n_slices;
  return w;
}

template <int kPart>
__device__ __forceinline__ void slice_producer(const CUtensorMap* x_map,
                                               const CUtensorMap* dy_map,
                                               const CUtensorMap* w1_map,
                                               const CUtensorMap* w2_map,
                                               const SliceParams& prm, uint32_t base, int rank) {
  using L = SliceLayout<kPart>;
  const SliceWork w = slice_work(prm, rank);
  if (w.valid) {
    mbar_expect_tx(L::w_full(base), (kPart == 1 ? 12 : 6) * kBox);
    for (int j = 0; j < 6; ++j) {
      tma_load_2d(base + j * kBox, w1_map, L::w_full(base), kH * w.slice, 64 * j);
      if (kPart == 1)
        tma_load_2d(base + L::kOffW2 + j * kBox, w2_map, L::w_full(base), 64 * j, kH * w.slice);
    }
  }
  for (int j = 0; j < w.n; ++j) {
    const int s = j % L::kStages;
    if (j >= L::kStages) mbar_wait(L::x_empty(base, s), ((j / L::kStages) - 1) & 1);
    mbar_expect_tx(L::x_full(base, s), L::kStageBytes);
    const int row = (w.st0 + j) * kStageRows;
    for (int b = 12 * rank / kCluster; b < 12 * (rank + 1) / kCluster; ++b)
      tma_load_2d_multicast(base + L::kOffX + s * L::kStageBytes + b * 4096, b < 6 ? x_map : dy_map,
                            L::x_full(base, s), 64 * (b % 6), row, kClusterMask);
  }
}

template <int kPart, bool kApprox, int kWg>
__device__ __forceinline__ void slice_consumer(const SliceParams& prm, uint32_t base, int rank,
                                               int tid) {
  using L = SliceLayout<kPart>;
  const SliceWork w = slice_work(prm, rank);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int hr = warp * 16 + g;  // this thread's first hidden row of the slice (and hr + 8)
  const int f0 = kH * w.slice;
  if (!w.valid) {  // release every stage for the peers, nothing else
    for (int j = 0; j < w.n; ++j) {
      mbar_wait(L::x_full(base, j % L::kStages), (j / L::kStages) & 1);
      warp_arrive_cluster(L::x_empty(base, j % L::kStages));
    }
    return;  // to the cluster barrier of the caller
  }
  float acc[96];  // part 1: dW1[cols, slice]^T; part 2: dW2[slice, cols]; cols = 192 kWg ..
  zero(acc);
  float db1_a = 0.f, db1_b = 0.f;
  const float bias0 = bf16_at(prm.b1, f0 + hr), bias1 = bf16_at(prm.b1, f0 + hr + 8);
  mbar_wait(L::w_full(base), 0);

  for (int j = 0; j < w.n; ++j) {
    // x/dy slot, the builder (and the half of the tile), the tile, and the
    // barrier pair of that half: each recurs every kStages, 2, 4 and 4 stages
    const int s = j % L::kStages, half = j & 1, ti = (j >> 1) & 1, q = 2 * ti + half;
    const uint32_t xs = base + L::kOffX + s * L::kStageBytes;
    const uint32_t tbuf = base + L::kOffT + ti * kBox;
    mbar_wait(L::x_full(base, s), (j / L::kStages) & 1);
    if (half == kWg) {
      if (j >= 4) mbar_wait(L::t_empty(base, q), ((j >> 2) - 1) & 1);
      const uint32_t w1s = opaque(base), w2s = opaque(base + L::kOffW2), xb = opaque(xs);
      // Part 1 runs dh^T's chain beside u^T's. The erf GELU's derivative
      // needs more registers than the tanh one's, and with both results live
      // ptxas spills that form: there dh^T waits in shared memory instead.
      constexpr bool kPark = kPart == 1 && !kApprox;
      const uint32_t park = base + L::kOffPark + half * kBox + tid * 64;
      float u[16], dh[16];  // dh: part 1 only
      wgmma_fence();
      if constexpr (kPart == 1) {
#pragma unroll
        for (int kk = 0; kk < 24; ++kk)  // dh^T = W2s . dy^T: both K-major
          ss_n32<0, 0>(dh, sw128(opaque(w2s) + (kk >> 2) * kBox + (kk & 3) * 32),
                       sw128(opaque(xb) + 6 * 4096 + (kk >> 2) * 4096 + (kk & 3) * 32), kk);
        wgmma_commit();
      }
      if constexpr (kPark) {
        wgmma_wait<0>();
        reg_fence(dh);
#pragma unroll
        for (int i = 0; i < 16; ++i) st_shared_f32(park + 4 * ((i + tid) & 15), dh[i]);
        wgmma_fence();
      }
#pragma unroll
      for (int kk = 0; kk < 24; ++kk)  // u^T = W1s^T . x^T: W1s MN-major, 16 rows of D a step
        ss_n32<1, 0>(u, sw128(opaque(w1s) + kk * 2048),
                     sw128(opaque(xb) + (kk >> 2) * 4096 + (kk & 3) * 32), kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(u);
      if constexpr (kPart == 1 && !kPark) reg_fence(dh);
      // this thread's hidden rows hr, hr + 8 and rows 8i + 2t, + 1 of the
      // stage: columns 32 half + 8i + 2t of the tile
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = u[4 * i + e] + ((e & 2) ? bias1 : bias0);
          if constexpr (kPart == 1) {
            float dg;
            mlp::gelu_and_grad(x, kApprox, &dg);
            v[e] = (kPark ? ld_shared_f32(park + 4 * ((4 * i + e + tid) & 15)) : dh[4 * i + e]) * dg;
          } else {
            v[e] = mlp::gelu(x, kApprox);
          }
        }
        if constexpr (kPart == 1) {
          db1_a += v[0] + v[1];
          db1_b += v[2] + v[3];
        }
        const int col = 32 * half + 8 * i + 2 * t;
        st_shared_u32(tbuf + swz(hr, col), hopper::pack_bf16(v[0], v[1]));
        st_shared_u32(tbuf + swz(hr + 8, col), hopper::pack_bf16(v[2], v[3]));
      }
      fence_proxy_async();
      mbar_arrive(L::t_full(base, q));
    }
    mbar_wait(L::t_full(base, q), (j >> 2) & 1);
    {
      // K = the stage's 32 rows: columns 32 half .. of the tile (64 bytes
      // on), two k16 steps of 32 bytes; rows of the x (part 1) or dy (part
      // 2) boxes this warpgroup's 192 columns take, MN-major, 2,048 bytes a
      // step, boxes 4 KB apart
      const uint32_t ta = opaque(tbuf + half * 64);
      const uint32_t xb = opaque(xs + ((kPart == 1 ? 0 : 6) + 3 * kWg) * 4096);
      wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2)
        ss_n192<0, 1>(acc, sw128(opaque(ta) + k2 * 32), sw128(opaque(xb) + k2 * 2048, 4096), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
    }
    warp_arrive(L::t_empty(base, q));
    warp_arrive_cluster(L::x_empty(base, s));
  }

  float* part = prm.w_part + static_cast<size_t>(w.grp) * (2 * static_cast<size_t>(kD) * prm.f + prm.f);
  if constexpr (kPart == 1) {
#pragma unroll
    for (int i = 0; i < 24; ++i) {  // dW1[d][f] from the transposed accumulator
      const int d = 192 * kWg + 8 * i + 2 * t;
      float* row = part + static_cast<size_t>(d) * prm.f + f0 + hr;
      row[0] = acc[4 * i];
      row[prm.f] = acc[4 * i + 1];
      row[8] = acc[4 * i + 2];
      row[prm.f + 8] = acc[4 * i + 3];
    }
    // db1: this thread's rows summed over the quad, then warpgroup 0's plus 1's
    db1_a = quad_sum(db1_a);
    db1_b = quad_sum(db1_b);
    const uint32_t red = base + L::kOffRed;
    if (t == 0) {
      st_shared_f32(red + 4 * (kWg * 64 + hr), db1_a);
      st_shared_f32(red + 4 * (kWg * 64 + hr + 8), db1_b);
    }
    named_sync(1, kConsumerThreads);
    if (kWg == 0 && tid < 64)
      part[2 * static_cast<size_t>(kD) * prm.f + f0 + tid] =
          ld_shared_f32(red + 4 * tid) + ld_shared_f32(red + 4 * (64 + tid));
  } else {
    float* dw2 = part + static_cast<size_t>(kD) * prm.f;
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int col = 192 * kWg + 8 * i + 2 * t;
      *reinterpret_cast<float2*>(dw2 + static_cast<size_t>(f0 + hr) * kD + col) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(dw2 + static_cast<size_t>(f0 + hr + 8) * kD + col) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

template <int kPart, bool kApprox>
__global__ void __launch_bounds__(kThreads, 1)
mlp_dw_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap dy_map,
          const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w2_map,
          const SliceParams prm) {
  using L = SliceLayout<kPart>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int rank = static_cast<int>(cluster_ctarank());
  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();
    mbar_init(L::w_full(base), 1);
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(L::x_full(base, i), 1);
      mbar_init(L::x_empty(base, i), 8 * kCluster);
    }
    for (int i = 0; i < 4; ++i) {
      mbar_init(L::t_full(base, i), 128);  // every thread of the warpgroup that rebuilds
      mbar_init(L::t_empty(base, i), 8);   // every warp of both warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  // warp 8 produces (one thread), warpgroups 0 and 1 consume
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    if (threadIdx.x == kConsumerThreads)
      slice_producer<kPart>(&x_map, &dy_map, &w1_map, &w2_map, prm, base, rank);
  } else if (role == 0) {
    slice_consumer<kPart, kApprox, 0>(prm, base, rank, threadIdx.x);
  } else {
    slice_consumer<kPart, kApprox, 1>(prm, base, rank, threadIdx.x - 128);
  }
  cluster_sync();  // no block leaves while a peer may still arrive on its barriers
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int blocks, int smem,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of a row kernel the card holds at once, asked once per kernel.
template <bool kBwd, bool kBlock, bool kApprox>
int row_clusters(int* clusters) {
  static int cached = 0;
  if (cached == 0) {
    auto kernel = mlp_row_kernel<kBwd, kBlock, kApprox>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           RowLayout<kBwd>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(&attr, kCluster, RowLayout<kBwd>::kSmem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&cached, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cached < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  *clusters = cached;
  return 0;
}

template <bool kBwd, bool kBlock, bool kApprox>
int launch_rows(const CUtensorMap& x_map, const CUtensorMap& dy_map, const CUtensorMap& w1_map,
                const CUtensorMap& w2_map, const RowParams& prm, cudaStream_t stream) {
  int clusters = 0;
  const int err0 = row_clusters<kBwd, kBlock, kApprox>(&clusters);
  if (err0 != 0) return err0;
  if (clusters > prm.n_groups) clusters = prm.n_groups;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(&attr, clusters * kCluster, RowLayout<kBwd>::kSmem, stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, mlp_row_kernel<kBwd, kBlock, kApprox>, x_map, dy_map,
                                       w1_map, w2_map, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBwd, bool kBlock>
int launch_rows(int approx, const CUtensorMap& x_map, const CUtensorMap& dy_map,
                const CUtensorMap& w1_map, const CUtensorMap& w2_map, const RowParams& prm,
                cudaStream_t stream) {
  return approx ? launch_rows<kBwd, kBlock, true>(x_map, dy_map, w1_map, w2_map, prm, stream)
                : launch_rows<kBwd, kBlock, false>(x_map, dy_map, w1_map, w2_map, prm, stream);
}

template <int kPart, bool kApprox>
int launch_slices(const CUtensorMap& x_map, const CUtensorMap& dy_map, const CUtensorMap& w1_map,
                  const CUtensorMap& w2_map, const SliceParams& prm, int groups,
                  cudaStream_t stream) {
  auto kernel = mlp_dw_kernel<kPart, kApprox>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SliceLayout<kPart>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(&attr, groups * prm.n_sc * kCluster, SliceLayout<kPart>::kSmem, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, x_map, dy_map, w1_map, w2_map, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kPart>
int launch_slices(int approx, const CUtensorMap& x_map, const CUtensorMap& dy_map,
                  const CUtensorMap& w1_map, const CUtensorMap& w2_map, const SliceParams& prm,
                  int groups, cudaStream_t stream) {
  return approx ? launch_slices<kPart, true>(x_map, dy_map, w1_map, w2_map, prm, groups, stream)
                : launch_slices<kPart, false>(x_map, dy_map, w1_map, w2_map, prm, groups, stream);
}

// The forward, K5f or (kBlock) K6f, of `prm` (out, b1, b2, and x, gamma,
// beta, eps for the sub-block) at rows x f.
template <bool kBlock>
int forward(RowParams prm, const void* x, const void* w1, const void* w2, int approx,
            cudaStream_t stream) {
  if (prm.rows < 1 || prm.f < kH || prm.f % kH) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap x_map, w1_map, w2_map;
  if (!encode_2d(&x_map, encode, x, kD, prm.rows, kRows) ||
      !encode_2d(&w1_map, encode, w1, prm.f, kD, kQuarter) ||
      !encode_2d(&w2_map, encode, w2, kD, prm.f, kQuarter))
    return static_cast<int>(cudaErrorInvalidValue);
  prm.n_tiles = (prm.rows + kRows - 1) / kRows;
  prm.n_groups = (prm.n_tiles + kCluster - 1) / kCluster;
  return launch_rows<false, kBlock>(approx, x_map, x_map, w1_map, w2_map, prm, stream);
}

// The backward, K5b or (kBlock) K6b, of `prm` (out = dx, b1, row_part, and
// x, dy, gamma, eps, ln_out for the sub-block): the dx pass, then the dW
// passes on fc1's input `a` (x, or the LN(x) that the dx pass leaves in
// ln_out), writing per row group into w_part.
template <bool kBlock>
int backward(RowParams prm, const void* x, const void* dy, const void* w1, const void* w2,
             const void* a, float* w_part, int n_row_tiles, int groups, int approx,
             cudaStream_t stream) {
  const int rows = prm.rows, f = prm.f;
  const int n_stages = (rows + kStageRows - 1) / kStageRows;
  if (rows < 1 || f < kH || f % kH || n_row_tiles != (rows + kRows - 1) / kRows || groups < 1 ||
      groups > n_stages)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap x_map, dy_map, w1_map, w2_map, xs_map, dys_map, w1s_map, w2s_map;
  if (!encode_2d(&x_map, encode, x, kD, rows, kRows) ||
      !encode_2d(&dy_map, encode, dy, kD, rows, kRows) ||
      !encode_2d(&w1_map, encode, w1, f, kD, kQuarter) ||
      !encode_2d(&w2_map, encode, w2, kD, f, kQuarter) ||
      !encode_2d(&xs_map, encode, a, kD, rows, kStageRows) ||
      !encode_2d(&dys_map, encode, dy, kD, rows, kStageRows) ||
      !encode_2d(&w1s_map, encode, w1, f, kD, 64) || !encode_2d(&w2s_map, encode, w2, kD, f, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  prm.n_tiles = n_row_tiles;
  prm.n_groups = (n_row_tiles + kCluster - 1) / kCluster;
  int err = launch_rows<true, kBlock>(approx, x_map, dy_map, w1_map, w2_map, prm, stream);
  if (err != 0) return err;

  SliceParams sp{};
  sp.b1 = prm.b1;
  sp.w_part = w_part;
  sp.f = f;
  sp.n_slices = f / kH;
  sp.n_sc = (sp.n_slices + kCluster - 1) / kCluster;
  sp.n_stages = n_stages;
  sp.per_group = (n_stages + groups - 1) / groups;
  err = launch_slices<1>(approx, xs_map, dys_map, w1s_map, w2s_map, sp, groups, stream);
  if (err != 0) return err;
  return launch_slices<2>(approx, xs_map, dys_map, w1s_map, w2s_map, sp, groups, stream);
}

}  // namespace

namespace mlp_sm90 {

// y = bf16(bf16(gelu(x . w1 + b1)) . w2 + b2) at D = 384: x, y (rows, 384),
// w1 (384, f), w2 (f, 384), b1 (f,), b2 (384,) bf16, contiguous, 16-byte
// aligned; f a multiple of 64; approx: the tanh GELU, else erf.
int fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* y,
        int rows, int f, int approx, cudaStream_t stream) {
  RowParams prm{};
  prm.b1 = static_cast<const __nv_bfloat16*>(b1);
  prm.b2 = static_cast<const __nv_bfloat16*>(b2);
  prm.out = static_cast<__nv_bfloat16*>(y);
  prm.rows = rows;
  prm.f = f;
  return forward<false>(prm, x, w1, w2, approx, stream);
}

// The pre-norm sub-block, y = bf16(x + bf16(... with bf16(LN(x)) as fc1's
// input)), operands as above; gamma, beta (384,) fp32, 8-byte aligned.
int block_fwd(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
              const void* w2, const void* b2, void* y, int rows, int f, float eps, int approx,
              cudaStream_t stream) {
  RowParams prm{};
  prm.b1 = static_cast<const __nv_bfloat16*>(b1);
  prm.b2 = static_cast<const __nv_bfloat16*>(b2);
  prm.out = static_cast<__nv_bfloat16*>(y);
  prm.x = static_cast<const __nv_bfloat16*>(x);
  prm.gamma = static_cast<const float*>(gamma);
  prm.beta = static_cast<const float*>(beta);
  prm.eps = eps;
  prm.rows = rows;
  prm.f = f;
  return forward<true>(prm, x, w1, w2, approx, stream);
}

// The three passes of the backward at D = 384 (operands as above, dy and dx
// like x): dx, and per row group the partial sums w_part (groups, 2 D f + f)
// = dW1 | dW2 | db1, and per 64-row tile the column sums of dy, row_part
// (n_row_tiles, D). The caller adds the partials in a fixed order.
// 1 <= groups <= ceil(rows / 32), n_row_tiles = ceil(rows / 64).
int bwd(const void* x, const void* dy, const void* w1, const void* b1, const void* w2, void* dx,
        float* w_part, float* row_part, int rows, int f, int n_row_tiles, int groups, int approx,
        cudaStream_t stream) {
  RowParams prm{};
  prm.b1 = static_cast<const __nv_bfloat16*>(b1);
  prm.out = static_cast<__nv_bfloat16*>(dx);
  prm.row_part = row_part;
  prm.part_stride = kD;
  prm.rows = rows;
  prm.f = f;
  return backward<false>(prm, x, dy, w1, w2, x, w_part, n_row_tiles, groups, approx, stream);
}

// The same for the pre-norm sub-block: row_part is (n_row_tiles, 3, D) =
// db2 | dgamma | dbeta per tile; ln_work (rows, D) bf16 takes LN(x) from the
// dx pass to the dW passes. gamma, beta (384,) fp32, 8-byte aligned.
int block_bwd(const void* x, const void* dy, const void* gamma, const void* beta, const void* w1,
              const void* b1, const void* w2, void* dx, float* w_part, float* row_part,
              void* ln_work, int rows, int f, int n_row_tiles, int groups, float eps, int approx,
              cudaStream_t stream) {
  RowParams prm{};
  prm.b1 = static_cast<const __nv_bfloat16*>(b1);
  prm.out = static_cast<__nv_bfloat16*>(dx);
  prm.row_part = row_part;
  prm.part_stride = 3 * kD;
  prm.x = static_cast<const __nv_bfloat16*>(x);
  prm.dy = static_cast<const __nv_bfloat16*>(dy);
  prm.gamma = static_cast<const float*>(gamma);
  prm.beta = static_cast<const float*>(beta);
  prm.ln_out = static_cast<__nv_bfloat16*>(ln_work);
  prm.eps = eps;
  prm.rows = rows;
  prm.f = f;
  return backward<true>(prm, x, dy, w1, w2, ln_work, w_part, n_row_tiles, groups, approx, stream);
}

}  // namespace mlp_sm90
