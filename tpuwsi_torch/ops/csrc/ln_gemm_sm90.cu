// The row-tiled LN+GEMM whose input is 384 wide, forward and backward,
// written for Hopper: every product a wgmma from 128-byte swizzled shared
// memory, every load a TMA issued by a producer thread into mbarrier-tracked
// stages, the weight stream multicast across a thread-block cluster, the
// outputs leaving by TMA stores, and a grid of at most one block per SM that
// walks its row tiles.
//
// Replaces, at width 384 (dense.cu dispatches here; 768 keeps the row-tiled
// kernels of dense.cu and dense_common.cuh):
//   tpuwsi/ops/mlp.py:832  `_ln_gemm_fwd_kernel`  (pallas_call at :904)  K9a
//       y = bf16(LN(x)) . W + b; x (rows, 384), y (rows, n)
//   tpuwsi/ops/mlp.py:850  `_ln_gemm_bwd_kernel`  (pallas_call at :928)  K9b
//       dln = dy . W^T, dW = bf16(LN(x))^T . dy, db = sum dy, and the
//       LayerNorm backward: dx, dgamma = sum dln xhat, dbeta = sum dln
// Same arithmetic as the TPU kernels: LayerNorm in fp32 with the fast
// variance E[x^2] - mean^2 clamped at 0, its output rounded to bf16 before
// the product; every product accumulates in fp32, the bias is added in fp32;
// y and dx are bf16; dW, db, dgamma and dbeta are fp32 sums over ALL rows.
// Rows past the end read as zeros and are never written. W is read as it is
// stored: (384, n) (w_layout 0, the JAX layout) or (n, 384) (w_layout 1, as
// nn.Linear keeps it); the TMA map's coordinates and wgmma's transpose bit
// choose which, and nothing is copied.
//
// What bounds them on an H100 (published peaks of the SXM part at 700 W:
// 989 TFLOP/s dense bf16, 3.35 TB/s). At the DINO step's student global views
// with the qkv layer, (rows, K, N) = (37,824, 384, 1,152), the forward reads x
// and writes y (116 MB, 0.035 ms) for one product of 34 GFLOP (0.034 ms): at
// the ridge. The backward reads x and dy and writes dx (145 MB, 0.044 ms) for
// two products (0.068 ms): bound by operations.
//
// K9a, the forward (`ln_gemm_fwd_kernel`). The reduction is only 384 deep (six
// 64-wide chunks) and the output n wide, so a 64-row tile's LN(x) stays
// resident and W streams past it:
//   - 384-thread blocks (setmaxnreg 40 / 232): two consumer warpgroups, a
//     producer warpgroup in which one thread loads W and another the tiles'
//     x. Clusters of kFwdCluster blocks walk neighbouring 64-row tiles on a
//     persistent grid sized by cudaOccupancyMaxActiveClusters, as the row pass
//     of dense_sm90.cuh does; two blocks, not the row pass's four: four read
//     1-7% slower, one level with two (PERF.md).
//   - The tile's x (six 64 x 64 boxes, 48 KB) arrives by TMA; each consumer
//     warpgroup normalises its 32 rows in place, at their swizzled places,
//     then fence.proxy.async and a 256-thread barrier: both warpgroups read
//     all 64 rows as the A operand.
//   - The output goes in slices of 384 columns (the last one may be partial:
//     W's boxes past n load as zeros, y's stores past n are not issued): each
//     warpgroup computes 192 of them (m64n192, 96 fp32 accumulators a thread)
//     over six chunks of W, each a stage of 64 reduction rows x 384 outputs
//     (48 KB) multicast to the cluster, so L2 serves W once per pair of
//     tiles: 0.26 GB a call at the qkv layer, where one tile a block would
//     pull 0.52 GB. Every SM still takes in all of W (0.88 MB) for each
//     64-row tile it walks.
//   - Shared memory: LN(x) 48 KB and a ring of three 48 KB stages (192 KB of
//     227). A fourth stage does not fit beside the resident tile; six 24 KB
//     half-stages, one ring per warpgroup, would hold the same bytes with
//     twice the barriers and TMA issues. After a slice's sixth chunk the ring
//     gives one stage to the epilogue: the bias is added in fp32, y rounded
//     to bf16 and written into the stage in the swizzled layout (stmatrix),
//     and one thread of each warpgroup stores its three boxes by TMA (rows
//     past the end clipped) while the next slice's chunks land in the other
//     stages.
//   - Between tiles the x buffer is refilled once the last slice's products
//     have read it: one load and one LayerNorm per 18 chunks at n = 1,152.
//   - What bounds it (PERF.md: copies with one part cut out): the
//     LayerNorm, the products, y's writes into the stage and its TMA stores
//     each take 8-20% of the time, one after the other; with all four cut,
//     the loads and the ring's round trips still take half.
//
// K9b, the backward (`ln_gemm_bwd`): five launches, all of them kernels that
// other ops share (dense_sm90.cuh):
//   - `ln_rows_kernel` writes bf16 LN(x) into ln_work;
//   - the row pass computes dln = dy . W^T (n / 64 chunks, W multicast) with
//     the residual-free LayerNorm backward as its epilogue (`LnBackward<false>`:
//     x by TMA into the epilogue's stage, the statistics and xhat from shared
//     memory, dx written back in place and stored by TMA), which also writes
//     the tile's dgamma, dbeta column sums into row_part;
//   - K7's dW kernel computes dW and db from (ln_work, dy) per (64-column
//     slice, group of row steps) into w_part;
//   - `sum_partials_kernel` adds w_part and row_part in a fixed order.
// Every output element has one writer and there are no atomics: two launches
// on the same inputs give the same bits.
//
// The entry points (declared in dense_sm90.cuh) launch on the caller's
// stream, allocate nothing and return a CUDA error code. The tensor maps are
// encoded on the host at each launch (hopper.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_sm90.cuh"

namespace {

using namespace dense_sm90;

// blocks of a cluster, neighbouring row tiles sharing each chunk of W
constexpr int kFwdCluster = 2;
constexpr uint16_t kFwdMask = (1u << kFwdCluster) - 1;
constexpr int kFwdStages = 3;
constexpr uint32_t kFwdStage = kPieces * kBox;  // a 64 x 384 chunk of W, or a slice of y
constexpr uint32_t kFwdOffRing = kPieces * kBox;  // after the tile's LN(x)
constexpr uint32_t kFwdOffBar = kFwdOffRing + kFwdStages * kFwdStage;
constexpr uint32_t kFwdSmem = kFwdOffBar + 8 * (2 * kFwdStages + 2);  // the ring's, x's barriers
static_assert(kFwdSmem <= kSmemLimit, "227 KB a block");
using FwdBars = RingBars<kFwdStages>;

struct FwdShape {
  int n, n_slices, n_tiles, n_groups;  // n_groups = ceil(n_tiles / kFwdCluster)
};

struct FwdParams {
  const float* gamma;
  const float* beta;
  const __nv_bfloat16* bias;  // (n,)
  float eps;
};

// The x buffer's barriers, after the ring's.
__device__ __forceinline__ uint32_t x_full(uint32_t base) {
  return base + kFwdOffBar + 16 * kFwdStages;
}
__device__ __forceinline__ uint32_t x_empty(uint32_t base) { return x_full(base) + 8; }

// One thread: per row tile, per slice, the six chunks of W, then the stage
// the slice's epilogue writes y into. Each block loads W's boxes p = rank,
// rank + kFwdCluster, ... of a chunk for the whole cluster. kTransB: W stored
// (384, n), a box 64 reduction rows of 64 outputs (read MN-major); else
// stored (n, 384), 64 outputs of 64 reduction values (K-major).
template <bool kTransB>
__device__ __forceinline__ void fwd_w_producer(const CUtensorMap* w_map, const FwdShape& shape,
                                               uint32_t base, int rank) {
  const FwdBars bars{base + kFwdOffBar};
  const int cluster = blockIdx.x / kFwdCluster, n_clusters = gridDim.x / kFwdCluster;
  uint32_t it = 0;
  for (int grp = cluster; grp < shape.n_groups; grp += n_clusters) {
    for (int s = 0; s < shape.n_slices; ++s) {
      for (int c = 0; c <= kPieces; ++c, ++it) {
        const int st = static_cast<int>(it % kFwdStages);
        if (it >= kFwdStages) mbar_wait(bars.empty(st), ((it / kFwdStages) - 1) & 1);
        if (c == kPieces) {
          mbar_arrive(bars.full(st));  // the stage only gives the epilogue its room
          continue;
        }
        const uint32_t dst = base + kFwdOffRing + st * kFwdStage;
        mbar_expect_tx(bars.full(st), kFwdStage);  // every block's W boxes
        for (int p = rank; p < kPieces; p += kFwdCluster) {
          const int out = kWidth * s + kTile * p;  // the box's first output column
          const int col = kTransB ? out : kTile * c, row = kTransB ? kTile * c : out;
          if constexpr (kFwdCluster == 1)
            tma_load_2d(dst + p * kBox, w_map, bars.full(st), col, row);
          else
            tma_load_2d_multicast(dst + p * kBox, w_map, bars.full(st), col, row, kFwdMask);
        }
      }
    }
  }
}

// One thread: the tile's x into the LN(x) buffer, once the previous tile's
// last slice has read it.
__device__ __forceinline__ void fwd_x_producer(const CUtensorMap* x_map, const FwdShape& shape,
                                               uint32_t base, int rank) {
  const int cluster = blockIdx.x / kFwdCluster, n_clusters = gridDim.x / kFwdCluster;
  uint32_t t = 0;
  for (int grp = cluster; grp < shape.n_groups; grp += n_clusters, ++t) {
    const int row0 = kTile * (grp * kFwdCluster + rank);
    if (t > 0) mbar_wait(x_empty(base), (t - 1) & 1);
    mbar_expect_tx(x_full(base), kPieces * kBox);
    for (int b = 0; b < kPieces; ++b)
      tma_load_2d(base + b * kBox, x_map, x_full(base), kTile * b, row0);
  }
}

// bf16(LN(x)) of rows 32 kWg .. + 31 of the tile, in place: each warp eight
// rows, two at a time, its lanes on a row's 16-byte chunks c = lane and
// lane + 32 (c < 48), with ln_rows_kernel's arithmetic; the lane's gamma and
// beta are loaded once a tile. Rows past the end hold zeros and give beta;
// their products are never stored.
template <int kWg>
__device__ __forceinline__ void ln_tile(const FwdParams& prm, uint32_t base, int tid) {
  tid = static_cast<int>(opaque(static_cast<uint32_t>(tid)));
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kChunks = kWidth / 8;
  float2 gm[2][4], bt[2][4];  // gamma, beta of the lane's chunks (8-byte aligned)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h < kChunks ? lane + 32 * h : lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gm[h][e] = *reinterpret_cast<const float2*>(prm.gamma + 8 * c + 2 * e);
      bt[h][e] = *reinterpret_cast<const float2*>(prm.beta + 8 * c + 2 * e);
    }
  }
#pragma unroll 1
  for (int j = 0; j < 8; j += 2) {
    uint4 v[2][2];
    float sum[2], sq[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = 32 * kWg + 8 * warp + j + q;
      sum[q] = 0.f;
      sq[q] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        v[q][h] = c < kChunks ? ld_shared_v4(base + chunk_at(r, c)) : make_uint4(0, 0, 0, 0);
        const uint32_t w[4] = {v[q][h].x, v[q][h].y, v[q][h].z, v[q][h].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = mlp::unpack_bf16(w[e]);
          sum[q] += f.x + f.y;
          sq[q] += f.x * f.x + f.y * f.y;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = 32 * kWg + 8 * warp + j + q;
      const float mean = warp_sum(sum[q]) * (1.f / kWidth);
      const float var = warp_sum(sq[q]) * (1.f / kWidth) - mean * mean;
      const float inv = rsqrtf(fmaxf(var, 0.f) + prm.eps);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        if (c >= kChunks) continue;
        const uint32_t w[4] = {v[q][h].x, v[q][h].y, v[q][h].z, v[q][h].w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = mlp::unpack_bf16(w[e]);
          o[e] = pack_bf16((f.x - mean) * inv * gm[h][e].x + bt[h][e].x,
                           (f.y - mean) * inv * gm[h][e].y + bt[h][e].y);
        }
        st_shared_v4(base + chunk_at(r, c), make_uint4(o[0], o[1], o[2], o[3]));
      }
    }
  }
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// y of slice s, this warpgroup's 192 columns: acc + bias in fp32, rounded,
// into boxes 3 kWg .. + 2 of the stage at `io`, then stored by one thread.
// The warp's 16 rows go in by stmatrix, four 8 x 8 pieces an instruction
// (rows 16 warp + 0..7 and + 8..15 of two 8-column groups): an accumulator
// pair is the fragment stmatrix takes, and lane l gives row l % 8 of piece
// l / 8 its swizzled 16-byte place.
template <int kWg>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[96], const FwdParams& prm,
                                             const CUtensorMap* y_map, uint32_t io, int tile,
                                             int s, const FwdShape& shape, int tid) {
  tid = static_cast<int>(opaque(static_cast<uint32_t>(tid)));
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 24; i += 2) {
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // 8-column group i + j: rows g (piece 2j), g + 8 (2j + 1)
      const int out = kWidth * s + kTile * (3 * kWg) + 8 * (i + j) + 2 * t4;
      const float2 b = out < shape.n
                           ? mlp::unpack_bf16(*reinterpret_cast<const uint32_t*>(prm.bias + out))
                           : make_float2(0.f, 0.f);
      r[2 * j] = pack_bf16(acc[4 * (i + j)] + b.x, acc[4 * (i + j) + 1] + b.y);
      r[2 * j + 1] = pack_bf16(acc[4 * (i + j) + 2] + b.x, acc[4 * (i + j) + 3] + b.y);
    }
    const int piece = lane >> 3, group = i + (piece >> 1);
    const int row = 16 * warp + 8 * (piece & 1) + (lane & 7);
    stsm_x4(io + (3 * kWg + group / 8) * kBox + row * 128 + ((((group & 7) ^ row) & 7) << 4), r);
  }
  fence_proxy_async();       // the generic stores, before TMA reads them
  named_sync(2 + kWg, 128);  // the warpgroup's three boxes, whole
  if (tid == 0 && tile < shape.n_tiles) {
    for (int j = 0; j < 3; ++j) {
      const int out = kWidth * s + kTile * (3 * kWg + j);
      if (out < shape.n) tma_store_2d(y_map, io + (3 * kWg + j) * kBox, out, kTile * tile);
    }
    bulk_commit();
    bulk_wait_read<0>();
  }
  named_sync(2 + kWg, 128);  // TMA has read the boxes: the stage may be refilled
}

// One consumer warpgroup; kWg is a template argument so that every branch
// around a wgmma is uniform by construction.
template <bool kTransB, int kWg>
__device__ __forceinline__ void fwd_consumer(const CUtensorMap* y_map, const FwdShape& shape,
                                             const FwdParams& prm, uint32_t base, int rank,
                                             int tid) {
  const FwdBars bars{base + kFwdOffBar};
  const int cluster = blockIdx.x / kFwdCluster, n_clusters = gridDim.x / kFwdCluster;
  uint32_t it = 0, t = 0;
  for (int grp = cluster; grp < shape.n_groups; grp += n_clusters, ++t) {
    const int tile = grp * kFwdCluster + rank;
    mbar_wait(x_full(base), t & 1);
    ln_tile<kWg>(prm, base, tid);
    fence_proxy_async();  // LN(x)'s generic stores, before wgmma reads them
    named_sync(1, 256);   // both warpgroups read all 64 rows
    for (int s = 0; s < shape.n_slices; ++s) {
      float acc[96];  // the tile's 64 rows x columns 384 s + 192 kWg .. + 191
      zero(acc);
      // each chunk's products issued one group ahead of the wait that frees
      // the chunk before it
#pragma unroll 1
      for (int c = 0; c < kPieces; ++c) {
        const uint32_t i = it + c;
        mbar_wait(bars.full(i % kFwdStages), (i / kFwdStages) & 1);
        const uint32_t st = base + kFwdOffRing + (i % kFwdStages) * kFwdStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // A: LN(x)'s box c, K-major, 32 bytes a k16 step. B: this
          // warpgroup's three boxes of the chunk, MN-major (16 rows, 2,048
          // bytes a step; 8 KB between 64-column blocks) or K-major (32 bytes)
          const uint64_t a = sw128(opaque(base) + c * kBox + 32 * kk);
          const uint32_t wb = opaque(st) + 3 * kWg * kBox;
          if constexpr (kTransB)
            ss_n192<0, 1>(acc, a, sw128(wb + 2048 * kk, kBox), 1);
          else
            ss_n192<0, 0>(acc, a, sw128(wb + 32 * kk), 1);
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          warp_arrive_cluster<kFwdCluster>(bars.empty((i - 1) % kFwdStages));
        }
      }
      wgmma_wait<0>();
      reg_fence(acc);
      it += kPieces;
      warp_arrive_cluster<kFwdCluster>(bars.empty((it - 1) % kFwdStages));
      if (s == shape.n_slices - 1) warp_arrive(x_empty(base));  // LN(x) is read for the last time
      mbar_wait(bars.full(it % kFwdStages), (it / kFwdStages) & 1);  // the epilogue's stage
      fwd_epilogue<kWg>(acc, prm, y_map, base + kFwdOffRing + (it % kFwdStages) * kFwdStage,
                        tile, s, shape, tid);
      warp_arrive_cluster<kFwdCluster>(bars.empty(it % kFwdStages));
      ++it;
    }
  }
  if (tid == 0) bulk_wait<0>();  // this warpgroup's stores have landed
}

template <bool kTransB>
__global__ void __launch_bounds__(kRowThreads, 1)
ln_gemm_fwd_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap y_map, const FwdShape shape,
                   const FwdParams prm) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int rank = static_cast<int>(cluster_ctarank());
  const FwdBars bars{base + kFwdOffBar};
  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();  // the swizzled boxes need 1024-byte alignment
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(bars.full(s), 1);
      mbar_init(bars.empty(s), 8 * kFwdCluster);  // every consumer warp of every block
    }
    mbar_init(x_full(base), 1);
    mbar_init(x_empty(base), 8);  // this block's consumer warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the peers' barriers exist before any multicast or remote arrival

  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256)
      fwd_w_producer<kTransB>(&w_map, shape, base, rank);
    else if (threadIdx.x == 288)
      fwd_x_producer(&x_map, shape, base, rank);
  } else if (role == 0) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    fwd_consumer<kTransB, 0>(&y_map, shape, prm, base, rank, threadIdx.x);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    fwd_consumer<kTransB, 1>(&y_map, shape, prm, base, rank, threadIdx.x - 128);
  }
  cluster_sync();  // no block leaves while a peer may still write to it or arrive on its barriers
}

// Clusters of the forward kernel the card holds at once, asked once per
// instantiation; the shared-memory ceiling is set at every launch.
template <bool kTransB>
int fwd_launch(const CUtensorMap& x_map, const CUtensorMap& w_map, const CUtensorMap& y_map,
               FwdShape shape, const FwdParams& prm, cudaStream_t stream) {
  auto kernel = ln_gemm_fwd_kernel<kTransB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int clusters = 0;
  cudaLaunchAttribute attr;
  if (clusters == 0) {
    cudaLaunchConfig_t cfg = row_config(&attr, kFwdCluster, kFwdSmem, nullptr, kFwdCluster);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int grid = clusters < shape.n_groups ? clusters : shape.n_groups;
  cudaLaunchConfig_t cfg = row_config(&attr, grid * kFwdCluster, kFwdSmem, stream, kFwdCluster);
  err = cudaLaunchKernelEx(&cfg, kernel, x_map, w_map, y_map, shape, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace dense_sm90 {

int ln_gemm_fwd(const void* x, const void* gamma, const void* beta, const void* w, int w_layout,
                const void* b, void* y, int rows, int n, float eps, cudaStream_t stream) {
  if (rows < 1 || n < kTile || n % kTile || (w_layout != 0 && w_layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap x_map, w_map, y_map;
  if (!encode_2d(&x_map, encode, x, kWidth, rows, kTile) ||
      !encode_w(&w_map, encode, w, w_layout, n) || !encode_2d(&y_map, encode, y, n, rows, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdShape shape{n, (n + kWidth - 1) / kWidth, (rows + kTile - 1) / kTile, 0};
  shape.n_groups = (shape.n_tiles + kFwdCluster - 1) / kFwdCluster;
  const FwdParams prm{static_cast<const float*>(gamma), static_cast<const float*>(beta),
                      static_cast<const __nv_bfloat16*>(b), eps};
  // y = LN(x) . W: W (384, n) is read MN-major, nn.Linear's (n, 384) K-major
  return w_layout == 0 ? fwd_launch<true>(x_map, w_map, y_map, shape, prm, stream)
                       : fwd_launch<false>(x_map, w_map, y_map, shape, prm, stream);
}

int ln_gemm_bwd(const void* x, const void* dy, const void* gamma, const void* beta, const void* w,
                int w_layout, void* dx, void* grads, void* w_part, void* row_part, void* ln_work,
                int rows, int n, int groups, float eps, cudaStream_t stream) {
  const int n_tiles = (rows + kTile - 1) / kTile;
  if (rows < 1 || n < kTile || n % kTile || (w_layout != 0 && w_layout != 1) || groups < 1 ||
      groups > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = ln_launch<kWidth>(x, gamma, beta, ln_work, rows, eps, stream);
  if (err != 0) return err;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap w_map;
  if (!encode_w(&w_map, encode, w, w_layout, n)) return static_cast<int>(cudaErrorInvalidValue);
  // dln = dy . W^T: W (384, n) is read K-major, nn.Linear's (n, 384) MN-major
  const DxParams dxp{nullptr, static_cast<const float*>(gamma), static_cast<float*>(row_part),
                     eps, rows, n_tiles};
  err = w_layout == 0
            ? launch_rows<LnBackward<false>, false>(dy, w_map, x, dx, rows, n / kTile, dxp, stream)
            : launch_rows<LnBackward<false>, true>(dy, w_map, x, dx, rows, n / kTile, dxp, stream);
  if (err != 0) return err;
  err = dw(ln_work, dy, static_cast<float*>(w_part), rows, n, groups, stream);
  if (err != 0) return err;
  const long long n_w = static_cast<long long>(kWidth) * n + n;
  float* out = static_cast<float*>(grads);
  const unsigned w_blocks = static_cast<unsigned>((n_w + 255) / 256);
  mlp::sum_partials_kernel<float><<<w_blocks, 256, 0, stream>>>(static_cast<const float*>(w_part),
                                                                 out, groups, n_w);
  mlp::sum_partials_kernel<float><<<(2 * kWidth + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(row_part), out + n_w, n_tiles, 2LL * kWidth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dense_sm90
