// Dense-layer row passes whose output is 384 wide, written for Hopper: every
// product a wgmma from 128-byte swizzled shared memory, every load a TMA
// issued by a producer thread into mbarrier-tracked stages, the weight stream
// multicast across a thread-block cluster, the output leaving by TMA stores,
// and a grid of at most one block per SM that walks its row tiles.
//
// Replaces, at width 384 (dense.cu dispatches here; 768 keeps the row-tiled
// kernels of dense.cu and dense_common.cuh):
//   tpuwsi/ops/dense.py:51  `_dense_bwd_kernel`     (pallas_call at :87)   K7
//       dx = dy . W^T, dW = x^T . dy, db = sum dy; x, dx (rows, 384)
//   tpuwsi/ops/mlp.py:1092  `_gemm_res_bwd_kernel`  (pallas_call at :1146) K9d
//       the same with a (rows, 384) and W (384, d)
//   tpuwsi/ops/mlp.py:1079  `_gemm_res_fwd_kernel`  (pallas_call at :1124) K9c
//       y = res + bf16(a . W + b); res, y (rows, 384), a (rows, f)
// Same arithmetic as the TPU kernels: every product accumulates in fp32, the
// bias is added in fp32 and the product rounded to bf16 before the residual
// is added (y = bf16(res + bf16(acc + b))), dx is bf16, dW and db are fp32
// sums over ALL rows. Rows past the end read as zeros and are never written.
//
// What bounds them on an H100 (published peaks of the SXM part at 700 W:
// 989 TFLOP/s dense bf16, 3.35 TB/s). At the DINO step's student global views
// with the qkv layer, (rows, K, N) = (37,824, 384, 1,152), the backward reads
// x and dy and writes dx (145 MB; 0.044 ms) for two products of 34 GFLOP each
// (0.068 ms): bound by operations. With the proj layer (N = 384) it moves
// 88 MB (0.026 ms) for 22 GFLOP: bound by bytes, as is K9c at (37,824, 384,
// 384): res, a and y, 87 MB (0.026 ms) for 11 GFLOP. What stands between the
// kernels and that bound on this card is the weight each 64-row tile needs
// whole (W is 0.9 MB at the qkv layer: 591 tiles would pull 0.52 GB of it
// through L2), the latency of the loads that feed one chunk's products, and,
// for K9c, the narrow stores of an accumulator's fragments.
//
// What this design does about it:
//   - The row pass (K7's dx, K9c; dense_sm90.cuh's `dense_row_kernel`, K8b's
//     dx tail too): 384-thread blocks, one block per SM (224 KB of shared
//     memory), in clusters of kRowCluster blocks that walk neighbouring 64-row
//     tiles. Two consumer warpgroups own 192 output columns each (m64n192, 96
//     fp32 accumulators a thread, setmaxnreg 232); the producer warpgroup
//     (setmaxnreg 40) has one thread issue the loads. A ring of four 56 KB
//     stages: a stage is one 64-wide chunk of the reduction, the tile's (64 x
//     64) box of the A operand (dy or a) and the chunk of W (64 x 384: six 64
//     x 64 boxes). The reduction is a run-time count of chunks: 6 at 384, 12
//     at 768, 18 at 1,152.
//   - W's chunks are multicast: each block of a cluster loads its share of
//     the six boxes and writes them into every block's stage, so L2 serves W
//     once per cluster of tiles; every consumer warp releases each stage in
//     every block of the cluster, and a producer refills a stage only when
//     all of them have.
//   - W enters as Wᵀ for K7's dx, never copied: stored (384, n), as the JAX
//     layout and K9d have it, each box is 64 output rows of 64 reduction
//     values (the K-major B operand); stored (n, 384), as nn.Linear keeps it,
//     or as K9c's (f, 384), each box is 64 reduction rows of 64 outputs (the
//     MN-major B operand, wgmma's transpose bit). The TMA map's coordinates
//     choose which.
//   - The epilogue (`StoreEpilogue` below: the row pass takes its epilogue as
//     a type) takes one more stage of the ring: for K9c the producer loads the
//     tile's res into it by TMA; each thread adds its fragments (bias in fp32,
//     the rounding, the residual) and writes the bf16 result back in place, in
//     the swizzled layout TMA reads, and one thread of each warpgroup stores
//     its three boxes with TMA (rows past the end clipped). The next tile's
//     chunks load into the other three stages meanwhile.
//   - K7's and K9d's dW and db are dense_sm90.cuh's kernel, the one K8b's
//     tails launch, and `sum_partials_kernel` adds its per-group partials in
//     a fixed order: two launches on the same inputs give the same bits.
//   - What bounds them now (PERF.md; device time): K7 takes 0.14 ms at
//     the qkv layer, 57% of it the dW kernel, whose slices each stream all
//     of x from L2; K9c 0.041 ms, 63% of its bound. Cutting every product
//     saves 2-6%, the TMA stores 5-19%, the multicast 1-3% (clusters of 4
//     against none): the loads' latency, not L2 bandwidth or the tensor
//     cores, is what is left.
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

// K7's dx (kRes false) and K9c's residual sum (kRes true): the tile's rows
// 16 warp + g (a), + 8 (b) and columns 192 kWg + 8i + 2t4, + 1 from acc into
// the epilogue's stage `io` (six boxes of 64 columns, as TMA writes and reads
// them), K9c's res read from the same places first; then one thread stores
// the warpgroup's three boxes.
template <bool kRes>
struct StoreEpilogue {
  struct Params {
    const __nv_bfloat16* bias;  // kRes: (384,)
  };
  static constexpr bool kLoadsRes = kRes;
  static constexpr uint32_t kSmem = 0;

  template <int kWg>
  __device__ static void epilogue(const float (&acc)[96], const Params& ep,
                                  const CUtensorMap* out_map, uint32_t io, uint32_t, int tile,
                                  const RowShape& shape, int tid) {
    tid = static_cast<int>(opaque(static_cast<uint32_t>(tid)));
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int ra = 16 * warp + g, rb = ra + 8;
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int p = 3 * kWg + i / 8, col = 8 * (i % 8) + 2 * t4;  // box p, its column
      const uint32_t at_a = io + p * kBox + swz(ra, col), at_b = io + p * kBox + swz(rb, col);
      float v0 = acc[4 * i], v1 = acc[4 * i + 1], v2 = acc[4 * i + 2], v3 = acc[4 * i + 3];
      if constexpr (kRes) {  // the residual sum in bf16: bf16(res + bf16(acc + b))
        const float2 b =
            mlp::unpack_bf16(*reinterpret_cast<const uint32_t*>(ep.bias + kTile * p + col));
        const float2 res_a = mlp::unpack_bf16(ld_shared_u32(at_a));
        const float2 res_b = mlp::unpack_bf16(ld_shared_u32(at_b));
        v0 = res_a.x + mlp::round_bf16(v0 + b.x);
        v1 = res_a.y + mlp::round_bf16(v1 + b.y);
        v2 = res_b.x + mlp::round_bf16(v2 + b.x);
        v3 = res_b.y + mlp::round_bf16(v3 + b.y);
      }
      st_shared_u32(at_a, pack_bf16(v0, v1));
      st_shared_u32(at_b, pack_bf16(v2, v3));
    }
    fence_proxy_async();       // the generic stores, before TMA reads them
    named_sync(2 + kWg, 128);  // the warpgroup's three boxes, whole
    if (tid == 0 && tile < shape.n_tiles) {
      for (int j = 0; j < 3; ++j)
        tma_store_2d(out_map, io + (3 * kWg + j) * kBox, kTile * (3 * kWg + j), kTile * tile);
      bulk_commit();
      bulk_wait_read<0>();
    }
    named_sync(2 + kWg, 128);  // TMA has read the boxes: the stage may be refilled
  }
};
using DxStore = StoreEpilogue<false>;
using ResStore = StoreEpilogue<true>;

// dx (rows, 384) = dy (rows, n) . W^T, W (384, n) (w_layout 0) or (n, 384) (1).
int dx_pass(const void* dy, const void* w, int w_layout, void* dx, int rows, int n,
            cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap w_map;
  if (!encode_w(&w_map, encode, w, w_layout, n)) return static_cast<int>(cudaErrorInvalidValue);
  return w_layout == 0
             ? launch_rows<DxStore, false>(dy, w_map, nullptr, dx, rows, n / kTile, {}, stream)
             : launch_rows<DxStore, true>(dy, w_map, nullptr, dx, rows, n / kTile, {}, stream);
}

}  // namespace

namespace dense_sm90 {

int bwd(const void* x, const void* dy, const void* w, int w_layout, void* dx, void* grads,
        void* w_part, int rows, int n, int groups, cudaStream_t stream) {
  if (rows < 1 || n < kTile || n % kTile || (w_layout != 0 && w_layout != 1) || groups < 1 ||
      groups > (rows + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = dx_pass(dy, w, w_layout, dx, rows, n, stream);
  if (err != 0) return err;
  err = dw(x, dy, static_cast<float*>(w_part), rows, n, groups, stream);
  if (err != 0) return err;
  const long long n_w = static_cast<long long>(kWidth) * n + n;
  mlp::sum_partials_kernel<float><<<static_cast<unsigned>((n_w + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(w_part), static_cast<float*>(grads), groups, n_w);
  return static_cast<int>(cudaGetLastError());
}

int gemm_res_fwd(const void* res, const void* a, const void* w, const void* b, void* y, int rows,
                 int f, cudaStream_t stream) {
  if (rows < 1 || (f != 384 && f != 768)) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap w_map;  // W (f, 384): 64 reduction rows of 64 outputs a box, MN-major
  if (!encode_2d(&w_map, encode, w, kWidth, f, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<ResStore, true>(a, w_map, res, y, rows, f / kTile,
                                     {static_cast<const __nv_bfloat16*>(b)}, stream);
}

}  // namespace dense_sm90
