// Fused transformer MLP backward, bf16: the hidden activation is rebuilt on
// chip and never reaches device memory.
//
// Replaces two TPU kernels of tpuwsi/ops/mlp.py:
//   kBlock = false  :100 `_mlp_bwd_kernel`        (pallas_call at :185)
//                   (at D = 768 only: D = 384 takes the Hopper kernels of
//                   mlp_sm90.cu, whose partials the same sums add)
//   kBlock = true   :508 `_mlp_block_bwd_kernel`  (pallas_call at :612)
//                   (likewise at D = 768 only)
// Same arithmetic, per row tile, with a = x (or a = bf16(LN(x)) when kBlock):
//   u = a . W1 + b1 (fp32), h = bf16(gelu(u)), gelu'(u) in fp32
//   dh = dy . W2^T,  du = dh * gelu'(u) (fp32),  du_c = bf16(du)
//   dx = du_c . W1^T           (kBlock: this is dln, the gradient at LN's output)
//   dW1 = a^T . du_c, dW2 = h^T . dy, db1 = sum du (the fp32 values), db2 = sum dy
//   kBlock: dxhat = dln * gamma; dx = dy + inv * (dxhat - mean(dxhat) -
//           xhat * mean(dxhat * xhat)); dgamma = sum dln * xhat; dbeta = sum dln
// dx is bf16; every weight and bias gradient is fp32 and summed over ALL
// rows. Rows past the end read as zeros, in x and in dy: a zero row of x
// still gives h = gelu(b1) != 0, and it is dy = 0 there that keeps dW2, dW1
// and db1 clean. Rows past the end of dx are never written.
//
// What bounds it on an H100. At (rows, D, F) = (37,824, 384, 1,536): x, dy
// and dx are 87 MB, the weights and their gradients 12 MB: 0.03 ms at 3.35
// TB/s; five products are 10 rows D F = 223 GFLOP: 0.23 ms at the dense bf16
// peak. Bound by the tensor cores.
//
// What this design does about it. The TPU kernel keeps dW1 and dW2 (2 x 2.36
// MB fp32) in VMEM scratch across a SEQUENTIAL row grid and writes them at the
// last step. A Hopper block has 227 KB and blocks run in no order, so the work
// is cut twice, once along each axis that something must stay on chip for:
//   1. `mlp_bwd_dx_kernel`, one block per row tile (64 rows; 32 at D = 768),
//      walks F in chunks like the forward: dh, u, du for the chunk, then
//      dx += du_c . W1[:, chunk]^T in registers (16 x D/4 fp32 a warp). It
//      writes dx, and per row tile the column sums that need whole rows of D:
//      db2 and, for kBlock, dgamma and dbeta after the LayerNorm backward
//      (row means across the four column warps go through shared memory);
//   2. `mlp_bwd_dw_kernel`, a 2-D grid of (slice of 16 hidden units) x
//      (group of row tiles): the block keeps W1[:, slice] and W2[slice, :]
//      in shared memory and dW1[:, slice], dW2[slice, :] in registers (over
//      16 warps), loops over its rows 32 at a time, rebuilds u, h, dh, du
//      for its slice and adds a^T . du_c
//      and h^T . dy; db1 comes from the same du. It writes one partial per
//      row group. For kBlock its a is the bf16 LN(x) that the first kernel
//      left in a (rows, D) workspace: every slice block would otherwise
//      normalise every row again (that cost a third of the launch);
//   3. `sum_partials_kernel` adds the partials of the row groups (and of the
//      row tiles for db2, dgamma, dbeta) in a fixed order.
// So u and dh are built twice (7 products where one pass needs 5), as the
// attention backward is split into dQ and dK/dV: in exchange every output
// element has one writer and no atomics, and the result is the same from run
// to run, bit for bit, which checkpoints that replay exactly need. The other
// way, one pass that adds dW tiles with red.global.add.f32, sums in an order
// that changes between runs. The number of row groups depends only on the
// shapes and the card's SM count (the caller passes it), so it too is fixed.
// The (rows, F) intermediates never leave the chip; the price is L2 traffic:
// each slice block streams its row group's x and dy, F / 64 times 58 MB at
// this shape (slices of 32 units read twice as much and were 15% slower).
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include "mlp_common.cuh"

namespace mlp_sm90 {
int bwd(const void* x, const void* dy, const void* w1, const void* b1, const void* w2, void* dx,
        float* w_part, float* row_part, int rows, int f, int n_row_tiles, int groups, int approx,
        cudaStream_t stream);
int block_bwd(const void* x, const void* dy, const void* gamma, const void* beta, const void* w1,
              const void* b1, const void* w2, void* dx, float* w_part, float* row_part,
              void* ln_work, int rows, int f, int n_row_tiles, int groups, float eps, int approx,
              cudaStream_t stream);
}

namespace {

using namespace mlp;

// ---------------------------------------------------------------------------
// 1. dx (and the column sums of whole rows)
// ---------------------------------------------------------------------------

template <int D>
constexpr int dx_smem_bytes() {
  using T = Tile<D>;
  return 2 * (2 * T::kRows * T::kXStride + D * T::kFStride + T::kFc * T::kXStride +
              T::kRows * T::kFStride) +
         4 * 2 * T::kRows;  // mean and 1/sigma of each row
}

// row_part: (n_row_tiles, kBlock ? 3 : 1, D) fp32: db2 (, dgamma, dbeta) of
// this block's rows.
template <int D, bool kBlock>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
mlp_bwd_dx_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ dx,
                  __nv_bfloat16* __restrict__ ln_out, float* __restrict__ row_part, int rows,
                  int f, float eps, int approx) {
  using T = Tile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kXStride]
  __nv_bfloat16* dy_s = x_s + T::kRows * T::kXStride;               // [kRows][kXStride]
  __nv_bfloat16* w1_s = dy_s + T::kRows * T::kXStride;              // [D][kFStride]
  __nv_bfloat16* w2_s = w1_s + D * T::kFStride;                     // [kFc][kXStride]
  __nv_bfloat16* du_s = w2_s + T::kFc * T::kXStride;                // [kRows][kFStride]
  float* mean_s = reinterpret_cast<float*>(du_s + T::kRows * T::kFStride);  // [kRows]
  float* inv_s = mean_s + T::kRows;                                         // [kRows]

  const int row0 = blockIdx.x * T::kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / T::kColGroups, cg = warp % T::kColGroups;
  const Lane L(lane);
  const int n_chunks = f / T::kFc;

  if constexpr (!kBlock) stage_rows(x_s, T::kXStride, x, D, row0, rows, T::kRows, D);
  stage_rows(dy_s, T::kXStride, dy, D, row0, rows, T::kRows, D);
  stage_rows(w2_s, T::kXStride, w2, D, 0, T::kFc, T::kFc, D);
  cp_async_commit();
  stage_rows(w1_s, T::kFStride, w1, f, 0, D, D, T::kFc);
  cp_async_commit();
  if constexpr (kBlock) {
    for (int r = warp; r < T::kRows; r += T::kWarps) {
      const int row = row0 + r;
      const bool ok = row < rows;
      float mean, inv;
      layer_norm_row<D>(ok ? x + static_cast<size_t>(row) * D : nullptr, gamma, beta, eps,
                        x_s + r * T::kXStride,
                        ok ? ln_out + static_cast<size_t>(row) * D : nullptr, lane, &mean, &inv);
      if (lane == 0) {
        mean_s[r] = mean;
        inv_s[r] = inv;
      }
    }
  }

  constexpr int kNOut = T::kColsPerWarp / 8;
  float acc[kNOut][4];
#pragma unroll
  for (int nt = 0; nt < kNOut; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();  // x, dy and this chunk of W2; W1's may be in flight
    __syncthreads();

    // dh = dy . W2[chunk, :]^T: this warp's 16 rows x kN1 n-tiles, over all of D
    float dh[T::kN1][4], u[T::kN1][4];
#pragma unroll
    for (int nt = 0; nt < T::kN1; ++nt) {
      dh[nt][0] = dh[nt][1] = dh[nt][2] = dh[nt][3] = 0.f;
      u[nt][0] = u[nt][1] = u[nt][2] = u[nt][3] = 0.f;
    }
    const __nv_bfloat16* dya = dy_s + rg * 16 * T::kXStride;
    const __nv_bfloat16* w2b = w2_s + cg * (T::kN1 * 8) * T::kXStride;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, L.a_rows(dya + kk * 16, T::kXStride));
      if constexpr (T::kN1 == 2) {
        uint32_t b[4];
        ldmatrix_x4(b, L.b_nk(w2b + kk * 16, T::kXStride));
        mma_16816(dh[0], a, b[0], b[1]);
        mma_16816(dh[1], a, b[2], b[3]);
      } else {
        uint32_t b[2];
        ldmatrix_x2(b, L.b_nk(w2b + kk * 16, T::kXStride));
        mma_16816(dh[0], a, b[0], b[1]);
      }
    }
    cp_async_wait<0>();  // this chunk of W1
    __syncthreads();

    // u = a . W1[:, chunk]
    const __nv_bfloat16* xa = x_s + rg * 16 * T::kXStride;
    const __nv_bfloat16* w1b = w1_s + cg * (T::kN1 * 8);
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, L.a_rows(xa + kk * 16, T::kXStride));
      if constexpr (T::kN1 == 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, L.b_kn(w1b + kk * 16 * T::kFStride, T::kFStride));
        mma_16816(u[0], a, b[0], b[1]);
        mma_16816(u[1], a, b[2], b[3]);
      } else {
        uint32_t b[2];
        ldmatrix_x2_trans(b, L.b_kn(w1b + kk * 16 * T::kFStride, T::kFStride));
        mma_16816(u[0], a, b[0], b[1]);
      }
    }
    // du_c = bf16(dh * gelu'(u + b1)) -> shared memory
#pragma unroll
    for (int nt = 0; nt < T::kN1; ++nt) {
      const int col = cg * (T::kN1 * 8) + nt * 8 + 2 * t;
      const float2 bias =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(b1 + c * T::kFc + col));
      float dg[4];
      gelu_and_grad(u[nt][0] + bias.x, approx, &dg[0]);
      gelu_and_grad(u[nt][1] + bias.y, approx, &dg[1]);
      gelu_and_grad(u[nt][2] + bias.x, approx, &dg[2]);
      gelu_and_grad(u[nt][3] + bias.y, approx, &dg[3]);
      __nv_bfloat16* dst = du_s + (rg * 16 + g) * T::kFStride + col;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(dh[nt][0] * dg[0], dh[nt][1] * dg[1]);
      *reinterpret_cast<uint32_t*>(dst + 8 * T::kFStride) =
          pack_bf16(dh[nt][2] * dg[2], dh[nt][3] * dg[3]);
    }
    __syncthreads();  // du is whole; nobody reads the W2 chunk any more
    if (c + 1 < n_chunks) {
      stage_rows(w2_s, T::kXStride, w2 + static_cast<size_t>(c + 1) * T::kFc * D, D, 0, T::kFc,
                 T::kFc, D);
      cp_async_commit();
    }

    // acc += du_c . W1[:, chunk]^T: this warp's 16 rows x its quarter of D
    const __nv_bfloat16* dua = du_s + rg * 16 * T::kFStride;
#pragma unroll
    for (int kk = 0; kk < T::kFc / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, L.a_rows(dua + kk * 16, T::kFStride));
      const __nv_bfloat16* wrow = w1_s + cg * T::kColsPerWarp * T::kFStride + kk * 16;
#pragma unroll
      for (int nt = 0; nt < kNOut; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, L.b_nk(wrow + nt * 8 * T::kFStride, T::kFStride));
        mma_16816(acc[nt], a, b[0], b[1]);
        mma_16816(acc[nt + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next copies overwrite the W1 chunk, the next du this one
    if (c + 1 < n_chunks) {
      stage_rows(w1_s, T::kFStride, w1 + (c + 1) * T::kFc, f, 0, D, D, T::kFc);
      cp_async_commit();
    }
  }

  constexpr int kParts = kBlock ? 3 : 1;
  float* part = row_part + static_cast<size_t>(blockIdx.x) * kParts * D;

  if constexpr (!kBlock) {
    const int row_a = row0 + rg * 16 + g, row_b = row_a + 8;  // this thread's rows
#pragma unroll
    for (int nt = 0; nt < kNOut; ++nt) {
      const int col = cg * T::kColsPerWarp + nt * 8 + 2 * t;
      if (row_a < rows)
        *reinterpret_cast<uint32_t*>(dx + static_cast<size_t>(row_a) * D + col) =
            pack_bf16(acc[nt][0], acc[nt][1]);
      if (row_b < rows)
        *reinterpret_cast<uint32_t*>(dx + static_cast<size_t>(row_b) * D + col) =
            pack_bf16(acc[nt][2], acc[nt][3]);
    }
  } else {
    // The weight chunks and du are free now: their room takes the sums.
    float* row_red = reinterpret_cast<float*>(w1_s);          // [kRows][kColGroups][2]
    float* col_red = row_red + T::kRows * T::kColGroups * 2;  // [kRows / 16][2][D]
    layer_norm_backward_tile<D, true>(acc, x, gamma, mean_s, inv_s, dy_s, row_red, col_red, dx,
                                      part + D, row0, rows);
  }
  // db2 of this tile: column sums of dy (rows past the end are zero)
  for (int col = threadIdx.x; col < D; col += T::kThreads) {
    float s = 0.f;
    for (int r = 0; r < T::kRows; ++r) s += __bfloat162float(dy_s[r * T::kXStride + col]);
    part[col] = s;
  }
}

// ---------------------------------------------------------------------------
// 2. dW1, dW2, db1 per (slice of the hidden dimension, group of row tiles)
// ---------------------------------------------------------------------------

// The grid's blocks at D = 768 (D = 384 takes the dW passes of mlp_sm90.cu).
template <int D>
struct Slice {
  static_assert(D == 768, "the row-tiled backward is built for D = 768");
  using T = Tile<D>;
  static constexpr int kWarps = 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kFs = 16;    // hidden units per block
  static constexpr int kRows = 32;  // rows per step
  static constexpr int kFStride = kFs + kPad;
  static constexpr int kXStride = D + kPad;
  static constexpr int kTilesM = kRows / 16, kTilesN = kFs / 8;  // m- and n-tiles of u, dh, du
  // u, dh and du are built in pieces of 16 x 16 (two n-tiles), dealt to the warps
  static constexpr int kPieces = kTilesM * (kTilesN / 2);
  static constexpr int kPiecesPerWarp = (kPieces + kWarps - 1) / kWarps;
  static constexpr int kM1 = D / 16 / kWarps;  // m-tiles of dW1[:, slice] a warp owns
  static constexpr int kN2 = D / 8 / kWarps;   // n-tiles of dW2[slice, :] a warp owns
  static_assert(D / 16 % kWarps == 0 && kN2 % 2 == 0 && kTilesN % 2 == 0, "warp split");
  static constexpr int smem_bytes() {
    return 2 * (D * kFStride + kFs * kXStride + 2 * kRows * kXStride + 2 * kRows * kFStride) +
           4 * kTilesM * kFs;
  }
};

// x: fc1's input (for the sub-block: the LN(x) that the dx kernel wrote).
// w_part: (groups, 2 D F + F) fp32: dW1 (D, F), dW2 (F, D), db1 (F,) of the
// rows of each group.
template <int D>
__global__ void __launch_bounds__(Slice<D>::kThreads, 1)
mlp_bwd_dw_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                  const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2, float* __restrict__ w_part, int rows,
                  int f, int approx) {
  using S = Slice<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w1_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [D][kFStride]
  __nv_bfloat16* w2_s = w1_s + D * S::kFStride;                      // [kFs][kXStride]
  __nv_bfloat16* x_s = w2_s + S::kFs * S::kXStride;                 // [kRows][kXStride]
  __nv_bfloat16* dy_s = x_s + S::kRows * S::kXStride;                // the same
  __nv_bfloat16* h_s = dy_s + S::kRows * S::kXStride;                // [kRows][kFStride]
  __nv_bfloat16* du_s = h_s + S::kRows * S::kFStride;                // [kRows][kFStride]
  float* db1_s = reinterpret_cast<float*>(du_s + S::kRows * S::kFStride);  // [kTilesM][kFs]

  const int f0 = blockIdx.x * S::kFs;
  const int n_tiles = (rows + S::kRows - 1) / S::kRows;
  const int per_group = (n_tiles + gridDim.y - 1) / gridDim.y;
  const int tile_lo = blockIdx.y * per_group;
  const int tile_hi = min(tile_lo + per_group, n_tiles);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Lane L(lane);

  auto stage_tile = [&](int tile) {
    stage_rows(x_s, S::kXStride, x, D, tile * S::kRows, rows, S::kRows, D);
    stage_rows(dy_s, S::kXStride, dy, D, tile * S::kRows, rows, S::kRows, D);
    cp_async_commit();
  };
  stage_rows(w1_s, S::kFStride, w1 + f0, f, 0, D, D, S::kFs);
  stage_rows(w2_s, S::kXStride, w2 + static_cast<size_t>(f0) * D, D, 0, S::kFs, S::kFs, D);
  if (tile_lo < tile_hi) stage_tile(tile_lo);  // one group with the weights
  else cp_async_commit();

  float acc1[S::kM1][S::kTilesN][4];       // dW1[warp's rows of D, slice]
  float acc2[S::kFs / 16][S::kN2][4];      // dW2[slice, warp's columns of D]
  float db1_acc[S::kPiecesPerWarp][2][2];
#pragma unroll
  for (int i = 0; i < S::kM1; ++i)
#pragma unroll
    for (int j = 0; j < S::kTilesN; ++j)
      acc1[i][j][0] = acc1[i][j][1] = acc1[i][j][2] = acc1[i][j][3] = 0.f;
#pragma unroll
  for (int i = 0; i < S::kFs / 16; ++i)
#pragma unroll
    for (int j = 0; j < S::kN2; ++j)
      acc2[i][j][0] = acc2[i][j][1] = acc2[i][j][2] = acc2[i][j][3] = 0.f;
#pragma unroll
  for (int i = 0; i < S::kPiecesPerWarp; ++i)
    db1_acc[i][0][0] = db1_acc[i][0][1] = db1_acc[i][1][0] = db1_acc[i][1][1] = 0.f;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    cp_async_wait<0>();
    __syncthreads();

    // u, dh, h, du of the slice: 16 x 16 pieces dealt to the warps in turn
#pragma unroll
    for (int i = 0; i < S::kPiecesPerWarp; ++i) {
      const int piece = warp + i * S::kWarps;
      if (piece < S::kPieces) {
        const int mt = piece / (S::kTilesN / 2), np = piece % (S::kTilesN / 2);
        float u[2][4], dh[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          u[j][0] = u[j][1] = u[j][2] = u[j][3] = 0.f;
          dh[j][0] = dh[j][1] = dh[j][2] = dh[j][3] = 0.f;
        }
        const __nv_bfloat16* xa = x_s + mt * 16 * S::kXStride;
        const __nv_bfloat16* dya = dy_s + mt * 16 * S::kXStride;
        const __nv_bfloat16* w1b = w1_s + np * 16;
        const __nv_bfloat16* w2b = w2_s + np * 16 * S::kXStride;
#pragma unroll 4
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4], b[4];
          ldmatrix_x4(a, L.a_rows(xa + kk * 16, S::kXStride));
          ldmatrix_x4_trans(b, L.b_kn(w1b + kk * 16 * S::kFStride, S::kFStride));
          mma_16816(u[0], a, b[0], b[1]);
          mma_16816(u[1], a, b[2], b[3]);
          ldmatrix_x4(a, L.a_rows(dya + kk * 16, S::kXStride));
          ldmatrix_x4(b, L.b_nk(w2b + kk * 16, S::kXStride));
          mma_16816(dh[0], a, b[0], b[1]);
          mma_16816(dh[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = np * 16 + j * 8 + 2 * t;
          const float2 bias = unpack_bf16(*reinterpret_cast<const uint32_t*>(b1 + f0 + col));
          float dg[4], hv[4];
          hv[0] = gelu_and_grad(u[j][0] + bias.x, approx, &dg[0]);
          hv[1] = gelu_and_grad(u[j][1] + bias.y, approx, &dg[1]);
          hv[2] = gelu_and_grad(u[j][2] + bias.x, approx, &dg[2]);
          hv[3] = gelu_and_grad(u[j][3] + bias.y, approx, &dg[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) dg[e] *= dh[j][e];  // du, fp32
          db1_acc[i][j][0] += dg[0] + dg[2];
          db1_acc[i][j][1] += dg[1] + dg[3];
          const int at = (mt * 16 + g) * S::kFStride + col;
          *reinterpret_cast<uint32_t*>(h_s + at) = pack_bf16(hv[0], hv[1]);
          *reinterpret_cast<uint32_t*>(h_s + at + 8 * S::kFStride) = pack_bf16(hv[2], hv[3]);
          *reinterpret_cast<uint32_t*>(du_s + at) = pack_bf16(dg[0], dg[1]);
          *reinterpret_cast<uint32_t*>(du_s + at + 8 * S::kFStride) = pack_bf16(dg[2], dg[3]);
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < S::kRows / 16; ++kk) {
      // dW1[:, slice] += a^T . du_c
      uint32_t bdu[S::kTilesN / 2][4];
#pragma unroll
      for (int j = 0; j < S::kTilesN / 2; ++j)
        ldmatrix_x4_trans(bdu[j], L.b_kn(du_s + kk * 16 * S::kFStride + j * 16, S::kFStride));
#pragma unroll
      for (int i = 0; i < S::kM1; ++i) {
        uint32_t a[4];
        ldmatrix_x4_trans(
            a, L.a_cols(x_s + kk * 16 * S::kXStride + (warp * S::kM1 + i) * 16, S::kXStride));
#pragma unroll
        for (int j = 0; j < S::kTilesN / 2; ++j) {
          mma_16816(acc1[i][2 * j], a, bdu[j][0], bdu[j][1]);
          mma_16816(acc1[i][2 * j + 1], a, bdu[j][2], bdu[j][3]);
        }
      }
      // dW2[slice, :] += h^T . dy
      uint32_t ah[S::kFs / 16][4];
#pragma unroll
      for (int i = 0; i < S::kFs / 16; ++i)
        ldmatrix_x4_trans(ah[i], L.a_cols(h_s + kk * 16 * S::kFStride + i * 16, S::kFStride));
#pragma unroll
      for (int j = 0; j < S::kN2; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, L.b_kn(dy_s + kk * 16 * S::kXStride + (warp * S::kN2 + j) * 8, S::kXStride));
#pragma unroll
        for (int i = 0; i < S::kFs / 16; ++i) {
          mma_16816(acc2[i][j], ah[i], b[0], b[1]);
          mma_16816(acc2[i][j + 1], ah[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next tiles overwrite h, du and the rows
    if (tile + 1 < tile_hi) stage_tile(tile + 1);
  }
  cp_async_wait<0>();  // a group with no row tile still waits for its weight copies

  float* part = w_part + static_cast<size_t>(blockIdx.y) * (2 * static_cast<size_t>(D) * f + f);
  float* dw1 = part;
  float* dw2 = part + static_cast<size_t>(D) * f;
  float* db1 = dw2 + static_cast<size_t>(D) * f;
#pragma unroll
  for (int i = 0; i < S::kM1; ++i) {
    const int d0 = (warp * S::kM1 + i) * 16 + g;
#pragma unroll
    for (int j = 0; j < S::kTilesN; ++j) {
      const int col = f0 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(dw1 + static_cast<size_t>(d0) * f + col) =
          make_float2(acc1[i][j][0], acc1[i][j][1]);
      *reinterpret_cast<float2*>(dw1 + static_cast<size_t>(d0 + 8) * f + col) =
          make_float2(acc1[i][j][2], acc1[i][j][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < S::kFs / 16; ++i) {
    const int fr = f0 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < S::kN2; ++j) {
      const int col = (warp * S::kN2 + j) * 8 + 2 * t;
      *reinterpret_cast<float2*>(dw2 + static_cast<size_t>(fr) * D + col) =
          make_float2(acc2[i][j][0], acc2[i][j][1]);
      *reinterpret_cast<float2*>(dw2 + static_cast<size_t>(fr + 8) * D + col) =
          make_float2(acc2[i][j][2], acc2[i][j][3]);
    }
  }
  // db1: the pieces' column sums over the eight g lanes, then over the m-tiles
#pragma unroll
  for (int i = 0; i < S::kPiecesPerWarp; ++i) {
    const int piece = warp + i * S::kWarps;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s0 = db1_acc[i][j][0], s1 = db1_acc[i][j][1];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (g == 0 && piece < S::kPieces) {
        const int mt = piece / (S::kTilesN / 2), np = piece % (S::kTilesN / 2);
        db1_s[mt * S::kFs + np * 16 + j * 8 + 2 * t] = s0;
        db1_s[mt * S::kFs + np * 16 + j * 8 + 2 * t + 1] = s1;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < S::kFs) {
    float s = 0.f;
#pragma unroll
    for (int mt = 0; mt < S::kTilesM; ++mt) s += db1_s[mt * S::kFs + threadIdx.x];
    db1[f0 + threadIdx.x] = s;
  }
}

// grads: dW1 (D, F) | dW2 (F, D) | db1 (F,) | db2 (D,) [| dgamma (D,) | dbeta (D,)], each
// the sum of its partials in the order of their index.
template <int D, bool kBlock>
int sum_grads(void* grads, const void* w_part, const void* row_part, int f, int n_row_tiles,
              int groups, cudaStream_t stream) {
  const long long n_w = 2LL * D * f + f, n_row = (kBlock ? 3LL : 1LL) * D;
  float* out = static_cast<float*>(grads);
  sum_partials_kernel<float><<<static_cast<unsigned>((n_w + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(w_part), out, groups, n_w);
  sum_partials_kernel<float><<<static_cast<unsigned>((n_row + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(row_part), out + n_w, n_row_tiles, n_row);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBlock>
int launch(const void* x, const void* dy, const void* gamma, const void* beta, const void* w1,
           const void* b1, const void* w2, void* dx, void* grads, void* w_part, void* row_part,
           void* ln_work, int rows, int f, int n_row_tiles, int groups, float eps, int approx,
           void* stream_) {
  using T = Tile<D>;
  using S = Slice<D>;
  if (n_row_tiles != (rows + T::kRows - 1) / T::kRows || groups < 1 || groups > n_row_tiles ||
      groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* dyp = static_cast<const __nv_bfloat16*>(dy);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  const auto* w1p = static_cast<const __nv_bfloat16*>(w1);
  const auto* b1p = static_cast<const __nv_bfloat16*>(b1);
  const auto* w2p = static_cast<const __nv_bfloat16*>(w2);

  auto dx_kernel = mlp_bwd_dx_kernel<D, kBlock>;
  constexpr int kDxSmem = dx_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dx_kernel<<<n_row_tiles, T::kThreads, kDxSmem, stream>>>(
      xp, dyp, gp, bp, w1p, b1p, w2p, static_cast<__nv_bfloat16*>(dx),
      static_cast<__nv_bfloat16*>(ln_work), static_cast<float*>(row_part), rows, f, eps, approx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dw_kernel = mlp_bwd_dw_kernel<D>;
  constexpr int kDwSmem = S::smem_bytes();
  err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<<<dim3(f / S::kFs, groups), S::kThreads, kDwSmem, stream>>>(
      kBlock ? static_cast<const __nv_bfloat16*>(ln_work) : xp, dyp, w1p, b1p, w2p,
      static_cast<float*>(w_part), rows, f, approx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_grads<D, kBlock>(grads, w_part, row_part, f, n_row_tiles, groups, stream);
}

// K5b and K6b at D = 384: the kernels of mlp_sm90.cu, then the same sums.
template <bool kBlock>
int launch_sm90(const void* x, const void* dy, const void* gamma, const void* beta, const void* w1,
                const void* b1, const void* w2, void* dx, void* grads, void* w_part,
                void* row_part, void* ln_work, int rows, int f, int n_row_tiles, int groups,
                float eps, int approx, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  float* wp = static_cast<float*>(w_part);
  float* rp = static_cast<float*>(row_part);
  const int err =
      kBlock ? mlp_sm90::block_bwd(x, dy, gamma, beta, w1, b1, w2, dx, wp, rp, ln_work, rows, f,
                                   n_row_tiles, groups, eps, approx, stream)
             : mlp_sm90::bwd(x, dy, w1, b1, w2, dx, wp, rp, rows, f, n_row_tiles, groups, approx,
                             stream);
  if (err != 0) return err;
  return sum_grads<384, kBlock>(grads, w_part, row_part, f, n_row_tiles, groups, stream);
}

template <bool kBlock>
int dispatch(const void* x, const void* dy, const void* gamma, const void* beta, const void* w1,
             const void* b1, const void* w2, void* dx, void* grads, void* w_part,
             void* row_part, void* ln_work, int rows, int d, int f, int n_row_tiles, int groups,
             float eps, int approx, void* stream) {
  if (rows < 1 || f < 64 || f % 64) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 384)  // K5b, K6b: the Hopper kernels of mlp_sm90.cu
    return launch_sm90<kBlock>(x, dy, gamma, beta, w1, b1, w2, dx, grads, w_part, row_part,
                               ln_work, rows, f, n_row_tiles, groups, eps, approx, stream);
  if (d == 768)
    return launch<768, kBlock>(x, dy, gamma, beta, w1, b1, w2, dx, grads, w_part, row_part,
                               ln_work, rows, f, n_row_tiles, groups, eps, approx, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Rows of one row tile for embedding width d (0 for a width that is not built).
int tpuwsi_mlp_rows_per_tile(int d) {
  if (d == 384) return Tile<384>::kRows;
  if (d == 768) return Tile<768>::kRows;
  return 0;
}

// Hidden units per block of the weight-gradient grid, likewise (D = 384 has
// none: its dW passes are mlp_sm90.cu's).
int tpuwsi_mlp_hidden_per_slice(int d) {
  return d == 768 ? Slice<768>::kFs : 0;
}

// x, dy, dx: (rows, d) bf16; w1: (d, f), b1: (f,), w2: (f, d) bf16; all
// contiguous and 16-byte aligned; d is 384 or 768, f a multiple of 64.
// grads (out): 2 d f + f + d fp32 = dW1 (d, f) | dW2 (f, d) | db1 | db2.
// Workspaces, fp32, contents undefined on entry: w_part (groups, 2 d f + f),
// row_part (n_row_tiles, d), with n_row_tiles = ceil(rows / rows_per_tile(d))
// and groups row groups in the weight-gradient grid: 1 <= groups <=
// n_row_tiles at d = 768, 1 <= groups <= ceil(rows / 32) at d = 384 (here
// and in the sub-block's backward below).
int tpuwsi_mlp_bwd(const void* x, const void* dy, const void* w1, const void* b1, const void* w2,
                   void* dx, void* grads, void* w_part, void* row_part, int rows, int d, int f,
                   int n_row_tiles, int groups, int approx, void* stream) {
  return dispatch<false>(x, dy, nullptr, nullptr, w1, b1, w2, dx, grads, w_part, row_part,
                         nullptr, rows, d, f, n_row_tiles, groups, 0.f, approx, stream);
}

// As above for the pre-norm sub-block; gamma, beta: (d,) fp32, 8-byte
// aligned. grads: ... | db2 | dgamma (d,) | dbeta (d,); row_part
// (n_row_tiles, 3 d); one more workspace, ln_work (rows, d) bf16, takes the
// LayerNorm's output from the first kernel to the second.
int tpuwsi_mlp_block_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
                         const void* w1, const void* b1, const void* w2, void* dx, void* grads,
                         void* w_part, void* row_part, void* ln_work, int rows, int d, int f,
                         int n_row_tiles, int groups, float eps, int approx, void* stream) {
  return dispatch<true>(x, dy, gamma, beta, w1, b1, w2, dx, grads, w_part, row_part, ln_work,
                        rows, d, f, n_row_tiles, groups, eps, approx, stream);
}

}  // extern "C"
