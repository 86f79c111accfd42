// Device kernels of a dense layer's backward that more than one source
// launches (dense.cu, attn_block.cu): dx = dy . W^T per row tile, with the
// LayerNorm backward and a residual cotangent where asked for, and dW, db per
// (slice of the output columns, group of row tiles).

#pragma once

#include "mlp_common.cuh"

namespace mlp {


// ---------------------------------------------------------------------------
// backward 1: dx = dy . W^T (and, for the LN+GEMM, the LayerNorm backward)
// ---------------------------------------------------------------------------

template <int K, bool kRes = false>
constexpr int dx_smem_bytes() {
  using T = Tile<K>;
  return 2 * 2 * (T::kRows + K) * T::kFStride + 4 * 2 * T::kRows +
         (kRes ? 2 * T::kRows * T::kXStride : 0);
}

// row_part (kLn only): (n_row_tiles, 2, K) fp32: dgamma, dbeta of this
// block's rows. ln_out (kLn only): (rows, K) bf16, takes LN(x). kRes (with
// kLn): `res` (rows, K), the cotangent that reaches x past the layer, is added
// to the LayerNorm backward's result in fp32 before dx is rounded.
template <int K, bool kLn, bool kRes = false>
__global__ void __launch_bounds__(Tile<K>::kThreads, 1)
dense_bwd_dx_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ res,
                    __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ ln_out,
                    float* __restrict__ row_part, int rows, int n, float eps) {
  static_assert(kLn || !kRes, "the residual cotangent joins in the LayerNorm backward");
  using T = Tile<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* dy_bufs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kRows][kFStride]
  __nv_bfloat16* w_bufs = dy_bufs + 2 * T::kRows * T::kFStride;         // [2][K][kFStride]
  float* mean_s = reinterpret_cast<float*>(w_bufs + 2 * K * T::kFStride);  // [kRows]
  float* inv_s = mean_s + T::kRows;                                        // [kRows]
  __nv_bfloat16* res_s = reinterpret_cast<__nv_bfloat16*>(inv_s + T::kRows);  // [kRows][kXStride]

  const int row0 = blockIdx.x * T::kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp / T::kColGroups, cg = warp % T::kColGroups;
  const Lane L(lane);
  const int n_chunks = n / T::kFc;

  auto stage = [&](int c) {
    stage_rows(dy_bufs + (c & 1) * T::kRows * T::kFStride, T::kFStride, dy + c * T::kFc, n, row0,
               rows, T::kRows, T::kFc);
    stage_rows(w_bufs + (c & 1) * K * T::kFStride, T::kFStride, w + c * T::kFc, n, 0, K, K,
               T::kFc);
    cp_async_commit();
  };
  if constexpr (kRes)  // one group with the first chunk
    stage_rows(res_s, T::kXStride, res, K, row0, rows, T::kRows, K);
  stage(0);
  if constexpr (kLn) {
    for (int r = warp; r < T::kRows; r += T::kWarps) {
      const int row = row0 + r;
      const bool ok = row < rows;
      float mean, inv;
      layer_norm_row<K>(ok ? x + static_cast<size_t>(row) * K : nullptr, gamma, beta, eps, nullptr,
                        ok ? ln_out + static_cast<size_t>(row) * K : nullptr, lane, &mean, &inv);
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
    cp_async_wait<0>();  // this chunk of dy and W
    __syncthreads();     // ... is whole; nobody reads the other buffers any more
    if (c + 1 < n_chunks) stage(c + 1);

    // acc += dy[:, chunk] . W[:, chunk]^T: this warp's 16 rows x its quarter of K
    const __nv_bfloat16* dya = dy_bufs + ((c & 1) * T::kRows + rg * 16) * T::kFStride;
    const __nv_bfloat16* wrow = w_bufs + ((c & 1) * K + cg * T::kColsPerWarp) * T::kFStride;
#pragma unroll
    for (int kk = 0; kk < T::kFc / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, L.a_rows(dya + kk * 16, T::kFStride));
#pragma unroll
      for (int nt = 0; nt < kNOut; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, L.b_nk(wrow + nt * 8 * T::kFStride + kk * 16, T::kFStride));
        mma_16816(acc[nt], a, b[0], b[1]);
        mma_16816(acc[nt + 1], a, b[2], b[3]);
      }
    }
  }

  if constexpr (!kLn) {
    const int g = lane >> 2, t = lane & 3;
    const int row_a = row0 + rg * 16 + g, row_b = row_a + 8;  // this thread's rows
#pragma unroll
    for (int nt = 0; nt < kNOut; ++nt) {
      const int col = cg * T::kColsPerWarp + nt * 8 + 2 * t;
      if (row_a < rows)
        *reinterpret_cast<uint32_t*>(dx + static_cast<size_t>(row_a) * K + col) =
            pack_bf16(acc[nt][0], acc[nt][1]);
      if (row_b < rows)
        *reinterpret_cast<uint32_t*>(dx + static_cast<size_t>(row_b) * K + col) =
            pack_bf16(acc[nt][2], acc[nt][3]);
    }
  } else {
    __syncthreads();  // the weight chunks are free now: their room takes the sums
    float* row_red = reinterpret_cast<float*>(w_bufs);        // [kRows][kColGroups][2]
    float* col_red = row_red + T::kRows * T::kColGroups * 2;  // [kRows / 16][2][K]
    layer_norm_backward_tile<K, kRes>(acc, x, gamma, mean_s, inv_s, kRes ? res_s : nullptr,
                                      row_red, col_red, dx,
                                      row_part + static_cast<size_t>(blockIdx.x) * 2 * K, row0,
                                      rows);
  }
}

// ---------------------------------------------------------------------------
// backward 2: dW, db per (slice of the output columns, group of row tiles)
// ---------------------------------------------------------------------------

template <int K>
struct DwSlice {
  static constexpr int kWarps = K <= 384 ? 12 : 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kNs = K <= 384 ? 64 : 32;    // output columns per block
  static constexpr int kRows = K <= 384 ? 64 : 32;  // rows per step
  static constexpr int kNStride = kNs + kPad;
  static constexpr int kXStride = K + kPad;
  static constexpr int kM = K / 16 / kWarps;  // m-tiles of dW[:, slice] a warp owns
  static constexpr int kTilesN = kNs / 8;
  static_assert(K / 16 % kWarps == 0 && kTilesN % 2 == 0 && kNs <= kThreads, "warp split");
  static constexpr int smem_bytes() { return 2 * 2 * kRows * (kXStride + kNStride); }
};

// a: the layer's input (for the LN+GEMM: the LN(x) that the dx kernel wrote).
// w_part: (groups, K n + n) fp32: dW (K, n), db (n,) of the rows of each group.
template <int K>
__global__ void __launch_bounds__(DwSlice<K>::kThreads, 1)
dense_bwd_dw_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ dy,
                    float* __restrict__ w_part, int rows, int n) {
  using S = DwSlice<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* a_bufs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kRows][kXStride]
  __nv_bfloat16* dy_bufs = a_bufs + 2 * S::kRows * S::kXStride;        // [2][kRows][kNStride]

  const int n0 = blockIdx.x * S::kNs;
  const int n_tiles = (rows + S::kRows - 1) / S::kRows;
  const int per_group = (n_tiles + gridDim.y - 1) / gridDim.y;
  const int tile_lo = blockIdx.y * per_group;
  const int tile_hi = min(tile_lo + per_group, n_tiles);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Lane L(lane);

  auto stage_tile = [&](int tile) {
    const int buf = (tile - tile_lo) & 1;
    stage_rows(a_bufs + buf * S::kRows * S::kXStride, S::kXStride, a, K, tile * S::kRows, rows,
               S::kRows, K);
    stage_rows(dy_bufs + buf * S::kRows * S::kNStride, S::kNStride, dy + n0, n, tile * S::kRows,
               rows, S::kRows, S::kNs);
    cp_async_commit();
  };
  if (tile_lo < tile_hi) stage_tile(tile_lo);

  float acc[S::kM][S::kTilesN][4];  // dW[warp's rows of K, slice]
#pragma unroll
  for (int i = 0; i < S::kM; ++i)
#pragma unroll
    for (int j = 0; j < S::kTilesN; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float db_acc = 0.f;  // of column n0 + threadIdx.x, in the first kNs threads

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    cp_async_wait<0>();  // this tile
    __syncthreads();     // ... is whole; nobody reads the other buffers any more
    if (tile + 1 < tile_hi) stage_tile(tile + 1);
    const int buf = (tile - tile_lo) & 1;
    const __nv_bfloat16* a_s = a_bufs + buf * S::kRows * S::kXStride;
    const __nv_bfloat16* dy_s = dy_bufs + buf * S::kRows * S::kNStride;

#pragma unroll
    for (int kk = 0; kk < S::kRows / 16; ++kk) {
      uint32_t bdy[S::kTilesN / 2][4];
#pragma unroll
      for (int j = 0; j < S::kTilesN / 2; ++j)
        ldmatrix_x4_trans(bdy[j], L.b_kn(dy_s + kk * 16 * S::kNStride + j * 16, S::kNStride));
#pragma unroll
      for (int i = 0; i < S::kM; ++i) {
        uint32_t af[4];
        ldmatrix_x4_trans(
            af, L.a_cols(a_s + kk * 16 * S::kXStride + (warp * S::kM + i) * 16, S::kXStride));
#pragma unroll
        for (int j = 0; j < S::kTilesN / 2; ++j) {
          mma_16816(acc[i][2 * j], af, bdy[j][0], bdy[j][1]);
          mma_16816(acc[i][2 * j + 1], af, bdy[j][2], bdy[j][3]);
        }
      }
    }
    if (threadIdx.x < S::kNs) {
#pragma unroll 8
      for (int r = 0; r < S::kRows; ++r)
        db_acc += __bfloat162float(dy_s[r * S::kNStride + threadIdx.x]);
    }
  }

  float* dw = w_part + static_cast<size_t>(blockIdx.y) * (static_cast<size_t>(K) * n + n);
  float* db = dw + static_cast<size_t>(K) * n;
#pragma unroll
  for (int i = 0; i < S::kM; ++i) {
    const int k0 = (warp * S::kM + i) * 16 + g;
#pragma unroll
    for (int j = 0; j < S::kTilesN; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(dw + static_cast<size_t>(k0) * n + col) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(dw + static_cast<size_t>(k0 + 8) * n + col) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
  if (threadIdx.x < S::kNs) db[n0 + threadIdx.x] = db_acc;
}

}  // namespace mlp
