// Row-tiled dense-layer kernels, bf16: one GEMM with its cheap neighbours
// (LayerNorm in front, bias and residual sum behind) forward, and the three
// gradients of a dense layer from one op backward.
//
// Replaces five TPU kernels at width 768 (at 384 the entry points below
// dispatch K7, K9d, K9a and K9b by their input width and K9c by its output
// width to the Hopper kernels of dense_sm90.cu and ln_gemm_sm90.cu):
//   tpuwsi/ops/dense.py:51  `_dense_bwd_kernel`     (pallas_call at :87)
//       dx = dy . W^T, dW = x^T . dy, db = sum dy
//   tpuwsi/ops/mlp.py:832   `_ln_gemm_fwd_kernel`   (pallas_call at :904)
//       y = bf16(LN(x)) . W + b
//   tpuwsi/ops/mlp.py:850   `_ln_gemm_bwd_kernel`   (pallas_call at :928)
//       dln = dy . W^T, dW = bf16(LN(x))^T . dy, db = sum dy, LayerNorm
//       backward: dx, dgamma = sum dln * xhat, dbeta = sum dln
//   tpuwsi/ops/mlp.py:1079  `_gemm_res_fwd_kernel`  (pallas_call at :1124)
//       y = res + bf16(a . W + b)
//   tpuwsi/ops/mlp.py:1092  `_gemm_res_bwd_kernel`  (pallas_call at :1146)
//       da = dy . W^T, dW = a^T . dy, db = sum dy
// The layer is A (rows, K) . W (K, N): K, the input width, is 384 or 768 and a
// template parameter; N, the output width, is a multiple of 64 given at run
// time. Same arithmetic as the TPU kernels: every product accumulates in
// fp32; LayerNorm runs in fp32 with the fast variance E[x^2] - mean^2 clamped
// at 0 and its output is rounded to bf16 before the product; the bias is
// added in fp32; the residual sum is bf16(res + bf16(a . W + b)); dx is bf16;
// every parameter gradient is fp32 and summed over ALL rows. Rows past the
// end read as zeros, in A and in dy, and are never written.
//
// What bounds them on an H100. At the DINO step's student global views with
// the qkv layer, (rows, K, N) = (37,824, 384, 1,152): the backward reads x
// and dy and writes dx (145 MB) beside 3 MB of weights and gradients: 0.044
// ms at 3.35 TB/s; two products are 4 rows K N = 67 GFLOP: 0.068 ms at the
// dense bf16 peak. The forward moves 117 MB (0.035 ms) for 33 GFLOP (0.034
// ms). With the proj layer (N = 384) both are bound by bytes. So these
// kernels sit near the ridge: a version that reaches either peak reaches
// both.
//
// What this design does about it. The TPU kernels hold W whole in VMEM beside
// a 512-row (backward: 256-row) tile, and carry dW (1.77 MB fp32 for qkv) in
// VMEM scratch across a SEQUENTIAL row grid. A Hopper block has 227 KB and
// blocks run in no order, so, as in mlp_bwd.cu:
//   - `row_gemm_fwd_kernel`, one block per row tile (64 rows; 32 at K = 768):
//     the tile (LN(x) for the LN+GEMM) stays in shared memory as the A
//     operand; W streams from L2 in chunks of 64 (32) output columns through
//     two buffers, the next chunk landing under this chunk's product; a warp
//     owns 16 rows x a quarter of the chunk and writes its piece of y from
//     registers, with bias (and residual sum) applied there;
//   - `dense_bwd_dx_kernel` (in dense_common.cuh, as the next one, which
//     attn_block.cu launches too), one block per row tile: dx = dy . W^T with the
//     tile's (rows, K) accumulator in registers (16 x K/4 fp32 a warp) while
//     dy[:, chunk] and W[:, chunk] stream through two buffers each. For the
//     LN+GEMM it first normalises its rows (keeping mean and 1/sigma, and
//     leaving bf16 LN(x) in a (rows, K) workspace for the next kernel) and
//     ends with the LayerNorm backward of mlp_common.cuh, which also gives
//     dgamma and dbeta per row tile;
//   - `dense_bwd_dw_kernel`, a 2-D grid of (slice of 64 output columns; 32 at
//     K = 768) x (group of row tiles): the block keeps dW[:, slice] in
//     registers (64 fp32 a thread over 12 warps; 48 over 16) and walks its
//     rows 64 (32) at a time through two buffers, adding A^T . dy; db is the
//     column sum of the same dy tiles. One partial per row group;
//   - `sum_partials_kernel` adds the partials in a fixed order.
// Every output element has one writer and there are no atomics: two launches
// on the same inputs give the same bits. Unlike the MLP backward nothing has
// to be rebuilt for the weight gradient, so each of the two products is done
// once. The price of the split is that dy is read twice (by the dx and by the
// dW kernel), and that each slice block streams its row group's A from L2:
// N / 64 times 29 MB at this shape.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include "dense_common.cuh"
#include "dense_sm90.cuh"

namespace {

using namespace mlp;

// ---------------------------------------------------------------------------
// forward: y = A . W + b  [+ res], A = LN(x) or a
// ---------------------------------------------------------------------------

template <int K>
constexpr int fwd_smem_bytes() {
  using T = Tile<K>;
  return 2 * (T::kRows * T::kXStride + 2 * K * T::kFStride);
}

// kLn: `a` is x and A = bf16(LN(x)); else A = a and `res` (rows, n) is added
// to the rounded product.
template <int K, bool kLn>
__global__ void __launch_bounds__(Tile<K>::kThreads, 1)
row_gemm_fwd_kernel(const __nv_bfloat16* __restrict__ a, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                    __nv_bfloat16* __restrict__ y, int rows, int n, float eps) {
  using T = Tile<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kXStride]
  __nv_bfloat16* w_bufs = a_s + T::kRows * T::kXStride;             // [2][K][kFStride]

  const int row0 = blockIdx.x * T::kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / T::kColGroups, cg = warp % T::kColGroups;
  const Lane L(lane);
  const int n_chunks = n / T::kFc;

  auto stage_w = [&](int c) {
    stage_rows(w_bufs + (c & 1) * K * T::kFStride, T::kFStride, w + c * T::kFc, n, 0, K, K,
               T::kFc);
    cp_async_commit();
  };
  if constexpr (!kLn) stage_rows(a_s, T::kXStride, a, K, row0, rows, T::kRows, K);
  stage_w(0);  // one group with the rows of a
  if constexpr (kLn) {
    for (int r = warp; r < T::kRows; r += T::kWarps) {
      const int row = row0 + r;
      float mean, inv;
      layer_norm_row<K>(row < rows ? a + static_cast<size_t>(row) * K : nullptr, gamma, beta, eps,
                        a_s + r * T::kXStride, nullptr, lane, &mean, &inv);
    }
  }

  const int row_a = row0 + rg * 16 + g, row_b = row_a + 8;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();  // this chunk (and the rows of a)
    __syncthreads();     // ... are whole; nobody reads the other buffer any more
    if (c + 1 < n_chunks) stage_w(c + 1);

    // this warp's 16 rows x kN1 n-tiles of the chunk, over all of K
    float u[T::kN1][4];
#pragma unroll
    for (int nt = 0; nt < T::kN1; ++nt) u[nt][0] = u[nt][1] = u[nt][2] = u[nt][3] = 0.f;
    const __nv_bfloat16* aa = a_s + rg * 16 * T::kXStride;
    const __nv_bfloat16* wb = w_bufs + (c & 1) * K * T::kFStride + cg * (T::kN1 * 8);
#pragma unroll 4
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, L.a_rows(aa + kk * 16, T::kXStride));
      if constexpr (T::kN1 == 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, L.b_kn(wb + kk * 16 * T::kFStride, T::kFStride));
        mma_16816(u[0], af, b[0], b[1]);
        mma_16816(u[1], af, b[2], b[3]);
      } else {
        uint32_t b[2];
        ldmatrix_x2_trans(b, L.b_kn(wb + kk * 16 * T::kFStride, T::kFStride));
        mma_16816(u[0], af, b[0], b[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < T::kN1; ++nt) {
      const int col = c * T::kFc + cg * (T::kN1 * 8) + nt * 8 + 2 * t;
      const float2 bv = unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + col));
      float ya0 = u[nt][0] + bv.x, ya1 = u[nt][1] + bv.y;
      float yb0 = u[nt][2] + bv.x, yb1 = u[nt][3] + bv.y;
      if (row_a < rows) {
        const size_t at = static_cast<size_t>(row_a) * n + col;
        if constexpr (!kLn) {  // the residual sum in bf16: bf16(res + bf16(y))
          const float2 rv = unpack_bf16(*reinterpret_cast<const uint32_t*>(res + at));
          ya0 = rv.x + round_bf16(ya0);
          ya1 = rv.y + round_bf16(ya1);
        }
        *reinterpret_cast<uint32_t*>(y + at) = pack_bf16(ya0, ya1);
      }
      if (row_b < rows) {
        const size_t at = static_cast<size_t>(row_b) * n + col;
        if constexpr (!kLn) {
          const float2 rv = unpack_bf16(*reinterpret_cast<const uint32_t*>(res + at));
          yb0 = rv.x + round_bf16(yb0);
          yb1 = rv.y + round_bf16(yb1);
        }
        *reinterpret_cast<uint32_t*>(y + at) = pack_bf16(yb0, yb1);
      }
    }
  }
}

template <int K, bool kLn>
int launch_fwd(const void* a, const void* gamma, const void* beta, const void* w, const void* bias,
               const void* res, void* y, int rows, int n, float eps, void* stream) {
  using T = Tile<K>;
  auto kernel = row_gemm_fwd_kernel<K, kLn>;
  constexpr int kSmem = fwd_smem_bytes<K>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(rows + T::kRows - 1) / T::kRows, T::kThreads, kSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(y), rows, n, eps);
  return static_cast<int>(cudaGetLastError());
}

// grads (out): dW (K, n) | db (n,) [| dgamma (K,) | dbeta (K,)] fp32.
template <int K, bool kLn>
int launch_bwd(const void* x, const void* dy, const void* gamma, const void* beta, const void* w,
               void* dx, void* grads, void* w_part, void* row_part, void* ln_work, int rows,
               int n, int groups, float eps, void* stream_) {
  using T = Tile<K>;
  using S = DwSlice<K>;
  const int n_row_tiles = (rows + T::kRows - 1) / T::kRows;
  if (groups < 1 || groups > (rows + S::kRows - 1) / S::kRows || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* dyp = static_cast<const __nv_bfloat16*>(dy);

  auto dx_kernel = dense_bwd_dx_kernel<K, kLn>;
  constexpr int kDxSmem = dx_smem_bytes<K>();
  cudaError_t err =
      cudaFuncSetAttribute(dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dx_kernel<<<n_row_tiles, T::kThreads, kDxSmem, stream>>>(
      xp, dyp, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const __nv_bfloat16*>(w), nullptr, static_cast<__nv_bfloat16*>(dx),
      static_cast<__nv_bfloat16*>(ln_work), static_cast<float*>(row_part), rows, n, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dw_kernel = dense_bwd_dw_kernel<K>;
  constexpr int kDwSmem = S::smem_bytes();
  err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<<<dim3(n / S::kNs, groups), S::kThreads, kDwSmem, stream>>>(
      kLn ? static_cast<const __nv_bfloat16*>(ln_work) : xp, dyp, static_cast<float*>(w_part),
      rows, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n_w = static_cast<long long>(K) * n + n;
  float* out = static_cast<float*>(grads);
  sum_partials_kernel<float><<<static_cast<unsigned>((n_w + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(w_part), out, groups, n_w);
  if constexpr (kLn)
    sum_partials_kernel<float><<<(2 * K + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(row_part), out + n_w, n_row_tiles, 2LL * K);
  return static_cast<int>(cudaGetLastError());
}

bool widths_ok(int rows, int k, int n) {
  return rows >= 1 && (k == 384 || k == 768) && n >= 64 && n % 64 == 0;
}


// The three gradients of a dense layer with input width k, K7's and K9d's:
// at 384 dense_sm90.cu's kernels, which take W (k, n) (w_layout 0) or (n, k)
// (1); at 768 the row-tiled kernels, which read W as (k, n) only.
int dense_grads(const void* x, const void* dy, const void* w, int w_layout, void* dx, void* grads,
                void* w_part, int rows, int k, int n, int groups, void* stream) {
  if (!widths_ok(rows, k, n) || (w_layout != 0 && w_layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 384)
    return dense_sm90::bwd(x, dy, w, w_layout, dx, grads, w_part, rows, n, groups,
                           static_cast<cudaStream_t>(stream));
  if (w_layout != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<768, false>(x, dy, nullptr, nullptr, w, dx, grads, w_part, nullptr, nullptr,
                                rows, n, groups, 0.f, stream);
}

}  // namespace

extern "C" {

// Rows per step and output columns per block of the weight-gradient grid for
// input width k (0 for a width that is not built). The number of row groups
// may not exceed ceil(rows / rows_per_step). At 384 every weight gradient is
// dense_sm90.cuh's kernel (K7, K9d, K9b and K8b's tails), whose grid
// attn_block.cu reads as DwSlice<384>'s.
static_assert(DwSlice<384>::kRows == dense_sm90::kTile && DwSlice<384>::kNs == dense_sm90::kTile,
              "one weight-gradient grid at input width 384");

int tpuwsi_dense_rows_per_step(int k) {
  if (k == 384) return dense_sm90::kTile;
  if (k == 768) return DwSlice<768>::kRows;
  return 0;
}

int tpuwsi_dense_cols_per_slice(int k) {
  if (k == 384) return dense_sm90::kTile;
  if (k == 768) return DwSlice<768>::kNs;
  return 0;
}

// Every tensor is contiguous and 16-byte aligned (fp32 vectors 8-byte), bf16
// unless said otherwise.
//
// Gradients of y = x . w + b. x, dx: (rows, d); dy: (rows, n); w: (d, n)
// with w_layout 0, or nn.Linear's (n, d) with w_layout 1 (at d = 384 only: the
// caller makes a (d, n) copy for d = 768); d is 384 or 768, n is d or 3 d.
// grads (out): d n + n fp32 = dW (d, n) | db. Workspace, fp32, contents
// undefined on entry: w_part (groups, d n + n), with 1 <= groups <= ceil(rows
// / rows_per_step(d)) row groups.
int tpuwsi_dense_bwd(const void* x, const void* dy, const void* w, void* dx, void* grads,
                     void* w_part, int rows, int d, int n, int groups, int w_layout,
                     void* stream) {
  if (n != d && n != 3 * d) return static_cast<int>(cudaErrorInvalidValue);
  return dense_grads(x, dy, w, w_layout, dx, grads, w_part, rows, d, n, groups, stream);
}

// Gradients of y = res + a . w + b but for d(res) = dy. a, da: (rows, f);
// dy: (rows, d); w: (f, d); f and d are 384 or 768. grads: f d + d fp32 =
// dW (f, d) | db. w_part as above with (f, d) for (d, n).
int tpuwsi_gemm_res_bwd(const void* a, const void* dy, const void* w, void* da, void* grads,
                        void* w_part, int rows, int f, int d, int groups, void* stream) {
  if (d != 384 && d != 768) return static_cast<int>(cudaErrorInvalidValue);
  return dense_grads(a, dy, w, 0, da, grads, w_part, rows, f, d, groups, stream);
}

// y = LN(x) . w + b. x: (rows, d); gamma, beta: (d,) fp32; w: (d, f) with
// w_layout 0, or nn.Linear's (f, d) with w_layout 1 (at d = 384 only: the
// caller makes a (d, f) copy for d = 768); b: (f,); y: (rows, f); d is 384
// or 768, f a multiple of 64. d = 384 runs ln_gemm_sm90.cu's kernel (K9a).
int tpuwsi_ln_gemm_fwd(const void* x, const void* gamma, const void* beta, const void* w,
                       const void* b, void* y, int rows, int d, int f, float eps, int w_layout,
                       void* stream) {
  if (!widths_ok(rows, d, f) || (w_layout != 0 && w_layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 384)
    return dense_sm90::ln_gemm_fwd(x, gamma, beta, w, w_layout, b, y, rows, f, eps,
                                   static_cast<cudaStream_t>(stream));
  if (w_layout != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd<768, true>(x, gamma, beta, w, b, nullptr, y, rows, f, eps, stream);
}

// Gradients of the above. dy: (rows, f); dx: (rows, d). grads: d f + f + 2 d
// fp32 = dW (d, f) | db | dgamma | dbeta. Workspaces: w_part (groups, d f + f)
// and row_part (n_row_tiles, 2 d) fp32, with n_row_tiles = ceil(rows /
// tpuwsi_mlp_rows_per_tile(d)) and 1 <= groups <= ceil(rows /
// tpuwsi_dense_rows_per_step(d)); ln_work (rows, d) bf16 takes LN(x) from the
// first kernel to the weight gradient's. d = 384 runs ln_gemm_sm90.cu's
// launches (K9b).
int tpuwsi_ln_gemm_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
                       const void* w, void* dx, void* grads, void* w_part, void* row_part,
                       void* ln_work, int rows, int d, int f, int groups, float eps, int w_layout,
                       void* stream) {
  if (!widths_ok(rows, d, f) || (w_layout != 0 && w_layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 384)
    return dense_sm90::ln_gemm_bwd(x, dy, gamma, beta, w, w_layout, dx, grads, w_part, row_part,
                                   ln_work, rows, f, groups, eps,
                                   static_cast<cudaStream_t>(stream));
  if (w_layout != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<768, true>(x, dy, gamma, beta, w, dx, grads, w_part, row_part, ln_work, rows,
                               f, groups, eps, stream);
}

// y = res + bf16(a . w + b). res, y: (rows, d); a: (rows, f); w: (f, d);
// b: (d,); f and d are 384 or 768. d = 384 runs dense_sm90.cu's row kernel.
int tpuwsi_gemm_res_fwd(const void* res, const void* a, const void* w, const void* b, void* y,
                        int rows, int f, int d, void* stream) {
  if (d == 384) return dense_sm90::gemm_res_fwd(res, a, w, b, y, rows, f,
                                                static_cast<cudaStream_t>(stream));
  if (d != 768 || !widths_ok(rows, f, d)) return static_cast<int>(cudaErrorInvalidValue);
  return f == 384 ? launch_fwd<384, false>(a, nullptr, nullptr, w, b, res, y, rows, d, 0.f, stream)
                  : launch_fwd<768, false>(a, nullptr, nullptr, w, b, res, y, rows, d, 0.f, stream);
}

}  // extern "C"
