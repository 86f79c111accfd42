// Fused transformer MLP forward, bf16: the hidden activation never reaches
// device memory.
//
// Replaces two TPU kernels of tpuwsi/ops/mlp.py:
//   kBlock = false  :83  `_mlp_fwd_kernel`        (pallas_call at :160)
//       y = gelu(x . W1 + b1) . W2 + b2
//       (at D = 768 only: D = 384 takes the Hopper kernel of mlp_sm90.cu)
//   kBlock = true   :485 `_mlp_block_fwd_kernel`  (pallas_call at :584)
//       y = x + (gelu(LN(x) . W1 + b1) . W2 + b2)
//       (at D = 768 only: D = 384 takes the Hopper kernel of mlp_sm90.cu)
// x, y: (rows, D) bf16; W1: (D, F), W2: (F, D), b1: (F,), b2: (D,) bf16;
// gamma, beta: (D,) fp32. Same arithmetic as the TPU kernels: both products
// accumulate in fp32, the biases are added in fp32, h = gelu(u) (tanh or erf
// form) is rounded to bf16 before the second product, y is rounded to bf16
// once; LayerNorm runs in fp32 with the fast variance E[x^2] - mean^2 clamped
// at 0 and its output is rounded to bf16 before the first product; the
// residual sum is bf16(x + bf16(y)). Rows past the end are read as zeros and
// never written.
//
// What bounds it on an H100. At the DINO step's student global views (rows =
// 37,824, D = 384, F = 1,536) the kernel must move x and y (58 MB) and the
// weights (2.4 MB): 0.018 ms at 3.35 TB/s; the two products are 4 rows D F =
// 89 GFLOP: 0.090 ms at the dense bf16 peak. An ideal kernel is bound by the
// tensor cores, five to one. The unfused route writes and reads the (rows, F)
// hidden state (232 MB for h alone) and so sits near both limits at once.
//
// What this design does about it. The TPU kernel holds W1 and W2 whole in
// VMEM beside a 512-row tile; a Hopper block has 227 KB, so:
//   - a block owns 64 rows (32 at D = 768), kept in shared memory for the
//     whole block as the A operand of the first product (LN(x) when kBlock);
//   - the hidden dimension is walked in chunks of 64 (32): W1[:, chunk] and
//     W2[chunk, :] stream from L2 through shared memory with cp.async, and
//     each lands while the other product runs (the W1 chunk is free once u
//     is built, the W2 chunk once y has taken it), so one buffer each does;
//   - 16 warps (8): 4 (2) row groups of 16 rows x 4 column groups. A warp
//     builds its 16 x 16 (16 x 8) piece of u over all of D, applies bias and
//     GELU in registers and writes bf16 h to a shared tile; after a barrier
//     it multiplies its row group's h by its quarter of W2's columns into
//     16 x D/4 fp32 accumulators, which live in registers across the chunks
//     (48 registers at D = 384, 96 at D = 768): splitting D over four warps
//     is what keeps the accumulator of a row tile inside the register file;
//   - W1 and W2 (2.36 MB) are read from L2 once per 64 rows: 1.4 GB of L2
//     traffic at this shape, which no kernel with 64-row tiles can go below;
//     the fp32 accumulator of a row tile (64 x 384 x 4 bytes = 96 KB of the
//     SM's 256 KB of registers) is what keeps the tile at 64 rows. What holds
//     this version back first is shared-memory bandwidth: the first product
//     takes one ldmatrix.x4 per mma. wgmma (operands read from shared memory
//     once per 64 rows by the hardware) and weight chunks shared across a
//     cluster of blocks would cut both; this version is the simple one.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include "mlp_common.cuh"

namespace mlp_sm90 {
int fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* y,
        int rows, int f, int approx, cudaStream_t stream);
int block_fwd(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
              const void* w2, const void* b2, void* y, int rows, int f, float eps, int approx,
              cudaStream_t stream);
}

namespace {

using namespace mlp;

template <int D>
constexpr int fwd_smem_bytes() {
  using T = Tile<D>;
  return 2 * (T::kRows * T::kXStride + D * T::kFStride + T::kFc * T::kXStride +
              T::kRows * T::kFStride);
}

// Fragment ownership (PTX ISA, mma.m16n8k16): lane = 4*g + t. A thread holds
// rows g and g+8 of the 16-row tile; of an 8-column accumulator tile it holds
// columns 2t and 2t+1 (regs 0,1 for row g; regs 2,3 for row g+8).
template <int D, bool kBlock>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
mlp_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1,
               const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
               const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ y, int rows,
               int f, float eps, int approx) {
  using T = Tile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kXStride]
  __nv_bfloat16* w1_s = x_s + T::kRows * T::kXStride;               // [D][kFStride]
  __nv_bfloat16* w2_s = w1_s + D * T::kFStride;                     // [kFc][kXStride]
  __nv_bfloat16* h_s = w2_s + T::kFc * T::kXStride;                 // [kRows][kFStride]

  const int row0 = blockIdx.x * T::kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / T::kColGroups, cg = warp % T::kColGroups;
  const Lane L(lane);
  const int n_chunks = f / T::kFc;

  if constexpr (!kBlock) {
    stage_rows(x_s, T::kXStride, x, D, row0, rows, T::kRows, D);
    cp_async_commit();
  }
  stage_rows(w1_s, T::kFStride, w1, f, 0, D, D, T::kFc);
  cp_async_commit();
  stage_rows(w2_s, T::kXStride, w2, D, 0, T::kFc, T::kFc, D);
  cp_async_commit();
  if constexpr (kBlock) {
    for (int r = warp; r < T::kRows; r += T::kWarps) {
      const int row = row0 + r;
      float mean, inv;
      layer_norm_row<D>(row < rows ? x + static_cast<size_t>(row) * D : nullptr, gamma, beta,
                        eps, x_s + r * T::kXStride, nullptr, lane, &mean, &inv);
    }
  }

  constexpr int kNOut = T::kColsPerWarp / 8;
  float acc[kNOut][4];
#pragma unroll
  for (int nt = 0; nt < kNOut; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();  // x and this chunk of W1 have landed; W2's may be in flight
    __syncthreads();

    // u = x . W1[:, chunk]: this warp's 16 rows x kN1 n-tiles, over all of D
    float u[T::kN1][4];
#pragma unroll
    for (int nt = 0; nt < T::kN1; ++nt) u[nt][0] = u[nt][1] = u[nt][2] = u[nt][3] = 0.f;
    const __nv_bfloat16* xa = x_s + rg * 16 * T::kXStride;
    const __nv_bfloat16* wb = w1_s + cg * (T::kN1 * 8);
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, L.a_rows(xa + kk * 16, T::kXStride));
      if constexpr (T::kN1 == 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, L.b_kn(wb + kk * 16 * T::kFStride, T::kFStride));
        mma_16816(u[0], a, b[0], b[1]);
        mma_16816(u[1], a, b[2], b[3]);
      } else {
        uint32_t b[2];
        ldmatrix_x2_trans(b, L.b_kn(wb + kk * 16 * T::kFStride, T::kFStride));
        mma_16816(u[0], a, b[0], b[1]);
      }
    }
    // h = bf16(gelu(u + b1)) -> shared memory
#pragma unroll
    for (int nt = 0; nt < T::kN1; ++nt) {
      const int col = cg * (T::kN1 * 8) + nt * 8 + 2 * t;
      const float2 bias =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(b1 + c * T::kFc + col));
      __nv_bfloat16* dst = h_s + (rg * 16 + g) * T::kFStride + col;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(gelu(u[nt][0] + bias.x, approx), gelu(u[nt][1] + bias.y, approx));
      *reinterpret_cast<uint32_t*>(dst + 8 * T::kFStride) =
          pack_bf16(gelu(u[nt][2] + bias.x, approx), gelu(u[nt][3] + bias.y, approx));
    }
    cp_async_wait<0>();  // this chunk of W2
    __syncthreads();     // h is whole; nobody reads the W1 chunk any more
    if (c + 1 < n_chunks) {
      stage_rows(w1_s, T::kFStride, w1 + (c + 1) * T::kFc, f, 0, D, D, T::kFc);
      cp_async_commit();
    }

    // acc += h . W2[chunk, :]: this warp's 16 rows x its quarter of D
    const __nv_bfloat16* ha = h_s + rg * 16 * T::kFStride;
#pragma unroll
    for (int kk = 0; kk < T::kFc / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, L.a_rows(ha + kk * 16, T::kFStride));
      const __nv_bfloat16* wrow = w2_s + kk * 16 * T::kXStride + cg * T::kColsPerWarp;
#pragma unroll
      for (int nt = 0; nt < kNOut; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, L.b_kn(wrow + nt * 8, T::kXStride));
        mma_16816(acc[nt], a, b[0], b[1]);
        mma_16816(acc[nt + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next copies overwrite the W2 chunk, the next h this one
    if (c + 1 < n_chunks) {
      stage_rows(w2_s, T::kXStride, w2 + static_cast<size_t>(c + 1) * T::kFc * D, D, 0, T::kFc,
                 T::kFc, D);
      cp_async_commit();
    }
  }

  const int row_a = row0 + rg * 16 + g, row_b = row_a + 8;
#pragma unroll
  for (int nt = 0; nt < kNOut; ++nt) {
    const int col = cg * T::kColsPerWarp + nt * 8 + 2 * t;
    const float2 bias = unpack_bf16(*reinterpret_cast<const uint32_t*>(b2 + col));
    float ya0 = acc[nt][0] + bias.x, ya1 = acc[nt][1] + bias.y;
    float yb0 = acc[nt][2] + bias.x, yb1 = acc[nt][3] + bias.y;
    if (row_a < rows) {
      const size_t at = static_cast<size_t>(row_a) * D + col;
      if constexpr (kBlock) {  // the residual sum in bf16: bf16(x + bf16(y))
        const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + at));
        ya0 = xv.x + round_bf16(ya0);
        ya1 = xv.y + round_bf16(ya1);
      }
      *reinterpret_cast<uint32_t*>(y + at) = pack_bf16(ya0, ya1);
    }
    if (row_b < rows) {
      const size_t at = static_cast<size_t>(row_b) * D + col;
      if constexpr (kBlock) {
        const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + at));
        yb0 = xv.x + round_bf16(yb0);
        yb1 = xv.y + round_bf16(yb1);
      }
      *reinterpret_cast<uint32_t*>(y + at) = pack_bf16(yb0, yb1);
    }
  }
}

template <int D, bool kBlock>
int launch(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
           const void* w2, const void* b2, void* y, int rows, int f, float eps, int approx,
           void* stream) {
  using T = Tile<D>;
  auto kernel = mlp_fwd_kernel<D, kBlock>;
  constexpr int kSmem = fwd_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + T::kRows - 1) / T::kRows;
  kernel<<<blocks, T::kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y), rows, f, eps,
      approx);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlock>
int dispatch(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
             const void* w2, const void* b2, void* y, int rows, int d, int f, float eps,
             int approx, void* stream) {
  if (rows < 1 || f < 64 || f % 64) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 384) {  // K5f, K6f: the Hopper kernels of mlp_sm90.cu
    const auto s = static_cast<cudaStream_t>(stream);
    if constexpr (kBlock)
      return mlp_sm90::block_fwd(x, gamma, beta, w1, b1, w2, b2, y, rows, f, eps, approx, s);
    else
      return mlp_sm90::fwd(x, w1, b1, w2, b2, y, rows, f, approx, s);
  }
  if (d == 768)
    return launch<768, kBlock>(x, gamma, beta, w1, b1, w2, b2, y, rows, f, eps, approx, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x, y: (rows, d) bf16; w1: (d, f), b1: (f,), w2: (f, d), b2: (d,) bf16, all
// contiguous and 16-byte aligned; d is 384 or 768, f a multiple of 64;
// approx: 1 for the tanh GELU, 0 for erf.
int tpuwsi_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   void* y, int rows, int d, int f, int approx, void* stream) {
  return dispatch<false>(x, nullptr, nullptr, w1, b1, w2, b2, y, rows, d, f, 0.f, approx,
                         stream);
}

// As above with LayerNorm in front and the residual sum behind; gamma, beta:
// (d,) fp32, 8-byte aligned.
int tpuwsi_mlp_block_fwd(const void* x, const void* gamma, const void* beta, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* y, int rows,
                         int d, int f, float eps, int approx, void* stream) {
  return dispatch<true>(x, gamma, beta, w1, b1, w2, b2, y, rows, d, f, eps, approx, stream);
}

}  // extern "C"
