// Shared device code of the row-tiled GEMM kernels (mlp_fwd.cu, mlp_bwd.cu,
// dense.cu, attn_block.cu): tile sizes by embedding width, mma.sync / ldmatrix / cp.async
// helpers, the two GELU forms with their derivatives, the LayerNorm of one
// row, the LayerNorm backward of a row tile, and the fixed-order sum of
// partial results.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

constexpr int kPad = 8;  // bf16 appended to every shared-memory row: 16 bytes,
                         // so rows of 64k values start on odd multiples of 16
                         // bytes apart and ldmatrix meets no bank conflict

// Tile sizes by embedding width D. A block owns kRows rows of the flattened
// batch and walks the hidden dimension in chunks of kFc; its warps form
// kRows / 16 row groups of 16 rows times 4 column groups. D <= 384 (ViT-S)
// leaves room for 64 rows and chunks of 64; D = 768 (ViT-B) halves both so
// that the row tiles and two weight chunks fit 227 KB of shared memory.
template <int D>
struct Tile {
  static_assert(D % 64 == 0, "embedding width must be a multiple of 64");
  static constexpr int kRows = D <= 384 ? 64 : 32;
  static constexpr int kFc = D <= 384 ? 64 : 32;
  static constexpr int kColGroups = 4;
  static constexpr int kWarps = kRows / 16 * kColGroups;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kColsPerWarp = D / kColGroups;  // of a (rows, D) output
  static constexpr int kN1 = kFc / kColGroups / 8;     // n-tiles of a (rows, kFc) product
  static constexpr int kXStride = D + kPad;            // x, dy, W2-chunk rows
  static constexpr int kFStride = kFc + kPad;          // W1-chunk, h, du rows
};

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluA = 0.044715f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix: 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 (for .x2 the lanes 16-31 are ignored).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// Where a lane points ldmatrix, for a 16 x 16 window of a row-major tile in
// shared memory whose top-left element is `tile` (row stride in elements):
//   a_rows:   A fragment of tile[m][k]                      (plain)
//   a_cols:   A fragment of the transpose, tile[k][m]       (.trans)
//   b_kn:     B fragments of two n-tiles of tile[k][n]      (.trans)
//   b_nk:     B fragments of two n-tiles of tile[n][k]      (plain)
// The .x2 forms take the first n-tile of b_kn / b_nk with the same addresses.
struct Lane {
  int r8, lo, hi;  // lane % 8, bit 3 and bit 4 of the lane, as 0 or 8
  __device__ __forceinline__ explicit Lane(int lane)
      : r8(lane & 7), lo(((lane >> 3) & 1) * 8), hi((lane >> 4) * 8) {}
  __device__ __forceinline__ const __nv_bfloat16* a_rows(const __nv_bfloat16* tile,
                                                         int stride) const {
    return tile + (r8 + lo) * stride + hi;
  }
  __device__ __forceinline__ const __nv_bfloat16* a_cols(const __nv_bfloat16* tile,
                                                         int stride) const {
    return tile + (r8 + hi) * stride + lo;
  }
  __device__ __forceinline__ const __nv_bfloat16* b_kn(const __nv_bfloat16* tile,
                                                       int stride) const {
    return tile + (r8 + lo) * stride + hi;
  }
  __device__ __forceinline__ const __nv_bfloat16* b_nk(const __nv_bfloat16* tile,
                                                       int stride) const {
    return tile + (r8 + hi) * stride + lo;
  }
};

// 16 bytes from device to shared memory without passing through registers;
// with !valid nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// `n_rows` rows of `n_cols` bf16 (a multiple of 8) from src (row stride
// src_stride, first row row0) into a shared-memory tile (row stride
// dst_stride), asynchronously; rows at or past `limit` become zero.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int dst_stride,
                                           const __nv_bfloat16* src, long long src_stride,
                                           int row0, int limit, int n_rows, int n_cols) {
  const int per_row = n_cols / 8;
  for (int idx = threadIdx.x; idx < n_rows * per_row; idx += blockDim.x) {
    const int r = idx / per_row, c = (idx % per_row) * 8;
    const bool ok = row0 + r < limit;
    cp_async_16(dst + r * dst_stride + c, src + (ok ? row0 + r : 0) * src_stride + c, ok);
  }
}

__device__ __forceinline__ float gelu(float u, bool approx) {
  if (approx) {
    const float t = tanhf(kSqrt2OverPi * (u + kGeluA * u * u * u));
    return 0.5f * u * (1.0f + t);
  }
  return u * 0.5f * (1.0f + erff(u * kInvSqrt2));
}

// gelu(u) and its derivative.
__device__ __forceinline__ float gelu_and_grad(float u, bool approx, float* dg) {
  if (approx) {
    const float t = tanhf(kSqrt2OverPi * (u + kGeluA * u * u * u));
    *dg = 0.5f * (1.0f + t) +
          0.5f * u * (1.0f - t * t) * kSqrt2OverPi * (1.0f + 3.0f * kGeluA * u * u);
    return 0.5f * u * (1.0f + t);
  }
  const float phi = 0.5f * (1.0f + erff(u * kInvSqrt2));
  const float pdf = expf(-0.5f * u * u) * kInvSqrt2Pi;
  *dg = phi + u * pdf;
  return u * phi;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// LayerNorm of one row by one warp, fp32, with the fast variance
// E[x^2] - mean^2 clamped at 0: the row (zeros when `x_row` is null) is
// normalised, scaled and shifted, rounded to bf16 and stored to `dst`
// (shared memory) and to `copy` (device memory), each where it is not null;
// mean and 1 / sqrt(var + eps) come back for the backward.
template <int D>
__device__ __forceinline__ void layer_norm_row(const __nv_bfloat16* x_row,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta, float eps,
                                               __nv_bfloat16* dst, __nv_bfloat16* copy,
                                               int lane, float* mean_out, float* inv_out) {
  constexpr int kPairs = D / 64;  // bf16 pairs per lane
  float2 v[kPairs];
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    uint32_t raw = 0u;
    if (x_row != nullptr) raw = *reinterpret_cast<const uint32_t*>(x_row + 2 * lane + 64 * j);
    v[j] = unpack_bf16(raw);
    sum += v[j].x + v[j].y;
    sumsq += v[j].x * v[j].x + v[j].y * v[j].y;
  }
  const float mean = warp_sum(sum) * (1.0f / D);
  const float var = warp_sum(sumsq) * (1.0f / D) - mean * mean;
  const float inv = rsqrtf(fmaxf(var, 0.f) + eps);
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int col = 2 * lane + 64 * j;
    const float2 g = *reinterpret_cast<const float2*>(gamma + col);
    const float2 b = *reinterpret_cast<const float2*>(beta + col);
    const uint32_t ln =
        pack_bf16((v[j].x - mean) * inv * g.x + b.x, (v[j].y - mean) * inv * g.y + b.y);
    if (dst != nullptr) *reinterpret_cast<uint32_t*>(dst + col) = ln;
    if (copy != nullptr) *reinterpret_cast<uint32_t*>(copy + col) = ln;
  }
  *mean_out = mean;
  *inv_out = inv;
}

// LayerNorm backward of one row tile, by all threads of a block in Tile<D>'s
// warp layout (kRows / 16 row groups x 4 column groups). `acc` holds dln, the
// gradient at LayerNorm's output, as the fp32 accumulators of the block's
// (kRows, D) product: warp (rg, cg) owns rows rg * 16 .. + 15 and columns
// cg * D / 4 .. of it. With xhat = (x - mean) * inv and dxhat = dln * gamma:
//   dx = [dy +] inv * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//   dgamma = sum over the tile's rows of dln * xhat, dbeta = that of dln
// dx goes to device memory as bf16 (rows at or past `rows` are not written),
// dgamma to part[0 .. D) and dbeta to part[D .. 2 D). With kResidual, dy is
// added from `dy_s`, the tile's (kRows, D + kPad) copy in shared memory. x is
// read from device memory; mean_s, inv_s: (kRows,) in shared memory. row_red
// (kRows * 8 floats) and col_red (kRows / 16 * 2 * D floats) are scratch in
// shared memory that nobody else touches from this call on.
template <int D, bool kResidual>
__device__ __forceinline__ void layer_norm_backward_tile(
    const float (&acc)[D / 32][4], const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ gamma, const float* mean_s, const float* inv_s,
    const __nv_bfloat16* dy_s, float* row_red, float* col_red, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ part, int row0, int rows) {
  using T = Tile<D>;
  constexpr int kNOut = T::kColsPerWarp / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / T::kColGroups, cg = warp % T::kColGroups;
  const int ra = rg * 16 + g, rb = ra + 8;  // this thread's rows within the tile
  const int row_a = row0 + ra, row_b = row0 + rb;
  const float mean_a = mean_s[ra], inv_a = inv_s[ra];
  const float mean_b = mean_s[rb], inv_b = inv_s[rb];
  float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
#pragma unroll
  for (int nt = 0; nt < kNOut; ++nt) {
    const int col = cg * T::kColsPerWarp + nt * 8 + 2 * t;
    const float2 gam = *reinterpret_cast<const float2*>(gamma + col);
    uint32_t xa_raw = 0u, xb_raw = 0u;
    if (row_a < rows)
      xa_raw = *reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(row_a) * D + col);
    if (row_b < rows)
      xb_raw = *reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(row_b) * D + col);
    const float2 xa = unpack_bf16(xa_raw), xb = unpack_bf16(xb_raw);
    const float ha0 = (xa.x - mean_a) * inv_a, ha1 = (xa.y - mean_a) * inv_a;
    const float hb0 = (xb.x - mean_b) * inv_b, hb1 = (xb.y - mean_b) * inv_b;
    const float da0 = acc[nt][0] * gam.x, da1 = acc[nt][1] * gam.y;
    const float db0 = acc[nt][2] * gam.x, db1v = acc[nt][3] * gam.y;
    s1a += da0 + da1;
    s2a += da0 * ha0 + da1 * ha1;
    s1b += db0 + db1v;
    s2b += db0 * hb0 + db1v * hb1;
    // dgamma, dbeta of this warp's 16 rows: sum over the eight g lanes
    float pg0 = acc[nt][0] * ha0 + acc[nt][2] * hb0, pg1 = acc[nt][1] * ha1 + acc[nt][3] * hb1;
    float pb0 = acc[nt][0] + acc[nt][2], pb1 = acc[nt][1] + acc[nt][3];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      pg0 += __shfl_xor_sync(0xffffffffu, pg0, off);
      pg1 += __shfl_xor_sync(0xffffffffu, pg1, off);
      pb0 += __shfl_xor_sync(0xffffffffu, pb0, off);
      pb1 += __shfl_xor_sync(0xffffffffu, pb1, off);
    }
    if (g == 0) {
      float* dst = col_red + rg * 2 * D + col;
      dst[0] = pg0;
      dst[1] = pg1;
      dst[D] = pb0;
      dst[D + 1] = pb1;
    }
  }
  // row sums over this warp's columns, then over the four column warps
  s1a += __shfl_xor_sync(0xffffffffu, s1a, 1);
  s1a += __shfl_xor_sync(0xffffffffu, s1a, 2);
  s2a += __shfl_xor_sync(0xffffffffu, s2a, 1);
  s2a += __shfl_xor_sync(0xffffffffu, s2a, 2);
  s1b += __shfl_xor_sync(0xffffffffu, s1b, 1);
  s1b += __shfl_xor_sync(0xffffffffu, s1b, 2);
  s2b += __shfl_xor_sync(0xffffffffu, s2b, 1);
  s2b += __shfl_xor_sync(0xffffffffu, s2b, 2);
  if (t == 0) {
    row_red[(ra * T::kColGroups + cg) * 2] = s1a;
    row_red[(ra * T::kColGroups + cg) * 2 + 1] = s2a;
    row_red[(rb * T::kColGroups + cg) * 2] = s1b;
    row_red[(rb * T::kColGroups + cg) * 2 + 1] = s2b;
  }
  __syncthreads();
  float m1a = 0.f, m2a = 0.f, m1b = 0.f, m2b = 0.f;
#pragma unroll
  for (int q = 0; q < T::kColGroups; ++q) {
    m1a += row_red[(ra * T::kColGroups + q) * 2];
    m2a += row_red[(ra * T::kColGroups + q) * 2 + 1];
    m1b += row_red[(rb * T::kColGroups + q) * 2];
    m2b += row_red[(rb * T::kColGroups + q) * 2 + 1];
  }
  m1a *= 1.0f / D;
  m2a *= 1.0f / D;
  m1b *= 1.0f / D;
  m2b *= 1.0f / D;
#pragma unroll
  for (int nt = 0; nt < kNOut; ++nt) {
    const int col = cg * T::kColsPerWarp + nt * 8 + 2 * t;
    const float2 gam = *reinterpret_cast<const float2*>(gamma + col);
    if (row_a < rows) {
      const size_t at = static_cast<size_t>(row_a) * D + col;
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + at));
      float2 dyv = make_float2(0.f, 0.f);
      if constexpr (kResidual)
        dyv = unpack_bf16(*reinterpret_cast<const uint32_t*>(dy_s + ra * T::kXStride + col));
      const float h0 = (xv.x - mean_a) * inv_a, h1 = (xv.y - mean_a) * inv_a;
      *reinterpret_cast<uint32_t*>(dx + at) =
          pack_bf16(dyv.x + inv_a * (acc[nt][0] * gam.x - m1a - h0 * m2a),
                    dyv.y + inv_a * (acc[nt][1] * gam.y - m1a - h1 * m2a));
    }
    if (row_b < rows) {
      const size_t at = static_cast<size_t>(row_b) * D + col;
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + at));
      float2 dyv = make_float2(0.f, 0.f);
      if constexpr (kResidual)
        dyv = unpack_bf16(*reinterpret_cast<const uint32_t*>(dy_s + rb * T::kXStride + col));
      const float h0 = (xv.x - mean_b) * inv_b, h1 = (xv.y - mean_b) * inv_b;
      *reinterpret_cast<uint32_t*>(dx + at) =
          pack_bf16(dyv.x + inv_b * (acc[nt][2] * gam.x - m1b - h0 * m2b),
                    dyv.y + inv_b * (acc[nt][3] * gam.y - m1b - h1 * m2b));
    }
  }
  for (int col = threadIdx.x; col < D; col += T::kThreads) {
    float dg = 0.f, db = 0.f;
#pragma unroll
    for (int q = 0; q < T::kRows / 16; ++q) {
      dg += col_red[q * 2 * D + col];
      db += col_red[q * 2 * D + D + col];
    }
    part[col] = dg;
    part[D + col] = db;
  }
}

// out[i] = part[0][i] + part[1][i] + ... in that order: the sum over the
// blocks that each wrote one partial result, the same bits on every run.
template <typename T>
__global__ void sum_partials_kernel(const T* __restrict__ part, T* __restrict__ out, int n_parts,
                                    long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s = 0;
  for (int p = 0; p < n_parts; ++p) s += part[p * n + i];
  out[i] = s;
}

}  // namespace mlp
