// Shared device code of the fused-MLP kernels (mlp_fwd.cu, mlp_bwd.cu):
// tile sizes by embedding width, mma.sync / ldmatrix / cp.async helpers, the
// two GELU forms with their derivatives, and the LayerNorm of one row.

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
// (shared memory) and, where `copy` is not null, there too (device memory);
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
    *reinterpret_cast<uint32_t*>(dst + col) = ln;
    if (copy != nullptr) *reinterpret_cast<uint32_t*>(copy + col) = ln;
  }
  *mean_out = mean;
  *inv_out = inv;
}

}  // namespace mlp
