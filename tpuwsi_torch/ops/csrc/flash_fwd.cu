// Tiled attention forward with an online softmax, bf16, any sequence length.
//
// Replaces two TPU kernels of tpuwsi/ops/attention.py (both reached through
// `_flash_forward`, :179, whose pallas_call is at :239):
//   kStats = false  :80  `_flash_kernel`
//   kStats = true   :148 `_flash_kernel_stats`  (also writes lse)
// Same contract, per (batch element b, head h), q (Sq, 64), k and v (Sk, 64):
//   s = (q . k^T) * scale         fp32; the scale multiplies the fp32 product
//   key j is valid iff j < min(kv_lengths[b], Sk); an invalid key has p = 0
//   per key tile:  m' = max(m, rowmax s),  p = exp(s - m') (0 where invalid),
//                  l = l exp(m - m') + rowsum p            (fp32 p)
//                  acc = acc exp(m - m') + bf16(p) . v     (unnormalised p)
//   o = acc / l  rounded to bf16, once at the end; a row with no valid key has
//   l = 0 and gives o = 0 and lse = 0; otherwise lse = m + log l (fp32).
// m starts at a finite -1e30, so no inf - inf arises; p of an invalid key is
// set to 0 rather than computed, because with every key of a row invalid
// exp(s - m') would be exp(0) = 1.
//
// The operands are addressed by element strides for batch, head and row (the
// 64 values of a row are contiguous), so the same kernel reads q, k, v as
// column blocks of a fused (B, N, 3D) qkv projection and writes o into
// (B, N, D), or takes contiguous (B, H, S, 64) tensors; nothing is transposed
// or padded in device memory.
//
// What bounds it on an H100. At the DINO step's global views with 448-px
// images (B = 192, H = 6, S = 785) the kernel must read q, k, v (347 MB) and
// write o (116 MB): 0.14 ms at 3.35 TB/s. The two products are
// 2 * 2 * B*H*S*S*64 = 182 GFLOP: 0.18 ms at the dense bf16 peak. So, unlike
// the whole-sequence kernels at 197-257 tokens, an ideal kernel here is bound
// by the tensor cores, narrowly; the B*H*S*S = 710 M exponentials weigh about
// as much on the special-function units.
//
// What this design does about it. The TPU kernel keeps m, l and acc in VMEM
// scratch across a sequential grid axis over key tiles; blocks on a GPU run
// in no order, so that axis becomes a loop inside the block:
//   - one block per (b, h, tile of 128 queries), 8 warps of 16 query rows; a
//     warp whose rows all lie past Sq only helps to stage tiles;
//   - K and V stream through shared memory in tiles of 64 keys, two buffers
//     filled with cp.async so the next tile loads while this one is used;
//     rows are padded to 72 bf16, free of bank conflicts for the 32-bit
//     fragment loads of K and the ldmatrix.trans loads of V; keys past Sk are
//     zero-filled by the copy, never read from device memory;
//   - K fragments come four 8x8 matrices at a time (ldmatrix) instead of two
//     32-bit loads per mma, and the softmax runs in base 2 (one multiply by
//     scale * log2 e per score, then ex2.approx), with the key mask applied
//     only in the one tile that holds the end of the keys;
//   - scores never leave registers (mma.sync m16n8k16, fp32 accumulate); the
//     accumulator layout of the score product is the A-operand layout of
//     p . V; m, l and the 16 x 64 fp32 accumulator of a warp stay in registers
//     for the whole key loop: one pass over the keys, so shared memory holds
//     two tiles whatever Sk is;
//   - key tiles past the valid length are skipped: they would change nothing;
//   - blocks of one (b, h) are neighbours in the grid, so its K and V are
//     read from device memory once and from L2 by the other query tiles.
// wgmma and TMA would raise the tensor-core rate further; this version runs
// mma.sync on eight independent warps.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kTileQ = kWarps * 16;      // query rows per block
constexpr int kTileK = 64;               // keys per shared-memory tile
constexpr int kStride = kHeadDim + 8;    // bf16 per K/V row in shared memory
constexpr float kNegInf = -1e30f;        // finite, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {  // in elements
  long long b, h, r;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed; lane i gives the
// address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8x8 bf16 matrices from shared memory as they lie; lane i gives the
// address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 2^x on the special-function unit; 0 for a large negative x.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + kTileK) of a 64-column matrix (row stride `stride`) ->
// a shared-memory tile, asynchronously; rows >= n become zero. n >= 1.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                           long long stride, int row0, int n) {
  for (int idx = threadIdx.x; idx < kTileK * (kHeadDim / 8); idx += blockDim.x) {
    const int j = idx >> 3, col = (idx & 7) * 8;
    const bool ok = row0 + j < n;
    cp_async_16(tile + j * kStride + col, src + (ok ? row0 + j : 0) * stride + col, ok);
  }
}

// Fragment ownership (PTX ISA, mma.m16n8k16): lane = 4*g + t. A thread holds
// rows g and g+8 of the 16-row tile; of an 8-column accumulator tile it holds
// columns 2t and 2t+1 (regs 0,1 for row g; regs 2,3 for row g+8).
template <bool kStats>
__global__ void __launch_bounds__(kWarps * 32, 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_lengths, int heads, int sq,
                 int sk, int q_tiles, Strides qs, Strides kvs, Strides os, float scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kTileK * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kTileK * kStride];

  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x % q_tiles;
  const int b = bh / heads, h = bh % heads;
  const __nv_bfloat16* q_src = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* k_src = k + b * kvs.b + h * kvs.h;
  const __nv_bfloat16* v_src = v + b * kvs.b + h * kvs.h;
  __nv_bfloat16* o_dst = o + b * os.b + h * os.h;

  int klen = sk;
  if (kv_lengths != nullptr) klen = min(max(kv_lengths[b], 0), sk);
  const int n_kt = (klen + kTileK - 1) / kTileK;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * kTileQ + warp * 16;
  const int row_a = r0 + g, row_b = r0 + g + 8;
  const bool active = r0 < sq;  // the same for the whole warp

  // this lane's ldmatrix row for V (transposed): matrix lane/8 = (key half, d half)
  const int v_key = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;
  // and for K (as it lies): matrix lane/8 = (d half, key n-tile of a pair)
  const int k_key = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  // the softmax runs in base 2: exp(x) = 2^(x log2 e), one multiply per score
  const float scale_log2 = scale * kLog2e;

  if (n_kt > 0) {
    stage_tile(k_s[0], k_src, kvs.r, 0, sk);
    stage_tile(v_s[0], v_src, kvs.r, 0, sk);
    cp_async_commit();
  }

  // q rows of this warp as A fragments, unscaled; rows >= sq read as zero.
  uint32_t qf[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = kk * 16 + half * 8 + 2 * t;
      uint32_t qa = 0u, qb = 0u;
      if (row_a < sq) qa = *reinterpret_cast<const uint32_t*>(q_src + row_a * qs.r + col);
      if (row_b < sq) qb = *reinterpret_cast<const uint32_t*>(q_src + row_b * qs.r + col);
      qf[kk][2 * half] = qa;
      qf[kk][2 * half + 1] = qb;
    }
  }

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this thread's share
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      stage_tile(k_s[buf ^ 1], k_src, kvs.r, (kt + 1) * kTileK, sk);
      stage_tile(v_s[buf ^ 1], v_src, kvs.r, (kt + 1) * kTileK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const __nv_bfloat16* ks = k_s[buf];
      const __nv_bfloat16* vs = v_s[buf];
      const int c0 = kt * kTileK;

      float s[kTileK / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTileK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < kTileK / 8; nt += 2) {
          uint32_t kb[4];  // b0, b1 of n-tile nt, then of nt + 1
          ldmatrix_x4(kb, ks + (nt * 8 + k_key) * kStride + kk * 16 + k_col);
          mma_16816(s[nt], qf[kk], kb[0], kb[1]);
          mma_16816(s[nt + 1], qf[kk], kb[2], kb[3]);
        }
      }

      // scale in fp32 (to base-2 units), mask, tile row max; only the tile
      // that holds key klen has anything to mask
      const bool edge = c0 + kTileK > klen;
      float cm_a = kNegInf, cm_b = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kTileK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c0 + nt * 8 + 2 * t + (e & 1);
          s[nt][e] = (edge && j >= klen) ? kNegInf : s[nt][e] * scale_log2;
        }
        cm_a = fmaxf(cm_a, fmaxf(s[nt][0], s[nt][1]));
        cm_b = fmaxf(cm_b, fmaxf(s[nt][2], s[nt][3]));
      }
      const float nm_a = fmaxf(m_a, quad_max(cm_a));
      const float nm_b = fmaxf(m_b, quad_max(cm_b));
      const float alpha_a = exp2_approx(m_a - nm_a), alpha_b = exp2_approx(m_b - nm_b);
      m_a = nm_a;
      m_b = nm_b;

      // unnormalised p, exactly 0 for an invalid key
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < kTileK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c0 + nt * 8 + 2 * t + (e & 1);
          const float p = exp2_approx(s[nt][e] - (e < 2 ? nm_a : nm_b));
          s[nt][e] = (edge && j >= klen) ? 0.f : p;
        }
        sum_a += s[nt][0] + s[nt][1];
        sum_b += s[nt][2] + s[nt][3];
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int nd = 0; nd < kHeadDim / 8; ++nd) {
        acc[nd][0] *= alpha_a;
        acc[nd][1] *= alpha_a;
        acc[nd][2] *= alpha_b;
        acc[nd][3] *= alpha_b;
      }

      // acc += bf16(p) . V
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        const float(&lo)[4] = s[2 * kk];
        const float(&hi)[4] = s[2 * kk + 1];
        const uint32_t pa[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                                pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3])};
        const __nv_bfloat16* vrow = vs + (kk * 16 + v_key) * kStride + v_col;
#pragma unroll
        for (int nd = 0; nd < kHeadDim / 8; nd += 2) {
          uint32_t vb[4];  // b0, b1 of n-tile nd, then of nd + 1
          ldmatrix_x4_trans(vb, vrow + nd * 8);
          mma_16816(acc[nd], pa, vb[0], vb[1]);
          mma_16816(acc[nd + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer's twin
  }

  if (!active) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float d_a = l_a == 0.f ? 1.f : l_a, d_b = l_b == 0.f ? 1.f : l_b;
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row_a < sq)
      *reinterpret_cast<uint32_t*>(o_dst + row_a * os.r + col) =
          pack_bf16(acc[nd][0] / d_a, acc[nd][1] / d_a);
    if (row_b < sq)
      *reinterpret_cast<uint32_t*>(o_dst + row_b * os.r + col) =
          pack_bf16(acc[nd][2] / d_b, acc[nd][3] / d_b);
  }
  if constexpr (kStats) {
    if (t == 0) {
      float* dst = lse + static_cast<size_t>(bh) * sq;
      if (row_a < sq) dst[row_a] = l_a == 0.f ? 0.f : m_a * kLn2 + logf(fmaxf(l_a, 1e-30f));
      if (row_b < sq) dst[row_b] = l_b == 0.f ? 0.f : m_b * kLn2 + logf(fmaxf(l_b, 1e-30f));
    }
  }
}

template <bool kStats>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                     const void* kv_lengths, int batch, int heads, int sq, int sk,
                     const long long* strides, float scale, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1 || (kStats && lse == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = (sq + kTileQ - 1) / kTileQ;
  const long long blocks = static_cast<long long>(batch) * heads * q_tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides kvs{strides[3], strides[4], strides[5]};
  const Strides os{strides[6], strides[7], strides[8]};
  flash_fwd_kernel<kStats><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(kv_lengths), heads, sq, sk, q_tiles, qs,
      kvs, os, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, o: (batch, heads, sq, 64) bf16; k, v: (batch, heads, sk, 64) bf16, each
// addressed as base + b * stride_b + h * stride_h + row * stride_r (+ column),
// strides = {q: b, h, r; k and v: b, h, r; o: b, h, r} in elements, every
// stride a multiple of 8 and every base 16-byte aligned. kv_lengths: (batch,)
// int32 on the device, or null for sk everywhere.
int tpuwsi_flash_fwd(const void* q, const void* k, const void* v, void* o,
                     const void* kv_lengths, int batch, int heads, int sq, int sk,
                     const long long* strides, float scale, void* stream) {
  return launch_flash_fwd<false>(q, k, v, o, nullptr, kv_lengths, batch, heads, sq, sk, strides,
                                 scale, stream);
}

// As above, and lse: (batch, heads, sq) fp32, contiguous.
int tpuwsi_flash_fwd_stats(const void* q, const void* k, const void* v, void* o, void* lse,
                           const void* kv_lengths, int batch, int heads, int sq, int sk,
                           const long long* strides, float scale, void* stream) {
  return launch_flash_fwd<true>(q, k, v, o, lse, kv_lengths, batch, heads, sq, sk, strides,
                                scale, stream);
}

}  // extern "C"
