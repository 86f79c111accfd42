// Backward of whole-sequence multi-head attention from the fused qkv
// projection, bf16: dqkv from qkv and dO, with p saved or rebuilt.
//
// Replaces two TPU kernels of tpuwsi/ops/attention.py:
//   kSaved = true   :935 `_mha_qkv_bwd_kernel_saved` (p comes from the forward)
//   kSaved = false  :732 `_mha_qkv_bwd_kernel`       (p is rebuilt from qkv)
// Same contract, per head, with g = dO (B, N, D) and P[i, j] (query i, key j):
//   dV = P^T . g          bf16 operands, fp32 accumulate
//   dP = g . V^T          fp32
//   t_i = sum_j P_ij dP_ij                       fp32
//   dS = P * (dP - t) * scale                    rounded to bf16
//   dQ = dS . K,  dK = dS^T . Q                  with the unscaled bf16 q and k
// all written into one dqkv (B, N, 3D) bf16 in the [which, head, hd] columns.
// With kSaved, P is the bf16 tensor the forward wrote, (B, H, N, p_stride),
// used as it is everywhere. Without, P = softmax(q_s . k^T) is rebuilt in fp32
// under the forward's masks (q_s = q * scale rounded to bf16; key j valid for
// query i iff j < N and, for 0 < block_len < N, j / block_len == i / block_len)
// and stays fp32 in t and dS; it is rounded to bf16 only as the operand of dV.
//
// What bounds it on an H100. At the DINO student-global shape (B=192, N=197,
// H=6, hd=64) the kernel must read qkv (87 MB), g (29 MB) and, when saved, p
// (94 MB), and write dqkv (87 MB); the four products that are needed come to
// B*H*4*2*N*N*hd = 23 GFLOP (five with the score product). That is 80-110 FLOP per byte,
// below the card's ~295 FLOP/byte ridge: an ideal kernel is bounded by device
// memory. This one trades arithmetic for simplicity (below) and is bounded by
// mma issue instead.
//
// What this design does about it. The TPU kernel keeps (H*S, S) fp32 score and
// dP blocks in VMEM; a Hopper SM has 227 KB, so nothing of size N x N is kept:
//   - one block per (head, batch element), two phases, two or three (n_pad, 64)
//     operand tiles in shared memory at a time (rows padded to 72 bf16, free
//     of bank conflicts for 32-bit and ldmatrix loads);
//   - phase A is query-major with K and V staged: a warp owns 16 queries, holds
//     their g (and scaled q) as mma A fragments, and walks the keys twice. The
//     first walk finds t (and, without saved p, the row max and sum, with
//     sum_j e_ij dP_ij carried under the running max and divided by the row sum
//     at the end); the second forms dS in registers and feeds it as the A
//     operand of dQ += dS . K. t, max and 1/sum go to shared memory;
//   - phase B is key-major with Q and g staged instead (and the scaled q, when
//     p is rebuilt): a warp owns 16 keys, holds their V (and K) as A fragments,
//     walks the queries once, forms dP^T and p^T tiles, then dS^T, and
//     accumulates dV += p^T . g and dK += dS^T . Q in registers;
//   - dP is therefore computed three times and the scores, when rebuilt, three
//     times, but no atomics and no cross-warp reduction are needed: every
//     output element has one writer and the result is deterministic;
//   - there are no padded rows: every access to qkv, g, p and dqkv past row
//     N - 1 is guarded, and tile rows past N read as zero;
//   - with block_len (rebuilt p only; a saved p has its mask baked in) the
//     walks skip key or query chunks wholly outside the owned rows' blocks,
//     which contribute exact zeros.
//   - the loops wait on shared and device memory more than on the tensor
//     cores, so two blocks of 8 warps share an SM: steps of 16 keys or queries
//     and a cap of 128 registers per thread (a few spill) measured 15-25%
//     faster at N = 197 than one block of 32-key steps with 166-194 registers.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kBlocksPerSm = 2;          // caps a thread at 128 registers (a few spill)
constexpr int kChunk = 16;               // keys (phase A) or queries (phase B) per step
constexpr int kStride = kHeadDim + 8;    // bf16 per tile row in shared memory
constexpr int kMaxSeq = 511;
constexpr float kNegInf = -1e30f;        // finite, as in the TPU kernel

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// n rows of 64 bf16 (row stride `stride`, starting at src) -> a shared-memory
// tile of n_pad rows, 16 bytes per copy; rows >= n are zero. With kScale the
// values are multiplied by scale in fp32 and rounded back to bf16.
template <bool kScale>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                           int stride, int n, int n_pad, float scale) {
  for (int idx = threadIdx.x; idx < n_pad * (kHeadDim / 8); idx += blockDim.x) {
    const int j = idx >> 3, col = (idx & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) {
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(j) * stride + col);
      if constexpr (kScale) {
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
          w[e] = pack_bf16(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(tile + j * kStride + col) = v;
  }
}

// Rows row_a = r0 + g and row_b = row_a + 8 of a 64-column matrix in device
// memory as the four k-steps of an mma A operand; rows >= n read as zero.
template <bool kScale>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[kHeadDim / 16][4],
                                             const __nv_bfloat16* src, int stride, int row_a,
                                             int row_b, int n, int t, float scale) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = kk * 16 + half * 8 + 2 * t;
      float2 a = make_float2(0.f, 0.f), b = a;
      if (row_a < n)
        a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            src + static_cast<size_t>(row_a) * stride + col));
      if (row_b < n)
        b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            src + static_cast<size_t>(row_b) * stride + col));
      if constexpr (kScale) {
        a.x *= scale; a.y *= scale; b.x *= scale; b.y *= scale;
      }
      f[kk][2 * half] = pack_bf16(a.x, a.y);
      f[kk][2 * half + 1] = pack_bf16(b.x, b.y);
    }
  }
}

// acc (16 x kChunk, fp32) = A (16 x 64, fragments) . tile[c0 .. c0 + kChunk)^T,
// the tile holding one row of 64 bf16 per output column.
__device__ __forceinline__ void mma_a_tile_t(float (&acc)[kChunk / 8][4],
                                             const uint32_t (&a)[kHeadDim / 16][4],
                                             const __nv_bfloat16* tile, int c0, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      const __nv_bfloat16* p = tile + (c0 + nt * 8 + g) * kStride + kk * 16 + 2 * t;
      mma_16816(acc[nt], a[kk], *reinterpret_cast<const uint32_t*>(p),
                *reinterpret_cast<const uint32_t*>(p + 8));
    }
  }
}

// acc (16 x 64, fp32) += A (16 x kChunk, bf16 from the fp32 tile x) . tile[c0 .. c0 + kChunk),
// the accumulator layout of x being the A-operand layout of the product.
__device__ __forceinline__ void mma_acc_tile(float (&acc)[kHeadDim / 8][4],
                                             const float (&x)[kChunk / 8][4],
                                             const __nv_bfloat16* tile, int c0, int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    const float(&lo)[4] = x[2 * kk];
    const float(&hi)[4] = x[2 * kk + 1];
    const uint32_t a[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                           pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3])};
    const __nv_bfloat16* src = tile + (c0 + kk * 16 + row) * kStride + col;
#pragma unroll
    for (int nd = 0; nd < kHeadDim / 8; nd += 2) {
      uint32_t b[4];  // b0, b1 of n-tile nd, then of nd + 1
      ldmatrix_x4_trans(b, src + nd * 8);
      mma_16816(acc[nd], a, b[0], b[1]);
      mma_16816(acc[nd + 1], a, b[2], b[3]);
    }
  }
}

// Rows row_a, row_b of a 16 x 64 fp32 accumulator -> bf16 in device memory.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int stride,
                                           const float (&acc)[kHeadDim / 8][4], int row_a,
                                           int row_b, int n, int t) {
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row_a < n)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_a) * stride + col) =
          pack_bf16(acc[nd][0], acc[nd][1]);
    if (row_b < n)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_b) * stride + col) =
          pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

// Fragment ownership (PTX ISA, mma.m16n8k16): lane = 4*g + t. A thread holds
// rows g and g+8 of the 16-row tile; of an 8-column accumulator tile it holds
// columns 2t and 2t+1 (regs 0,1 for row g; regs 2,3 for row g+8).
template <bool kSaved>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
mha_qkv_bwd_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ gout,
                   const __nv_bfloat16* __restrict__ probs, __nv_bfloat16* __restrict__ dqkv,
                   int p_stride, int n, int d, int n_pad, float scale, int block_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  // phase A: tile0 = K, tile1 = V.  phase B: tile0 = Q, tile1 = g, tile2 = scaled Q.
  __nv_bfloat16* tile0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* tile1 = tile0 + n_pad * kStride;
  __nv_bfloat16* tile2 = tile1 + n_pad * kStride;  // only without saved p
  float* stats = reinterpret_cast<float*>(tile0 + (kSaved ? 2 : 3) * n_pad * kStride);
  float* t_s = stats;               // [n_pad] t_i
  float* m_s = stats + n_pad;       // [n_pad] row max      (rebuilt p only)
  float* il_s = stats + 2 * n_pad;  // [n_pad] 1 / row sum  (rebuilt p only)

  const int h = blockIdx.x;
  const int d3 = 3 * d;
  const size_t img = blockIdx.y;
  const __nv_bfloat16* q_src = qkv + img * n * d3 + h * kHeadDim;
  const __nv_bfloat16* k_src = q_src + d;
  const __nv_bfloat16* v_src = q_src + 2 * d;
  const __nv_bfloat16* g_src = gout + img * n * d + h * kHeadDim;
  __nv_bfloat16* dq_dst = dqkv + img * n * d3 + h * kHeadDim;
  const __nv_bfloat16* p_src =
      kSaved ? probs + (img * gridDim.x + h) * n * static_cast<size_t>(p_stride) : nullptr;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_warps = blockDim.x >> 5;
  const bool packed = !kSaved && block_len > 0 && block_len < n;

  for (int i = threadIdx.x; i < 3 * n_pad; i += blockDim.x) stats[i] = 0.f;
  stage_tile<false>(tile0, k_src, d3, n, n_pad, 1.f);
  stage_tile<false>(tile1, v_src, d3, n, n_pad, 1.f);
  __syncthreads();

  // ---- phase A: 16 queries per warp against all keys -> t (m, 1/l), dQ ----
  for (int r0 = warp * 16; r0 < n; r0 += n_warps * 16) {
    const int row_a = r0 + g, row_b = r0 + g + 8;
    uint32_t gf[kHeadDim / 16][4], qf[kHeadDim / 16][4];
    load_a_frags<false>(gf, g_src, d, row_a, row_b, n, t, 1.f);
    if constexpr (!kSaved) load_a_frags<true>(qf, q_src, d3, row_a, row_b, n, t, scale);
    const int blk_a = packed ? row_a / block_len : 0;
    const int blk_b = packed ? row_b / block_len : 0;
    int c_lo = 0, c_hi = n_pad;
    if (packed) {  // keys of the blocks that rows r0 .. r0 + 15 belong to
      const int last = min(r0 + 15, n - 1);
      c_lo = (r0 / block_len) * block_len / kChunk * kChunk;
      c_hi = (min((last / block_len + 1) * block_len, n) + kChunk - 1) / kChunk * kChunk;
    }

    // p (fp32) of the 16 rows against keys [c0, c0 + kChunk): read, or rebuilt
    // from the scores with the row's max m and 1 / sum il.
    auto probs_chunk = [&](int c0, float (&p)[kChunk / 8][4], float m_a, float m_b,
                           float il_a, float il_b) {
      if constexpr (kSaved) {
#pragma unroll
        for (int nt = 0; nt < kChunk / 8; ++nt) {
          const int j = c0 + nt * 8 + 2 * t;
          float2 pa = make_float2(0.f, 0.f), pb = pa;
          if (j < p_stride) {
            if (row_a < n)
              pa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  p_src + static_cast<size_t>(row_a) * p_stride + j));
            if (row_b < n)
              pb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  p_src + static_cast<size_t>(row_b) * p_stride + j));
          }
          p[nt][0] = pa.x; p[nt][1] = pa.y; p[nt][2] = pb.x; p[nt][3] = pb.y;
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < kChunk / 8; ++nt) {
          p[nt][0] = __expf(p[nt][0] - m_a) * il_a;
          p[nt][1] = __expf(p[nt][1] - m_a) * il_a;
          p[nt][2] = __expf(p[nt][2] - m_b) * il_b;
          p[nt][3] = __expf(p[nt][3] - m_b) * il_b;
        }
      }
    };
    // masked fp32 scores (rebuilt p only)
    auto scores = [&](int c0, float (&s)[kChunk / 8][4]) {
      mma_a_tile_t(s, qf, tile0, c0, g, t);
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c0 + nt * 8 + 2 * t + (e & 1);
          const bool ok = j < n && (!packed || j / block_len == (e < 2 ? blk_a : blk_b));
          if (!ok) s[nt][e] = kNegInf;
        }
      }
    };

    // Walk 1: t_i = sum_j p_ij dP_ij (and the row max and sum).
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f, u_a = 0.f, u_b = 0.f;
    for (int c0 = c_lo; c0 < c_hi; c0 += kChunk) {
      float p[kChunk / 8][4], dp[kChunk / 8][4];
      mma_a_tile_t(dp, gf, tile1, c0, g, t);
      if constexpr (kSaved) {
        probs_chunk(c0, p, 0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int nt = 0; nt < kChunk / 8; ++nt) {
          u_a += p[nt][0] * dp[nt][0] + p[nt][1] * dp[nt][1];
          u_b += p[nt][2] * dp[nt][2] + p[nt][3] * dp[nt][3];
        }
      } else {
        scores(c0, p);
        float cm_a = kNegInf, cm_b = kNegInf;
#pragma unroll
        for (int nt = 0; nt < kChunk / 8; ++nt) {
          cm_a = fmaxf(cm_a, fmaxf(p[nt][0], p[nt][1]));
          cm_b = fmaxf(cm_b, fmaxf(p[nt][2], p[nt][3]));
        }
        const float nm_a = fmaxf(m_a, quad_max(cm_a));
        const float nm_b = fmaxf(m_b, quad_max(cm_b));
        float sa = 0.f, sb = 0.f, ua = 0.f, ub = 0.f;
#pragma unroll
        for (int nt = 0; nt < kChunk / 8; ++nt) {
          const float e0 = __expf(p[nt][0] - nm_a), e1 = __expf(p[nt][1] - nm_a);
          const float e2 = __expf(p[nt][2] - nm_b), e3 = __expf(p[nt][3] - nm_b);
          sa += e0 + e1;
          sb += e2 + e3;
          ua += e0 * dp[nt][0] + e1 * dp[nt][1];
          ub += e2 * dp[nt][2] + e3 * dp[nt][3];
        }
        const float f_a = __expf(m_a - nm_a), f_b = __expf(m_b - nm_b);
        l_a = l_a * f_a + sa;
        l_b = l_b * f_b + sb;
        u_a = u_a * f_a + ua;
        u_b = u_b * f_b + ub;
        m_a = nm_a;
        m_b = nm_b;
      }
    }
    float il_a = 1.f, il_b = 1.f;
    if constexpr (!kSaved) {
      il_a = 1.f / quad_sum(l_a);
      il_b = 1.f / quad_sum(l_b);
    }
    const float t_a = quad_sum(u_a) * il_a, t_b = quad_sum(u_b) * il_b;
    if (t == 0) {  // row_a, row_b < n_pad always
      t_s[row_a] = t_a;
      t_s[row_b] = t_b;
      if constexpr (!kSaved) {
        m_s[row_a] = m_a;
        m_s[row_b] = m_b;
        il_s[row_a] = il_a;
        il_s[row_b] = il_b;
      }
    }

    // Walk 2: dS = p (dP - t) scale, dQ += dS . K.
    float dq[kHeadDim / 8][4];
#pragma unroll
    for (int nd = 0; nd < kHeadDim / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
    for (int c0 = c_lo; c0 < c_hi; c0 += kChunk) {
      float p[kChunk / 8][4], dp[kChunk / 8][4];
      mma_a_tile_t(dp, gf, tile1, c0, g, t);
      if constexpr (!kSaved) scores(c0, p);
      probs_chunk(c0, p, m_a, m_b, il_a, il_b);
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        p[nt][0] = p[nt][0] * (dp[nt][0] - t_a) * scale;
        p[nt][1] = p[nt][1] * (dp[nt][1] - t_a) * scale;
        p[nt][2] = p[nt][2] * (dp[nt][2] - t_b) * scale;
        p[nt][3] = p[nt][3] * (dp[nt][3] - t_b) * scale;
      }
      mma_acc_tile(dq, p, tile0, c0, lane);
    }
    store_rows(dq_dst, d3, dq, row_a, row_b, n, t);
  }

  // ---- restage: Q, g (and scaled Q) take the place of K, V ----
  __syncthreads();
  stage_tile<false>(tile0, q_src, d3, n, n_pad, 1.f);
  stage_tile<false>(tile1, g_src, d, n, n_pad, 1.f);
  if constexpr (!kSaved) stage_tile<true>(tile2, q_src, d3, n, n_pad, scale);
  __syncthreads();

  // ---- phase B: 16 keys per warp against all queries -> dK, dV ----
  for (int j0 = warp * 16; j0 < n; j0 += n_warps * 16) {
    const int key_a = j0 + g, key_b = j0 + g + 8;
    uint32_t vf[kHeadDim / 16][4], kf[kHeadDim / 16][4];
    load_a_frags<false>(vf, v_src, d3, key_a, key_b, n, t, 1.f);
    if constexpr (!kSaved) load_a_frags<false>(kf, k_src, d3, key_a, key_b, n, t, 1.f);
    const int blk_a = packed ? key_a / block_len : 0;
    const int blk_b = packed ? key_b / block_len : 0;
    int i_lo = 0, i_hi = n_pad;
    if (packed) {  // queries of the blocks that keys j0 .. j0 + 15 belong to
      const int last = min(j0 + 15, n - 1);
      i_lo = (j0 / block_len) * block_len / kChunk * kChunk;
      i_hi = (min((last / block_len + 1) * block_len, n) + kChunk - 1) / kChunk * kChunk;
    }
    float dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
#pragma unroll
    for (int nd = 0; nd < kHeadDim / 8; ++nd) {
      dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
      dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
    }
    for (int i0 = i_lo; i0 < i_hi; i0 += kChunk) {
      // transposed tiles: rows are this warp's keys, columns the queries
      float pt[kChunk / 8][4], dpt[kChunk / 8][4];
      mma_a_tile_t(dpt, vf, tile1, i0, g, t);
      if constexpr (!kSaved) mma_a_tile_t(pt, kf, tile2, i0, g, t);
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + nt * 8 + 2 * t + (e & 1);
          const int key = e < 2 ? key_a : key_b;
          float p = 0.f;
          if (i < n && key < n) {
            if constexpr (kSaved) {
              p = __bfloat162float(p_src[static_cast<size_t>(i) * p_stride + key]);
            } else if (!packed || i / block_len == (e < 2 ? blk_a : blk_b)) {
              p = __expf(pt[nt][e] - m_s[i]) * il_s[i];
            }
          }
          pt[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - t_s[i]) * scale;  // dS^T
        }
      }
      mma_acc_tile(dv, pt, tile1, i0, lane);
      mma_acc_tile(dk, dpt, tile0, i0, lane);
    }
    store_rows(dq_dst + d, d3, dk, key_a, key_b, n, t);
    store_rows(dq_dst + 2 * d, d3, dv, key_a, key_b, n, t);
  }
}

template <bool kSaved>
int launch_bwd(const void* qkv, const void* g, const void* probs, void* dqkv, int p_stride,
               int batch, int n, int num_heads, float scale, int block_len, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || n > kMaxSeq || num_heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kSaved && p_stride < n) return static_cast<int>(cudaErrorInvalidValue);
  const int d = num_heads * kHeadDim;
  const int n_pad = (n + kChunk - 1) / kChunk * kChunk;
  const int tiles = kSaved ? 2 : 3;
  const int smem_bytes = static_cast<int>(
      static_cast<size_t>(tiles) * n_pad * kStride * sizeof(__nv_bfloat16) +
      3 * static_cast<size_t>(n_pad) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mha_qkv_bwd_kernel<kSaved>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n + 15) / 16;
  const int warps = groups < kWarps ? groups : kWarps;
  mha_qkv_bwd_kernel<kSaved><<<dim3(num_heads, batch), warps * 32, smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(probs), static_cast<__nv_bfloat16*>(dqkv), p_stride, n,
      d, n_pad, scale, block_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv, dqkv: (batch, n, 3 * num_heads * 64) bf16; g: (batch, n, num_heads * 64)
// bf16; probs: (batch, num_heads, n, p_stride) bf16 as tpuwsi_mha_qkv_fwd_saved
// wrote it. All contiguous and 16-byte aligned, p_stride even. 1 <= n <= 511.
int tpuwsi_mha_qkv_bwd_saved(const void* qkv, const void* g, const void* probs, void* dqkv,
                             int p_stride, int batch, int n, int num_heads, float scale,
                             void* stream) {
  return launch_bwd<true>(qkv, g, probs, dqkv, p_stride, batch, n, num_heads, scale, 0, stream);
}

// The same result with p rebuilt from qkv under the forward's masks.
int tpuwsi_mha_qkv_bwd(const void* qkv, const void* g, void* dqkv, int batch, int n,
                       int num_heads, float scale, int block_len, void* stream) {
  return launch_bwd<false>(qkv, g, nullptr, dqkv, 0, batch, n, num_heads, scale, block_len,
                           stream);
}

}  // extern "C"
