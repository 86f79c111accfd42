// The pre-norm attention sub-block as one op, forward and backward, bf16:
//   y = x + bf16(MHA(bf16(bf16(LN(x)) . Wqkv + bqkv)) . Wproj + bproj)
//
// Replaces two TPU kernels of tpuwsi/ops/attention.py:
//   :1467 `_attn_block_fwd_kernel` (pallas_call at :1593)  -> tpuwsi_attn_block_fwd
//   :1490 `_attn_block_bwd_kernel` (pallas_call at :1647)  -> tpuwsi_attn_block_bwd
// Same arithmetic. LayerNorm in fp32 with the fast variance E[x^2] - mean^2
// clamped at 0, rounded to bf16 before the qkv product; every product sums in
// fp32; qkv = product + bias, rounded; the attention is that of
// mha_qkv_fwd.cu / mha_qkv_bwd.cu (q scaled in fp32 and rounded, fp32 softmax
// over the whole row, p rounded before p.V, o rounded before the projection);
// the projection with its bias is rounded BEFORE x is added. Backward, from x,
// dy and the weights alone: LN(x), qkv, p and o are rebuilt; dWproj = o^T . dy,
// dbproj = sum dy; do = bf16(dy . Wproj^T); dqkv as in mha_qkv_bwd.cu (p fp32
// in t and dS, rounded for dV only, dS rounded); dWqkv = bf16(LN)^T . bf16(dqkv)
// but dbqkv = sum of the fp32, unrounded dqkv; dln = bf16(dqkv) . Wqkv^T;
// LayerNorm backward; dx = bf16(dy + dx_ln); dgamma, dbeta. The six parameter
// gradients are fp32 sums over all images.
//
// What bounds it on an H100. At (B, N, D) = (192, 197, 384) the forward must
// read x and write y (58 MB, 0.017 ms at 3.35 TB/s) for 56 GFLOP (0.057 ms at
// the dense bf16 peak): bound by operations, as is the backward (157 GFLOP).
// The unfused route moves qkv, o and the projection through device memory
// (five more tensors); what this op saves is those bytes and six launches.
//
// What this design does about it. The TPU program holds one image's qkv and
// all heads' (S, S) fp32 scores in VMEM; one image's qkv (454 KB at 197
// tokens) fits no SM. So an image is split by head:
//   - forward, ONE kernel, a thread-block cluster of 6 blocks (16 warps each)
//     per image, block h = head h. The block normalises x in row tiles of 64 (all six repeat
//     that: cheap), multiplies each tile with its 192 columns of Wqkv (streamed
//     from L2 in chunks of 32 rows through two buffers) and leaves q (scaled),
//     k, v of its head as three (N, 64) tiles in shared memory; runs K2's two
//     passes on them, a warp per 16 queries, scores in registers, and puts o
//     over q; cluster.sync(); then computes ITS 64 columns of y: every head's
//     o, read from the other blocks' shared memory, times Wproj[:, 64h..],
//     plus bias, rounded, plus x. One writer per element of y and one order
//     of summation. qkv, the scores, p and o never reach device memory;
//   - backward, one entry point, four kinds of device kernel. `attn_block_bwd_
//     head_kernel`, a block per (image, head), rebuilds q, k, v as above, o
//     (to a workspace, for dWproj), its 64 columns of do from dy and 64 rows
//     of Wproj, and runs K3's two phases on five (N, 64) tiles in shared
//     memory; it leaves bf16 dqkv in a workspace and the fp32 column sums of
//     its dqkv as one partial per image. Scores, p and dP never leave the
//     chip. What crosses heads is finished by the row-tiled kernels of
//     dense_common.cuh over all B N rows: dln = dqkv . Wqkv^T with the
//     LayerNorm backward and dy added (it also rebuilds LN(x) into a
//     workspace), dWqkv = LN(x)^T . dqkv and dWproj, dbproj = o^T . dy, sum dy
//     per group of row tiles; `sum_partials_kernel` adds every partial in a
//     fixed order. No atomics: two launches on the same inputs give the same
//     bits. The price is three workspaces written and read once each (dqkv,
//     o, LN(x): 5 B N D bf16) and the forward half done a second time.
// Built for D = 384 with 6 heads of 64 and 1 <= N <= 304 (five tiles of the
// backward in 227 KB); rows past N are neither read nor written.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cooperative_groups.h>

#include "dense_common.cuh"

namespace {

using namespace mlp;
namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kD = 384;                     // embedding width
constexpr int kHeadDim = 64;
constexpr int kHeads = kD / kHeadDim;       // and blocks per cluster in the forward
constexpr int kHeadCols = 3 * kHeadDim;     // columns of qkv that belong to one head
constexpr int kMaxSeq = 304;
constexpr int kKc = 16;                     // keys (or queries) per step of the attention loops
constexpr float kNegInf = -1e30f;           // finite, as in the TPU kernel

constexpr int kTStride = kHeadDim + kPad;   // bf16 per row of an (N, 64) tile
constexpr int kARows = 64;                  // rows of x per LN(x) tile
constexpr int kAStride = kD + kPad;
constexpr int kWChunk = 32;                 // rows of Wqkv per streamed chunk
constexpr int kWChunks = kD / kWChunk;
constexpr int kWStride = kHeadCols + kPad;
constexpr int kGemmBytes = 2 * (kARows * kAStride + 2 * kWChunk * kWStride);
constexpr int kWpSliceBytes = 2 * kHeadDim * kAStride;  // 64 rows of Wproj (backward)
static_assert(2 * kD * kTStride <= kGemmBytes, "Wproj[:, 64 columns] takes the GEMM's room");
static_assert(kWChunks % 2 == 0, "the chunk buffers keep their turn across row tiles");

constexpr int kFwdWarps = 16;               // 4 row groups x 4 column groups in the qkv product
constexpr int kBwdWarps = 9;                // 8 in the GEMM (4 x 2); 16 queries each after it
constexpr int kBwdGemmColGroups = 2;

constexpr int tile_bytes(int n_pad) { return n_pad * kTStride * 2; }
constexpr int fwd_smem_bytes(int n_pad) { return 3 * tile_bytes(n_pad) + kGemmBytes; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int bwd_smem_bytes(int n_pad) {
  return cmax(cmax(3 * tile_bytes(n_pad) + kGemmBytes, 4 * tile_bytes(n_pad) + kWpSliceBytes),
              5 * tile_bytes(n_pad) + 4 * (3 * n_pad + kBwdWarps * kHeadCols));
}
constexpr int kSmemLimit = 232448;          // 227 KB a block
static_assert(fwd_smem_bytes(kMaxSeq) <= kSmemLimit && bwd_smem_bytes(kMaxSeq) <= kSmemLimit,
              "kMaxSeq tokens must fit a block's shared memory");
static_assert(kMaxSeq % kKc == 0, "kMaxSeq is its own padded length");

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment ownership (PTX ISA, mma.m16n8k16): lane = 4*g + t. A thread holds
// rows g and g+8 of the 16-row tile; of an 8-column accumulator tile it holds
// columns 2t and 2t+1 (regs 0,1 for row g; regs 2,3 for row g+8).

// Rows r0 .. r0 + 15 of an (N, 64) tile in shared memory as the four k-steps
// of an mma A operand.
__device__ __forceinline__ void tile_a_frags(uint32_t (&f)[kHeadDim / 16][4], const bf16* tile,
                                             int r0, const Lane& L) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    ldmatrix_x4(f[kk], L.a_rows(tile + r0 * kTStride + kk * 16, kTStride));
}

// The same fragments times `scale` in fp32, rounded back to bf16.
__device__ __forceinline__ void scale_frags(uint32_t (&f)[kHeadDim / 16][4], float scale) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = unpack_bf16(f[kk][e]);
      f[kk][e] = pack_bf16(v.x * scale, v.y * scale);
    }
  }
}

// acc (16 x kKc, fp32) = A (16 x 64, fragments) . tile[c0 .. c0 + kKc)^T,
// the tile holding one row of 64 bf16 per output column.
__device__ __forceinline__ void mma_a_tile_t(float (&acc)[kKc / 8][4],
                                             const uint32_t (&a)[kHeadDim / 16][4],
                                             const bf16* tile, int c0, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kKc / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kKc / 8; ++nt) {
      const bf16* p = tile + (c0 + nt * 8 + g) * kTStride + kk * 16 + 2 * t;
      mma_16816(acc[nt], a[kk], *reinterpret_cast<const uint32_t*>(p),
                *reinterpret_cast<const uint32_t*>(p + 8));
    }
  }
}

// acc (16 x 64, fp32) += bf16(x) (16 x kKc) . tile[c0 .. c0 + kKc), the
// accumulator layout of x being the A-operand layout of the product.
__device__ __forceinline__ void mma_acc_tile(float (&acc)[kHeadDim / 8][4],
                                             const float (&x)[kKc / 8][4], const bf16* tile,
                                             int c0, const Lane& L) {
  const uint32_t a[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[0][2], x[0][3]),
                         pack_bf16(x[1][0], x[1][1]), pack_bf16(x[1][2], x[1][3])};
  const bf16* src = L.b_kn(tile + c0 * kTStride, kTStride);
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; nd += 2) {
    uint32_t b[4];  // b0, b1 of n-tile nd, then of nd + 1
    ldmatrix_x4_trans(b, src + nd * 8);
    mma_16816(acc[nd], a, b[0], b[1]);
    mma_16816(acc[nd + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[kHeadDim / 8][4]) {
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
}

// fp32 scores of 16 queries against keys [c0, c0 + kKc); keys at or past n
// get the finite kNegInf.
__device__ __forceinline__ void masked_scores(float (&s)[kKc / 8][4],
                                              const uint32_t (&qf)[kHeadDim / 16][4],
                                              const bf16* k_s, int c0, int n, int g, int t) {
  mma_a_tile_t(s, qf, k_s, c0, g, t);
#pragma unroll
  for (int nt = 0; nt < kKc / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + nt * 8 + 2 * t + (e & 1) >= n) s[nt][e] = kNegInf;
  }
}

// Softmax attention of 16 queries (their scaled q as A fragments) over the n
// keys of k_s, v_s, in the two passes of mha_qkv_fwd.cu: exact row max and
// sum first, then p = exp(s - m) / l rounded to bf16 and o += p . V.
__device__ __forceinline__ void attention_rows(float (&o)[kHeadDim / 8][4],
                                               const uint32_t (&qf)[kHeadDim / 16][4],
                                               const bf16* k_s, const bf16* v_s, int n, int n_pad,
                                               int g, int t, const Lane& L) {
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  for (int c0 = 0; c0 < n_pad; c0 += kKc) {
    float s[kKc / 8][4];
    masked_scores(s, qf, k_s, c0, n, g, t);
    float cm_a = kNegInf, cm_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kKc / 8; ++nt) {
      cm_a = fmaxf(cm_a, fmaxf(s[nt][0], s[nt][1]));
      cm_b = fmaxf(cm_b, fmaxf(s[nt][2], s[nt][3]));
    }
    const float nm_a = fmaxf(m_a, quad_max(cm_a));
    const float nm_b = fmaxf(m_b, quad_max(cm_b));
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int nt = 0; nt < kKc / 8; ++nt) {
      sa += __expf(s[nt][0] - nm_a) + __expf(s[nt][1] - nm_a);
      sb += __expf(s[nt][2] - nm_b) + __expf(s[nt][3] - nm_b);
    }
    l_a = l_a * __expf(m_a - nm_a) + sa;
    l_b = l_b * __expf(m_b - nm_b) + sb;
    m_a = nm_a;
    m_b = nm_b;
  }
  const float inv_a = 1.f / quad_sum(l_a);
  const float inv_b = 1.f / quad_sum(l_b);
  zero_acc(o);
  for (int c0 = 0; c0 < n_pad; c0 += kKc) {
    float s[kKc / 8][4];
    masked_scores(s, qf, k_s, c0, n, g, t);
#pragma unroll
    for (int nt = 0; nt < kKc / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - m_a) * inv_a;
      s[nt][1] = __expf(s[nt][1] - m_a) * inv_a;
      s[nt][2] = __expf(s[nt][2] - m_b) * inv_b;
      s[nt][3] = __expf(s[nt][3] - m_b) * inv_b;
    }
    mma_acc_tile(o, s, v_s, c0, L);
  }
}

// Rows r0 + g and r0 + g + 8 of a 16 x 64 fp32 accumulator -> bf16, row stride
// `stride`; rows at or past `limit` are not written.
__device__ __forceinline__ void store_rows(bf16* dst, int stride,
                                           const float (&acc)[kHeadDim / 8][4], int r0, int limit,
                                           int g, int t) {
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (r0 + g < limit)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r0 + g) * stride + col) =
          pack_bf16(acc[nd][0], acc[nd][1]);
    if (r0 + g + 8 < limit)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r0 + g + 8) * stride + col) =
          pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

// q, k, v of head h for the n rows of one image:
//   bf16(bf16(LN(x)) . Wqkv[:, the head's 3 x 64 columns] + bias)
// into three (n_pad, 64) tiles in shared memory, rows [n, n_pad) zero. With
// kScaleQ the stored q is bf16(q * q_scale), the operand of the score product.
// Row tiles of kARows rows are normalised into a_s ([kARows][kAStride]); the
// weight columns stream through w_bufs ([2][kWChunk][kWStride]). The first
// 4 * kColGroups warps each own 16 rows x 192 / kColGroups columns of a tile's
// product; the others only help with the staging. `ln_copy` (device memory,
// the image's (n, D) rows), where not null, takes bf16 LN(x). Ends with a
// block barrier: the tiles are whole and a_s, w_bufs are free.
template <int kColGroups, bool kScaleQ>
__device__ __forceinline__ void qkv_head_gemm(
    const bf16* __restrict__ x_img, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
    int h, int n, int n_pad, float eps, float q_scale, bf16* a_s, bf16* w_bufs, bf16* q_s,
    bf16* k_s, bf16* v_s, bf16* ln_copy) {
  constexpr int kColsPerWarp = kHeadCols / kColGroups;
  constexpr int kNt = kColsPerWarp / 8;
  static_assert(kNt % 2 == 0, "n-tiles are loaded in pairs");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / kColGroups, cgp = warp % kColGroups;
  const bool in_gemm = warp < 4 * kColGroups;
  const Lane L(lane);
  const int n_tiles = (n + kARows - 1) / kARows;
  const int total = n_tiles * kWChunks;

  auto stage_w = [&](int chunk) {  // chunks count on across the row tiles
    const int k0 = (chunk % kWChunks) * kWChunk;
    bf16* dst = w_bufs + (chunk & 1) * kWChunk * kWStride;
    constexpr int kPieces = kHeadCols / 8;  // 16-byte pieces per row
    for (int idx = threadIdx.x; idx < kWChunk * kPieces; idx += blockDim.x) {
      const int r = idx / kPieces, piece = idx % kPieces;
      const int which = piece / (kHeadDim / 8), c8 = piece % (kHeadDim / 8) * 8;
      cp_async_16(dst + r * kWStride + which * kHeadDim + c8,
                  wqkv + static_cast<size_t>(k0 + r) * (3 * kD) + which * kD + h * kHeadDim + c8,
                  true);
    }
    cp_async_commit();
  };
  stage_w(0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int row0 = tile * kARows;
    for (int r = warp; r < kARows; r += n_warps) {
      const int row = row0 + r;
      const bool ok = row < n;
      float mean, inv;
      layer_norm_row<kD>(ok ? x_img + static_cast<size_t>(row) * kD : nullptr, gamma, beta, eps,
                         a_s + r * kAStride,
                         ok && ln_copy != nullptr ? ln_copy + static_cast<size_t>(row) * kD
                                                  : nullptr,
                         lane, &mean, &inv);
    }
    float acc[kNt][4];
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int kc = 0; kc < kWChunks; ++kc) {
      const int chunk = tile * kWChunks + kc;
      cp_async_wait<0>();  // this chunk
      __syncthreads();     // ... is whole, as is a_s; nobody reads the other buffer any more
      if (chunk + 1 < total) stage_w(chunk + 1);
      if (in_gemm) {
        const bf16* aa = a_s + rg * 16 * kAStride + kc * kWChunk;
        const bf16* wb = w_bufs + (chunk & 1) * kWChunk * kWStride + cgp * kColsPerWarp;
#pragma unroll
        for (int kk = 0; kk < kWChunk / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, L.a_rows(aa + kk * 16, kAStride));
#pragma unroll
          for (int nt = 0; nt < kNt; nt += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, L.b_kn(wb + kk * 16 * kWStride + nt * 8, kWStride));
            mma_16816(acc[nt], af, b[0], b[1]);
            mma_16816(acc[nt + 1], af, b[2], b[3]);
          }
        }
      }
    }
    if (in_gemm) {
      const int ra = row0 + rg * 16 + g, rb = ra + 8;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int c = cgp * kColsPerWarp + nt * 8 + 2 * t;  // within the head's 192
        const int which = c / kHeadDim, hd = c % kHeadDim;
        const float2 bv = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(bqkv + which * kD + h * kHeadDim + hd));
        float a0 = round_bf16(acc[nt][0] + bv.x), a1 = round_bf16(acc[nt][1] + bv.y);
        float b0 = round_bf16(acc[nt][2] + bv.x), b1 = round_bf16(acc[nt][3] + bv.y);
        if (kScaleQ && which == 0) {
          a0 *= q_scale; a1 *= q_scale; b0 *= q_scale; b1 *= q_scale;
        }
        bf16* dst = (which == 0 ? q_s : which == 1 ? k_s : v_s) + hd;
        if (ra < n_pad)
          *reinterpret_cast<uint32_t*>(dst + ra * kTStride) = ra < n ? pack_bf16(a0, a1) : 0u;
        if (rb < n_pad)
          *reinterpret_cast<uint32_t*>(dst + rb * kTStride) = rb < n ? pack_bf16(b0, b1) : 0u;
      }
    }
    __syncthreads();  // a_s is free for the next tile
  }
}

// ---------------------------------------------------------------------------
// forward: a cluster of kHeads blocks per image
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kFwdWarps * 32, 1)
attn_block_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const bf16* __restrict__ wqkv,
                      const bf16* __restrict__ bqkv, const bf16* __restrict__ wp,
                      const bf16* __restrict__ bp, bf16* __restrict__ y, int n, int n_pad,
                      float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [n_pad][kTStride]: scaled q, then o
  bf16* k_s = q_s + n_pad * kTStride;
  bf16* v_s = k_s + n_pad * kTStride;
  bf16* work = v_s + n_pad * kTStride;
  bf16* a_s = work;                               // the qkv product's row tile
  bf16* w_bufs = a_s + kARows * kAStride;         // ... and weight chunks
  bf16* wp_s = work;                              // then Wproj[:, 64h ..]: [kD][kTStride]

  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x;                       // the block's rank in its cluster
  const size_t img = blockIdx.y;
  const bf16* x_img = x + img * n * kD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Lane L(lane);

  qkv_head_gemm<kFwdWarps / 4, true>(x_img, gamma, beta, wqkv, bqkv, h, n, n_pad, eps, scale, a_s,
                                     w_bufs, q_s, k_s, v_s, nullptr);
  // Wproj's 64 columns land while the attention runs
  stage_rows(wp_s, kTStride, wp + h * kHeadDim, kD, 0, kD, kD, kHeadDim);
  cp_async_commit();

  for (int r0 = warp * 16; r0 < n; r0 += kFwdWarps * 16) {
    uint32_t qf[kHeadDim / 16][4];
    tile_a_frags(qf, q_s, r0, L);
    float o[kHeadDim / 8][4];
    attention_rows(o, qf, k_s, v_s, n, n_pad, g, t, L);
    __syncwarp();
    store_rows(q_s, kTStride, o, r0, n_pad, g, t);  // only this warp read these rows of q
  }
  cp_async_wait<0>();
  cluster.sync();  // every head's o is whole in its block's q tile, and wp_s in this one

  for (int r0 = warp * 16; r0 < n; r0 += kFwdWarps * 16) {
    float acc[kHeadDim / 8][4];
    zero_acc(acc);
    for (int hh = 0; hh < kHeads; ++hh) {
      const bf16* o_r = cluster.map_shared_rank(q_s, hh) + (r0 + g) * kTStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const uint32_t af[4] = {
            *reinterpret_cast<const uint32_t*>(o_r + kk * 16),
            *reinterpret_cast<const uint32_t*>(o_r + 8 * kTStride + kk * 16),
            *reinterpret_cast<const uint32_t*>(o_r + kk * 16 + 8),
            *reinterpret_cast<const uint32_t*>(o_r + 8 * kTStride + kk * 16 + 8)};
        const bf16* wb = L.b_kn(wp_s + (hh * kHeadDim + kk * 16) * kTStride, kTStride);
#pragma unroll
        for (int nd = 0; nd < kHeadDim / 8; nd += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, wb + nd * 8);
          mma_16816(acc[nd], af, b[0], b[1]);
          mma_16816(acc[nd + 1], af, b[2], b[3]);
        }
      }
    }
    // y = x + bf16(o . Wproj + bproj), the sum in bf16
#pragma unroll
    for (int nd = 0; nd < kHeadDim / 8; ++nd) {
      const int col = h * kHeadDim + nd * 8 + 2 * t;
      const float2 bv = unpack_bf16(*reinterpret_cast<const uint32_t*>(bp + col));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row < n) {
          const size_t at = (img * n + row) * kD + col;
          const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + at));
          *reinterpret_cast<uint32_t*>(y + at) =
              pack_bf16(xv.x + round_bf16(acc[nd][2 * half] + bv.x),
                        xv.y + round_bf16(acc[nd][2 * half + 1] + bv.y));
        }
      }
    }
  }
  cluster.sync();  // no block leaves while a neighbour still reads its o
}

cudaError_t fwd_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int batch, int n_pad,
                       cudaStream_t stream) {
  const int smem = fwd_smem_bytes(n_pad);
  cudaError_t err = cudaFuncSetAttribute(attn_block_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kHeads, batch);
  cfg->blockDim = dim3(kFwdWarps * 32);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kHeads;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// backward 1: a block per (image, head) -> o, dqkv (bf16), column sums of dqkv
// ---------------------------------------------------------------------------

// Adds the two rows a thread holds of a 16 x 64 accumulator to its column sums.
__device__ __forceinline__ void add_cols(float (&cs)[kHeadDim / 8][2],
                                         const float (&acc)[kHeadDim / 8][4]) {
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) {
    cs[nd][0] += acc[nd][0] + acc[nd][2];
    cs[nd][1] += acc[nd][1] + acc[nd][3];
  }
}

// A warp's column sums -> dst[64]: over the eight row lanes, then one writer.
__device__ __forceinline__ void store_cols(float* dst, float (&cs)[kHeadDim / 8][2], int g,
                                           int t) {
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[nd][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (g == 0) dst[nd * 8 + 2 * t + e] = v;
    }
  }
}

__global__ void __launch_bounds__(kBwdWarps * 32, 1)
attn_block_bwd_head_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
                           const bf16* __restrict__ wp, bf16* __restrict__ o_work,
                           bf16* __restrict__ dqkv_work, float* __restrict__ dbqkv_part, int n,
                           int n_pad, float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = n_pad * kTStride;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // unscaled q
  bf16* k_s = q_s + tile;
  bf16* v_s = k_s + tile;
  bf16* work = v_s + tile;
  bf16* a_s = work;                        // step 1: the qkv product's row tile
  bf16* w_bufs = a_s + kARows * kAStride;  // ... and weight chunks
  bf16* g_s = work;                        // from step 3: do of this head
  bf16* wp_s = g_s + tile;                 // step 3: Wproj[64h .. 64h + 63, :], [64][kAStride]
  bf16* qs_s = g_s + tile;                 // after it: scaled q
  float* t_s = reinterpret_cast<float*>(qs_s + tile);  // [n_pad] t_i
  float* m_s = t_s + n_pad;                            // [n_pad] row max
  float* il_s = m_s + n_pad;                           // [n_pad] 1 / row sum
  float* col_s = il_s + n_pad;                         // [kBwdWarps][kHeadCols] column sums

  const int h = blockIdx.x;
  const size_t img = blockIdx.y;
  const bf16* x_img = x + img * n * kD;
  const bf16* dy_img = dy + img * n * kD;
  bf16* dq_dst = dqkv_work + img * n * (3 * kD) + h * kHeadDim;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Lane L(lane);

  // ---- step 1: q, k, v of this head ----
  qkv_head_gemm<kBwdGemmColGroups, false>(x_img, gamma, beta, wqkv, bqkv, h, n, n_pad, eps, 1.f,
                                          a_s, w_bufs, q_s, k_s, v_s, nullptr);

  // ---- step 2: o of this head, for dWproj; 64 rows of Wproj land meanwhile ----
  stage_rows(wp_s, kAStride, wp + static_cast<size_t>(h) * kHeadDim * kD, kD, 0, kHeadDim,
             kHeadDim, kD);
  cp_async_commit();
  for (int r0 = warp * 16; r0 < n; r0 += kBwdWarps * 16) {
    uint32_t qf[kHeadDim / 16][4];
    tile_a_frags(qf, q_s, r0, L);
    scale_frags(qf, scale);
    float o[kHeadDim / 8][4];
    attention_rows(o, qf, k_s, v_s, n, n_pad, g, t, L);
    store_rows(o_work + img * n * kD + h * kHeadDim, kD, o, r0, n, g, t);
  }
  cp_async_wait<0>();
  __syncthreads();  // wp_s is whole (g_s's room was free since step 1 ended)

  // ---- step 3: do[:, 64h ..] = bf16(dy . Wproj[64h .., :]^T), dy rows from device memory ----
  for (int r0 = warp * 16; r0 < n_pad; r0 += kBwdWarps * 16) {
    float acc[kHeadDim / 8][4];
    zero_acc(acc);
    const int row_a = r0 + g, row_b = row_a + 8;
    const bf16* pa = dy_img + static_cast<size_t>(row_a) * kD + 2 * t;
    const bf16* pb = dy_img + static_cast<size_t>(row_b) * kD + 2 * t;
#pragma unroll 4
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t af[4] = {0u, 0u, 0u, 0u};
      if (row_a < n) {
        af[0] = *reinterpret_cast<const uint32_t*>(pa + kk * 16);
        af[2] = *reinterpret_cast<const uint32_t*>(pa + kk * 16 + 8);
      }
      if (row_b < n) {
        af[1] = *reinterpret_cast<const uint32_t*>(pb + kk * 16);
        af[3] = *reinterpret_cast<const uint32_t*>(pb + kk * 16 + 8);
      }
#pragma unroll
      for (int nd = 0; nd < kHeadDim / 8; nd += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, L.b_nk(wp_s + nd * 8 * kAStride + kk * 16, kAStride));
        mma_16816(acc[nd], af, b[0], b[1]);
        mma_16816(acc[nd + 1], af, b[2], b[3]);
      }
    }
    store_rows(g_s, kTStride, acc, r0, n_pad, g, t);  // rows at or past n are zero
  }
  __syncthreads();  // g_s is whole; wp_s has been read: its room takes scaled q and the sums

  for (int idx = threadIdx.x; idx < n_pad * (kHeadDim / 2); idx += blockDim.x) {
    const int at = idx / (kHeadDim / 2) * kTStride + idx % (kHeadDim / 2) * 2;
    const float2 v = unpack_bf16(*reinterpret_cast<const uint32_t*>(q_s + at));
    *reinterpret_cast<uint32_t*>(qs_s + at) = pack_bf16(v.x * scale, v.y * scale);
  }
  for (int i = threadIdx.x; i < 3 * n_pad; i += blockDim.x) t_s[i] = 0.f;
  __syncthreads();

  // ---- phase A of mha_qkv_bwd.cu: 16 queries per warp against all keys -> t, m, 1/l, dQ ----
  float cs_q[kHeadDim / 8][2];
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) cs_q[nd][0] = cs_q[nd][1] = 0.f;
  for (int r0 = warp * 16; r0 < n; r0 += kBwdWarps * 16) {
    const int row_a = r0 + g, row_b = row_a + 8;
    uint32_t gf[kHeadDim / 16][4], qf[kHeadDim / 16][4];
    tile_a_frags(gf, g_s, r0, L);
    tile_a_frags(qf, qs_s, r0, L);

    // Walk 1: the row max and sum, and t_i = sum_j p_ij dP_ij carried under the running max.
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f, u_a = 0.f, u_b = 0.f;
    for (int c0 = 0; c0 < n_pad; c0 += kKc) {
      float p[kKc / 8][4], dp[kKc / 8][4];
      mma_a_tile_t(dp, gf, v_s, c0, g, t);
      masked_scores(p, qf, k_s, c0, n, g, t);
      float cm_a = kNegInf, cm_b = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kKc / 8; ++nt) {
        cm_a = fmaxf(cm_a, fmaxf(p[nt][0], p[nt][1]));
        cm_b = fmaxf(cm_b, fmaxf(p[nt][2], p[nt][3]));
      }
      const float nm_a = fmaxf(m_a, quad_max(cm_a));
      const float nm_b = fmaxf(m_b, quad_max(cm_b));
      float sa = 0.f, sb = 0.f, ua = 0.f, ub = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKc / 8; ++nt) {
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
    const float il_a = 1.f / quad_sum(l_a), il_b = 1.f / quad_sum(l_b);
    const float t_a = quad_sum(u_a) * il_a, t_b = quad_sum(u_b) * il_b;
    if (t == 0) {  // row_a, row_b < n_pad always
      t_s[row_a] = t_a;
      t_s[row_b] = t_b;
      m_s[row_a] = m_a;
      m_s[row_b] = m_b;
      il_s[row_a] = il_a;
      il_s[row_b] = il_b;
    }

    // Walk 2: dS = p (dP - t) scale, dQ += dS . K.
    float dq[kHeadDim / 8][4];
    zero_acc(dq);
    for (int c0 = 0; c0 < n_pad; c0 += kKc) {
      float p[kKc / 8][4], dp[kKc / 8][4];
      mma_a_tile_t(dp, gf, v_s, c0, g, t);
      masked_scores(p, qf, k_s, c0, n, g, t);
#pragma unroll
      for (int nt = 0; nt < kKc / 8; ++nt) {
        p[nt][0] = __expf(p[nt][0] - m_a) * il_a * (dp[nt][0] - t_a) * scale;
        p[nt][1] = __expf(p[nt][1] - m_a) * il_a * (dp[nt][1] - t_a) * scale;
        p[nt][2] = __expf(p[nt][2] - m_b) * il_b * (dp[nt][2] - t_b) * scale;
        p[nt][3] = __expf(p[nt][3] - m_b) * il_b * (dp[nt][3] - t_b) * scale;
      }
      mma_acc_tile(dq, p, k_s, c0, L);
    }
    store_rows(dq_dst, 3 * kD, dq, r0, n, g, t);
    add_cols(cs_q, dq);  // rows at or past n hold exact zeros: their do is zero
  }
  store_cols(col_s + warp * kHeadCols, cs_q, g, t);
  __syncthreads();  // t, m, 1/l of every row

  // ---- phase B: 16 keys per warp against all queries -> dK, dV ----
  float cs_k[kHeadDim / 8][2], cs_v[kHeadDim / 8][2];
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd)
    cs_k[nd][0] = cs_k[nd][1] = cs_v[nd][0] = cs_v[nd][1] = 0.f;
  for (int j0 = warp * 16; j0 < n; j0 += kBwdWarps * 16) {
    const int key_a = j0 + g, key_b = key_a + 8;
    uint32_t vf[kHeadDim / 16][4], kf[kHeadDim / 16][4];
    tile_a_frags(vf, v_s, j0, L);
    tile_a_frags(kf, k_s, j0, L);
    float dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
    zero_acc(dk);
    zero_acc(dv);
    for (int i0 = 0; i0 < n_pad; i0 += kKc) {
      // transposed tiles: rows are this warp's keys, columns the queries
      float pt[kKc / 8][4], dpt[kKc / 8][4];
      mma_a_tile_t(dpt, vf, g_s, i0, g, t);
      mma_a_tile_t(pt, kf, qs_s, i0, g, t);
#pragma unroll
      for (int nt = 0; nt < kKc / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + nt * 8 + 2 * t + (e & 1);
          const int key = e < 2 ? key_a : key_b;
          float p = 0.f;
          if (i < n && key < n) p = __expf(pt[nt][e] - m_s[i]) * il_s[i];
          pt[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - t_s[i]) * scale;  // dS^T
        }
      }
      mma_acc_tile(dv, pt, g_s, i0, L);
      mma_acc_tile(dk, dpt, q_s, i0, L);
    }
    store_rows(dq_dst + kD, 3 * kD, dk, j0, n, g, t);
    store_rows(dq_dst + 2 * kD, 3 * kD, dv, j0, n, g, t);
    add_cols(cs_k, dk);  // keys at or past n hold exact zeros: their p is zero
    add_cols(cs_v, dv);
  }
  store_cols(col_s + warp * kHeadCols + kHeadDim, cs_k, g, t);
  store_cols(col_s + warp * kHeadCols + 2 * kHeadDim, cs_v, g, t);
  __syncthreads();

  // dbqkv of this image and head from the fp32, unrounded dqkv: warps in order
  if (threadIdx.x < kHeadCols) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += col_s[w * kHeadCols + threadIdx.x];
    const int which = threadIdx.x / kHeadDim, hd = threadIdx.x % kHeadDim;
    dbqkv_part[img * (3 * kD) + which * kD + h * kHeadDim + hd] = s;
  }
}

bool shape_ok(int batch, int n, int d, int num_heads) {
  return batch >= 1 && batch <= 65535 && n >= 1 && n <= kMaxSeq && d == kD &&
         num_heads == kHeads;
}

int pad_seq(int n) { return (n + kKc - 1) / kKc * kKc; }

}  // namespace

extern "C" {

// The longest sequence the two kernels take at embedding width d with
// d / 64 heads; 0 for a width they are not built for.
int tpuwsi_attn_block_max_seq(int d) { return d == kD ? kMaxSeq : 0; }

// How many clusters of the forward (d / 64 blocks, one image of n tokens each)
// the card can hold at once; 0 means the forward cannot launch. Negative: a
// CUDA error code, negated.
int tpuwsi_attn_block_max_clusters(int n) {
  if (n < 1 || n > kMaxSeq) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = fwd_config(&cfg, &attr, 1, pad_seq(n), nullptr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, attn_block_fwd_kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}

// Every tensor is contiguous and 16-byte aligned (fp32 vectors 8-byte), bf16
// unless said otherwise. x, y, dy, dx: (batch, n, d); gamma, beta: (d,) fp32;
// wqkv: (d, 3 d), columns [which(3), head, 64]; bqkv: (3 d,); wp: (d, d);
// bp: (d,). d = 384, num_heads = 6, 1 <= n <= tpuwsi_attn_block_max_seq(d).
int tpuwsi_attn_block_fwd(const void* x, const void* gamma, const void* beta, const void* wqkv,
                          const void* bqkv, const void* wp, const void* bp, void* y, int batch,
                          int n, int d, int num_heads, float scale, float eps, void* stream) {
  if (!shape_ok(batch, n, d, num_heads)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int n_pad = pad_seq(n);
  cudaError_t err = fwd_config(&cfg, &attr, batch, n_pad, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, attn_block_fwd_kernel, static_cast<const bf16*>(x),
                           static_cast<const float*>(gamma), static_cast<const float*>(beta),
                           static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
                           static_cast<const bf16*>(wp), static_cast<const bf16*>(bp),
                           static_cast<bf16*>(y), n, n_pad, scale, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Gradients of the above at the cotangent dy. grads (out), fp32:
//   dWqkv (d, 3 d) | 3 d values of no use | dWproj (d, d) | dbproj (d) |
//   dgamma (d) | dbeta (d) | dbqkv (3 d)
// (the weight-gradient kernel also sums the ROUNDED dqkv; dbqkv, the last
// piece, is the sum of the unrounded one). Workspaces, contents undefined on
// entry: dqkv_work (batch, n, 3 d), o_work and ln_work (batch, n, d) bf16;
// dbqkv_part (batch, 3 d), w_part_qkv (groups_qkv, d 3 d + 3 d), w_part_proj
// (groups_proj, d d + d) and row_part (ceil(batch n / tpuwsi_mlp_rows_per_tile
// (d)), 2 d) fp32; each number of row groups between 1 and
// ceil(batch n / tpuwsi_dense_rows_per_step(d)).
int tpuwsi_attn_block_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
                          const void* wqkv, const void* bqkv, const void* wp, void* dx,
                          void* grads, void* dqkv_work, void* o_work, void* ln_work,
                          void* dbqkv_part, void* w_part_qkv, void* w_part_proj, void* row_part,
                          int batch, int n, int d, int num_heads, int groups_qkv,
                          int groups_proj, float scale, float eps, void* stream_) {
  using T = Tile<kD>;
  using S = DwSlice<kD>;
  if (!shape_ok(batch, n, d, num_heads)) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows_ll = static_cast<long long>(batch) * n;
  if (rows_ll * 3 * kD >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = static_cast<int>(rows_ll);
  const int max_groups = (rows + S::kRows - 1) / S::kRows;
  if (groups_qkv < 1 || groups_qkv > max_groups || groups_proj < 1 || groups_proj > max_groups ||
      groups_qkv > 65535 || groups_proj > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* dyp = static_cast<const bf16*>(dy);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bep = static_cast<const float*>(beta);
  const auto* wq = static_cast<const bf16*>(wqkv);
  auto* dqkv = static_cast<bf16*>(dqkv_work);
  auto* o = static_cast<bf16*>(o_work);
  auto* ln = static_cast<bf16*>(ln_work);
  float* out = static_cast<float*>(grads);

  const int n_pad = pad_seq(n);
  const int head_smem = bwd_smem_bytes(n_pad);
  cudaError_t err = cudaFuncSetAttribute(attn_block_bwd_head_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, head_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_block_bwd_head_kernel<<<dim3(kHeads, batch), kBwdWarps * 32, head_smem, stream>>>(
      xp, dyp, gp, bep, wq, static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wp), o, dqkv,
      static_cast<float*>(dbqkv_part), n, n_pad, scale, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // dln = dqkv . Wqkv^T, LayerNorm backward, dx = bf16(dy + dx_ln); LN(x) -> ln_work
  auto dx_kernel = dense_bwd_dx_kernel<kD, true, true>;
  constexpr int kDxSmem = dx_smem_bytes<kD, true>();
  err = cudaFuncSetAttribute(dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_row_tiles = (rows + T::kRows - 1) / T::kRows;
  dx_kernel<<<n_row_tiles, T::kThreads, kDxSmem, stream>>>(
      xp, dqkv, gp, bep, wq, dyp, static_cast<bf16*>(dx), ln, static_cast<float*>(row_part), rows,
      3 * kD, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // dWqkv = LN(x)^T . dqkv;  dWproj = o^T . dy, dbproj = sum dy
  auto dw_kernel = dense_bwd_dw_kernel<kD>;
  err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::smem_bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<<<dim3(3 * kD / S::kNs, groups_qkv), S::kThreads, S::smem_bytes(), stream>>>(
      ln, dqkv, static_cast<float*>(w_part_qkv), rows, 3 * kD);
  dw_kernel<<<dim3(kD / S::kNs, groups_proj), S::kThreads, S::smem_bytes(), stream>>>(
      o, dyp, static_cast<float*>(w_part_proj), rows, kD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n_qkv = static_cast<long long>(kD) * 3 * kD + 3 * kD;
  const long long n_proj = static_cast<long long>(kD) * kD + kD;
  auto sum = [&](const void* part, float* dst, int n_parts, long long count) {
    sum_partials_kernel<float><<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(part), dst, n_parts, count);
  };
  sum(w_part_qkv, out, groups_qkv, n_qkv);
  sum(w_part_proj, out + n_qkv, groups_proj, n_proj);
  sum(row_part, out + n_qkv + n_proj, n_row_tiles, 2LL * kD);
  sum(dbqkv_part, out + n_qkv + n_proj + 2 * kD, batch, 3LL * kD);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
