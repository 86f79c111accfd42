// Whole-sequence multi-head attention from the fused qkv projection, bf16.
//
// Replaces the TPU kernel tpuwsi/ops/attention.py:633 `_mha_qkv_kernel`
// (reached through `_mha_qkv_forward`, :695). Same contract:
//   qkv (B, N, 3D) bf16, columns laid out [which(3), head, hd]  ->  o (B, N, D) bf16
//   - q is scaled in fp32 and rounded back to bf16 before the dot product;
//   - scores are fp32 dots; key j is masked (finite NEG_INF) when j >= N, and
//     when j / block_len != i / block_len for 0 < block_len < N (sequence
//     packing: several independent sub-sequences share the sequence axis);
//   - the softmax over keys is fp32 with the exact row max and row sum, and
//     the normalised p is rounded to bf16 before p.V, which accumulates in fp32.
//
// What bounds it on an H100. At the serving shape (ViT-S/16 at 256 px:
// B=500, N=257, H=6, hd=64) the kernel must read qkv once (B*N*3D*2 = 296 MB)
// and write o (B*N*D*2 = 99 MB); the tensor work is B*H*2*N*N*hd*2 = 51 GFLOP
// for QK^T and P.V together, and the softmax needs B*H*N*N = 198 M
// exponentials. That is ~130 FLOP per byte moved, below the card's ~295
// FLOP/byte ridge, so an ideal kernel that streams qkv once is bounded by
// device memory. This one repeats QK^T and the exponentials (below), 76 GFLOP
// and 396 M exponentials in all, which brings mma issue and the special-function
// units close to that bound as well. The TPU design (all H score matrices as
// one (H*S, S) fp32 block in VMEM) does not fit a Hopper SM, which has 227 KB
// of shared memory.
//
// What this design does about it:
//   - one block per (head, batch element): K and V of the head (<= 512 keys)
//     are staged once in shared memory with plain 16-byte copies, so qkv is
//     read from device memory once; rows are padded to 72 bf16 so that the
//     fragment loads (32-bit for K, ldmatrix.trans for V) are free of bank
//     conflicts;
//   - the block's warps share the query rows in groups of 16, at most two
//     groups per warp, so a 257-token head runs 9 warps and wastes 15 rows;
//   - a warp never materialises scores in memory: it keeps 16 rows x 32 keys
//     of scores in registers (mma.sync m16n8k16, bf16 in, fp32 accumulate);
//   - two passes over the keys: the first finds each row's max and sum, the
//     second recomputes the scores and forms the normalised p exactly as the
//     TPU kernel does, then feeds p straight from the score registers into
//     the P.V product (the accumulator layout of one mma is the A-operand
//     layout of the next). The second pass repeats QK^T and the exponentials
//     so the numbers follow the reference's normalise-then-round order; an
//     online-softmax single pass is a later optimisation;
//   - rows past N are neither read nor written: loads are guarded instead of
//     zeroing an out-of-bounds block as the TPU kernel does.
//
// The same kernel with kSaveP also replaces tpuwsi/ops/attention.py:852
// `_mha_qkv_kernel_saved` (the training forward under attn_save_probs): it
// writes the normalised bf16 p, the very registers that multiply V, to
// probs (B, H, N, p_stride), queries on rows, so forward and backward see
// one p. Masked entries and the pad columns [N, p_stride) come out as exact
// zeros (exp of the finite NEG_INF underflows). The TPU kernel's layout
// (keys on rows, 128-padded) is a TPU tiling choice and is not carried over.
// p adds B*H*N*p_stride*2 bytes of writes (94 MB at the DINO student-global
// shape B=192, N=197, H=6, against 87 MB read and 29 MB written otherwise),
// so the saved forward is bounded by device memory even more than the plain one.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxWarps = 16;            // 512 threads: two 16-row groups each at N = 511
constexpr int kKeyChunk = 32;            // keys per inner step: 4 n-tiles of 8
constexpr int kStride = kHeadDim + 8;    // bf16 per K/V row in shared memory
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

// Fragment ownership (PTX ISA, mma.m16n8k16): lane = 4*g + t. A thread holds
// rows g and g+8 of the 16-row tile; of an 8-column accumulator tile it holds
// columns 2t and 2t+1 (regs 0,1 for row g; regs 2,3 for row g+8).
template <bool kSaveP>
__global__ void __launch_bounds__(kMaxWarps * 32)
mha_qkv_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                   __nv_bfloat16* __restrict__ out,
                   __nv_bfloat16* __restrict__ probs, int p_stride, int n, int d,
                   int n_pad, float scale, int block_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [n_pad][kStride]
  __nv_bfloat16* vs = ks + n_pad * kStride;                     // [n_pad][kStride]

  const int h = blockIdx.x;
  const int d3 = 3 * d;
  const __nv_bfloat16* src = qkv + static_cast<size_t>(blockIdx.y) * n * d3;
  __nv_bfloat16* dst = out + static_cast<size_t>(blockIdx.y) * n * d + h * kHeadDim;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // K and V of head h -> shared memory, 16 bytes per copy; keys >= n are zero.
  for (int idx = threadIdx.x; idx < n_pad * (kHeadDim / 8); idx += blockDim.x) {
    const int j = idx >> 3, col = (idx & 7) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (j < n) {
      const __nv_bfloat16* row = src + static_cast<size_t>(j) * d3 + h * kHeadDim + col;
      kv = *reinterpret_cast<const uint4*>(row + d);
      vv = *reinterpret_cast<const uint4*>(row + 2 * d);
    }
    *reinterpret_cast<uint4*>(ks + j * kStride + col) = kv;
    *reinterpret_cast<uint4*>(vs + j * kStride + col) = vv;
  }
  __syncthreads();

  const bool packed = block_len > 0 && block_len < n;
  const int n_warps = blockDim.x >> 5;
  // this lane's ldmatrix row for V: matrix lane/8 = (key half, d half)
  const int v_key = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  for (int r0 = (threadIdx.x >> 5) * 16; r0 < n; r0 += n_warps * 16) {
    const int row_a = r0 + g, row_b = r0 + g + 8;

    // q rows of this group as A fragments: fp32 scale, rounded back to bf16.
    uint32_t qf[kHeadDim / 16][4];
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = h * kHeadDim + kk * 16 + half * 8 + 2 * t;
        float2 qa = make_float2(0.f, 0.f), qb = qa;
        if (row_a < n)
          qa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              src + static_cast<size_t>(row_a) * d3 + col));
        if (row_b < n)
          qb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              src + static_cast<size_t>(row_b) * d3 + col));
        qf[kk][2 * half] = pack_bf16(qa.x * scale, qa.y * scale);
        qf[kk][2 * half + 1] = pack_bf16(qb.x * scale, qb.y * scale);
      }
    }
    const int blk_a = packed ? row_a / block_len : 0;
    const int blk_b = packed ? row_b / block_len : 0;
    // rows of this (batch, head) in probs; dereferenced only for rows < n
    __nv_bfloat16* prow_a = nullptr;
    __nv_bfloat16* prow_b = nullptr;
    if constexpr (kSaveP) {
      const size_t head_row0 = (static_cast<size_t>(blockIdx.y) * gridDim.x + h) * n;
      prow_a = probs + (head_row0 + row_a) * p_stride;
      prow_b = probs + (head_row0 + row_b) * p_stride;
    }

    // Masked fp32 scores of the 16 rows against keys [c0, c0 + kKeyChunk).
    auto scores = [&](int c0, float (&s)[kKeyChunk / 8][4]) {
#pragma unroll
      for (int nt = 0; nt < kKeyChunk / 8; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
          const __nv_bfloat16* kp = ks + (c0 + nt * 8 + g) * kStride + kk * 16 + 2 * t;
          mma_16816(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                    *reinterpret_cast<const uint32_t*>(kp + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c0 + nt * 8 + 2 * t + (e & 1);
          const bool ok = j < n && (!packed || j / block_len == (e < 2 ? blk_a : blk_b));
          if (!ok) s[nt][e] = kNegInf;
        }
      }
    };

    // Pass 1: row max (kept equal across each quad) and per-thread partial sums.
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    for (int c0 = 0; c0 < n_pad; c0 += kKeyChunk) {
      float s[kKeyChunk / 8][4];
      scores(c0, s);
      float cm_a = kNegInf, cm_b = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
        cm_a = fmaxf(cm_a, fmaxf(s[nt][0], s[nt][1]));
        cm_b = fmaxf(cm_b, fmaxf(s[nt][2], s[nt][3]));
      }
      const float nm_a = fmaxf(m_a, quad_max(cm_a));
      const float nm_b = fmaxf(m_b, quad_max(cm_b));
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
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

    // Pass 2: p = exp(s - m) / l rounded to bf16, then o += p . V.
    float o[kHeadDim / 8][4];
#pragma unroll
    for (int nd = 0; nd < kHeadDim / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
    for (int c0 = 0; c0 < n_pad; c0 += kKeyChunk) {
      float s[kKeyChunk / 8][4];
      scores(c0, s);
#pragma unroll
      for (int kk = 0; kk < kKeyChunk / 16; ++kk) {
        const float(&lo)[4] = s[2 * kk];
        const float(&hi)[4] = s[2 * kk + 1];
        const uint32_t pa[4] = {
            pack_bf16(__expf(lo[0] - m_a) * inv_a, __expf(lo[1] - m_a) * inv_a),
            pack_bf16(__expf(lo[2] - m_b) * inv_b, __expf(lo[3] - m_b) * inv_b),
            pack_bf16(__expf(hi[0] - m_a) * inv_a, __expf(hi[1] - m_a) * inv_a),
            pack_bf16(__expf(hi[2] - m_b) * inv_b, __expf(hi[3] - m_b) * inv_b)};
        if constexpr (kSaveP) {
          // p_stride is a multiple of 16 and n_pad >= p_stride, so every
          // column below p_stride is written once, in pairs that never
          // straddle it.
          const int j_lo = c0 + kk * 16 + 2 * t, j_hi = j_lo + 8;
          if (row_a < n) {
            if (j_lo < p_stride) *reinterpret_cast<uint32_t*>(prow_a + j_lo) = pa[0];
            if (j_hi < p_stride) *reinterpret_cast<uint32_t*>(prow_a + j_hi) = pa[2];
          }
          if (row_b < n) {
            if (j_lo < p_stride) *reinterpret_cast<uint32_t*>(prow_b + j_lo) = pa[1];
            if (j_hi < p_stride) *reinterpret_cast<uint32_t*>(prow_b + j_hi) = pa[3];
          }
        }
        const __nv_bfloat16* vrow = vs + (c0 + kk * 16 + v_key) * kStride + v_col;
#pragma unroll
        for (int nd = 0; nd < kHeadDim / 8; nd += 2) {
          uint32_t vb[4];  // b0, b1 of n-tile nd, then of nd + 1
          ldmatrix_x4_trans(vb, vrow + nd * 8);
          mma_16816(o[nd], pa, vb[0], vb[1]);
          mma_16816(o[nd + 1], pa, vb[2], vb[3]);
        }
      }
    }

#pragma unroll
    for (int nd = 0; nd < kHeadDim / 8; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (row_a < n)
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_a) * d + col) =
            pack_bf16(o[nd][0], o[nd][1]);
      if (row_b < n)
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_b) * d + col) =
            pack_bf16(o[nd][2], o[nd][3]);
    }
  }
}

template <bool kSaveP>
int launch_fwd(const void* qkv, void* out, void* probs, int p_stride, int batch, int n,
               int num_heads, float scale, int block_len, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || n > kMaxSeq || num_heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kSaveP && (p_stride < n || p_stride % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = num_heads * kHeadDim;
  const int n_pad = (n + kKeyChunk - 1) / kKeyChunk * kKeyChunk;
  const int smem_bytes =
      static_cast<int>(2 * static_cast<size_t>(n_pad) * kStride * sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(
      mha_qkv_fwd_kernel<kSaveP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n + 15) / 16;
  const int warps = (groups + 1) / 2;  // <= kMaxWarps for n <= kMaxSeq
  mha_qkv_fwd_kernel<kSaveP><<<dim3(num_heads, batch), warps * 32, smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(probs), p_stride, n, d, n_pad, scale, block_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv: (batch, n, 3 * num_heads * 64) bf16, contiguous, 16-byte aligned.
// out: (batch, n, num_heads * 64) bf16, contiguous. 1 <= n <= 511.
int tpuwsi_mha_qkv_fwd(const void* qkv, void* out, int batch, int n, int num_heads,
                       float scale, int block_len, void* stream) {
  return launch_fwd<false>(qkv, out, nullptr, 0, batch, n, num_heads, scale, block_len,
                           stream);
}

// As above, and probs: (batch, num_heads, n, p_stride) bf16, contiguous,
// p_stride >= n a multiple of 16; every element of probs is written.
int tpuwsi_mha_qkv_fwd_saved(const void* qkv, void* out, void* probs, int p_stride,
                             int batch, int n, int num_heads, float scale, int block_len,
                             void* stream) {
  return launch_fwd<true>(qkv, out, probs, p_stride, batch, n, num_heads, scale, block_len,
                          stream);
}

const char* tpuwsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
