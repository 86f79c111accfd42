// Tiled attention backward from the saved row statistics, bf16, any sequence
// length: dQ in one kernel, dK and dV in another.
//
// Replaces two TPU kernels of tpuwsi/ops/attention.py (both launched by
// `_flash_backward`, :349):
//   flash_bwd_dq_kernel   :261 `_flash_bwd_dq_kernel`   (pallas_call at :390)
//   flash_bwd_dkv_kernel  :303 `_flash_bwd_dkv_kernel`  (pallas_call at :409)
// Same contract, per (batch element, head), with q, dO (Sq, 64), k, v (Sk, 64),
// lse and delta (Sq,) fp32, where lse = m + log l comes from the forward and
// delta_i = sum_c dO_ic O_ic is computed by the caller outside any kernel:
//   p  = exp((q . k^T) * scale - lse)        fp32, rebuilt tile by tile
//   dP = dO . v^T                            fp32
//   dS = p * (dP - delta) * scale            rounded to bf16
//   dQ = dS . k      dK = dS^T . q           fp32 accumulation
//   dV = bf16(p)^T . dO                      fp32 accumulation
// All keys are valid (the backward takes no key lengths, as in the TPU
// package); rows past Sq or Sk are neither read nor written and contribute
// exact zeros.
//
// The operands are addressed by element strides for batch, head and row, so
// q, k, v may be column blocks of a fused (B, N, 3D) qkv projection, dO a
// (B, N, D) cotangent and dQ, dK, dV column blocks of one (B, N, 3D) dqkv; or
// all may be contiguous (B, H, S, 64) tensors.
//
// What bounds it on an H100. At the DINO step's global views with 448-px
// images (B = 192, H = 6, S = 785) dQ must read q, k, v, dO (463 MB) and
// write dQ (116 MB), 0.17 ms at 3.35 TB/s, against 3 products of
// 2*B*H*S*S*64 = 91 GFLOP each: 0.28 ms at the dense bf16 peak. dK/dV reads
// the same and writes two outputs (0.21 ms) against 4 products: 0.37 ms. Both
// are bound by the tensor cores, and the B*H*S*S = 710 M exponentials of each
// kernel weigh about as much on the special-function units.
//
// What this design does about it. The TPU kernels carry their accumulators in
// VMEM scratch across a sequential innermost grid axis; here that axis is a
// loop inside the block, and the accumulators are registers:
//   - dQ: one block per (b, h, tile of 128 queries), 8 warps of 16 query rows
//     holding q and dO as mma A fragments and a 16 x 64 fp32 dQ; K and V
//     stream through shared memory in tiles of 64 keys (two buffers, cp.async),
//     used 32 keys at a time: s and dP by 32-bit fragment loads of K and V,
//     dS straight from the accumulator registers into dQ += dS . K with K read
//     again through ldmatrix.trans;
//   - dK/dV: one block per (b, h, tile of 128 keys), 8 warps of 16 keys
//     holding k and v as A fragments and two 16 x 64 fp32 accumulators; Q, dO,
//     lse and delta stream through shared memory in tiles of 64 queries. The
//     scores are built transposed (s^T = k . q^T, dP^T = v . dO^T), as the TPU
//     kernel builds them, so p^T and dS^T are already A operands and dO and Q
//     are read through ldmatrix.trans; 16 queries at a time keep the two
//     accumulators and the fragments within 128 registers;
//   - the B operands of s and dP come four 8x8 matrices at a time (ldmatrix),
//     and p = 2^(s scale log2 e - lse log2 e) is one fused multiply-add and
//     one ex2.approx per score;
//   - every output element has one writer: no atomics, deterministic sums;
//   - tile rows past the end are zero-filled by the copy, which makes their
//     terms exact zeros (see the kernels), so the ragged last tile
//     (785 = 12 * 64 + 17) needs no padding and nearly no masking.
// The score and dP products are computed in both kernels (5 + 4 products
// against the 5 a single-pass backward would need); fusing the two is a
// redesign for later, as are wgmma and TMA.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kTileOwn = kWarps * 16;    // rows a block owns: queries (dQ) or keys (dK/dV)
constexpr int kTile = 64;                // rows per streamed shared-memory tile
constexpr int kStride = kHeadDim + 8;    // bf16 per tile row in shared memory
constexpr int kChunkDq = 32;             // keys per inner step of dQ
constexpr int kChunkDkv = 16;            // queries per inner step of dK/dV
constexpr float kLog2e = 1.4426950408889634f;

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

// Rows [row0, row0 + kTile) of a 64-column matrix (row stride `stride`) -> a
// shared-memory tile, asynchronously; rows >= n become zero. n >= 1.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                           long long stride, int row0, int n) {
  for (int idx = threadIdx.x; idx < kTile * (kHeadDim / 8); idx += blockDim.x) {
    const int j = idx >> 3, col = (idx & 7) * 8;
    const bool ok = row0 + j < n;
    cp_async_16(tile + j * kStride + col, src + (ok ? row0 + j : 0) * stride + col, ok);
  }
}

// Rows row_a and row_b of a 64-column matrix in device memory as the four
// k-steps of an mma A operand; rows >= n read as zero.
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[kHeadDim / 16][4],
                                             const __nv_bfloat16* src, long long stride,
                                             int row_a, int row_b, int n, int t) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = kk * 16 + half * 8 + 2 * t;
      uint32_t a = 0u, b = 0u;
      if (row_a < n) a = *reinterpret_cast<const uint32_t*>(src + row_a * stride + col);
      if (row_b < n) b = *reinterpret_cast<const uint32_t*>(src + row_b * stride + col);
      f[kk][2 * half] = a;
      f[kk][2 * half + 1] = b;
    }
  }
}

// acc (16 x kChunk, fp32) = A (16 x 64, fragments) . tile[c0 .. c0 + kChunk)^T,
// the tile holding one row of 64 bf16 per output column.
template <int kChunk>
__device__ __forceinline__ void mma_a_tile_t(float (&acc)[kChunk / 8][4],
                                             const uint32_t (&a)[kHeadDim / 16][4],
                                             const __nv_bfloat16* tile, int c0, int lane) {
  // this lane's ldmatrix row: matrix lane/8 = (column half, n-tile of a pair)
  const int row = (lane & 7) + (lane >> 4) * 8, col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; nt += 2) {
      uint32_t b[4];  // b0, b1 of n-tile nt, then of nt + 1
      ldmatrix_x4(b, tile + (c0 + nt * 8 + row) * kStride + kk * 16 + col);
      mma_16816(acc[nt], a[kk], b[0], b[1]);
      mma_16816(acc[nt + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x 64, fp32) += A (16 x kChunk, bf16 from the fp32 tile x) . tile[c0 .. c0 + kChunk),
// the accumulator layout of x being the A-operand layout of the product.
template <int kChunk>
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
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long stride,
                                           const float (&acc)[kHeadDim / 8][4], int row_a,
                                           int row_b, int n, int t) {
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row_a < n)
      *reinterpret_cast<uint32_t*>(dst + row_a * stride + col) =
          pack_bf16(acc[nd][0], acc[nd][1]);
    if (row_b < n)
      *reinterpret_cast<uint32_t*>(dst + row_b * stride + col) =
          pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

// Fragment ownership (PTX ISA, mma.m16n8k16): lane = 4*g + t. A thread holds
// rows g and g+8 of the 16-row tile; of an 8-column accumulator tile it holds
// columns 2t and 2t+1 (regs 0,1 for row g; regs 2,3 for row g+8).

__global__ void __launch_bounds__(kWarps * 32, 2)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int heads, int sq, int sk, int q_tiles,
                    Strides qs, Strides kvs, Strides dos, Strides dqs, float scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kTile * kStride];

  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x % q_tiles;
  const int b = bh / heads, h = bh % heads;
  const __nv_bfloat16* k_src = k + b * kvs.b + h * kvs.h;
  const __nv_bfloat16* v_src = v + b * kvs.b + h * kvs.h;
  const int n_kt = (sk + kTile - 1) / kTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * kTileOwn + warp * 16;
  const int row_a = r0 + g, row_b = r0 + g + 8;
  const bool active = r0 < sq;  // the same for the whole warp

  stage_tile(k_s[0], k_src, kvs.r, 0, sk);
  stage_tile(v_s[0], v_src, kvs.r, 0, sk);
  cp_async_commit();

  uint32_t qf[kHeadDim / 16][4], gf[kHeadDim / 16][4];
  load_a_frags(qf, q + b * qs.b + h * qs.h, qs.r, row_a, row_b, sq, t);
  load_a_frags(gf, dout + b * dos.b + h * dos.h, dos.r, row_a, row_b, sq, t);
  const float* lse_row = lse + static_cast<size_t>(bh) * sq;
  const float* delta_row = delta + static_cast<size_t>(bh) * sq;
  const bool ok_a = row_a < sq, ok_b = row_b < sq;
  // lse in base-2 units: p = exp(s scale - lse) = 2^(s scale log2 e - lse log2 e)
  const float lse_a = ok_a ? lse_row[row_a] * kLog2e : 0.f;
  const float lse_b = ok_b ? lse_row[row_b] * kLog2e : 0.f;
  const float dl_a = ok_a ? delta_row[row_a] : 0.f, dl_b = ok_b ? delta_row[row_b] : 0.f;
  const float scale_log2 = scale * kLog2e;

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      stage_tile(k_s[buf ^ 1], k_src, kvs.r, (kt + 1) * kTile, sk);
      stage_tile(v_s[buf ^ 1], v_src, kvs.r, (kt + 1) * kTile, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      // Rows past sq hold q = dO = 0 and lse = delta = 0: p = 1, dS = 0, and
      // they are not stored. Keys past sk hold k = v = 0, so whatever dS they
      // get adds dS . 0 to dQ; their p is still set to 0, in the one tile that
      // has such keys, so that a very negative lse cannot make it infinite.
      const bool edge = (kt + 1) * kTile > sk;
#pragma unroll
      for (int c = 0; c < kTile; c += kChunkDq) {
        float s[kChunkDq / 8][4], dp[kChunkDq / 8][4];
        mma_a_tile_t<kChunkDq>(s, qf, k_s[buf], c, lane);
        mma_a_tile_t<kChunkDq>(dp, gf, v_s[buf], c, lane);
#pragma unroll
        for (int nt = 0; nt < kChunkDq / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = kt * kTile + c + nt * 8 + 2 * t + (e & 1);
            float p = exp2_approx(fmaf(s[nt][e], scale_log2, -(e < 2 ? lse_a : lse_b)));
            if (edge && j >= sk) p = 0.f;
            s[nt][e] = p * (dp[nt][e] - (e < 2 ? dl_a : dl_b)) * scale;  // dS
          }
        }
        mma_acc_tile<kChunkDq>(acc, s, k_s[buf], c, lane);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer's twin
  }

  if (active) store_rows(dq + b * dqs.b + h * dqs.h, dqs.r, acc, row_a, row_b, sq, t);
}

__global__ void __launch_bounds__(kWarps * 32, 2)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int heads,
                     int sq, int sk, int k_tiles, Strides qs, Strides kvs, Strides dos,
                     Strides dkvs, float scale) {
  __shared__ __align__(16) __nv_bfloat16 q_s[2][kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 g_s[2][kTile * kStride];
  __shared__ __align__(8) float lse_s[2][kTile];
  __shared__ __align__(8) float delta_s[2][kTile];

  const int bh = blockIdx.x / k_tiles, kt = blockIdx.x % k_tiles;
  const int b = bh / heads, h = bh % heads;
  const __nv_bfloat16* q_src = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* g_src = dout + b * dos.b + h * dos.h;
  const float* lse_row = lse + static_cast<size_t>(bh) * sq;
  const float* delta_row = delta + static_cast<size_t>(bh) * sq;
  const int n_qt = (sq + kTile - 1) / kTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = kt * kTileOwn + warp * 16;
  const int key_a = j0 + g, key_b = j0 + g + 8;
  const bool active = j0 < sk;  // the same for the whole warp
  const float scale_log2 = scale * kLog2e;

  // Q, dO, lse and delta of query tile `tile` -> buffer `buf`; the row
  // statistics by plain loads, visible after the next __syncthreads.
  auto stage = [&](int buf, int tile) {
    stage_tile(q_s[buf], q_src, qs.r, tile * kTile, sq);
    stage_tile(g_s[buf], g_src, dos.r, tile * kTile, sq);
    if (threadIdx.x < 2 * kTile) {
      const int i = tile * kTile + (threadIdx.x & (kTile - 1));
      const float* src = threadIdx.x < kTile ? lse_row : delta_row;
      float* dst = threadIdx.x < kTile ? lse_s[buf] : delta_s[buf];
      // lse in base-2 units: p = exp(s scale - lse) = 2^(s scale log2 e - lse log2 e)
      const float unit = threadIdx.x < kTile ? kLog2e : 1.f;
      dst[threadIdx.x & (kTile - 1)] = i < sq ? src[i] * unit : 0.f;
    }
    cp_async_commit();
  };
  stage(0, 0);

  uint32_t kf[kHeadDim / 16][4], vf[kHeadDim / 16][4];
  load_a_frags(kf, k + b * kvs.b + h * kvs.h, kvs.r, key_a, key_b, sk, t);
  load_a_frags(vf, v + b * kvs.b + h * kvs.h, kvs.r, key_a, key_b, sk, t);

  float acc_k[kHeadDim / 8][4], acc_v[kHeadDim / 8][4];
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) {
    acc_k[nd][0] = acc_k[nd][1] = acc_k[nd][2] = acc_k[nd][3] = 0.f;
    acc_v[nd][0] = acc_v[nd][1] = acc_v[nd][2] = acc_v[nd][3] = 0.f;
  }

  for (int qt = 0; qt < n_qt; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < n_qt) {
      stage(buf ^ 1, qt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      // No mask is needed. Queries past sq hold q = dO = 0 and lse = delta = 0:
      // p = 1 meets dO = 0 in dV and gives dS = 0. Keys past sk are rows of
      // this warp's tiles that are not stored, and rows do not mix.
#pragma unroll
      for (int c = 0; c < kTile; c += kChunkDkv) {
        // transposed tiles: rows are this warp's keys, columns the queries
        float pt[kChunkDkv / 8][4], dpt[kChunkDkv / 8][4];
        mma_a_tile_t<kChunkDkv>(pt, kf, q_s[buf], c, lane);
        mma_a_tile_t<kChunkDkv>(dpt, vf, g_s[buf], c, lane);
#pragma unroll
        for (int nt = 0; nt < kChunkDkv / 8; ++nt) {
          const float2 lse2 = *reinterpret_cast<const float2*>(&lse_s[buf][c + nt * 8 + 2 * t]);
          const float2 dl2 = *reinterpret_cast<const float2*>(&delta_s[buf][c + nt * 8 + 2 * t]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_approx(fmaf(pt[nt][e], scale_log2, -((e & 1) ? lse2.y : lse2.x)));
            pt[nt][e] = p;
            dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dl2.y : dl2.x)) * scale;  // dS^T
          }
        }
        mma_acc_tile<kChunkDkv>(acc_v, pt, g_s[buf], c, lane);
        mma_acc_tile<kChunkDkv>(acc_k, dpt, q_s[buf], c, lane);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer's twin
  }

  if (active) {
    store_rows(dk + b * dkvs.b + h * dkvs.h, dkvs.r, acc_k, key_a, key_b, sk, t);
    store_rows(dv + b * dkvs.b + h * dkvs.h, dkvs.r, acc_v, key_a, key_b, sk, t);
  }
}

// The i-th (b, h, r) triple of the host array of strides.
Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// Blocks for `rows` rows per (batch, head), or 0 where the grid cannot hold them.
long long grid_blocks(int batch, int heads, int rows, int* tiles) {
  *tiles = (rows + kTileOwn - 1) / kTileOwn;
  const long long blocks = static_cast<long long>(batch) * heads * *tiles;
  return blocks > 2147483647LL ? 0 : blocks;
}

}  // namespace

extern "C" {

// q, dout, dq: (batch, heads, sq, 64) bf16; k, v, dk, dv: (batch, heads, sk, 64)
// bf16, each addressed as base + b * stride_b + h * stride_h + row * stride_r
// (+ column); lse, delta: (batch, heads, sq) fp32, contiguous. strides =
// {q; k and v; dout; the gradient(s)}, three each (b, h, r), in elements, every
// stride a multiple of 8 and every base 16-byte aligned.
int tpuwsi_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int batch, int heads,
                        int sq, int sk, const long long* strides, float scale, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  int tiles;
  const long long blocks = grid_blocks(batch, heads, sq, &tiles);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dq_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), heads, sq, sk, tiles, strides_at(strides, 0),
      strides_at(strides, 1), strides_at(strides, 2), strides_at(strides, 3), scale);
  return static_cast<int>(cudaGetLastError());
}

// dk and dv share their strides.
int tpuwsi_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int batch,
                         int heads, int sq, int sk, const long long* strides, float scale,
                         void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  int tiles;
  const long long blocks = grid_blocks(batch, heads, sk, &tiles);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkv_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), heads, sq, sk, tiles,
      strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
      strides_at(strides, 3), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
