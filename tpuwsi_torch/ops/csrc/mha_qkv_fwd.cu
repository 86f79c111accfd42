// Whole-sequence multi-head attention from the fused qkv projection, bf16.
//
// Replaces the TPU kernels tpuwsi/ops/attention.py:633 `_mha_qkv_kernel`
// (reached through `_mha_qkv_forward`) and, with kSaveP,
// tpuwsi/ops/attention.py:852 `_mha_qkv_kernel_saved` (the training forward
// under attn_save_probs). Same contract:
//   qkv (B, N, 3D) bf16, columns laid out [which(3), head, hd]  ->  o (B, N, D) bf16
//   - q is scaled in fp32 and rounded back to bf16 before the dot product;
//   - scores are fp32 dots; key j is masked (finite NEG_INF) when j >= N, and
//     when j / block_len != i / block_len for 0 < block_len < N (sequence
//     packing: several independent sub-sequences share the sequence axis);
//   - the softmax over keys is fp32 with the exact row max and row sum, and
//     the normalised p is rounded to bf16 before p.V, which accumulates in fp32;
//   - with kSaveP the very bf16 p that multiplies V is also written to probs
//     (B, H, N, p_stride), queries on rows, p_stride = N rounded up to 16;
//     masked entries and the pad columns [N, p_stride) are exact zeros (exp of
//     the finite NEG_INF underflows). The TPU kernel's layout (keys on rows,
//     128-padded) is a TPU tiling choice and is not carried over.
//   1 <= N <= 511, head dim 64, any number of heads.
//
// What bounds it on an H100. The kernel must read qkv once and write o (and
// p) once; the tensor work is 4 * B * H * N^2 * 64 operations (QK^T and P.V)
// and the softmax B * H * N^2 exponentials. At the serving shape (ViT-S/16
// at 256 px: B=500, N=257, H=6) that is 296 MB read and 99 MB written, 0.118
// ms at 3.35 TB/s, against 51 GFLOP (0.051 ms at 989 TFLOP/s) and 198 M
// exponentials. At the DINO step's global views with p saved (B=192, N=197,
// H=6): 87 MB read, 29 MB of o and 94 MB of p written, 0.063 ms, against 11
// GFLOP (0.012 ms). Both are bounded by device memory, so the design reads
// qkv once, keeps scores and p on chip, and keeps the loads in flight.
//
// What this design does about it:
//   - one pass over the keys, as the TPU kernel does: a consumer warpgroup
//     owns a 64-query tile of one (image, head) and takes its scores against
//     every key once, four wgmma k16 steps of one wide product (m64n208k16,
//     m64n48k16 up to 48 keys), q and K both from shared memory. A row's
//     scores stay on chip: 208 in registers (104 fp32 a thread) and up to 64
//     more parked in a per-thread stash in shared memory (their own wgmma,
//     m64n64k16). The exact row max and sum come from there; p is
//     normalised, rounded and packed to bf16 pairs, which are the register A
//     operand of the P.V wgmma (m64n64k16 per 16 keys, V MN-major from shared
//     memory): the accumulator layout of one m64 wgmma is the A-fragment
//     layout of the next. QK^T and each exponential run once (the design
//     before ran both twice, to keep the normalise-then-round order without
//     holding a whole score row). 208 scores in registers is what the
//     consumers hold without spilling (ptxas reports 168 registers a thread;
//     272 in registers spilled and serialised the wgmma);
//   - up to 272 keys a warpgroup takes a tile alone, and the two consumer
//     warpgroups walk the tiles independently; from 273 to 511 keys the two
//     share each tile, half of the keys each, trade row maxima and sums
//     through shared memory (the softmax is still the exact one) and add
//     their halves of P.V the same way;
//   - asynchronous staging: a persistent grid (one block of 384 threads per
//     SM) walks the (image, head) items; one producer thread loads K and V of
//     an item, and each 64-row q tile, with TMA through one 3-D tensor map
//     over (B, N, 3D), so rows past N arrive as zeros, into 128-byte swizzled
//     shared memory (one head row is 128 bytes; the wgmma descriptors name the
//     same swizzle). Completion goes to mbarriers. K/V sit in a ring of up to
//     four stages and q in a ring of four tiles, so the next items' loads
//     overlap this item's arithmetic; q is scaled and rounded in place;
//   - p leaves through shared memory: each tile's bf16 p is written to a
//     padded tile, then stored as whole rows with 16-byte coalesced stores
//     (the tile's rows are contiguous in probs). Two warpgroups that share a
//     tile (273+ keys, no main path) store theirs straight to probs.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError(). The tensor map is encoded
// on the host at each launch by cuTensorMapEncodeTiled, which the runtime
// hands out through cudaGetDriverEntryPoint (the library links no libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;                         // q rows of a tile; rows of a TMA box
constexpr uint32_t kBoxBytes = kTile * kHeadDim * 2;  // 8 KB: one box of one head, 128 B a row
constexpr int kMaxSeq = 511;
constexpr int kShortKeys = 48;   // scores a row in registers up to 48 keys (the 37-token views)
constexpr int kRegKeys = 208;    // scores a row in registers beyond that
constexpr int kTailKeys = 64;    // more scores a row, parked in shared memory
constexpr int kWholeKeys = kRegKeys + kTailKeys;  // one warpgroup a tile up to 272 keys
constexpr int kMaxStages = 4;    // K/V ring
constexpr int kMaxQSlots = 4;    // q ring
constexpr int kThreads = 384;    // two consumer warpgroups + one producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kSmemLimit = 232448;
constexpr float kNegInf = -1e30f;  // finite, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* out;
  __nv_bfloat16* probs;
  float scale;
  int n, d, heads, items, tiles, n16, half, p_stride, block_len, stages, qslots;
  uint32_t off_kv, off_p, off_x, off_st, off_bar;  // byte offsets in shared memory
};

using namespace hopper;

// S tiles: D(64 x N) (+)= A(64 x 16) . B(16 x N), A = q and B = K both from
// shared memory, K-major (m64nNk16; N = 48 and 208 for the scores held in
// registers, 64 for those parked in the stash).
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t desc_a, uint64_t desc_b,
                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n208(float (&d)[104], uint64_t desc_a, uint64_t desc_b,
                                        int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int kKeys>
__device__ __forceinline__ void wgmma_scores(float (&d)[kKeys / 2], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  if constexpr (kKeys == 48) {
    wgmma_ss_n48(d, desc_a, desc_b, accumulate);
  } else {
    static_assert(kKeys == 208, "score widths held in registers: 48, 208");
    wgmma_ss_n208(d, desc_a, desc_b, accumulate);
  }
}

// Fragment ownership (wgmma m64nN, PTX ISA): warp w of a warpgroup holds
// rows 16w..16w+15; lane = 4*g + t holds rows 16w+g and 16w+g+8, and of each
// 8-column group of an accumulator, columns 2t and 2t+1 (regs 4i, 4i+1 for
// row g; 4i+2, 4i+3 for row g+8). The register A operand has the layout of
// mma.m16n8k16's, so 16 columns of scores packed to bf16 pairs are the A
// fragment of one k16 step of P.V.
//
// One consumer warpgroup's walk. kWg is the warpgroup (0 or 1) as a template
// argument, so that every condition around a wgmma depends on launch
// parameters alone: ptxas serialises wgmma behind a branch it cannot prove
// uniform. kKeys scores a row are held in registers; with kTail, up to 64
// more go to this thread's own slots of a shared-memory stash (raw, then
// their exponentials) and come back for P.V.
template <bool kSaveP, bool kSplit, int kKeys, bool kTail, int kWg>
__device__ __forceinline__ void consume(const Params& prm, unsigned char* smem, int tid) {
  constexpr int kChunks = kKeys / 16;
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + prm.off_bar;
  const int T = prm.tiles;
  const uint32_t kv_stage_bytes = 2u * T * kBoxBytes;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n = prm.n, bl = prm.block_len;
  const bool packed = bl > 0 && bl < n;
  // this warpgroup's keys: all of them, or one half when the two share a tile;
  // nch chunks of 16 in registers, nst in the stash
  const int key0 = kSplit && kWg == 1 ? prm.half : 0;
  const int nk = kSplit ? (kWg == 0 ? prm.half : prm.n16 - prm.half) : prm.n16;
  const int nch = min(nk, kKeys) / 16;
  const int nst = kTail ? (nk - nch * 16) / 16 : 0;
  const int ps8 = prm.p_stride + 8;  // row of the p tile in shared memory, bf16
  __nv_bfloat16* ptile = reinterpret_cast<__nv_bfloat16*>(smem + prm.off_p) + kWg * kTile * ps8;
  float* xo = reinterpret_cast<float*>(smem + prm.off_x);  // split: 32 x 128 fp32 of P.V
  float* red = xo + 32 * 128;                               // split: [max | sum][wg][64]
  float4* stash = reinterpret_cast<float4*>(smem + prm.off_st) + kWg * (kTailKeys / 8) * 128;
  const int lr_a = warp * 16 + g, lr_b = lr_a + 8;          // this thread's rows of a tile

  int u = 0;
  for (int k = 0, item = blockIdx.x; item < prm.items; ++k, item += gridDim.x) {
    const int b = item / prm.heads, h = item - b * prm.heads;
    const int s = k % prm.stages;
    mbar_wait(bars + 8u * (2 * kMaxQSlots + s), (k / prm.stages) & 1);  // K/V full
    const uint32_t kbase = base + prm.off_kv + s * kv_stage_bytes;
    const uint32_t vbase = kbase + T * kBoxBytes;
    for (int tt = 0; tt < T; ++tt, ++u) {
      if (!kSplit && (u & 1) != kWg) continue;
      const int q = u % prm.qslots;
      mbar_wait(bars + 8u * q, (u / prm.qslots) & 1);  // q full

      // q * scale in fp32, rounded back to bf16, in place: the A operand of S.
      // Elementwise, so the swizzle does not matter; the two warpgroups share
      // the work when they share the tile.
      {
        uint4* qs = reinterpret_cast<uint4*>(smem + q * kBoxBytes);
        const float scale = prm.scale;
        auto scale2 = [scale](uint32_t w) {  // a bf16 is the top half of its fp32
          return pack_bf16(__uint_as_float(w << 16) * scale,
                           __uint_as_float(w & 0xffff0000u) * scale);
        };
#pragma unroll
        for (int i = (kSplit ? kWg * 128 : 0) + tid; i < int(kBoxBytes / 16);
             i += kSplit ? 256 : 128) {
          uint4 v = qs[i];
          v.x = scale2(v.x);
          v.y = scale2(v.y);
          v.z = scale2(v.z);
          v.w = scale2(v.w);
          qs[i] = v;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        named_sync(kSplit ? 1 : 2 + kWg, kSplit ? 256 : 128);
      }

      // Descriptors of this tile's q, K and V; each k16 step and each chunk is
      // a constant away (32 and 2,048 bytes: 2 and 128 in descriptor units).
      const uint64_t qdesc = sw128_desc(opaque(base + q * kBoxBytes));
      const uint64_t kdesc = sw128_desc(opaque(kbase + key0 * 128));
      const uint64_t vdesc = sw128_desc(opaque(vbase + key0 * 128));

      // Mask: key j is valid for row r iff lo(r) <= j < hi(r).
      const int r0 = tt * kTile;
      const int row_a = r0 + lr_a, row_b = r0 + lr_b;
      int lo_a = 0, hi_a = n, lo_b = 0, hi_b = n;
      if (packed) {
        lo_a = row_a / bl * bl;
        hi_a = min(lo_a + bl, n);
        lo_b = row_b / bl * bl;
        hi_b = min(lo_b + bl, n);
      }
      const int lo = max(lo_a, lo_b), hi = min(hi_a, hi_b);
      const int jt = opaque(key0 + 2 * t4);  // this thread's first key column
      // masks this thread's 8 scores of key chunk c where the chunk crosses a bound
      auto mask_chunk = [&](float* v, int c) {
        const int j0 = key0 + 16 * c;
        if (j0 < lo || j0 + 16 > hi) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int j = jt + 16 * c + (e >> 2) * 8 + (e & 1);
            const bool ok = (e & 2) ? (j >= lo_b && j < hi_b) : (j >= lo_a && j < hi_a);
            if (!ok) v[e] = kNegInf;
          }
        }
      };
      float m_a = kNegInf, m_b = kNegInf;
      auto max_chunk = [&](const float* v) {
        m_a = fmaxf(m_a, fmaxf(fmaxf(v[0], v[1]), fmaxf(v[4], v[5])));
        m_b = fmaxf(m_b, fmaxf(fmaxf(v[2], v[3]), fmaxf(v[6], v[7])));
      };

      if constexpr (kTail) {
        // Scores past the first kKeys: masked, their max taken, then parked raw.
        if (nst > 0) {
          float st[kTailKeys / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(st, qdesc + 2 * kk, kdesc + ((kKeys * 128) >> 4) + 2 * kk, kk);
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int i = 0; i < kTailKeys / 2; ++i) reg_fence(st[i]);
#pragma unroll
          for (int c = 0; c < kTailKeys / 16; ++c) {
            if (c < nst) {
              mask_chunk(&st[8 * c], kChunks + c);
              max_chunk(&st[8 * c]);
              stash[(2 * c) * 128 + tid] = make_float4(st[8 * c], st[8 * c + 1], st[8 * c + 2],
                                                       st[8 * c + 3]);
              stash[(2 * c + 1) * 128 + tid] = make_float4(st[8 * c + 4], st[8 * c + 5],
                                                           st[8 * c + 6], st[8 * c + 7]);
            }
          }
        }
      }

      // S = q . K^T for this warpgroup's first kKeys keys, once: four k16 steps.
      float sc[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_scores<kKeys>(sc, qdesc + 2 * kk, kdesc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) reg_fence(sc[i]);
      mbar_arrive(bars + 8u * (kMaxQSlots + q));  // q empty

      // Exact row max and sum over every key of the row.
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c < nch) {
          mask_chunk(&sc[8 * c], c);
          max_chunk(&sc[8 * c]);
        }
      }
      m_a = quad_max(m_a);
      m_b = quad_max(m_b);
      if constexpr (kSplit) {
        if (t4 == 0) {
          red[kWg * 64 + lr_a] = m_a;
          red[kWg * 64 + lr_b] = m_b;
        }
        named_sync(1, 256);
        m_a = fmaxf(red[lr_a], red[64 + lr_a]);
        m_b = fmaxf(red[lr_b], red[64 + lr_b]);
      }
      const float ml_a = m_a * kLog2e, ml_b = m_b * kLog2e;
      float l_a = 0.f, l_b = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c < nch) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float& x = sc[8 * c + e];
            x = exp2_approx(fmaf(x, kLog2e, -((e & 2) ? ml_b : ml_a)));
            if (e & 2) l_b += x; else l_a += x;
          }
        }
      }
      if constexpr (kTail) {
        // x, y of each parked float4 are row a's, z, w row b's
#pragma unroll
        for (int i = 0; i < kTailKeys / 8; ++i) {
          if (i < 2 * nst) {
            float4 v = stash[i * 128 + tid];
            v.x = exp2_approx(fmaf(v.x, kLog2e, -ml_a));
            v.y = exp2_approx(fmaf(v.y, kLog2e, -ml_a));
            v.z = exp2_approx(fmaf(v.z, kLog2e, -ml_b));
            v.w = exp2_approx(fmaf(v.w, kLog2e, -ml_b));
            l_a += v.x + v.y;
            l_b += v.z + v.w;
            stash[i * 128 + tid] = v;
          }
        }
      }
      l_a = quad_sum(l_a);
      l_b = quad_sum(l_b);
      if constexpr (kSplit) {
        if (t4 == 0) {
          red[128 + kWg * 64 + lr_a] = l_a;
          red[128 + kWg * 64 + lr_b] = l_b;
        }
        named_sync(1, 256);
        l_a = red[128 + lr_a] + red[192 + lr_a];
        l_b = red[128 + lr_b] + red[192 + lr_b];
      }
      const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;

      // p normalised, rounded to bf16 pairs: the A fragments of P.V.
      constexpr int kAll = kChunks + (kTail ? kTailKeys / 16 : 0);
      uint32_t pa[kAll][4];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c < nch) {
          const float* x = &sc[8 * c];
          pa[c][0] = pack_bf16(x[0] * inv_a, x[1] * inv_a);
          pa[c][1] = pack_bf16(x[2] * inv_b, x[3] * inv_b);
          pa[c][2] = pack_bf16(x[4] * inv_a, x[5] * inv_a);
          pa[c][3] = pack_bf16(x[6] * inv_b, x[7] * inv_b);
        }
      }
#pragma unroll
      for (int c = kChunks; c < kAll; ++c) {
        if (c - kChunks < nst) {
          const float4 v0 = stash[(2 * (c - kChunks)) * 128 + tid];
          const float4 v1 = stash[(2 * (c - kChunks) + 1) * 128 + tid];
          pa[c][0] = pack_bf16(v0.x * inv_a, v0.y * inv_a);
          pa[c][1] = pack_bf16(v0.z * inv_b, v0.w * inv_b);
          pa[c][2] = pack_bf16(v1.x * inv_a, v1.y * inv_a);
          pa[c][3] = pack_bf16(v1.z * inv_b, v1.w * inv_b);
        }
      }
      // chunk c of this warpgroup is key chunk c (c < nch) or, from kChunks
      // on, key chunk nch + (c - kChunks) with nch = kChunks: the same offset
      auto live = [&](int c) { return c < kChunks ? c < nch : c - kChunks < nst; };
      if constexpr (kSaveP && kSplit) {
        // Two warpgroups that share a tile store their p straight to probs
        // (the tile of a long row does not fit beside K and V in shared memory).
        __nv_bfloat16* prow =
            prm.probs + (static_cast<size_t>(item) * n + r0) * prm.p_stride + key0 + 2 * t4;
        uint32_t* p_a = reinterpret_cast<uint32_t*>(prow + static_cast<size_t>(lr_a) * prm.p_stride);
        uint32_t* p_b = reinterpret_cast<uint32_t*>(prow + static_cast<size_t>(lr_b) * prm.p_stride);
#pragma unroll
        for (int c = 0; c < kAll; ++c) {
          if (live(c)) {
            if (row_a < n) {
              p_a[8 * c] = pa[c][0];
              p_a[8 * c + 4] = pa[c][2];
            }
            if (row_b < n) {
              p_b[8 * c] = pa[c][1];
              p_b[8 * c + 4] = pa[c][3];
            }
          }
        }
      }
      float o[32];
#pragma unroll
      for (int c = 0; c < kAll; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(pa[c][e]);  // packed before the fence
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kAll; ++c)
        if (live(c)) wgmma_n64_mn(o, pa[c], vdesc + 128 * c, c);
      wgmma_commit();

      if constexpr (kSaveP && !kSplit) {
        // While P.V runs: the same bf16 p into the tile's rows in shared
        // memory, to leave as whole rows.
        named_sync(2 + kWg, 128);  // the last tile's rows are out
        const uint32_t pr_a = opaque(smem_u32(ptile) + (lr_a * ps8 + 2 * t4) * 2);
        const uint32_t pr_b = pr_a + 8 * ps8 * 2;
#pragma unroll
        for (int c = 0; c < kAll; ++c) {
          if (live(c)) {
            st_shared_u32(pr_a + 32 * c, pa[c][0]);
            st_shared_u32(pr_b + 32 * c, pa[c][1]);
            st_shared_u32(pr_a + 32 * c + 16, pa[c][2]);
            st_shared_u32(pr_b + 32 * c + 16, pa[c][3]);
          }
        }
      }
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(o[e]);
#pragma unroll
      for (int c = 0; c < kAll; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(pa[c][e]);

      if constexpr (kSplit) {
        // Warpgroup 1's half of P.V joins warpgroup 0's, which writes o.
        if constexpr (kWg == 1) {
#pragma unroll
          for (int e = 0; e < 32; ++e) xo[e * 128 + tid] = o[e];
        }
        named_sync(1, 256);
        if constexpr (kWg == 0) {
#pragma unroll
          for (int e = 0; e < 32; ++e) o[e] += xo[e * 128 + tid];
        }
      } else if constexpr (kSaveP) {
        named_sync(2 + kWg, 128);
      }
      if (!kSplit || kWg == 0) {
        __nv_bfloat16* dst = prm.out + static_cast<size_t>(b) * n * prm.d + h * kHeadDim + 2 * t4;
        uint32_t* o_a = reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_a) * prm.d);
        uint32_t* o_b = reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_b) * prm.d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (row_a < n) o_a[4 * i] = pack_bf16(o[4 * i], o[4 * i + 1]);
          if (row_b < n) o_b[4 * i] = pack_bf16(o[4 * i + 2], o[4 * i + 3]);
        }
      }
      if constexpr (kSaveP && !kSplit) {
        // The tile's valid rows are contiguous in probs: whole rows, 16 bytes a store.
        const int per_row = prm.p_stride / 8;
        const int total = min(kTile, n - r0) * per_row;
        __nv_bfloat16* dst = prm.probs + (static_cast<size_t>(item) * n + r0) * prm.p_stride;
        for (int idx = tid; idx < total; idx += 128) {
          const int r = idx / per_row, c8 = (idx - r * per_row) * 8;
          *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * prm.p_stride + c8) =
              *reinterpret_cast<const uint4*>(ptile + r * ps8 + c8);
        }
      }
    }
    mbar_arrive(bars + 8u * (2 * kMaxQSlots + kMaxStages + s));  // K/V empty
  }
}

// 384 threads: warpgroups 0 and 1 consume, warpgroup 2's first thread
// produces. setmaxnreg moves the producer's registers to the consumers;
// without it ptxas spills the score rows and serialises the wgmma (measured:
// 0.55 against 0.34 ms at 500 x 257 tokens).
template <bool kSaveP, bool kSplit, int kKeys, bool kTail>
__global__ void __launch_bounds__(kThreads, 1)
mha_qkv_fwd_kernel(const __grid_constant__ CUtensorMap qkv_map, const Params prm) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + prm.off_bar;
  auto q_full = [&](int i) { return bars + 8u * i; };
  auto q_empty = [&](int i) { return bars + 8u * (kMaxQSlots + i); };
  auto kv_full = [&](int i) { return bars + 8u * (2 * kMaxQSlots + i); };
  auto kv_empty = [&](int i) { return bars + 8u * (2 * kMaxQSlots + kMaxStages + i); };

  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();  // the swizzled tiles need 1024-byte alignment
    for (int i = 0; i < prm.qslots; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), kSplit ? 256 : 128);
    }
    for (int i = 0; i < prm.stages; ++i) {
      mbar_init(kv_full(i), 1);
      mbar_init(kv_empty(i), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role of this thread's warpgroup, broadcast from lane 0 so that the
  // compiler sees a warp-uniform branch into each role's setmaxnreg region.
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    // Producer: one thread keeps the rings full, item after item.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      const int T = prm.tiles;
      const uint32_t kv_stage_bytes = 2u * T * kBoxBytes;
      int u = 0;  // q tiles issued so far
      for (int k = 0, item = blockIdx.x; item < prm.items; ++k, item += gridDim.x) {
        const int b = item / prm.heads, h = item - b * prm.heads;
        const int s = k % prm.stages;
        if (k >= prm.stages) mbar_wait(kv_empty(s), ((k / prm.stages) - 1) & 1);
        mbar_expect_tx(kv_full(s), kv_stage_bytes);
        const uint32_t kdst = base + prm.off_kv + s * kv_stage_bytes;
        for (int t = 0; t < T; ++t) {
          tma_load(kdst + t * kBoxBytes, &qkv_map, kv_full(s), prm.d + h * kHeadDim, t * kTile, b);
          tma_load(kdst + (T + t) * kBoxBytes, &qkv_map, kv_full(s), 2 * prm.d + h * kHeadDim,
                   t * kTile, b);
        }
        for (int t = 0; t < T; ++t, ++u) {
          const int q = u % prm.qslots;
          if (u >= prm.qslots) mbar_wait(q_empty(q), ((u / prm.qslots) - 1) & 1);
          mbar_expect_tx(q_full(q), kBoxBytes);
          tma_load(base + q * kBoxBytes, &qkv_map, q_full(q), h * kHeadDim, t * kTile, b);
        }
      }
    }
  } else if (role == 0) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<kSaveP, kSplit, kKeys, kTail, 0>(prm, smem, threadIdx.x);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<kSaveP, kSplit, kKeys, kTail, 1>(prm, smem, threadIdx.x - 128);
  }
}

// Shared memory of one block: q ring, K/V ring (K boxes then V boxes of an
// item), the p tiles, the split exchange, the score stash, the mbarriers. As
// many K/V stages (at most four) as fit in 227 KB, with four q slots if they
// fit, else two.
constexpr uint32_t kBarBytes = 8u * 2u * (kMaxQSlots + kMaxStages);

// The S products read `read_rows` rows from the start of a stage's K boxes
// (whole score widths, dead keys included); past the last stage's boxes they
// fall in the regions after it, and the allocation is padded where they would
// not. Returns the bytes to allocate, 0 if nothing fits.
uint32_t plan(Params& prm, bool save, bool split, bool tail, int read_rows) {
  const uint32_t kv_stage = 2u * prm.tiles * kBoxBytes;
  const uint32_t p_bytes = save && !split ? 2u * kTile * (prm.p_stride + 8) * 2u : 0u;
  const uint32_t x_bytes = split ? (32u * 128u + 256u) * 4u : 0u;
  const uint32_t st_bytes = tail ? 2u * (kTailKeys / 8) * 128u * 16u : 0u;
  const uint32_t tail_bytes = kv_stage + p_bytes + x_bytes + st_bytes + kBarBytes;
  const uint32_t read = static_cast<uint32_t>(read_rows) * 128u;
  const uint32_t pad = read > tail_bytes ? read - tail_bytes : 0u;
  for (prm.qslots = kMaxQSlots; prm.qslots >= 2; prm.qslots -= 2) {
    prm.off_kv = prm.qslots * kBoxBytes;
    for (prm.stages = kMaxStages; prm.stages >= 1; --prm.stages) {
      prm.off_p = prm.off_kv + prm.stages * kv_stage;
      prm.off_x = prm.off_p + p_bytes;
      prm.off_st = prm.off_x + x_bytes;
      prm.off_bar = prm.off_st + st_bytes;
      const uint32_t bytes = prm.off_bar + kBarBytes + pad;

      if (bytes <= static_cast<uint32_t>(kSmemLimit)) return bytes;
    }
  }
  return 0;
}

template <bool kSaveP>
int launch_fwd(const void* qkv, void* out, void* probs, int p_stride, int batch, int n,
               int num_heads, float scale, int block_len, void* stream) {
  // The grid is persistent (at most one block per SM) and every offset is 64-bit:
  // the batch is bounded only by the item count (an int) and the tensor maps'
  // dimensions (below 2^32).
  if (batch < 1 || n < 1 || n > kMaxSeq || num_heads < 1 ||
      static_cast<long long>(batch) * num_heads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n16 = (n + 15) / 16 * 16;
  if (kSaveP && p_stride != n16) return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.probs = static_cast<__nv_bfloat16*>(probs);
  prm.scale = scale;
  prm.n = n;
  prm.d = num_heads * kHeadDim;
  prm.heads = num_heads;
  prm.items = batch * num_heads;
  prm.tiles = (n + kTile - 1) / kTile;
  prm.n16 = n16;
  prm.p_stride = p_stride;
  prm.block_len = block_len;
  // One warpgroup takes a tile alone up to kWholeKeys keys, 48 or 208 of a
  // row in registers and the rest in the stash; beyond, two share it, each
  // with half of the keys held the same way.
  const bool split = n16 > kWholeKeys;
  prm.half = split ? (n16 / 2 + 15) / 16 * 16 : n16;
  const int width = n16 <= kShortKeys ? kShortKeys : kRegKeys;
  const bool tail = (split ? prm.half : n16) > width;
  const int smem_bytes = static_cast<int>(
      plan(prm, kSaveP, split, tail, (split ? prm.half : 0) + width + (tail ? kTailKeys : 0)));
  if (smem_bytes == 0) return static_cast<int>(cudaErrorInvalidValue);

  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(3 * prm.d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(3 * prm.d) * 2,
                                 static_cast<cuuint64_t>(3 * prm.d) * 2 * n};
  const cuuint32_t box[3] = {kHeadDim, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = width == kShortKeys ? mha_qkv_fwd_kernel<kSaveP, false, kShortKeys, false>
                : !split            ? mha_qkv_fwd_kernel<kSaveP, false, kRegKeys, true>
                                    : mha_qkv_fwd_kernel<kSaveP, true, kRegKeys, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = prm.items < sms ? prm.items : sms;
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(map, prm);
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
// 16-byte aligned, p_stride = n rounded up to 16; every element of probs is
// written.
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
