// The pre-norm attention sub-block as one op, forward and backward, bf16:
//   y = x + bf16(MHA(bf16(bf16(LN(x)) . Wqkv + bqkv)) . Wproj + bproj)
//
// Replaces two TPU kernels of tpuwsi/ops/attention.py:
//   :1467 `_attn_block_fwd_kernel` (pallas_call at :1593)  -> tpuwsi_attn_block_fwd
//   :1490 `_attn_block_bwd_kernel` (pallas_call at :1647)  -> tpuwsi_attn_block_bwd
// Same arithmetic. LayerNorm in fp32 with the fast variance E[x^2] - mean^2
// clamped at 0, rounded to bf16 before the qkv product; every product sums in
// fp32; qkv = product + bias, rounded; q scaled in fp32 and rounded, an fp32
// softmax over the whole row (exact row max and sum), p rounded before p.V, o
// rounded before the projection; the projection with its bias is rounded
// BEFORE x is added. Backward, from x, dy and the weights alone: LN(x), qkv, p
// and o are rebuilt; dWproj = o^T . dy, dbproj = sum dy; do = bf16(dy .
// Wproj^T); dqkv as in mha_qkv_bwd.cu (p fp32 in t and dS, rounded for dV
// only, dS rounded); dWqkv = bf16(LN)^T . bf16(dqkv) but dbqkv = sum of the
// fp32, unrounded dqkv; dln = bf16(dqkv) . Wqkv^T; LayerNorm backward; dx =
// bf16(dy + dx_ln); dgamma, dbeta. The six parameter gradients are fp32 sums
// over all images. Widths D = 384 (6 heads) and 768 (12 heads), head_dim 64,
// 1 <= N <= kMaxSeq tokens at both, any number of images; rows past N are
// neither read nor written (the tensor maps give zeros there).
//
// What bounds it on an H100. At (B, N, D) = (192, 197, 384) the forward must
// read x and write y (58 MB, 0.017 ms at 3.35 TB/s) for 56 GFLOP (0.057 ms at
// the dense bf16 peak): bound by operations, as is the backward (157 GFLOP).
// The unfused route moves qkv, o and the projection through device memory;
// what the op saves is those bytes and the launches. What stands between the
// kernels and that bound on this card: one image's qkv (454 KB at 197 tokens)
// fits no SM, so the work is split by head, and every 64-row tile of an image
// takes in its heads' columns of the weights again (L2 traffic); the softmax
// runs between the products; the heads of an image must meet for the
// projection.
//
// LayerNorm, once per image: `ln_rows_kernel` writes bf16(LN(x)) (B N D,
// one warp a row) to a workspace, and both kernels below take it as TMA
// boxes, so neither normalises anything (in-kernel LayerNorm, with the row
// statistics shared through distributed shared memory, cost K8f 22% of its
// time and the head kernel, which ran it for every head, 16% of K8b's:
// PERF.md, PR 13).
//
// The forward (K8f): a persistent grid of thread-block clusters, D / 128
// blocks each (3 at ViT-S, 6 at ViT-B), that walk the items; an item is an
// image, or at small batch (more clusters than images) one of several groups
// of an image's 64-row query tiles. Block r of a cluster owns heads 2r and
// 2r+1 and the 128 columns 128r.. of y. A block is two consumer warpgroups,
// one head each, and a producer warp whose one thread keeps two rings full
// by TMA (128-byte swizzled boxes, mbarriers): LN(x) in 64 x 64 boxes, and
// 16 KB stages of the weights (as many as fit: 2 at 304 tokens, 5 at 197).
// Per item:
//   1. K and V of the block's two heads for every 64-row tile, resident (4 R x
//      128 B, R = N rounded up to 16: 152 KB at 304 tokens): each LN(x) box
//      is the A operand of m64n128k16 wgmma (k and v of the warpgroup's head:
//      two 64-column weight boxes read MN-major);
//   2. per 64-row query tile of the item: q = LN(x) . Wq (m64n64) + bias,
//      rounded, scaled, rounded, kept in registers as the A operand of S =
//      q . K^T (m64n64k16 per 64-key chunk, A from registers); the exact row
//      max and sum in a first walk over the keys, p = exp(s - m) / l rounded
//      and o += p . V (V MN-major) in a second (S is computed twice: no 64 x
//      304 score row fits a thread's registers); o leaves as bf16 A
//      fragments into the block's shared memory; every warp of the cluster
//      releases its tile to every block (mbarrier, release/acquire at
//      cluster scope); then each warpgroup computes 64 of the block's
//      columns of y, o of every head read from the owner block's shared
//      memory (ld.shared::cluster, 16 bytes a thread a k16 step, three heads
//      at a time) as the register A operand and Wproj's columns streamed
//      MN-major: one writer per element of y, one order of summation. A
//      second arrival per warp frees the tile's fragments for the next one.
// qkv, the scores, p and o never reach device memory.
//
// The backward (K8b): LN(x) as above, a head kernel, then the row-tiled
// kernels that finish what crosses heads. `attn_block_bwd_head_kernel` is a
// persistent grid of 384-thread blocks (two consumer warpgroups with
// setmaxnreg 232, a producer warpgroup whose one thread issues the TMA loads)
// over the (image, head) items. Per item: q (unscaled), k, v and do (=
// bf16(dy . Wproj[64h.., :]^T)) rebuilt into four resident R-row tiles by
// wgmma from 48 KB ring stages (LN(x) and dy boxes; Wq, Wk, Wv boxes
// MN-major, Wproj's 64 rows K-major): warpgroup 0 takes q|k (m64n128),
// warpgroup 1 v and do (two m64n64); then K3's two phases of mha_qkv_bwd.cu
// on the resident tiles, every product an m64n64 wgmma: query tiles (S = q
// k^T scale, dP = do V^T: row max, sum and t in a first walk; then dS, dQ +=
// dS K and the forward's o += bf16(p) V, for dWproj), then key tiles (S^T,
// dP^T from the saved row statistics; dV += p^T do, dK += dS^T q). The scale
// is head_dim^-1/2 = 1/8, a power of two, so bf16(q scale) = q scale exactly
// and one q tile serves both the scores and dK. The item leaves o and bf16
// dqkv in two workspaces and the fp32 column sums of its dqkv (warps in a
// fixed order) as its part of dbqkv. What crosses heads is finished over all
// B N rows by the tails: dln = dqkv . Wqkv^T with the LayerNorm backward and
// dy added, per 64-row tile with its dgamma, dbeta column sums; dWqkv =
// LN(x)^T . dqkv and dWproj, dbproj = o^T . dy, sum dy per group of row
// steps. At D = 384 they are K7's wgmma kernels (dense_sm90.cuh): its row
// pass with the LayerNorm-backward epilogue (`LnBackward<true>`, K9b's with
// the cotangent added; x arrives by TMA in the epilogue's stage and dx leaves
// by TMA stores), and its dW kernel; at D = 768 the row-tiled kernels of
// dense_common.cuh (K7's at 768; the dx one rebuilds LN(x) into the workspace
// with the same arithmetic). `sum_partials_kernel` adds every partial in a
// fixed order. No atomics: two launches on the same
// inputs give the same bits. (PR 6's head kernel held 1.2 of the backward's
// 1.8 ms at (192, 197), the tails the rest: PERF.md, PR 13.)
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError(). The tensor maps are
// encoded on the host at each launch (hopper.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_common.cuh"
#include "dense_sm90.cuh"
#include "hopper.cuh"

namespace {

// kTile (64: rows of an x tile, a query tile, a key chunk), kRowBytes (one
// head row, 64 bf16, 128-byte swizzled), kBox (8 KB), kSmemLimit, the
// swizzle, descriptor and wgmma helpers and the dW kernel: dense_sm90.cuh
using namespace hopper;
using namespace dense_sm90;
using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;
constexpr int kMaxSeq = 304;                  // K and V of two heads (forward), four tiles (backward)
constexpr float kNegInf = -1e30f;             // finite, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;

// ---- small helpers --------------------------------------------------------

__device__ __forceinline__ uint64_t desc(uint32_t addr) { return sw128(opaque(addr)); }



// ---- thread-block clusters --------------------------------------------------

// This block's shared-memory address `addr` in the cluster's block of rank `cta`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(cta));
  return r;
}

__device__ __forceinline__ uint4 ld_cluster_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Arrive on the mbarrier at offset `bar` of the cluster's block `cta`,
// releasing at cluster scope what this thread wrote before (its shared memory
// read by the peers, or their shared memory written by it).
__device__ __forceinline__ void arrive_release_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// mbar_wait with acquire at cluster scope: what the peers released before
// their arrivals is visible after.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// ---- wgmma -------------------------------------------------------------------
// (fragment ownership of an m64nN result: dense_sm90.cuh.) Packed to bf16
// pairs (pack_a), 16 columns of a result are the register A fragment of one
// k16 step.

template <int kTransA, int kTransB>
__device__ __forceinline__ void ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// D(64 x 64) (+)= A(64 x 16, registers) . B(16 x 64), B K-major in shared
// memory (the scores: q from registers against 64 rows of K).
__device__ __forceinline__ void rk_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// acc += A (register fragments, four k16 steps) . B (64 rows read MN-major
// from b_addr, 2,048 bytes a step), the steps below `steps` only: rows past a
// tile's R are never read as K.
__device__ __forceinline__ void rn_steps(float (&acc)[32], const uint32_t (&a)[4][4],
                                         uint32_t b_addr, int steps) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < steps) wgmma_n64_mn(acc, a[s], desc(b_addr + 2048 * s), 1);
}

// This thread's eight bias pairs of a head's 64 columns (8i + 2t4, + 1),
// loaded ahead of the products that they follow; zeros without a bias.
__device__ __forceinline__ void load_bias(float2 (&b)[8], const bf16* bias, int t4) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    b[i] = bias != nullptr
               ? mlp::unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + 8 * i + 2 * t4))
               : make_float2(0.f, 0.f);
}

// An m64n64 result (rows a, b of this thread, head columns 8i + 2t4, + 1)
// plus its bias, rounded, into rows of a 128-byte swizzled R-row tile at
// `tile`; rows at or past R are not written.
__device__ __forceinline__ void store_tile(uint32_t tile, const float* acc, const float2 (&b)[8],
                                           int row_a, int R, int t4) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * t4;
    if (row_a < R)
      st_shared_u32(tile + swz(row_a, col), pack_bf16(acc[4 * i] + b[i].x, acc[4 * i + 1] + b[i].y));
    if (row_a + 8 < R)
      st_shared_u32(tile + swz(row_a + 8, col),
                    pack_bf16(acc[4 * i + 2] + b[i].x, acc[4 * i + 3] + b[i].y));
  }
}

// ---------------------------------------------------------------------------
// forward: a cluster of D / 128 blocks per image, two heads a block
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 288;  // two consumer warpgroups and one producer warp
constexpr int kAStages = 3;       // LN(x) boxes (two cost 9% at 197 tokens, four the weight stages)
constexpr int kMaxWStages = 6;    // weight stages
constexpr uint32_t kWStage = 2 * kBox;
constexpr uint32_t kOBytes = 2 * kBox;  // the block's o tile as A fragments, two heads

struct FwdParams {
  const bf16* x;
  const bf16* bqkv;
  const bf16* bp;
  bf16* y;
  float scale;
  // tokens, query-tile groups an image (items = images x groups, each item a
  // cluster's: the image's K/V pass and the query tiles t = group, group +
  // groups, ...), 64-row tiles, rows of a K/V region
  int n, groups, items, T, R, w_stages;
  uint32_t off_a, off_w, off_o, off_bar;  // byte offsets in shared memory
};

// x full / empty, weight stage full / empty, the o tile full / free (remote
// arrivals)
struct FwdBars {
  uint32_t at;
  __device__ uint32_t a_full(int i) const { return at + 8u * i; }
  __device__ uint32_t a_empty(int i) const { return at + 8u * (kAStages + i); }
  __device__ uint32_t w_full(int i) const { return at + 8u * (2 * kAStages + i); }
  __device__ uint32_t w_empty(int i) const { return at + 8u * (2 * kAStages + kMaxWStages + i); }
  __device__ uint32_t o_full() const { return at + 8u * (2 * kAStages + 2 * kMaxWStages); }
  __device__ uint32_t o_empty() const { return o_full() + 8u; }
};
constexpr uint32_t kFwdBarBytes = 8u * (2 * kAStages + 2 * kMaxWStages + 2);

// Shared memory: K and V of the two heads ([K0 | V0 | K1 | V1], R rows each),
// the LN(x) ring, the weight ring (as many 16 KB stages as fit, at most six),
// the o tile, the mbarriers. The score products read whole 64-row chunks of
// K, up to 48 rows past R: those land in the next region (V of the head, or
// the LN(x) ring after V1) and only feed masked columns.
uint32_t fwd_plan(FwdParams& prm) {
  prm.off_a = 4u * prm.R * kRowBytes;
  prm.off_w = prm.off_a + kAStages * kBox;
  const uint32_t tail = kOBytes + kFwdBarBytes;
  if (prm.off_w + 2 * kWStage + tail > kSmemLimit) return 0;
  int stages = static_cast<int>((kSmemLimit - prm.off_w - tail) / kWStage);
  prm.w_stages = stages < kMaxWStages ? stages : kMaxWStages;
  prm.off_o = prm.off_w + prm.w_stages * kWStage;
  prm.off_bar = prm.off_o + kOBytes;
  return prm.off_bar + kFwdBarBytes;
}

// The producer: per item, the image's K/V pass then per query tile of the
// item the q pass and the projection, in the order the consumers take them. Weight stages: K/V pass,
// 32 rows of Wqkv x [k h0 | v h0 | k h1 | v h1] (four 4 KB boxes); q pass, 64
// rows x [q h0 | q h1]; projection, 64 rows of Wproj x the block's 128
// columns.
template <int kD>
__device__ __forceinline__ void fwd_producer(const CUtensorMap* ln_map, const CUtensorMap* wkv_map,
                                             const CUtensorMap* wq_map, const CUtensorMap* wp_map,
                                             const FwdParams& prm, uint32_t base, int rank) {
  constexpr int kC = kD / 128, kChunks = kD / 64;
  const FwdBars bars{base + prm.off_bar};
  const int h0 = 2 * rank, h1 = h0 + 1;
  uint32_t ia = 0, iw = 0;
  auto a_slot = [&]() {
    const int s = static_cast<int>(ia % kAStages);
    if (ia >= kAStages) mbar_wait(bars.a_empty(s), ((ia / kAStages) - 1) & 1);
    mbar_expect_tx(bars.a_full(s), kBox);
    ++ia;
    return s;
  };
  auto w_slot = [&]() {
    const int s = static_cast<int>(iw % prm.w_stages);
    if (iw >= static_cast<uint32_t>(prm.w_stages))
      mbar_wait(bars.w_empty(s), ((iw / prm.w_stages) - 1) & 1);
    mbar_expect_tx(bars.w_full(s), kWStage);
    ++iw;
    return s;
  };
  for (int item = blockIdx.x / kC; item < prm.items; item += gridDim.x / kC) {
    const int img = item / prm.groups;
    for (int t = 0; t < prm.T; ++t) {
      for (int kc = 0; kc < kChunks; ++kc) {
        const int a = a_slot();
        tma_load(base + prm.off_a + a * kBox, ln_map, bars.a_full(a), 64 * kc, kTile * t, img);
        for (int half = 0; half < 2; ++half) {
          const int s = w_slot();
          const uint32_t dst = base + prm.off_w + s * kWStage;
          const int row = 64 * kc + 32 * half;
          tma_load_2d(dst, wkv_map, bars.w_full(s), kD + 64 * h0, row);
          tma_load_2d(dst + kBox / 2, wkv_map, bars.w_full(s), 2 * kD + 64 * h0, row);
          tma_load_2d(dst + kBox, wkv_map, bars.w_full(s), kD + 64 * h1, row);
          tma_load_2d(dst + 3 * kBox / 2, wkv_map, bars.w_full(s), 2 * kD + 64 * h1, row);
        }
      }
    }
    for (int t = item % prm.groups; t < prm.T; t += prm.groups) {
      for (int kc = 0; kc < kChunks; ++kc) {
        const int a = a_slot();
        tma_load(base + prm.off_a + a * kBox, ln_map, bars.a_full(a), 64 * kc, kTile * t, img);
        const int s = w_slot();
        const uint32_t dst = base + prm.off_w + s * kWStage;
        tma_load_2d(dst, wq_map, bars.w_full(s), 64 * h0, 64 * kc);
        tma_load_2d(dst + kBox, wq_map, bars.w_full(s), 64 * h1, 64 * kc);
      }
      for (int kc = 0; kc < kChunks; ++kc) {
        const int s = w_slot();
        const uint32_t dst = base + prm.off_w + s * kWStage;
        tma_load_2d(dst, wp_map, bars.w_full(s), 128 * rank, 64 * kc);
        tma_load_2d(dst + kBox, wp_map, bars.w_full(s), 128 * rank + 64, 64 * kc);
      }
    }
  }
}

template <int kD, int kWg>
__device__ __forceinline__ void fwd_consumer(const FwdParams& prm, uint32_t base, int rank,
                                             int tid) {
  constexpr int kC = kD / 128, kChunks = kD / 64;
  const FwdBars bars{base + prm.off_bar};
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int h = 2 * rank + kWg;  // this warpgroup's head
  const int n = prm.n, T = prm.T, R = prm.R;
  const uint32_t kb = base + 2 * kWg * R * kRowBytes;  // K of the head, then V
  const uint32_t vb = kb + R * kRowBytes;
  const bf16* bq = prm.bqkv + kHeadDim * h;
  uint32_t ia = 0, iw = 0, u = 0;  // LN(x) boxes, weight stages and query tiles taken so far
  auto a_box = [&](uint32_t i) {
    mbar_wait(bars.a_full(i % kAStages), (i / kAStages) & 1);
    return base + prm.off_a + (i % kAStages) * kBox;
  };
  auto w_stage = [&](uint32_t i) {
    mbar_wait(bars.w_full(i % prm.w_stages), (i / prm.w_stages) & 1);
    return base + prm.off_w + (i % prm.w_stages) * kWStage;
  };
  auto release_w = [&](uint32_t i) { warp_arrive(bars.w_empty(i % prm.w_stages)); };
  auto release_a = [&](uint32_t i) { warp_arrive(bars.a_empty(i % kAStages)); };
  float2 bk[8], bv[8];  // the head's k and v biases, for every tile
  load_bias(bk, prm.bqkv + kD + kHeadDim * h, t4);
  load_bias(bv, prm.bqkv + 2 * kD + kHeadDim * h, t4);

  for (int item = blockIdx.x / kC; item < prm.items; item += gridDim.x / kC) {
    const int img = item / prm.groups;

    // K and V of this warpgroup's head, tile by tile. Each weight stage's
    // products are issued one group ahead of the wait that frees the stage
    // before it (and, with its first stage, the box before): two slots of
    // each ring are all that this needs.
    for (int t = 0; t < T; ++t) {
      float acc[64];  // k | v
      zero(acc);
#pragma unroll
      for (int kc = 0; kc < kChunks; ++kc) {
        const uint32_t a = a_box(ia + kc);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int st = 2 * kc + half;
          const uint32_t w = w_stage(iw + st);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            ss_n128<0, 1>(acc, sw128(opaque(a) + 32 * (2 * half + kk)),
                          sw128(opaque(w) + kWg * kBox + 2048 * kk, kBox / 2), 1);
          wgmma_commit();
          if (st > 0) {
            wgmma_wait<1>();
            release_w(iw + st - 1);
            if (half == 0) release_a(ia + kc - 1);
          }
        }
      }
      wgmma_wait<0>();
      reg_fence(acc);
      release_w(iw + 2 * kChunks - 1);
      release_a(ia + kChunks - 1);
      ia += kChunks;
      iw += 2 * kChunks;
      const int row_a = kTile * t + 16 * warp + g;
      store_tile(kb, acc, bk, row_a, R, t4);
      store_tile(vb, acc + 32, bv, row_a, R, t4);
    }
    fence_proxy_async();
    named_sync(2 + kWg, 128);  // the head's K and V are whole

    for (int t = item % prm.groups; t < T; t += prm.groups, ++u) {
      // q = bf16(bf16(LN(x) . Wq + bq) * scale) as A fragments
      float qa[32];
      zero(qa);
      float2 b[8];
      load_bias(b, bq, t4);
#pragma unroll
      for (int kc = 0; kc < kChunks; ++kc) {
        const uint32_t a = a_box(ia + kc);
        const uint32_t w = w_stage(iw + kc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ss_n64<0, 1>(qa, sw128(opaque(a) + 32 * kk), sw128(opaque(w) + kWg * kBox + 2048 * kk), 1);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();
          release_w(iw + kc - 1);
          release_a(ia + kc - 1);
        }
      }
      wgmma_wait<0>();
      reg_fence(qa);
      release_w(iw + kChunks - 1);
      release_a(ia + kChunks - 1);
      ia += kChunks;
      iw += kChunks;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qa[4 * i + e] = mlp::round_bf16(qa[4 * i + e] + ((e & 1) ? b[i].y : b[i].x)) * prm.scale;
      uint32_t qf[4][4];
      pack_a(qa, qf);

      // softmax(q K^T) over the n keys, two walks of 64-key chunks
      float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
      for (int j = 0; j < T; ++j) {
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) rk_n64(s, qf[kk], desc(kb + j * kBox + 32 * kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s);
        float cm_a = kNegInf, cm_b = kNegInf;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& v = s[4 * i + e];
            v = kTile * j + 8 * i + 2 * t4 + (e & 1) < n ? v : kNegInf;
            if (e & 2) cm_b = fmaxf(cm_b, v); else cm_a = fmaxf(cm_a, v);
          }
        const float nm_a = fmaxf(m_a, quad_max(cm_a)), nm_b = fmaxf(m_b, quad_max(cm_b));
        const float ml_a = nm_a * kLog2e, ml_b = nm_b * kLog2e;
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = s[4 * i + e];
            const float x = v == kNegInf ? 0.f : exp2_approx(fmaf(v, kLog2e, (e & 2) ? -ml_b : -ml_a));
            if (e & 2) sb += x; else sa += x;
          }
        l_a = l_a * exp2_approx((m_a - nm_a) * kLog2e) + sa;
        l_b = l_b * exp2_approx((m_b - nm_b) * kLog2e) + sb;
        m_a = nm_a;
        m_b = nm_b;
      }
      const float il_a = 1.f / quad_sum(l_a), il_b = 1.f / quad_sum(l_b);
      const float ml_a = m_a * kLog2e, ml_b = m_b * kLog2e;
      float o[32];
      zero(o);
      for (int j = 0; j < T; ++j) {
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) rk_n64(s, qf[kk], desc(kb + j * kBox + 32 * kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& v = s[4 * i + e];
            const float pv = exp2_approx(fmaf(v, kLog2e, (e & 2) ? -ml_b : -ml_a)) * ((e & 2) ? il_b : il_a);
            v = kTile * j + 8 * i + 2 * t4 + (e & 1) < n ? pv : 0.f;
          }
        uint32_t pa[4][4];
        pack_a(s, pa);
        const int steps = min(4, (R - kTile * j) / 16);
        wgmma_fence();
        rn_steps(o, pa, vb + j * kBox, steps);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(pa);
      }

      // o (bf16 A fragments) to the cluster; slot kWg of the block's o tile,
      // 16 bytes a thread a k16 step
      uint32_t of[4][4];
      pack_a(o, of);
      const uint32_t ob = base + prm.off_o + (kWg * 4 * 128 + tid) * 16;
      if (u > 0) mbar_wait_cluster(bars.o_empty(), (u - 1) & 1);  // every peer read the last
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        st_shared_v4(ob + kk * 2048, make_uint4(of[kk][0], of[kk][1], of[kk][2], of[kk][3]));
      __syncwarp();
      if (lane < kC) arrive_release_cluster(bars.o_full(), lane);
      mbar_wait_cluster(bars.o_full(), u & 1);

      // x and bproj of the epilogue, loaded while the projection runs
      const int row_a = kTile * t + 16 * warp + g;
      const size_t img_at = static_cast<size_t>(img) * n * kD;
      const int col0 = 128 * rank + 64 * kWg + 2 * t4;
      uint32_t xr[8][2];
      float2 bpr[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        bpr[i] = mlp::unpack_bf16(*reinterpret_cast<const uint32_t*>(prm.bp + col0 + 8 * i));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row_a + 8 * half;
          xr[i][half] = row < n ? *reinterpret_cast<const uint32_t*>(
                                      prm.x + img_at + static_cast<size_t>(row) * kD + col0 + 8 * i)
                                : 0u;
        }
      }

      // y[:, 128 rank + 64 kWg ..] = o (all heads) . Wproj[:, those columns]
      float ya[32];
      zero(ya);
      for (int kc0 = 0; kc0 < kChunks; kc0 += 3) {  // chunk kc = head kc of the image
        uint32_t af[3][4][4];  // three heads' fragments, loaded together
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int kc = kc0 + j;
          const uint32_t src =
              mapa(base + prm.off_o + ((kc & 1) * 4 * 128 + opaque(tid)) * 16, kc >> 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint4 v = ld_cluster_v4(src + kk * 2048);
            af[j][kk][0] = v.x;
            af[j][kk][1] = v.y;
            af[j][kk][2] = v.z;
            af[j][kk][3] = v.w;
          }
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const uint32_t w = w_stage(iw + j);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_n64_mn(ya, af[j][kk], desc(w + kWg * kBox + 2048 * kk), 1);
          wgmma_commit();
          if (j > 0) {
            wgmma_wait<1>();
            release_w(iw + j - 1);
          }
        }
        wgmma_wait<0>();
        reg_fence(ya);
        reg_fence(af[0]);
        reg_fence(af[1]);
        reg_fence(af[2]);
        release_w(iw + 2);
        iw += 3;
      }
      // the reads are done (their values fed completed products): the default
      // release orders them before the owner's next stores, as in a ring
      __syncwarp();
      if (lane < kC) mbar_arrive_cluster(bars.o_empty(), lane);

      // y = x + bf16(acc + bproj), the sum rounded to bf16; rows past n not written
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row_a + 8 * half;
          if (row < n) {
            const size_t at = img_at + static_cast<size_t>(row) * kD + col0 + 8 * i;
            const float2 xv = mlp::unpack_bf16(xr[i][half]);
            *reinterpret_cast<uint32_t*>(prm.y + at) =
                pack_bf16(xv.x + mlp::round_bf16(ya[4 * i + 2 * half] + bpr[i].x),
                          xv.y + mlp::round_bf16(ya[4 * i + 2 * half + 1] + bpr[i].y));
          }
        }
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kFwdThreads, 1)
attn_block_fwd_kernel(const __grid_constant__ CUtensorMap ln_map,
                      const __grid_constant__ CUtensorMap wkv_map,
                      const __grid_constant__ CUtensorMap wq_map,
                      const __grid_constant__ CUtensorMap wp_map, const FwdParams prm) {
  constexpr int kC = kD / 128;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int rank = static_cast<int>(cluster_ctarank());
  const FwdBars bars{base + prm.off_bar};
  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();  // the swizzled tiles need 1024-byte alignment
    for (int i = 0; i < kAStages; ++i) {
      mbar_init(bars.a_full(i), 1);
      mbar_init(bars.a_empty(i), 8);  // every consumer warp
    }
    for (int i = 0; i < prm.w_stages; ++i) {
      mbar_init(bars.w_full(i), 1);
      mbar_init(bars.w_empty(i), 8);
    }
    mbar_init(bars.o_full(), 8 * kC);  // every consumer warp of the cluster
    mbar_init(bars.o_empty(), 8 * kC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the peers' barriers exist before any remote store or arrival

  // warp 8 produces (one thread), warpgroups 0 and 1 consume
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    if (threadIdx.x == 256) fwd_producer<kD>(&ln_map, &wkv_map, &wq_map, &wp_map, prm, base, rank);
  } else if (role == 0) {
    fwd_consumer<kD, 0>(prm, base, rank, threadIdx.x);
  } else {
    fwd_consumer<kD, 1>(prm, base, rank, threadIdx.x - 128);
  }
  cluster_sync();  // no block leaves while a peer may still read or arrive on it
}

// ---------------------------------------------------------------------------
// backward 1: a block per (image, head) item -> o, dqkv (bf16), column sums of dqkv
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 384;  // two consumer warpgroups + one producer warpgroup (setmaxnreg)
constexpr int kMaxStages = 3;
constexpr uint32_t kStage = 6 * kBox;  // x, dy, Wq, Wk, Wv boxes of the head, Wproj's 64 rows

struct BwdParams {
  const bf16* bqkv;
  bf16* o_work;
  bf16* dqkv;
  float* dbqkv_part;
  float scale;
  int n, heads, items, T, R, stages;
  uint32_t off_ring, off_red, off_att, off_bar;
};

struct BwdBars {
  uint32_t at;
  __device__ uint32_t full(int i) const { return at + 8u * i; }
  __device__ uint32_t empty(int i) const { return at + 8u * (kMaxStages + i); }
};
constexpr uint32_t kBwdBarBytes = 8u * 2 * kMaxStages;

// Shared memory: q, k, v, do of the item (R rows each), the ring, the warps'
// column sums of dqkv, t, m log2 e and 1 / l per query row, the mbarriers.
// The 64-row products read up to 48 rows past a tile's R: those land in the
// next tile or the ring and only feed masked rows and columns.
constexpr uint32_t kRedBytes = 3u * 8u * kHeadDim * 4u;  // [q, k, v][8 warps][64] fp32
uint32_t bwd_plan(BwdParams& prm) {
  prm.off_ring = 4u * prm.R * kRowBytes;
  const uint32_t fixed = prm.off_ring + kRedBytes + 12u * kTile * prm.T + kBwdBarBytes;
  if (fixed + kStage > kSmemLimit) return 0;
  const int stages = static_cast<int>((kSmemLimit - fixed) / kStage);
  prm.stages = stages < kMaxStages ? stages : kMaxStages;
  prm.off_red = prm.off_ring + prm.stages * kStage;
  prm.off_att = prm.off_red + kRedBytes;
  prm.off_bar = prm.off_att + 12u * kTile * prm.T;
  return prm.off_bar + kBwdBarBytes;
}

template <int kD>
__device__ __forceinline__ void bwd_producer(const CUtensorMap* ln_map, const CUtensorMap* dy_map,
                                             const CUtensorMap* w_map, const CUtensorMap* wp_map,
                                             const BwdParams& prm, uint32_t base) {
  constexpr int kChunks = kD / 64;
  const BwdBars bars{base + prm.off_bar};
  uint32_t ic = 0;
  for (int item = blockIdx.x; item < prm.items; item += gridDim.x) {
    const int b = item / prm.heads, h = item - b * prm.heads;
    for (int t = 0; t < prm.T; ++t) {
      for (int kc = 0; kc < kChunks; ++kc, ++ic) {
        const int s = static_cast<int>(ic % prm.stages);
        if (ic >= static_cast<uint32_t>(prm.stages))
          mbar_wait(bars.empty(s), ((ic / prm.stages) - 1) & 1);
        mbar_expect_tx(bars.full(s), kStage);
        const uint32_t dst = base + prm.off_ring + s * kStage;
        tma_load(dst, ln_map, bars.full(s), 64 * kc, kTile * t, b);
        tma_load(dst + kBox, dy_map, bars.full(s), 64 * kc, kTile * t, b);
        tma_load_2d(dst + 2 * kBox, w_map, bars.full(s), kHeadDim * h, 64 * kc);
        tma_load_2d(dst + 3 * kBox, w_map, bars.full(s), kD + kHeadDim * h, 64 * kc);
        tma_load_2d(dst + 4 * kBox, w_map, bars.full(s), 2 * kD + kHeadDim * h, 64 * kc);
        tma_load_2d(dst + 5 * kBox, wp_map, bars.full(s), 64 * kc, kHeadDim * h);
      }
    }
  }
}

// Adds the two rows a thread holds of an m64n64 fp32 result to its column sums.
__device__ __forceinline__ void add_cols(float (&cs)[16], const float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cs[2 * i] += acc[4 * i] + acc[4 * i + 2];
    cs[2 * i + 1] += acc[4 * i + 1] + acc[4 * i + 3];
  }
}

// A warp's column sums (over its 16 rows: the eight row lanes) -> dst[64],
// the item's sums laid out [q, k, v][8 warps][64].
__device__ __forceinline__ void store_cols(uint32_t dst, float (&cs)[16], int g, int t4) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float v = cs[i];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (g == 0) st_shared_f32(dst + 4 * (8 * (i >> 1) + 2 * t4 + (i & 1)), v);
  }
}

// Rows row_a, row_a + 8 of an m64n64 fp32 result -> bf16 at `dst` (this
// thread's first column), row stride `stride`; rows at or past n not stored.
__device__ __forceinline__ void store_rows(bf16* dst, int stride, const float (&acc)[32],
                                           int row_a, int n) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (row_a < n)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_a) * stride + 8 * i) =
          pack_bf16(acc[4 * i], acc[4 * i + 1]);
    if (row_a + 8 < n)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_a + 8) * stride + 8 * i) =
          pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <int kD, int kWg>
__device__ __forceinline__ void bwd_consumer(const BwdParams& prm, uint32_t base, int tid) {
  constexpr int kChunks = kD / 64;
  const BwdBars bars{base + prm.off_bar};
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n = prm.n, T = prm.T, R = prm.R;
  const uint32_t qt = base, kt = qt + R * kRowBytes, vt = kt + R * kRowBytes,
                 gt = vt + R * kRowBytes;
  const uint32_t att = base + prm.off_att;  // t | m log2 e | 1 / l, 64 T floats each
  const int span = kTile * T;
  const float scale = prm.scale;
  uint32_t ic = 0;

  for (int item = blockIdx.x; item < prm.items; item += gridDim.x) {
    const int b = item / prm.heads, h = item - b * prm.heads;

    // q, k, v and do of the head: warpgroup 0 q | k, warpgroup 1 v and do
    // (the ring may hold one stage only: each is freed before the next wait)
    float2 b0[8], b1[8];
    load_bias(b0, prm.bqkv + (kWg == 0 ? 0 : 2 * kD) + kHeadDim * h, t4);
    load_bias(b1, kWg == 0 ? prm.bqkv + kD + kHeadDim * h : nullptr, t4);
    for (int t = 0; t < T; ++t) {
      float acc[64];
      zero(acc);
      for (int kc = 0; kc < kChunks; ++kc, ++ic) {
        const int s = static_cast<int>(ic % prm.stages);
        mbar_wait(bars.full(s), (ic / prm.stages) & 1);
        const uint32_t st = base + prm.off_ring + s * kStage;
        wgmma_fence();
        if constexpr (kWg == 0) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ss_n128<0, 1>(acc, sw128(opaque(st) + 32 * kk), sw128(opaque(st) + 2 * kBox + 2048 * kk, kBox), 1);
          wgmma_commit();
        } else {
          float(&va)[32] = *reinterpret_cast<float(*)[32]>(acc);
          float(&ga)[32] = *reinterpret_cast<float(*)[32]>(acc + 32);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ss_n64<0, 1>(va, sw128(opaque(st) + 32 * kk), sw128(opaque(st) + 4 * kBox + 2048 * kk), 1);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ss_n64<0, 0>(ga, sw128(opaque(st) + kBox + 32 * kk), sw128(opaque(st) + 5 * kBox + 32 * kk), 1);
          wgmma_commit();
        }
        wgmma_wait<0>();
        reg_fence(acc);
        warp_arrive(bars.empty(s));
      }
      const int row_a = kTile * t + 16 * warp + g;
      store_tile(kWg == 0 ? qt : vt, acc, b0, row_a, R, t4);
      store_tile(kWg == 0 ? kt : gt, acc + 32, b1, row_a, R, t4);
    }
    fence_proxy_async();
    named_sync(1, 256);  // q, k, v, do whole

    bf16* dst = prm.dqkv + static_cast<size_t>(b) * n * (3 * kD) + kHeadDim * h + 2 * t4;
    const uint32_t col_red = base + prm.off_red;
    const int wid = 4 * kWg + warp;

    // phase A: query tiles -> t, m, 1/l of every row; dQ and o
    float cs[16];
    zero(cs);
    for (int i = kWg; i < T; i += 2) {
      const int row_a = kTile * i + 16 * warp + g, row_b = row_a + 8;
      float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f, u_a = 0.f, u_b = 0.f;
      for (int j = 0; j < T; ++j) {
        float s[32], dp[32];
        wgmma_fence();
        wgmma_nt_k64(s, desc(qt + i * kBox), desc(kt + j * kBox));
        wgmma_nt_k64(dp, desc(gt + i * kBox), desc(vt + j * kBox));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
        float cm_a = kNegInf, cm_b = kNegInf;
#pragma unroll
        for (int ii = 0; ii < 8; ++ii)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = ((e & 2) ? row_b : row_a) < n && kTile * j + 8 * ii + 2 * t4 + (e & 1) < n;
            float& v = s[4 * ii + e];
            v = ok ? v * scale : kNegInf;
            dp[4 * ii + e] = ok ? dp[4 * ii + e] : 0.f;
            if (e & 2) cm_b = fmaxf(cm_b, v); else cm_a = fmaxf(cm_a, v);
          }
        const float nm_a = fmaxf(m_a, quad_max(cm_a)), nm_b = fmaxf(m_b, quad_max(cm_b));
        const float ml_a = nm_a * kLog2e, ml_b = nm_b * kLog2e;
        float sa = 0.f, sb = 0.f, ua = 0.f, ub = 0.f;
#pragma unroll
        for (int ii = 0; ii < 8; ++ii)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = s[4 * ii + e];
            // a masked entry adds nothing (a row of only masked keys keeps m = kNegInf)
            const float x = v == kNegInf ? 0.f : exp2_approx(fmaf(v, kLog2e, (e & 2) ? -ml_b : -ml_a));
            if (e & 2) {
              sb += x;
              ub += x * dp[4 * ii + e];
            } else {
              sa += x;
              ua += x * dp[4 * ii + e];
            }
          }
        const float f_a = exp2_approx((m_a - nm_a) * kLog2e), f_b = exp2_approx((m_b - nm_b) * kLog2e);
        l_a = l_a * f_a + sa;
        l_b = l_b * f_b + sb;
        u_a = u_a * f_a + ua;
        u_b = u_b * f_b + ub;
        m_a = nm_a;
        m_b = nm_b;
      }
      l_a = quad_sum(l_a);
      l_b = quad_sum(l_b);
      const bool ok_a = row_a < n, ok_b = row_b < n;
      const float il_a = ok_a ? 1.f / l_a : 0.f, il_b = ok_b ? 1.f / l_b : 0.f;
      const float t_a = quad_sum(u_a) * il_a, t_b = quad_sum(u_b) * il_b;
      const float ml_a = ok_a ? m_a * kLog2e : 0.f, ml_b = ok_b ? m_b * kLog2e : 0.f;
      if (t4 == 0) {
        st_shared_f32(att + 4 * row_a, t_a);
        st_shared_f32(att + 4 * row_b, t_b);
        st_shared_f32(att + 4 * (span + row_a), ml_a);
        st_shared_f32(att + 4 * (span + row_b), ml_b);
        st_shared_f32(att + 4 * (2 * span + row_a), il_a);
        st_shared_f32(att + 4 * (2 * span + row_b), il_b);
      }

      float dq[32], o[32];
      zero(dq);
      zero(o);
      for (int j = 0; j < T; ++j) {
        float s[32], dp[32];
        wgmma_fence();
        wgmma_nt_k64(s, desc(qt + i * kBox), desc(kt + j * kBox));
        wgmma_nt_k64(dp, desc(gt + i * kBox), desc(vt + j * kBox));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
#pragma unroll
        for (int ii = 0; ii < 8; ++ii)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool rb = e & 2;
            const bool ok = (rb ? ok_b : ok_a) && kTile * j + 8 * ii + 2 * t4 + (e & 1) < n;
            const float p = exp2_approx(fmaf(s[4 * ii + e] * scale, kLog2e, rb ? -ml_b : -ml_a)) *
                            (rb ? il_b : il_a);
            const float d = p * (dp[4 * ii + e] - (rb ? t_b : t_a)) * scale;
            s[4 * ii + e] = ok ? p : 0.f;
            dp[4 * ii + e] = ok ? d : 0.f;
          }
        uint32_t pa[4][4], ds[4][4];
        pack_a(s, pa);
        pack_a(dp, ds);
        const int steps = min(4, (R - kTile * j) / 16);
        wgmma_fence();
        rn_steps(o, pa, vt + j * kBox, steps);
        rn_steps(dq, ds, kt + j * kBox, steps);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(dq);
        reg_fence(pa);
        reg_fence(ds);
      }
      store_rows(dst, 3 * kD, dq, row_a, n);
      store_rows(prm.o_work + static_cast<size_t>(b) * n * kD + kHeadDim * h + 2 * t4, kD, o,
                 row_a, n);
      add_cols(cs, dq);  // rows at or past n hold exact zeros
    }
    store_cols(col_red + 4 * (64 * wid), cs, g, t4);
    named_sync(1, 256);  // t, m, 1/l of every query row

    // phase B: key tiles -> dK, dV
    float csk[16], csv[16];
    zero(csk);
    zero(csv);
    for (int j = kWg; j < T; j += 2) {
      const int key_a = kTile * j + 16 * warp + g, key_b = key_a + 8;
      float dk[32], dv[32];
      zero(dk);
      zero(dv);
      for (int i = 0; i < T; ++i) {
        float s[32], dp[32];
        wgmma_fence();
        wgmma_nt_k64(s, desc(kt + j * kBox), desc(qt + i * kBox));
        wgmma_nt_k64(dp, desc(vt + j * kBox), desc(gt + i * kBox));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int c = kTile * i + 8 * ii + 2 * t4;  // this thread's two query columns
          const float2 tq = ld_shared_f2(att + 4 * c);
          const float2 mq = ld_shared_f2(att + 4 * (span + c));
          const float2 iq = ld_shared_f2(att + 4 * (2 * span + c));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            const bool ok = ((e & 2) ? key_b : key_a) < n && c + odd < n;
            const float p = exp2_approx(fmaf(s[4 * ii + e] * scale, kLog2e, -(odd ? mq.y : mq.x))) *
                            (odd ? iq.y : iq.x);
            const float d = p * (dp[4 * ii + e] - (odd ? tq.y : tq.x)) * scale;
            s[4 * ii + e] = ok ? p : 0.f;
            dp[4 * ii + e] = ok ? d : 0.f;
          }
        }
        uint32_t pt[4][4], dst_t[4][4];
        pack_a(s, pt);
        pack_a(dp, dst_t);
        const int steps = min(4, (R - kTile * i) / 16);
        wgmma_fence();
        rn_steps(dv, pt, gt + i * kBox, steps);
        rn_steps(dk, dst_t, qt + i * kBox, steps);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dv);
        reg_fence(dk);
        reg_fence(pt);
        reg_fence(dst_t);
      }
      store_rows(dst + kD, 3 * kD, dk, key_a, n);
      store_rows(dst + 2 * kD, 3 * kD, dv, key_a, n);
      add_cols(csk, dk);  // keys at or past n hold exact zeros
      add_cols(csv, dv);
    }
    store_cols(col_red + 4 * (512 + 64 * wid), csk, g, t4);
    store_cols(col_red + 4 * (1024 + 64 * wid), csv, g, t4);
    named_sync(1, 256);

    // dbqkv of this image and head from the fp32, unrounded dqkv: warps in order
    const int c = kWg * 128 + static_cast<int>(opaque(static_cast<uint32_t>(tid)));
    if (c < 192) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w)
        sum += ld_shared_f32(col_red + 4 * (512 * (c / kHeadDim) + 64 * w + c % kHeadDim));
      prm.dbqkv_part[static_cast<size_t>(b) * (3 * kD) + (c / kHeadDim) * kD + kHeadDim * h +
                     c % kHeadDim] = sum;
    }
    named_sync(1, 256);  // the sums are read before the next item's
  }
}

template <int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
attn_block_bwd_head_kernel(const __grid_constant__ CUtensorMap ln_map,
                           const __grid_constant__ CUtensorMap dy_map,
                           const __grid_constant__ CUtensorMap w_map,
                           const __grid_constant__ CUtensorMap wp_map, const BwdParams prm) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const BwdBars bars{base + prm.off_bar};
  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();
    for (int i = 0; i < prm.stages; ++i) {
      mbar_init(bars.full(i), 1);
      mbar_init(bars.empty(i), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role of this thread's warpgroup, broadcast from lane 0 so that the
  // compiler sees a warp-uniform branch into each role's setmaxnreg region.
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) bwd_producer<kD>(&ln_map, &dy_map, &w_map, &wp_map, prm, base);
  } else if (role == 0) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    bwd_consumer<kD, 0>(prm, base, threadIdx.x);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    bwd_consumer<kD, 1>(prm, base, threadIdx.x - 128);
  }
}

// ---------------------------------------------------------------------------
// backward 2, at D = 384: the tails on wgmma (D = 768 keeps dense_common.cuh's)
// ---------------------------------------------------------------------------
// Both are dense_sm90.cuh's kernels, K7's at input width 384. dx: its row
// pass, per 64-row tile of the B N rows dln = dqkv . Wqkv^T (18 chunks of
// 64; Wqkv (384, 1,152) read K-major, multicast to the cluster), with the
// LayerNorm backward and dy added as its epilogue (dense_sm90.cuh's
// `LnBackward<true>`): dx = bf16(dy + inv (dln gamma - mean(dln gamma) - xhat
// mean(dln gamma xhat))) and the tile's dgamma, dbeta column sums (row_part,
// as the row-tiled kernel wrote them).
// dW: dWqkv = LN(x)^T . dqkv and dWproj = o^T . dy with their column sums,
// per (slice of 64 output columns, group of 64-row steps) into w_part in the
// fixed-order layout of the row-tiled kernels.

constexpr int kTailD = 384;

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool shape_ok(int batch, int n, int d, int num_heads) {
  return batch >= 1 && n >= 1 && n <= kMaxSeq && (d == 384 || d == 768) &&
         num_heads * kHeadDim == d;
}

// A 3-D map (cols, rows, images) over bf16 rows of `cols` values, boxes of
// 64 columns x 64 rows, 128-byte swizzled; rows past `rows` arrive as zeros.
bool encode_3d(CUtensorMap* map, EncodeTiledFn encode, const void* ptr, int cols, int rows,
               int images) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(images)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * 2 * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(kTile), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int blocks, int cluster, int smem,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The forward's plan at n tokens, and how many of its clusters the card holds
// at once (asked once per shared-memory size); 0 clusters: it cannot launch.
template <int kD>
int fwd_setup(FwdParams& prm, int n, int* clusters) {
  prm.n = n;
  prm.T = (n + kTile - 1) / kTile;
  prm.R = (n + 15) / 16 * 16;
  const uint32_t smem = fwd_plan(prm);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  static uint32_t cached_smem[8] = {};
  static int cached_clusters[8] = {};
  for (int i = 0; i < 8; ++i) {
    if (cached_smem[i] == smem) {
      *clusters = cached_clusters[i];
      return 0;
    }
  }
  auto kernel = attn_block_fwd_kernel<kD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, kD / 128, kD / 128, smem, nullptr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < 8; ++i) {
    if (cached_smem[i] == 0) {
      cached_smem[i] = smem;
      cached_clusters[i] = count;
      break;
    }
  }
  *clusters = count;
  return 0;
}

template <int kD>
int fwd_launch(const void* x, const void* gamma, const void* beta, const void* wqkv,
               const void* bqkv, const void* wp, const void* bp, void* y, void* ln, int batch,
               int n, float scale, float eps, cudaStream_t stream) {
  constexpr int kC = kD / 128;
  FwdParams prm{};
  int clusters = 0;
  int err = fwd_setup<kD>(prm, n, &clusters);
  if (err != 0) return err;
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  prm.x = static_cast<const bf16*>(x);
  prm.bqkv = static_cast<const bf16*>(bqkv);
  prm.bp = static_cast<const bf16*>(bp);
  prm.y = static_cast<bf16*>(y);
  prm.scale = scale;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ln_map, wkv_map, wq_map, wp_map;
  if (!encode_3d(&ln_map, encode, ln, kD, n, batch) ||
      !encode_2d(&wkv_map, encode, wqkv, 3 * kD, kD, 32) ||
      !encode_2d(&wq_map, encode, wqkv, 3 * kD, kD, 64) ||
      !encode_2d(&wp_map, encode, wp, kD, kD, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  err = ln_launch<kD>(x, gamma, beta, ln, static_cast<long long>(batch) * n, eps, stream);
  if (err != 0) return err;
  // the kernel's shared-memory ceiling is set at every launch: the last one
  // set may have been another length's, smaller
  const uint32_t smem = prm.off_bar + kFwdBarBytes;
  cudaError_t e = cudaFuncSetAttribute(attn_block_fwd_kernel<kD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // more clusters than images: an image's query tiles are split over several
  // clusters, each of which runs the image's K/V pass for its own group
  prm.groups = clusters / batch < 1 ? 1 : clusters / batch < prm.T ? clusters / batch : prm.T;
  prm.items = batch * prm.groups;
  if (clusters > prm.items) clusters = prm.items;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, clusters * kC, kC, smem, stream);
  e = cudaLaunchKernelEx(&cfg, attn_block_fwd_kernel<kD>, ln_map, wkv_map, wq_map, wp_map, prm);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The head kernel on LN(x) in `ln` (which the caller filled).
template <int kD>
int head_launch(const void* ln, const void* dy, const void* wqkv, const void* bqkv,
                const void* wp, void* o_work, void* dqkv, void* dbqkv_part, int batch, int n,
                float scale, cudaStream_t stream) {
  BwdParams prm{};
  prm.bqkv = static_cast<const bf16*>(bqkv);
  prm.o_work = static_cast<bf16*>(o_work);
  prm.dqkv = static_cast<bf16*>(dqkv);
  prm.dbqkv_part = static_cast<float*>(dbqkv_part);
  prm.scale = scale;
  prm.n = n;
  prm.heads = kD / kHeadDim;
  prm.items = batch * prm.heads;
  prm.T = (n + kTile - 1) / kTile;
  prm.R = (n + 15) / 16 * 16;
  const uint32_t smem = bwd_plan(prm);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ln_map, dy_map, w_map, wp_map;
  if (!encode_3d(&ln_map, encode, ln, kD, n, batch) ||
      !encode_3d(&dy_map, encode, dy, kD, n, batch) ||
      !encode_2d(&w_map, encode, wqkv, 3 * kD, kD, 64) ||
      !encode_2d(&wp_map, encode, wp, kD, kD, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attn_block_bwd_head_kernel<kD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = prm.items < sms ? prm.items : sms;
  kernel<<<grid, kBwdThreads, smem, stream>>>(ln_map, dy_map, w_map, wp_map, prm);
  return static_cast<int>(cudaGetLastError());
}

// The D = 384 tails on wgmma: dx (with the LayerNorm backward) and the two
// dW products, into row_part and the w_parts.
int tails_384(const bf16* xp, const bf16* dyp, const float* gp, const bf16* wq, bf16* dqkv,
              bf16* o, bf16* ln, bf16* dx, float* w_part_qkv, float* w_part_proj,
              float* row_part, int rows, int groups_qkv, int groups_proj, float eps,
              cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap w_map;  // Wqkv (384, 1,152): 64 output rows of 64 reduction values a box, K-major
  if (!encode_2d(&w_map, encode, wq, 3 * kTailD, kTailD, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  const DxParams dxp{dyp, gp, row_part, eps, rows, (rows + kTile - 1) / kTile};
  const int err = launch_rows<LnBackward<true>, false>(dqkv, w_map, xp, dx, rows,
                                                       3 * kTailD / kTile, dxp, stream);
  if (err != 0) return err;
  // dWqkv = LN(x)^T . dqkv and dWproj = o^T . dy with their column sums
  const int e = dw(ln, dqkv, w_part_qkv, rows, 3 * kTailD, groups_qkv, stream);
  if (e != 0) return e;
  return dw(o, dyp, w_part_proj, rows, kTailD, groups_proj, stream);
}

// The row-tiled tails of dense_common.cuh (K7's kernels) at D = 768: dx with
// the LayerNorm backward (rebuilding LN(x) into ln_work), the two dW products.
template <int kD>
int tails_dense(const bf16* xp, const bf16* dyp, const float* gp, const float* bep,
                const bf16* wq, bf16* dqkv, bf16* o, bf16* ln, bf16* dx, float* w_part_qkv,
                float* w_part_proj, float* row_part, int rows, int n_row_tiles, int groups_qkv,
                int groups_proj, float eps, cudaStream_t stream) {
  using T = mlp::Tile<kD>;
  using S = mlp::DwSlice<kD>;
  auto dx_kernel = mlp::dense_bwd_dx_kernel<kD, true, true>;
  constexpr int kSmem = mlp::dx_smem_bytes<kD, true>();
  cudaError_t err = cudaFuncSetAttribute(dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dx_kernel<<<n_row_tiles, T::kThreads, kSmem, stream>>>(xp, dqkv, gp, bep, wq, dyp, dx, ln,
                                                         row_part, rows, 3 * kD, eps);
  auto dw_kernel = mlp::dense_bwd_dw_kernel<kD>;
  err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::smem_bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<<<dim3(3 * kD / S::kNs, groups_qkv), S::kThreads, S::smem_bytes(), stream>>>(
      ln, dqkv, w_part_qkv, rows, 3 * kD);
  dw_kernel<<<dim3(kD / S::kNs, groups_proj), S::kThreads, S::smem_bytes(), stream>>>(
      o, dyp, w_part_proj, rows, kD);
  return static_cast<int>(cudaGetLastError());
}

// The backward's tails at width kD, after the head kernel: dx with the
// LayerNorm backward and the dW partials (on wgmma at D = 384, on
// dense_common.cuh's kernels at 768), then every partial summed in a fixed
// order: see tpuwsi_attn_block_bwd.
template <int kD>
int tails_launch(const bf16* xp, const bf16* dyp, const float* gp, const float* bep,
                 const bf16* wq, bf16* dqkv, bf16* o, bf16* ln, bf16* dx, float* out,
                 const float* dbqkv_part, float* w_part_qkv, float* w_part_proj, float* row_part,
                 int batch, int rows, int groups_qkv, int groups_proj, float eps,
                 cudaStream_t stream) {
  const int n_row_tiles = (rows + mlp::Tile<kD>::kRows - 1) / mlp::Tile<kD>::kRows;
  int err;
  if constexpr (kD == kTailD)
    err = tails_384(xp, dyp, gp, wq, dqkv, o, ln, dx, w_part_qkv, w_part_proj, row_part, rows,
                    groups_qkv, groups_proj, eps, stream);
  else
    err = tails_dense<kD>(xp, dyp, gp, bep, wq, dqkv, o, ln, dx, w_part_qkv, w_part_proj,
                          row_part, rows, n_row_tiles, groups_qkv, groups_proj, eps, stream);
  if (err != 0) return err;
  const long long n_qkv = static_cast<long long>(kD) * 3 * kD + 3 * kD;
  const long long n_proj = static_cast<long long>(kD) * kD + kD;
  auto sum = [&](const float* part, float* dst, int n_parts, long long count) {
    mlp::sum_partials_kernel<float><<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
        part, dst, n_parts, count);
  };
  sum(w_part_qkv, out, groups_qkv, n_qkv);
  sum(w_part_proj, out + n_qkv, groups_proj, n_proj);
  sum(row_part, out + n_qkv + n_proj, n_row_tiles, 2LL * kD);
  sum(dbqkv_part, out + n_qkv + n_proj + 2 * kD, batch, 3LL * kD);
  return static_cast<int>(cudaGetLastError());
}

// scale = head_dim^-1/2 = 1/8 for the kernels' head_dim: a power of two (see
// the backward's note above)
bool power_of_two(float scale) {
  int e = 0;
  return scale > 0.f && frexpf(scale, &e) == 0.5f;
}

}  // namespace

extern "C" {

// The longest sequence the two kernels take at embedding width d with d / 64
// heads; 0 for a width they are not built for.
int tpuwsi_attn_block_max_seq(int d) { return d == 384 || d == 768 ? kMaxSeq : 0; }

// How many clusters of the forward (d / 128 blocks) the card can hold at once
// at n tokens; 0 means the forward cannot launch. Negative: a CUDA error code,
// negated.
int tpuwsi_attn_block_max_clusters(int d, int n) {
  if (n < 1 || n > kMaxSeq || (d != 384 && d != 768))
    return -static_cast<int>(cudaErrorInvalidValue);
  FwdParams prm{};
  int clusters = 0;
  const int err = d == 384 ? fwd_setup<384>(prm, n, &clusters) : fwd_setup<768>(prm, n, &clusters);
  return err != 0 ? -err : clusters;
}

// Every tensor is contiguous and 16-byte aligned, bf16 unless said otherwise.
// x, y, dy, dx: (batch, n, d); gamma, beta: (d,) fp32; wqkv: (d, 3 d),
// columns [which(3), head, 64]; bqkv: (3 d,); wp: (d, d); bp: (d,); ln_work:
// (batch, n, d), contents undefined on entry (bf16 LN(x), from the first of
// the two launches to the second). d = 384 or 768 with d / 64 heads, 1 <= n
// <= tpuwsi_attn_block_max_seq(d), any batch of at most 2^31 / (d / 64)
// images.
int tpuwsi_attn_block_fwd(const void* x, const void* gamma, const void* beta, const void* wqkv,
                          const void* bqkv, const void* wp, const void* bp, void* y,
                          void* ln_work, int batch, int n, int d, int num_heads, float scale,
                          float eps, void* stream) {
  if (!shape_ok(batch, n, d, num_heads)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return d == 384 ? fwd_launch<384>(x, gamma, beta, wqkv, bqkv, wp, bp, y, ln_work, batch, n,
                                    scale, eps, s)
                  : fwd_launch<768>(x, gamma, beta, wqkv, bqkv, wp, bp, y, ln_work, batch, n,
                                    scale, eps, s);
}

// Gradients of the above at the cotangent dy. grads (out), fp32:
//   dWqkv (d, 3 d) | 3 d values of no use | dWproj (d, d) | dbproj (d) |
//   dgamma (d) | dbeta (d) | dbqkv (3 d)
// (the weight-gradient kernel also sums the ROUNDED dqkv; dbqkv, the last
// piece, is the sum of the unrounded one). Workspaces, contents undefined on
// entry: dqkv_work (batch, n, 3 d), o_work and ln_work (batch, n, d) bf16
// (ln_work carries LN(x) to the head kernel, and again, rebuilt by the dx
// tail with the same arithmetic, to the dW tails);
// dbqkv_part (batch, 3 d), w_part_qkv (groups_qkv, d 3 d + 3 d), w_part_proj
// (groups_proj, d d + d) and row_part (ceil(batch n / tpuwsi_mlp_rows_per_tile
// (d)), 2 d) fp32; each number of row groups between 1 and
// ceil(batch n / tpuwsi_dense_rows_per_step(d)); batch n 3 d < 2^31; scale a
// power of two.
int tpuwsi_attn_block_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
                          const void* wqkv, const void* bqkv, const void* wp, void* dx,
                          void* grads, void* dqkv_work, void* o_work, void* ln_work,
                          void* dbqkv_part, void* w_part_qkv, void* w_part_proj, void* row_part,
                          int batch, int n, int d, int num_heads, int groups_qkv,
                          int groups_proj, float scale, float eps, void* stream_) {
  if (!shape_ok(batch, n, d, num_heads) || !power_of_two(scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows_ll = static_cast<long long>(batch) * n;
  if (rows_ll * 3 * d >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = static_cast<int>(rows_ll);
  const int rows_per_step = d == 384 ? mlp::DwSlice<384>::kRows : mlp::DwSlice<768>::kRows;
  const int max_groups = (rows + rows_per_step - 1) / rows_per_step;
  if (groups_qkv < 1 || groups_qkv > max_groups || groups_proj < 1 || groups_proj > max_groups ||
      groups_qkv > 65535 || groups_proj > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int err = d == 384 ? ln_launch<384>(x, gamma, beta, ln_work, rows_ll, eps, stream)
                     : ln_launch<768>(x, gamma, beta, ln_work, rows_ll, eps, stream);
  if (err != 0) return err;
  err = d == 384 ? head_launch<384>(ln_work, dy, wqkv, bqkv, wp, o_work, dqkv_work, dbqkv_part,
                                    batch, n, scale, stream)
                 : head_launch<768>(ln_work, dy, wqkv, bqkv, wp, o_work, dqkv_work, dbqkv_part,
                                    batch, n, scale, stream);
  if (err != 0) return err;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* dyp = static_cast<const bf16*>(dy);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bep = static_cast<const float*>(beta);
  const auto* wq = static_cast<const bf16*>(wqkv);
  auto* dq = static_cast<bf16*>(dqkv_work);
  auto* o = static_cast<bf16*>(o_work);
  auto* ln = static_cast<bf16*>(ln_work);
  auto* dxp = static_cast<bf16*>(dx);
  auto* out = static_cast<float*>(grads);
  const auto* dbp = static_cast<const float*>(dbqkv_part);
  auto* wpq = static_cast<float*>(w_part_qkv);
  auto* wpp = static_cast<float*>(w_part_proj);
  auto* rp = static_cast<float*>(row_part);
  return d == 384 ? tails_launch<384>(xp, dyp, gp, bep, wq, dq, o, ln, dxp, out, dbp, wpq, wpp, rp,
                                      batch, rows, groups_qkv, groups_proj, eps, stream)
                  : tails_launch<768>(xp, dyp, gp, bep, wq, dq, o, ln, dxp, out, dbp, wpq, wpp, rp,
                                      batch, rows, groups_qkv, groups_proj, eps, stream);
}

}  // extern "C"
