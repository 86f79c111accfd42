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
// (94 MB), and write dqkv (87 MB): 298 MB with p, 204 MB without, 0.089 and
// 0.061 ms at 3.35 TB/s. The products that are needed come to B*H*4*2*N*N*hd
// = 23 GFLOP (29 with the score product), 0.03 ms at the dense bf16 peak.
// Both kernels are bound by device memory: the design reads each operand of
// an item once, keeps everything N x N on chip, and keeps loads in flight.
//
// The algorithm, in three steps per item (one image and head), 64-row tiles:
//   1. query-major, the row statistics: t_i, and without saved p the row max
//      m_i and 1 / sum l_i. With p saved, t comes from o' = P . V (a wgmma
//      with P straight from shared memory) as t_i = sum_c g_ic o'_ic, the
//      same sum of products g_ic P_ij V_jc in another order; rebuilt, S = q_s
//      . K^T and dP = g . V^T go 64 keys at a time through an online max and
//      sum, with sum_j e_ij dP_ij carried under the running max;
//   2. key-major, per 64-key tile against 64-query chunks: dP^T = V . g^T (and
//      rebuilt, S^T = K . q_s^T, p^T from the step's statistics), dS^T in
//      registers; p^T's bf16 pairs are the register A operand of dV += P^T . g
//      (g read MN-major). The saved p^T comes from shared memory through
//      ldmatrix.trans, already in the A-fragment layout; dS^T leaves through
//      stmatrix.trans as dS (queries on rows) into its 64-key box, in the
//      saved p's place (each warp reads and writes only its 16 key columns);
//   3. dQ = dS . K (query-major, dS read K-major) and dK = dS^T . Q
//      (key-major, dS read MN-major), every operand from shared memory.
// So dP is computed once with p saved and twice without (steps 1 and 2), the
// scores twice; every product is a wgmma m64n64k16 and nothing N x N leaves
// the chip.
//
// Where that fits (N <= kResidentMax = 208: both path shapes, 197 and 37)
// one item is resident: q (or q_s), k, v, g as one TMA box of R = N rounded
// up to 16 rows each, and dS in T = ceil(N / 64) boxes of 64 keys x R
// queries, 8 T R bytes with 128-byte swizzled rows (213 KB at N = 197). Rows
// past N arrive as zeros from the tensor maps; the 64-row wgmma tiles read up
// to 48 rows past R, which only feed output rows that are not stored or
// columns that are masked (by select, so garbage cannot leak), and every
// reduction over queries or keys stops at R. An item's loads come in three
// groups: v and g, which step 2 frees, so that they load for the next item
// while step 3 runs; then the p boxes, each on its own mbarrier so that step
// 1 starts on the first (rebuilt p: q, made q_s in place, and k); last what
// only step 3 reads (saved: q and k; rebuilt: q again, in q_s's place, once
// step 2 is done with q_s). Up to 128 tokens each consumer warpgroup runs its
// own items through its own slots and producer warp (three slots each at 37
// tokens, so the next items' loads are in flight); above, both warpgroups
// share each item in one slot, query and key tiles alternating between them.
// What holds it there (PERF.md; an H100 SXM at 700 W): an item fills shared
// memory, so the next item's p (or q and k) loads only once step 3 is done,
// and loads and arithmetic add up more than they overlap.
//
// Beyond 208 tokens no item fits (the supervised step's ViT-S/16 at 256 px,
// 257 tokens, runs here), and the kernel streams: each warpgroup runs its own items as the three steps over
// 64-row boxes through a ring of stages and two slots of the owned tile, and
// step 3 rebuilds dS from dP (and the scores) a third time, as the statistics
// of step 1 allow. Every length 1 <= N <= 511 reaches one of the two forms.
//
// A persistent grid, one block of 384 threads per SM: two consumer
// warpgroups (setmaxnreg 232) and a producer warpgroup (40) whose first one
// or two lanes issue every load, TMA through 3-D tensor maps over qkv (B, N,
// 3D), g (B, N, D) and p (B*H, N, p_stride), completing on mbarriers. No
// atomics: every output element has one writer and a fixed summation order,
// so two launches on the same inputs give the same bits.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError(). The tensor maps are
// encoded on the host at each launch (hopper.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kHeadDim = 64;
constexpr int kTile = 64;                      // rows of a wgmma tile and of a box
constexpr uint32_t kRowBytes = kHeadDim * 2;   // one head row, 128-byte swizzled
constexpr uint32_t kBox = kTile * kRowBytes;   // 8 KB
constexpr int kMaxSeq = 511;
constexpr int kResidentMax = 208;  // the longest sequence whose item fits on chip
constexpr int kMaxTiles = (kResidentMax + kTile - 1) / kTile;  // 64-row tiles of a resident item
constexpr int kMaxOwn = 2;  // one pipeline per warpgroup up to two tiles an item
constexpr int kMaxSlots = 4;       // item slots of a resident pipeline
constexpr int kStages = 3;         // streamed: ring of chunk stages of a pipeline
constexpr int kThreads = 384;      // two consumer warpgroups + one producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg: 128 x 40 + 256 x 232
constexpr uint32_t kSmemLimit = 232448;
constexpr uint32_t kBarPage = 2048;  // mbarriers, then the dump for stores past R
constexpr uint32_t kDump = 1536;
constexpr float kNegInf = -1e30f;    // finite, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;

// kTeam1: resident, one pipeline per consumer warpgroup; kTeam2: resident,
// both warpgroups on each item; kStream: streamed, one pipeline per warpgroup.
enum Mode { kTeam1 = 0, kTeam2 = 1, kStream = 2 };

struct Params {
  __nv_bfloat16* dqkv;
  float scale;
  int n, d, heads, items, T, R, block_len, slots;
  uint32_t stats_bytes;  // a pipeline's statistics: t, m log2 e, 1 / l (64 T each)
  uint32_t off_slots;    // first slot (resident) or pipeline area (streamed)
  uint32_t slot_bytes;   // one item's slot (resident) or one pipeline's area
};

// ---- small helpers --------------------------------------------------------

__device__ __forceinline__ uint64_t desc(uint32_t addr) { return sw128_desc(opaque(addr)); }

// Byte address of 16-byte chunk `chunk` of row `row` of a 128-byte swizzled
// region that starts on a 1024-byte boundary.
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int chunk) {
  return base + row * kRowBytes + (((chunk) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void stsm_x4_t(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// D(64 x 64) += A(64 x 16) . B(16 x 64), both from shared memory; kTransA /
// kTransB: the operand is MN-major (bf16 allows either transposed).
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// Rows row_a, row_b of a 64 x 64 fp32 accumulator -> bf16 at `o` (this
// thread's first column), row stride `stride`; rows >= n are not stored.
__device__ __forceinline__ void store_rows(__nv_bfloat16* o, int stride, const float (&acc)[32],
                                           int row_a, int row_b, int n) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (row_a < n)
      *reinterpret_cast<uint32_t*>(o + static_cast<size_t>(row_a) * stride + 8 * i) =
          pack_bf16(acc[4 * i], acc[4 * i + 1]);
    if (row_b < n)
      *reinterpret_cast<uint32_t*>(o + static_cast<size_t>(row_b) * stride + 8 * i) =
          pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// Fragment ownership (wgmma m64nN, PTX ISA): warp w of a warpgroup holds rows
// 16w..16w+15 of a 64-row tile; lane = 4 g + t4 holds rows 16w + g (a) and
// 16w + g + 8 (b), and of each 8-column group i, columns 8i + 2t4 and
// 8i + 2t4 + 1: regs 4i, 4i+1 of row a, 4i+2, 4i+3 of row b. Packed to bf16
// pairs (pack_a) 16 columns are the A fragment of one k16 step.

// The columns a row may attend to: lo <= c < hi, none for a row at or past N.
struct Bounds {
  int lo_a, hi_a, lo_b, hi_b;
};

__device__ __forceinline__ Bounds bounds_of(int row_a, int row_b, int n, int bl) {
  Bounds b{0, n, 0, n};
  if (bl > 0 && bl < n) {
    b.lo_a = row_a / bl * bl;
    b.hi_a = min(b.lo_a + bl, n);
    b.lo_b = row_b / bl * bl;
    b.hi_b = min(b.lo_b + bl, n);
  }
  if (row_a >= n) b.lo_a = b.hi_a = 0;
  if (row_b >= n) b.lo_b = b.hi_b = 0;
  return b;
}

__device__ __forceinline__ bool valid(const Bounds& b, int e, int col) {
  return (e & 2) ? (col >= b.lo_b && col < b.hi_b) : (col >= b.lo_a && col < b.hi_a);
}

// The saved p of a 64 x 64 block (rows = queries from `row0`, keys = the 64
// columns of a box) as bf16 pairs in the A-fragment layout of the block's
// transpose (rows = keys): warp w's 16 keys against the 64 queries.
__device__ __forceinline__ void load_pt(uint32_t (&pt)[4][4], uint32_t box, int row0, int warp,
                                        int lane) {
  const int m = lane >> 3;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    ldsm_x4_t(pt[s], swz(box, row0 + 16 * s + (m >> 1) * 8 + (lane & 7), 2 * warp + (m & 1)));
}

// The same block as A fragments of rows = queries: warp w's 16 queries
// against the 64 keys.
__device__ __forceinline__ void load_p(uint32_t (&pa)[4][4], uint32_t box, int row0, int warp,
                                       int lane) {
  const int m = lane >> 3;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    ldsm_x4(pa[s], swz(box, row0 + 16 * warp + (m & 1) * 8 + (lane & 7), 2 * s + (m >> 1)));
}

// dS^T (A fragments, rows = keys) -> the 64 x 64 block of dS (rows = queries
// from row0) where load_pt read p; rows at or past `rows` go to the dump.
__device__ __forceinline__ void store_ds(uint32_t box, const uint32_t (&ds)[4][4], int row0,
                                         int rows, uint32_t dump, int warp, int lane) {
  const int m = lane >> 3;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int row = row0 + 16 * s + (m >> 1) * 8 + (lane & 7);
    stsm_x4_t(row < rows ? swz(box, row, 2 * warp + (m & 1)) : dump + 16 * lane, ds[s]);
  }
}

__device__ __forceinline__ void unpack_a(const uint32_t (&a)[4][4], float (&x)[32]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[8 * s + 2 * k] = lo_bf16(a[s][k]);
      x[8 * s + 2 * k + 1] = hi_bf16(a[s][k]);
    }
}

// q * scale in fp32, rounded back to bf16, in place (rebuilt p): the operand
// of the scores. Elementwise, so the swizzle does not matter: `count` 16-byte
// chunks from `q`, this thread's from `first` in steps of `stride`; fenced
// for the wgmma that read them next.
__device__ __forceinline__ void scale_q(unsigned char* q, int count, float scale, int first,
                                        int stride) {
  uint4* qs = reinterpret_cast<uint4*>(q);
  auto scale2 = [scale](uint32_t w) { return pack_bf16(lo_bf16(w) * scale, hi_bf16(w) * scale); };
  for (int i = first; i < count; i += stride) {
    uint4 x = qs[i];
    x.x = scale2(x.x);
    x.y = scale2(x.y);
    x.z = scale2(x.z);
    x.w = scale2(x.w);
    qs[i] = x;
  }
  fence_async_smem();
}

// ---- step 1: row statistics (query-major) ---------------------------------

struct Online {
  float m_a, m_b, l_a, l_b, u_a, u_b;
};

// One 64-key chunk of rebuilt scores s and dP (keys from col0) into the
// running max m, sum l and sum_j e_ij dP_ij u of this thread's two rows.
// Masked entries are replaced by select, so nothing read past R leaks.
__device__ __forceinline__ void online_chunk(Online& o, float (&s)[32], float (&dp)[32],
                                             const Bounds& b, int col0, int t4) {
  float cm_a = kNegInf, cm_b = kNegInf;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = valid(b, e, col0 + 8 * i + 2 * t4 + (e & 1));
      float& x = s[4 * i + e];
      x = ok ? x : kNegInf;
      dp[4 * i + e] = ok ? dp[4 * i + e] : 0.f;
      if (e & 2) cm_b = fmaxf(cm_b, x); else cm_a = fmaxf(cm_a, x);
    }
  const float nm_a = fmaxf(o.m_a, quad_max(cm_a)), nm_b = fmaxf(o.m_b, quad_max(cm_b));
  const float f_a = exp2_approx((o.m_a - nm_a) * kLog2e), f_b = exp2_approx((o.m_b - nm_b) * kLog2e);
  const float ml_a = nm_a * kLog2e, ml_b = nm_b * kLog2e;
  float sa = 0.f, sb = 0.f, ua = 0.f, ub = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked entry adds nothing: while a row has seen only masked keys its
      // max is kNegInf, and exp2 of the rounding residual of kNegInf * log2 e
      // would overflow
      const float x = s[4 * i + e] == kNegInf
                          ? 0.f
                          : exp2_approx(fmaf(s[4 * i + e], kLog2e, (e & 2) ? -ml_b : -ml_a));
      if (e & 2) {
        sb += x;
        ub += x * dp[4 * i + e];
      } else {
        sa += x;
        ua += x * dp[4 * i + e];
      }
    }
  o.l_a = o.l_a * f_a + sa;
  o.l_b = o.l_b * f_b + sb;
  o.u_a = o.u_a * f_a + ua;
  o.u_b = o.u_b * f_b + ub;
  o.m_a = nm_a;
  o.m_b = nm_b;
}

// t (and m log2 e, 1 / l) of this thread's rows into the pipeline's stats.
__device__ __forceinline__ void put_stats(float* st, int span, int row_a, int row_b, float t_a,
                                          float t_b, float ml_a, float ml_b, float il_a,
                                          float il_b, int t4) {
  if (t4 == 0) {
    st[row_a] = t_a;
    st[row_b] = t_b;
    st[span + row_a] = ml_a;
    st[span + row_b] = ml_b;
    st[2 * span + row_a] = il_a;
    st[2 * span + row_b] = il_b;
  }
}

// Rebuilt p: the statistics of a query tile from its S and dP against every
// key; q_s, g from q_addr, g_addr (the tile's rows), K, V tile j at
// k_addr(j), v_addr(j).
template <typename KAddr, typename VAddr, typename Wait, typename Done>
__device__ __forceinline__ void stats_rebuilt(float* st, int span, uint32_t q_addr,
                                              uint32_t g_addr, KAddr k_addr, VAddr v_addr,
                                              Wait wait, Done done, int row_a, int row_b,
                                              const Params& prm, int t4) {
  const Bounds b = bounds_of(row_a, row_b, prm.n, prm.block_len);
  Online o{kNegInf, kNegInf, 0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < prm.T; ++j) {
    wait(j);
    float s[32], dp[32];
    wgmma_fence();
    wgmma_nt_k64(s, desc(q_addr), desc(k_addr(j)));
    wgmma_nt_k64(dp, desc(g_addr), desc(v_addr(j)));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    done(j);
    online_chunk(o, s, dp, b, j * kTile, t4);
  }
  const float il_a = 1.f / quad_sum(o.l_a), il_b = 1.f / quad_sum(o.l_b);
  put_stats(st, span, row_a, row_b, quad_sum(o.u_a) * il_a, quad_sum(o.u_b) * il_b,
            o.m_a * kLog2e, o.m_b * kLog2e, il_a, il_b, t4);
}

// Saved p: t_i = sum_c g_ic o'_ic with o' = P . V (P from the p boxes at
// p_addr(j) + the tile's rows, V MN-major at v_addr(j)), keys to R only.
template <typename PAddr, typename VAddr, typename Wait, typename Done>
__device__ __forceinline__ void stats_saved(float* st, int span, uint32_t g_addr, PAddr p_addr,
                                            VAddr v_addr, Wait wait, Done done, int rows,
                                            int row_a, int row_b, int lr_a, int t4) {
  float o[32];
  zero(o);
  for (int j = 0; j < (rows + kTile - 1) / kTile; ++j) {
    wait(j);
    const int steps = min(4, (rows - j * kTile) / 16);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s < steps) wgmma_ss_t<0, 1>(o, desc(p_addr(j) + 32 * s), desc(v_addr(j) + 2048 * s));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    done(j);
  }
  // g of rows a and b: chunk i holds columns 8i .. 8i + 7
  const int lr_b = lr_a + 8;
  float t_a = 0.f, t_b = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t wa, wb;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(wa) : "r"(swz(g_addr, lr_a, i) + 4 * t4));
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(wb) : "r"(swz(g_addr, lr_b, i) + 4 * t4));
    t_a = fmaf(lo_bf16(wa), o[4 * i], fmaf(hi_bf16(wa), o[4 * i + 1], t_a));
    t_b = fmaf(lo_bf16(wb), o[4 * i + 2], fmaf(hi_bf16(wb), o[4 * i + 3], t_b));
  }
  put_stats(st, span, row_a, row_b, quad_sum(t_a), quad_sum(t_b), 0.f, 0.f, 0.f, 0.f, t4);
}

// ---- step 2: one key tile against one 64-query chunk (key-major) ----------

// p^T and dS^T of the chunk (queries from col0) in this thread's key rows, as
// bf16 A fragments. Saved: p^T arrives as pt; rebuilt: from s (S^T) and the
// statistics. The query's t, m log2 e and 1 / l come from st.
template <bool kSaved>
__device__ __forceinline__ void ds_cols(uint32_t (&pt)[4][4], uint32_t (&dst)[4][4],
                                        float (&s)[32], float (&dp)[32], const float* st, int span,
                                        const Bounds& b, int col0, float scale, int t4) {
  if constexpr (kSaved) unpack_a(pt, s);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = col0 + 8 * i + 2 * t4;
    const float2 t = *reinterpret_cast<const float2*>(st + q);
    float2 ml = make_float2(0.f, 0.f), il = ml;
    if constexpr (!kSaved) {
      ml = *reinterpret_cast<const float2*>(st + span + q);
      il = *reinterpret_cast<const float2*>(st + 2 * span + q);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool odd = e & 1;
      const bool ok = valid(b, e, q + odd);
      float p = s[4 * i + e];
      if constexpr (!kSaved) p = exp2_approx(fmaf(p, kLog2e, -(odd ? ml.y : ml.x))) * (odd ? il.y : il.x);
      p = ok ? p : 0.f;
      s[4 * i + e] = p;
      const float ds = p * (dp[4 * i + e] - (odd ? t.y : t.x)) * scale;
      dp[4 * i + e] = ok ? ds : 0.f;
    }
  }
  pack_a(s, pt);
  pack_a(dp, dst);
}

// acc += A (fragments) . B (64 rows MN-major from b_addr), k16 steps < steps.
__device__ __forceinline__ void wgmma_rn(float (&acc)[32], const uint32_t (&a)[4][4],
                                         uint32_t b_addr, int steps) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < steps) wgmma_n64_mn(acc, a[s], desc(b_addr + 2048 * s), 1);
}

// ---- step 3 (streamed): dS of one query tile against one key chunk ---------

template <bool kSaved>
__device__ __forceinline__ void ds_rows(uint32_t (&pa)[4][4], uint32_t (&ds)[4][4],
                                        float (&s)[32], float (&dp)[32], const float* st, int span,
                                        const Bounds& b, int col0, int row_a, int row_b,
                                        float scale, int t4) {
  if constexpr (kSaved) unpack_a(pa, s);
  const float t_a = st[row_a], t_b = st[row_b];
  float ml_a = 0.f, ml_b = 0.f, il_a = 0.f, il_b = 0.f;
  if constexpr (!kSaved) {
    ml_a = st[span + row_a];
    ml_b = st[span + row_b];
    il_a = st[2 * span + row_a];
    il_b = st[2 * span + row_b];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool rb = e & 2;
      const bool ok = valid(b, e, col0 + 8 * i + 2 * t4 + (e & 1));
      float p = s[4 * i + e];
      if constexpr (!kSaved) p = exp2_approx(fmaf(p, kLog2e, rb ? -ml_b : -ml_a)) * (rb ? il_b : il_a);
      const float d = p * (dp[4 * i + e] - (rb ? t_b : t_a)) * scale;
      dp[4 * i + e] = ok ? d : 0.f;
    }
  pack_a(dp, ds);
}

// ---- the resident form ------------------------------------------------------

// mbarriers of a resident pipeline: per slot, A full, B full (rebuilt p) or
// one per p box (saved p: step 1 starts on the first box), q full (what
// only step 3 reads), A and B empty.
struct ResBars {
  uint32_t at;
  __device__ uint32_t full_a(int s) const { return at + 8u * s; }
  __device__ uint32_t full_b(int s) const { return at + 8u * (kMaxSlots + s); }
  __device__ uint32_t full_q(int s) const { return at + 8u * (2 * kMaxSlots + s); }
  __device__ uint32_t empty_a(int s) const { return at + 8u * (3 * kMaxSlots + s); }
  __device__ uint32_t empty_b(int s) const { return at + 8u * (4 * kMaxSlots + s); }
  __device__ uint32_t full_p(int s, int j) const {
    return at + 8u * (5 * kMaxSlots + s * kMaxTiles + j);
  }
};
constexpr uint32_t kResBarBytes = 8u * (5u + kMaxTiles) * kMaxSlots;
static_assert(2 * kResBarBytes <= kDump, "the mbarriers fit below the dump");

// A slot: q (or q_s), k, v, g boxes of R rows, then T boxes of 64 keys x R
// queries holding p (saved) and then dS.
struct Slot {
  uint32_t q, k, v, g, x, rb;  // rb: bytes of one R-row box
  __device__ uint32_t tile(uint32_t region, int i) const { return region + i * kBox; }
  __device__ uint32_t xbox(int j) const { return x + j * rb; }
};

__device__ __forceinline__ Slot slot_of(const Params& prm, uint32_t base, int pipe, int s) {
  Slot sl;
  sl.rb = prm.R * kRowBytes;
  sl.q = base + prm.off_slots + (pipe * prm.slots + s) * prm.slot_bytes;
  sl.k = sl.q + sl.rb;
  sl.v = sl.k + sl.rb;
  sl.g = sl.v + sl.rb;
  sl.x = sl.g + sl.rb;
  return sl;
}

template <bool kSaved, int kTeam, int kWg>
__device__ __forceinline__ void consume_resident(const Params& prm, unsigned char* smem, int tid) {
  constexpr int kRank = kTeam == kTeam2 ? kWg : 0;
  constexpr int kStep = kTeam == kTeam2 ? 2 : 1;
  constexpr int kPipe = kTeam == kTeam2 ? 0 : kWg;
  constexpr int kTeamThreads = 128 * kStep;
  const uint32_t base = smem_u32(smem);
  const ResBars bars{base + kPipe * kResBarBytes};
  float* st = reinterpret_cast<float*>(smem + kBarPage + kPipe * prm.stats_bytes);
  const uint32_t dump = base + kDump;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int lr_a = warp * 16 + g, lr_b = lr_a + 8;
  const int n = prm.n, T = prm.T, R = prm.R, span = kTile * T;
  const int d3 = 3 * prm.d;
  auto team_sync = [&]() { named_sync(1 + kPipe, kTeamThreads); };
  const int npipe = kTeam == kTeam2 ? 1 : 2;

  for (int k = 0, item = blockIdx.x * npipe + kPipe; item < prm.items;
       ++k, item += gridDim.x * npipe) {
    const int s = k % prm.slots;
    const uint32_t ph = (k / prm.slots) & 1;
    const int b = item / prm.heads, h = item - b * prm.heads;
    const Slot sl = slot_of(prm, base, kPipe, s);
    __nv_bfloat16* out = prm.dqkv + static_cast<size_t>(b) * n * d3 + h * kHeadDim + 2 * t4;
    mbar_wait(bars.full_a(s), ph);
    if constexpr (!kSaved) mbar_wait(bars.full_b(s), ph);  // saved: each p box in step 1

    if constexpr (!kSaved) {
      scale_q(smem + (sl.q - base), R * int(kRowBytes / 16), prm.scale, kRank * 128 + tid,
              kTeamThreads);
      team_sync();
    }

    // step 1: statistics of this warpgroup's query tiles
    for (int i = kRank; i < T; i += kStep) {
      const int row_a = i * kTile + lr_a, row_b = row_a + 8;
      auto nop = [](int) {};
      if constexpr (kSaved) {
        stats_saved(st, span, sl.tile(sl.g, i),
                    [&](int j) { return sl.xbox(j) + i * kBox; },
                    [&](int j) { return sl.tile(sl.v, j); },
                    [&](int j) { mbar_wait(bars.full_p(s, j), ph); }, nop, R, row_a, row_b,
                    lr_a, t4);
      } else {
        stats_rebuilt(st, span, sl.tile(sl.q, i), sl.tile(sl.g, i),
                      [&](int j) { return sl.tile(sl.k, j); },
                      [&](int j) { return sl.tile(sl.v, j); }, nop, nop, row_a, row_b, prm, t4);
      }
    }
    team_sync();

    // step 2: dV of this warpgroup's key tiles; dS into the x boxes, in place
    // of the saved p (whose boxes step 1 waited for already)
    if constexpr (kSaved)
      for (int j = kRank; j < T; j += kStep) mbar_wait(bars.full_p(s, j), ph);
    for (int j = kRank; j < T; j += kStep) {
      const int key_a = j * kTile + lr_a, key_b = key_a + 8;
      const Bounds bnd = kSaved ? bounds_of(key_a, key_b, n, 0)
                                : bounds_of(key_a, key_b, n, prm.block_len);
      const uint32_t xb = sl.xbox(j);
      float dv[32];
      zero(dv);
      for (int c = 0; c < T; ++c) {
        float sc[32], dp[32];
        uint32_t pt[4][4], dst[4][4];
        if constexpr (kSaved) load_pt(pt, xb, c * kTile, warp, lane);
        wgmma_fence();
        if constexpr (!kSaved) wgmma_nt_k64(sc, desc(sl.tile(sl.k, j)), desc(sl.tile(sl.q, c)));
        wgmma_nt_k64(dp, desc(sl.tile(sl.v, j)), desc(sl.tile(sl.g, c)));
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (!kSaved) reg_fence(sc);
        reg_fence(dp);
        ds_cols<kSaved>(pt, dst, sc, dp, st, span, bnd, c * kTile, prm.scale, t4);
        wgmma_fence();
        wgmma_rn(dv, pt, sl.tile(sl.g, c), min(4, (R - c * kTile) / 16));
        wgmma_commit();
        store_ds(xb, dst, c * kTile, R, dump, warp, lane);
        wgmma_wait<0>();
        reg_fence(dv);
        reg_fence(pt);
      }
      store_rows(out + 2 * prm.d, d3, dv, key_a, key_b, n);
    }
    fence_async_smem();  // dS, written by threads, is read by wgmma next
    team_sync();
    mbar_arrive(bars.empty_a(s));

    // step 3: dQ = dS . K of this warpgroup's query tiles, then dK = dS^T . Q
    // of its key tiles (rebuilt p: q arrives in q_s's place meanwhile), dS read
    // K-major and MN-major from the x boxes; one wgmma group per output tile,
    // unrolled over kMaxTiles chunks (a loop carried through a group, or more
    // than one accumulator in it, makes ptxas serialise the group: C7515)
    if constexpr (kSaved) mbar_wait(bars.full_q(s), ph);  // k and q
#pragma unroll
    for (int which = 0; which < 2; ++which) {  // dQ of query tile t, dK of key tile t
      if (!kSaved && which == 1) mbar_wait(bars.full_q(s), ph);
      for (int t = kRank; t < T; t += kStep) {
        float acc[32];
        zero(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          const int steps = min(4, (R - j * kTile) / 16);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (j < T && kk < steps) {
              if (which == 0)
                wgmma_ss_t<0, 1>(acc, desc(sl.xbox(j) + t * kBox + 32 * kk),
                                 desc(sl.tile(sl.k, j) + 2048 * kk));
              else
                wgmma_ss_t<1, 1>(acc, desc(sl.xbox(t) + j * kBox + 2048 * kk),
                                 desc(sl.tile(sl.q, j) + 2048 * kk));
            }
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        store_rows(out + which * prm.d, d3, acc, t * kTile + lr_a, t * kTile + lr_b, n);
      }
    }
    mbar_arrive(bars.empty_b(s));
  }
}

// Producer of one resident pipeline (one thread). Per item: group A (v, g),
// which step 2 frees; group B (saved: the p boxes; rebuilt: q for q_s, and
// k), which step 3 frees; then what only step 3 reads (saved: q and k;
// rebuilt: q again once step 2 is done with q_s).
template <bool kSaved>
__device__ __forceinline__ void produce_resident(const Params& prm, uint32_t base, int pipe,
                                                 int npipe, const CUtensorMap* qkv_map,
                                                 const CUtensorMap* g_map,
                                                 const CUtensorMap* p_map) {
  const ResBars bars{base + pipe * kResBarBytes};
  const uint32_t rb = prm.R * kRowBytes;
  for (int k = 0, item = blockIdx.x * npipe + pipe; item < prm.items;
       ++k, item += gridDim.x * npipe) {
    const int s = k % prm.slots;
    const uint32_t ph = (k / prm.slots) & 1;
    const int b = item / prm.heads, h = item - b * prm.heads;
    const Slot sl = slot_of(prm, base, pipe, s);
    const int cq = h * kHeadDim, ck = prm.d + cq, cv = 2 * prm.d + cq;
    if (k >= prm.slots) mbar_wait(bars.empty_a(s), ph ^ 1);
    mbar_expect_tx(bars.full_a(s), 2u * rb);
    tma_load(sl.v, qkv_map, bars.full_a(s), cv, 0, b);
    tma_load(sl.g, g_map, bars.full_a(s), cq, 0, b);
    if (k >= prm.slots) mbar_wait(bars.empty_b(s), ph ^ 1);
    if constexpr (kSaved) {
      for (int j = 0; j < prm.T; ++j) {
        mbar_expect_tx(bars.full_p(s, j), rb);
        tma_load(sl.xbox(j), p_map, bars.full_p(s, j), j * kTile, 0, item);
      }
      mbar_expect_tx(bars.full_q(s), 2u * rb);
      tma_load(sl.q, qkv_map, bars.full_q(s), cq, 0, b);
      tma_load(sl.k, qkv_map, bars.full_q(s), ck, 0, b);
    } else {
      mbar_expect_tx(bars.full_b(s), 2u * rb);
      tma_load(sl.q, qkv_map, bars.full_b(s), cq, 0, b);
      tma_load(sl.k, qkv_map, bars.full_b(s), ck, 0, b);
      mbar_wait(bars.empty_a(s), ph);  // step 2 is done with q_s
      mbar_expect_tx(bars.full_q(s), rb);
      tma_load(sl.q, qkv_map, bars.full_q(s), cq, 0, b);
    }
  }
}

// ---- the streamed form (beyond kResidentMax) ---------------------------------

// A pipeline's area: two slots of the owned tile (two boxes each), a ring of
// kStages stages of three boxes, then its statistics (512 rows of each).
constexpr uint32_t kOwnBytes = 2 * kBox;
constexpr uint32_t kStageBytes = 3 * kBox;
constexpr int kStreamSpan = 512;
constexpr uint32_t kStreamStats = 3 * kStreamSpan * 4;
constexpr uint32_t kPipeBytes = 2 * kOwnBytes + kStages * kStageBytes + kStreamStats;

struct StreamBars {
  uint32_t at;
  __device__ uint32_t own_full(int i) const { return at + 8u * i; }
  __device__ uint32_t own_empty(int i) const { return at + 8u * (2 + i); }
  __device__ uint32_t stage_full(int i) const { return at + 8u * (4 + i); }
  __device__ uint32_t stage_empty(int i) const { return at + 8u * (4 + kStages + i); }
};
constexpr uint32_t kStreamBarBytes = 8u * (4 + 2 * kStages);

// The boxes of step `step` (0, 1, 2) for own tile `t` and chunk `c`:
// box index 0..1 of the owned tile, 0..2 of a stage. Each names (which, rows
// from, source): which 0, 1, 2 = q, k, v of qkv, 3 = g, 4 = p (rows of the
// own tile against the chunk's keys, or the chunk's queries against the own
// tile's keys).
struct BoxSpec {
  int which, row, col;  // col: the p box's first key
};

// saved: g_i | v_j | g_i; rebuilt: q_i, g_i | k_j, v_j | q_i, g_i
template <bool kSaved>
__device__ __forceinline__ BoxSpec own_box(int step, int t, int idx) {
  const int r = t * kTile;
  if constexpr (kSaved) return BoxSpec{step == 1 ? 2 : 3, r, 0};
  if (step == 1) return BoxSpec{idx == 0 ? 1 : 2, r, 0};
  return BoxSpec{idx == 0 ? 0 : 3, r, 0};
}

template <bool kSaved>
__device__ __forceinline__ int stage_boxes(int step) {
  // saved: p_ij, v_j | p_cj, g_c, q_c | p_ij, v_j, k_j
  // rebuilt: k_j, v_j | q_c (scaled), g_c, q_c | k_j, v_j
  if constexpr (kSaved) return step == 0 ? 2 : 3;
  return step == 1 ? 3 : 2;
}

template <bool kSaved>
__device__ __forceinline__ BoxSpec stage_box(int step, int t, int c, int idx) {
  const int rt = t * kTile, rc = c * kTile;
  if constexpr (kSaved) {
    if (step == 1) {
      if (idx == 0) return BoxSpec{4, rc, rt};
      return BoxSpec{idx == 1 ? 3 : 0, rc, 0};
    }
    if (idx == 0) return BoxSpec{4, rt, rc};
    return BoxSpec{idx == 1 ? 2 : 1, rc, 0};
  } else {
    if (step == 1) return BoxSpec{idx == 1 ? 3 : 0, rc, 0};
    return BoxSpec{idx == 0 ? 1 : 2, rc, 0};
  }
}

__device__ __forceinline__ void load_box(uint32_t dst, const BoxSpec& bs, uint32_t bar,
                                         const Params& prm, int b, int h, int item,
                                         const CUtensorMap* qkv_map, const CUtensorMap* g_map,
                                         const CUtensorMap* p_map) {
  if (bs.which < 3)
    tma_load(dst, qkv_map, bar, bs.which * prm.d + h * kHeadDim, bs.row, b);
  else if (bs.which == 3)
    tma_load(dst, g_map, bar, h * kHeadDim, bs.row, b);
  else
    tma_load(dst, p_map, bar, bs.col, bs.row, item);
}

template <bool kSaved>
__device__ __forceinline__ void produce_stream(const Params& prm, uint32_t base, int pipe,
                                               const CUtensorMap* qkv_map,
                                               const CUtensorMap* g_map,
                                               const CUtensorMap* p_map) {
  const StreamBars bars{base + pipe * kStreamBarBytes};
  const uint32_t area = base + prm.off_slots + pipe * prm.slot_bytes;
  const int T = prm.T;
  int u = 0, v = 0;  // own slots and stages filled so far
  for (int item = blockIdx.x * 2 + pipe; item < prm.items; item += gridDim.x * 2) {
    const int b = item / prm.heads, h = item - b * prm.heads;
    for (int step = 0; step < 3; ++step) {
      for (int t = 0; t < T; ++t, ++u) {
        const int os = u & 1;
        if (u >= 2) mbar_wait(bars.own_empty(os), ((u >> 1) - 1) & 1);
        const int nb = kSaved ? 1 : 2;
        mbar_expect_tx(bars.own_full(os), nb * kBox);
        for (int i = 0; i < nb; ++i)
          load_box(area + os * kOwnBytes + i * kBox, own_box<kSaved>(step, t, i),
                   bars.own_full(os), prm, b, h, item, qkv_map, g_map, p_map);
        for (int c = 0; c < T; ++c, ++v) {
          const int ss = v % kStages;
          if (v >= kStages) mbar_wait(bars.stage_empty(ss), ((v / kStages) - 1) & 1);
          const int nsb = stage_boxes<kSaved>(step);
          mbar_expect_tx(bars.stage_full(ss), nsb * kBox);
          for (int i = 0; i < nsb; ++i)
            load_box(area + 2 * kOwnBytes + ss * kStageBytes + i * kBox,
                     stage_box<kSaved>(step, t, c, i), bars.stage_full(ss), prm, b, h, item,
                     qkv_map, g_map, p_map);
        }
      }
    }
  }
}

// q * scale in place in one box (rebuilt p), for this warpgroup's wgmma.
__device__ __forceinline__ void scale_box(unsigned char* box, float scale, int tid, int wg) {
  scale_q(box, int(kBox / 16), scale, tid, 128);
  named_sync(1 + wg, 128);
}

template <bool kSaved, int kWg>
__device__ __forceinline__ void consume_stream(const Params& prm, unsigned char* smem, int tid) {
  const uint32_t base = smem_u32(smem);
  const StreamBars bars{base + kWg * kStreamBarBytes};
  const uint32_t area = base + prm.off_slots + kWg * prm.slot_bytes;
  unsigned char* area_p = smem + (area - base);
  float* st = reinterpret_cast<float*>(area_p + 2 * kOwnBytes + kStages * kStageBytes);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int lr_a = warp * 16 + g;
  const int n = prm.n, T = prm.T, d3 = 3 * prm.d;
  int u = 0, v = 0;
  auto own = [&](int i) { return area + (u & 1) * kOwnBytes + i * kBox; };
  auto stage = [&](int i) { return area + 2 * kOwnBytes + (v % kStages) * kStageBytes + i * kBox; };
  auto wait_own = [&]() { mbar_wait(bars.own_full(u & 1), (u >> 1) & 1); };
  auto free_own = [&]() { mbar_arrive(bars.own_empty(u & 1)); ++u; };
  auto wait_stage = [&](int) { mbar_wait(bars.stage_full(v % kStages), (v / kStages) & 1); };
  auto free_stage = [&](int) { mbar_arrive(bars.stage_empty(v % kStages)); ++v; };

  for (int item = blockIdx.x * 2 + kWg; item < prm.items; item += gridDim.x * 2) {
    const int b = item / prm.heads, h = item - b * prm.heads;
    __nv_bfloat16* out = prm.dqkv + static_cast<size_t>(b) * n * d3 + h * kHeadDim + 2 * t4;

    // step 1: statistics, tile by tile
    for (int i = 0; i < T; ++i) {
      const int row_a = i * kTile + lr_a, row_b = row_a + 8;
      wait_own();
      if constexpr (kSaved) {
        stats_saved(st, kStreamSpan, own(0), [&](int) { return stage(0); },
                    [&](int) { return stage(1); }, wait_stage, free_stage, kTile * T, row_a,
                    row_b, lr_a, t4);
      } else {
        scale_box(area_p + (own(0) - area), prm.scale, tid, kWg);
        stats_rebuilt(st, kStreamSpan, own(0), own(1), [&](int) { return stage(0); },
                      [&](int) { return stage(1); }, wait_stage, free_stage, row_a, row_b, prm,
                      t4);
      }
      free_own();
    }
    named_sync(1 + kWg, 128);

    // step 2: dK and dV, key tile by key tile
    for (int j = 0; j < T; ++j) {
      const int key_a = j * kTile + lr_a, key_b = key_a + 8;
      const Bounds bnd = kSaved ? bounds_of(key_a, key_b, n, 0)
                                : bounds_of(key_a, key_b, n, prm.block_len);
      float dv[32], dk[32];
      zero(dv);
      zero(dk);
      wait_own();
      for (int c = 0; c < T; ++c) {
        wait_stage(c);
        if constexpr (!kSaved) scale_box(area_p + (stage(0) - area), prm.scale, tid, kWg);
        float sc[32], dp[32];
        uint32_t pt[4][4], dst[4][4];
        if constexpr (kSaved) load_pt(pt, stage(0), 0, warp, lane);
        wgmma_fence();
        if constexpr (!kSaved) wgmma_nt_k64(sc, desc(own(0)), desc(stage(0)));
        wgmma_nt_k64(dp, desc(own(kSaved ? 0 : 1)), desc(stage(1)));
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (!kSaved) reg_fence(sc);
        reg_fence(dp);
        ds_cols<kSaved>(pt, dst, sc, dp, st, kStreamSpan, bnd, c * kTile, prm.scale, t4);
        wgmma_fence();
        wgmma_rn(dv, pt, stage(1), 4);
        wgmma_rn(dk, dst, stage(2), 4);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dv);
        reg_fence(dk);
        reg_fence(pt);
        reg_fence(dst);
        free_stage(c);
      }
      free_own();
      store_rows(out + prm.d, d3, dk, key_a, key_b, n);
      store_rows(out + 2 * prm.d, d3, dv, key_a, key_b, n);
    }

    // step 3: dQ, query tile by query tile, dS rebuilt from the statistics
    for (int i = 0; i < T; ++i) {
      const int row_a = i * kTile + lr_a, row_b = row_a + 8;
      const Bounds bnd = kSaved ? bounds_of(row_a, row_b, n, 0)
                                : bounds_of(row_a, row_b, n, prm.block_len);
      float dq[32];
      zero(dq);
      wait_own();
      if constexpr (!kSaved) scale_box(area_p + (own(0) - area), prm.scale, tid, kWg);
      for (int j = 0; j < T; ++j) {
        wait_stage(j);
        float sc[32], dp[32];
        uint32_t pa[4][4], ds[4][4];
        if constexpr (kSaved) load_p(pa, stage(0), 0, warp, lane);
        wgmma_fence();
        if constexpr (!kSaved) wgmma_nt_k64(sc, desc(own(0)), desc(stage(0)));
        wgmma_nt_k64(dp, desc(own(kSaved ? 0 : 1)), desc(stage(1)));
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (!kSaved) reg_fence(sc);
        reg_fence(dp);
        ds_rows<kSaved>(pa, ds, sc, dp, st, kStreamSpan, bnd, j * kTile, row_a, row_b,
                        prm.scale, t4);
        wgmma_fence();
        wgmma_rn(dq, ds, stage(kSaved ? 2 : 0), 4);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq);
        reg_fence(ds);
        free_stage(j);
      }
      free_own();
      store_rows(out, d3, dq, row_a, row_b, n);
    }
    named_sync(1 + kWg, 128);  // step 3 is done with the statistics
  }
}

// ---- the kernel -------------------------------------------------------------

template <bool kSaved, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
mha_qkv_bwd_kernel(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap g_map,
                   const __grid_constant__ CUtensorMap p_map, const Params prm) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  constexpr int kPipes = kMode == kTeam2 ? 1 : 2;
  constexpr int kTeamThreads = kMode == kTeam2 ? 256 : 128;
  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();  // the swizzled boxes need 1024-byte alignment
    for (int p = 0; p < kPipes; ++p) {
      if constexpr (kMode == kStream) {
        const StreamBars bars{base + p * kStreamBarBytes};
        for (int i = 0; i < 2; ++i) {
          mbar_init(bars.own_full(i), 1);
          mbar_init(bars.own_empty(i), 128);
        }
        for (int i = 0; i < kStages; ++i) {
          mbar_init(bars.stage_full(i), 1);
          mbar_init(bars.stage_empty(i), 128);
        }
      } else {
        const ResBars bars{base + p * kResBarBytes};
        for (int i = 0; i < prm.slots; ++i) {
          mbar_init(bars.full_a(i), 1);
          mbar_init(bars.full_b(i), 1);
          mbar_init(bars.full_q(i), 1);
          mbar_init(bars.empty_a(i), kTeamThreads);
          mbar_init(bars.empty_b(i), kTeamThreads);
          for (int j = 0; j < kMaxTiles; ++j) mbar_init(bars.full_p(i, j), 1);
        }
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role of this thread's warpgroup, broadcast from lane 0 so that the
  // compiler sees a warp-uniform branch into each role's setmaxnreg region.
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pipe = (threadIdx.x - 256) / 32;
    if (pipe >= kPipes || (threadIdx.x & 31) != 0) return;
    if constexpr (kMode == kStream)
      produce_stream<kSaved>(prm, base, pipe, &qkv_map, &g_map, &p_map);
    else
      produce_resident<kSaved>(prm, base, pipe, kPipes, &qkv_map, &g_map, &p_map);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (role == 0) {
      if constexpr (kMode == kStream)
        consume_stream<kSaved, 0>(prm, smem, threadIdx.x);
      else
        consume_resident<kSaved, kMode, 0>(prm, smem, threadIdx.x);
    } else {
      if constexpr (kMode == kStream)
        consume_stream<kSaved, 1>(prm, smem, threadIdx.x - 128);
      else
        consume_resident<kSaved, kMode, 1>(prm, smem, threadIdx.x - 128);
    }
  }
}

// The form and the shared memory of a launch: resident up to kResidentMax
// tokens (one pipeline per warpgroup where two slots fit, else one shared),
// streamed beyond. Returns the bytes to allocate, 0 if nothing fits.
uint32_t plan(Params& prm, int& mode) {
  const uint32_t rb = prm.R * kRowBytes;
  if (prm.n > kResidentMax) {
    mode = kStream;
    prm.slots = 0;
    prm.stats_bytes = 0;
    prm.off_slots = kBarPage;
    prm.slot_bytes = kPipeBytes;
    return kBarPage + 2 * kPipeBytes;
  }
  prm.stats_bytes = (3u * kTile * prm.T * 4u + 1023u) / 1024u * 1024u;
  prm.slot_bytes = (4u + prm.T) * rb;
  // the 64-row tiles read up to 64 T - R rows past the last box
  const uint32_t pad = (kTile * prm.T - prm.R) * kRowBytes;
  // one pipeline per warpgroup only where a warpgroup can own every tile
  for (int pipes = prm.T <= kMaxOwn ? 2 : 1; pipes >= 1; --pipes) {
    prm.off_slots = kBarPage + pipes * prm.stats_bytes;
    const uint32_t fixed = prm.off_slots + pad;
    if (fixed >= kSmemLimit) continue;
    const int slots = static_cast<int>((kSmemLimit - fixed) / (pipes * prm.slot_bytes));
    if (slots >= 1) {
      mode = pipes == 2 ? kTeam1 : kTeam2;
      prm.slots = slots < kMaxSlots ? slots : kMaxSlots;
      return fixed + pipes * prm.slots * prm.slot_bytes;
    }
  }
  return 0;
}

// A 3-D map (cols, rows, outer) over bf16 rows of `cols` values, boxes of 64
// columns x box_rows rows, 128-byte swizzled; rows past `rows` arrive as zeros.
bool encode_3d(CUtensorMap* map, EncodeTiledFn encode, const void* ptr, int cols, int rows,
               int outer, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * 2 * rows};
  const cuuint32_t box[3] = {kHeadDim, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kSaved>
int launch_bwd(const void* qkv, const void* g, const void* probs, void* dqkv, int p_stride,
               int batch, int n, int num_heads, float scale, int block_len, void* stream) {
  // The grid is persistent (at most one block per SM) and every offset is 64-bit:
  // the batch is bounded only by the item count (an int) and the tensor maps'
  // dimensions (below 2^32).
  if (batch < 1 || n < 1 || n > kMaxSeq || num_heads < 1 ||
      static_cast<long long>(batch) * num_heads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kSaved && (p_stride < n || p_stride % 8 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  prm.scale = scale;
  prm.n = n;
  prm.d = num_heads * kHeadDim;
  prm.heads = num_heads;
  prm.items = batch * num_heads;
  prm.T = (n + kTile - 1) / kTile;
  prm.R = (n + 15) / 16 * 16;
  prm.block_len = kSaved ? 0 : block_len;
  int mode = kTeam2;
  const uint32_t smem_bytes = plan(prm, mode);
  if (smem_bytes == 0 || smem_bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);

  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int box_rows = mode == kStream ? kTile : prm.R;
  CUtensorMap qkv_map, g_map, p_map;
  if (!encode_3d(&qkv_map, encode, qkv, 3 * prm.d, n, batch, box_rows) ||
      !encode_3d(&g_map, encode, g, prm.d, n, batch, box_rows) ||
      !encode_3d(&p_map, encode, kSaved ? probs : qkv, kSaved ? p_stride : 3 * prm.d, n,
                 kSaved ? prm.items : batch, box_rows))
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = mode == kTeam1   ? mha_qkv_bwd_kernel<kSaved, kTeam1>
                : mode == kTeam2 ? mha_qkv_bwd_kernel<kSaved, kTeam2>
                                 : mha_qkv_bwd_kernel<kSaved, kStream>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pipes = mode == kTeam2 ? 1 : 2;
  const int blocks = (prm.items + pipes - 1) / pipes;
  const int grid = blocks < sms ? blocks : sms;
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(qkv_map, g_map,
                                                                           p_map, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv, dqkv: (batch, n, 3 * num_heads * 64) bf16; g: (batch, n, num_heads * 64)
// bf16; probs: (batch, num_heads, n, p_stride) bf16 as tpuwsi_mha_qkv_fwd_saved
// wrote it. All contiguous and 16-byte aligned, p_stride a multiple of 8 and
// at least n. 1 <= n <= 511.
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
