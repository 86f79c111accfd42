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
// exp(s - m') would be exp(0) = 1. Key tiles are 64 keys (FLASH_TILE_K), as
// in the plain version, so the running max moves at the same points.
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
// 2 * 2 * B*H*S*S*64 = 182 GFLOP: 0.184 ms at the dense bf16 peak. The
// B*H*S*S = 710 M exponentials take about as long again on the
// special-function units (~0.18 ms at 16 a cycle per SM), and the rest of
// the softmax (max, fma, sum, rounding, rescale: ~5 instructions a score)
// about 0.13 ms of issue. So the kernel is bound by the tensor cores and the
// softmax together, and comes near 0.2 ms only if the two overlap.
//
// What this design does about it:
//   - tensor cores at their Hopper rate: both products are wgmma. A consumer
//     warpgroup owns 64 query rows: S = q . K^T is m64n64k16 from shared
//     memory (q and K, K-major), four k16 steps a key tile, fp32 in
//     registers; p is packed to bf16 pairs in registers, which are the A
//     operand of P.V (m64n64k16 per 16 keys, V MN-major from shared memory):
//     the accumulator layout of one m64 wgmma is the A-fragment layout of the
//     next;
//   - the softmax overlapped with the products: within a warpgroup, tile j's
//     S and tile j-1's P.V are issued together and the softmax of tile j
//     runs while P.V does (wgmma.wait_group 1); across the three consumer
//     warpgroups, which share each K/V tile (an item is 192 query rows of one
//     (b, h)), the scheduler runs one warpgroup's softmax while the others'
//     products run. Three warpgroups rather than two hide more of each one's
//     serial chain (S, softmax, rescale) and read K and V from L2 once per
//     192 rows instead of 128 (PERF.md); a warpgroup whose 64 rows all lie
//     past Sq (the last item of a 785-token sequence holds 17 rows) only
//     releases the q slot and the K/V stages of the walk;
//   - fewer instructions a score: the row max is taken on the raw scores and
//     scaled once, so p = 2^(s * scale log2 e - m) is one fma and one ex2
//     (a negative scale negates q in the product instead, imm-scale-a = -1);
//     o is normalised by one reciprocal a row;
//   - loads off the consumers' path: one producer thread issues TMA loads
//     through 4-D tensor maps (64 columns, rows, heads, batch) built on the
//     host from the strides, so the qkv views and contiguous tensors are the
//     same to it; rows past Sq or Sk arrive as zeros. The q tile goes to one
//     of two slots, K and V to a ring of kStages 64-key stages, in 128-byte
//     swizzled shared memory (one head row is 128 bytes; the wgmma
//     descriptors name the same swizzle). Each load completes on an
//     mbarrier; the consumers release a stage or a slot by arriving on
//     another, so no block-wide barrier remains in the key loop. The producer
//     stops at the element's valid length, and key tiles past it are never
//     loaded nor multiplied;
//   - the key mask only in the tile that holds the end of the keys: the last
//     tile of an item is its own copy of the loop body;
//   - a persistent grid: one block per SM walks (b, h, query tile) items;
//     the query tiles of one (b, h) run side by side on neighbouring blocks,
//     so its K and V come from L2 after the first read, and the next item's q
//     and first K/V stages load while this one finishes and writes o.
// What still holds it (PERF.md): each warpgroup's step is a serial chain (S,
// then ~150 softmax instructions, then the rescale) that three warpgroups do
// not fully hide; the K/V traffic from L2 is next in line.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError(). The tensor maps are
// encoded on the host at each launch (hopper.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kHeadDim = 64;
constexpr int kConsumers = 3;               // consumer warpgroups
constexpr int kRows = 64;                   // query rows of a consumer warpgroup
constexpr int kTileQ = kConsumers * kRows;  // query rows of an item
constexpr int kTileK = 64;                  // keys of a K/V stage (FLASH_TILE_K)
constexpr uint32_t kBoxBytes = kTileK * kHeadDim * 2;  // 8 KB, 128 B a row
constexpr uint32_t kQBytes = kTileQ * kHeadDim * 2;    // 8 KB a consumer warpgroup
constexpr int kQSlots = 2;
constexpr int kStages = 8;
constexpr int kThreads = 128 * (kConsumers + 1);  // consumer warpgroups + one producer warpgroup
constexpr int kConsumerThreads = 128 * kConsumers;
// setmaxnreg: 128 x 24 (producer) + 384 x 160 (consumers) = 64 K registers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
constexpr float kNegInf = -1e30f;  // finite, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory: q slots, then K/V stages (K box, V box), then mbarriers:
// q full, q empty, K/V full, K/V empty.
constexpr uint32_t kOffKV = kQSlots * kQBytes;
constexpr uint32_t kOffBar = kOffKV + kStages * 2 * kBoxBytes;
constexpr uint32_t kSmemBytes = kOffBar + 8u * 2u * (kQSlots + kStages);
static_assert(kSmemBytes <= 232448, "227 KB of shared memory a block");

struct Params {
  __nv_bfloat16* o;
  float* lse;
  const int* kv_lengths;
  long long o_b, o_h, o_r;  // element strides of o
  float scale_log2;         // |scale| * log2 e: the softmax runs in base 2
  int heads, sq, sk, q_tiles, items;
};

struct Item {
  int b, h, qt, klen, n_kt;  // klen valid keys in n_kt key tiles
};

__device__ __forceinline__ Item item_of(const Params& prm, int item) {
  Item it;
  const int bh = item / prm.q_tiles;
  it.qt = item - bh * prm.q_tiles;
  it.b = bh / prm.heads;
  it.h = bh - it.b * prm.heads;
  it.klen = prm.sk;
  if (prm.kv_lengths != nullptr) it.klen = min(max(prm.kv_lengths[it.b], 0), prm.sk);
  it.n_kt = (it.klen + kTileK - 1) / kTileK;
  return it;
}

// The running softmax state of this thread's two rows (a = 16w + g and
// b = 16w + g + 8 of its warpgroup's 64): max in base-2 units, and this
// thread's share of the row sum (the quad adds the shares at the end).
struct RowState {
  float m_a, m_b, l_a, l_b;
};

// One key tile's softmax on the raw scores s (this thread's 32 of the 64 x 64
// tile: regs 4i, 4i+1 row a, 4i+2, 4i+3 row b, keys 8i + 2t and 8i + 2t + 1),
// in place: mask (kMask: keys at or past klen), the row max of the raw
// scores times the scale (scale_log2 >= 0: the same as the max of the
// scaled ones) is the new max in base 2, p = 2^(s * scale_log2 - m') in fp32
// (one fma and one ex2 a score; 0 where masked), the row sums from it.
// Returns the factors 2^(m - m') that rescale acc.
template <bool kMask>
__device__ __forceinline__ float2 softmax_tile(float (&s)[32], RowState& st, float scale_log2,
                                               int key0, int klen, int t4) {
  auto masked = [&](int i, int e) { return kMask && key0 + 8 * i + 2 * t4 + (e & 1) >= klen; };
  float cm_a = kNegInf, cm_b = kNegInf;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (masked(i, e)) s[4 * i + e] = kNegInf;
    cm_a = fmaxf(cm_a, fmaxf(s[4 * i], s[4 * i + 1]));
    cm_b = fmaxf(cm_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  const float nm_a = fmaxf(st.m_a, quad_max(cm_a) * scale_log2);
  const float nm_b = fmaxf(st.m_b, quad_max(cm_b) * scale_log2);
  const float2 alpha = make_float2(exp2_approx(st.m_a - nm_a), exp2_approx(st.m_b - nm_b));
  st.m_a = nm_a;
  st.m_b = nm_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fmaf(s[4 * i + e], scale_log2, -((e & 2) ? nm_b : nm_a));
      x = exp2_approx(x);
      if (masked(i, e)) x = 0.f;
      s[4 * i + e] = x;
    }
    sum_a += s[4 * i] + s[4 * i + 1];
    sum_b += s[4 * i + 2] + s[4 * i + 3];
  }
  st.l_a = st.l_a * alpha.x + sum_a;
  st.l_b = st.l_b * alpha.y + sum_b;
  return alpha;
}

// p rounded to bf16 pairs: the A fragments of P.V, four k16 chunks. Packed
// only once the P.V that reads the previous tile's pairs has completed: ptxas
// sees no use of a wgmma's register operand after its issue, so pairs packed
// while it runs would share its registers and ptxas would serialise (C7513).
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&p)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* x = &s[8 * c];
    p[c][0] = pack_bf16(x[0], x[1]);
    p[c][1] = pack_bf16(x[2], x[3]);
    p[c][2] = pack_bf16(x[4], x[5]);
    p[c][3] = pack_bf16(x[6], x[7]);
  }
}

// The operands of one issue, described before the first wgmma: an
// instruction that defines a wgmma's input between the wgmma of one stage
// makes ptxas serialise them (C7513). For the same reason the accumulate
// flags are constants (acc starts at zero rather than with a flag computed
// at run time). Each k16 step is a constant away: 32 bytes of q and K (2
// descriptor units), 16 keys of V (2,048 bytes, 128 units).
struct Descs {
  uint64_t q, k, v;
};

__device__ __forceinline__ Descs descs(uint32_t q_addr, uint32_t k_addr, uint32_t v_addr) {
  return {sw128_desc(opaque(q_addr)), sw128_desc(opaque(k_addr)), sw128_desc(opaque(v_addr))};
}

// S = q . K^T of one key tile: four k16 steps of m64n64k16, q and K from
// shared memory, K-major. kNeg negates q in the product (imm-scale-a = -1):
// the launch passes |scale|, so that the row max of the raw scores, times
// the scale, is the row max of the scaled ones.
template <bool kNeg>
__device__ __forceinline__ void issue_scores(float (&s)[32], const Descs& d) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64<kNeg ? -1 : 1>(s, d.q + 2 * kk, d.k + 2 * kk, kk);
}

// acc += P . V of one key tile, four k16 steps.
__device__ __forceinline__ void issue_pv(float (&acc)[32], const uint32_t (&p)[4][4],
                                         const Descs& d) {
#pragma unroll
  for (int c = 0; c < 4; ++c) wgmma_n64_mn(acc, p[c], d.v + 128 * c, 1);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(r[c][e]);
}

// Fragment ownership (wgmma m64nN, PTX ISA): warp w of a warpgroup holds rows
// 16w..16w+15; lane = 4*g + t holds rows 16w+g and 16w+g+8, and of each
// 8-column group of an accumulator, columns 2t and 2t+1 (regs 4i, 4i+1 for row
// g; 4i+2, 4i+3 for row g+8). The register A operand has the layout of
// mma.m16n8k16's, so 16 columns of p packed to bf16 pairs are the A fragment
// of one k16 step of P.V.
//
// One consumer warpgroup's walk; kWg (0 .. kConsumers - 1) is a template
// argument so that every branch around a wgmma is uniform by construction.
template <bool kStats, bool kNeg, int kWg>
__device__ __forceinline__ void consume(const Params& prm, unsigned char* smem, int tid) {
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + kOffBar;
  auto q_full = [&](int i) { return bars + 8u * i; };
  auto q_empty = [&](int i) { return bars + 8u * (kQSlots + i); };
  auto kv_full = [&](int i) { return bars + 8u * (2 * kQSlots + i); };
  auto kv_empty = [&](int i) { return bars + 8u * (2 * kQSlots + kStages + i); };

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int lr_a = warp * 16 + g;  // this thread's first row of the 64 (the other is 8 on)
  const float sl2 = prm.scale_log2;

  int u = 0, kv = 0;  // items with keys taken so far, K/V tiles taken so far
  for (int item = blockIdx.x; item < prm.items; item += gridDim.x) {
    const Item it = item_of(prm, item);
    // the same in every lane, and visibly so to the compiler, which otherwise
    // takes the loop bounds around the wgmma for divergent and serialises it
    const int klen = __shfl_sync(0xffffffffu, it.klen, 0);
    const int n = __shfl_sync(0xffffffffu, it.n_kt, 0);
    const int row0 = it.qt * kTileQ + kWg * kRows;
    const int row_a = row0 + lr_a, row_b = row_a + 8;
    RowState st{kNegInf, kNegInf, 0.f, 0.f};
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (n > 0 && row0 >= prm.sq) {
      // No row of this warpgroup is a query (the last tile of a sequence):
      // only release the q slot and the K/V stages, each after its load, so
      // that the release counts toward that load's phase.
      const int slot = u % kQSlots;
      mbar_wait(q_full(slot), (u / kQSlots) & 1);
      mbar_arrive(q_empty(slot));
      for (int j = 0; j < n; ++j) {
        mbar_wait(kv_full((kv + j) % kStages), ((kv + j) / kStages) & 1);
        mbar_arrive(kv_empty((kv + j) % kStages));
      }
      kv += n;
      ++u;
      continue;
    }
    if (n > 0) {
      const int slot = u % kQSlots;
      mbar_wait(q_full(slot), (u / kQSlots) & 1);
      const uint32_t q_addr = base + slot * kQBytes + kWg * (kRows * 128);
      auto k_addr = [&](int i) { return base + kOffKV + (i % kStages) * 2 * kBoxBytes; };
      auto wait_kv = [&](int i) { mbar_wait(kv_full(i % kStages), (i / kStages) & 1); };

      // key tile 0: its scores alone
      float s[32];
      uint32_t p[4][4];
      wait_kv(kv);
      Descs d = descs(q_addr, k_addr(kv), 0);
      wgmma_fence();
      issue_scores<kNeg>(s, d);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (n == 1) {
        mbar_arrive(q_empty(slot));
        softmax_tile<true>(s, st, sl2, 0, klen, t4);
      } else {
        softmax_tile<false>(s, st, sl2, 0, klen, t4);
      }
      pack_p(s, p);

      // key tile j: its scores and tile j-1's P.V issued together; the
      // softmax of j runs while P.V does, its pairs are packed after. The
      // last tile masks and frees q.
      auto step = [&](int j, auto last) {
        constexpr bool kLast = decltype(last)::value;
        wait_kv(kv + j);
        const Descs d = descs(q_addr, k_addr(kv + j), k_addr(kv + j - 1) + kBoxBytes);
        wgmma_fence();
        issue_scores<kNeg>(s, d);
        wgmma_commit();
        issue_pv(acc, p, d);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        if (kLast) mbar_arrive(q_empty(slot));
        float2 alpha = softmax_tile<kLast>(s, st, sl2, j * kTileK, klen, t4);
        // The softmax's results are used only after the wait below; these
        // fences keep the compiler from sinking the exponentials past it in
        // the PTX (ptxas may still schedule the wait earlier: see PERF.md).
        fence_regs(s);
        reg_fence(st.l_a);
        reg_fence(st.l_b);
        reg_fence(alpha.x);
        reg_fence(alpha.y);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p);
        fence_regs(s);  // the pairs are packed from here on, not hoisted above the wait
        mbar_arrive(kv_empty((kv + j - 1) % kStages));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[4 * i] *= alpha.x;
          acc[4 * i + 1] *= alpha.x;
          acc[4 * i + 2] *= alpha.y;
          acc[4 * i + 3] *= alpha.y;
        }
        pack_p(s, p);
      };
      for (int j = 1; j < n - 1; ++j) step(j, std::false_type{});
      if (n > 1) step(n - 1, std::true_type{});

      // the last tile's P.V
      d = descs(0, 0, k_addr(kv + n - 1) + kBoxBytes);
      wgmma_fence();
      issue_pv(acc, p, d);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      mbar_arrive(kv_empty((kv + n - 1) % kStages));
      kv += n;
      ++u;
    }

    // o = acc / l (one reciprocal a row) rounded once; lse = m + log l; both
    // 0 for a row with no key
    const float l_a = quad_sum(st.l_a), l_b = quad_sum(st.l_b);
    const float inv_a = l_a == 0.f ? 1.f : 1.f / l_a, inv_b = l_b == 0.f ? 1.f : 1.f / l_b;
    __nv_bfloat16* o = prm.o + it.b * prm.o_b + it.h * prm.o_h + 2 * t4;
    __nv_bfloat16* o_a = o + row_a * prm.o_r;
    __nv_bfloat16* o_b = o + row_b * prm.o_r;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (row_a < prm.sq)
        *reinterpret_cast<uint32_t*>(o_a + 8 * i) = pack_bf16(acc[4 * i] * inv_a, acc[4 * i + 1] * inv_a);
      if (row_b < prm.sq)
        *reinterpret_cast<uint32_t*>(o_b + 8 * i) =
            pack_bf16(acc[4 * i + 2] * inv_b, acc[4 * i + 3] * inv_b);
    }
    if constexpr (kStats) {
      if (t4 == 0) {
        float* dst = prm.lse + static_cast<size_t>(it.b * prm.heads + it.h) * prm.sq;
        if (row_a < prm.sq) dst[row_a] = l_a == 0.f ? 0.f : st.m_a * kLn2 + logf(fmaxf(l_a, 1e-30f));
        if (row_b < prm.sq) dst[row_b] = l_b == 0.f ? 0.f : st.m_b * kLn2 + logf(fmaxf(l_b, 1e-30f));
      }
    }
  }
}

// 512 threads: warpgroups 0, 1 and 2 consume, warpgroup 3's first thread
// produces. setmaxnreg moves the producer's registers to the consumers.
template <bool kStats, bool kNeg>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const Params prm) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + kOffBar;
  auto q_full = [&](int i) { return bars + 8u * i; };
  auto q_empty = [&](int i) { return bars + 8u * (kQSlots + i); };
  auto kv_full = [&](int i) { return bars + 8u * (2 * kQSlots + i); };
  auto kv_empty = [&](int i) { return bars + 8u * (2 * kQSlots + kStages + i); };

  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();  // the swizzled tiles need 1024-byte alignment
    for (int i = 0; i < kQSlots; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), kConsumerThreads);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(kv_full(i), 1);
      mbar_init(kv_empty(i), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role of this thread's warpgroup, broadcast from lane 0 so that the
  // compiler sees a warp-uniform branch into each role's setmaxnreg region.
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumerThreads) return;
    // Producer: the q tile of each item, then its key tiles, as far ahead as
    // the ring allows.
    int u = 0, kv = 0;
    for (int item = blockIdx.x; item < prm.items; item += gridDim.x) {
      const Item it = item_of(prm, item);
      if (it.n_kt == 0) continue;
      const int slot = u % kQSlots;
      if (u >= kQSlots) mbar_wait(q_empty(slot), ((u / kQSlots) - 1) & 1);
      mbar_expect_tx(q_full(slot), kQBytes);
      tma_load_4d(base + slot * kQBytes, &q_map, q_full(slot), 0, it.qt * kTileQ, it.h, it.b);
      for (int j = 0; j < it.n_kt; ++j, ++kv) {
        const int s = kv % kStages;
        if (kv >= kStages) mbar_wait(kv_empty(s), ((kv / kStages) - 1) & 1);
        mbar_expect_tx(kv_full(s), 2 * kBoxBytes);
        const uint32_t dst = base + kOffKV + s * 2 * kBoxBytes;
        tma_load_4d(dst, &k_map, kv_full(s), 0, j * kTileK, it.h, it.b);
        tma_load_4d(dst + kBoxBytes, &v_map, kv_full(s), 0, j * kTileK, it.h, it.b);
      }
      ++u;
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (role == 0) {
      consume<kStats, kNeg, 0>(prm, smem, threadIdx.x);
    } else if (role == 1) {
      consume<kStats, kNeg, 1>(prm, smem, threadIdx.x - 128);
    } else {
      consume<kStats, kNeg, 2>(prm, smem, threadIdx.x - 256);
    }
  }
}

// A 4-D map (64 columns, rows, heads, batch) over one operand with the given
// element strides; boxes of 64 columns x box_rows rows, 128-byte swizzled.
bool encode_map(CUtensorMap* map, EncodeTiledFn encode, const void* ptr, int rows, int heads,
                int batch, const long long* strides, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHeadDim), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {kHeadDim, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, bytes,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kStats>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                     const void* kv_lengths, int batch, int heads, int sq, int sk,
                     const long long* strides, float scale, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1 || (kStats && lse == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = (sq + kTileQ - 1) / kTileQ;
  const long long items = static_cast<long long>(batch) * heads * q_tiles;
  if (items > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, encode, q, sq, heads, batch, strides, kTileQ) ||
      !encode_map(&k_map, encode, k, sk, heads, batch, strides + 3, kTileK) ||
      !encode_map(&v_map, encode, v, sk, heads, batch, strides + 3, kTileK))
    return static_cast<int>(cudaErrorInvalidValue);

  Params prm{};
  prm.o = static_cast<__nv_bfloat16*>(o);
  prm.lse = static_cast<float*>(lse);
  prm.kv_lengths = static_cast<const int*>(kv_lengths);
  prm.o_b = strides[6];
  prm.o_h = strides[7];
  prm.o_r = strides[8];
  prm.scale_log2 = fabsf(scale) * kLog2e;
  prm.heads = heads;
  prm.sq = sq;
  prm.sk = sk;
  prm.q_tiles = q_tiles;
  prm.items = static_cast<int>(items);

  auto kernel = scale < 0.f ? flash_fwd_kernel<kStats, true> : flash_fwd_kernel<kStats, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = prm.items < sms ? prm.items : sms;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(q_map, k_map, v_map,
                                                                             prm);
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
