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
// write dQ (116 MB), 0.17 ms at 3.35 TB/s, against 3 products (S, dP, dS.K)
// of 2*B*H*S*S*64 = 91 GFLOP each: 0.28 ms at the dense bf16 peak. dK/dV
// reads the same and writes two outputs (0.21 ms) against 4 products (S^T,
// dP^T, P^T.dO, dS^T.Q): 0.37 ms. Both are bound by the tensor cores, and the
// B*H*S*S = 710 M exponentials and ~8 other instructions a score of each
// kernel weigh about half as much again; they overlap the products only
// across warpgroups and across neighbouring stages.
//
// Why two kernels, S and dP computed in both (7 products where the math
// needs 5): a key-major single pass would add every key block's share of dQ
// into every query row. At the step's shape that is 1,152 heads x 7 key
// blocks x 201 KB of fp32 partials, ~3.2 GB through L2 read and written, more
// than the two products it saves (0.18 ms at peak); atomics would give other
// bits on every launch.
//
// What this design does about it (the forward, flash_fwd.cu, is the model):
//   - every product is wgmma m64n64k16 (hopper.cuh). A consumer warpgroup
//     owns 64 rows: query rows in dQ, key rows in dK/dV;
//   - dQ: S = q . K^T and dP = dO . V^T from shared memory (K-major, four k16
//     steps each); p = 2^(s scale log2 e - lse log2 e) is one fma and one ex2,
//     with the row's lse and delta held in registers for the item; dS is
//     rounded to bf16 pairs in registers, the A operand of dQ += dS . K, K read
//     MN-major from the same stage (as P.V reads V in the forward). An item is
//     (b, h, 192 query rows): three consumer warpgroups share each 64-key K/V
//     stage;
//   - dK/dV, the transposed form: K and V of the item's 128 keys stay in
//     shared memory as the A operands of S^T = K . Q^T and dP^T = V . dO^T;
//     p^T and dS^T, rounded to bf16 pairs in registers, are the A operands of
//     dV += P^T . dO and dK += dS^T . Q, with dO and Q read MN-major. A
//     64-query stage carries Q, dO and its 64 lse and 64 delta values. Two
//     consumer warpgroups of 232 registers (setmaxnreg) hold the two
//     accumulators, the two score tiles and their packed halves (three of
//     160 spilled and serialised the wgmma: 2.1 ms against 0.93 on the H100,
//     PERF.md);
//   - the elementwise work overlapped with the products: in both kernels a
//     stage's S and dP are issued together with the previous stage's
//     accumulating products, and the elementwise work of the stage runs while
//     those do (wgmma.wait_group 1); the warpgroups of a block cover each
//     other besides. No running max and no rescale are needed;
//   - loads off the consumers' path: one producer thread issues TMA loads
//     through 4-D tensor maps (64 columns, rows, heads, batch) built on the
//     host from the strides, into 128-byte swizzled shared memory; rows past
//     Sq or Sk arrive as zeros. The item's own rows go to one of two slots,
//     the streamed rows to a ring of kStages stages; every load completes on
//     an mbarrier and the consumers release by arriving on another, so no
//     block-wide barrier remains. lse and delta rows are 4 * Sq bytes apart
//     (not a multiple of 16, so no tensor map): the producer warp copies a
//     stage's 64 + 64 values with 4-byte cp.async, zero past Sq, whose
//     completion arrives on the stage's mbarrier;
//   - the ragged ends need almost no masking: a query past Sq has q = dO = 0
//     and lse = delta = 0, so p = 1 meets dO = 0 in dV and gives dS = 0; a key
//     past Sk has k = v = 0 and its rows of dK/dV are not stored, but in dQ
//     its p is set to 0 (in the last key tile only: its own copy of the loop
//     body), because exp(-lse) there has no bound;
//   - persistent grids, one block per SM walking (b, h, row tile) items: the
//     row tiles of one (b, h) run side by side on neighbouring blocks, so the
//     streamed operands leave device memory once and come from L2 after, and
//     the next item's first loads start while this one writes;
//   - every output element has one writer and a fixed summation order: two
//     launches on the same inputs give the same bits.
// What still holds it (PERF.md; an H100 SXM at 700 W): copies with a part
// cut out show the parts adding up more than overlapping. At the step's
// shape dK/dV takes 0.69 ms with no elementwise work at all, where its
// m64n64 products (half of them with both operands from shared memory)
// would take 0.44 ms at the tensor peak on tiles padded to 64 rows, and
// ~0.25 ms more with it; dQ 0.46 ms (0.36 at peak) and ~0.14 more. ptxas
// places the wait for the accumulating products after the first few
// exponentials (the SASS shows it), but keeping those products in flight
// across stages, with two sets of pairs so that the SASS runs all the
// elementwise work between them, gave no gain in dK/dV and lost 0.1 ms in
// dQ: the overlap inside a warpgroup is not what holds them. Wider products
// (128-row stages) need more registers than a warpgroup has while two stages
// overlap.
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
constexpr int kRows = 64;   // rows a consumer warpgroup owns
constexpr int kTile = 64;   // rows of a streamed stage (FLASH_TILE_K keys in dQ)
constexpr uint32_t kBoxBytes = kTile * kHeadDim * 2;  // 8 KB, 128 B a row
constexpr uint32_t kRowBytes = kHeadDim * 2;
constexpr int kSlots = 2;   // the item's own rows: this item's and the next one's
constexpr int kStages = 8;  // streamed rows
constexpr float kLog2e = 1.4426950408889634f;

// dQ: three consumer warpgroups of 64 query rows share each 64-key K/V stage.
namespace dq_cfg {
constexpr int kConsumers = 3;  // at most 3 (the role dispatch)
constexpr int kTileOwn = kConsumers * kRows;        // query rows of an item
constexpr uint32_t kOwnBytes = kTileOwn * kRowBytes;  // q (then dO) of an item: 24 KB
constexpr uint32_t kSlotBytes = 2 * kOwnBytes;
constexpr int kThreads = 128 * (kConsumers + 1);     // + one producer warpgroup
constexpr int kConsumerThreads = 128 * kConsumers;
// setmaxnreg: 128 x 24 (producer) + 384 x 160 (consumers) = 64 K registers
constexpr int kProducerRegs = 24, kConsumerRegs = 160;
constexpr uint32_t kOffStage = kSlots * kSlotBytes;              // K, V stages
constexpr uint32_t kOffBar = kOffStage + kStages * 2 * kBoxBytes;
constexpr uint32_t kSmemBytes = kOffBar + 8u * 2u * (kSlots + kStages);
static_assert(kSmemBytes <= 232448, "227 KB of shared memory a block");
}  // namespace dq_cfg

// dK/dV: two consumer warpgroups of 64 key rows share each 64-query stage.
namespace dkv_cfg {
constexpr int kConsumers = 2;  // at most 3 (the role dispatch)
constexpr int kTileOwn = kConsumers * kRows;          // key rows of an item
constexpr uint32_t kOwnBytes = kTileOwn * kRowBytes;  // k (then v) of an item: 16 KB
constexpr uint32_t kSlotBytes = 2 * kOwnBytes;
constexpr uint32_t kStatBytes = 2 * kTile * 4;        // a stage's lse, then delta
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConsumerThreads = 128 * kConsumers;
// setmaxnreg: 128 x 40 (producer) + 256 x 232 (consumers) = 63 K registers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr uint32_t kOffStage = kSlots * kSlotBytes;  // Q, dO stages
constexpr uint32_t kOffStat = kOffStage + kStages * 2 * kBoxBytes;
constexpr uint32_t kOffBar = kOffStat + kStages * kStatBytes;
constexpr uint32_t kSmemBytes = kOffBar + 8u * 2u * (kSlots + kStages);
static_assert(kSmemBytes <= 232448, "227 KB of shared memory a block");
}  // namespace dkv_cfg

struct Params {
  const float* lse;    // (batch, heads, sq), contiguous
  const float* delta;
  __nv_bfloat16* out0;  // dq, or dk
  __nv_bfloat16* out1;  // dv
  long long o_b, o_h, o_r;  // element strides of the outputs
  float scale, scale_log2;  // scale, and scale * log2 e
  int heads, sq, sk, tiles, items;  // tiles: row tiles of an item's own rows
};

// mbarriers: slot full, slot empty, stage full, stage empty.
struct Bars {
  uint32_t at;
  __device__ uint32_t slot_full(int i) const { return at + 8u * i; }
  __device__ uint32_t slot_empty(int i) const { return at + 8u * (kSlots + i); }
  __device__ uint32_t stage_full(int i) const { return at + 8u * (2 * kSlots + i); }
  __device__ uint32_t stage_empty(int i) const { return at + 8u * (2 * kSlots + kStages + i); }
};

struct Item {
  int b, h, t;  // batch element, head, tile of the item's own rows
};

__device__ __forceinline__ Item item_of(const Params& prm, int item) {
  Item it;
  const int bh = item / prm.tiles;
  it.t = item - bh * prm.tiles;
  it.b = bh / prm.heads;
  it.h = bh - it.b * prm.heads;
  return it;
}

// The swizzled-tile descriptor of a shared address, formed next to its use.
__device__ __forceinline__ uint64_t desc(uint32_t addr) { return sw128_desc(opaque(addr)); }

// 4 bytes from device to shared memory, asynchronously; with !valid nothing
// is read and 4 zero bytes land.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread has issued has landed;
// .noinc: the barrier's expected count includes it.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Rows a and b of a 64 x 64 fp32 accumulator -> bf16 at row stride o_r.
__device__ __forceinline__ void store_rows(__nv_bfloat16* o, long long o_r, const float (&acc)[32],
                                           int row_a, int row_b, int rows) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (row_a < rows)
      *reinterpret_cast<uint32_t*>(o + row_a * o_r + 8 * i) = pack_bf16(acc[4 * i], acc[4 * i + 1]);
    if (row_b < rows)
      *reinterpret_cast<uint32_t*>(o + row_b * o_r + 8 * i) =
          pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ---- dQ --------------------------------------------------------------------

// The two query rows of this thread: -lse log2 e and delta (0 past Sq).
struct RowStats {
  float nl_a, nl_b, dl_a, dl_b;
};

// dS of one key tile in place of s (this thread's 32 of the 64 x 64 tile:
// regs 4i, 4i+1 row a, 4i+2, 4i+3 row b, keys 8i + 2t and 8i + 2t + 1):
// p = 2^(s scale log2 e - lse log2 e) in fp32, 0 for a key at or past Sk
// (kMask: the last tile), dS = p (dP - delta) scale.
template <bool kMask>
__device__ __forceinline__ void ds_rows(float (&s)[32], const float (&dp)[32], const RowStats& r,
                                        float scale_log2, float scale, int key0, int sk, int t4) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool row_b = e & 2;
      float p = exp2_approx(fmaf(s[4 * i + e], scale_log2, row_b ? r.nl_b : r.nl_a));
      if (kMask && key0 + 8 * i + 2 * t4 + (e & 1) >= sk) p = 0.f;
      s[4 * i + e] = p * (dp[4 * i + e] - (row_b ? r.dl_b : r.dl_a)) * scale;
    }
  }
}

// One consumer warpgroup's walk over the items; kWg (0 .. kConsumers - 1) is
// a template argument so that every branch around a wgmma is uniform by
// construction.
template <int kWg>
__device__ __forceinline__ void consume_dq(const Params& prm, uint32_t base, int tid) {
  using namespace dq_cfg;
  const Bars bars{base + kOffBar};
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n = (prm.sk + kTile - 1) / kTile;  // key tiles of every item

  int u = 0, kv = 0;  // items taken so far, K/V stages taken so far
  for (int item = blockIdx.x; item < prm.items; item += gridDim.x, ++u, kv += n) {
    const Item it = item_of(prm, item);
    const int slot = u % kSlots;
    const uint32_t slot_parity = (u / kSlots) & 1;
    auto stage = [&](int j) { return (kv + j) % kStages; };
    auto wait_kv = [&](int j) { mbar_wait(bars.stage_full(stage(j)), ((kv + j) / kStages) & 1); };
    auto k_addr = [&](int j) { return base + kOffStage + stage(j) * 2 * kBoxBytes; };
    const int row0 = it.t * kTileOwn + kWg * kRows;
    if (row0 >= prm.sq) {
      // No row of this warpgroup is a query (the last tile of a sequence):
      // only release the slot and the stages, each after its load, so that
      // the release counts toward that load's phase.
      mbar_wait(bars.slot_full(slot), slot_parity);
      mbar_arrive(bars.slot_empty(slot));
      for (int j = 0; j < n; ++j) {
        wait_kv(j);
        mbar_arrive(bars.stage_empty(stage(j)));
      }
      continue;
    }
    const int row_a = row0 + warp * 16 + g, row_b = row_a + 8;
    const size_t bh = static_cast<size_t>(it.b) * prm.heads + it.h;
    const float* lse = prm.lse + bh * prm.sq;
    const float* delta = prm.delta + bh * prm.sq;
    RowStats r{0.f, 0.f, 0.f, 0.f};
    if (row_a < prm.sq) {
      r.nl_a = -lse[row_a] * kLog2e;
      r.dl_a = delta[row_a];
    }
    if (row_b < prm.sq) {
      r.nl_b = -lse[row_b] * kLog2e;
      r.dl_b = delta[row_b];
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mbar_wait(bars.slot_full(slot), slot_parity);
    const uint32_t q_addr = base + slot * kSlotBytes + kWg * kRows * kRowBytes;
    const uint32_t do_addr = q_addr + kOwnBytes;

    // key tile 0: its S and dP alone
    float s[32], dp[32];
    uint32_t ds[4][4];
    wait_kv(0);
    {
      const uint64_t dq_ = desc(q_addr), dk = desc(k_addr(0)), dd = desc(do_addr),
                     dv = desc(k_addr(0) + kBoxBytes);
      wgmma_fence();
      wgmma_nt_k64(s, dq_, dk);
      wgmma_nt_k64(dp, dd, dv);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
    }
    if (n == 1) {
      mbar_arrive(bars.slot_empty(slot));
      ds_rows<true>(s, dp, r, prm.scale_log2, prm.scale, 0, prm.sk, t4);
    } else {
      ds_rows<false>(s, dp, r, prm.scale_log2, prm.scale, 0, prm.sk, t4);
    }
    pack_a(s, ds);

    // key tile j: its S and dP issued with tile j-1's dQ += dS . K; the
    // elementwise work of j runs while that product does, its pairs are
    // packed after it (ptxas sees no use of a wgmma's register operand after
    // the issue, so pairs packed while it runs would make it serialise). The
    // last tile masks and frees the slot.
    auto step = [&](int j, auto last) {
      constexpr bool kLast = decltype(last)::value;
      wait_kv(j);
      const uint64_t dq_ = desc(q_addr), dk = desc(k_addr(j)), dd = desc(do_addr),
                     dv = desc(k_addr(j) + kBoxBytes), dk_prev = desc(k_addr(j - 1));
      wgmma_fence();
      wgmma_nt_k64(s, dq_, dk);
      wgmma_nt_k64(dp, dd, dv);
      wgmma_commit();
      wgmma_rn_k64(acc, ds, dk_prev);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(s);
      reg_fence(dp);
      if (kLast) mbar_arrive(bars.slot_empty(slot));
      ds_rows<kLast>(s, dp, r, prm.scale_log2, prm.scale, j * kTile, prm.sk, t4);
      reg_fence(s);  // computed before the wait, not sunk past it
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(ds);
      reg_fence(s);
      mbar_arrive(bars.stage_empty(stage(j - 1)));
      pack_a(s, ds);
    };
    for (int j = 1; j < n - 1; ++j) step(j, std::false_type{});
    if (n > 1) step(n - 1, std::true_type{});

    // the last tile's dQ += dS . K
    {
      const uint64_t dk = desc(k_addr(n - 1));
      wgmma_fence();
      wgmma_rn_k64(acc, ds, dk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(ds);
    }
    mbar_arrive(bars.stage_empty(stage(n - 1)));
    store_rows(prm.out0 + it.b * prm.o_b + it.h * prm.o_h + 2 * t4, prm.o_r, acc, row_a, row_b,
               prm.sq);
  }
}

// 512 threads: warpgroups 0, 1 and 2 consume, warpgroup 3's first thread
// produces. setmaxnreg moves the producer's registers to the consumers.
__global__ void __launch_bounds__(dq_cfg::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const Params prm) {
  using namespace dq_cfg;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const Bars bars{base + kOffBar};
  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();  // the swizzled tiles need 1024-byte alignment
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(bars.slot_full(i), 1);
      mbar_init(bars.slot_empty(i), kConsumerThreads);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bars.stage_full(i), 1);
      mbar_init(bars.stage_empty(i), kConsumerThreads);
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
    // Producer: q and dO of each item, then its K/V stages, as far ahead as
    // the rings allow.
    const int n = (prm.sk + kTile - 1) / kTile;
    int u = 0, kv = 0;
    for (int item = blockIdx.x; item < prm.items; item += gridDim.x, ++u) {
      const Item it = item_of(prm, item);
      const int slot = u % kSlots;
      if (u >= kSlots) mbar_wait(bars.slot_empty(slot), ((u / kSlots) - 1) & 1);
      mbar_expect_tx(bars.slot_full(slot), kSlotBytes);
      const uint32_t own = base + slot * kSlotBytes;
      tma_load_4d(own, &q_map, bars.slot_full(slot), 0, it.t * kTileOwn, it.h, it.b);
      tma_load_4d(own + kOwnBytes, &do_map, bars.slot_full(slot), 0, it.t * kTileOwn, it.h, it.b);
      for (int j = 0; j < n; ++j, ++kv) {
        const int st = kv % kStages;
        if (kv >= kStages) mbar_wait(bars.stage_empty(st), ((kv / kStages) - 1) & 1);
        mbar_expect_tx(bars.stage_full(st), 2 * kBoxBytes);
        const uint32_t dst = base + kOffStage + st * 2 * kBoxBytes;
        tma_load_4d(dst, &k_map, bars.stage_full(st), 0, j * kTile, it.h, it.b);
        tma_load_4d(dst + kBoxBytes, &v_map, bars.stage_full(st), 0, j * kTile, it.h, it.b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (role == 0) {
      consume_dq<0>(prm, base, threadIdx.x);
    } else if (role == 1) {
      consume_dq<1>(prm, base, threadIdx.x - 128);
    } else if constexpr (kConsumers > 2) {
      consume_dq<2>(prm, base, threadIdx.x - 256);
    }
  }
}

// ---- dK/dV -----------------------------------------------------------------

// p^T and dS^T of one query stage in place of s and dp (this thread's 32 of
// the 64 keys x 64 queries: regs 4i, 4i+1 key a, 4i+2, 4i+3 key b, queries
// 8i + 2t and 8i + 2t + 1), with the stage's lse and delta from shared
// memory at `stats` (64 of each).
__device__ __forceinline__ void ds_cols(float (&s)[32], float (&dp)[32], const float* stats,
                                        float scale_log2, float scale, int t4) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(stats + 8 * i + 2 * t4);
    const float2 dl = *reinterpret_cast<const float2*>(stats + kTile + 8 * i + 2 * t4);
    const float nl0 = -l.x * kLog2e, nl1 = -l.y * kLog2e;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool odd = e & 1;
      const float p = exp2_approx(fmaf(s[4 * i + e], scale_log2, odd ? nl1 : nl0));
      s[4 * i + e] = p;
      dp[4 * i + e] = p * (dp[4 * i + e] - (odd ? dl.y : dl.x)) * scale;
    }
  }
}

template <int kWg>
__device__ __forceinline__ void consume_dkv(const Params& prm, unsigned char* smem, int tid) {
  using namespace dkv_cfg;
  const uint32_t base = smem_u32(smem);
  const Bars bars{base + kOffBar};
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n = (prm.sq + kTile - 1) / kTile;  // query stages of every item

  int u = 0, qs = 0;  // items taken so far, Q/dO stages taken so far
  for (int item = blockIdx.x; item < prm.items; item += gridDim.x, ++u, qs += n) {
    const Item it = item_of(prm, item);
    const int slot = u % kSlots;
    const uint32_t slot_parity = (u / kSlots) & 1;
    auto stage = [&](int j) { return (qs + j) % kStages; };
    auto wait_q = [&](int j) { mbar_wait(bars.stage_full(stage(j)), ((qs + j) / kStages) & 1); };
    auto q_addr = [&](int j) { return base + kOffStage + stage(j) * 2 * kBoxBytes; };
    auto stats = [&](int j) {
      return reinterpret_cast<const float*>(smem + kOffStat + stage(j) * kStatBytes);
    };
    const int key0 = it.t * kTileOwn + kWg * kRows;
    if (key0 >= prm.sk) {
      // No key of this warpgroup: only release the slot and the stages.
      mbar_wait(bars.slot_full(slot), slot_parity);
      mbar_arrive(bars.slot_empty(slot));
      for (int j = 0; j < n; ++j) {
        wait_q(j);
        mbar_arrive(bars.stage_empty(stage(j)));
      }
      continue;
    }
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(bars.slot_full(slot), slot_parity);
    const uint32_t k_addr = base + slot * kSlotBytes + kWg * kRows * kRowBytes;
    const uint32_t v_addr = k_addr + kOwnBytes;

    // query stage 0: its S^T and dP^T alone
    float s[32], dp[32];
    uint32_t pt[4][4], dst[4][4];
    wait_q(0);
    {
      const uint64_t dk_ = desc(k_addr), dq_ = desc(q_addr(0)), dv_ = desc(v_addr),
                     dd = desc(q_addr(0) + kBoxBytes);
      wgmma_fence();
      wgmma_nt_k64(s, dk_, dq_);
      wgmma_nt_k64(dp, dv_, dd);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
    }
    if (n == 1) mbar_arrive(bars.slot_empty(slot));
    ds_cols(s, dp, stats(0), prm.scale_log2, prm.scale, t4);
    pack_a(s, pt);
    pack_a(dp, dst);

    // query stage j: its S^T and dP^T issued with stage j-1's dV += P^T . dO
    // and dK += dS^T . Q; the elementwise work of j runs while those do.
    auto step = [&](int j, auto last) {
      constexpr bool kLast = decltype(last)::value;
      wait_q(j);
      const uint64_t dk_ = desc(k_addr), dq_ = desc(q_addr(j)), dv_ = desc(v_addr),
                     dd = desc(q_addr(j) + kBoxBytes), dq_prev = desc(q_addr(j - 1)),
                     dd_prev = desc(q_addr(j - 1) + kBoxBytes);
      wgmma_fence();
      wgmma_nt_k64(s, dk_, dq_);
      wgmma_nt_k64(dp, dv_, dd);
      wgmma_commit();
      wgmma_rn_k64(dv, pt, dd_prev);
      wgmma_rn_k64(dk, dst, dq_prev);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(s);
      reg_fence(dp);
      if (kLast) mbar_arrive(bars.slot_empty(slot));
      ds_cols(s, dp, stats(j), prm.scale_log2, prm.scale, t4);
      reg_fence(s);
      reg_fence(dp);
      wgmma_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
      reg_fence(pt);
      reg_fence(dst);
      reg_fence(s);
      reg_fence(dp);
      mbar_arrive(bars.stage_empty(stage(j - 1)));
      pack_a(s, pt);
      pack_a(dp, dst);
    };
    for (int j = 1; j < n - 1; ++j) step(j, std::false_type{});
    if (n > 1) step(n - 1, std::true_type{});

    // the last stage's dV and dK
    {
      const uint64_t dq_ = desc(q_addr(n - 1)), dd = desc(q_addr(n - 1) + kBoxBytes);
      wgmma_fence();
      wgmma_rn_k64(dv, pt, dd);
      wgmma_rn_k64(dk, dst, dq_);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
      reg_fence(pt);
      reg_fence(dst);
    }
    mbar_arrive(bars.stage_empty(stage(n - 1)));
    const int key_a = key0 + warp * 16 + g, key_b = key_a + 8;
    const long long off = it.b * prm.o_b + it.h * prm.o_h + 2 * t4;
    store_rows(prm.out0 + off, prm.o_r, dk, key_a, key_b, prm.sk);
    store_rows(prm.out1 + off, prm.o_r, dv, key_a, key_b, prm.sk);
  }
}

// 384 threads: warpgroups 0 and 1 consume, warpgroup 2's first warp
// produces (its first thread the TMA loads, all 32 the row statistics).
__global__ void __launch_bounds__(dkv_cfg::kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map, const Params prm) {
  using namespace dkv_cfg;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const Bars bars{base + kOffBar};
  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(bars.slot_full(i), 1);
      mbar_init(bars.slot_empty(i), kConsumerThreads);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bars.stage_full(i), 1 + 32);  // the TMA loads' arrival + 32 cp.async arrivals
      mbar_init(bars.stage_empty(i), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= kConsumerThreads + 32) return;
    // Producer warp: K and V of each item, then its Q/dO stages with their
    // lse and delta, as far ahead as the rings allow.
    const int lane = threadIdx.x & 31;
    const int n = (prm.sq + kTile - 1) / kTile;
    int u = 0, qs = 0;
    for (int item = blockIdx.x; item < prm.items; item += gridDim.x, ++u) {
      const Item it = item_of(prm, item);
      const int slot = u % kSlots;
      if (lane == 0) {
        if (u >= kSlots) mbar_wait(bars.slot_empty(slot), ((u / kSlots) - 1) & 1);
        mbar_expect_tx(bars.slot_full(slot), kSlotBytes);
        const uint32_t own = base + slot * kSlotBytes;
        tma_load_4d(own, &k_map, bars.slot_full(slot), 0, it.t * kTileOwn, it.h, it.b);
        tma_load_4d(own + kOwnBytes, &v_map, bars.slot_full(slot), 0, it.t * kTileOwn, it.h,
                    it.b);
      }
      const size_t bh = static_cast<size_t>(it.b) * prm.heads + it.h;
      const float* lse = prm.lse + bh * prm.sq;
      const float* delta = prm.delta + bh * prm.sq;
      for (int j = 0; j < n; ++j, ++qs) {
        const int st = qs % kStages;
        if (qs >= kStages) mbar_wait(bars.stage_empty(st), ((qs / kStages) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(bars.stage_full(st), 2 * kBoxBytes);
          const uint32_t dst = base + kOffStage + st * 2 * kBoxBytes;
          tma_load_4d(dst, &q_map, bars.stage_full(st), 0, j * kTile, it.h, it.b);
          tma_load_4d(dst + kBoxBytes, &do_map, bars.stage_full(st), 0, j * kTile, it.h, it.b);
        }
        const uint32_t stat = base + kOffStat + st * kStatBytes;
        for (int r = lane; r < kTile; r += 32) {
          const int i = j * kTile + r;
          const bool ok = i < prm.sq;
          cp_async_4(stat + 4 * r, lse + (ok ? i : 0), ok);
          cp_async_4(stat + 4 * (kTile + r), delta + (ok ? i : 0), ok);
        }
        cp_async_arrive(bars.stage_full(st));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (role == 0) {
      consume_dkv<0>(prm, smem, threadIdx.x);
    } else if (role == 1) {
      consume_dkv<1>(prm, smem, threadIdx.x - 128);
    } else if constexpr (kConsumers > 2) {
      consume_dkv<2>(prm, smem, threadIdx.x - 256);
    }
  }
}

using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const CUtensorMap,
                        const Params);

// Encode the four maps (q and dO in boxes of q_box rows, k and v of k_box),
// fill the parameters and launch `kernel` on a persistent grid; items are
// (b, h, tile of item_rows of own_rows).
int launch(Kernel kernel, int threads, uint32_t smem_bytes, int q_box, int k_box, int own_rows,
           int item_rows, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* out0, void* out1, int batch, int heads,
           int sq, int sk, const long long* strides, float scale, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (own_rows + item_rows - 1) / item_rows;
  const long long items = static_cast<long long>(batch) * heads * tiles;
  if (items > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_rows_4d(&q_map, encode, q, sq, heads, batch, strides, q_box) ||
      !encode_rows_4d(&k_map, encode, k, sk, heads, batch, strides + 3, k_box) ||
      !encode_rows_4d(&v_map, encode, v, sk, heads, batch, strides + 3, k_box) ||
      !encode_rows_4d(&do_map, encode, dout, sq, heads, batch, strides + 6, q_box))
    return static_cast<int>(cudaErrorInvalidValue);

  Params prm{};
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<const float*>(delta);
  prm.out0 = static_cast<__nv_bfloat16*>(out0);
  prm.out1 = static_cast<__nv_bfloat16*>(out1);
  prm.o_b = strides[9];
  prm.o_h = strides[10];
  prm.o_r = strides[11];
  prm.scale = scale;
  prm.scale_log2 = scale * kLog2e;
  prm.heads = heads;
  prm.sq = sq;
  prm.sk = sk;
  prm.tiles = tiles;
  prm.items = static_cast<int>(items);

  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = prm.items < sms ? prm.items : sms;
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(q_map, k_map, v_map,
                                                                           do_map, prm);
  return static_cast<int>(cudaGetLastError());
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
  return launch(flash_bwd_dq_kernel, dq_cfg::kThreads, dq_cfg::kSmemBytes, dq_cfg::kTileOwn, kTile, sq,
                dq_cfg::kTileOwn, q, k, v, dout, lse, delta, dq, nullptr, batch, heads, sq, sk,
                strides, scale, stream);
}

// dk and dv share their strides.
int tpuwsi_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int batch,
                         int heads, int sq, int sk, const long long* strides, float scale,
                         void* stream) {
  return launch(flash_bwd_dkv_kernel, dkv_cfg::kThreads, dkv_cfg::kSmemBytes, kTile, dkv_cfg::kTileOwn, sk,
                dkv_cfg::kTileOwn, q, k, v, dout, lse, delta, dk, dv, batch, heads, sq, sk, strides,
                scale, stream);
}

}  // extern "C"
