// One fused pre-LN transformer block over [M, S, 256] bf16 sequences
// (HSIMAE-L's width: 16 heads of 16), on Hopper's tensor cores (sm_90a:
// wgmma, bulk async copies, mbarriers).
//
// Replaces the Pallas TPU kernel hsimae_tpu/ops/fused_block.py::_kernel
// (math _block_math) for the bfloat16 stream at D 256; D 64 and 128 run
// csrc/fused_block_wgmma.cu. Per sequence, rounding to bf16 where the
// reference (ops/fused_block.py::block_reference) does:
//
//   y  = bf16(LN1(x))                     f32 statistics, eps 1e-5
//   q, k, v = bf16(y W + b)               bf16 x bf16, f32 accumulators
//   o  = bf16(bf16(softmax(q k^T / 4)) v) per head (hd 16), softmax in f32
//   x  = bf16(x + bf16(o Wo + bo))
//   y2 = bf16(LN2(x))
//   x  = bf16(x + bf16(bf16(silu(y2 W1 + b1) * (y2 W3 + b3)) W2 + b2))
//
// What bounds it on an H100: operations. HSIMAE-L's block (SwiGLU hidden
// 684, padded to 688) at batch 4096 does ~234 GFLOP against ~300 MB of
// activations and packed weights, ~780 FLOP per byte, far above the card's
// bf16 balance point (~295): 0.24 ms at 989 TFLOP/s. The D 128 kernel's
// design instantiated at this width ran one math warpgroup a CTA on 64-row
// tiles (its q/k/v and residual filled shared memory), re-streamed the whole
// 1.59 MB pack from L2 for every 64 rows, and used 36 of 64 rows at S 36.
// This design:
//   * a CTA owns a tile of 128 rows of whole sequences (3 sequences of 36,
//     14 of 9); two consumer warpgroups (256 threads, so ptxas may give each
//     thread up to 255 registers) each own 64 rows and run every product on
//     them (wgmma M 64) from the same weight stages, so one warpgroup's
//     epilogues, LayerNorm and attention overlap the other's wgmmas, and
//     the pack streams from L2 once per 128 rows;
//   * attention runs by head group: q, k and v of 4 heads (64 columns) at a
//     time, [128 x 64] each, 128-byte swizzled in shared memory (no padding,
//     no bank conflicts); q goes into the group's 64-column atom of the o
//     operand, and attention on mma.sync m16n8k16 writes o over it (a unit
//     reads q and writes o of its own rows and head only); Wo runs once all
//     four groups are in, K 256, as two products of 128 output columns;
//   * no thread holds more than 64 accumulators of a wgmma in flight plus
//     64 of a finished one: with 128-column sums of 128 accumulators (Wo's
//     and W2's 256 columns at once) ptxas spilled and serialised the
//     wgmmas;
//   * x stays in global memory: LN1 reads it (a warp per row), the first
//     residual add reads it in the accumulator layout and stores x1 to the
//     output, from where LN2 reads it back (and the second residual add).
//     Shared memory: the ring (4 x 16 KB), the LN output (64 KB, the A
//     operand of q/k/v and of [W1 | W3]), q and o (64 KB; in the SwiGLU half
//     W2's f32 sums of output columns 128-255), one group's k and v (32 KB,
//     later the SwiGLU hidden tile);
//   * the SwiGLU half runs by 64 hidden columns: [W1 | W3] interleaved per
//     32 hidden columns, each an m64n64 product with the f32 silu gate in its
//     epilogue, the two into one 64-column hidden tile, then that tile's K
//     slice of W2 as two products of 128 output columns: the first summed
//     in registers across the hidden tiles, the second added into its f32
//     sums in shared memory;
//   * the weights are packed once per model
//     (ops/fused_block.py::pack_block_wgmma_d256) as bf16 tiles of up to 128
//     output rows x 64 K (one 128-byte swizzle atom) in the order the kernel
//     consumes them, so one plain cp.async.bulk puts each where the wgmma B
//     descriptor expects it. They stream through a ring of four 16 KB
//     stages (one K atom of a 128-row tile, or two of a 64-row one: with
//     8 KB stages the ring held too little to cover L2's latency), each
//     guarded by an mbarrier (bytes landed) and a counter of the warps done
//     with it; there is no producer warp (a ninth warp would hold every
//     thread to 168 registers): the consumer warp that releases a stage
//     last refills it at once, from a table of the stages' offsets;
//   * the grid is persistent: one CTA per SM walks the row tiles, and
//     prefetches the next tile's x into L2 during the SwiGLU half.
// What holds it back now (scripts/profile_fused_block.py, PERF.md): ~200 k
// SM clocks a 128-row tile against ~49 k of tensor-core work. The SwiGLU
// half takes 46% of them at ~30% of the tensor rate (its stages wait on the
// ring, W2's second half on its f32 sums in shared memory), attention
// 12-22% with both warpgroups in it at once (the CTA's barriers around each
// head group keep them in step) and the tensor cores idle. A 2-CTA cluster
// sharing the weight ring by multicast was measured 2.9x slower (PERF.md):
// its cross-CTA wait in the refill path made ptxas spill and serialise.
// Primitives (mbarriers, bulk copies, wgmma fences and descriptors) come
// from sm90_common.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace hsimae_sm90;
typedef __nv_bfloat16 bf16;

constexpr int kD = 256;
constexpr int kHeadDim = 16;
constexpr int kAtomK = 64;                      // bf16 K columns in one 128-byte swizzle atom
constexpr int kKA = kD / kAtomK;                // K atoms of a D-deep product: 4
constexpr int kGroupCols = 64;                  // q/k/v columns of a head group
constexpr int kGroups = kD / kGroupCols;        // 4
constexpr int kGroupHeads = kGroupCols / kHeadDim;  // 4
constexpr int kHidTile = 64;                    // hidden columns per W2 K atom
constexpr int kHidSub = 32;                     // hidden columns per [W1 | W3] product
constexpr int kRows = 128;                      // rows per tile, 64 per consumer warpgroup
constexpr int kThreads = 256;                   // two consumer warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;                      // weight ring depth
constexpr int kSlotBytes = 16384;               // one ring stage: <= 128 rows x 128 bytes
constexpr int kAtomBytes = kRows * 128;         // one 64-column atom of a 128-row operand
constexpr int kMaxSeq = 64;                     // a tile holds whole sequences
constexpr int kMaxHidden = 1024;               // the stage table below holds the pack's stages
constexpr int kMaxSmem = 232448;
// shared memory, every operand 1024-aligned
constexpr int kAOff = kStages * kSlotBytes;     // LN1(x), later LN2(x1): [128 x 256] A operand
constexpr int kOOff = kAOff + kKA * kAtomBytes;  // q, then o: [128 x 256] A operand of Wo
static_assert(kRows * 128 * 4 == kKA * kAtomBytes, "W2's f32 sums of 128 columns fill o's space");
constexpr int kKOff = kOOff + kKA * kAtomBytes;  // a group's k and v: [128 x 64] each; k's space
                                                 // holds the SwiGLU hidden tile
constexpr int kBarOff = kKOff + 2 * kAtomBytes;
constexpr int kCountOff = kBarOff + kStages * 8;      // per ring stage: warps that released it
constexpr int kTableOff = kCountOff + 16;              // per stage of the pack: its offset and bytes
static_assert(4 * kStages <= 16, "the counters fit before the table");
static_assert(kHeadDim == 16, "the attention scale 0.25 assumes head dim 16");
static_assert(kWarps == 2 * kGroupHeads, "attention: two warps a head of the group");

// The pack, in the order the kernel consumes it, per row tile: per head
// group, the K atoms of [q_g | k_g] (128 rows), then those of v_g (64 rows);
// the K atoms of Wo's output rows 0-127, then those of 128-255; per hidden
// tile of tw <= 64 columns, per 32 of them (sw <= 32) the K atoms of
// [W1 | W3] (2 sw rows), then the tile's K atom of W2, rows 0-127 then
// 128-255. Only the last hidden tile may be narrower than 64.
// A ring stage holds one K atom of a 128-row tile (q|k, Wo, W2) or two of a
// 64-row one (v, [W1 | W3]), so every stage but a narrow last one is 16 KB.
constexpr int kQKBytes = 128 * 128;
constexpr int kVBytes = 64 * 128;
constexpr int kGroupStages = kKA + kKA / 2;
constexpr int kGroupBytes = kKA * (kQKBytes + kVBytes);
constexpr int kWoStages = 2 * kKA;
constexpr int kHidStages = 2 * (kKA / 2) + 2;  // a 64-column hidden tile: two [W1 | W3], W2's halves
constexpr int kHidBytes = kKA * 2 * kHidTile * 128 + 2 * kSlotBytes;  // and its bytes
constexpr int kMaxStages = kGroups * kGroupStages + kWoStages + kMaxHidden / kHidTile * kHidStages;
constexpr int kSmem = kTableOff + 8 * kMaxStages + 1024;  // + slack to align the base
static_assert(kSmem <= kMaxSmem, "shared memory budget");

// Offsets into the packed f32 vector buffer, in the pack's order.
enum { V_LN1_S, V_LN1_B, V_BQ, V_BK, V_BV, V_BO, V_LN2_S, V_LN2_B, V_B2, V_NUM_D };

// Built with -DHSIMAE_PHASE_CLOCKS (scripts/profile_fused_block.py), the
// first thread of every CTA adds the SM clocks it spends in each phase of a
// tile into g_phase_clocks[phase] (only at phase ends: a clock around every
// ring wait cost enough registers to spill); without it PHASE_MARK is empty.
#ifdef HSIMAE_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[16];
#define PHASE_MARK(k)                                                  \
  if (threadIdx.x == 0) {                                              \
    const long long t1_ = clock64();                                   \
    atomicAdd(&g_phase_clocks[k], (unsigned long long)(t1_ - t0_));    \
    t0_ = t1_;                                                         \
  }
#else
#define PHASE_MARK(k)
#endif

// m64nNk16 bf16 x bf16 -> f32, A and B K-major from shared memory;
// d += A B, or d = A B when scale_d is 0.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// The weight stream: the pack is a fixed sequence of stages (the order
// above), streamed once per row tile. Before the first tile each CTA writes
// every stage's offset and bytes into a table in shared memory (stage_of);
// stage j of the stream goes into ring stage j % kStages. A ring stage is
// refilled by whichever consumer warp releases its previous contents last (a
// counter per ring stage in shared memory says which): a refill, inlined at
// every release, is a table read and one bulk copy.

// Stage a of the pack: its bytes, and where they start in the pack.
__device__ __forceinline__ void stage_of(int a, int hp, int& bytes, long long& off) {
  if (a < kGroups * kGroupStages) {
    const int i = a % kGroupStages;
    bytes = i < kKA ? kQKBytes : 2 * kVBytes;
    off = (long long)(a / kGroupStages) * kGroupBytes +
          (i < kKA ? i * kQKBytes : kKA * kQKBytes + (i - kKA) * 2 * kVBytes);
    return;
  }
  a -= kGroups * kGroupStages;
  off = (long long)kGroups * kGroupBytes;
  if (a < kWoStages) {
    bytes = kSlotBytes;
    off += (long long)a * kSlotBytes;
    return;
  }
  a -= kWoStages;
  // every hidden tile before t is 64 columns wide (96 KB); tile t is tw wide
  const int t = a / kHidStages, i = a % kHidStages, tw = min(kHidTile, hp - t * kHidTile);
  off += (long long)kWoStages * kSlotBytes + (long long)t * kHidBytes;
  const int nsub = (tw + kHidSub - 1) / kHidSub, per = kKA / 2;  // two K atoms a stage
  if (i < nsub * per) {  // [W1 | W3] of sub-tile i / per: only the last may be narrower
    const int sub = i / per, sw = min(kHidSub, tw - sub * kHidSub);
    bytes = 2 * (2 * sw * 128);
    off += sub * kKA * 2 * kHidSub * 128 + (i % per) * bytes;
  } else {  // W2's two halves
    bytes = kSlotBytes;
    off += kKA * 2 * tw * 128 + (i - nsub * per) * kSlotBytes;
  }
}

// Stages of the pack per row tile.
__device__ __forceinline__ int stage_count(int hp) {
  const int nfull = hp / kHidTile, rest = hp % kHidTile;
  return kGroups * kGroupStages + kWoStages + nfull * kHidStages +
         (rest ? (rest + kHidSub - 1) / kHidSub * (kKA / 2) + 2 : 0);
}

// A stage a consumer warp has taken: its shared address, ring stage, and
// place in the CTA's stream.
struct Slot {
  uint32_t addr;
  int stage;
  int seq;
};

// Ring position of a consumer warp; every consumer warp walks the same
// sequence of stages.
struct Ring {
  const uint8_t* image;
  uint32_t base;  // shared address of the aligned base: slots, barriers, counters, table
  int nstages;    // stages of the pack per row tile
  int total;      // stages this CTA streams: its row tiles x nstages
  int stage;
  uint32_t phase;
  int seq;        // stages taken so far
  __device__ __forceinline__ uint32_t full(int s) const { return base + kBarOff + 8 * s; }
  // issues stage a of the pack into ring stage s
  __device__ __forceinline__ void issue(int s, int a) const {
    uint32_t off, bytes;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(off), "=r"(bytes)
                 : "r"(base + kTableOff + 8 * a));
    mbar_expect_tx(full(s), bytes);
    bulk_load(base + s * kSlotBytes, image + off, bytes, full(s));
  }
  // waits until the current stage has landed and moves on
  __device__ __forceinline__ Slot take() {
    mbar_wait(full(stage), phase);
    const Slot sl{base + stage * kSlotBytes, stage, seq++};
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    return sl;
  }
  // one count per consumer warp on the slot's counter; the warp that
  // counts last refills the stage. The fences order every warp's reads of
  // the slot (its wgmmas waited for) before the refill's copy, as an empty
  // mbarrier would, without a wait loop in the products' pipeline
  __device__ __forceinline__ void release(const Slot& sl) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const uint32_t counter = base + kCountOff + 4 * sl.stage;
      uint32_t before;
      __threadfence_block();
      asm volatile("atom.shared.add.u32 %0, [%1], 1;" : "=r"(before) : "r"(counter) : "memory");
      if (before == kWarps - 1) {
        __threadfence_block();
        asm volatile("st.shared.u32 [%0], 0;" ::"r"(counter) : "memory");
        const int next = sl.seq + kStages;
        if (next < total) issue(sl.stage, next % nstages);
      }
    }
  }
};

// acc = A B (acc += A B when `accumulate`) for this warpgroup's 64 rows and
// N output columns: A from shared memory, K atoms kAtomBytes apart from
// a_addr; B in ring stages of APS K atoms (N rows x 128 bytes each); the last
// of the katoms K atoms has LAST K steps of 16. Each stage's wgmmas are one
// group; a stage is released as soon as its group is done, one group stays
// in flight.
template <int N, int LAST, int APS = 1>
__device__ __forceinline__ void product(float (&acc)[N / 2], Ring& ring, uint32_t a_addr,
                                        int katoms, bool accumulate) {
  Slot prev{};
  fence_regs(acc);
  for (int ka = 0; ka < katoms; ka += APS) {
    const Slot cur = ring.take();
    wg_fence();
#pragma unroll
    for (int i = 0; i < APS; ++i) {
      const uint32_t a = a_addr + (ka + i) * kAtomBytes, b = cur.addr + i * N * 128;
      if (ka + i < katoms - 1 || LAST == 4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<N>::mma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk),
                        accumulate || ((ka + i) | kk) != 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < LAST; ++kk)
          Wgmma<N>::mma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk),
                        accumulate || ((ka + i) | kk) != 0);
      }
    }
    wg_commit();
    if (ka > 0) {
      wg_wait<1>();
      ring.release(prev);
    }
    prev = cur;
  }
  wg_wait<0>();
  fence_regs(acc);
  ring.release(prev);
}

// Accumulator coordinates of this thread: rows er and er + 8 of the
// warpgroup's 64, columns 8 j + ec and 8 j + ec + 1.
struct AccPos {
  int er, ec;
  __device__ __forceinline__ AccPos() {
    const int lane = threadIdx.x & 31;
    er = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    ec = 2 * (lane & 3);
  }
};

// Element (r, c) of a [128 x 64] bf16 buffer in the 128-byte swizzle.
__device__ __forceinline__ const bf16* at(const uint8_t* buf, int r, int c) {
  return reinterpret_cast<const bf16*>(buf + sw128_row(r, c >> 3) + 2 * (c & 7));
}

// dst[row, c] = bf16(acc + bias[c]) for this warpgroup's rows and the N
// columns of acc: c < 64 into the [128 x 64] swizzled buffer dst0 (bias b0),
// 64 <= c < 128 into dst1 (bias b1).
template <int N>
__device__ __forceinline__ void store_biased(const float (&acc)[N / 2], uint8_t* dst0, uint8_t* dst1,
                                             const float* __restrict__ b0,
                                             const float* __restrict__ b1, int r_lo) {
  const AccPos p;
  const int row = r_lo + p.er;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint8_t* dst = j < 8 ? dst0 : dst1;
    const int jj = j & 7;
    const float2 bb = __ldg(reinterpret_cast<const float2*>((j < 8 ? b0 : b1) + 8 * jj + p.ec));
    *reinterpret_cast<uint32_t*>(dst + sw128_row(row, jj) + 2 * p.ec) =
        pack_bf16x2(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
    *reinterpret_cast<uint32_t*>(dst + sw128_row(row + 8, jj) + 2 * p.ec) =
        pack_bf16x2(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
  }
}

// y = bf16(LN(x) * scale + bias) for this warpgroup's 64 rows of the tile,
// x read from global memory (xr: the tile's first row; rows at or past
// nvalid read as zero; through the read-only path unless the kernel wrote
// them, CACHED false), one warp per row, eight columns a lane, four rows in
// flight (independent shuffle chains); y written as the swizzled A operand.
template <bool CACHED>
__device__ __forceinline__ void layer_norm_rows(const bf16* xr, uint8_t* as,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ bias, int r_lo,
                                                int nvalid) {
  constexpr int E = kD / 32;  // 8 columns a lane: one 16-byte chunk
  constexpr int U = 4;        // rows in flight per warp
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  float sc[E], bi[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    sc[e] = __ldg(scale + E * lane + e);
    bi[e] = __ldg(bias + E * lane + e);
  }
#pragma unroll 1
  for (int i0 = wl; i0 < 64; i0 += 4 * U) {
    float v[U][E], mu[U], sq[U];
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r_lo + i0 + 4 * u;
      const uint4* src = reinterpret_cast<const uint4*>(xr + (long long)r * kD + E * lane);
      raw[u] = r >= nvalid ? make_uint4(0, 0, 0, 0) : CACHED ? __ldg(src) : *src;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      mu[u] = 0.f;
#pragma unroll
      for (int e = 0; e < E / 2; ++e) {
        const float2 f = unpack_bf16x2(w[e]);
        v[u][2 * e] = f.x;
        v[u][2 * e + 1] = f.y;
        mu[u] += f.x + f.y;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) mu[u] += __shfl_xor_sync(0xffffffffu, mu[u], off);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mu[u] *= 1.f / kD;
      sq[u] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) sq[u] += (v[u][e] - mu[u]) * (v[u][e] - mu[u]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) sq[u] += __shfl_xor_sync(0xffffffffu, sq[u], off);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r_lo + i0 + 4 * u;
      const float inv = rsqrtf(sq[u] * (1.f / kD) + 1e-5f);
      uint32_t w[E / 2];
#pragma unroll
      for (int e = 0; e < E / 2; ++e)
        w[e] = pack_bf16x2((v[u][2 * e] - mu[u]) * inv * sc[2 * e] + bi[2 * e],
                           (v[u][2 * e + 1] - mu[u]) * inv * sc[2 * e + 1] + bi[2 * e + 1]);
      *reinterpret_cast<uint4*>(as + (lane >> 3) * kAtomBytes + sw128_row(r, lane & 7)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The first residual add on one of Wo's two products (output columns n0 +
// 8 j + ec, + 1 of rows er and er + 8): x1 = bf16(x + bf16(acc + bo)), x read
// from global memory (xr: the tile's first row), stored to out (orow) for
// rows below nvalid.
__device__ __forceinline__ void residual_half(const float (&acc)[64], const bf16* __restrict__ xr,
                                              bf16* orow, const float* __restrict__ bo, int n0,
                                              int r_lo, int nvalid) {
  const AccPos p;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + p.er + 8 * half;
    if (r >= nvalid) continue;
    const uint32_t* xrow = reinterpret_cast<const uint32_t*>(xr + (long long)r * kD + n0 + p.ec);
    uint32_t* orow2 = reinterpret_cast<uint32_t*>(orow + (long long)r * kD + n0 + p.ec);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bo + n0 + 8 * j + p.ec));
      const float2 xv = unpack_bf16x2(__ldg(xrow + 4 * j));  // columns 8 j + ec, + 1
      orow2[4 * j] = pack_bf16x2(xv.x + round_bf16(acc[4 * j + 2 * half] + b.x),
                                 xv.y + round_bf16(acc[4 * j + 2 * half + 1] + b.y));
    }
  }
}

// W2's f32 sums of output columns 128-255 in o's space (park): 128 rows of
// 128 floats, each warpgroup's 64 rows in its own rows of the four o atoms
// (16 rows of 512 bytes in each), so neither touches the other's o; the
// float2 at column 2 f of row r is stored at f ^ 4 (r % 8) (the eight rows
// of an accumulator access hit distinct banks in pairs).
__device__ __forceinline__ float2* park_at(float* park, int r, int f) {
  float* row = park + (((r & 63) >> 4) * kAtomBytes + (r >> 6) * (kAtomBytes / 2) + (r & 15) * 512) / 4;
  return reinterpret_cast<float2*>(row) + (f ^ ((r & 7) << 2));
}

// park = acc (first) or park + acc, for the thread's accumulator positions.
__device__ __forceinline__ void park_add(const float (&acc)[64], float* park, int r_lo,
                                         bool first) {
  const AccPos p;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + p.er + 8 * half;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float2* d = park_at(park, r, 4 * j + p.ec / 2);
      const float2 v = first ? make_float2(0.f, 0.f) : *d;
      *d = make_float2(v.x + acc[4 * j + 2 * half], v.y + acc[4 * j + 2 * half + 1]);
    }
  }
}

// The second residual add: out = bf16(x1 + bf16(W2 h + b2)) for rows below
// nvalid, W2 h of output columns 0-127 in acc and of 128-255 in park, x1
// read back from out, where this thread stored it.
__device__ __forceinline__ void residual_final(const float (&acc)[64], const float* park,
                                               bf16* orow, const float* __restrict__ b2, int r_lo,
                                               int nvalid) {
  const AccPos p;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + p.er + 8 * half;
    if (r >= nvalid) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(orow + (long long)r * kD + p.ec);
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // columns 8 i + ec, + 1
      const float2 b = __ldg(reinterpret_cast<const float2*>(b2 + 8 * i + p.ec));
      const float2 w = i < 16 ? make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1])
                              : *park_at(const_cast<float*>(park), r, 4 * (i - 16) + p.ec / 2);
      const float2 xv = unpack_bf16x2(row[4 * i]);
      row[4 * i] = pack_bf16x2(xv.x + round_bf16(w.x + b.x), xv.y + round_bf16(w.y + b.y));
    }
  }
}

__device__ __forceinline__ float silu_gate(float h1, float h3) {
  return __fdividef(h1, 1.f + __expf(-h1)) * h3;
}

// One hidden sub-tile of SW <= 32 columns at column c0 of the hidden tile:
// [W1 | W3] on LN2(x1) (A at a_wg) in one m64n(2 SW) product, then h =
// bf16(silu(h1 + b1) * (h3 + b3)) into the warpgroup's rows of the
// swizzled [128 x 64] tile hs (b1, b3 from the sub-tile's first column).
template <int SW>
__device__ __forceinline__ void hidden_sub(Ring& ring, uint32_t a_wg, uint8_t* hs,
                                           const float* __restrict__ b1,
                                           const float* __restrict__ b3, int r_lo, int c0) {
  float acc[SW];
  product<2 * SW, 4, 2>(acc, ring, a_wg, kKA, false);
  const AccPos p;
  const int row = r_lo + p.er;
#pragma unroll
  for (int j = 0; j < SW / 8; ++j) {
    const int col = 8 * j + p.ec;
    const float2 c1 = __ldg(reinterpret_cast<const float2*>(b1 + col));
    const float2 c3 = __ldg(reinterpret_cast<const float2*>(b3 + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i1 = 4 * j + 2 * half, i3 = 4 * (j + SW / 8) + 2 * half;
      *reinterpret_cast<uint32_t*>(hs + sw128_row(row + 8 * half, c0 / 8 + j) + 2 * p.ec) =
          pack_bf16x2(silu_gate(acc[i1] + c1.x, acc[i3] + c3.x),
                      silu_gate(acc[i1 + 1] + c1.y, acc[i3 + 1] + c3.y));
    }
  }
}

// The sub-tile of `width` (16 or 32) columns at column c0 of the hidden tile
// that starts at b1, b3.
__device__ __forceinline__ void hidden_sub_any(Ring& ring, uint32_t a_wg, uint8_t* hs,
                                               const float* __restrict__ b1,
                                               const float* __restrict__ b3, int r_lo, int c0,
                                               int width) {
  if (width == kHidSub) hidden_sub<kHidSub>(ring, a_wg, hs, b1 + c0, b3 + c0, r_lo, c0);
  else hidden_sub<16>(ring, a_wg, hs, b1 + c0, b3 + c0, r_lo, c0);
}

// The hidden tile's K slice of W2 (LAST K steps of 16): output columns 0-127
// into wacc (overwritten for the first tile), 128-255 added into park.
template <int LAST>
__device__ __forceinline__ void w2_tile(float (&wacc)[64], Ring& ring, uint32_t h_wg, float* park,
                                        int r_lo, bool first) {
  product<128, LAST>(wacc, ring, h_wg, 1, !first);
  float acc[64];
  product<128, LAST>(acc, ring, h_wg, 1, false);
  park_add(acc, park, r_lo, first);
}

// d += A B on mma.sync m16n8k16 (bf16 in, f32 accumulators), fragments in
// registers.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from shared memory as one bf16x2 (lo, hi).
__device__ __forceinline__ uint32_t lds_pair(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// o = bf16(bf16(softmax(q k^T * 0.25)) v) for the head group's 4 heads, per
// sequence, on mma.sync m16n8k16, whose K step of 16 is the head dim. Two
// warps take each head. A unit is one block of 16 query rows of one head:
// rows of one sequence (S > 8; ceil(S / 16) blocks per sequence) or of a
// group of 16 / S whole sequences (S <= 8), masked block-diagonally. Its
// logits (keys padded to KT blocks of 16, masked) are computed once into
// the accumulator fragments, the softmax runs in f32 on them (rows reduced
// across each quad), and P, rounded to bf16, is already the A fragment of
// P.V. A warp runs four units side by side (two for S > 32), independent
// chains that hide each other's latency. Row and key indices past a group
// are clamped onto its last row (their weights are 0; their outputs are not
// written). q comes from, and o goes out into, the group's atom og of the
// swizzled A operand of the output projection.
template <int KT>
__device__ __forceinline__ void attention(uint8_t* og, const uint8_t* ks, const uint8_t* vs, int S,
                                          int nseq) {
  const uint8_t* qs = og;  // o overwrites q, unit by unit
  constexpr int U = KT <= 2 ? 4 : 2, NSUB = kWarps / kGroupHeads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int per = S > 8 ? 1 : 16 / S;      // sequences per group
  const int mtiles = (per * S + 15) / 16;  // query blocks per group
  const int blocks = (nseq + per - 1) / per * mtiles;
  const int h = warp % kGroupHeads, col = kHeadDim * h;
  for (int b0 = warp / kGroupHeads; b0 < blocks; b0 += U * NSUB) {
    int base[U], rows[U], qb[U], qlo[U][2];
    uint32_t a[U][4];
    float lg[U][2 * KT][4];
#pragma unroll
    for (int w = 0; w < U; ++w) {
      const int b = min(b0 + w * NSUB, blocks - 1);
      const int grp = mtiles == 1 ? b : b / mtiles;
      base[w] = grp * per * S;
      rows[w] = min(per, nseq - grp * per) * S;
      qb[w] = 16 * (b - grp * mtiles);
      const int last = rows[w] - 1;
      const int q0 = min(qb[w] + g, last), q1 = min(qb[w] + g + 8, last);
      qlo[w][0] = per == 1 ? 0 : q0 - q0 % S;  // first key of each row's sequence
      qlo[w][1] = per == 1 ? 0 : q1 - q1 % S;
      a[w][0] = lds32(at(qs, base[w] + q0, col + 2 * t));
      a[w][1] = lds32(at(qs, base[w] + q1, col + 2 * t));
      a[w][2] = lds32(at(qs, base[w] + q0, col + 8 + 2 * t));
      a[w][3] = lds32(at(qs, base[w] + q1, col + 8 + 2 * t));
    }
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
      for (int w = 0; w < U; ++w) {
        const int key = base[w] + min(8 * j + g, rows[w] - 1);
        lg[w][j][0] = lg[w][j][1] = lg[w][j][2] = lg[w][j][3] = 0.f;
        mma16816(lg[w][j], a[w][0], a[w][1], a[w][2], a[w][3], lds32(at(ks, key, col + 2 * t)),
                 lds32(at(ks, key, col + 8 + 2 * t)));
      }
    }
    // rows g (fragment slots 0, 1) and g + 8 (slots 2, 3)
    float mx[U][2], sum[U][2];
#pragma unroll
    for (int w = 0; w < U; ++w) {
      mx[w][0] = mx[w][1] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t + (e & 1), lo = qlo[w][e >> 1];
          lg[w][j][e] = key >= lo && key < lo + S ? lg[w][j][e] * 0.25f : -INFINITY;
          mx[w][e >> 1] = fmaxf(mx[w][e >> 1], lg[w][j][e]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
      for (int w = 0; w < U; ++w) {
        mx[w][0] = fmaxf(mx[w][0], __shfl_xor_sync(0xffffffffu, mx[w][0], off));
        mx[w][1] = fmaxf(mx[w][1], __shfl_xor_sync(0xffffffffu, mx[w][1], off));
      }
    }
#pragma unroll
    for (int w = 0; w < U; ++w) {
      sum[w][0] = sum[w][1] = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lg[w][j][e] = __expf(lg[w][j][e] - mx[w][e >> 1]);
          sum[w][e >> 1] += lg[w][j][e];
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
      for (int w = 0; w < U; ++w) {
        sum[w][0] += __shfl_xor_sync(0xffffffffu, sum[w][0], off);
        sum[w][1] += __shfl_xor_sync(0xffffffffu, sum[w][1], off);
      }
    }
#pragma unroll
    for (int w = 0; w < U; ++w) {
      sum[w][0] = 1.f / sum[w][0];
      sum[w][1] = 1.f / sum[w][1];
    }
    float o[U][2][4];
#pragma unroll
    for (int w = 0; w < U; ++w) {
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) o[w][nn][0] = o[w][nn][1] = o[w][nn][2] = o[w][nn][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int w = 0; w < U; ++w) {
        const float(&l0)[4] = lg[w][2 * kk];
        const float(&l1)[4] = lg[w][2 * kk + 1];
        const float s0 = sum[w][0], s1 = sum[w][1];  // reciprocals
        const uint32_t p0 = pack_bf16x2(l0[0] * s0, l0[1] * s0);
        const uint32_t p1 = pack_bf16x2(l0[2] * s1, l0[3] * s1);
        const uint32_t p2 = pack_bf16x2(l1[0] * s0, l1[1] * s0);
        const uint32_t p3 = pack_bf16x2(l1[2] * s1, l1[3] * s1);
        const int k0 = 16 * kk + 2 * t, last = rows[w] - 1;
        const int v0 = base[w] + min(k0, last), v1 = base[w] + min(k0 + 1, last);
        const int v8 = base[w] + min(k0 + 8, last), v9 = base[w] + min(k0 + 9, last);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const int c = col + 8 * nn + g;
          mma16816(o[w][nn], p0, p1, p2, p3, lds_pair(at(vs, v0, c), at(vs, v1, c)),
                   lds_pair(at(vs, v8, c), at(vs, v9, c)));
        }
      }
    }
#pragma unroll
    for (int w = 0; w < U; ++w) {
      if (w > 0 && b0 + w * NSUB >= blocks) break;
      const int r0 = qb[w] + g;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int chunk = 2 * h + nn;
        if (r0 < rows[w])
          *reinterpret_cast<uint32_t*>(og + sw128_row(base[w] + r0, chunk) + 4 * t) =
              pack_bf16x2(o[w][nn][0], o[w][nn][1]);
        if (r0 + 8 < rows[w])
          *reinterpret_cast<uint32_t*>(og + sw128_row(base[w] + r0 + 8, chunk) + 4 * t) =
              pack_bf16x2(o[w][nn][2], o[w][nn][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_block_wgmma_d256_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                                  const uint8_t* __restrict__ image,
                                  const float* __restrict__ vecs, int S, int Hp, int nseq,
                                  int ntiles, long long total_rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5;
  const int R = nseq * S;  // rows of whole sequences per tile
  const int nh = (Hp + kHidTile - 1) / kHidTile;
  // the grid is at most as many CTAs as tiles, so every CTA has a tile
  const int my_tiles = (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int nstages = stage_count(Hp);
  Ring ring{image, smem_u32(smem), nstages, my_tiles * nstages, 0, 0, 0};
  uint2* table = reinterpret_cast<uint2*>(smem + kTableOff);
  for (int a = threadIdx.x; a < nstages; a += kThreads) {
    int n;
    long long off;
    stage_of(a, Hp, n, off);
    table[a] = make_uint2(static_cast<uint32_t>(off), static_cast<uint32_t>(n));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full(s), 1);
      reinterpret_cast<int*>(smem + kCountOff)[s] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();  // the barriers and the stage table are in place
  if (threadIdx.x == 0)
    for (int a = 0; a < kStages; ++a) ring.issue(a, a);  // the first stages of the stream

  // warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile in every product
  const int wg = warp >> 2, tid = threadIdx.x;
  const int r_lo = 64 * wg, bar_wg = 2 + wg;
  constexpr int bar_all = 1;
  uint8_t* as = smem + kAOff;
  uint8_t* os = smem + kOOff;
  uint8_t* ks = smem + kKOff;
  uint8_t* vs = ks + kAtomBytes;
  uint8_t* hs = ks;  // the hidden tile reuses k's space in the SwiGLU half
  const uint32_t a_wg = smem_u32(as) + r_lo * 128, o_wg = smem_u32(os) + r_lo * 128;
  const uint32_t h_wg = smem_u32(hs) + r_lo * 128;
  const float* b1 = vecs + V_NUM_D * kD;
  const float* b3 = b1 + Hp;
#ifdef HSIMAE_PHASE_CLOCKS
  long long t0_ = clock64();
#endif
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * R;
    const int nvalid = (int)max(0LL, min((long long)R, total_rows - row0));
    const bf16* xr = x + row0 * kD;
    bf16* orow = out + row0 * kD;
    bar_sync(bar_wg, 128);  // the warpgroup is done with the previous tile's operands
    PHASE_MARK(0)
    layer_norm_rows<true>(xr, as, vecs + V_LN1_S * kD, vecs + V_LN1_B * kD, r_lo, nvalid);
    fence_async_smem();
    bar_sync(bar_wg, 128);
    PHASE_MARK(1)

    // ---- attention half, by head group ----
#pragma unroll 1
    for (int gi = 0; gi < kGroups; ++gi) {
      const int c0 = gi * kGroupCols;
      {
        float qk[64];
        product<128, 4>(qk, ring, a_wg, kKA, false);
        // every warp is done with the previous group's k, v (and the
        // previous tile's hidden tile)
        bar_sync(bar_all, kThreads);
        store_biased<128>(qk, os + gi * kAtomBytes, ks, vecs + V_BQ * kD + c0,
                          vecs + V_BK * kD + c0, r_lo);
      }
      {
        float v[32];
        product<64, 4, 2>(v, ring, a_wg, kKA, false);
        store_biased<64>(v, vs, vs, vecs + V_BV * kD + c0, vecs + V_BV * kD + c0, r_lo);
      }
      bar_sync(bar_all, kThreads);  // the group's q, k, v are in place
      PHASE_MARK(2)
      uint8_t* og = os + gi * kAtomBytes;
      switch (S > 8 ? (S + 15) / 16 : 1) {  // key blocks of 16
        case 1: attention<1>(og, ks, vs, S, nvalid / S); break;
        case 2: attention<2>(og, ks, vs, S, nvalid / S); break;
        case 3: attention<3>(og, ks, vs, S, nvalid / S); break;
        default: attention<4>(og, ks, vs, S, nvalid / S); break;
      }
      PHASE_MARK(3)
    }
    fence_async_smem();
    bar_sync(bar_all, kThreads);  // o of every head is in place
    PHASE_MARK(3)
#pragma unroll 1
    for (int n0 = 0; n0 < kD; n0 += 128) {  // Wo by 128 output columns
      float acc[64];
      product<128, 4>(acc, ring, o_wg, kKA, false);
      residual_half(acc, xr, orow, vecs + V_BO * kD, n0, r_lo, nvalid);
    }
    bar_sync(bar_wg, 128);  // the warpgroup's rows of x1 are in out
    PHASE_MARK(4)
    layer_norm_rows<false>(orow, as, vecs + V_LN2_S * kD, vecs + V_LN2_B * kD, r_lo, nvalid);
    fence_async_smem();
    bar_sync(bar_wg, 128);
    PHASE_MARK(5)

    // ---- SwiGLU half, by 64 hidden columns ----
    {
      const int next = tile + gridDim.x;  // its x into L2 meanwhile
      if (next < ntiles) {
        const long long nrow0 = (long long)next * R;
        const long long nbytes = min((long long)R, total_rows - nrow0) * kD * 2;
        const uint8_t* nx = reinterpret_cast<const uint8_t*>(x + nrow0 * kD);
        for (long long off = 128LL * tid; off < nbytes; off += 128LL * kThreads)
          prefetch_l2(nx + off);
      }
    }
    float wacc[64];  // W2's output columns 0-127, summed over the hidden tiles
    float* park = reinterpret_cast<float*>(os);  // and 128-255
#pragma unroll 1
    for (int t = 0; t < nh; ++t) {
      const int h0 = t * kHidTile, tw = min(kHidTile, Hp - h0);
      hidden_sub_any(ring, a_wg, hs, b1 + h0, b3 + h0, r_lo, 0, min(kHidSub, tw));
      if (tw > kHidSub)
        hidden_sub_any(ring, a_wg, hs, b1 + h0, b3 + h0, r_lo, kHidSub, tw - kHidSub);
      fence_async_smem();
      bar_sync(bar_wg, 128);  // the warpgroup's hidden tile is in place
      PHASE_MARK(6)
      switch (tw) {  // the tile's K slice of W2: tw / 16 K steps
        case 64: w2_tile<4>(wacc, ring, h_wg, park, r_lo, t == 0); break;
        case 48: w2_tile<3>(wacc, ring, h_wg, park, r_lo, t == 0); break;
        case 32: w2_tile<2>(wacc, ring, h_wg, park, r_lo, t == 0); break;
        default: w2_tile<1>(wacc, ring, h_wg, park, r_lo, t == 0); break;
      }
      PHASE_MARK(7)
    }
    residual_final(wacc, park, orow, vecs + V_B2 * kD, r_lo, nvalid);  // out = x1 + (W2 h + b2)
    PHASE_MARK(8)
  }
}

long long image_bytes(int Hp) {
  const int nfull = Hp / kHidTile, rest = Hp % kHidTile;
  return (long long)kGroups * kGroupBytes + (long long)kWoStages * kSlotBytes +
         (long long)nfull * kHidBytes +
         (rest ? kKA * 2LL * rest * 128 + 2LL * kSlotBytes : 0LL);
}

}  // namespace

extern "C" {

#ifdef HSIMAE_PHASE_CLOCKS
// Copies the 16 phase-clock sums to host and zeroes them (synchronises).
int hsimae_fused_block_wgmma_d256_phase_clocks(unsigned long long* host) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_phase_clocks, sizeof(g_phase_clocks));
  unsigned long long zero[16] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif

// Longest sequence the kernel takes at width D (0 if D is unsupported).
int hsimae_fused_block_wgmma_d256_max_seq(int D) { return D == kD ? kMaxSeq : 0; }

// Dynamic shared memory a CTA of the kernel takes at width D, in bytes.
int hsimae_fused_block_wgmma_d256_smem_bytes(int D) { return D == kD ? kSmem : 0; }

// Widest padded SwiGLU hidden axis the kernel takes at width D.
int hsimae_fused_block_wgmma_d256_max_hidden(int D) { return D == kD ? kMaxHidden : 0; }

// Bytes of the packed bf16 weight image the kernel streams per row tile.
long long hsimae_fused_block_wgmma_d256_image_bytes(int D, int Hp) {
  return D == kD ? image_bytes(Hp) : 0;
}

// x, out: [M, S, 256] bf16. image: pack_block_wgmma_d256's bf16 weight
// tiles; vecs: its f32 LayerNorm and bias vectors. Hp: the padded hidden
// width (a multiple of 16). Returns the cudaError_t of the launch (0 on
// success); does not synchronise.
int hsimae_fused_block_wgmma_d256(const void* x, void* out, const void* image, const void* vecs,
                                  int M, int S, int D, int Hp, int num_heads, void* stream) {
  if (M <= 0 || S <= 0 || S > kMaxSeq || D != kD || num_heads * kHeadDim != D || Hp <= 0 ||
      Hp % 16 != 0 || Hp > kMaxHidden)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_block_wgmma_d256_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int nseq = kRows / S;
  const int ntiles = (M + nseq - 1) / nseq;
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(out);
  const uint8_t* ip = static_cast<const uint8_t*>(image);
  const float* vp = static_cast<const float*>(vecs);
  const int grid = ntiles < sms ? ntiles : sms;
  fused_block_wgmma_d256_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      xp, op, ip, vp, S, Hp, nseq, ntiles, (long long)M * S);
  return (int)cudaGetLastError();
}

}  // extern "C"
