// One fused pre-LN transformer block over [M, S, 256] float32 sequences
// (HSIMAE-L's width), on Hopper's tensor cores in 3xTF32 (sm_90a: wgmma,
// cp.async.bulk, mbarriers).
//
// Replaces the Pallas TPU kernel hsimae_tpu/ops/fused_block.py::_kernel
// (math _block_math) for the float32 stream at D 256; D 64 and 128 run
// csrc/fused_block_tf32x3.cu. Per sequence, in float32 at the points where
// block_reference rounds:
//
//   y  = LN1(x)                              eps 1e-5
//   q, k, v = y W + b
//   o  = softmax(q k^T / 4) v                per head (hd 16)
//   x  = x + (o Wo + bo)
//   y2 = LN2(x)
//   x  = x + ((silu(y2 W1 + b1) * (y2 W3 + b3)) W2 + b2)
//
// Precision, as in fused_block_tf32x3.cu: each product is three TF32
// products, a_lo w_hi + a_hi w_lo + a_hi w_hi, every part rounded to TF32
// (the weights once per model by ops/fused_block.py::pack_block_tf32_d256,
// the activations in registers as the A operand is loaded); the tensor
// cores truncate as they accumulate, so no accumulator takes a long chain
// of wgmmas: every product runs as chains of at most 4 K atoms of 16 (24
// wgmmas) into a fresh partial, the partials added in f32 with
// round-to-nearest adds (q/k/v and [W1 | W3]: 4 partials over K 256; a head
// group's slice of Wo: one, the groups' sums added in order; a hidden
// tile's slice of W2: one, the tiles' sums added the same way).
//
// What bounds it on an H100. HSIMAE-L's block (SwiGLU hidden 684, padded to
// 688) at batch 4096 does ~233-238 GFLOP, ~700 GFLOP of TF32 work as three
// products (1.4 ms at 495 TFLOP/s); each 64-row tile streams the whole hi +
// lo pack, 6.32 MB. Measured (PERF.md): neither the operations nor L2 nor
// the weight bytes, but each warpgroup's own loop of A split, wgmma issue
// and drain, and the CUDA-core work around the products. At D 256 the D 128
// kernel's 64-row residual and full q/k/v (266 KB) do not fit in 227 KB of
// shared memory. The design:
//   * a CTA owns 64 rows of whole sequences (wgmma's M). Two consumer
//     warpgroups split every product's output columns; warp w of either
//     holds rows 16 (w % 4) .. + 15. There is no producer warp: with 256
//     threads ptxas may give each thread 255 registers, which the m64n128
//     sums need (a CTA of 9 or 12 warps is held to 168, and spilled);
//   * attention runs by head group: q, k and v are computed for 4 heads (64
//     columns) at a time into a [64, 68] buffer each, attention runs on them
//     in f32 on the CUDA cores (one thread per row and head, logits in
//     registers), o overwrites q, and o's K slice of Wo is summed in
//     registers (m64n128 per warpgroup), then parked in the output rows in
//     global memory (so no sum lives across the next group's products); the
//     residual is updated once all four groups are in. Shared memory: a
//     [64, 260] row tile (66.5 KB), one group's q/k/v (52 KB), the ring
//     (96 KB);
//   * the SwiGLU half runs by 64 hidden columns: [W1 | W3] on LN2(x1) into a
//     gate tile [64, 68] (double-buffered in the q/k/v space), then that
//     tile's slice of W2 summed in registers (m64n128 per warpgroup) and
//     added to the sum over the hidden tiles;
//   * LayerNorm is applied once, in place, to the row tile: it holds LN1(x),
//     then LN2(x1). The residual itself is read again from global memory
//     for the two residual adds: x from the input, x1 from the output,
//     where the first add also stores it;
//   * A comes from registers, split into TF32 hi and lo as it is loaded from
//     shared memory; the next K atom's A is split while the current atom's
//     wgmmas run;
//   * B streams through a ring of three 32 KB stages of K atoms of 16
//     float32 columns (64-byte rows, 64-byte swizzle), a stage's hi tiles
//     then its lo tiles under one pair of barriers: one atom of q/k/v, Wo or
//     W2 (up to 256 rows, 16 KB an image), two of [W1 | W3] (128 rows). The
//     consumer warp that releases a stage last refills it at once, so two
//     stages stay in flight behind the one being read;
//   * each CTA streams the whole pack once per row tile, from L2. Sharing
//     the stream across a cluster of 2 or 4 CTAs by multicast bulk copies
//     was slower on an H100 (PERF.md): L2 does not bound it;
//   * the grid is persistent: one CTA per SM (shared memory allows no
//     more), each walking the row tiles.
//
// Kept out of the hot paths: IEEE float division (a slow-path subroutine
// around whose calls accumulators went to local memory in the D 128 kernel);
// the divisions here are __fdividef on divisors known to lie in [1, 2^126].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 256;
constexpr int kHeadDim = 16;
constexpr int kGroupCols = 64;                         // q/k/v columns of a head group
constexpr int kGroups = kD / kGroupCols;               // 4
constexpr int kGroupHeads = kGroupCols / kHeadDim;     // 4
constexpr int kAtomK = 16;                             // f32 K columns of a 64-byte swizzle atom
constexpr int kKA = kD / kAtomK;                       // K atoms of a D-deep product
constexpr int kGroupKA = kGroupCols / kAtomK;          // K atoms of a group's slice of Wo
constexpr int kHidTile = 64;                           // hidden columns per [W1 | W3] tile
constexpr int kStages = 3;                             // ring stages, one K atom each
constexpr int kSlotBytes = 16384;                      // one image's tile: <= 256 rows x 64 bytes
constexpr int kStageBytes = 2 * kSlotBytes;            // an atom's hi tile, then its lo tile
constexpr int kRows = 64;                              // rows per tile: wgmma's M
constexpr int kMaxSeq = 64;                            // a tile holds whole sequences
constexpr int kConsumers = 2;                          // consumer warpgroups
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = kConsumerThreads;            // thread 0 also produces
constexpr int kMaxHidden = 4096;
constexpr int kLD = kD + 4;                            // residual row stride (floats): 4 mod 32
constexpr int kLDQ = kGroupCols + 4;                   // q, k, v and gate tile row stride
constexpr int kQkvRows = 3 * kGroupCols;               // rows of a group's [q | v0 | k | v1] tile
constexpr int kQkvAtomBytes = kQkvRows * kAtomK * 4;   // 12 KB
constexpr int kWideAtomBytes = kD * kAtomK * 4;        // 16 KB: Wo and W2 (256 output rows)
constexpr int kBufQ = kRows * kLDQ * 4;                // one [64, 68] buffer
constexpr int kXOff = kStages * kStageBytes;
constexpr int kQkvOff = kXOff + kRows * kLD * 4;
constexpr int kBarOff = kQkvOff + 3 * kBufQ;
constexpr int kCountOff = kBarOff + 2 * kStages * 8;   // per ring stage: warps that released it
constexpr int kSmem = kCountOff + 4 * kStages + 1024;  // + slack to align the base
constexpr int kMaxSmem = 232448;
static_assert(kSmem <= kMaxSmem, "shared memory budget");
static_assert(kHeadDim == 16, "the attention scale 0.25 assumes head dim 16");
static_assert(kWideAtomBytes <= kSlotBytes && kQkvAtomBytes <= kSlotBytes, "slot size");

// Offsets into the packed f32 vector buffer, in the pack's order.
enum { V_LN1_S, V_LN1_B, V_BQ, V_BK, V_BV, V_BO, V_LN2_S, V_LN2_B, V_B2, V_NUM_D };

// ------------------------------ primitives ---------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Global -> shared bulk copy into this CTA; completion counted in bytes on
// the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Built with -DHSIMAE_PHASE_CLOCKS (scripts/profile_fused_block.py), the
// first consumer thread of every CTA adds the SM clocks it spends in each
// phase of a tile into g_phase_clocks[phase], and those it spends waiting,
// within the phases, into g_phase_clocks[W_*]: for a ring stage to land
// (issuing meanwhile), for its wgmmas, at the consumers' barrier. Without it
// PHASE_MARK and the clock of WAIT_CLOCK are empty.
#ifdef HSIMAE_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[16];
#define PHASE_MARK(k)                                                  \
  if (threadIdx.x == 0) {                                              \
    const long long t1_ = clock64();                                   \
    atomicAdd(&g_phase_clocks[k], (unsigned long long)(t1_ - t0_));    \
    t0_ = t1_;                                                         \
  }
#define WAIT_CLOCK(k, stmt)                                                          \
  {                                                                                  \
    const long long w0_ = clock64();                                                 \
    stmt;                                                                            \
    if (threadIdx.x == 0) atomicAdd(&g_phase_clocks[k], (unsigned long long)(clock64() - w0_)); \
  }
#else
#define PHASE_MARK(k)
#define WAIT_CLOCK(k, stmt) \
  { stmt; }
#endif
enum { W_RING = 9, W_WGMMA = 10, W_BAR = 11 };

// Keep the compiler from moving accumulator or A-fragment accesses across
// wgmma issue and wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// wgmma descriptor of a K-major, 64-byte-swizzled operand at shared address
// addr (512-aligned atom of 8 rows, plus 32 bytes per K step of 8 TF32): LBO
// 16 B (unused), SBO 512 B (8 rows of 64 bytes), layout type 2 (64B swizzle).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// v rounded to TF32, to nearest with ties away from zero: the low 13
// mantissa bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32; v - hi is exact in f32.
__device__ __forceinline__ void split4(const float4 v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(a[i]);
    lo[i] = tf32_rna(a[i] - __uint_as_float(hi[i]));
  }
}

// m64nNk8 tf32 x tf32 -> f32, A from registers (rows g and g + 8 of the
// warp's 16, columns t and t + 4: a[0] (g, t), a[1] (g + 8, t), a[2]
// (g, t + 4), a[3] (g + 8, t + 4)), B K-major from shared memory;
// d += A B, or d = A B when scale_d is 0.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The weight stream. The pack is a fixed sequence of ring stages (the order
// above), streamed once per row tile; stage j of that sequence goes into
// ring stage j % kStages. A ring stage is refilled by whichever consumer
// warp releases its previous contents last (a counter per ring stage in
// shared memory says which): once the stage's "empty" barrier completes,
// that warp issues the next contents' hi and lo tiles, one bulk copy each.
// So a stage is refilled as soon as it is free.
struct Stream {
  const uint8_t* hi;
  const uint8_t* lo;
  uint32_t base;  // shared address of ring stage 0; the barriers at kBarOff
  int* released;  // per ring stage: warps that have released it, in shared memory
  int hp;         // padded hidden width
  int nstages;    // ring stages the pack fills
  int tiles;      // row tiles this CTA streams the pack for

  __device__ __forceinline__ uint32_t full(int s) const { return base + kBarOff + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + kBarOff + 8 * (kStages + s);
  }
  // bytes of stage a of the pack in one image (one K atom, or two of
  // [W1 | W3]) and where they start in it
  __device__ __forceinline__ int bytes(int a) const {
    constexpr int per_group = kKA + kGroupKA, per_tile = kKA / 2 + kHidTile / kAtomK;
    if (a < kGroups * per_group) return a % per_group < kKA ? kQkvAtomBytes : kWideAtomBytes;
    a -= kGroups * per_group;
    const int nfull = hp / kHidTile;  // 64-column hidden tiles: every stage 16 KB
    if (a < nfull * per_tile) return kWideAtomBytes;
    a -= nfull * per_tile;
    return a < kKA / 2 ? 4 * (hp - nfull * kHidTile) * kAtomK * 4 : kWideAtomBytes;
  }
  __device__ __forceinline__ long long offset(int a) const {
    constexpr int per_group = kKA + kGroupKA, per_tile = kKA / 2 + kHidTile / kAtomK;
    constexpr long long group_bytes = kKA * kQkvAtomBytes + kGroupKA * kWideAtomBytes;
    if (a < kGroups * per_group) {
      const int i = a % per_group;
      return a / per_group * group_bytes +
             (i < kKA ? i * kQkvAtomBytes : kKA * kQkvAtomBytes + (i - kKA) * kWideAtomBytes);
    }
    a -= kGroups * per_group;
    long long off = kGroups * group_bytes;
    const int nfull = hp / kHidTile;
    if (a < nfull * per_tile) return off + (long long)a * kWideAtomBytes;
    a -= nfull * per_tile;
    off += (long long)nfull * per_tile * kWideAtomBytes;
    const int w13 = 4 * (hp - nfull * kHidTile) * kAtomK * 4;
    return off + (a < kKA / 2 ? a * w13 : kKA / 2 * w13 + (a - kKA / 2) * kWideAtomBytes);
  }
  // issues stage a of the pack into ring stage s
  __device__ __forceinline__ void issue(int s, int a) const {
    const int n = bytes(a);
    const long long off = offset(a);
    const uint32_t dst = base + s * kStageBytes, bar = full(s);
    mbar_expect_tx(bar, 2 * n);
    bulk_load(dst, hi + off, n, bar);
    bulk_load(dst + kSlotBytes, lo + off, n, bar);
  }
};

// A stage a consumer warp has taken: its shared address, ring stage and
// phase, and which stage of the pack, for which of the CTA's row tiles, it
// holds.
struct Slot {
  uint32_t addr;
  int stage;
  uint32_t phase;
  int atom, tile;
};

// Ring position of a consumer warp; every consumer warp walks the same
// sequence of stages.
struct Ring {
  const Stream& st;
  int stage;
  uint32_t phase;
  int atom, tile;  // what the next take() holds
  // waits until the current stage has landed and moves on
  __device__ __forceinline__ Slot take() {
    WAIT_CLOCK(W_RING, mbar_wait(st.full(stage), phase))
    const Slot sl{st.base + stage * kStageBytes, stage, phase, atom, tile};
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    if (++atom == st.nstages) {
      atom = 0;
      ++tile;
    }
    return sl;
  }
  // one arrival per consumer warp on the slot's empty barrier; the last
  // warp to arrive refills the stage
  __device__ __forceinline__ void release(const Slot& sl) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const uint32_t bar = st.empty(sl.stage);
      mbar_arrive(bar);
      if (atomicAdd(st.released + sl.stage, 1) == kConsumerWarps - 1) {
        atomicExch(st.released + sl.stage, 0);
        int a = sl.atom + kStages, tile = sl.tile;
        if (a >= st.nstages) {
          a -= st.nstages;
          ++tile;
        }
        if (tile < st.tiles) {
          mbar_wait(bar, sl.phase);  // every warp is done with the slot
          st.issue(sl.stage, a);
        }
      }
    }
  }
};

// The thread's A values of one K step at column k0 of a product whose A is a
// row-major f32 buffer in shared memory: rows r0 and r0 + 8, columns k0 + t
// and k0 + t + 4, in the order of the fragment.
struct RowsA {
  const float* r0;  // row r0, at column t
  const float* r8;  // row r0 + 8, at column t
  __device__ __forceinline__ float4 at(int k0) const {
    return make_float4(r0[k0], r8[k0], r0[k0 + 4], r8[k0 + 4]);
  }
};

// Loads and splits the thread's A values of STEPS K steps from column k0.
template <int STEPS, class ASrc>
__device__ __forceinline__ void split_steps(const ASrc& a, int k0, uint32_t (&hi)[2][4],
                                            uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) split4(a.at(k0 + 8 * s), hi[s], lo[s]);
  fence_regs(hi);
  fence_regs(lo);
}

// One K atom's wgmma group: per K step s, a_lo B_hi, a_hi B_lo, a_hi B_hi
// (small terms first) into d, the first overwriting it unless ACCUMULATE;
// B_hi and B_lo at shared addresses b_hi and b_lo.
template <int N, int STEPS, bool ACCUMULATE = false>
__device__ __forceinline__ void mma_steps(float (&d)[N / 2], const uint32_t (&hi)[2][4],
                                          const uint32_t (&lo)[2][4], uint32_t b_hi, uint32_t b_lo) {
  wg_fence();
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    Wgmma<N>::mma(d, lo[s], sw64_desc(b_hi + 32 * s), s == 0 && !ACCUMULATE ? 0 : 1);
    Wgmma<N>::mma(d, hi[s], sw64_desc(b_lo + 32 * s), 1);
    Wgmma<N>::mma(d, hi[s], sw64_desc(b_hi + 32 * s), 1);
  }
  wg_commit();
}

// One K atom of a chained product (`chain`), at position POS of its ring
// stage (a stage holds 1 or 2 atoms, atom_bytes apart): at POS 0 the next
// stage taken; its wgmmas issued into acc (overwriting it when FIRST); then,
// once the previous atom's wgmmas are done, the previous stage released if
// that atom was its last, and the next atom's A (NEXT K steps from column
// k_next; none when 0) split into the register set the previous atom read.
template <int N, int STEPS, int NEXT, bool FIRST, int POS, class ASrc>
__device__ __forceinline__ void chain_atom(float (&acc)[N / 2], Ring& ring, uint32_t b_off,
                                           uint32_t atom_bytes, uint32_t (&hi)[2][4],
                                           uint32_t (&lo)[2][4], const ASrc& a, int k_next,
                                           uint32_t (&nhi)[2][4], uint32_t (&nlo)[2][4],
                                           Slot& cur, Slot& prev) {
  if constexpr (POS == 0) {
    prev = cur;
    cur = ring.take();
  }
  const uint32_t b_hi = cur.addr + b_off + POS * atom_bytes;
  mma_steps<N, STEPS, !FIRST>(acc, hi, lo, b_hi, b_hi + kSlotBytes);
  if constexpr (!FIRST) {
    WAIT_CLOCK(W_WGMMA, wg_wait<1>())
    fence_regs(nhi);
    fence_regs(nlo);
    if constexpr (POS == 0) ring.release(prev);
  }
  if constexpr (NEXT > 0) split_steps<NEXT>(a, k_next, nhi, nlo);
}

// acc = A B for the warpgroup's 64 rows and N output columns, in 3xTF32, as
// one wgmma chain over `katoms` (1 to 4) K atoms of 16 from A column k0, the
// last of LAST K steps, each ring stage holding APS of them (1, or 2 for
// [W1 | W3]): at most 24 wgmmas in one accumulator, since the tensor cores'
// truncation grows with the chain. An atom's wgmmas are issued before the
// previous atom's are waited for, so the tensor cores see no gap between
// them within the chain.
template <int N, int LAST, int APS, class ASrc>
__device__ __forceinline__ void chain(float (&acc)[N / 2], Ring& ring, const ASrc& a, int katoms,
                                      int k0, uint32_t b_off, uint32_t atom_bytes = 0) {
  static_assert(APS == 1 || APS == 2, "atoms per stage");
  constexpr int P1 = 1 % APS, P3 = 3 % APS;  // stage positions of atoms 1 and 3
  uint32_t hx[2][4], lx[2][4], hy[2][4], ly[2][4];
  Slot cur{}, prev{};
  fence_regs(acc);
  switch (katoms) {
    case 1:
      split_steps<LAST>(a, k0, hx, lx);
      chain_atom<N, LAST, 0, true, 0>(acc, ring, b_off, atom_bytes, hx, lx, a, 0, hy, ly, cur, prev);
      break;
    case 2:
      split_steps<2>(a, k0, hx, lx);
      chain_atom<N, 2, LAST, true, 0>(acc, ring, b_off, atom_bytes, hx, lx, a, k0 + kAtomK, hy, ly,
                                      cur, prev);
      chain_atom<N, LAST, 0, false, P1>(acc, ring, b_off, atom_bytes, hy, ly, a, 0, hx, lx, cur,
                                        prev);
      break;
    case 3:
      split_steps<2>(a, k0, hx, lx);
      chain_atom<N, 2, 2, true, 0>(acc, ring, b_off, atom_bytes, hx, lx, a, k0 + kAtomK, hy, ly,
                                   cur, prev);
      chain_atom<N, 2, LAST, false, P1>(acc, ring, b_off, atom_bytes, hy, ly, a, k0 + 2 * kAtomK,
                                        hx, lx, cur, prev);
      chain_atom<N, LAST, 0, false, 0>(acc, ring, b_off, atom_bytes, hx, lx, a, 0, hy, ly, cur,
                                       prev);
      break;
    default:
      split_steps<2>(a, k0, hx, lx);
      chain_atom<N, 2, 2, true, 0>(acc, ring, b_off, atom_bytes, hx, lx, a, k0 + kAtomK, hy, ly,
                                   cur, prev);
      chain_atom<N, 2, 2, false, P1>(acc, ring, b_off, atom_bytes, hy, ly, a, k0 + 2 * kAtomK, hx,
                                     lx, cur, prev);
      chain_atom<N, 2, LAST, false, 0>(acc, ring, b_off, atom_bytes, hx, lx, a, k0 + 3 * kAtomK,
                                       hy, ly, cur, prev);
      chain_atom<N, LAST, 0, false, P3>(acc, ring, b_off, atom_bytes, hy, ly, a, 0, hx, lx, cur,
                                        prev);
      break;
  }
  WAIT_CLOCK(W_WGMMA, wg_wait<0>())
  fence_regs(acc);
  ring.release(cur);
}

// acc += A B over a whole K of `katoms` atoms (a multiple of 4), as chains of
// 4 atoms into a fresh partial each, the partials added to acc with
// round-to-nearest adds.
template <int N, int APS, class ASrc>
__device__ __forceinline__ void product(float (&acc)[N / 2], Ring& ring, const ASrc& a, int katoms,
                                        uint32_t b_off, uint32_t atom_bytes = 0) {
  float part[N / 2];
#pragma unroll 1
  for (int ka = 0; ka < katoms; ka += 4) {
    chain<N, 2, APS>(part, ring, a, 4, ka * kAtomK, b_off, atom_bytes);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
  }
}

// Takes and releases `nstages` stages of the ring without reading them: a
// warpgroup with no columns in a tile.
__device__ __forceinline__ void skip_stages(Ring& ring, int nstages) {
  for (int ka = 0; ka < nstages; ++ka) ring.release(ring.take());
}

// Accumulator coordinates of this thread: rows er and er + 8 of the 64,
// columns 8 j + ec and 8 j + ec + 1 of the warpgroup's N.
struct AccPos {
  int er, ec;
  __device__ __forceinline__ AccPos() {
    const int lane = threadIdx.x & 31;
    er = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    ec = 2 * (lane & 3);
  }
};

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// The epilogue of a head group's q/k/v product: warpgroup 0's 96 columns
// are q's 64 and v's first 32, warpgroup 1's are k's 64 and v's last 32;
// each plus its bias into the [64, 68] buffers.
__device__ __forceinline__ void store_qkv(const float (&acc)[48], int wg, float* qs, float* ks,
                                          float* vs, const float* __restrict__ vecs, int c0) {
  const AccPos p;
  float* qk = wg == 0 ? qs : ks;
  const float* bqk = vecs + (wg == 0 ? V_BQ : V_BK) * kD + c0;
  const float* bv = vecs + V_BV * kD + c0 + 32 * wg;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    float* dst = j < 8 ? qk + 8 * j : vs + 32 * wg + 8 * (j - 8);
    const float* bias = j < 8 ? bqk + 8 * j : bv + 8 * (j - 8);
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + p.ec));
    *reinterpret_cast<float2*>(dst + p.er * kLDQ + p.ec) = make_float2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
    *reinterpret_cast<float2*>(dst + (p.er + 8) * kLDQ + p.ec) =
        make_float2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
  }
}

// The thread's float2 of out (or x) at the accumulator positions of this
// warpgroup's 128 columns (rows er, er + 8; columns n0 + 8 j + ec, + 1) of
// the rows below nvalid, zero elsewhere: all 32 loads issued before any is
// used. rows: the tile's first row.
template <bool READONLY>
__device__ __forceinline__ void load_acc_layout(float2 (&v)[32], const float* rows, int n0,
                                                int nvalid) {
  const AccPos p;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = p.er + 8 * half;
      const float2* src = reinterpret_cast<const float2*>(rows + r * kD + n0 + 8 * j + p.ec);
      v[2 * j + half] = r >= nvalid ? make_float2(0.f, 0.f) : READONLY ? __ldg(src) : *src;
    }
  }
}

// The out-projection of the head groups so far, parked in out (orow: the
// tile's first row) for this warpgroup's 128 columns of the thread's rows
// below nvalid: sum = acc after the first group, sum + acc after the next.
__device__ __forceinline__ void park_out_proj(const float (&acc)[64], float* orow, int n0,
                                              int nvalid, bool first) {
  const AccPos p;
  float2 sum[32];
  if (first) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] = make_float2(0.f, 0.f);
  } else {
    load_acc_layout<false>(sum, orow, n0, nvalid);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = p.er + 8 * half;
      const float2 v = sum[2 * j + half];
      if (r < nvalid)
        *reinterpret_cast<float2*>(orow + r * kD + n0 + 8 * j + p.ec) =
            make_float2(v.x + acc[4 * j + 2 * half], v.y + acc[4 * j + 2 * half + 1]);
    }
  }
}

// The first residual add, x1 = x + ((sum + acc) + bias), sum the parked
// out-projection of the earlier head groups and acc the last group's, for
// this warpgroup's 128 columns of the thread's rows, x read again from
// global memory (xr: the tile's first row): into the row tile xs (LN2's
// input) and, for rows below nvalid, into out.
__device__ __forceinline__ void residual_out(const float (&acc)[64], const float* __restrict__ xr,
                                             float* xs, float* orow, int n0,
                                             const float* __restrict__ bias, int nvalid) {
  const AccPos p;
  float2 xv[32], sum[32];
  load_acc_layout<true>(xv, xr, n0, nvalid);
  load_acc_layout<false>(sum, orow, n0, nvalid);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + p.ec;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = p.er + 8 * half, i = 2 * j + half;
      const float2 v = make_float2(xv[i].x + ((sum[i].x + acc[4 * j + 2 * half]) + b.x),
                                   xv[i].y + ((sum[i].y + acc[4 * j + 2 * half + 1]) + b.y));
      *reinterpret_cast<float2*>(xs + r * kLD + col) = v;
      if (r < nvalid) *reinterpret_cast<float2*>(orow + r * kD + col) = v;
    }
  }
}

// The second, out = x1 + (acc + bias), x1 read back from out where this
// thread stored it, for rows below nvalid.
__device__ __forceinline__ void residual_final(const float (&acc)[64], float* orow, int n0,
                                               const float* __restrict__ bias, int nvalid) {
  const AccPos p;
  float2 x1[32];
  load_acc_layout<false>(x1, orow, n0, nvalid);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + p.ec;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = p.er + 8 * half, i = 2 * j + half;
      if (r < nvalid)
        *reinterpret_cast<float2*>(orow + r * kD + col) =
            make_float2(x1[i].x + (acc[4 * j + 2 * half] + b.x), x1[i].y + (acc[4 * j + 2 * half + 1] + b.y));
    }
  }
}

// silu(h1) * h3, the division as __fdividef (2 ulp; the divisor 1 + exp(-h1)
// lies in [1, 2^126] wherever silu is not already 0).
__device__ __forceinline__ float silu_gate(float h1, float h3) {
  return __fdividef(h1, 1.f + expf(-h1)) * h3;
}

// This warpgroup's part of one [W1 | W3] tile: T = N / 2 hidden columns,
// its W1 rows over its W3 rows in one product (K atoms of atom_bytes, two a
// stage), then h = silu(h1 + b1) * (h3 + b3) into the gate tile hs at local
// column hc (global column h0 + hc).
template <int N>
__device__ __forceinline__ void hidden_part(Ring& ring, const RowsA& a, uint32_t b_off,
                                            uint32_t atom_bytes, float* hs,
                                            const float* __restrict__ b1,
                                            const float* __restrict__ b3, int hc) {
  constexpr int T = N / 2;
  float acc[N / 2];
  zero(acc);
  product<N, 2>(acc, ring, a, kKA, b_off, atom_bytes);
  const AccPos p;
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
    const int col = hc + 8 * j + p.ec;
    const float2 c1 = __ldg(reinterpret_cast<const float2*>(b1 + col));
    const float2 c3 = __ldg(reinterpret_cast<const float2*>(b3 + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i1 = 4 * j + 2 * half, i3 = 4 * (j + T / 8) + 2 * half;
      *reinterpret_cast<float2*>(hs + (p.er + 8 * half) * kLDQ + col) =
          make_float2(silu_gate(acc[i1] + c1.x, acc[i3] + c3.x),
                      silu_gate(acc[i1 + 1] + c1.y, acc[i3 + 1] + c3.y));
    }
  }
}

// LayerNorm (eps 1e-5) of the tile's 64 rows in place in shared memory:
// warp w takes rows 8 w .. 8 w + 7, each reduced by the whole warp (8
// columns a lane), the 8 rows in flight together.
__device__ __forceinline__ void layer_norm_rows(float* xs, const float* __restrict__ scale,
                                                const float* __restrict__ bias) {
  constexpr int E = kD / 32;
  const int lane = threadIdx.x & 31, row0 = 8 * (threadIdx.x >> 5);
  float v[8][E], mu[8], sq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float* xr = xs + (row0 + i) * kLD + E * lane;
    mu[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 u = *reinterpret_cast<const float4*>(xr + e);
      v[i][e] = u.x;
      v[i][e + 1] = u.y;
      v[i][e + 2] = u.z;
      v[i][e + 3] = u.w;
      mu[i] += (u.x + u.y) + (u.z + u.w);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) mu[i] += __shfl_xor_sync(0xffffffffu, mu[i], off);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mu[i] *= 1.f / kD;
    sq[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) sq[i] += (v[i][e] - mu[i]) * (v[i][e] - mu[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], off);
  }
  float s[E], b[E];
#pragma unroll
  for (int e = 0; e < E; e += 4) {
    const float4 us = __ldg(reinterpret_cast<const float4*>(scale + E * lane + e));
    const float4 ub = __ldg(reinterpret_cast<const float4*>(bias + E * lane + e));
    s[e] = us.x, s[e + 1] = us.y, s[e + 2] = us.z, s[e + 3] = us.w;
    b[e] = ub.x, b[e + 1] = ub.y, b[e + 2] = ub.z, b[e + 3] = ub.w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float inv = rsqrtf(sq[i] * (1.f / kD) + 1e-5f);
    float* xr = xs + (row0 + i) * kLD + E * lane;
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(xr + e) = make_float4(
          (v[i][e] - mu[i]) * inv * s[e] + b[e], (v[i][e + 1] - mu[i]) * inv * s[e + 1] + b[e + 1],
          (v[i][e + 2] - mu[i]) * inv * s[e + 2] + b[e + 2],
          (v[i][e + 3] - mu[i]) * inv * s[e + 3] + b[e + 3]);
  }
}

__device__ __forceinline__ float dot16(const float (&q)[kHeadDim], const float* k) {
  float s0 = 0.f, s1 = 0.f;  // two chains
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 8) {
    const float4 u = *reinterpret_cast<const float4*>(k + d);
    const float4 w = *reinterpret_cast<const float4*>(k + d + 4);
    s0 = fmaf(q[d], u.x, s0);
    s1 = fmaf(q[d + 4], w.x, s1);
    s0 = fmaf(q[d + 1], u.y, s0);
    s1 = fmaf(q[d + 5], w.y, s1);
    s0 = fmaf(q[d + 2], u.z, s0);
    s1 = fmaf(q[d + 6], w.z, s1);
    s0 = fmaf(q[d + 3], u.w, s0);
    s1 = fmaf(q[d + 7], w.w, s1);
  }
  return s0 + s1;
}

// o = softmax(q k^T * 0.25) v for the head group's 4 heads, one consumer
// thread per (row, head), in f32, for sequences of S <= KMAX <= 36: the row's
// S logits computed once into registers, their max, exp and sum, then the
// weighted sum of v times the sum's reciprocal. Rows are the fastest index,
// so the eight threads of a 16-byte access phase read eight rows (stride 4
// mod 32 words, or one broadcast key row), free of bank conflicts. o
// overwrites q in place: only this thread reads q[row, head]. Rows from
// nrows on (empty sequences) are skipped.
template <int KMAX>
__device__ __forceinline__ void attention(float* qs, const float* ks, const float* vs, int S,
                                          int nrows) {
  for (int item = threadIdx.x; item < nrows * kGroupHeads; item += kConsumerThreads) {
    const int r = item % nrows, c = (item / nrows) * kHeadDim;
    const int s0 = r - r % S;
    float* qp = qs + r * kLDQ + c;
    float q[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4) {
      const float4 u = *reinterpret_cast<const float4*>(qp + d);
      q[d] = u.x;
      q[d + 1] = u.y;
      q[d + 2] = u.z;
      q[d + 3] = u.w;
    }
    const float* kp = ks + s0 * kLDQ + c;
    const float* vp = vs + s0 * kLDQ + c;
    float l[KMAX];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < S) {
        l[j] = dot16(q, kp + j * kLDQ) * 0.25f;
        mx = fmaxf(mx, l[j]);
      }
    }
    float sum = 0.f, o[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) o[d] = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < S) {
        const float e = expf(l[j] - mx);
        sum += e;
#pragma unroll
        for (int d = 0; d < kHeadDim; d += 4) {
          const float4 u = *reinterpret_cast<const float4*>(vp + j * kLDQ + d);
          o[d] = fmaf(e, u.x, o[d]);
          o[d + 1] = fmaf(e, u.y, o[d + 1]);
          o[d + 2] = fmaf(e, u.z, o[d + 2]);
          o[d + 3] = fmaf(e, u.w, o[d + 3]);
        }
      }
    }
    const float inv = __fdividef(1.f, sum);  // sum in [1, 64]
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4)
      *reinterpret_cast<float4*>(qp + d) =
          make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
  }
}

// The same for sequences longer than 36, in two passes over the keys (the
// logits' max, then exp, sum and the weighted v, each logit computed
// again), with no array of logits.
__device__ __forceinline__ void attention_long(float* qs, const float* ks, const float* vs, int S,
                                               int nrows) {
  for (int item = threadIdx.x; item < nrows * kGroupHeads; item += kConsumerThreads) {
    const int r = item % nrows, c = (item / nrows) * kHeadDim;
    const int s0 = r - r % S;
    float* qp = qs + r * kLDQ + c;
    float q[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4) {
      const float4 u = *reinterpret_cast<const float4*>(qp + d);
      q[d] = u.x;
      q[d + 1] = u.y;
      q[d + 2] = u.z;
      q[d + 3] = u.w;
    }
    const float* kp = ks + s0 * kLDQ + c;
    const float* vp = vs + s0 * kLDQ + c;
    float mx = -INFINITY;
    for (int j = 0; j < S; ++j) mx = fmaxf(mx, dot16(q, kp + j * kLDQ) * 0.25f);
    float sum = 0.f, o[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) o[d] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float e = expf(dot16(q, kp + j * kLDQ) * 0.25f - mx);
      sum += e;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 4) {
        const float4 u = *reinterpret_cast<const float4*>(vp + j * kLDQ + d);
        o[d] = fmaf(e, u.x, o[d]);
        o[d + 1] = fmaf(e, u.y, o[d + 1]);
        o[d + 2] = fmaf(e, u.z, o[d + 2]);
        o[d + 3] = fmaf(e, u.w, o[d + 3]);
      }
    }
    const float inv = __fdividef(1.f, sum);  // sum in [1, 64]
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4)
      *reinterpret_cast<float4*>(qp + d) =
          make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
  }
}

__device__ __forceinline__ void attention_any(float* qs, const float* ks, const float* vs, int S,
                                              int nrows) {
  if (S <= 4) attention<4>(qs, ks, vs, S, nrows);
  else if (S <= 9) attention<9>(qs, ks, vs, S, nrows);
  else if (S <= 18) attention<18>(qs, ks, vs, S, nrows);
  else if (S <= 36) attention<36>(qs, ks, vs, S, nrows);
  else attention_long(qs, ks, vs, S, nrows);
}


__global__ void __launch_bounds__(kThreads, 1)
    fused_block_tf32x3_d256_kernel(const float* __restrict__ x, float* __restrict__ out,
                                   const uint8_t* __restrict__ hi, const uint8_t* __restrict__ lo,
                                   const float* __restrict__ vecs, int S, int Hp, int nseq,
                                   int ntiles, long long total_rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = nseq * S;  // rows of whole sequences per tile
  // the grid is at most ntiles CTAs, so every CTA has a tile
  const int my_tiles = (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const Stream stream{hi, lo, smem_u32(smem), reinterpret_cast<int*>(smem + kCountOff), Hp,
                      kGroups * (kKA + kGroupKA) + (Hp + kHidTile - 1) / kHidTile * (kKA / 2) +
                          (Hp + kAtomK - 1) / kAtomK,
                      my_tiles};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(stream.full(s), 1);
      mbar_init(stream.empty(s), kConsumerWarps);  // one arrival per consumer warp
      stream.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int a = 0; a < kStages; ++a) stream.issue(a, a);  // the first kStages stages of the stream
  }
  __syncthreads();  // the barriers are initialised before any thread waits on them

  // warpgroup wg takes output columns [128 wg, + 128) of Wo and W2, its 96
  // columns of each group's q/k/v, and its half of each [W1 | W3] tile;
  // warp w holds rows [16 (w % 4), + 16) of every product
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // this thread's A and accumulator rows: r0, r0 + 8
  constexpr int bar_all = 1;
  float* xs = reinterpret_cast<float*>(smem + kXOff);
  float* qs = reinterpret_cast<float*>(smem + kQkvOff);
  float* ks = qs + kRows * kLDQ;
  float* vs = ks + kRows * kLDQ;
  const float* b1 = vecs + V_NUM_D * kD;
  const float* b3 = b1 + Hp;
  const RowsA yrows{xs + r0 * kLD + t, xs + (r0 + 8) * kLD + t};  // LN1(x), later LN2(x1)
  const int n0 = wg * (kD / kConsumers);                          // this warpgroup's Wo / W2 columns
  const uint32_t wide_off = n0 * kAtomK * 4;                      // and its rows of their B tiles
  const uint32_t qkv_off = wg * (kQkvRows / kConsumers) * kAtomK * 4;
  Ring ring{stream, 0, 0, 0, 0};
  constexpr int C4 = kD / 4;  // float4 per row
#ifdef HSIMAE_PHASE_CLOCKS
  long long t0_ = clock64();
#endif
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * R;
    const int nvalid = (int)min((long long)R, total_rows - row0);
    const float* xr = x + row0 * kD;
    float* orow = out + row0 * kD;
    WAIT_CLOCK(W_BAR, bar_sync(bar_all, kConsumerThreads))  // the previous tile is done with xs
    PHASE_MARK(0)
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * C4; i += kConsumerThreads) {  // x rows, zero past the valid
      const int r = i / C4, c = (i % C4) * 4;
      *reinterpret_cast<float4*>(xs + r * kLD + c) =
          r < nvalid ? __ldg(reinterpret_cast<const float4*>(xr + r * kD + c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    bar_sync(bar_all, kConsumerThreads);
    layer_norm_rows(xs, vecs + V_LN1_S * kD, vecs + V_LN1_B * kD);
    bar_sync(bar_all, kConsumerThreads);  // LN1(x) in place
    PHASE_MARK(1)

    // ---- attention half, by head group ----
#pragma unroll 1
    for (int gi = 0; gi < kGroups; ++gi) {
      {
        float acc[48];
        zero(acc);
        product<96, 1>(acc, ring, yrows, kKA, qkv_off);
        WAIT_CLOCK(W_BAR, bar_sync(bar_all, kConsumerThreads))  // every warp has read the previous group's o
        store_qkv(acc, wg, qs, ks, vs, vecs, gi * kGroupCols);
      }
      WAIT_CLOCK(W_BAR, bar_sync(bar_all, kConsumerThreads))  // the group's q, k, v are in place
      PHASE_MARK(2)
      attention_any(qs, ks, vs, S, nvalid);
      WAIT_CLOCK(W_BAR, bar_sync(bar_all, kConsumerThreads))  // its o is in place
      PHASE_MARK(3)
      const RowsA o{qs + r0 * kLDQ + t, qs + (r0 + 8) * kLDQ + t};
      float oacc[64];  // o Wo of this group, for this warpgroup's 128 columns
      chain<128, 2, 1>(oacc, ring, o, kGroupKA, 0, wide_off);
      if (gi + 1 < kGroups) {
        park_out_proj(oacc, orow, n0, nvalid, gi == 0);
      } else {
        // every warp is done with LN1(x) and with o: x1 = x + (o Wo + bo) into xs and out
        WAIT_CLOCK(W_BAR, bar_sync(bar_all, kConsumerThreads))
        residual_out(oacc, xr, xs, orow, n0, vecs + V_BO * kD, nvalid);
      }
      PHASE_MARK(4)
    }
    bar_sync(bar_all, kConsumerThreads);  // x1 in place

    // ---- SwiGLU half, by 64 hidden columns ----
    layer_norm_rows(xs, vecs + V_LN2_S * kD, vecs + V_LN2_B * kD);
    bar_sync(bar_all, kConsumerThreads);  // LN2(x1) in place
    PHASE_MARK(5)
    float wacc[64];  // W2's output for this warpgroup's 128 columns, summed over the tiles
    zero(wacc);
    int buf = 0;
#pragma unroll 1
    for (int h0 = 0; h0 < Hp; h0 += kHidTile, buf ^= 1) {
      // the tile's tw hidden columns: the first warpgroup takes tw0 (a
      // multiple of 8, at least half), the second the rest
      const int tw = min(kHidTile, Hp - h0), tw0 = (tw / 2 + 7) / 8 * 8;
      const int mine = wg == 0 ? tw0 : tw - tw0;
      const int hc = wg == 0 ? 0 : tw0;
      const uint32_t off = wg == 0 ? 0 : 2 * tw0 * kAtomK * 4;
      float* hs = qs + buf * kRows * kLDQ;  // gate tiles alternate between two buffers
      const uint32_t ab = 2 * tw * kAtomK * 4;  // one [W1 | W3] atom, in either image
      switch (mine) {
        case 32: hidden_part<64>(ring, yrows, off, ab, hs, b1 + h0, b3 + h0, hc); break;
        case 24: hidden_part<48>(ring, yrows, off, ab, hs, b1 + h0, b3 + h0, hc); break;
        case 16: hidden_part<32>(ring, yrows, off, ab, hs, b1 + h0, b3 + h0, hc); break;
        case 8: hidden_part<16>(ring, yrows, off, ab, hs, b1 + h0, b3 + h0, hc); break;
        default: skip_stages(ring, kKA / 2); break;
      }
      WAIT_CLOCK(W_BAR, bar_sync(bar_all, kConsumerThreads))  // the gate tile is in place
      PHASE_MARK(6)
      const RowsA h{hs + r0 * kLDQ + t, hs + (r0 + 8) * kLDQ + t};
      const int hka = (tw + kAtomK - 1) / kAtomK;
      {
        float tacc[64];  // this tile's W2 h, added to the sum over the tiles
        if (tw % kAtomK) chain<128, 1, 1>(tacc, ring, h, hka, 0, wide_off);
        else chain<128, 2, 1>(tacc, ring, h, hka, 0, wide_off);
#pragma unroll
        for (int i = 0; i < 64; ++i) wacc[i] += tacc[i];
      }
      PHASE_MARK(7)
    }
    residual_final(wacc, orow, n0, vecs + V_B2 * kD, nvalid);  // out = x1 + (W2 h + b2)
    PHASE_MARK(8)
  }
}

long long image_bytes(int Hp) {
  const long long hka = (Hp + kAtomK - 1) / kAtomK;
  return (long long)kGroups * (kKA * kQkvAtomBytes + kGroupKA * kWideAtomBytes) +
         2LL * Hp * kKA * kAtomK * 4 + hka * kWideAtomBytes;
}

}  // namespace

extern "C" {

#ifdef HSIMAE_PHASE_CLOCKS
// Copies the 16 phase-clock sums to host and zeroes them (synchronises).
int hsimae_fused_block_tf32x3_d256_phase_clocks(unsigned long long* host) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_phase_clocks, sizeof(g_phase_clocks));
  unsigned long long zero[16] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif

// Longest sequence the kernel takes at width D (0 if D is unsupported).
int hsimae_fused_block_tf32x3_d256_max_seq(int D) { return D == kD ? kMaxSeq : 0; }

// Dynamic shared memory a CTA of the kernel takes at width D, in bytes.
int hsimae_fused_block_tf32x3_d256_smem_bytes(int D) { return D == kD ? kSmem : 0; }

// Widest padded SwiGLU hidden axis the kernel takes at width D.
int hsimae_fused_block_tf32x3_d256_max_hidden(int D) { return D == kD ? kMaxHidden : 0; }

// Bytes of one packed image (hi or lo) the kernel streams per row tile.
long long hsimae_fused_block_tf32x3_d256_image_bytes(int D, int Hp) {
  return D == kD ? image_bytes(Hp) : 0;
}

// x, out: [M, S, 256] float32. hi, lo: pack_block_tf32_d256's TF32 weight
// images; vecs: its f32 LayerNorm and bias vectors. Hp: the padded hidden
// width (a multiple of 8). Returns the cudaError_t of the launch (0 on
// success); does not synchronise.
int hsimae_fused_block_tf32x3_d256(const void* x, void* out, const void* hi, const void* lo,
                                   const void* vecs, int M, int S, int D, int Hp, int num_heads,
                                   void* stream) {
  if (M <= 0 || S <= 0 || S > kMaxSeq || D != kD || num_heads * kHeadDim != D || Hp <= 0 ||
      Hp % 8 != 0 || Hp > kMaxHidden)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_block_tf32x3_d256_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int nseq = kRows / S;
  const int ntiles = (M + nseq - 1) / nseq;
  const int grid = ntiles < sms ? ntiles : sms;
  fused_block_tf32x3_d256_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<const uint8_t*>(hi),
      static_cast<const uint8_t*>(lo), static_cast<const float*>(vecs), S, Hp, nseq, ntiles,
      (long long)M * S);
  return (int)cudaGetLastError();
}

}  // extern "C"
