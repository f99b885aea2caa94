// One fused pre-LN transformer block over [M, S, D] float32 sequences at
// D 64 and 128, on Hopper's tensor cores in 3xTF32 (sm_90a: wgmma, bulk
// async copies, mbarriers).
//
// Replaces the Pallas TPU kernel hsimae_tpu/ops/fused_block.py::_kernel
// (math _block_math) for the float32 stream at D 64 and 128; float32 at
// D 256 runs csrc/fused_block.cu (see the end of this note). Per sequence,
// in float32 at the points where block_reference rounds:
//
//   y  = LN1(x)                              eps 1e-5
//   q, k, v = y W + b
//   o  = softmax(q k^T / 4) v                per head (hd 16)
//   x  = x + (o Wo + bo)
//   y2 = LN2(x)
//   x  = x + ((silu(y2 W1 + b1) * (y2 W3 + b3)) W2 + b2)
//
// Precision. One TF32 product keeps 11 bits of each operand and misses the
// 2e-5 check by two orders of magnitude. Each product here is three: with
// a = a_hi + a_lo and w = w_hi + w_lo, every part rounded to TF32 (round to
// nearest, ties away), it sums a_lo w_hi + a_hi w_lo + a_hi w_hi, small
// terms first; the dropped a_lo w_lo is ~2^-22 relative. wgmma ignores the
// 13 low bits of a TF32 operand rather than rounding them, so both parts
// are rounded before: the weights once per model
// (ops/fused_block.py::pack_block_tf32: a hi and a lo image), the
// activations in registers as the A operand is loaded (cvt.rna.tf32.f32).
// The tensor cores round toward zero as they accumulate, a bias that grows
// with the number of wgmmas summed into one accumulator (1.9e-5 against the
// 2e-5 check over W2's 129 when one accumulator took them all); so each K
// atom's 12 wgmmas sum into a fresh partial, added to the f32 accumulator
// with round-to-nearest adds.
//
// What bounds it on an H100: operations. HSIMAE-B's block (D 128, SwiGLU
// hidden 344) at batch 4096 does ~59 GFLOP, ~177 GFLOP of TF32 work as three
// products (0.36 ms at the 495 TFLOP/s TF32 rate), against ~152 MB of
// activations and a 1.58 MB hi + lo weight pack. The design:
//   * a CTA owns a row tile of whole sequences, 64 rows (wgmma's M). Two
//     consumer warpgroups split every product's output columns, each an
//     m64n64 (at most) accumulator per thread; warp w of either holds rows
//     16 (w % 4) .. + 15 in every A fragment and accumulator. A third
//     warpgroup is the producer: one thread, its registers handed to the
//     consumers with setmaxnreg;
//   * A comes from registers: at each K step of 8 a thread loads its four
//     f32 values (rows g and g + 8, columns t and t + 4) from shared memory
//     and splits them, two K steps at a time into alternating register sets.
//     LayerNorm is applied on the fly, from the residual and per-row
//     statistics, so no LN buffer exists: shared memory holds the residual
//     and q/k/v (~135 KB at D 128); o overwrites q in place, and the SwiGLU
//     hidden tile reuses the q/k/v space as W2's A;
//   * B (the weights) streams through a ring of five 16 KB slots guarded by
//     mbarriers (full: bytes landed; empty: every consumer warp's wgmmas done
//     with the slot), kept in flight by the producer thread with
//     cp.async.bulk; a K atom of 32 columns takes two slots, its hi and its
//     lo tile, and each consumer warpgroup reads its half of the tile's rows;
//   * W1 and W3 are interleaved per 64 hidden columns, each warpgroup's half
//     of a tile holding W1 over W3 for the same hidden columns, so one wgmma
//     gives a thread both halves of the gate; the hidden axis is padded with
//     zeros to a multiple of 8, TF32's K step;
//   * epilogues (bias, residual add, the f32 silu gate) run in registers on
//     the accumulators;
//   * attention runs in f32 on the CUDA cores, one thread per (row, head),
//     the row's logits held in registers: it is 1-5% of the FLOPs;
//   * the grid is persistent: one CTA per SM walks the row tiles, and the
//     producer runs ahead across tile boundaries.
// What holds it back: the weight stream. Every 64-row tile reads the whole
// hi + lo pack (1.58 MB at D 128) from L2, ~3.7 GB per launch at batch 4096.
// At S 36 a tile holds one sequence, 36 of its 64 rows. At D 256 the 64-row
// residual and q/k/v alone (266 KB) exceed the 227 KB of shared memory, so
// float32 at that width runs on fused_block.cu, by width.
//
// Kept out of the hot paths: IEEE float division. It calls a slow-path
// subroutine, and around such calls the accumulators went to local memory;
// the divisions here are __fdividef on divisors known to lie in [1, 2^126].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 16;
constexpr int kAtomK = 32;         // f32 K columns in one 128-byte swizzle atom
constexpr int kHidTile = 64;       // hidden columns per W1|W3 tile
constexpr int kStages = 5;         // weight ring depth (two slots per K atom)
constexpr int kSlotBytes = 16384;  // one ring slot: <= 128 rows x 128 bytes
constexpr int kRows = 64;          // rows per tile: wgmma's M
constexpr int kMaxSeq = 64;        // longest sequence (a tile holds whole sequences)
constexpr int kConsumers = 2;      // consumer warpgroups, splitting each product's columns
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kMaxSmem = 232448;
static_assert(kHeadDim == 16, "the attention scale 0.25 assumes head dim 16");

template <int D>
struct Geom {
  static_assert(D == 64 || D == 128, "widths of this kernel");
  static constexpr int KA = D / kAtomK;       // K atoms of a D-deep product
  static constexpr int NW = D / kConsumers;   // columns of a D-wide product per warpgroup
  static constexpr int HEADS = D / kHeadDim;
  static constexpr int LD = D + 4;            // row stride (floats) of x, q, k, v: 4 mod 32
  static constexpr int BUF = kRows * LD * 4;  // bytes of one [64, D] buffer
  static constexpr int X_OFF = kStages * kSlotBytes;
  static constexpr int QKV_OFF = X_OFF + BUF;
  static constexpr int BAR_OFF = QKV_OFF + 3 * BUF;
  static constexpr int SMEM = BAR_OFF + 2 * kStages * 8 + 1024;  // + slack to align the base
  // widest padded hidden axis whose [64, Hp + 4] tile fits in the q/k/v space
  static constexpr int MAX_HIDDEN = (3 * BUF / (kRows * 4) - 4) / 8 * 8;
  static_assert(SMEM <= kMaxSmem, "shared memory budget");
};

// Offsets into the packed f32 vector buffer, in the packs' order.
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Global -> shared bulk copy; completion counted in bytes on the mbarrier.
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

// wgmma descriptor of a K-major, 128-byte-swizzled operand at shared address
// addr (1024-aligned atom, plus 32 bytes per K step of 8 TF32): LBO 16 B,
// SBO 1024 B (8 rows of 128 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
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


// Ring position of a consumer warpgroup; both consumer warpgroups and the
// producer walk the same sequence of slots.
struct Ring {
  uint32_t slots;  // shared address of slot 0
  uint32_t full;   // shared address of full barrier 0 (8 bytes apart)
  uint32_t empty;  // shared address of empty barrier 0
  int stage;
  uint32_t phase;
  // waits until the current slot has landed; returns its shared address and moves on
  __device__ __forceinline__ uint32_t take() {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t addr = slots + stage * kSlotBytes;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    return addr;
  }
  // one arrival per consumer warp on the empty barriers of the atom whose hi
  // tile sat in slot s (its lo tile in the next)
  __device__ __forceinline__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      mbar_arrive(empty + 8 * s);
      mbar_arrive(empty + 8 * (s + 1 == kStages ? 0 : s + 1));
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

// The same of LN(x), computed from the residual rows as they are read:
// (x - mu) * inv * scale + bias, the rows' mean and 1 / sqrt(var + eps)
// held by the thread.
struct NormA {
  RowsA x;
  float mu0, inv0, mu8, inv8;
  const float* scale;  // at column t
  const float* bias;
  __device__ __forceinline__ float4 at(int k0) const {
    const float4 v = x.at(k0);
    const float s0 = __ldg(scale + k0), s4 = __ldg(scale + k0 + 4);
    const float b0 = __ldg(bias + k0), b4 = __ldg(bias + k0 + 4);
    return make_float4((v.x - mu0) * inv0 * s0 + b0, (v.y - mu8) * inv8 * s0 + b0,
                       (v.z - mu0) * inv0 * s4 + b4, (v.w - mu8) * inv8 * s4 + b4);
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

// One wgmma group: per K step s, a_lo B_hi, a_hi B_lo, a_hi B_hi (small terms
// first) into d; B_hi and B_lo at shared addresses b_hi and b_lo (K step 0
// of the group). The group's first product overwrites d when scale_first is 0.
template <int N, int STEPS>
__device__ __forceinline__ void mma_steps(float (&d)[N / 2], const uint32_t (&hi)[2][4],
                                          const uint32_t (&lo)[2][4], uint32_t b_hi, uint32_t b_lo,
                                          int scale_first) {
  wg_fence();
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    Wgmma<N>::mma(d, lo[s], sw128_desc(b_hi + 32 * s), s == 0 ? scale_first : 1);
    Wgmma<N>::mma(d, hi[s], sw128_desc(b_lo + 32 * s), 1);
    Wgmma<N>::mma(d, hi[s], sw128_desc(b_hi + 32 * s), 1);
  }
  wg_commit();
}

// One K atom (STEPS K steps of 8) of a product, for this warpgroup's rows of
// the B tiles from byte b_off: its hi and lo tiles waited for, two wgmma
// groups into a fresh partial (K steps 0-1 from the A registers x, 2-3 from
// y, the second half's A split while the first runs), then the partial added
// to acc once both are done, and the atom's slots released.
template <int N, int STEPS, class ASrc>
__device__ __forceinline__ void product_atom(float (&acc)[N / 2], float (&part)[N / 2], Ring& ring,
                                             const ASrc& a, int ka, uint32_t b_off,
                                             uint32_t (&hx)[2][4], uint32_t (&lx)[2][4],
                                             uint32_t (&hy)[2][4], uint32_t (&ly)[2][4]) {
  constexpr int H1 = STEPS < 2 ? STEPS : 2, H2 = STEPS - H1;
  const int k0 = ka * kAtomK;
  split_steps<H1>(a, k0, hx, lx);
  const int slot = ring.stage;
  const uint32_t b_hi = ring.take() + b_off;
  const uint32_t b_lo = ring.take() + b_off;
  fence_regs(part);
  mma_steps<N, H1>(part, hx, lx, b_hi, b_lo, 0);
  if constexpr (H2 > 0) {
    split_steps<H2>(a, k0 + 16, hy, ly);
    mma_steps<N, H2>(part, hy, ly, b_hi + 64, b_lo + 64, 1);
  }
  wg_wait<0>();
  fence_regs(part);
  ring.release(slot);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
}

// acc = A B for the warpgroup's 64 rows and N output columns, in 3xTF32. B
// arrives as `katoms` K atoms, each a hi and a lo ring tile of which this
// warpgroup reads the rows from byte b_off; the last atom carries LAST K
// steps of 8.
template <int N, int LAST, class ASrc>
__device__ __forceinline__ void product(float (&acc)[N / 2], Ring& ring, const ASrc& a, int katoms,
                                        uint32_t b_off) {
  float part[N / 2];
  uint32_t hx[2][4], lx[2][4], hy[2][4], ly[2][4];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int ka = 0; ka < katoms - 1; ++ka)
    product_atom<N, 4>(acc, part, ring, a, ka, b_off, hx, lx, hy, ly);
  product_atom<N, LAST>(acc, part, ring, a, katoms - 1, b_off, hx, lx, hy, ly);
}

// Takes and releases `katoms` atoms of the ring without reading them: a
// warpgroup with no columns in a tile.
__device__ __forceinline__ void skip_atoms(Ring& ring, int katoms) {
  for (int ka = 0; ka < katoms; ++ka) {
    const int slot = ring.stage;
    ring.take();
    ring.take();
    ring.release(slot);
  }
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

// dst[row, n0 + col] = acc + bias[n0 + col], dst row-major with stride ld.
template <int N>
__device__ __forceinline__ void store_biased(const float (&acc)[N / 2], float* dst, int ld, int n0,
                                             const float* __restrict__ bias) {
  const AccPos p;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = n0 + 8 * j + p.ec;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
    *reinterpret_cast<float2*>(dst + p.er * ld + col) = make_float2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
    *reinterpret_cast<float2*>(dst + (p.er + 8) * ld + col) =
        make_float2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
  }
}

// xs[row, n0 + col] = xs + (acc + bias): the residual add.
template <int N>
__device__ __forceinline__ void add_residual(const float (&acc)[N / 2], float* xs, int ld, int n0,
                                             const float* __restrict__ bias) {
  const AccPos p;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = n0 + 8 * j + p.ec;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2* xp = reinterpret_cast<float2*>(xs + (p.er + 8 * half) * ld + col);
      const float2 xv = *xp;
      *xp = make_float2(xv.x + (acc[4 * j + 2 * half] + b.x), xv.y + (acc[4 * j + 2 * half + 1] + b.y));
    }
  }
}

// silu(h1) * h3, the division as __fdividef (2 ulp; the divisor 1 + exp(-h1)
// lies in [1, 2^126] wherever silu is not already 0).
__device__ __forceinline__ float silu_gate(float h1, float h3) {
  return __fdividef(h1, 1.f + expf(-h1)) * h3;
}

// This warpgroup's part of one [W1 | W3] tile: T = N / 2 hidden columns
// from hc, its W1 rows over its W3 rows in one product, then h = silu(h1 +
// b1) * (h3 + b3) into the hidden tile (row-major, stride ldh), the A of W2.
template <int D, int N>
__device__ __forceinline__ void hidden_part(Ring& ring, const NormA& a, uint32_t b_off, float* hs,
                                            int ldh, const float* __restrict__ b1,
                                            const float* __restrict__ b3, int hc) {
  constexpr int T = N / 2;
  float acc[N / 2];
  product<N, 4>(acc, ring, a, Geom<D>::KA, b_off);
  const AccPos p;
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
    const int col = hc + 8 * j + p.ec;
    const float2 c1 = __ldg(reinterpret_cast<const float2*>(b1 + col));
    const float2 c3 = __ldg(reinterpret_cast<const float2*>(b3 + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i1 = 4 * j + 2 * half, i3 = 4 * (j + T / 8) + 2 * half;
      *reinterpret_cast<float2*>(hs + (p.er + 8 * half) * ldh + col) =
          make_float2(silu_gate(acc[i1] + c1.x, acc[i3] + c3.x),
                      silu_gate(acc[i1 + 1] + c1.y, acc[i3 + 1] + c3.y));
    }
  }
}

// Mean and 1 / sqrt(var + 1e-5) of this thread's A rows r0 = 16 (w % 4) + g
// and r0 + 8, from its warp's 16 residual rows: each row reduced by the
// whole warp (D / 32 columns a lane), the 16 rows in flight together. Both
// consumer warpgroups compute them, each for its own threads.
template <int D>
__device__ __forceinline__ void row_stats(const float* xs, float& mu0, float& inv0, float& mu8,
                                          float& inv8) {
  using G = Geom<D>;
  constexpr int E = D / 32;  // columns per lane: 2 or 4
  const int lane = threadIdx.x & 31, g = lane >> 2, row0 = 16 * ((threadIdx.x >> 5) & 3);
  float v[16][E], mu[16], sq[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float* xr = xs + (row0 + i) * G::LD + E * lane;
    mu[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[i][e] = xr[e];
      mu[i] += v[i][e];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) mu[i] += __shfl_xor_sync(0xffffffffu, mu[i], off);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mu[i] *= 1.f / D;
    sq[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) sq[i] += (v[i][e] - mu[i]) * (v[i][e] - mu[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], off);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i == g) {
      mu0 = mu[i];
      inv0 = rsqrtf(sq[i] * (1.f / D) + 1e-5f);
      mu8 = mu[i + 8];
      inv8 = rsqrtf(sq[i + 8] * (1.f / D) + 1e-5f);
    }
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

// o = softmax(q k^T * 0.25) v per (row, head), one consumer thread per pair,
// in f32, for sequences of S <= KMAX: the row's S logits computed once into
// registers (independent chains), their max, exp and sum, then the weighted
// sum of v times the sum's reciprocal. Rows are the fastest index, so the
// eight threads of a 16-byte access phase read eight rows (stride 4 mod 32
// words, or one broadcast key row), free of bank conflicts. o overwrites q
// in place: only this thread reads q[row, head]. Rows from nrows on (empty
// sequences) are skipped.
template <int D, int KMAX>
__device__ __forceinline__ void attention(float* qs, const float* ks, const float* vs, int S,
                                          int nrows) {
  using G = Geom<D>;
  for (int item = threadIdx.x; item < nrows * G::HEADS; item += kConsumerThreads) {
    const int r = item % nrows, c = (item / nrows) * kHeadDim;
    const int s0 = r - r % S;
    float* qp = qs + r * G::LD + c;
    float q[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4) {
      const float4 u = *reinterpret_cast<const float4*>(qp + d);
      q[d] = u.x;
      q[d + 1] = u.y;
      q[d + 2] = u.z;
      q[d + 3] = u.w;
    }
    const float* kp = ks + s0 * G::LD + c;
    const float* vp = vs + s0 * G::LD + c;
    float l[KMAX];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < S) {
        l[j] = dot16(q, kp + j * G::LD) * 0.25f;
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
          const float4 u = *reinterpret_cast<const float4*>(vp + j * G::LD + d);
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

// Built with -DHSIMAE_PHASE_CLOCKS (scripts/profile_fused_block.py), the
// first consumer thread of every CTA adds the SM clocks it spends in each
// phase of a tile into g_phase_clocks[phase]; without it PHASE_MARK is empty.
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fused_block_tf32x3_kernel(const float* __restrict__ x, float* __restrict__ out,
                              const uint8_t* __restrict__ hi, const uint8_t* __restrict__ lo,
                              const float* __restrict__ vecs, int S, int Hp, int nseq, int ntiles,
                              long long total_rows) {
  using G = Geom<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full0 = smem_u32(smem + G::BAR_OFF), empty0 = full0 + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerThreads / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int R = nseq * S;  // rows of whole sequences per tile
  const int hka = (Hp + kAtomK - 1) / kAtomK;

  if (warp >= kConsumerThreads / 32) {
    // ---- producer warpgroup: one thread streams the hi and lo tiles of the
    // pack, tile after tile, into the ring; the warpgroup hands its
    // registers to the consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumerThreads / 32 && lane == 0) {
      const uint32_t slots = smem_u32(smem);
      int stage = 0;
      uint32_t phase = 0;
      auto push = [&](const uint8_t* src, int bytes) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full0 + 8 * stage, bytes);
        bulk_load(slots + stage * kSlotBytes, src, bytes, full0 + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        long long off = 0;
        auto pair = [&](int bytes) {  // one K atom: its hi tile, then its lo tile
          push(hi + off, bytes);
          push(lo + off, bytes);
          off += bytes;
        };
        for (int i = 0; i < 4 * G::KA; ++i) pair(D * 128);  // q k v o
        for (int h0 = 0; h0 < Hp; h0 += kHidTile) {         // [W1 | W3]
          const int bytes = 2 * min(kHidTile, Hp - h0) * 128;
          for (int ka = 0; ka < G::KA; ++ka) pair(bytes);
        }
        for (int i = 0; i < hka; ++i) pair(D * 128);  // W2
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes output columns [wg NW, wg NW + NW) of
  // each D-wide product and its half of each [W1 | W3] tile; warp w holds
  // rows [16 (w % 4), + 16) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // this thread's A and accumulator rows: r0, r0 + 8
  constexpr int bar_all = 1;
  float* xs = reinterpret_cast<float*>(smem + G::X_OFF);
  float* qs = reinterpret_cast<float*>(smem + G::QKV_OFF);
  float* ks = qs + kRows * G::LD;
  float* vs = ks + kRows * G::LD;
  float* hs = qs;  // the hidden tile reuses q/k/v after the output projection
  const int ldh = Hp + 4;  // 4 mod 8 floats: conflict-free A loads
  const float* b1 = vecs + V_NUM_D * D;
  const float* b3 = b1 + Hp;
  const RowsA xrows{xs + r0 * G::LD + t, xs + (r0 + 8) * G::LD + t};
  const int n0 = wg * G::NW;                    // this warpgroup's columns of a D-wide product
  const uint32_t b_off = wg * G::NW * 128;      // and its rows of the product's B tiles
  Ring ring{smem_u32(smem), full0, empty0, 0, 0};
  constexpr int C4 = D / 4;  // float4 per row
#ifdef HSIMAE_PHASE_CLOCKS
  long long t0_ = clock64();
#endif
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * R;
    const int nvalid = (int)min((long long)R, total_rows - row0);
    bar_sync(bar_all, kConsumerThreads);  // q/k/v and the hidden tile are free of the previous tile
    PHASE_MARK(0)
#pragma unroll
    for (int i = threadIdx.x; i < kRows * C4; i += kConsumerThreads) {  // x rows, zero past the valid
      const int r = i / C4, c = (i % C4) * 4;
      *reinterpret_cast<float4*>(xs + r * G::LD + c) =
          r < nvalid ? __ldg(reinterpret_cast<const float4*>(x + (row0 + r) * D + c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    bar_sync(bar_all, kConsumerThreads);
    float mu0, inv0, mu8, inv8;
    row_stats<D>(xs, mu0, inv0, mu8, inv8);
    PHASE_MARK(1)

    // ---- attention half ----
    {
      const NormA y{xrows, mu0, inv0, mu8, inv8, vecs + V_LN1_S * D + t, vecs + V_LN1_B * D + t};
#pragma unroll 1
      for (int m = 0; m < 3; ++m) {
        float acc[G::NW / 2];
        product<G::NW, 4>(acc, ring, y, G::KA, b_off);
        store_biased<G::NW>(acc, qs + m * kRows * G::LD, G::LD, n0, vecs + (V_BQ + m) * D);
      }
    }
    bar_sync(bar_all, kConsumerThreads);  // q, k, v of every row and column are in place
    PHASE_MARK(2)
    if (S <= 4) attention<D, 4>(qs, ks, vs, S, nvalid);
    else if (S <= 9) attention<D, 9>(qs, ks, vs, S, nvalid);
    else if (S <= 18) attention<D, 18>(qs, ks, vs, S, nvalid);
    else if (S <= 36) attention<D, 36>(qs, ks, vs, S, nvalid);
    else attention<D, kMaxSeq>(qs, ks, vs, S, nvalid);
    bar_sync(bar_all, kConsumerThreads);  // o of every row is in place
    PHASE_MARK(3)
    {
      const RowsA o{qs + r0 * G::LD + t, qs + (r0 + 8) * G::LD + t};
      float acc[G::NW / 2];
      product<G::NW, 4>(acc, ring, o, G::KA, b_off);
      add_residual<G::NW>(acc, xs, G::LD, n0, vecs + V_BO * D);
    }
    // every residual column is updated, and every warp has read its o: the
    // hidden tile may overwrite q/k/v
    bar_sync(bar_all, kConsumerThreads);
    PHASE_MARK(4)

    // ---- SwiGLU half ----
    row_stats<D>(xs, mu0, inv0, mu8, inv8);
    PHASE_MARK(5)
    {
      const NormA y2{xrows, mu0, inv0, mu8, inv8, vecs + V_LN2_S * D + t, vecs + V_LN2_B * D + t};
      for (int h0 = 0; h0 < Hp; h0 += kHidTile) {
        // the tile's tw hidden columns: the first warpgroup takes tw0 (a
        // multiple of 8, at least half), the second the rest
        const int tw = min(kHidTile, Hp - h0), tw0 = (tw / 2 + 7) / 8 * 8;
        const int mine = wg == 0 ? tw0 : tw - tw0;
        const int hc = h0 + (wg == 0 ? 0 : tw0);
        const uint32_t off = wg == 0 ? 0 : 2 * tw0 * 128;
        switch (mine) {
          case 32: hidden_part<D, 64>(ring, y2, off, hs, ldh, b1, b3, hc); break;
          case 24: hidden_part<D, 48>(ring, y2, off, hs, ldh, b1, b3, hc); break;
          case 16: hidden_part<D, 32>(ring, y2, off, hs, ldh, b1, b3, hc); break;
          case 8: hidden_part<D, 16>(ring, y2, off, hs, ldh, b1, b3, hc); break;
          default: skip_atoms(ring, G::KA); break;
        }
      }
    }
    bar_sync(bar_all, kConsumerThreads);  // every hidden column is in place
    PHASE_MARK(6)
    {
      const RowsA h{hs + r0 * ldh + t, hs + (r0 + 8) * ldh + t};
      float acc[G::NW / 2];
      switch ((Hp - (hka - 1) * kAtomK) / 8) {  // K steps in the last atom
        case 1: product<G::NW, 1>(acc, ring, h, hka, b_off); break;
        case 2: product<G::NW, 2>(acc, ring, h, hka, b_off); break;
        case 3: product<G::NW, 3>(acc, ring, h, hka, b_off); break;
        default: product<G::NW, 4>(acc, ring, h, hka, b_off); break;
      }
      add_residual<G::NW>(acc, xs, G::LD, n0, vecs + V_B2 * D);
    }
    bar_sync(bar_all, kConsumerThreads);  // every output column is in place
    PHASE_MARK(7)
#pragma unroll
    for (int i = threadIdx.x; i < kRows * C4; i += kConsumerThreads) {
      const int r = i / C4, c = (i % C4) * 4;
      if (r < nvalid)
        *reinterpret_cast<float4*>(out + (row0 + r) * D + c) =
            *reinterpret_cast<const float4*>(xs + r * G::LD + c);
    }
    PHASE_MARK(8)
  }
}

template <int D>
long long image_bytes(int Hp) {
  using G = Geom<D>;
  const long long hka = (Hp + kAtomK - 1) / kAtomK;
  return 128LL * (4LL * G::KA * D + 2LL * Hp * G::KA + hka * D);
}

template <int D>
int launch(const void* x, void* out, const void* hi, const void* lo, const void* vecs, int M, int S,
           int Hp, cudaStream_t stream) {
  using G = Geom<D>;
  if (Hp > G::MAX_HIDDEN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_block_tf32x3_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int nseq = kRows / S;
  const int ntiles = (M + nseq - 1) / nseq;
  const int grid = ntiles < sms ? ntiles : sms;
  fused_block_tf32x3_kernel<D><<<grid, kThreads, G::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<const uint8_t*>(hi),
      static_cast<const uint8_t*>(lo), static_cast<const float*>(vecs), S, Hp, nseq, ntiles,
      (long long)M * S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef HSIMAE_PHASE_CLOCKS
// Copies the 16 phase-clock sums to host and zeroes them (synchronises).
int hsimae_fused_block_tf32x3_phase_clocks(unsigned long long* host) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_phase_clocks, sizeof(g_phase_clocks));
  unsigned long long zero[16] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif

// Longest sequence the kernel takes at width D (0 if D is unsupported).
int hsimae_fused_block_tf32x3_max_seq(int D) { return (D == 64 || D == 128) ? kMaxSeq : 0; }

// Dynamic shared memory a CTA of the kernel takes at width D, in bytes.
int hsimae_fused_block_tf32x3_smem_bytes(int D) {
  switch (D) {
    case 64: return Geom<64>::SMEM;
    case 128: return Geom<128>::SMEM;
    default: return 0;
  }
}

// Widest padded SwiGLU hidden axis the kernel takes at width D.
int hsimae_fused_block_tf32x3_max_hidden(int D) {
  switch (D) {
    case 64: return Geom<64>::MAX_HIDDEN;
    case 128: return Geom<128>::MAX_HIDDEN;
    default: return 0;
  }
}

// Bytes of one packed image (hi or lo) the kernel streams per row tile.
long long hsimae_fused_block_tf32x3_image_bytes(int D, int Hp) {
  switch (D) {
    case 64: return image_bytes<64>(Hp);
    case 128: return image_bytes<128>(Hp);
    default: return 0;
  }
}

// x, out: [M, S, D] float32. hi, lo: pack_block_tf32's TF32 weight images;
// vecs: its f32 LayerNorm and bias vectors. Hp: the padded hidden width (a
// multiple of 8). Returns the cudaError_t of the launch (0 on success); does
// not synchronise.
int hsimae_fused_block_tf32x3(const void* x, void* out, const void* hi, const void* lo,
                              const void* vecs, int M, int S, int D, int Hp, int num_heads,
                              void* stream) {
  if (M <= 0 || S <= 0 || S > kMaxSeq || num_heads * kHeadDim != D || Hp <= 0 || Hp % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(x, out, hi, lo, vecs, M, S, Hp, s);
    case 128: return launch<128>(x, out, hi, lo, vecs, M, S, Hp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
