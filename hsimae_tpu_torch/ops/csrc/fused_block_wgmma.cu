// One fused pre-LN transformer block over [M, S, D] bf16 sequences, on
// Hopper's tensor cores (sm_90a: wgmma, bulk async copies, mbarriers).
//
// Replaces the Pallas TPU kernel hsimae_tpu/ops/fused_block.py::_kernel
// (math _block_math) for the bfloat16 stream at D 64 and 128; D 256 runs
// csrc/fused_block_wgmma_d256.cu. Per sequence, rounding to bf16 where the
// reference does:
//
//   y  = bf16(LN1(x))                     f32 statistics, eps 1e-5
//   q, k, v = bf16(y W + b)               bf16 x bf16, f32 accumulators
//   o  = bf16(bf16(softmax(q k^T / 4)) v) per head (hd 16), softmax in f32
//   x  = bf16(x + bf16(o Wo + bo))
//   y2 = bf16(LN2(x))
//   x  = bf16(x + bf16(bf16(silu(y2 W1 + b1) * (y2 W3 + b3)) W2 + b2))
//
// What bounds it on an H100: operations. HSIMAE-B's block (D 128, SwiGLU
// hidden 344) at batch 4096 does ~59 GFLOP against ~77 MB of activations
// and packed weights, ~770 FLOP per byte, far above the card's bf16 balance
// point (~295). So the design keeps every intermediate on chip and feeds the
// tensor cores from shared memory:
//   * a CTA owns a row tile of whole sequences, 128 rows, one consumer
//     warpgroup per 64 rows; wgmma M is 64. Products are row-local,
//     so a sequence may straddle the two warpgroups; only LayerNorm (a warp
//     per row, eight rows in flight) and attention read across rows, from
//     shared memory;
//   * the residual, the LN output (the wgmma A operand, 128-byte swizzled,
//     K-major), q, k and v stay in shared memory (~222 KB at D 128); after
//     attention the q/k/v space holds the whole SwiGLU hidden tile, the A
//     operand of W2;
//   * the weights are packed once per model (ops/fused_block.py::pack_block)
//     as bf16 tiles in the order and swizzle the kernel consumes them: each
//     tile is up to 128 output rows x 64 K, one 128-byte swizzle atom, so one
//     plain cp.async.bulk puts it where the wgmma B descriptor expects it.
//     A producer warpgroup (one issuing thread; it hands its registers to
//     the consumers with setmaxnreg) keeps them in flight through a 3-stage
//     ring of 16 KB slots guarded by mbarriers (full: bytes landed; empty:
//     every consumer warp's wgmmas done with the slot); no tensor map, no
//     libcuda;
//   * W1 and W3 are interleaved per 64 hidden columns, so one m64n128 wgmma
//     gives a thread both halves of the gate; the hidden axis is padded
//     with zeros to a multiple of 16 (wgmma's K step) in the pack;
//   * epilogues (bias, rounding, residual add, the f32 silu gate) run in
//     registers on the wgmma accumulators;
//   * attention runs on mma.sync m16n8k16 (K step 16 = the head dim): each
//     logit is computed once into fragments, softmax in f32 on them, P
//     rounded to bf16 feeds P.V directly;
//   * the grid is persistent: one CTA per SM walks the row tiles; the
//     producer runs ahead across tile boundaries, and the consumers load the
//     next tile's x rows into registers during the SwiGLU half.
// What holds it back now (scripts/profile_fused_block.py, PERF.md): the
// weight stream. Every row tile re-reads the whole packed block (~400 KB at
// D 128) from L2, 470-560 MB per launch at batch 4096, and the products run
// at about a third of the tensor-core rate while epilogues and attention
// leave the tensor cores idle. Cluster multicast of the weight tiles and
// overlapping epilogues with the next products are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHeadDim = 16;
constexpr int kAtomK = 64;        // bf16 K columns in one 128-byte swizzle atom
constexpr int kHidTile = 64;      // hidden columns per W1|W3 tile
constexpr int kStages = 3;        // weight ring depth
constexpr int kSlotBytes = 16384; // one ring slot: <= 128 rows x 128 bytes
constexpr int kMaxSeq = 64;       // longest sequence (a tile holds whole sequences)
constexpr int kMaxSmem = 232448;
static_assert(kHeadDim == 16, "the attention scale 0.25 assumes head dim 16");

constexpr int align1024(int v) { return (v + 1023) / 1024 * 1024; }

template <int D>
struct Geom {
  static constexpr int NC = 2;  // consumer warpgroups
  static constexpr int RT = NC * 64;          // rows per tile
  static constexpr int THREADS = (NC + 1) * 128;  // + the producer warpgroup
  static constexpr int NT = D < 128 ? D : 128;  // output columns per D-wide wgmma
  static constexpr int NPARTS = D / NT;
  static constexpr int KA = D / kAtomK;  // K atoms of a D-deep product
  static constexpr int HEADS = D / kHeadDim;
  static constexpr int LDS = D + 8;  // row stride (elements) of x, q, k, v in shared memory
  static constexpr int ROW_BYTES = RT * LDS * 2;
  static constexpr int A_OFF = kStages * kSlotBytes;
  static constexpr int QKV_OFF = A_OFF + RT * D * 2;
  static constexpr int QKV_BYTES = align1024(3 * ROW_BYTES);
  static constexpr int X_OFF = QKV_OFF + QKV_BYTES;
  static constexpr int BAR_OFF = X_OFF + ROW_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * kStages * 8 + 1024;  // + slack to align the base
  // widest padded hidden axis the q/k/v space holds as the W2 A operand
  static constexpr int MAX_HIDDEN = QKV_BYTES / (RT * 128) * kAtomK;
  static_assert(SMEM <= kMaxSmem, "shared memory budget");
};

// Offsets into the packed f32 vector buffer, in pack_block's order.
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

// Makes this thread's generic-proxy shared writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across wgmma issue/wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a K-major, 128-byte-swizzled operand at shared address
// addr (1024-aligned atom, plus 32 bytes per K step of 16): LBO 16 B, SBO
// 1024 B (8 rows of 128 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Byte offset of element (row, col) in a K-major, 128-byte-swizzled operand
// of `rows` rows: atoms of 64 columns, each rows x 128 bytes.
__device__ __forceinline__ uint32_t sw128_offset(int row, int col, int rows) {
  return (col / kAtomK) * rows * 128 + row * 128 + ((((col % kAtomK) >> 3) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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

// Ring position of one consumer warpgroup; every consumer and the producer
// walk the same sequence of slots.
struct Ring {
  uint32_t slots;  // shared address of slot 0
  uint32_t full;   // shared address of full barrier 0 (8 bytes apart)
  uint32_t empty;  // shared address of empty barrier 0
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// acc = A x B for this warpgroup's 64 rows. A starts at shared address
// a_addr (atoms a_atom_bytes apart); B arrives as `katoms` ring tiles, the
// last of which carries LAST K steps of 16. Each slot is released as soon as
// the wgmmas that read it are done; one group stays in flight.
template <int N, int LAST = 4>
__device__ __forceinline__ void product(float (&acc)[N / 2], Ring& ring, uint32_t a_addr,
                                        uint32_t a_atom_bytes, int katoms) {
  const int lane = threadIdx.x & 31;
  int prev = -1;
  fence_regs(acc);
  for (int ka = 0; ka < katoms; ++ka) {
    mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    wg_fence();
    const uint32_t a = a_addr + ka * a_atom_bytes;
    const uint32_t b = ring.slots + ring.stage * kSlotBytes;
    if (ka < katoms - 1 || LAST == 4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<N>::mma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk), (ka | kk) != 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < LAST; ++kk)
        Wgmma<N>::mma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk), (ka | kk) != 0);
    }
    wg_commit();
    if (prev >= 0) {
      wg_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty + 8 * prev);
    }
    prev = ring.stage;
    ring.advance();
  }
  wg_wait<0>();
  fence_regs(acc);
  __syncwarp();
  if (lane == 0) mbar_arrive(ring.empty + 8 * prev);
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

// dst[row, n0 + col] = bf16(acc + bias), dst row-major with stride ld.
template <int N>
__device__ __forceinline__ void store_biased(const float (&acc)[N / 2], bf16* dst, int ld, int r_lo,
                                             int n0, const float* __restrict__ bias) {
  const AccPos p;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = n0 + 8 * j + p.ec;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
    const float b0 = bb.x, b1 = bb.y;
    *reinterpret_cast<uint32_t*>(dst + (r_lo + p.er) * ld + col) =
        pack_bf16x2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<uint32_t*>(dst + (r_lo + p.er + 8) * ld + col) =
        pack_bf16x2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
}

// xs[row, n0 + col] = bf16(xs + bf16(acc + bias)): the residual add.
template <int N>
__device__ __forceinline__ void add_residual(const float (&acc)[N / 2], bf16* xs, int ld, int r_lo,
                                             int n0, const float* __restrict__ bias) {
  const AccPos p;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = n0 + 8 * j + p.ec;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
    const float b0 = bb.x, b1 = bb.y;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t* xp = reinterpret_cast<uint32_t*>(xs + (r_lo + p.er + 8 * half) * ld + col);
      const float2 xv = unpack_bf16x2(*xp);
      *xp = pack_bf16x2(xv.x + round_bf16(acc[4 * j + 2 * half] + b0),
                        xv.y + round_bf16(acc[4 * j + 2 * half + 1] + b1));
    }
  }
}

__device__ __forceinline__ float silu_gate(float h1, float h3) {
  return __fdividef(h1, 1.f + __expf(-h1)) * h3;
}

// One tile of N / 2 hidden columns from h0: [W1 | W3] interleaved in one
// wgmma, then h = bf16(silu(h1 + b1) * (h3 + b3)) into the swizzled hidden
// operand (rows x Hp, the A of W2).
template <int D, int N>
__device__ __forceinline__ void hidden_tile(Ring& ring, uint32_t a_wg, uint8_t* hs,
                                            const float* __restrict__ b1,
                                            const float* __restrict__ b3, int h0, int r_lo) {
  using G = Geom<D>;
  constexpr int T = N / 2;
  float acc[N / 2];
  product<N>(acc, ring, a_wg, G::RT * 128, G::KA);
  const AccPos p;
  // h0 is a multiple of 64: one swizzle atom; rows er and er + 8 share the XOR
  const int row = r_lo + p.er, sw = row & 7;
  uint8_t* dst = hs + (h0 / kAtomK) * G::RT * 128 + row * 128 + 2 * p.ec;
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
    const int col = h0 + 8 * j + p.ec;
    const float2 c1 = __ldg(reinterpret_cast<const float2*>(b1 + col));
    const float2 c3 = __ldg(reinterpret_cast<const float2*>(b3 + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i1 = 4 * j + 2 * half, i3 = 4 * (j + T / 8) + 2 * half;
      *reinterpret_cast<uint32_t*>(dst + half * 8 * 128 + ((j ^ sw) << 4)) =
          pack_bf16x2(silu_gate(acc[i1] + c1.x, acc[i3] + c3.x),
                      silu_gate(acc[i1 + 1] + c1.y, acc[i3 + 1] + c3.y));
    }
  }
}

// out = bf16(LN(x) * scale + bias) for this warpgroup's 64 rows, one warp
// per row, eight rows at a time (independent shuffle chains), written as
// the swizzled A operand.
template <int D>
__device__ __forceinline__ void layer_norm(const bf16* xs, uint8_t* as,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, int r_lo) {
  using G = Geom<D>;
  constexpr int E = D / 32;  // columns per lane: 2, 4 or 8
  constexpr int U = 8;       // rows in flight per warp
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  float sc[E], bi[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    sc[e] = __ldg(scale + E * lane + e);
    bi[e] = __ldg(bias + E * lane + e);
  }
  for (int i0 = wl; i0 < 64; i0 += 4 * U) {
    float v[U][E], mu[U], sq[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t* xr =
          reinterpret_cast<const uint32_t*>(xs + (r_lo + i0 + 4 * u) * G::LDS + E * lane);
      mu[u] = 0.f;
#pragma unroll
      for (int e = 0; e < E / 2; ++e) {
        const float2 f = unpack_bf16x2(xr[e]);
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
      mu[u] *= 1.f / D;
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
      const float inv = rsqrtf(sq[u] * (1.f / D) + 1e-5f);
      uint32_t w[E / 2];
#pragma unroll
      for (int e = 0; e < E / 2; ++e)
        w[e] = pack_bf16x2((v[u][2 * e] - mu[u]) * inv * sc[2 * e] + bi[2 * e],
                           (v[u][2 * e + 1] - mu[u]) * inv * sc[2 * e + 1] + bi[2 * e + 1]);
      uint8_t* dst = as + sw128_offset(r, E * lane, G::RT);
      if constexpr (E == 2) {
        *reinterpret_cast<uint32_t*>(dst) = w[0];
      } else if constexpr (E == 4) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
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

// o = bf16(bf16(softmax(q k^T * 0.25)) v) per (sequence, head), on mma.sync
// m16n8k16, whose K step of 16 is the head dim. A unit is one block of 16
// query rows of one head: rows of one sequence (S > 8; ceil(S / 16) blocks
// per sequence) or of a group of 16 / S whole sequences (S <= 8), masked
// block-diagonally. Its logits (keys padded to KT blocks of 16, masked) are
// computed once into the accumulator fragments, the softmax runs in f32 on
// them (rows reduced across each quad), and P, rounded to bf16, is already
// the A fragment of P.V. A warp runs four units side by side (two for
// S > 32), independent chains that hide each other's latency. Row and key indices past a group are clamped onto
// its last row (their weights are 0; their outputs are not written). o goes
// out as the swizzled A operand of the output projection.
template <int D, int KT>
__device__ __forceinline__ void attention(const bf16* qs, const bf16* ks, const bf16* vs,
                                          uint8_t* as, int S, int nseq) {
  using G = Geom<D>;
  constexpr int LD = G::LDS, U = KT <= 2 ? 4 : 2, NW = G::NC * 4;
  // warps split the heads; where there are more warps than heads, the
  // warps of one head split its blocks
  constexpr int NSUB = NW > G::HEADS ? NW / G::HEADS : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int per = S > 8 ? 1 : 16 / S;      // sequences per group
  const int mtiles = (per * S + 15) / 16;  // query blocks per group
  const int blocks = (nseq + per - 1) / per * mtiles;
  for (int h = warp % G::HEADS; h < G::HEADS; h += NW)
  for (int b0 = warp / G::HEADS % NSUB; b0 < blocks; b0 += U * NSUB) {
    int base[U], rows[U], qb[U], qlo[U][2];
    uint32_t a[U][4];
    const int col = kHeadDim * h;
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
      const bf16* qp = qs + base[w] * LD + col + 2 * t;
      a[w][0] = lds32(qp + q0 * LD);
      a[w][1] = lds32(qp + q1 * LD);
      a[w][2] = lds32(qp + q0 * LD + 8);
      a[w][3] = lds32(qp + q1 * LD + 8);
    }
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
      for (int w = 0; w < U; ++w) {
        const int key = min(8 * j + g, rows[w] - 1);
        const bf16* kp = ks + (base[w] + key) * LD + col + 2 * t;
        lg[w][j][0] = lg[w][j][1] = lg[w][j][2] = lg[w][j][3] = 0.f;
        mma16816(lg[w][j], a[w][0], a[w][1], a[w][2], a[w][3], lds32(kp), lds32(kp + 8));
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
        const bf16* v0 = vs + (base[w] + min(k0, last)) * LD;
        const bf16* v1 = vs + (base[w] + min(k0 + 1, last)) * LD;
        const bf16* v8 = vs + (base[w] + min(k0 + 8, last)) * LD;
        const bf16* v9 = vs + (base[w] + min(k0 + 9, last)) * LD;
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const int c = col + 8 * nn + g;
          mma16816(o[w][nn], p0, p1, p2, p3, lds_pair(v0 + c, v1 + c), lds_pair(v8 + c, v9 + c));
        }
      }
    }
#pragma unroll
    for (int w = 0; w < U; ++w) {
      if (w > 0 && b0 + w * NSUB >= blocks) break;
      const int r0 = qb[w] + g;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int c = col + 8 * nn + 2 * t;
        if (r0 < rows[w])
          *reinterpret_cast<uint32_t*>(as + sw128_offset(base[w] + r0, c, G::RT)) =
              pack_bf16x2(o[w][nn][0], o[w][nn][1]);
        if (r0 + 8 < rows[w])
          *reinterpret_cast<uint32_t*>(as + sw128_offset(base[w] + r0 + 8, c, G::RT)) =
              pack_bf16x2(o[w][nn][2], o[w][nn][3]);
      }
    }
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
__global__ void __launch_bounds__(Geom<D>::THREADS, 1)
    fused_block_wgmma_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                             const uint8_t* __restrict__ image, const float* __restrict__ vecs,
                             int S, int Hp, int nseq, int ntiles, long long total_rows) {
  using G = Geom<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full0 = smem_u32(smem + G::BAR_OFF), empty0 = full0 + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, G::NC * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int R = nseq * S;  // rows of whole sequences per tile
  const int hka = (Hp + kAtomK - 1) / kAtomK;

  if (warp >= G::NC * 4) {
    // ---- producer warpgroup: one thread streams the packed block, tile
    // after tile, into the ring; the warpgroup hands its registers to the
    // consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == G::NC * 4 && lane == 0) {
      const uint32_t slots = smem_u32(smem);
      int stage = 0;
      uint32_t phase = 0;
      auto push = [&](const uint8_t*& src, int bytes) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full0 + 8 * stage, bytes);
        bulk_load(slots + stage * kSlotBytes, src, bytes, full0 + 8 * stage);
        src += bytes;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const uint8_t* src = image;
        for (int i = 0; i < 4 * G::NPARTS * G::KA; ++i) push(src, G::NT * 128);  // q k v o
        for (int h0 = 0; h0 < Hp; h0 += kHidTile) {                               // [W1 | W3]
          const int bytes = 2 * min(kHidTile, Hp - h0) * 128;
          for (int ka = 0; ka < G::KA; ++ka) push(src, bytes);
        }
        for (int i = 0; i < G::NPARTS * hka; ++i) push(src, G::NT * 128);  // W2
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int r_lo = 64 * wg;
  const int bar_wg = 2 + wg, n_all = G::NC * 128;
  constexpr int bar_all = 1;
  bf16* xs = reinterpret_cast<bf16*>(smem + G::X_OFF);
  bf16* qs = reinterpret_cast<bf16*>(smem + G::QKV_OFF);
  bf16* ks = qs + G::RT * G::LDS;
  bf16* vs = ks + G::RT * G::LDS;
  uint8_t* as = smem + G::A_OFF;
  uint8_t* hs = smem + G::QKV_OFF;  // the hidden tile reuses q/k/v after attention
  const uint32_t a_wg = smem_u32(as) + r_lo * 128, h_wg = smem_u32(hs) + r_lo * 128;
  Ring ring{smem_u32(smem), full0, empty0, 0, 0};
  constexpr int NT = G::NT, CPR = D / 8;  // 16-byte chunks per row

  // x rows of this warpgroup for one tile, 16 bytes a thread per step (zero
  // past the valid rows); loaded into registers a tile ahead
  constexpr int XV = 64 * CPR / 128;
  auto load_x = [&](int tile, uint4 (&v)[XV]) {
    const long long row0 = (long long)tile * R;
#pragma unroll
    for (int k = 0; k < XV; ++k) {
      const int i = tid + 128 * k, r = r_lo + i / CPR, c = (i % CPR) * 8;
      v[k] = row0 + r < total_rows && r < R
                 ? __ldg(reinterpret_cast<const uint4*>(x + (row0 + r) * D + c))
                 : make_uint4(0, 0, 0, 0);
    }
  };
  uint4 xnext[XV];
  if (blockIdx.x < ntiles) load_x(blockIdx.x, xnext);
#ifdef HSIMAE_PHASE_CLOCKS
  long long t0_ = clock64();
#endif
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * R;
    const int nvalid = (int)min((long long)R, total_rows - row0);
    bar_sync(bar_all, n_all);  // every buffer is free of the previous tile
    PHASE_MARK(0)
#pragma unroll
    for (int k = 0; k < XV; ++k) {
      const int i = tid + 128 * k;
      *reinterpret_cast<uint4*>(xs + (r_lo + i / CPR) * G::LDS + (i % CPR) * 8) = xnext[k];
    }
    bar_sync(bar_wg, 128);
    PHASE_MARK(1)

    // ---- attention half ----
    layer_norm<D>(xs, as, vecs + V_LN1_S * D, vecs + V_LN1_B * D, r_lo);
    fence_async_smem();
    bar_sync(bar_wg, 128);
    PHASE_MARK(2)
#pragma unroll 1
    for (int m = 0; m < 3; ++m) {
      for (int np = 0; np < G::NPARTS; ++np) {
        float acc[NT / 2];
        product<NT>(acc, ring, a_wg, G::RT * 128, G::KA);
        store_biased<NT>(acc, qs + m * G::RT * G::LDS, G::LDS, r_lo, np * NT,
                         vecs + (V_BQ + m) * D);
      }
    }
    PHASE_MARK(3)
    bar_sync(bar_all, n_all);  // q, k, v of every sequence are in place
    switch (S > 8 ? (S + 15) / 16 : 1) {  // key blocks of 16
      case 1: attention<D, 1>(qs, ks, vs, as, S, nvalid / S); break;
      case 2: attention<D, 2>(qs, ks, vs, as, S, nvalid / S); break;
      case 3: attention<D, 3>(qs, ks, vs, as, S, nvalid / S); break;
      default: attention<D, 4>(qs, ks, vs, as, S, nvalid / S); break;
    }
    fence_async_smem();
    bar_sync(bar_all, n_all);
    PHASE_MARK(4)
    for (int np = 0; np < G::NPARTS; ++np) {
      float acc[NT / 2];
      product<NT>(acc, ring, a_wg, G::RT * 128, G::KA);
      add_residual<NT>(acc, xs, G::LDS, r_lo, np * NT, vecs + V_BO * D);
    }
    bar_sync(bar_wg, 128);
    PHASE_MARK(5)

    // ---- SwiGLU half ----
    layer_norm<D>(xs, as, vecs + V_LN2_S * D, vecs + V_LN2_B * D, r_lo);
    fence_async_smem();
    bar_sync(bar_wg, 128);
    PHASE_MARK(6)
    if (tile + (int)gridDim.x < ntiles) load_x(tile + gridDim.x, xnext);
    const float* b1 = vecs + V_NUM_D * D;
    const float* b3 = b1 + Hp;
    for (int h0 = 0; h0 < Hp; h0 += kHidTile) {
      switch (min(kHidTile, Hp - h0)) {
        case 64: hidden_tile<D, 128>(ring, a_wg, hs, b1, b3, h0, r_lo); break;
        case 48: hidden_tile<D, 96>(ring, a_wg, hs, b1, b3, h0, r_lo); break;
        case 32: hidden_tile<D, 64>(ring, a_wg, hs, b1, b3, h0, r_lo); break;
        default: hidden_tile<D, 32>(ring, a_wg, hs, b1, b3, h0, r_lo); break;
      }
    }
    fence_async_smem();
    bar_sync(bar_wg, 128);
    PHASE_MARK(7)
    for (int np = 0; np < G::NPARTS; ++np) {
      float acc[NT / 2];
      switch ((Hp - (hka - 1) * kAtomK) / 16) {  // K steps in the last atom
        case 1: product<NT, 1>(acc, ring, h_wg, G::RT * 128, hka); break;
        case 2: product<NT, 2>(acc, ring, h_wg, G::RT * 128, hka); break;
        case 3: product<NT, 3>(acc, ring, h_wg, G::RT * 128, hka); break;
        default: product<NT, 4>(acc, ring, h_wg, G::RT * 128, hka); break;
      }
      add_residual<NT>(acc, xs, G::LDS, r_lo, np * NT, vecs + V_B2 * D);
    }
    bar_sync(bar_wg, 128);
    PHASE_MARK(8)
    for (int i = tid; i < 64 * CPR; i += 128) {
      const int r = r_lo + i / CPR, c = (i % CPR) * 8;
      if (r < nvalid)
        *reinterpret_cast<uint4*>(out + (row0 + r) * D + c) =
            *reinterpret_cast<const uint4*>(xs + r * G::LDS + c);
    }
  }
}

template <int D>
long long image_bytes(int Hp) {
  using G = Geom<D>;
  const long long hka = (Hp + kAtomK - 1) / kAtomK;
  return 128LL * (4LL * G::NPARTS * G::KA * G::NT + 2LL * Hp * G::KA + G::NPARTS * hka * G::NT);
}

template <int D>
int launch(const void* x, void* out, const void* image, const void* vecs, int M, int S, int Hp,
           cudaStream_t stream) {
  using G = Geom<D>;
  if (Hp > G::MAX_HIDDEN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_block_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int nseq = G::RT / S;
  const int ntiles = (M + nseq - 1) / nseq;
  const int grid = ntiles < sms ? ntiles : sms;
  fused_block_wgmma_kernel<D><<<grid, G::THREADS, G::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const uint8_t*>(image),
      static_cast<const float*>(vecs), S, Hp, nseq, ntiles, (long long)M * S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef HSIMAE_PHASE_CLOCKS
// Copies the 16 phase-clock sums to host and zeroes them (synchronises).
int hsimae_fused_block_wgmma_phase_clocks(unsigned long long* host) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_phase_clocks, sizeof(g_phase_clocks));
  unsigned long long zero[16] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif

// Longest sequence the kernel takes at width D (0 if D is unsupported).
int hsimae_fused_block_wgmma_max_seq(int D) {
  return (D == 64 || D == 128) ? kMaxSeq : 0;
}

// Dynamic shared memory a CTA of the kernel takes at width D, in bytes.
int hsimae_fused_block_wgmma_smem_bytes(int D) {
  switch (D) {
    case 64: return Geom<64>::SMEM;
    case 128: return Geom<128>::SMEM;
    default: return 0;
  }
}

// Widest padded SwiGLU hidden axis the kernel takes at width D.
int hsimae_fused_block_wgmma_max_hidden(int D) {
  switch (D) {
    case 64: return Geom<64>::MAX_HIDDEN;
    case 128: return Geom<128>::MAX_HIDDEN;
    default: return 0;
  }
}

// Bytes of the packed bf16 weight image the kernel streams per row tile.
long long hsimae_fused_block_wgmma_image_bytes(int D, int Hp) {
  switch (D) {
    case 64: return image_bytes<64>(Hp);
    case 128: return image_bytes<128>(Hp);
    default: return 0;
  }
}

// x, out: [M, S, D] bf16. image: pack_block's bf16 weight tiles; vecs: its
// f32 LayerNorm and bias vectors. Hp: the padded hidden width (a multiple of
// 16). Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
int hsimae_fused_block_wgmma(const void* x, void* out, const void* image, const void* vecs, int M,
                             int S, int D, int Hp, int num_heads, void* stream) {
  if (M <= 0 || S <= 0 || S > kMaxSeq || num_heads * kHeadDim != D || Hp <= 0 || Hp % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(x, out, image, vecs, M, S, Hp, s);
    case 128: return launch<128>(x, out, image, vecs, M, S, Hp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
