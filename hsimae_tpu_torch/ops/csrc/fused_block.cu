// One fused pre-LN transformer block over [M, S, D] sequences, for sm_90a.
//
// Replaces the Pallas TPU kernel hsimae_tpu/ops/fused_block.py::_kernel
// (launched by fused_encoder_block, math in _block_math). Per sequence:
//
//   y  = LN1(x)                          f32, eps 1e-5, rounded to T
//   q, k, v = y W + b                    rounded to T
//   o  = softmax(q k^T * hd^-0.5) v      per head (hd 16), softmax in f32
//   x += round_T(o Wo + bo)
//   y2 = LN2(x)                          rounded to T
//   x += round_T(W2(round_T(silu(W1 y2 + b1) * (W3 y2 + b3))) + b2)
//
// T is the stream dtype (float or bf16); weights are float32 in [in, out]
// layout and are rounded to T as they are read, so every product is
// T x T accumulated in f32, as in the reference.
//
// What bounds it on an H100: operations. At HSIMAE-B shapes (D 128,
// SwiGLU hidden 344) one launch at batch 4096 does about 59 GFLOP and moves
// about 151 MB of activations in f32 (x read once, the output written once),
// about 390 FLOP per byte, far above the card's f32 balance point. This
// first design keeps everything but the weights on chip and spends nothing
// on speed beyond that:
//   * one CTA of 256 threads owns a tile of whole sequences, up to 64 rows;
//     the residual, LN outputs, q/k/v and the attention output stay in
//     dynamic shared memory (5 row tiles, up to ~200 KB), so activations
//     cross device memory exactly once each way;
//   * the block's weights (790 KB in f32 at D 128) do not fit in shared
//     memory; each product streams them from global memory, where they stay
//     resident in the 50 MB L2, as float4 rows shared by a warp;
//   * the SwiGLU hidden axis is walked in chunks of 32 columns, each chunk's
//     silu(W1 y2) * W3 y2 tile feeding W2 at once, so the R x H hidden tile
//     is never held whole; H needs only be a multiple of 4 (float4 columns),
//     so 172, 344 and 684 run unpadded;
//   * products run on the f32 CUDA cores (no tensor cores): register tiles
//     of 8 rows x 4 columns, 4-deep float4 steps over K.
// wgmma, TMA and warp specialisation are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 16;
constexpr int kMaxRows = 64;     // tokens per CTA (whole sequences)
constexpr int kRowTile = 8;      // rows per thread in the D-wide products
constexpr int kHidChunk = 32;    // SwiGLU hidden columns per chunk
constexpr int kMaxSmem = 232448; // dynamic shared memory a block may use
constexpr int kNumWeights = 18;
static_assert(kHeadDim == 16, "the attention scale below assumes head dim 16");

// Same order as hsimae_tpu_torch.ops.fused_block.BlockParams.
enum { LN1_S, LN1_B, WQ, BQ, WK, BK, WV, BV, WO, BO, LN2_S, LN2_B, W1, B1, W3, B3, W2, B2 };

struct Weights {
  const float* p[kNumWeights];
};

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

template <typename T>
__device__ __forceinline__ float4 load_weight4(const float* p) {
  float4 w = __ldg(reinterpret_cast<const float4*>(p));
  w.x = Num<T>::rnd(w.x);
  w.y = Num<T>::rnd(w.y);
  w.z = Num<T>::rnd(w.z);
  w.w = Num<T>::rnd(w.w);
  return w;
}

__device__ __forceinline__ void fma4(float* acc, float a, const float4& w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[TR][4] += A[r0:r0+TR, k:k+4] . W[k:k+4, n0:n0+4], over all K.
template <typename T, int TR>
__device__ __forceinline__ void tile_product(float (&acc)[TR][4], const float* A, int lda,
                                             const float* __restrict__ W, int ldw, int K,
                                             int r0, int n0) {
  for (int k = 0; k < K; k += 4) {
    float4 w[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) w[kk] = load_weight4<T>(W + (size_t)(k + kk) * ldw + n0);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
      fma4(acc[i], a.x, w[0]);
      fma4(acc[i], a.y, w[1]);
      fma4(acc[i], a.z, w[2]);
      fma4(acc[i], a.w, w[3]);
    }
  }
}

// out[r, n] = sum_k A[r, k] W[k, n] for r < Rp, n < N, handed to epi(r, n0, acc[4])
// four columns at a time. A lives in shared memory, W in global memory.
template <typename T, int TR, typename Epi>
__device__ __forceinline__ void matmul(const float* A, int lda, const float* __restrict__ W,
                                       int ldw, int K, int N, int Rp, Epi epi) {
  const int ncg = N / 4;
  const int tiles = (Rp / TR) * ncg;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int n0 = (t % ncg) * 4;
    const int r0 = (t / ncg) * TR;
    float acc[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    tile_product<T, TR>(acc, A, lda, W, ldw, K, r0, n0);
#pragma unroll
    for (int i = 0; i < TR; ++i) epi(r0 + i, n0, acc[i]);
  }
}

// hs[r, n] = round_T(silu(y W1[:, n] + b1[n]) * (y W3[:, n] + b3[n])) for one
// chunk of N hidden columns (W1, W3, b1, b3 already offset to the chunk).
template <typename T>
__device__ __forceinline__ void swiglu_chunk(const float* Y, int lda, const float* __restrict__ W1c,
                                             const float* __restrict__ W3c, int ldw,
                                             const float* __restrict__ b1c,
                                             const float* __restrict__ b3c, int K, int N, int Rp,
                                             float* hs, int ldh) {
  constexpr int TR = 2;
  const int ncg = N / 4;
  const int tiles = (Rp / TR) * ncg;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int n0 = (t % ncg) * 4;
    const int r0 = (t / ncg) * TR;
    float a1[TR][4], a3[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a1[i][j] = a3[i][j] = 0.f;
    }
    tile_product<T, TR>(a1, Y, lda, W1c, ldw, K, r0, n0);
    tile_product<T, TR>(a3, Y, lda, W3c, ldw, K, r0, n0);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h1 = a1[i][j] + b1c[n0 + j];
        const float h3 = a3[i][j] + b3c[n0 + j];
        hs[(r0 + i) * ldh + n0 + j] = Num<T>::rnd(h1 / (1.f + expf(-h1)) * h3);
      }
    }
  }
}

// dst[r, :] = round_T(LN(src[r, :]) * scale + bias), one warp per row.
template <typename T>
__device__ __forceinline__ void layer_norm(const float* src, float* dst, const float* __restrict__ scale,
                                           const float* __restrict__ bias, int Rp, int D, int ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < Rp; r += kWarps) {
    const float* xr = src + r * ld;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += xr[c];
    const float mu = warp_sum(s) / D;
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = xr[c] - mu;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / D + 1e-5f);
    for (int c = lane; c < D; c += 32) dst[r * ld + c] = Num<T>::rnd((xr[c] - mu) * inv * scale[c] + bias[c]);
  }
}

__device__ __forceinline__ float dot16(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 4) {
    const float4 u = *reinterpret_cast<const float4*>(a + d);
    const float4 v = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
    s = fmaf(u.z, v.z, s);
    s = fmaf(u.w, v.w, s);
  }
  return s;
}

// One thread per (row, head): o = round_T(round_T(softmax(q k^T * scale)) v).
template <typename T>
__device__ __forceinline__ void attention(const float* qs, const float* ks, const float* vs, float* os,
                                          int S, int D, int R, int Rp, int ld) {
  const int nh = D / kHeadDim;
  const float scale = 0.25f;  // kHeadDim ** -0.5
  for (int item = threadIdx.x; item < Rp * nh; item += kThreads) {
    const int r = item / nh, h = item % nh;
    float* o = os + r * ld + h * kHeadDim;
    if (r >= R) {
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) o[d] = 0.f;
      continue;
    }
    const int s0 = (r / S) * S;
    const float* q = qs + r * ld + h * kHeadDim;
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) m = fmaxf(m, dot16(q, ks + (s0 + j) * ld + h * kHeadDim) * scale);
    float sum = 0.f;
    for (int j = 0; j < S; ++j) sum += expf(dot16(q, ks + (s0 + j) * ld + h * kHeadDim) * scale - m);
    float acc[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float p =
          Num<T>::rnd(expf(dot16(q, ks + (s0 + j) * ld + h * kHeadDim) * scale - m) / sum);
      const float* v = vs + (s0 + j) * ld + h * kHeadDim;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(p, v[d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) o[d] = Num<T>::rnd(acc[d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_block_kernel(const T* __restrict__ x, T* __restrict__ out, Weights w, int M, int S,
                       int D, int H, int nseq, int Rp) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;  // row stride of every [Rp, D] tile (keeps float4 alignment)
  float* xs = smem;         // residual stream, f32 copy of T values
  float* ys = xs + Rp * ld; // LN1 out -> attention out -> LN2 out
  float* qs = ys + Rp * ld; // q -> SwiGLU output accumulator
  float* ks = qs + Rp * ld; // k -> hidden chunk
  float* vs = ks + Rp * ld; // v

  const int R = nseq * S;
  const size_t row0 = (size_t)blockIdx.x * R;
  const size_t total = (size_t)M * S;
  const size_t rem = total - row0;
  const int nvalid = rem < (size_t)R ? (int)rem : R;

  for (int i = threadIdx.x; i < Rp * D; i += kThreads) {
    const int r = i / D, c = i % D;
    xs[r * ld + c] = r < nvalid ? Num<T>::load(x + (row0 + r) * D + c) : 0.f;
  }
  __syncthreads();

  // ---- attention half ----
  layer_norm<T>(xs, ys, w.p[LN1_S], w.p[LN1_B], Rp, D, ld);
  __syncthreads();
  {
    float* dsts[3] = {qs, ks, vs};
    const int widx[3] = {WQ, WK, WV};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float* dst = dsts[m];
      const float* __restrict__ b = w.p[widx[m] + 1];
      matmul<T, kRowTile>(ys, ld, w.p[widx[m]], D, D, D, Rp, [&](int r, int n0, const float* acc) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[r * ld + n0 + j] = Num<T>::rnd(acc[j] + b[n0 + j]);
      });
    }
  }
  __syncthreads();
  attention<T>(qs, ks, vs, ys, S, D, R, Rp, ld);
  __syncthreads();
  {
    const float* __restrict__ bo = w.p[BO];
    matmul<T, kRowTile>(ys, ld, w.p[WO], D, D, D, Rp, [&](int r, int n0, const float* acc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* xp = xs + r * ld + n0 + j;
        *xp = Num<T>::rnd(*xp + Num<T>::rnd(acc[j] + bo[n0 + j]));
      }
    });
  }
  __syncthreads();

  // ---- SwiGLU half ----
  layer_norm<T>(xs, ys, w.p[LN2_S], w.p[LN2_B], Rp, D, ld);
  for (int i = threadIdx.x; i < Rp * ld; i += kThreads) qs[i] = 0.f;
  __syncthreads();
  float* hs = ks;
  const int ldh = kHidChunk + 4;
  for (int h0 = 0; h0 < H; h0 += kHidChunk) {
    const int hc = min(kHidChunk, H - h0);
    swiglu_chunk<T>(ys, ld, w.p[W1] + h0, w.p[W3] + h0, H, w.p[B1] + h0, w.p[B3] + h0, D, hc, Rp,
                    hs, ldh);
    __syncthreads();
    matmul<T, kRowTile>(hs, ldh, w.p[W2] + (size_t)h0 * D, D, hc, D, Rp,
                        [&](int r, int n0, const float* acc) {
#pragma unroll
                          for (int j = 0; j < 4; ++j) qs[r * ld + n0 + j] += acc[j];
                        });
    __syncthreads();
  }
  const float* __restrict__ b2 = w.p[B2];
  for (int i = threadIdx.x; i < nvalid * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float mlp = Num<T>::rnd(qs[r * ld + c] + b2[c]);
    Num<T>::store(out + (row0 + r) * D + c, xs[r * ld + c] + mlp);
  }
}

template <typename T>
int launch(const void* x, void* out, const Weights& w, int M, int S, int D, int H, int nseq,
           int Rp, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_block_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M + nseq - 1) / nseq;
  fused_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), w, M, S, D, H, nseq, Rp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest sequence length one CTA can hold at width D (0 if D is unsupported).
int hsimae_fused_block_max_seq(int D) {
  if (D <= 0 || D % kHeadDim != 0 || D > 256) return 0;
  int rows = kMaxSmem / (5 * (D + 4) * (int)sizeof(float));
  rows = rows < kMaxRows ? rows : kMaxRows;
  return rows - rows % kRowTile;
}

// dtype 0: float32, 1: bfloat16. weights: kNumWeights float32 device pointers
// in BlockParams order, w1/w3 [D, H], w2 [H, D], H a multiple of 4.
// Returns the cudaError_t of the launch (0 on success). Does not synchronise.
int hsimae_fused_block(int dtype, const void* x, void* out, const void* const* weights, int M,
                       int S, int D, int H, int num_heads, void* stream) {
  const int max_seq = hsimae_fused_block_max_seq(D);
  if (M <= 0 || S <= 0 || S > max_seq || num_heads * kHeadDim != D || H <= 0 || H % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int nseq = max_seq / S;
  const int R = nseq * S;
  const int Rp = (R + kRowTile - 1) / kRowTile * kRowTile;
  const size_t smem = (size_t)5 * Rp * (D + 4) * sizeof(float);
  Weights w;
  for (int i = 0; i < kNumWeights; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, w, M, S, D, H, nseq, Rp, smem, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, w, M, S, D, H, nseq, Rp, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
