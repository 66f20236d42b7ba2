// Device code shared by the EquivariantBlock forward (egnn_block.cu), its
// backward (egnn_block_bwd.cu) and the row-tiled stages (egnn_tiled.cu,
// egnn_tiled_bwd.cu, and their sequence-parallel slabs in egnn_sp.cu):
// constants, activations, the bf16 operand rounding of the bf16 forward
// variants, the f32 node GEMM with its fused epilogues and the src/dst
// projection. The edge tile of the forward grids is in
// egnn_tile.cuh. See egnn_block.cu and egnn_tiled.cu for the designs and
// what bounds them on an H100.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxEdgeFeat = 24;  // 2 * SIN_EMBEDDING_DIM
constexpr int kNumFreq = 6;
constexpr int kMaxHidden = 512;
constexpr int kMaxNodes = 64;

// 2*pi*4^k/15 in double, rounded once to f32 (ops/distance.py:_FREQUENCIES).
__constant__ float kFreq[kNumFreq] = {
    (float)(2.0 * 3.141592653589793 * 1.0 / 15.0),
    (float)(2.0 * 3.141592653589793 * 4.0 / 15.0),
    (float)(2.0 * 3.141592653589793 * 16.0 / 15.0),
    (float)(2.0 * 3.141592653589793 * 64.0 / 15.0),
    (float)(2.0 * 3.141592653589793 * 256.0 / 15.0),
    (float)(2.0 * 3.141592653589793 * 1024.0 / 15.0),
};

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float silu_f(float v) { return v * sigmoid_f(v); }

__global__ void silu_kernel(const float* in, float* out, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) out[idx] = silu_f(in[idx]);
}

// ---------------------------------------------------------------------------
// bf16 operands (the bf16 forward variants of #1, #3, #4): every matrix
// product takes its operands rounded to bf16 (to nearest, ties to even) and
// sums in f32, as JAX's _matmul does under a bf16 compute dtype. A product
// of two bf16 values is exact in f32, so an f32 FMA of rounded operands is
// a bf16 product with f32 accumulation.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x rounded to a BF16 operand, x itself in the f32 kernels.
template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (BF16) return bf16_round(x);
  else return x;
}

// Two bf16 values in one register, lo in the low half (the element with the
// lower k of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void to_bf16_kernel(const float* in, __nv_bfloat16* out, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) out[idx] = __float2bfloat16_rn(in[idx]);
}

// out [n] = bf16(in): a W2 converted once per launch for the bf16 edge tile.
int to_bf16(const float* in, void* out, int n, cudaStream_t s) {
  to_bf16_kernel<<<(n + 255) / 256, 256, 0, s>>>(in, static_cast<__nv_bfloat16*>(out), n);
  return (int)cudaGetLastError();
}

__global__ void round_bf16_kernel(float* p, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) p[idx] = bf16_round(p[idx]);
}

// p [n] = bf16(p), in place: a bf16 backward's weight gradient, rounded once
// after its f32 sum over every edge and molecule (the bf16 operand's
// gradient, as the transpose of a bf16 product returns it).
int round_bf16(float* p, int n, cudaStream_t s) {
  if (!p) return 0;
  round_bf16_kernel<<<(n + 255) / 256, 256, 0, s>>>(p, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Node GEMM: C[m, n] = epilogue(sum_k A[m, k] * W[n, k]); W in nn.Linear
// layout [out, in]. A may be split by columns: A[:, :k1] from a1 and
// A[:, k1:] from a2 (the node MLP's [h, agg] input without a concat).
// ---------------------------------------------------------------------------

enum { kEpiNone = 0, kEpiSilu = 1, kEpiResidMask = 2 };

struct GemmArgs {
  const float* a1; int lda1; int k1;
  const float* a2; int lda2;
  const float* w; int ldw;
  const float* bias;      // [Nout] or null
  const float* resid; int ldr;
  const float* row_mask;  // [M], kEpiResidMask
  float* c; int ldc;
  int M, Nout, K;
  int epilogue;
};

constexpr int kTM = 64, kTN = 64, kTK = 16;

// kOwner only names the grid in a profile: 1 for the whole-block kernels
// (#1, #2), 3 and 4 for the row-tiled GCL and coordinate stages, 5 for their
// backward, 6 and 7 for the sequence-parallel slab stages and their backward.
// BF16: the operands are rounded to bf16 as they enter shared memory (the
// bf16 variants of #3/#4).
template <int kOwner, bool BF16 = false>
__global__ void __launch_bounds__(256) gemm_nt_kernel(GemmArgs g) {
  __shared__ float As[kTK][kTM + 4];
  __shared__ float Ws[kTK][kTN + 4];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += kTK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = t + 256 * q;
      const int r = idx / kTK, kk = idx % kTK;
      const int k = k0 + kk;
      const int m = m0 + r, n = n0 + r;
      float av = 0.f, wv = 0.f;
      if (m < g.M && k < g.K)
        av = k < g.k1 ? g.a1[(size_t)m * g.lda1 + k]
                      : g.a2[(size_t)m * g.lda2 + (k - g.k1)];
      if (n < g.Nout && k < g.K) wv = g.w[(size_t)n * g.ldw + k];
      As[kk][r] = operand<BF16>(av);
      Ws[kk][r] = operand<BF16>(wv);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.Nout) continue;
      float v = acc[i][j];
      if (g.bias) v += g.bias[n];
      if (g.epilogue == kEpiSilu) v = silu_f(v);
      if (g.epilogue == kEpiResidMask)
        v = (g.resid[(size_t)m * g.ldr + n] + v) * g.row_mask[m];
      g.c[(size_t)m * g.ldc + n] = v;
    }
  }
}

template <int kOwner = 1, bool BF16 = false>
int launch_gemm(const GemmArgs& g, cudaStream_t s) {
  dim3 grid((g.Nout + kTN - 1) / kTN, (g.M + kTM - 1) / kTM);
  gemm_nt_kernel<kOwner, BF16><<<grid, 256, 0, s>>>(g);
  return (int)cudaGetLastError();
}

// proj[:Mr, :H] = hr W1[:, :H]^T (the src half, over the rows a stage
// computes) and proj[:Mc, H:2H] = hc W1[:, H:2H]^T (the dst half, over the
// columns); no bias: b1 is added once per edge in the edge kernel, as the TPU
// kernel does. The row stride of proj is 2H.
template <int kOwner = 1, bool BF16 = false>
int launch_projection_window(const float* hr, int Mr, const float* hc, int Mc,
                             const float* w1, int ld1, float* proj, int H, cudaStream_t s) {
  for (int half = 0; half < 2; ++half) {
    GemmArgs g = {};
    g.a1 = half ? hc : hr; g.lda1 = H; g.k1 = H;
    g.w = w1 + half * H; g.ldw = ld1;
    g.c = proj + half * H; g.ldc = 2 * H;
    g.M = half ? Mc : Mr; g.Nout = H; g.K = H;
    g.epilogue = kEpiNone;
    const int rc = launch_gemm<kOwner, BF16>(g, s);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace
