// Device code shared by the EquivariantBlock forward (egnn_block.cu), its
// backward (egnn_block_bwd.cu) and the row-tiled stages (egnn_tiled.cu,
// egnn_tiled_bwd.cu, and their sequence-parallel slabs in egnn_sp.cu):
// constants, activations and the bf16 operand rounding of the bf16
// variants. The edge tile of the grids is in egnn_tile.cuh, the node GEMM in
// egnn_tc_gemm.cuh. See egnn_block.cu and egnn_tiled.cu for the designs and
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

}  // namespace
