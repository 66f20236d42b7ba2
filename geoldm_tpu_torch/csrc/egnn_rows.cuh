// The row-tiled EquivariantBlock stages' forward (egnn_tiled.cu, TPU kernels
// #3 and #4): one CTA per (molecule, row), the columns streamed in masked tiles
// of kColTile. Shared by egnn_tiled.cu, whose header comment gives the design,
// and by the stage backward (egnn_tiled_bwd.cu, TPU kernel #5), which re-runs
// the GCL forward for its aggregate.

#pragma once

#include "egnn_common.cuh"

namespace {

constexpr int kColTile = 32;
// The largest N the card tests hold; beyond it a CTA's sequential walk over
// N/32 column tiles is untested, not impossible.
constexpr int kMaxTiledNodes = 1024;

template <bool COORD>
__device__ __forceinline__ void rows_stage(const EdgeArgs& a, float* smem) {
  const int H = a.H, N = a.N;
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5, nwarp = H >> 5;
  const int b = blockIdx.y, i = blockIdx.x;
  const size_t row_i = (size_t)b * N + i;

  float* As = smem;                            // [kColTile][H] silu(first layer)
  float* Ws = As + kColTile * H;               // [kKChunk][H + 1] W2 chunk, k-major
  float* ef = Ws + kKChunk * (H + 1);          // [kColTile][kMaxEdgeFeat]
  float* em = ef + kColTile * kMaxEdgeFeat;    // [kColTile] edge mask of row i
  float* cd = em + kColTile;                   // [kColTile][3] coord_diff
  float* red = cd + kColTile * 3;              // [nwarp][kColTile]
  float* rs = red + nwarp * kColTile;          // [kColTile] per-pair reductions

  const float mi = a.mask[row_i];
  float xi[3], x0i[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    xi[q] = a.x[row_i * 3 + q];
    x0i[q] = a.x0[row_i * 3 + q];
  }
  const float src = a.proj[row_i * 2 * H + c];
  const float bias1 = a.b1[c];
  const float bias2 = a.b2[c];
  const bool need_rowsum = COORD || a.attention;
  const float wo = need_rowsum ? a.w_out[c] : 0.f;
  float we[kMaxEdgeFeat];
#pragma unroll
  for (int e = 0; e < kMaxEdgeFeat; ++e)
    we[e] = e < a.E ? a.w1[(size_t)c * a.ld1 + 2 * H + e] : 0.f;

  float agg = 0.f;   // #3: this channel's sum over the row
  float aggx = 0.f;  // #4: thread c < 3 holds coordinate c's sum

  for (int j0 = 0; j0 < N; j0 += kColTile) {
    // 1. Pair features of the tile: thread c < kColTile owns column j0 + c
    //    (H >= 32 = kColTile threads).
    bool live = false;
    if (c < kColTile) {
      const int j = j0 + c;
      float* f = ef + c * kMaxEdgeFeat;
#pragma unroll
      for (int e = 0; e < kMaxEdgeFeat; ++e) f[e] = 0.f;
      float emv = 0.f;
      cd[c * 3 + 0] = cd[c * 3 + 1] = cd[c * 3 + 2] = 0.f;
      if (j < N) {
        const size_t rj = (size_t)b * N + j;
        float d[3], d0[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          d[q] = xi[q] - a.x[rj * 3 + q];
          d0[q] = x0i[q] - a.x0[rj * 3 + q];
        }
        const float r = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
        const float r0 = d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2];
        const float norm = sqrtf(r + 1e-8f);
#pragma unroll
        for (int q = 0; q < 3; ++q) cd[c * 3 + q] = d[q] / (norm + a.norm_constant);
        if (a.sin_emb) {
          const float dist0 = sqrtf(r0 + 1e-8f);
#pragma unroll
          for (int k = 0; k < kNumFreq; ++k) {
            f[k] = sinf(norm * kFreq[k]);
            f[kNumFreq + k] = cosf(norm * kFreq[k]);
            f[2 * kNumFreq + k] = sinf(dist0 * kFreq[k]);
            f[3 * kNumFreq + k] = cosf(dist0 * kFreq[k]);
          }
        } else {
          f[0] = r;
          f[1] = r0;
        }
        emv = j == i ? 0.f : mi * a.mask[rj];
      }
      em[c] = emv;
      live = emv != 0.f;
    }
    // Barrier for step 1; a tile with no live pair adds exactly zero.
    if (!__syncthreads_or(live)) continue;

    // 2. The tile's first-layer activations silu(src_i + dst_j + f_ij W1e + b1).
    for (int jj = 0; jj < kColTile; ++jj) {
      const int j = j0 + jj;
      float v = 0.f;
      if (j < N) {
        const float dst = a.proj[((size_t)b * N + j) * 2 * H + H + c];
        const float* f = ef + jj * kMaxEdgeFeat;
        float ew = 0.f;
        if (a.sin_emb) {
#pragma unroll
          for (int e = 0; e < kMaxEdgeFeat; ++e) ew = fmaf(f[e], we[e], ew);
        } else {
          ew = fmaf(f[1], we[1], f[0] * we[0]);
        }
        v = silu_f(src + dst + ew + bias1);
      }
      As[jj * H + c] = v;
    }
    __syncthreads();

    // 3. acc[jj] = sum_k As[jj][k] * W2[c][k], W2 streamed in K chunks.
    float acc[kColTile];
#pragma unroll
    for (int jj = 0; jj < kColTile; ++jj) acc[jj] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kKChunk) {
      for (int idx = c; idx < H * kKChunk; idx += H) {
        const int row = idx / kKChunk, kk = idx % kKChunk;
        Ws[kk * (H + 1) + row] = a.w2[(size_t)row * H + k0 + kk];
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kKChunk; kk += 4) {
        const float w0 = Ws[(kk + 0) * (H + 1) + c];
        const float w1 = Ws[(kk + 1) * (H + 1) + c];
        const float w2 = Ws[(kk + 2) * (H + 1) + c];
        const float w3 = Ws[(kk + 3) * (H + 1) + c];
#pragma unroll
        for (int jj = 0; jj < kColTile; ++jj) {
          const float4 av = *reinterpret_cast<const float4*>(As + jj * H + k0 + kk);
          acc[jj] = fmaf(av.x, w0, acc[jj]);
          acc[jj] = fmaf(av.y, w1, acc[jj]);
          acc[jj] = fmaf(av.z, w2, acc[jj]);
          acc[jj] = fmaf(av.w, w3, acc[jj]);
        }
      }
      __syncthreads();
    }

    // 4. m = silu(acc + b2); rs_jj = sum_c m[c] * w_out[c] (attention logit
    //    or coordinate scale), reduced across the CTA.
#pragma unroll
    for (int jj = 0; jj < kColTile; ++jj) acc[jj] = silu_f(acc[jj] + bias2);
    if (need_rowsum) {
#pragma unroll
      for (int jj = 0; jj < kColTile; ++jj) {
        float p = acc[jj] * wo;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        if (lane == 0) red[warp * kColTile + jj] = p;
      }
      __syncthreads();
      if (c < kColTile) {
        float s = 0.f;
        for (int w = 0; w < nwarp; ++w) s += red[w * kColTile + c];
        if (COORD) {
          rs[c] = a.use_tanh ? tanhf(s) * a.coords_range : s;
        } else {
          rs[c] = sigmoid_f(s + a.b_out[0]);
        }
      }
      __syncthreads();
    }

    // 5. Fold the tile into the row's sums.
    if (!COORD) {
#pragma unroll
      for (int jj = 0; jj < kColTile; ++jj) {
        const float m = a.attention ? acc[jj] * rs[jj] : acc[jj];
        agg += m * em[jj];
      }
    } else if (c < 3) {
      for (int jj = 0; jj < kColTile; ++jj) aggx += cd[jj * 3 + c] * rs[jj] * em[jj];
    }
    __syncthreads();  // the next tile overwrites ef, em, cd, As and rs
  }

  if (!COORD) {
    a.agg[row_i * H + c] = agg / a.norm_div;
  } else if (c < 3) {
    a.x_out[row_i * 3 + c] = (a.x[row_i * 3 + c] + aggx / a.norm_div) * mi;
  }
}

__global__ void __launch_bounds__(kMaxHidden, 1) gcl_rows_kernel(EdgeArgs a) {
  extern __shared__ __align__(16) float smem[];
  rows_stage<false>(a, smem);
}

__global__ void __launch_bounds__(kMaxHidden, 1) coord_rows_kernel(EdgeArgs a) {
  extern __shared__ __align__(16) float smem[];
  rows_stage<true>(a, smem);
}

int launch_rows(bool coord, const EdgeArgs& a, int B, cudaStream_t s) {
  void (*kern)(EdgeArgs) = coord ? coord_rows_kernel : gcl_rows_kernel;
  const size_t smem = edge_smem_bytes(kColTile, a.H);
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(a.N, B), a.H, smem, s>>>(a);
  return (int)cudaGetLastError();
}

bool bad_dims(int B, int N, int H, int E, int sin_emb) {
  return B < 1 || B > 65535 || N < 1 || N > kMaxTiledNodes || H < 32 || H > kMaxHidden ||
         H % 32 || E != (sin_emb ? kMaxEdgeFeat : 2);
}

EdgeArgs stage_args(const float* x, const float* x0, const float* mask, float* proj,
                    const float* const* w, int N, int H, int E, int sin_emb, int mean_agg,
                    float norm_constant, float normalization_factor) {
  EdgeArgs ea = {};
  ea.proj = proj; ea.x = x; ea.x0 = x0; ea.mask = mask;
  ea.w1 = w[0]; ea.ld1 = 2 * H + E; ea.b1 = w[1]; ea.w2 = w[2]; ea.b2 = w[3];
  ea.N = N; ea.H = H; ea.E = E; ea.sin_emb = sin_emb;
  ea.norm_constant = norm_constant;
  ea.norm_div = mean_agg ? (float)N : normalization_factor;
  return ea;
}

}  // namespace
