// The row-tiled EquivariantBlock stages' forward (egnn_tiled.cu, TPU kernels
// #3 and #4): one CTA per (molecule, row), the columns streamed in masked tiles
// of kColTile. Shared by egnn_tiled.cu, whose header comment gives the design,
// by the stage backward (egnn_rows_bwd.cuh, TPU kernels #5 and #7), which
// re-runs the GCL forward for its aggregate, and by the sequence-parallel slab
// stages (egnn_sp.cu, TPU kernel #6).
//
// Row window: a stage computes the rows row0..row0+S of every molecule (its
// slab) against all N columns. The slab's own tensors are [B*S, *] views,
// apart from the [B*N, *] views of the columns; the diagonal is masked at the
// global row row0 + s, and 'mean' divides by the caller's divisor. The
// single-device stages (#3, #4, #5) pass the full view as the slab: row0 0,
// S = N, the same pointers, and their arithmetic is unchanged.

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
  const int b = blockIdx.y;
  const int i = a.row0 + blockIdx.x;                     // global row: the diagonal
  const size_t row_i = (size_t)b * a.S + blockIdx.x;     // index into the slab's views

  float* As = smem;                            // [kColTile][H] silu(first layer)
  float* Ws = As + kColTile * H;               // [kKChunk][H + 1] W2 chunk, k-major
  float* ef = Ws + kKChunk * (H + 1);          // [kColTile][kMaxEdgeFeat]
  float* em = ef + kColTile * kMaxEdgeFeat;    // [kColTile] edge mask of row i
  float* cd = em + kColTile;                   // [kColTile][3] coord_diff
  float* red = cd + kColTile * 3;              // [nwarp][kColTile]
  float* rs = red + nwarp * kColTile;          // [kColTile] per-pair reductions

  const float mi = a.maskr[row_i];
  float xi[3], x0i[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    xi[q] = a.xr[row_i * 3 + q];
    x0i[q] = a.x0r[row_i * 3 + q];
  }
  const float src = a.src[row_i * a.ld_src + c];
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
        const float dst = a.dst[((size_t)b * N + j) * a.ld_dst + c];
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
    a.x_out[row_i * 3 + c] = (a.xr[row_i * 3 + c] + aggx / a.norm_div) * mi;
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
  kern<<<dim3(a.S, B), a.H, smem, s>>>(a);
  return (int)cudaGetLastError();
}

bool bad_dims(int B, int N, int H, int E, int sin_emb) {
  return B < 1 || B > 65535 || N < 1 || N > kMaxTiledNodes || H < 32 || H > kMaxHidden ||
         H % 32 || E != (sin_emb ? kMaxEdgeFeat : 2);
}

// A stage's rows: the slab row0..row0+S of every molecule, h, x, x0 and mask
// at [B*S, *].
struct Slab {
  const float *h, *x, *x0, *mask;
  int row0, S;
};

bool bad_slab(const Slab& r, int N) {
  return r.row0 < 0 || r.S < 1 || r.row0 + r.S > N;
}

// Edge-kernel arguments of a stage over slab r against the columns x, x0,
// mask [B*N, *]; proj holds the src projection of the slab's rows in its
// first H columns and the dst projection of all columns in the next H.
EdgeArgs stage_args(const Slab& r, const float* x, const float* x0, const float* mask,
                    float* proj, const float* const* w, int N, int H, int E, int sin_emb,
                    float norm_div, float norm_constant) {
  EdgeArgs ea = {};
  ea.proj = proj; ea.x = x; ea.x0 = x0; ea.mask = mask;
  ea.xr = r.x; ea.x0r = r.x0; ea.maskr = r.mask;
  ea.src = proj; ea.ld_src = 2 * H; ea.dst = proj + H; ea.ld_dst = 2 * H;
  ea.row0 = r.row0; ea.S = r.S;
  ea.w1 = w[0]; ea.ld1 = 2 * H + E; ea.b1 = w[1]; ea.w2 = w[2]; ea.b2 = w[3];
  ea.N = N; ea.H = H; ea.E = E; ea.sin_emb = sin_emb;
  ea.norm_constant = norm_constant;
  ea.norm_div = norm_div;
  return ea;
}

// One GCL over slab r (kernel #3 with the full view as the slab, #6 over an
// SP slab): h_out [B*S, H] = (h_r + node_mlp([h_r, agg])) * m_r. w: the GCL's
// 10 weight pointers (egnn_gcl_rows' order). Scratch: proj [B*N, 2H], agg and
// hidden [B*S, H]. Enqueues 5 grids.
template <int kOwner>
int gcl_rows_host(const float* h, const float* x, const float* x0, const float* mask,
                  const Slab& r, float* h_out, float* proj, float* agg, float* hidden,
                  const float* const* w, int B, int N, int H, int E, int attention,
                  int sin_emb, float norm_div, float norm_constant, cudaStream_t s) {
  const int Mr = B * r.S;
  int rc;
  if ((rc = launch_projection_window<kOwner>(r.h, Mr, h, B * N, w[0], 2 * H + E, proj, H, s)))
    return rc;
  EdgeArgs ea = stage_args(r, x, x0, mask, proj, w, N, H, E, sin_emb, norm_div, norm_constant);
  ea.attention = attention;
  ea.w_out = w[4]; ea.b_out = w[5]; ea.agg = agg;
  if ((rc = launch_rows(false, ea, B, s))) return rc;

  GemmArgs n1 = {};
  n1.a1 = r.h; n1.lda1 = H; n1.k1 = H; n1.a2 = agg; n1.lda2 = H;
  n1.w = w[6]; n1.ldw = 2 * H; n1.bias = w[7];
  n1.c = hidden; n1.ldc = H; n1.M = Mr; n1.Nout = H; n1.K = 2 * H;
  n1.epilogue = kEpiSilu;
  if ((rc = launch_gemm<kOwner>(n1, s))) return rc;

  GemmArgs n2 = {};
  n2.a1 = hidden; n2.lda1 = H; n2.k1 = H;
  n2.w = w[8]; n2.ldw = H; n2.bias = w[9];
  n2.resid = r.h; n2.ldr = H; n2.row_mask = r.mask;
  n2.c = h_out; n2.ldc = H; n2.M = Mr; n2.Nout = H; n2.K = H;
  n2.epilogue = kEpiResidMask;
  return launch_gemm<kOwner>(n2, s);
}

// The coordinate update over slab r (#4 / #6): x_out [B*S, 3]. w: 5 weight
// pointers (egnn_coord_rows' order). Scratch: proj [B*N, 2H]. Enqueues 3 grids.
template <int kOwner>
int coord_rows_host(const float* h, const float* x, const float* x0, const float* mask,
                    const Slab& r, float* x_out, float* proj, const float* const* w, int B,
                    int N, int H, int E, int sin_emb, int use_tanh, float coords_range,
                    float norm_div, float norm_constant, cudaStream_t s) {
  int rc;
  if ((rc = launch_projection_window<kOwner>(r.h, B * r.S, h, B * N, w[0], 2 * H + E, proj, H,
                                             s)))
    return rc;
  EdgeArgs ea = stage_args(r, x, x0, mask, proj, w, N, H, E, sin_emb, norm_div, norm_constant);
  ea.use_tanh = use_tanh; ea.coords_range = coords_range;
  ea.w_out = w[4]; ea.x_out = x_out;
  return launch_rows(true, ea, B, s);
}

}  // namespace
