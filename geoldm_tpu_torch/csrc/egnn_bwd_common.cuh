// Device code shared by the EquivariantBlock backward (egnn_block_bwd.cu,
// TPU kernel #2) and the row-tiled stage backward (egnn_rows_bwd.cuh, TPU
// kernels #5 and #7): the deterministic row and column reductions, the
// coordinate pass, the node-MLP backward and the gradients of one edge
// stage's weights and input after its edge-backward grid ran, every product
// on the tensor-core GEMMs of egnn_tc_gemm.cuh. None of it depends on a
// bound on N; all of it reduces in a fixed order without atomics, so a seeded
// run replays bit for bit. BF16 selects the bf16 backward, the vjp of the
// bf16 forward (every product on bf16 operands): each product's cotangent
// stays f32, the gradient of each bf16 operand is rounded to bf16 where the
// product returns it (operand gradients in the GEMM's epilogue, weight
// gradients once after their f32 sum, round_weight_grads), and the
// elementwise passes stay f32. See egnn_block_bwd.cu and egnn_tiled_bwd.cu
// for the designs.

#pragma once

#include "egnn_tc_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// Small node-side passes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dsilu_f(float v) {
  const float s = sigmoid_f(v);
  return s * (1.f + v * (1.f - s));
}

// out[r, c] = in[r, c] * mask[r]
__global__ void rows_mask_kernel(const float* in, const float* mask, float* out, int M, int H) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < M * H) out[idx] = in[idx] * mask[idx / H];
}

// out = dy * silu'(z)
__global__ void dsilu_mul_kernel(const float* dy, const float* z, float* out, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) out[idx] = dy[idx] * dsilu_f(z[idx]);
}

// out[c * ostride] (+)= sum_r in[r * ld + c] for c < ncols. A block takes 32
// columns; its 32 row groups each sum every 32nd row, then one thread per
// column adds the 32 group sums in order (deterministic).
__global__ void __launch_bounds__(1024) reduce_rows_kernel(const float* in, int rows, int ld,
                                                           int ncols, float* out, int ostride,
                                                           int accumulate) {
  __shared__ float part[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < ncols)
    for (int r = threadIdx.y; r < rows; r += 32) s += in[(size_t)r * ld + c];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < ncols) {
    float t = 0.f;
    for (int k = 0; k < 32; ++k) t += part[k][threadIdx.x];
    float* dst = out + (size_t)c * ostride;
    *dst = accumulate ? *dst + t : t;
  }
}

int reduce_rows(const float* in, int rows, int ld, int ncols, float* out, int ostride,
                int accumulate, cudaStream_t s) {
  reduce_rows_kernel<<<(ncols + 31) / 32, dim3(32, 32), 0, s>>>(in, rows, ld, ncols, out,
                                                                 ostride, accumulate);
  return (int)cudaGetLastError();
}

// colsum[b, j, c] = sum over the T tiles (or CTAs) of molecule b of
// colpart[b, t, j, c], in tile order: the dst projection's gradient.
__global__ void column_sum_kernel(const float* colpart, float* colsum, int T, int N, int H) {
  const int bj = blockIdx.x;  // b * N + j
  const int b = bj / N, j = bj % N;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += colpart[(((size_t)b * T + t) * N + j) * H + c];
    colsum[(size_t)bj * H + c] = s;
  }
}

// dx_i = gx_i m_i + sum_j (G_ij - G_ji) with G_ij = dL/d(x_i - x_j) through
// coord_diff (dcd) and the squared distance (dr, plus the norm inside
// coord_diff); dx0_i = sum_j 2 (x0_i - x0_j) (dr0_ij + dr0_ji). COORD false
// is a GCL stage's: no direct x path and no coord_diff (gx and dcd unread).
template <bool COORD>
__global__ void coord_grad_kernel(const float* x, const float* x0, const float* mask,
                                  const float* gx, const float* dcd, const float* dr,
                                  const float* dr0, float* dx, float* dx0, int BN, int N,
                                  float norm_constant) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= BN) return;
  const int b = r / N, i = r % N;
  const float mi = mask[r];
  float gi[3], gi0[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 3; ++q) gi[q] = COORD ? gx[(size_t)r * 3 + q] * mi : 0.f;
  for (int j = 0; j < N; ++j) {
    const size_t rj = (size_t)b * N + j;
    const size_t eij = (size_t)r * N + j, eji = rj * N + i;
    float d[3], d0[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      d[q] = x[(size_t)r * 3 + q] - x[rj * 3 + q];
      d0[q] = x0[(size_t)r * 3 + q] - x0[rj * 3 + q];
    }
    if (COORD) {
      const float rr = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      const float norm = sqrtf(rr + 1e-8f);
      const float cc = norm + norm_constant;
      const float* cij = dcd + eij * 3;
      const float* cji = dcd + eji * 3;
      const float dot_ij = cij[0] * d[0] + cij[1] * d[1] + cij[2] * d[2];
      const float dot_ji = -(cji[0] * d[0] + cji[1] * d[1] + cji[2] * d[2]);
      const float dlr_ij = dr[eij] - dot_ij / (cc * cc) / (2.f * norm);
      const float dlr_ji = dr[eji] - dot_ji / (cc * cc) / (2.f * norm);
      const float s0 = 2.f * (dr0[eij] + dr0[eji]);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float g_ij = cij[q] / cc + 2.f * d[q] * dlr_ij;
        const float g_ji = cji[q] / cc - 2.f * d[q] * dlr_ji;
        gi[q] += g_ij - g_ji;
        gi0[q] += d0[q] * s0;
      }
    } else {
      const float s = 2.f * (dr[eij] + dr[eji]);
      const float s0 = 2.f * (dr0[eij] + dr0[eji]);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        gi[q] += d[q] * s;
        gi0[q] += d0[q] * s0;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    dx[(size_t)r * 3 + q] = gi[q];
    dx0[(size_t)r * 3 + q] = gi0[q];
  }
}

// ---------------------------------------------------------------------------
// Gradients of one stage's weights and input h, after its edge-backward
// grid ran.
// ---------------------------------------------------------------------------

// The edge-sized and per-tile buffers an edge-backward grid fills and
// stage_grads reads: silu(pre) and d(mm) of every edge [Me, H], the row sums
// of d(pre) [B*S, H], its column partials [B, T, N, H] (one row of tiles, or
// CTAs, per molecule), the per-tile partials [B*T, (3 + E) * H] (db2 | dw_out
// | db_out | the edge-feature columns of W1), and the split-K partials of
// the W2 gradient (wsplit) and of the node GEMM (split).
struct EdgeGradBufs {
  float *abuf, *dbuf, *rowsum, *colpart, *colsum, *part, *wsplit;
  SplitBuf split;
};

// S: the rows of each molecule's edge grid (N for the whole-block and the
// single-device row-tiled stages, the slab's rows for an SP stage); T: its
// tiles, or CTAs, per molecule, whose partials the grid wrote.
struct Dims {
  int B, N, H, E, ld1, S, T;
};

// w1 is the stage's first-layer weight, gw1 ... gbo the gradients of its
// first and second layers and of its gate or scale (written, or added to
// when acc). hr: the stage input's rows [B*S, H], whose src projection the
// edge grid read; hc: its columns [B*N, H], the dst projection's input.
// dhr += the gradient through the src half of W1, dhc += that through the
// dst half (the same buffer when hr is hc).
template <bool BF16 = false>
int stage_grads(const Dims& d, const float* hr, const float* hc, const float* w1, float* gw1,
                float* gb1, float* gw2, float* gb2, float* gwo, float* gbo,
                const EdgeGradBufs& sc, float* dhr, float* dhc, int acc, cudaStream_t s) {
  const int Mr = d.B * d.S, Mc = d.B * d.N, H = d.H, Me = Mr * d.N, P = d.B * d.T;
  const int ps = (3 + d.E) * H;
  int rc;
  // W2 (torch [out][in]): dW2[c][k] = sum_e dmm[e][c] silu(pre)[e][k].
  if ((rc = wgrad_tc<BF16>(sc.dbuf, sc.abuf, Me, H, gw2, sc.wsplit, acc, s))) return rc;
  if ((rc = reduce_rows(sc.part, P, ps, H, gb2, 1, acc, s))) return rc;
  if (gwo && (rc = reduce_rows(sc.part + H, P, ps, H, gwo, 1, acc, s))) return rc;
  if (gbo && (rc = reduce_rows(sc.part + 2 * H, P, ps, 1, gbo, 1, acc, s))) return rc;
  // W1: src columns from the row sums, dst columns from the column sums,
  // edge-feature columns from the per-tile partials; b1 from the row sums.
  column_sum_kernel<<<Mc, 256, 0, s>>>(sc.colpart, sc.colsum, d.T, d.N, H);
  if ((rc = (int)cudaGetLastError())) return rc;
  if (Mr == Mc) {  // one grouped launch
    if ((rc = node_gemm_pair<BF16>(sc.rowsum, sc.colsum, H, 1, hr, hc, H, 0, gw1, gw1 + H, d.ld1,
                                   H, H, Mr, acc, acc, sc.split, s)))
      return rc;
  } else {
    if ((rc = node_gemm<BF16>(sc.rowsum, H, 1, hr, H, 0, gw1, d.ld1, H, H, Mr, acc, sc.split, s)))
      return rc;
    if ((rc = node_gemm<BF16>(sc.colsum, H, 1, hc, H, 0, gw1 + H, d.ld1, H, H, Mc, acc, sc.split,
                              s)))
      return rc;
  }
  for (int e = 0; e < d.E; ++e)
    if ((rc = reduce_rows(sc.part + (3 + e) * H, P, ps, H, gw1 + 2 * H + e, d.ld1, acc, s)))
      return rc;
  if ((rc = reduce_rows(sc.rowsum, Mr, H, H, gb1, 1, acc, s))) return rc;
  // dhr += rowsum W1[:, :H]; dhc += colsum W1[:, H:2H] (BF16: each rounded,
  // the gradient of its product's bf16 h).
  if ((rc = node_gemm<BF16>(sc.rowsum, H, 0, w1, d.ld1, 0, dhr, H, Mr, H, H, 1, sc.split, s,
                            BF16)))
    return rc;
  return node_gemm<BF16>(sc.colsum, H, 0, w1 + H, d.ld1, 0, dhc, H, Mc, H, H, 1, sc.split, s,
                         BF16);
}

// Node MLP backward of one GCL, out = (hin + silu([hin, agg] Wn1^T + bn1)
// Wn2^T + bn2) * mask, from the cotangent dout of out and the forward's z =
// [hin, agg] Wn1^T + bn1 and u = silu(z). w / g: the GCL's 10 weight /
// gradient pointers (egnn_block_forward's order); the node-MLP gradients
// g[6..9] are written, or added to when acc. Writes dh = dout * mask + the
// gradient through Wn1's hin columns, and dagg = the gradient of agg; dtmp
// is [M, H] scratch. BF16: d(u), dh's node-MLP share and dagg rounded
// (gradients of bf16 operands), the weight gradients left in f32 for
// round_weight_grads.
template <bool BF16 = false>
int node_mlp_backward(const float* dout, const float* mask, const float* hin, const float* agg,
                      const float* z, const float* u, const float* const* w, float* const* g,
                      float* dtmp, float* dagg, float* dh, int M, int H, int acc,
                      const SplitBuf& sb, cudaStream_t s) {
  const int nblk = (M * H + 255) / 256;
  int rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(dout, mask, dtmp, M, H);  // d(upd)
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = reduce_rows(dtmp, M, H, H, g[9], 1, acc, s))) return rc;
  if ((rc = node_gemm<BF16>(dtmp, H, 1, u, H, 0, g[8], H, H, H, M, acc, sb, s))) return rc;
  if ((rc = node_gemm<BF16>(dtmp, H, 0, w[8], H, 0, dagg, H, M, H, H, 0, sb, s, BF16)))
    return rc;  // d(u), in dagg for now
  dsilu_mul_kernel<<<nblk, 256, 0, s>>>(dagg, z, dtmp, M * H);  // d(z)
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = reduce_rows(dtmp, M, H, H, g[7], 1, acc, s))) return rc;
  if ((rc = node_gemm_pair<BF16>(dtmp, dtmp, H, 1, hin, agg, H, 0, g[6], g[6] + H, 2 * H, H, H,
                                 M, acc, acc, sb, s)))
    return rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(dout, mask, dh, M, H);  // residual path
  if ((rc = (int)cudaGetLastError())) return rc;
  // dh += dtmp Wn1[:, :H], dagg = dtmp Wn1[:, H:2H]: one grouped launch.
  return node_gemm_pair<BF16>(dtmp, dtmp, H, 0, w[6], w[6] + H, 2 * H, 0, dh, dagg, H, M, H, H,
                              1, 0, sb, s, BF16);
}

// The bf16 backward's weight gradients of one stage, rounded to bf16 once
// after their f32 sums over every edge, molecule and group: g holds the
// stage's gradient pointers in the weights' order (10 of a GCL, 5 of the
// coordinate update); the products' weights (W1, W2, the gate's or scale's
// weight, Wn1, Wn2) are rounded, the biases stay f32 (added, not multiplied)
// but with lowp (the low-precision variant of #2): there b2 and the gate's
// bias are cast to bf16 and added in bf16, so theirs are rounded too.
int round_weight_grads(float* const* g, bool coord, int H, int E, cudaStream_t s,
                       bool lowp = false) {
  const int ld1 = 2 * H + E;
  int rc;
  if ((rc = round_bf16(g[0], H * ld1, s))) return rc;
  if ((rc = round_bf16(g[2], H * H, s))) return rc;
  if ((rc = round_bf16(g[4], H, s))) return rc;  // null: a GCL without attention
  if (lowp && (rc = round_bf16(g[3], H, s))) return rc;
  if (lowp && !coord && (rc = round_bf16(g[5], 1, s))) return rc;  // null likewise
  if (coord) return 0;
  if ((rc = round_bf16(g[6], 2 * H * H, s))) return rc;
  return round_bf16(g[8], H * H, s);
}

}  // namespace
