// Device code shared by the EquivariantBlock backward (egnn_block_bwd.cu,
// TPU kernel #2) and the row-tiled stage backward (egnn_rows_bwd.cuh, TPU
// kernels #5 and #7): the split-K weight-gradient GEMM, the deterministic row and
// column reductions, the coordinate pass, the node-MLP backward, the
// gradients of one edge stage's weights, and the per-tile products of the
// edge-backward kernels. None of it depends on a bound on N; all of it
// reduces in a fixed order without atomics, so a seeded run replays bit for
// bit. See egnn_block_bwd.cu for the design.

#pragma once

#include "egnn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Generic tiled GEMM: C(m, n) (+)= sum_k A(m, k) * B(k, n).
//   ta: A is stored [K][M] (A(m, k) = a[k * lda + m]), else [M][K];
//   tb: B is stored [N][K] (B(k, n) = b[n * ldb + k]), else [K][N].
// blockIdx.z splits K; with more than one split each writes its partial
// [M][N] block to c + z * split_stride and splitk_reduce_kernel sums them.
// ---------------------------------------------------------------------------

struct Gemm2Args {
  const float* a; int lda; int ta;
  const float* b; int ldb; int tb;
  float* c; int ldc;
  int M, N, K;
  int accumulate;
  int kchunk;
  size_t split_stride;
};

__global__ void __launch_bounds__(256) gemm_kernel(Gemm2Args g) {
  __shared__ float As[kTK][kTM + 4];
  __shared__ float Bs[kTK][kTN + 4];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int kbeg = blockIdx.z * g.kchunk;
  const int kend = min(g.K, kbeg + g.kchunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kTK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = t + 256 * q;
      {  // A tile, neighbouring threads on neighbouring addresses
        const int r = g.ta ? idx % kTM : idx / kTK;
        const int kk = g.ta ? idx / kTM : idx % kTK;
        const int m = m0 + r, k = k0 + kk;
        float v = 0.f;
        if (m < g.M && k < kend)
          v = g.ta ? g.a[(size_t)k * g.lda + m] : g.a[(size_t)m * g.lda + k];
        As[kk][r] = v;
      }
      {  // B tile
        const int r = g.tb ? idx / kTK : idx % kTN;
        const int kk = g.tb ? idx % kTK : idx / kTN;
        const int n = n0 + r, k = k0 + kk;
        float v = 0.f;
        if (n < g.N && k < kend)
          v = g.tb ? g.b[(size_t)n * g.ldb + k] : g.b[(size_t)k * g.ldb + n];
        Bs[kk][r] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* c = g.c + blockIdx.z * g.split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      float* dst = c + (size_t)m * g.ldc + n;
      *dst = g.accumulate ? *dst + acc[i][j] : acc[i][j];
    }
  }
}

// c[m, n] (+)= sum_z buf[z][m][n], summed in split order.
__global__ void splitk_reduce_kernel(const float* buf, int splits, int M, int N, float* c,
                                     int ldc, int accumulate) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * N) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += buf[(size_t)z * M * N + idx];
  float* dst = c + (size_t)(idx / N) * ldc + idx % N;
  *dst = accumulate ? *dst + s : s;
}

constexpr int kMaxSplits = 32;

struct SplitBuf {
  float* buf;
  size_t cap;  // floats
};

// Split K when the output has few tiles and K is long (the weight gradients:
// a 256x256 output has 16 tiles), so that the grid fills the card.
int gemm(const float* a, int lda, int ta, const float* b, int ldb, int tb, float* c, int ldc,
         int M, int N, int K, int accumulate, const SplitBuf& sb, cudaStream_t s) {
  const int tiles = ((M + kTM - 1) / kTM) * ((N + kTN - 1) / kTN);
  int splits = 1;
  if (tiles < 128 && K >= 512) {
    splits = (K + 255) / 256;
    if (splits > kMaxSplits) splits = kMaxSplits;
    if ((size_t)splits * M * N > sb.cap) splits = 1;
  }
  int kchunk = (K + splits - 1) / splits;
  kchunk = (kchunk + kTK - 1) / kTK * kTK;
  splits = (K + kchunk - 1) / kchunk;
  Gemm2Args g = {};
  g.a = a; g.lda = lda; g.ta = ta;
  g.b = b; g.ldb = ldb; g.tb = tb;
  g.M = M; g.N = N; g.K = K; g.kchunk = kchunk;
  dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM, splits);
  if (splits == 1) {
    g.c = c; g.ldc = ldc; g.accumulate = accumulate; g.split_stride = 0;
    gemm_kernel<<<grid, 256, 0, s>>>(g);
    return (int)cudaGetLastError();
  }
  g.c = sb.buf; g.ldc = N; g.accumulate = 0; g.split_stride = (size_t)M * N;
  gemm_kernel<<<grid, 256, 0, s>>>(g);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  splitk_reduce_kernel<<<(M * N + 255) / 256, 256, 0, s>>>(sb.buf, splits, M, N, c, ldc,
                                                           accumulate);
  return (int)cudaGetLastError();
}

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

__global__ void silu_kernel(const float* in, float* out, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) out[idx] = silu_f(in[idx]);
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

// colsum[b, j, c] = sum_i pbuf[b, i, j, c] over the S rows of each
// molecule's edge grid [S, N]: the dst projection's gradient.
__global__ void column_sum_kernel(const float* pbuf, float* colsum, int S, int N, int H) {
  const int bj = blockIdx.x;  // b * N + j
  const int b = bj / N, j = bj % N;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < S; ++i) s += pbuf[(((size_t)b * S + i) * N + j) * H + c];
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
// Edge-stage backward pieces of the row-tiled kernels: one CTA per
// (molecule b, row i), blockDim.x == H (see egnn_rows_bwd.cuh:rows_bwd_kernel).
// ---------------------------------------------------------------------------

struct EdgeBwdArgs {
  const float* proj;  // [B*N, 2H] src | dst projections of the stage input
  const float* x;
  const float* x0;
  const float* mask;
  const float* w1; int ld1;
  const float* b1;
  const float* w2; const float* b2;
  const float* w_out;  // GCL: att_mlp.0.weight; coord: coord_mlp.4.weight
  const float* b_out;  // GCL: att_mlp.0.bias
  const float* dagg;   // GCL: [B*N, H] gradient of the aggregate
  const float* gx;     // coord: [B*N, 3] gradient of x_out
  float* abuf;         // [B*N*N, H] silu(pre)
  float* dbuf;         // [B*N*N, H] gradient of the second layer's pre-activation
  float* pbuf;         // [B*N*N, H] gradient of the first layer's pre-activation
  float* rowsum;       // [B*N, H] sum_j pbuf[b, i, j]
  float* part;         // [B*N, (3 + E) * H] per-CTA partials: db2 | dw_out | db_out | dWe
  float* dr;           // [B*N*N] gradient of the squared distance (not sin)
  float* dr0;          // [B*N*N] gradient of the initial squared distance (not sin)
  float* dcd;          // [B*N*N, 3] coord stage: gradient of coord_diff
  int N, H, E;
  int sin_emb, attention, use_tanh;
  float coords_range, norm_constant, norm_div;
  // Row-tiled backward only: the row window, as in TileArgs (egnn_tile.cuh);
  // dagg, gx, rowsum and part are then [B*S, *] and the edge buffers
  // [B*S*N, *].
  const float* xr; const float* x0r; const float* maskr;
  const float* src; int ld_src;
  const float* dst; int ld_dst;
  int row0, S;
};

// Shared memory of an edge-backward CTA holding nmax columns at a time.
size_t edge_bwd_smem_bytes(int nmax, int H) {
  const int nwarp = H / 32;
  return sizeof(float) * ((size_t)nmax * H + (size_t)kKChunk * (H + 1) +
                          (size_t)nmax * kMaxEdgeFeat + nmax + (size_t)nmax * 3 +
                          2 * (size_t)nwarp * nmax + 2 * (size_t)nmax);
}

// acc[j] += sum_k As[j][k] * W(c, k) with W(c, k) = w[c * H + k] (the
// forward product) or, TRANSPOSED, w[k * H + c]; W streamed in K chunks.
template <int NMAX, bool TRANSPOSED>
__device__ __forceinline__ void row_tile_product(const float* As, float* Ws, const float* w,
                                                 int H, int c, float* acc) {
  for (int k0 = 0; k0 < H; k0 += kKChunk) {
    for (int idx = c; idx < H * kKChunk; idx += H) {
      if (TRANSPOSED) {
        const int kk = idx / H, col = idx % H;
        Ws[kk * (H + 1) + col] = w[(size_t)(k0 + kk) * H + col];
      } else {
        const int row = idx / kKChunk, kk = idx % kKChunk;
        Ws[kk * (H + 1) + row] = w[(size_t)row * H + k0 + kk];
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kKChunk; kk += 4) {
      const float w0 = Ws[(kk + 0) * (H + 1) + c];
      const float w1 = Ws[(kk + 1) * (H + 1) + c];
      const float w2 = Ws[(kk + 2) * (H + 1) + c];
      const float w3 = Ws[(kk + 3) * (H + 1) + c];
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        const float4 av = *reinterpret_cast<const float4*>(As + j * H + k0 + kk);
        acc[j] = fmaf(av.x, w0, acc[j]);
        acc[j] = fmaf(av.y, w1, acc[j]);
        acc[j] = fmaf(av.z, w2, acc[j]);
        acc[j] = fmaf(av.w, w3, acc[j]);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Gradients of one stage's weights and input h, after its edge-backward
// kernel ran.
// ---------------------------------------------------------------------------

// The edge-sized and per-row buffers an edge-backward kernel fills and
// stage_grads reads.
struct EdgeGradBufs {
  float *abuf, *dbuf, *pbuf, *rowsum, *colsum, *part;
  SplitBuf split;
};

// S: the rows of each molecule's edge grid (N for the whole-block and the
// single-device row-tiled stages, the slab's rows for an SP stage).
struct Dims {
  int B, N, H, E, ld1;
  float norm_div;
  int S;
};

// w1 is the stage's first-layer weight, gw1 ... gbo the gradients of its
// first and second layers and of its gate or scale (written, or added to
// when acc). hr: the stage input's rows [B*S, H], whose src projection the
// edge grid read; hc: its columns [B*N, H], the dst projection's input.
// dhr += the gradient through the src half of W1, dhc += that through the
// dst half (the same buffer when hr is hc).
int stage_grads_window(const Dims& d, const float* hr, const float* hc, const float* w1,
                       float* gw1, float* gb1, float* gw2, float* gb2, float* gwo, float* gbo,
                       const EdgeGradBufs& sc, float* dhr, float* dhc, int acc, cudaStream_t s) {
  const int Mr = d.B * d.S, Mc = d.B * d.N, H = d.H, Me = Mr * d.N;
  const int ps = (3 + d.E) * H;
  int rc;
  // W2 (torch [out][in]): dW2[c][k] = sum_e dmm[e][c] silu(pre)[e][k].
  if ((rc = gemm(sc.dbuf, H, 1, sc.abuf, H, 0, gw2, H, H, H, Me, acc, sc.split, s))) return rc;
  if ((rc = reduce_rows(sc.part, Mr, ps, H, gb2, 1, acc, s))) return rc;
  if (gwo && (rc = reduce_rows(sc.part + H, Mr, ps, H, gwo, 1, acc, s))) return rc;
  if (gbo && (rc = reduce_rows(sc.part + 2 * H, Mr, ps, 1, gbo, 1, acc, s))) return rc;
  // W1: src columns from the row sums, dst columns from the column sums,
  // edge-feature columns from the per-CTA partials; b1 from the row sums.
  column_sum_kernel<<<Mc, H, 0, s>>>(sc.pbuf, sc.colsum, d.S, d.N, H);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = gemm(sc.rowsum, H, 1, hr, H, 0, gw1, d.ld1, H, H, Mr, acc, sc.split, s))) return rc;
  if ((rc = gemm(sc.colsum, H, 1, hc, H, 0, gw1 + H, d.ld1, H, H, Mc, acc, sc.split, s)))
    return rc;
  for (int e = 0; e < d.E; ++e)
    if ((rc = reduce_rows(sc.part + (3 + e) * H, Mr, ps, H, gw1 + 2 * H + e, d.ld1, acc, s)))
      return rc;
  if ((rc = reduce_rows(sc.rowsum, Mr, H, H, gb1, 1, acc, s))) return rc;
  // dhr += rowsum W1[:, :H]; dhc += colsum W1[:, H:2H].
  if ((rc = gemm(sc.rowsum, H, 0, w1, d.ld1, 0, dhr, H, Mr, H, H, 1, sc.split, s)))
    return rc;
  return gemm(sc.colsum, H, 0, w1 + H, d.ld1, 0, dhc, H, Mc, H, H, 1, sc.split, s);
}

// Every row against every column (d.S == d.N): dh_acc gets both halves.
int stage_grads(const Dims& d, const float* hin, const float* w1, float* gw1, float* gb1,
                float* gw2, float* gb2, float* gwo, float* gbo, const EdgeGradBufs& sc,
                float* dh_acc, int acc, cudaStream_t s) {
  return stage_grads_window(d, hin, hin, w1, gw1, gb1, gw2, gb2, gwo, gbo, sc, dh_acc, dh_acc,
                            acc, s);
}

// Node MLP backward of one GCL, out = (hin + silu([hin, agg] Wn1^T + bn1)
// Wn2^T + bn2) * mask, from the cotangent dout of out and the forward's z =
// [hin, agg] Wn1^T + bn1 and u = silu(z). w / g: the GCL's 10 weight /
// gradient pointers (egnn_block_forward's order); the node-MLP gradients
// g[6..9] are written, or added to when acc. Writes dh = dout * mask + the
// gradient through Wn1's hin columns, and dagg = the gradient of agg; dtmp
// is [M, H] scratch.
int node_mlp_backward(const float* dout, const float* mask, const float* hin, const float* agg,
                      const float* z, const float* u, const float* const* w, float* const* g,
                      float* dtmp, float* dagg, float* dh, int M, int H, int acc,
                      const SplitBuf& sb, cudaStream_t s) {
  const int nblk = (M * H + 255) / 256;
  int rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(dout, mask, dtmp, M, H);  // d(upd)
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = reduce_rows(dtmp, M, H, H, g[9], 1, acc, s))) return rc;
  if ((rc = gemm(dtmp, H, 1, u, H, 0, g[8], H, H, H, M, acc, sb, s))) return rc;
  if ((rc = gemm(dtmp, H, 0, w[8], H, 0, dagg, H, M, H, H, 0, sb, s)))
    return rc;  // d(u), in dagg for now
  dsilu_mul_kernel<<<nblk, 256, 0, s>>>(dagg, z, dtmp, M * H);  // d(z)
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = reduce_rows(dtmp, M, H, H, g[7], 1, acc, s))) return rc;
  if ((rc = gemm(dtmp, H, 1, hin, H, 0, g[6], 2 * H, H, H, M, acc, sb, s))) return rc;
  if ((rc = gemm(dtmp, H, 1, agg, H, 0, g[6] + H, 2 * H, H, H, M, acc, sb, s))) return rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(dout, mask, dh, M, H);  // residual path
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = gemm(dtmp, H, 0, w[6], 2 * H, 0, dh, H, M, H, H, 1, sb, s))) return rc;
  return gemm(dtmp, H, 0, w[6] + H, 2 * H, 0, dagg, H, M, H, H, 0, sb, s);
}

}  // namespace
