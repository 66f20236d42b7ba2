// One EGNN EquivariantBlock backward in f32 on Hopper (sm_90a).
//
// Replaces the TPU kernel geoldm_tpu/ops/pallas_egnn.py:_make_bwd_kernel
// (pallas_call at :507, via _fused_block_bwd_impl :485). Same function: from
// the block inputs (h, x, x0, node mask), the weights and the cotangents of
// (h_out, x_out) it recomputes the forward and returns dh, dx, the exact dx0
// and every weight gradient summed over the batch. As in _sin_features
// (:96-105) the sin/cos distance features carry no gradient.
//
// Design. The Pallas kernel differentiates the whole block in VMEM with an
// in-kernel jax.vjp and accumulates weight gradients across a sequential
// grid. A CUDA grid runs in parallel, so this version splits the work into
// stages that each own their outputs, and reduces across CTAs in separate,
// deterministic passes (no atomics: a seeded run replays bit for bit):
//   1. forward recompute of the node-level chain (the forward's node GEMM and edge
//      kernel), keeping each GCL's input h, aggregate, node-MLP
//      pre-activation and silu output ([B*N, H] each);
//   2. per edge stage, in reverse (coordinate update, then GCL n-1 ... 0), an
//      edge-backward kernel with one CTA per (molecule b, row i) and one
//      thread per hidden channel. It rebuilds row i's silu(pre) tile in shared
//      memory, recomputes the second layer, back-propagates through the
//      attention gate / coordinate scale, and runs the transposed W2 product
//      on its own row. Row sums (dst of the src projection, db1), per-CTA
//      partials (db2, the gate/coordinate weight, the edge-feature columns of
//      W1) and the distance-feature gradients of row i are written by the CTA
//      that owns them;
//   3. the terms that cross rows run as their own passes: a column sum of
//      d(pre) over i for the dst projection, hand-written tiled GEMMs for the
//      weight gradients (split over K with a summing pass where the output is
//      only 256x256) and the node-side products, and a coordinate pass that
//      turns the antisymmetric pair gradients into dx_i = sum_j (G_ij - G_ji)
//      and dx0 likewise.
//
// Memory: this first version writes three edge-sized activations to device
// memory per stage (silu(pre), d(mm) for the W2 gradient, d(pre) for the
// column sum): 3 * B*N*N*H*4 bytes, 3 x 55 MB at B=64, N=29, H=256, reused
// from stage to stage. The autograd Function saves only the block inputs.
//
// What bounds it on an H100: per edge stage about 6*N^2*H^2 FLOP per
// molecule (recompute, the transposed product and the W2 gradient), all f32
// FMA outside the tensor cores, against a few hundred MB of edge traffic: it
// is bound by operations, like the forward.

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

// out[c * ostride] = sum_r in[r * ld + c] for c < ncols. A block takes 32
// columns; its 32 row groups each sum every 32nd row, then one thread per
// column adds the 32 group sums in order (deterministic).
__global__ void __launch_bounds__(1024) reduce_rows_kernel(const float* in, int rows, int ld,
                                                           int ncols, float* out, int ostride) {
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
    out[(size_t)c * ostride] = t;
  }
}

int reduce_rows(const float* in, int rows, int ld, int ncols, float* out, int ostride,
                cudaStream_t s) {
  reduce_rows_kernel<<<(ncols + 31) / 32, dim3(32, 32), 0, s>>>(in, rows, ld, ncols, out,
                                                                 ostride);
  return (int)cudaGetLastError();
}

// colsum[b, j, c] = sum_i pbuf[b, i, j, c]: the dst projection's gradient.
__global__ void column_sum_kernel(const float* pbuf, float* colsum, int N, int H) {
  const int bj = blockIdx.x;  // b * N + j
  const int b = bj / N, j = bj % N;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < N; ++i) s += pbuf[(((size_t)b * N + i) * N + j) * H + c];
    colsum[(size_t)bj * H + c] = s;
  }
}

// dx_i = gx_i m_i + sum_j (G_ij - G_ji) with G_ij = dL/d(x_i - x_j) through
// coord_diff (dcd) and the squared distance (dr, plus the norm inside
// coord_diff); dx0_i = sum_j 2 (x0_i - x0_j) (dr0_ij + dr0_ji).
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
  for (int q = 0; q < 3; ++q) gi[q] = gx[(size_t)r * 3 + q] * mi;
  for (int j = 0; j < N; ++j) {
    const size_t rj = (size_t)b * N + j;
    const size_t eij = (size_t)r * N + j, eji = rj * N + i;
    float d[3], d0[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      d[q] = x[(size_t)r * 3 + q] - x[rj * 3 + q];
      d0[q] = x0[(size_t)r * 3 + q] - x0[rj * 3 + q];
    }
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
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    dx[(size_t)r * 3 + q] = gi[q];
    dx0[(size_t)r * 3 + q] = gi0[q];
  }
}

// ---------------------------------------------------------------------------
// Edge-stage backward: one CTA per (molecule b, row i), blockDim.x == H.
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
  float* dr;           // [B*N*N] += gradient of the squared distance (not sin)
  float* dr0;          // [B*N*N] += gradient of the initial squared distance (not sin)
  float* dcd;          // [B*N*N, 3] coord stage: gradient of coord_diff
  int N, H, E;
  int sin_emb, attention, use_tanh;
  float coords_range, norm_constant, norm_div;
};

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

template <int NMAX, bool COORD>
__global__ void __launch_bounds__(kMaxHidden, 1) edge_bwd_kernel(EdgeBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, N = a.N, E = a.E;
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5, nwarp = H >> 5;
  const int b = blockIdx.y, i = blockIdx.x;
  const size_t row_i = (size_t)b * N + i;
  const size_t edge0 = row_i * N;  // edge index of (b, i, j) is edge0 + j

  float* As = smem;                          // [NMAX][H] silu(pre), then d(mm), then d(pre)
  float* Ws = As + NMAX * H;                 // [kKChunk][H + 1] W2 chunk
  float* ef = Ws + kKChunk * (H + 1);        // [NMAX][kMaxEdgeFeat]
  float* em = ef + NMAX * kMaxEdgeFeat;      // [NMAX] edge mask of row i
  float* cd = em + NMAX;                     // [NMAX][3] coord_diff
  float* red = cd + NMAX * 3;                // [nwarp][NMAX]
  float* red2 = red + nwarp * NMAX;          // [nwarp][NMAX]
  float* rs = red2 + nwarp * NMAX;           // [NMAX] per-edge scalars
  float* rs2 = rs + NMAX;                    // [NMAX]

  // 1. Edge features, edge mask and coord_diff of row i (as the forward).
  const float mi = a.mask[row_i];
  for (int j = c; j < NMAX; j += H) {
    float* f = ef + j * kMaxEdgeFeat;
#pragma unroll
    for (int e = 0; e < kMaxEdgeFeat; ++e) f[e] = 0.f;
    em[j] = 0.f;
    cd[j * 3 + 0] = cd[j * 3 + 1] = cd[j * 3 + 2] = 0.f;
    if (j >= N) continue;
    const size_t rj = (size_t)b * N + j;
    float d[3], d0[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      d[q] = a.x[row_i * 3 + q] - a.x[rj * 3 + q];
      d0[q] = a.x0[row_i * 3 + q] - a.x0[rj * 3 + q];
    }
    const float r = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float r0 = d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2];
    const float norm = sqrtf(r + 1e-8f);
#pragma unroll
    for (int q = 0; q < 3; ++q) cd[j * 3 + q] = d[q] / (norm + a.norm_constant);
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
    em[j] = j == i ? 0.f : mi * a.mask[rj];
  }
  __syncthreads();

  // 2. Row i's silu(pre) tile, also written out for the W2 gradient.
  const float src = a.proj[row_i * 2 * H + c];
  const float bias1 = a.b1[c];
  float we[kMaxEdgeFeat];
#pragma unroll
  for (int e = 0; e < kMaxEdgeFeat; ++e)
    we[e] = e < E ? a.w1[(size_t)c * a.ld1 + 2 * H + e] : 0.f;
  for (int j = 0; j < NMAX; ++j) {
    float v = 0.f;
    if (j < N) {
      const float dst = a.proj[((size_t)b * N + j) * 2 * H + H + c];
      float ew = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxEdgeFeat; ++e) ew = fmaf(ef[j * kMaxEdgeFeat + e], we[e], ew);
      v = silu_f(src + dst + ew + bias1);
      a.abuf[(edge0 + j) * H + c] = v;
    }
    As[j * H + c] = v;
  }
  __syncthreads();

  // 3. Second layer: acc[j] = mm_j[c] - b2[c].
  float acc[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) acc[j] = 0.f;
  row_tile_product<NMAX, false>(As, Ws, a.w2, H, c, acc);
  const float bias2 = a.b2[c];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) acc[j] += bias2;  // mm_j[c]

  // 4. Per-edge scalars: the gate / coordinate logit sum_c m_j[c] w_out[c]
  //    and, for the gate, sum_c d(m'_j)[c] m_j[c].
  const float wo = (COORD || a.attention) ? a.w_out[c] : 0.f;
  const float dagg = COORD ? 0.f : a.dagg[row_i * H + c] / a.norm_div;
  if (COORD || a.attention) {
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      const float m = silu_f(acc[j]);
      float p = m * wo, p2 = m * dagg;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, o);
        p2 += __shfl_xor_sync(0xffffffffu, p2, o);
      }
      if (lane == 0) {
        red[warp * NMAX + j] = p;
        red2[warp * NMAX + j] = p2;
      }
    }
    __syncthreads();
    float daggx[3] = {0.f, 0.f, 0.f};
    if (COORD) {
#pragma unroll
      for (int q = 0; q < 3; ++q) daggx[q] = a.gx[row_i * 3 + q] * mi / a.norm_div;
    }
    for (int j = c; j < NMAX; j += H) {
      float s = 0.f, s2 = 0.f;
      for (int w = 0; w < nwarp; ++w) {
        s += red[w * NMAX + j];
        s2 += red2[w * NMAX + j];
      }
      if (COORD) {
        // s_ij = tanh(l) * range; ds_ij = em (daggx . cd); dcd = daggx s em.
        const float th = tanhf(s);
        const float scale = a.use_tanh ? th * a.coords_range : s;
        const float dotc = daggx[0] * cd[j * 3] + daggx[1] * cd[j * 3 + 1] +
                           daggx[2] * cd[j * 3 + 2];
        const float ds = em[j] * dotc;
        if (j < N) {
#pragma unroll
          for (int q = 0; q < 3; ++q) a.dcd[(edge0 + j) * 3 + q] = daggx[q] * scale * em[j];
        }
        rs2[j] = a.use_tanh ? ds * a.coords_range * (1.f - th * th) : ds;
      } else {
        // gate g = sigmoid(l + ba); q = g (1 - g) em (dagg . m).
        const float g = sigmoid_f(s + a.b_out[0]);
        rs[j] = g;
        rs2[j] = g * (1.f - g) * em[j] * s2;
      }
    }
    __syncthreads();
  }

  // 5. d(mm_j)[c] into As (the silu(pre) tile is no longer read) and out.
  float db2 = 0.f, dwo = 0.f, dbo = 0.f;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    const float mm = acc[j];
    const float m = silu_f(mm);
    float dm;
    if (COORD) {
      dm = rs2[j] * wo;
      dwo = fmaf(rs2[j], m, dwo);
    } else if (a.attention) {
      dm = dagg * em[j] * rs[j] + rs2[j] * wo;
      dwo = fmaf(rs2[j], m, dwo);
      dbo += rs2[j];
    } else {
      dm = dagg * em[j];
    }
    const float dmm = dm * dsilu_f(mm);
    db2 += dmm;
    As[j * H + c] = dmm;
    if (j < N) a.dbuf[(edge0 + j) * H + c] = dmm;
  }
  const int ps = (3 + E) * H;
  a.part[row_i * ps + c] = db2;
  a.part[row_i * ps + H + c] = dwo;
  a.part[row_i * ps + 2 * H + c] = c == 0 ? dbo : 0.f;
  __syncthreads();

  // 6. d(silu(pre_j))[c] = sum_k d(mm_j)[k] W2[k][c].
#pragma unroll
  for (int j = 0; j < NMAX; ++j) acc[j] = 0.f;
  row_tile_product<NMAX, true>(As, Ws, a.w2, H, c, acc);

  // 7. d(pre_j)[c]: into As, pbuf and the row sum.
  float rsum = 0.f;
  for (int j = 0; j < NMAX; ++j) {
    float dp = 0.f;
    if (j < N) {
      const float dst = a.proj[((size_t)b * N + j) * 2 * H + H + c];
      float ew = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxEdgeFeat; ++e) ew = fmaf(ef[j * kMaxEdgeFeat + e], we[e], ew);
      dp = acc[j] * dsilu_f(src + dst + ew + bias1);
      a.pbuf[(edge0 + j) * H + c] = dp;
    }
    As[j * H + c] = dp;
    rsum += dp;
  }
  a.rowsum[row_i * H + c] = rsum;
  __syncthreads();

  // 8. Edge-feature columns of W1: dWe[e][c] = sum_j ef[j][e] d(pre_j)[c].
  for (int e = 0; e < E; ++e) {
    float s = 0.f;
    for (int j = 0; j < N; ++j) s = fmaf(ef[j * kMaxEdgeFeat + e], As[j * H + c], s);
    a.part[row_i * ps + (3 + e) * H + c] = s;
  }

  // 9. Squared-distance features (not sin, whose features carry no
  //    gradient): dr_ij += sum_c d(pre_j)[c] We[c][0], dr0 with We[c][1].
  if (!a.sin_emb) {
    for (int j = 0; j < N; ++j) {
      const float dp = As[j * H + c];
      float p = dp * we[0], p0 = dp * we[1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, o);
        p0 += __shfl_xor_sync(0xffffffffu, p0, o);
      }
      if (lane == 0) {
        red[warp * NMAX + j] = p;
        red2[warp * NMAX + j] = p0;
      }
    }
    __syncthreads();
    for (int j = c; j < N; j += H) {
      float s = 0.f, s0 = 0.f;
      for (int w = 0; w < nwarp; ++w) {
        s += red[w * NMAX + j];
        s0 += red2[w * NMAX + j];
      }
      a.dr[edge0 + j] += s;
      a.dr0[edge0 + j] += s0;
    }
  }
}

template <int NMAX, bool COORD>
int launch_edge_bwd_n(const EdgeBwdArgs& a, int B, cudaStream_t s) {
  const size_t smem = edge_bwd_smem_bytes(NMAX, a.H);
  cudaError_t e = cudaFuncSetAttribute(edge_bwd_kernel<NMAX, COORD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  edge_bwd_kernel<NMAX, COORD><<<dim3(a.N, B), a.H, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool COORD>
int launch_edge_bwd(const EdgeBwdArgs& a, int B, cudaStream_t s) {
  if (a.N <= 16) return launch_edge_bwd_n<16, COORD>(a, B, s);
  if (a.N <= 24) return launch_edge_bwd_n<24, COORD>(a, B, s);
  if (a.N <= 32) return launch_edge_bwd_n<32, COORD>(a, B, s);
  return launch_edge_bwd_n<kMaxNodes, COORD>(a, B, s);
}

// Scratch layout, in floats (M = B*N node rows, Me = B*N*N edge rows).
struct Scratch {
  float *hs, *aggs, *zs, *us, *proj, *abuf, *dbuf, *pbuf, *rowsum, *colsum, *dcur, *dnext,
      *dagg, *dtmp, *part, *dr, *dr0, *dcd;
  SplitBuf split;
};

size_t scratch_layout(int B, int N, int H, int E, int n_gcl, float* base, Scratch* s) {
  const size_t M = (size_t)B * N, Me = M * N;
  const size_t sizes[] = {
      n_gcl * M * H, n_gcl * M * H, n_gcl * M * H, n_gcl * M * H, M * 2 * H,
      Me * H, Me * H, Me * H, M * H, M * H, M * H, M * H, M * H, M * H,
      M * (3 + E) * H, Me, Me, Me * 3, (size_t)kMaxSplits * H * H};
  float** ptrs[] = {&s->hs, &s->aggs, &s->zs, &s->us, &s->proj, &s->abuf, &s->dbuf,
                    &s->pbuf, &s->rowsum, &s->colsum, &s->dcur, &s->dnext, &s->dagg,
                    &s->dtmp, &s->part, &s->dr, &s->dr0, &s->dcd, &s->split.buf};
  s->split.cap = sizes[sizeof(sizes) / sizeof(sizes[0]) - 1];
  size_t off = 0;
  for (int k = 0; k < (int)(sizeof(sizes) / sizeof(sizes[0])); ++k) {
    if (base) *ptrs[k] = base + off;
    off += (sizes[k] + 63) / 64 * 64;  // 256-byte aligned pieces
  }
  return off;
}

struct Dims {
  int B, N, H, E, ld1;
  float norm_div;
};

// Gradients of one edge stage's weights and of its input h, after its edge
// backward kernel ran: w1 is the stage's first-layer weight, gw1 ... gbo the
// gradients of its first and second layers and of its gate or scale.
int stage_grads(const Dims& d, const float* hin, const float* w1, float* gw1, float* gb1,
                float* gw2, float* gb2, float* gwo, float* gbo, const Scratch& sc,
                float* dh_acc, cudaStream_t s) {
  const int M = d.B * d.N, H = d.H, Me = M * d.N;
  const int ps = (3 + d.E) * H;
  int rc;
  // W2 (torch [out][in]): dW2[c][k] = sum_e dmm[e][c] silu(pre)[e][k].
  if ((rc = gemm(sc.dbuf, H, 1, sc.abuf, H, 0, gw2, H, H, H, Me, 0, sc.split, s))) return rc;
  if ((rc = reduce_rows(sc.part, M, ps, H, gb2, 1, s))) return rc;
  if (gwo && (rc = reduce_rows(sc.part + H, M, ps, H, gwo, 1, s))) return rc;
  if (gbo && (rc = reduce_rows(sc.part + 2 * H, M, ps, 1, gbo, 1, s))) return rc;
  // W1: src columns from the row sums, dst columns from the column sums,
  // edge-feature columns from the per-CTA partials; b1 from the row sums.
  column_sum_kernel<<<M, H, 0, s>>>(sc.pbuf, sc.colsum, d.N, H);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = gemm(sc.rowsum, H, 1, hin, H, 0, gw1, d.ld1, H, H, M, 0, sc.split, s))) return rc;
  if ((rc = gemm(sc.colsum, H, 1, hin, H, 0, gw1 + H, d.ld1, H, H, M, 0, sc.split, s)))
    return rc;
  for (int e = 0; e < d.E; ++e)
    if ((rc = reduce_rows(sc.part + (3 + e) * H, M, ps, H, gw1 + 2 * H + e, d.ld1, s)))
      return rc;
  if ((rc = reduce_rows(sc.rowsum, M, H, H, gb1, 1, s))) return rc;
  // dh += rowsum W1[:, :H] + colsum W1[:, H:2H].
  if ((rc = gemm(sc.rowsum, H, 0, w1, d.ld1, 0, dh_acc, H, M, H, H, 1, sc.split, s)))
    return rc;
  return gemm(sc.colsum, H, 0, w1 + H, d.ld1, 0, dh_acc, H, M, H, H, 1, sc.split, s);
}

}  // namespace

extern "C" {

const char* egnn_block_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of device scratch egnn_block_backward needs for these shapes.
size_t egnn_block_backward_scratch_floats(int B, int N, int H, int E, int n_gcl) {
  Scratch s;
  return scratch_layout(B, N, H, E, n_gcl, nullptr, &s);
}

// gcl_w / coord_w: weight pointers in egnn_block_forward's order; gcl_g /
// coord_g: gradient outputs in the same order (att_mlp entries null without
// attention); every gradient is overwritten. scratch: a device buffer of
// egnn_block_backward_scratch_floats floats. Returns a cudaError_t value.
int egnn_block_backward(const float* h, const float* x, const float* x0, const float* mask,
                        const float* gh, const float* gx, float* dh, float* dx, float* dx0,
                        const void* const* gcl_w, const void* const* coord_w,
                        void* const* gcl_g, void* const* coord_g, float* scratch, int B,
                        int N, int H, int E, int n_gcl, int attention, int sin_emb,
                        int use_tanh, int mean_agg, float coords_range, float norm_constant,
                        float normalization_factor, void* stream) {
  if (B < 1 || N < 1 || N > kMaxNodes || H < 32 || H > kMaxHidden || H % 32 ||
      E < 2 || E > kMaxEdgeFeat || n_gcl < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Scratch sc;
  scratch_layout(B, N, H, E, n_gcl, scratch, &sc);
  const int M = B * N;
  const size_t Me = (size_t)M * N;
  Dims d = {B, N, H, E, 2 * H + E, mean_agg ? (float)N : normalization_factor};
  const int nblk = (M * H + 255) / 256;
  int rc;
  cudaError_t ce;
  if ((ce = cudaMemsetAsync(sc.dr, 0, Me * sizeof(float), s))) return (int)ce;
  if ((ce = cudaMemsetAsync(sc.dr0, 0, Me * sizeof(float), s))) return (int)ce;
  if ((ce = cudaMemsetAsync(sc.dcd, 0, Me * 3 * sizeof(float), s))) return (int)ce;

  // 1. Forward recompute of the node-level chain.
  EdgeArgs ea = {};
  ea.x = x; ea.x0 = x0; ea.mask = mask; ea.proj = sc.proj;
  ea.ld1 = d.ld1; ea.N = N; ea.H = H; ea.E = E;
  ea.sin_emb = sin_emb; ea.attention = attention; ea.use_tanh = use_tanh;
  ea.coords_range = coords_range; ea.norm_constant = norm_constant; ea.norm_div = d.norm_div;
  const float* const* gw = reinterpret_cast<const float* const*>(gcl_w);
  const float* hc = h;
  for (int gi = 0; gi < n_gcl; ++gi) {
    const float* const* w = gw + 10 * gi;
    float* agg = sc.aggs + (size_t)gi * M * H;
    float* z = sc.zs + (size_t)gi * M * H;
    float* u = sc.us + (size_t)gi * M * H;
    float* hn = sc.hs + (size_t)gi * M * H;
    if ((rc = launch_projection(hc, w[0], d.ld1, sc.proj, M, H, s))) return rc;
    ea.w1 = w[0]; ea.b1 = w[1]; ea.w2 = w[2]; ea.b2 = w[3];
    ea.w_out = w[4]; ea.b_out = w[5]; ea.agg = agg; ea.x_out = nullptr;
    if ((rc = launch_edge<false>(ea, B, s))) return rc;
    GemmArgs n1 = {};
    n1.a1 = hc; n1.lda1 = H; n1.k1 = H; n1.a2 = agg; n1.lda2 = H;
    n1.w = w[6]; n1.ldw = 2 * H; n1.bias = w[7];
    n1.c = z; n1.ldc = H; n1.M = M; n1.Nout = H; n1.K = 2 * H;
    n1.epilogue = kEpiNone;
    if ((rc = launch_gemm(n1, s))) return rc;
    silu_kernel<<<nblk, 256, 0, s>>>(z, u, M * H);
    if ((rc = (int)cudaGetLastError())) return rc;
    GemmArgs n2 = {};
    n2.a1 = u; n2.lda1 = H; n2.k1 = H;
    n2.w = w[8]; n2.ldw = H; n2.bias = w[9];
    n2.resid = hc; n2.ldr = H; n2.row_mask = mask;
    n2.c = hn; n2.ldc = H; n2.M = M; n2.Nout = H; n2.K = H;
    n2.epilogue = kEpiResidMask;
    if ((rc = launch_gemm(n2, s))) return rc;
    hc = hn;
  }

  EdgeBwdArgs eb = {};
  eb.proj = sc.proj; eb.x = x; eb.x0 = x0; eb.mask = mask; eb.ld1 = d.ld1;
  eb.abuf = sc.abuf; eb.dbuf = sc.dbuf; eb.pbuf = sc.pbuf; eb.rowsum = sc.rowsum;
  eb.part = sc.part; eb.dr = sc.dr; eb.dr0 = sc.dr0; eb.dcd = sc.dcd;
  eb.N = N; eb.H = H; eb.E = E; eb.sin_emb = sin_emb; eb.attention = attention;
  eb.use_tanh = use_tanh; eb.coords_range = coords_range; eb.norm_constant = norm_constant;
  eb.norm_div = d.norm_div;

  // 2. Coordinate update: dL/dh_n = gh * mask + its edge stage's share.
  const float* const* cw = reinterpret_cast<const float* const*>(coord_w);
  float* const* cg = reinterpret_cast<float* const*>(coord_g);
  if ((rc = launch_projection(hc, cw[0], d.ld1, sc.proj, M, H, s))) return rc;
  eb.w1 = cw[0]; eb.b1 = cw[1]; eb.w2 = cw[2]; eb.b2 = cw[3]; eb.w_out = cw[4];
  eb.b_out = nullptr; eb.dagg = nullptr; eb.gx = gx;
  if ((rc = launch_edge_bwd<true>(eb, B, s))) return rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(gh, mask, sc.dcur, M, H);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = stage_grads(d, hc, cw[0], cg[0], cg[1], cg[2], cg[3], cg[4], nullptr, sc, sc.dcur,
                        s)))
    return rc;

  // 3. GCLs in reverse. dcur = dL/d(output of GCL gi).
  float* const* gg = reinterpret_cast<float* const*>(gcl_g);
  float *dcur = sc.dcur, *dnext = sc.dnext;
  for (int gi = n_gcl - 1; gi >= 0; --gi) {
    const float* const* w = gw + 10 * gi;
    float* const* g = gg + 10 * gi;
    const float* hin = gi == 0 ? h : sc.hs + (size_t)(gi - 1) * M * H;
    const float* agg = sc.aggs + (size_t)gi * M * H;
    const float* z = sc.zs + (size_t)gi * M * H;
    const float* u = sc.us + (size_t)gi * M * H;
    // Node MLP: out = (hin + silu([hin, agg] Wn1^T + bn1) Wn2^T + bn2) * mask.
    rows_mask_kernel<<<nblk, 256, 0, s>>>(dcur, mask, sc.dtmp, M, H);  // d(upd)
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = reduce_rows(sc.dtmp, M, H, H, g[9], 1, s))) return rc;
    if ((rc = gemm(sc.dtmp, H, 1, u, H, 0, g[8], H, H, H, M, 0, sc.split, s))) return rc;
    if ((rc = gemm(sc.dtmp, H, 0, w[8], H, 0, sc.dagg, H, M, H, H, 0, sc.split, s)))
      return rc;  // d(u), in dagg for now
    dsilu_mul_kernel<<<nblk, 256, 0, s>>>(sc.dagg, z, sc.dtmp, M * H);  // d(z)
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = reduce_rows(sc.dtmp, M, H, H, g[7], 1, s))) return rc;
    if ((rc = gemm(sc.dtmp, H, 1, hin, H, 0, g[6], 2 * H, H, H, M, 0, sc.split, s))) return rc;
    if ((rc = gemm(sc.dtmp, H, 1, agg, H, 0, g[6] + H, 2 * H, H, H, M, 0, sc.split, s)))
      return rc;
    rows_mask_kernel<<<nblk, 256, 0, s>>>(dcur, mask, dnext, M, H);  // residual path
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = gemm(sc.dtmp, H, 0, w[6], 2 * H, 0, dnext, H, M, H, H, 1, sc.split, s)))
      return rc;
    if ((rc = gemm(sc.dtmp, H, 0, w[6] + H, 2 * H, 0, sc.dagg, H, M, H, H, 0, sc.split, s)))
      return rc;
    // Edge stage.
    if ((rc = launch_projection(hin, w[0], d.ld1, sc.proj, M, H, s))) return rc;
    eb.w1 = w[0]; eb.b1 = w[1]; eb.w2 = w[2]; eb.b2 = w[3]; eb.w_out = w[4];
    eb.b_out = w[5]; eb.dagg = sc.dagg; eb.gx = nullptr;
    if ((rc = launch_edge_bwd<false>(eb, B, s))) return rc;
    if ((rc = stage_grads(d, hin, w[0], g[0], g[1], g[2], g[3], attention ? g[4] : nullptr,
                          attention ? g[5] : nullptr, sc, dnext, s)))
      return rc;
    float* t = dcur; dcur = dnext; dnext = t;
  }
  if ((ce = cudaMemcpyAsync(dh, dcur, (size_t)M * H * sizeof(float), cudaMemcpyDeviceToDevice,
                            s)))
    return (int)ce;

  // 4. Coordinates.
  coord_grad_kernel<<<(M + 127) / 128, 128, 0, s>>>(x, x0, mask, gx, sc.dcd, sc.dr, sc.dr0, dx,
                                                    dx0, M, N, norm_constant);
  return (int)cudaGetLastError();
}

}  // extern "C"
