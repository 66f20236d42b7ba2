// The row-tiled stage backward, shared by the single-device stages
// (egnn_tiled_bwd.cu, TPU kernel #5, whose header comment gives the design)
// and the sequence-parallel slab stages (egnn_sp.cu, TPU kernel #7): the edge
// grid rows_bwd_kernel, the scratch layout, the coordinate passes and the
// host loop rows_backward, all over a row window (egnn_rows.cuh). A
// single-device stage is the window of every row with the slab's views
// aliasing the full ones, and its gradients of both views are summed; an SP
// stage keeps the full-view gradients [B*N, *] apart from the slab's [B*S, *].

#pragma once

#include "egnn_bwd_common.cuh"
#include "egnn_rows.cuh"

namespace {

template <bool COORD>
__global__ void __launch_bounds__(kMaxHidden, 1) rows_bwd_kernel(EdgeBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, N = a.N, E = a.E;
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5, nwarp = H >> 5;
  const int b = blockIdx.y;
  const int i = a.row0 + blockIdx.x;                  // global row: the diagonal
  const size_t row_i = (size_t)b * a.S + blockIdx.x;  // index into the slab's views
  const size_t edge0 = row_i * N;  // edge index of (b, i, j) is edge0 + j

  float* As = smem;                          // [kColTile][H] silu(pre), then d(mm), then d(pre)
  float* Ws = As + kColTile * H;             // [kKChunk][H + 1] W2 chunk
  float* ef = Ws + kKChunk * (H + 1);        // [kColTile][kMaxEdgeFeat]
  float* em = ef + kColTile * kMaxEdgeFeat;  // [kColTile] edge mask of row i
  float* cd = em + kColTile;                 // [kColTile][3] coord_diff
  float* red = cd + kColTile * 3;            // [nwarp][kColTile]
  float* red2 = red + nwarp * kColTile;      // [nwarp][kColTile]
  float* rs = red2 + nwarp * kColTile;       // [kColTile] per-pair scalars
  float* rs2 = rs + kColTile;                // [kColTile]

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
  const bool gated = COORD || a.attention;
  const float wo = gated ? a.w_out[c] : 0.f;
  const float dagg = COORD ? 0.f : a.dagg[row_i * H + c] / a.norm_div;
  float daggx[3] = {0.f, 0.f, 0.f};
  if (COORD) {
#pragma unroll
    for (int q = 0; q < 3; ++q) daggx[q] = a.gx[row_i * 3 + q] * mi / a.norm_div;
  }
  float we[kMaxEdgeFeat];
#pragma unroll
  for (int e = 0; e < kMaxEdgeFeat; ++e)
    we[e] = e < E ? a.w1[(size_t)c * a.ld1 + 2 * H + e] : 0.f;

  const int ps = (3 + E) * H;
  float* part = a.part + row_i * ps;  // this CTA's partial row
  for (int e = 0; e < E; ++e) part[(3 + e) * H + c] = 0.f;
  float db2 = 0.f, dwo = 0.f, dbo = 0.f, rsum = 0.f;

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
    // Barrier for step 1. A tile with no live pair adds exactly zero: its
    // rows of the edge buffers are zeroed for the passes that read them all.
    if (!__syncthreads_or(live)) {
      for (int jj = 0; jj < kColTile && j0 + jj < N; ++jj) {
        const size_t e = (edge0 + j0 + jj) * H + c;
        a.abuf[e] = 0.f;
        a.dbuf[e] = 0.f;
        a.pbuf[e] = 0.f;
      }
      continue;
    }

    // 2. The tile's silu(pre), also written out for the W2 gradient.
    for (int jj = 0; jj < kColTile; ++jj) {
      const int j = j0 + jj;
      float v = 0.f;
      if (j < N) {
        const float dst = a.dst[((size_t)b * N + j) * a.ld_dst + c];
        float ew = 0.f;
#pragma unroll
        for (int e = 0; e < kMaxEdgeFeat; ++e) ew = fmaf(ef[jj * kMaxEdgeFeat + e], we[e], ew);
        v = silu_f(src + dst + ew + bias1);
        a.abuf[(edge0 + j) * H + c] = v;
      }
      As[jj * H + c] = v;
    }
    __syncthreads();

    // 3. Second layer: acc[jj] = mm_jj[c].
    float acc[kColTile];
#pragma unroll
    for (int jj = 0; jj < kColTile; ++jj) acc[jj] = 0.f;
    row_tile_product<kColTile, false>(As, Ws, a.w2, H, c, acc);
#pragma unroll
    for (int jj = 0; jj < kColTile; ++jj) acc[jj] += bias2;

    // 4. Per-pair scalars: the gate / coordinate logit sum_c m[c] w_out[c]
    //    and, for the gate, sum_c dagg[c] m[c], reduced across the CTA.
    if (gated) {
#pragma unroll
      for (int jj = 0; jj < kColTile; ++jj) {
        const float m = silu_f(acc[jj]);
        float p = m * wo, p2 = m * dagg;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          p += __shfl_xor_sync(0xffffffffu, p, o);
          p2 += __shfl_xor_sync(0xffffffffu, p2, o);
        }
        if (lane == 0) {
          red[warp * kColTile + jj] = p;
          red2[warp * kColTile + jj] = p2;
        }
      }
      __syncthreads();
      if (c < kColTile) {
        float s = 0.f, s2 = 0.f;
        for (int w = 0; w < nwarp; ++w) {
          s += red[w * kColTile + c];
          s2 += red2[w * kColTile + c];
        }
        if (COORD) {
          // s_ij = tanh(l) * range; ds_ij = em (daggx . cd); dcd = daggx s em.
          const float th = tanhf(s);
          const float scale = a.use_tanh ? th * a.coords_range : s;
          const float dotc = daggx[0] * cd[c * 3] + daggx[1] * cd[c * 3 + 1] +
                             daggx[2] * cd[c * 3 + 2];
          const float ds = em[c] * dotc;
          if (j0 + c < N) {
#pragma unroll
            for (int q = 0; q < 3; ++q)
              a.dcd[(edge0 + j0 + c) * 3 + q] = daggx[q] * scale * em[c];
          }
          rs2[c] = a.use_tanh ? ds * a.coords_range * (1.f - th * th) : ds;
        } else {
          // gate g = sigmoid(l + ba); q = g (1 - g) em (dagg . m).
          const float g = sigmoid_f(s + a.b_out[0]);
          rs[c] = g;
          rs2[c] = g * (1.f - g) * em[c] * s2;
        }
      }
      __syncthreads();
    }

    // 5. d(mm)[c] into As (silu(pre) is no longer read) and out.
#pragma unroll
    for (int jj = 0; jj < kColTile; ++jj) {
      const float mm = acc[jj];
      const float m = silu_f(mm);
      float dm;
      if (COORD) {
        dm = rs2[jj] * wo;
        dwo = fmaf(rs2[jj], m, dwo);
      } else if (a.attention) {
        dm = dagg * em[jj] * rs[jj] + rs2[jj] * wo;
        dwo = fmaf(rs2[jj], m, dwo);
        dbo += rs2[jj];
      } else {
        dm = dagg * em[jj];
      }
      const float dmm = dm * dsilu_f(mm);
      db2 += dmm;
      As[jj * H + c] = dmm;
      if (j0 + jj < N) a.dbuf[(edge0 + j0 + jj) * H + c] = dmm;
    }
    __syncthreads();

    // 6. d(silu(pre))[c] = sum_k d(mm)[k] W2[k][c].
#pragma unroll
    for (int jj = 0; jj < kColTile; ++jj) acc[jj] = 0.f;
    row_tile_product<kColTile, true>(As, Ws, a.w2, H, c, acc);

    // 7. d(pre)[c]: into As, pbuf and the row sum.
    for (int jj = 0; jj < kColTile; ++jj) {
      const int j = j0 + jj;
      float dp = 0.f;
      if (j < N) {
        const float dst = a.dst[((size_t)b * N + j) * a.ld_dst + c];
        float ew = 0.f;
#pragma unroll
        for (int e = 0; e < kMaxEdgeFeat; ++e) ew = fmaf(ef[jj * kMaxEdgeFeat + e], we[e], ew);
        dp = acc[jj] * dsilu_f(src + dst + ew + bias1);
        a.pbuf[(edge0 + j) * H + c] = dp;
      }
      As[jj * H + c] = dp;
      rsum += dp;
    }
    __syncthreads();

    // 8. Edge-feature columns of W1: dWe[e][c] += sum_jj ef[jj][e] d(pre)[c].
    for (int e = 0; e < E; ++e) {
      float s = 0.f;
      for (int jj = 0; jj < kColTile; ++jj) s = fmaf(ef[jj * kMaxEdgeFeat + e], As[jj * H + c], s);
      part[(3 + e) * H + c] += s;
    }

    // 9. Squared-distance features (not sin, whose features carry no
    //    gradient): dr_ij = sum_c d(pre)[c] We[c][0], dr0 with We[c][1].
    if (!a.sin_emb) {
#pragma unroll
      for (int jj = 0; jj < kColTile; ++jj) {
        const float dp = As[jj * H + c];
        float p = dp * we[0], p0 = dp * we[1];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          p += __shfl_xor_sync(0xffffffffu, p, o);
          p0 += __shfl_xor_sync(0xffffffffu, p0, o);
        }
        if (lane == 0) {
          red[warp * kColTile + jj] = p;
          red2[warp * kColTile + jj] = p0;
        }
      }
      __syncthreads();
      if (c < kColTile && j0 + c < N) {
        float s = 0.f, s0 = 0.f;
        for (int w = 0; w < nwarp; ++w) {
          s += red[w * kColTile + c];
          s0 += red2[w * kColTile + c];
        }
        a.dr[edge0 + j0 + c] = s;
        a.dr0[edge0 + j0 + c] = s0;
      }
    }
    __syncthreads();  // the next tile overwrites ef, em, cd, As, red and rs
  }

  part[c] = db2;
  part[H + c] = dwo;
  part[2 * H + c] = c == 0 ? dbo : 0.f;
  a.rowsum[row_i * H + c] = rsum;
}

template <bool COORD>
int launch_rows_bwd(const EdgeBwdArgs& a, int B, cudaStream_t s) {
  const size_t smem = edge_bwd_smem_bytes(kColTile, a.H);
  cudaError_t e = cudaFuncSetAttribute(rows_bwd_kernel<COORD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  rows_bwd_kernel<COORD><<<dim3(a.S, B), a.H, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Scratch of one group of G molecules, in floats: node-sized pieces for M =
// G*N rows (the src projection, the aggregate and the row sums use the first
// G*S of them), edge-sized ones for Me = G*S*N pairs.
struct RowsScratch : EdgeGradBufs {
  float *proj, *agg, *z, *u, *dtmp, *dagg, *dr, *dr0, *dcd;
};

size_t rows_scratch_layout(int G, int S, int N, int H, int E, float* base, RowsScratch* s) {
  const size_t M = (size_t)G * N, Me = (size_t)G * S * N;
  const size_t sizes[] = {M * 2 * H, M * H, M * H, M * H, M * H, M * H, M * H, M * H,
                          M * (3 + E) * H, Me * H, Me * H, Me * H, Me, Me, Me * 3,
                          (size_t)kMaxSplits * H * H};
  float** ptrs[] = {&s->proj, &s->agg, &s->z, &s->u, &s->dtmp, &s->dagg, &s->rowsum,
                    &s->colsum, &s->part, &s->abuf, &s->dbuf, &s->pbuf, &s->dr, &s->dr0,
                    &s->dcd, &s->split.buf};
  s->split.cap = sizes[sizeof(sizes) / sizeof(sizes[0]) - 1];
  size_t off = 0;
  for (int k = 0; k < (int)(sizeof(sizes) / sizeof(sizes[0])); ++k) {
    if (base) *ptrs[k] = base + off;
    off += (sizes[k] + 63) / 64 * 64;  // 256-byte aligned pieces
  }
  return off;
}

EdgeBwdArgs bwd_args(const RowsScratch& sc, const Slab& r, const float* x, const float* x0,
                     const float* mask, const float* const* w, int N, int H, int E, int sin_emb,
                     float norm_div, float norm_constant) {
  EdgeBwdArgs eb = {};
  eb.proj = sc.proj; eb.x = x; eb.x0 = x0; eb.mask = mask;
  eb.xr = r.x; eb.x0r = r.x0; eb.maskr = r.mask;
  eb.src = sc.proj; eb.ld_src = 2 * H; eb.dst = sc.proj + H; eb.ld_dst = 2 * H;
  eb.row0 = r.row0; eb.S = r.S;
  eb.w1 = w[0]; eb.ld1 = 2 * H + E; eb.b1 = w[1]; eb.w2 = w[2]; eb.b2 = w[3];
  eb.abuf = sc.abuf; eb.dbuf = sc.dbuf; eb.pbuf = sc.pbuf; eb.rowsum = sc.rowsum;
  eb.part = sc.part; eb.dr = sc.dr; eb.dr0 = sc.dr0; eb.dcd = sc.dcd;
  eb.N = N; eb.H = H; eb.E = E; eb.sin_emb = sin_emb;
  eb.norm_constant = norm_constant; eb.norm_div = norm_div;
  return eb;
}

// Zeroes the pair gradients a stage's edge grid leaves unwritten: those of
// skipped tiles, and dr/dr0 under sin features.
int clear_pair_grads(const RowsScratch& sc, size_t Me, cudaStream_t s) {
  cudaError_t ce;
  if ((ce = cudaMemsetAsync(sc.dr, 0, Me * sizeof(float), s))) return (int)ce;
  if ((ce = cudaMemsetAsync(sc.dr0, 0, Me * sizeof(float), s))) return (int)ce;
  return (int)cudaMemsetAsync(sc.dcd, 0, Me * 3 * sizeof(float), s);
}

// G_ij = dL/d(x_i - x_j) of one pair, through coord_diff (dcd; coordinate
// stage only) and the squared distance (dr, plus the norm inside
// coord_diff), and G0_ij = dL/d(x0_i - x0_j) = 2 (x0_i - x0_j) dr0_ij, as in
// coord_grad_kernel (egnn_bwd_common.cuh).
template <bool COORD>
__device__ __forceinline__ void pair_coord_grad(const float* d, const float* d0, size_t e,
                                                const float* dcd, const float* dr,
                                                const float* dr0, float norm_constant,
                                                float* g, float* g0) {
  if (COORD) {
    const float rr = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float norm = sqrtf(rr + 1e-8f);
    const float cc = norm + norm_constant;
    const float* cij = dcd + e * 3;
    const float dot = cij[0] * d[0] + cij[1] * d[1] + cij[2] * d[2];
    const float dlr = dr[e] - dot / (cc * cc) / (2.f * norm);
#pragma unroll
    for (int q = 0; q < 3; ++q) g[q] = cij[q] / cc + 2.f * d[q] * dlr;
  } else {
    const float s = 2.f * dr[e];
#pragma unroll
    for (int q = 0; q < 3; ++q) g[q] = d[q] * s;
  }
  const float s0 = 2.f * dr0[e];
#pragma unroll
  for (int q = 0; q < 3; ++q) g0[q] = d0[q] * s0;
}

// The coordinate pass of a slab whose rows and columns are different views
// (kernel #7): the slab has only its own rows' pairs, so it splits where
// coord_grad_kernel reads the transposed pair. Row view: dxr_i = gx_i m_i +
// sum_j G_ij, dx0r_i = sum_j G0_ij, one thread per slab row.
template <bool COORD>
__global__ void slab_coord_rows_kernel(const float* xr, const float* x0r, const float* maskr,
                                       const float* x, const float* x0, const float* gx,
                                       const float* dcd, const float* dr, const float* dr0,
                                       float* dxr, float* dx0r, int BS, int S, int N,
                                       float norm_constant) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= BS) return;
  const int b = r / S;
  const float mi = maskr[r];
  float gi[3], gi0[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 3; ++q) gi[q] = COORD ? gx[(size_t)r * 3 + q] * mi : 0.f;
  for (int j = 0; j < N; ++j) {
    const size_t rj = (size_t)b * N + j;
    float d[3], d0[3], g[3], g0[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      d[q] = xr[(size_t)r * 3 + q] - x[rj * 3 + q];
      d0[q] = x0r[(size_t)r * 3 + q] - x0[rj * 3 + q];
    }
    pair_coord_grad<COORD>(d, d0, (size_t)r * N + j, dcd, dr, dr0, norm_constant, g, g0);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      gi[q] += g[q];
      gi0[q] += g0[q];
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    dxr[(size_t)r * 3 + q] = gi[q];
    dx0r[(size_t)r * 3 + q] = gi0[q];
  }
}

// Full (column) view: dx_j = -sum_{i in slab} G_ij, dx0_j = -sum_i G0_ij, one
// thread per column, the slab's rows summed in order.
template <bool COORD>
__global__ void slab_coord_cols_kernel(const float* xr, const float* x0r, const float* x,
                                       const float* x0, const float* dcd, const float* dr,
                                       const float* dr0, float* dx, float* dx0, int BN, int S,
                                       int N, float norm_constant) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;  // b * N + j
  if (r >= BN) return;
  const int b = r / N, j = r % N;
  float gj[3] = {0.f, 0.f, 0.f}, gj0[3] = {0.f, 0.f, 0.f};
  for (int il = 0; il < S; ++il) {
    const size_t ri = (size_t)b * S + il;
    float d[3], d0[3], g[3], g0[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      d[q] = xr[ri * 3 + q] - x[(size_t)r * 3 + q];
      d0[q] = x0r[ri * 3 + q] - x0[(size_t)r * 3 + q];
    }
    pair_coord_grad<COORD>(d, d0, ri * N + j, dcd, dr, dr0, norm_constant, g, g0);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      gj[q] -= g[q];
      gj0[q] -= g0[q];
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    dx[(size_t)r * 3 + q] = gj[q];
    dx0[(size_t)r * 3 + q] = gj0[q];
  }
}

// A stage backward's outputs: the full view's dh, dx, dx0 [B*N, *] and the
// slab's dhr, dxr, dx0r [B*S, *]. A single-device stage passes the same
// buffers twice.
struct StageGrads {
  float *dh, *dx, *dx0, *dhr, *dxr, *dx0r;
};

// One stage backward over slab r of the stage input (h, x, x0, mask the full
// view [B*N, *]): gout is the cotangent of the slab's output ([B*S, H] for a
// GCL, [B*S, 3] for the coordinate update). whole: the slab is the full view
// (kernel #5; out's two views alias and get the sum, coordinates through
// coord_grad_kernel), else an SP slab (#7; the split coordinate passes). w / g:
// the stage's weight / gradient pointers (10 of a GCL, 5 of the coordinate
// update); every gradient is overwritten. The molecules run in groups of G
// whose scratch is rows_scratch_layout(G, S, ...), each group's weight
// gradients added to the previous groups' in group order.
template <int kOwner, bool COORD>
int rows_backward(bool whole, const float* h, const float* x, const float* x0,
                  const float* mask, const Slab& r, const float* gout, const StageGrads& out,
                  const float* const* w, float* const* g, float* scratch, int B, int G, int N,
                  int H, int E, int attention, int sin_emb, int use_tanh, float coords_range,
                  float norm_div, float norm_constant, cudaStream_t s) {
  const int S = r.S;
  RowsScratch sc;
  rows_scratch_layout(G, S, N, H, E, scratch, &sc);
  int rc;
  cudaError_t ce;
  for (int b0 = 0; b0 < B; b0 += G) {
    const int Bg = min(G, B - b0);
    const int acc = b0 > 0;  // later groups add to the weight gradients
    const int Mr = Bg * S, Mc = Bg * N;
    const size_t offr = (size_t)b0 * S, offc = (size_t)b0 * N;
    const float *hg = h + offc * H, *xg = x + offc * 3, *x0g = x0 + offc * 3;
    const float* mg = mask + offc;
    const Slab rg = {r.h + offr * H, r.x + offr * 3, r.x0 + offr * 3, r.mask + offr, r.row0, S};
    float* dhg = out.dh + offc * H;
    float* dhrg = out.dhr + offr * H;
    if ((rc = clear_pair_grads(sc, (size_t)Mr * N, s))) return rc;
    if (COORD && (ce = cudaMemsetAsync(dhrg, 0, (size_t)Mr * H * sizeof(float), s)))
      return (int)ce;
    if (!whole && (ce = cudaMemsetAsync(dhg, 0, (size_t)Mc * H * sizeof(float), s)))
      return (int)ce;
    if ((rc = launch_projection_window<kOwner>(rg.h, Mr, hg, Mc, w[0], 2 * H + E, sc.proj, H, s)))
      return rc;
    if (!COORD) {
      // 1. Forward recompute of the aggregate and the node MLP, then its backward.
      TileArgs ea = stage_args(rg, xg, x0g, mg, sc.proj, w, N, H, E, sin_emb, norm_div,
                               norm_constant);
      ea.attention = attention;
      ea.w_out = w[4]; ea.b_out = w[5]; ea.agg = sc.agg;
      if ((rc = launch_rows<false>(ea, Bg, s))) return rc;
      GemmArgs n1 = {};
      n1.a1 = rg.h; n1.lda1 = H; n1.k1 = H; n1.a2 = sc.agg; n1.lda2 = H;
      n1.w = w[6]; n1.ldw = 2 * H; n1.bias = w[7];
      n1.c = sc.z; n1.ldc = H; n1.M = Mr; n1.Nout = H; n1.K = 2 * H;
      n1.epilogue = kEpiNone;
      if ((rc = launch_gemm<kOwner>(n1, s))) return rc;
      silu_kernel<<<(Mr * H + 255) / 256, 256, 0, s>>>(sc.z, sc.u, Mr * H);
      if ((rc = (int)cudaGetLastError())) return rc;
      if ((rc = node_mlp_backward(gout + offr * H, rg.mask, rg.h, sc.agg, sc.z, sc.u, w, g,
                                  sc.dtmp, sc.dagg, dhrg, Mr, H, acc, sc.split, s)))
        return rc;
    }
    // 2. The edge grid, then 3. the weight gradients, dh and the coordinates.
    EdgeBwdArgs eb = bwd_args(sc, rg, xg, x0g, mg, w, N, H, E, sin_emb, norm_div, norm_constant);
    const float* gxg = COORD ? gout + offr * 3 : nullptr;
    if (COORD) {
      eb.use_tanh = use_tanh; eb.coords_range = coords_range;
      eb.w_out = w[4]; eb.gx = gxg;
    } else {
      eb.attention = attention;
      eb.w_out = w[4]; eb.b_out = w[5]; eb.dagg = sc.dagg;
    }
    if ((rc = launch_rows_bwd<COORD>(eb, Bg, s))) return rc;
    const Dims d = {Bg, N, H, E, 2 * H + E, norm_div, S};
    float* gwo = COORD || attention ? g[4] : nullptr;
    float* gbo = !COORD && attention ? g[5] : nullptr;
    if ((rc = stage_grads_window(d, rg.h, hg, w[0], g[0], g[1], g[2], g[3], gwo, gbo, sc, dhrg,
                                 dhg, acc, s)))
      return rc;
    if (whole) {
      coord_grad_kernel<COORD><<<(Mr + 127) / 128, 128, 0, s>>>(
          xg, x0g, mg, gxg, COORD ? sc.dcd : nullptr, sc.dr, sc.dr0, out.dx + offc * 3,
          out.dx0 + offc * 3, Mr, N, norm_constant);
    } else {
      slab_coord_rows_kernel<COORD><<<(Mr + 127) / 128, 128, 0, s>>>(
          rg.x, rg.x0, rg.mask, xg, x0g, gxg, sc.dcd, sc.dr, sc.dr0, out.dxr + offr * 3,
          out.dx0r + offr * 3, Mr, S, N, norm_constant);
      if ((rc = (int)cudaGetLastError())) return rc;
      slab_coord_cols_kernel<COORD><<<(Mc + 127) / 128, 128, 0, s>>>(
          rg.x, rg.x0, xg, x0g, sc.dcd, sc.dr, sc.dr0, out.dx + offc * 3, out.dx0 + offc * 3,
          Mc, S, N, norm_constant);
    }
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  return 0;
}

}  // namespace
