// Backward of one row-tiled EquivariantBlock stage in f32 on Hopper (sm_90a),
// for molecules too large for the whole-row backward of egnn_block_bwd.cu
// (GEOM-Drugs trains in buckets padded to 80/104/128/184 atoms): the GCL
// stage with its node MLP (egnn_gcl_rows_backward) and the coordinate stage
// (egnn_coord_rows_backward).
//
// Replaces the TPU kernel #5, geoldm_tpu/ops/pallas_egnn_tiled.py:201
// _make_rows_bwd_kernel (pallas_call :276 in _call_rows_bwd :267-304), with
// its contract: from one stage's inputs (h, x, x0, node mask), its weights
// and the cotangent of its output (h_out [B,N,H] of a GCL, x_out [B,N,3] of
// the coordinate update) it returns dh, dx, the exact dx0 and every weight
// gradient of the stage summed over the batch (the Pallas kernel's full-
// column and row views summed, as :301-303 does). As in kernel #2 the sin/cos
// distance features carry no gradient.
//
// Design. The Pallas kernel recomputes a [T, N] row slab in VMEM, runs an
// in-kernel jax.vjp and accumulates weight gradients across its sequential
// grid. Here the stage runs as deterministic passes without atomics (a
// seeded run replays bit for bit), those of kernel #2 around a new edge
// grid:
//   1. the src/dst projection GEMM; for a GCL also the forward recompute of
//      its aggregate (the row-tiled forward edge kernel of egnn_rows.cuh)
//      and node MLP, and the node-MLP backward, which gives the gradient of
//      the aggregate;
//   2. rows_bwd_kernel, one CTA per (molecule b, row i) and one thread per
//      hidden channel, which walks the columns in masked tiles of kColTile =
//      32 through shared memory as the forward does. Per tile it rebuilds
//      the pair features and silu(pre), recomputes the second layer,
//      back-propagates through the attention gate or the tanh scale, runs
//      the transposed W2 product, and folds the tile into the row's sums
//      (db2, the gate or scale weight, db1 and the src projection's
//      gradient in registers; the edge-feature columns of W1 in the CTA's
//      own partial row). It writes silu(pre), d(mm) and d(pre) of its row to
//      device memory for the passes that cross rows, and the squared-
//      distance gradients of its pairs (not sin). A tile whose edge mask is
//      all zero adds nothing: it writes zeros and is skipped;
//   3. the passes of egnn_bwd_common.cuh: the column sum of d(pre) for the
//      dst projection, split-K GEMMs for the weight gradients, the
//      deterministic row reductions, and the coordinate pass dx_i = sum_j
//      (G_ij - G_ji), dx0 likewise.
// 'Mean' divides by the caller's N; the diagonal is masked at the global row.
//
// Memory. The three edge-sized buffers of step 2 (silu(pre), d(mm), d(pre))
// take 3 * G*N*N*H*4 bytes for a group of G molecules, 3 x 1.11 GB at G=32,
// N=184, H=256; with the node-sized pieces, the pair gradients and the
// split-K buffer, egnn_rows_backward_scratch_floats gives the whole. The
// caller picks G so that the scratch stays under its cap and this function
// runs the molecules in groups of G, adding each group's weight gradients to
// the previous groups' in group order; one molecule over the cap is the
// caller's to refuse.
//
// What bounds it on an H100: about 6*N^2*H^2 FLOP per molecule and stage
// (the recomputed second layer, the transposed product, the W2 gradient),
// f32 FMA outside the tensor cores, against ~7 bytes of edge traffic per
// 100 FLOP: it is bound by operations. One call enqueues about 25 grids
// (GCL) or 15 (coordinate update) per group on the caller's stream and does
// not synchronise.

#include "egnn_bwd_common.cuh"
#include "egnn_rows.cuh"

namespace {

template <bool COORD>
__global__ void __launch_bounds__(kMaxHidden, 1) rows_bwd_kernel(EdgeBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, N = a.N, E = a.E;
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5, nwarp = H >> 5;
  const int b = blockIdx.y, i = blockIdx.x;
  const size_t row_i = (size_t)b * N + i;
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
        const float dst = a.proj[((size_t)b * N + j) * 2 * H + H + c];
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
        const float dst = a.proj[((size_t)b * N + j) * 2 * H + H + c];
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
  rows_bwd_kernel<COORD><<<dim3(a.N, B), a.H, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Scratch of one group of G molecules, in floats (M = G*N node rows, Me =
// G*N*N edge rows).
struct RowsScratch : EdgeGradBufs {
  float *proj, *agg, *z, *u, *dtmp, *dagg, *dr, *dr0, *dcd;
};

size_t rows_scratch_layout(int G, int N, int H, int E, float* base, RowsScratch* s) {
  const size_t M = (size_t)G * N, Me = M * N;
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

EdgeBwdArgs bwd_args(const RowsScratch& sc, const float* x, const float* x0, const float* mask,
                     const float* const* w, int N, int H, int E, int sin_emb, float norm_div,
                     float norm_constant) {
  EdgeBwdArgs eb = {};
  eb.proj = sc.proj; eb.x = x; eb.x0 = x0; eb.mask = mask;
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

}  // namespace

extern "C" {

const char* egnn_tiled_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of device scratch either backward needs for a group of G molecules.
size_t egnn_rows_backward_scratch_floats(int G, int N, int H, int E) {
  RowsScratch s;
  return rows_scratch_layout(G, N, H, E, nullptr, &s);
}

// Kernel #5, GCL stage. h: the GCL's input; gh: the cotangent of its output
// [B*N, H]. w / g: host arrays of the GCL's 10 weight / gradient device
// pointers in egnn_gcl_rows' order (att_mlp entries null without
// attention); every gradient is overwritten. scratch: a device buffer of
// egnn_rows_backward_scratch_floats(G, ...) floats; the molecules run in
// groups of G. Returns a cudaError_t value (0 on success).
int egnn_gcl_rows_backward(const float* h, const float* x, const float* x0, const float* mask,
                           const float* gh, float* dh, float* dx, float* dx0,
                           const void* const* w_table, void* const* g_table, float* scratch,
                           int B, int G, int N, int H, int E, int attention, int sin_emb,
                           int mean_agg, float norm_constant, float normalization_factor,
                           void* stream) {
  if (bad_dims(B, N, H, E, sin_emb) || G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* const* w = reinterpret_cast<const float* const*>(w_table);
  float* const* g = reinterpret_cast<float* const*>(g_table);
  RowsScratch sc;
  rows_scratch_layout(G, N, H, E, scratch, &sc);
  const float norm_div = mean_agg ? (float)N : normalization_factor;
  int rc;
  for (int b0 = 0; b0 < B; b0 += G) {
    const int Bg = min(G, B - b0);
    const int acc = b0 > 0;  // later groups add to the weight gradients
    const int M = Bg * N;
    const size_t off = (size_t)b0 * N;
    const float *hg = h + off * H, *xg = x + off * 3, *x0g = x0 + off * 3, *mg = mask + off;
    float* dhg = dh + off * H;
    if ((rc = clear_pair_grads(sc, (size_t)M * N, s))) return rc;
    // 1. Forward recompute of the aggregate and the node MLP, then its backward.
    if ((rc = launch_projection<5>(hg, w[0], 2 * H + E, sc.proj, M, H, s))) return rc;
    EdgeArgs ea = stage_args(xg, x0g, mg, sc.proj, w, N, H, E, sin_emb, mean_agg,
                             norm_constant, normalization_factor);
    ea.attention = attention;
    ea.w_out = w[4]; ea.b_out = w[5]; ea.agg = sc.agg;
    if ((rc = launch_rows(false, ea, Bg, s))) return rc;
    GemmArgs n1 = {};
    n1.a1 = hg; n1.lda1 = H; n1.k1 = H; n1.a2 = sc.agg; n1.lda2 = H;
    n1.w = w[6]; n1.ldw = 2 * H; n1.bias = w[7];
    n1.c = sc.z; n1.ldc = H; n1.M = M; n1.Nout = H; n1.K = 2 * H;
    n1.epilogue = kEpiNone;
    if ((rc = launch_gemm<5>(n1, s))) return rc;
    silu_kernel<<<(M * H + 255) / 256, 256, 0, s>>>(sc.z, sc.u, M * H);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = node_mlp_backward(gh + off * H, mg, hg, sc.agg, sc.z, sc.u, w, g, sc.dtmp,
                                sc.dagg, dhg, M, H, acc, sc.split, s)))
      return rc;
    // 2. The edge grid, then 3. the weight gradients, dh and the coordinates.
    EdgeBwdArgs eb = bwd_args(sc, xg, x0g, mg, w, N, H, E, sin_emb, norm_div, norm_constant);
    eb.attention = attention;
    eb.w_out = w[4]; eb.b_out = w[5]; eb.dagg = sc.dagg;
    if ((rc = launch_rows_bwd<false>(eb, Bg, s))) return rc;
    const Dims d = {Bg, N, H, E, 2 * H + E, norm_div};
    if ((rc = stage_grads(d, hg, w[0], g[0], g[1], g[2], g[3], attention ? g[4] : nullptr,
                          attention ? g[5] : nullptr, sc, dhg, acc, s)))
      return rc;
    coord_grad_kernel<false><<<(M + 127) / 128, 128, 0, s>>>(
        xg, x0g, mg, nullptr, nullptr, sc.dr, sc.dr0, dx + off * 3, dx0 + off * 3, M, N,
        norm_constant);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  return 0;
}

// Kernel #5, coordinate stage. gx: the cotangent of x_out [B*N, 3]. w / g:
// host arrays of 5 weight / gradient device pointers, coord_mlp.0.{weight,
// bias}, coord_mlp.2.{weight,bias}, coord_mlp.4.weight; every gradient is
// overwritten. scratch and G as egnn_gcl_rows_backward. Returns a
// cudaError_t value.
int egnn_coord_rows_backward(const float* h, const float* x, const float* x0, const float* mask,
                             const float* gx, float* dh, float* dx, float* dx0,
                             const void* const* w_table, void* const* g_table, float* scratch,
                             int B, int G, int N, int H, int E, int sin_emb, int use_tanh,
                             int mean_agg, float coords_range, float norm_constant,
                             float normalization_factor, void* stream) {
  if (bad_dims(B, N, H, E, sin_emb) || G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* const* w = reinterpret_cast<const float* const*>(w_table);
  float* const* g = reinterpret_cast<float* const*>(g_table);
  RowsScratch sc;
  rows_scratch_layout(G, N, H, E, scratch, &sc);
  const float norm_div = mean_agg ? (float)N : normalization_factor;
  int rc;
  cudaError_t ce;
  for (int b0 = 0; b0 < B; b0 += G) {
    const int Bg = min(G, B - b0);
    const int acc = b0 > 0;
    const int M = Bg * N;
    const size_t off = (size_t)b0 * N;
    const float *hg = h + off * H, *xg = x + off * 3, *x0g = x0 + off * 3, *mg = mask + off;
    const float* gxg = gx + off * 3;
    float* dhg = dh + off * H;
    if ((rc = clear_pair_grads(sc, (size_t)M * N, s))) return rc;
    if ((ce = cudaMemsetAsync(dhg, 0, (size_t)M * H * sizeof(float), s))) return (int)ce;
    if ((rc = launch_projection<5>(hg, w[0], 2 * H + E, sc.proj, M, H, s))) return rc;
    EdgeBwdArgs eb = bwd_args(sc, xg, x0g, mg, w, N, H, E, sin_emb, norm_div, norm_constant);
    eb.use_tanh = use_tanh; eb.coords_range = coords_range;
    eb.w_out = w[4]; eb.gx = gxg;
    if ((rc = launch_rows_bwd<true>(eb, Bg, s))) return rc;
    const Dims d = {Bg, N, H, E, 2 * H + E, norm_div};
    if ((rc = stage_grads(d, hg, w[0], g[0], g[1], g[2], g[3], g[4], nullptr, sc, dhg, acc, s)))
      return rc;
    coord_grad_kernel<true><<<(M + 127) / 128, 128, 0, s>>>(
        xg, x0g, mg, gxg, sc.dcd, sc.dr, sc.dr0, dx + off * 3, dx0 + off * 3, M, N,
        norm_constant);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  return 0;
}

}  // extern "C"
