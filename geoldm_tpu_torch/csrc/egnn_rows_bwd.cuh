// The row-tiled stage backward, shared by the single-device stages
// (egnn_tiled_bwd.cu, TPU kernel #5, whose header comment gives the design)
// and the sequence-parallel slab stages (egnn_sp.cu, TPU kernel #7): the edge
// grid rows_bwd_tile_kernel on the tile of egnn_tile.cuh, the scratch layout,
// the coordinate passes and the host loop rows_backward, all over a row
// window (egnn_rows.cuh). A single-device stage is the window of every row
// with the slab's views aliasing the full ones, and its gradients of both
// views are summed; an SP stage keeps the full-view gradients [B*N, *] apart
// from the slab's [B*S, *].

#pragma once

#include "egnn_bwd_common.cuh"
#include "egnn_rows.cuh"

namespace {

// The stage backward's edge grid: CTA (s, b) owns slab row s of molecule b
// (global row row0 + s) and walks its N columns in windows of kTileRows, each
// a 64-edge-row tile of egnn_tile.cuh, as the forward grid (rows_tile_kernel)
// does. Per window: silu(pre) rebuilt (written to abuf), the second layer
// and the transposed product d(mm) W2 on the tensor cores (split TF32), the
// gate or coordinate scale and their gradients one warp per edge, d(mm)
// (written to dbuf) and d(pre) (written to colpart, the CTA's column
// partials: with one row per CTA they are the d(pre) row itself), and the
// squared-distance gradients dr, dr0 one warp per edge (not sin). The CTA's
// own rows of rowsum (sum_j d(pre): the src projection, b1) and part (db2,
// the gate or scale weight and bias, the edge-feature columns of W1) start
// at zero and gain each window's sums in window order; nothing but the loop
// counters lives across the products. A window whose edge mask is all zero
// adds exactly zero: it writes zeros where the passes after the grid read
// (abuf, dbuf, colpart; dr, dr0 and dcd are cleared before the grid) and is
// skipped. Each CTA writes only its own row's entries: no atomics. BF16:
// the bf16 variant, with the rounding sites of #2's (egnn_block_bwd.cu):
// the second layer on bf16 operands (W2 from a.w2bf), the transposed
// product on the f32 d(mm) against bf16 W2 and rounded, the gate's or
// scale's product and the edge features on bf16 operands, and the
// gradients those products return to bf16 operands rounded.
template <int HP, bool COORD, bool BF16 = false>
__global__ void __launch_bounds__(HP, TileCfg<HP>::kMinBlocks) rows_bwd_tile_kernel(TileArgs a) {
  using C = TileCfg<HP>;
  using T = TileEdges<HP>;
  constexpr int ld = C::kLdA;
  float* As = tile_smem;  // silu(pre), then mm, then d(mm), then d(silu(pre)), then d(pre)
  float* Wb = As + kTileRows * ld;
  const int H = a.H, N = a.N, E = a.E, ps = (3 + E) * H;
  // Formed where used, so that they are not held across the products: this
  // CTA's row of the slab's views, and the edge index of its column j.
  auto row = [&]() { return (size_t)blockIdx.y * a.S + blockIdx.x; };
  auto edge = [&](int j) { return row() * N + j; };
  if (tile_tid() < H) {
    float* part = a.part + row() * ps + tile_tid();
    for (int k = 0; k < 3 + E; ++k) part[k * H] = 0.f;
    a.rowsum[row() * H + tile_tid()] = 0.f;
  }
  for (int j0 = 0; j0 < N; j0 += kTileRows) {
    const int mrows = min(kTileRows, N - j0);
    tile_geometry<HP>(a, blockIdx.y, blockIdx.x, j0, kTileRows, mrows);
    // The geometry's barrier (thread e wrote edge e, HP >= kTileRows).
    if (!__syncthreads_or(tile_tid() < kTileRows && T::em()[tile_tid()] != 0.f)) {
      const int c = tile_tid();
      if (c < H) {
        for (int e = 0; e < mrows; ++e) {
          const size_t k = edge(j0 + e) * H + c;
          a.abuf[k] = 0.f;
          a.dbuf[k] = 0.f;
          a.colpart[k] = 0.f;
        }
      }
      continue;
    }

    // 1. silu(pre), also written out for the W2 gradient.
    build_edge_tile<HP, true, BF16>(a, As, blockIdx.y, mrows, a.abuf + edge(j0) * H);
    __syncthreads();

    // 2. Second layer: mm = silu(pre) W2^T + b2.
    {
      float acc[2][8][4];
      if constexpr (BF16) tile_product_bf16<HP>(As, Wb, a.w2bf, H, mrows, acc);
      else tile_product<HP, false>(As, Wb, a.w2, H, mrows, acc);
      store_acc<HP, false>(As, acc, a.b2, H);
    }
    __syncthreads();

    // 3. Per-edge scalars: the gate's or the coordinate scale's backward.
    if (COORD || a.attention) edge_scalars_bwd<HP, COORD, BF16>(a, As, blockIdx.y, mrows);

    // 4. d(mm) into As and dbuf; the window's db2, dw_out and db_out added
    //    to the CTA's partials. kBatch edges at a time: loads, then
    //    arithmetic, then stores.
    if (tile_tid() < H) {
      const int c = tile_tid();
      const float *em = T::em(), *rs = T::rs(), *rs2 = T::rs2();
      const float dg = COORD ? 0.f : a.dagg[row() * H + c] * (1.f / a.norm_div);
      const float wo = (COORD || a.attention) ? operand<BF16>(a.w_out[c]) : 0.f;
      float* db = a.dbuf + edge(j0) * H + c;  // window edge 0, channel c
      float db2 = 0.f, dwo = 0.f, dbo = 0.f;
      for (int e0 = 0; e0 < mrows; e0 += kBatch) {
        float mm[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) mm[q] = As[(e0 + q) * ld + c];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int e = e0 + q;
          const float sg = tile_sigmoid(mm[q]);
          const float m = mm[q] * sg;
          float dm;
          // BF16: the product's operand m rounded, the gradient it returns to m too.
          if (COORD) {
            dm = operand<BF16>(rs2[e] * wo);
            dwo = fmaf(rs2[e], operand<BF16>(m), dwo);
          } else if (a.attention) {
            dm = dg * em[e] * rs[e] + operand<BF16>(rs2[e] * wo);
            dwo = fmaf(rs2[e], operand<BF16>(m), dwo);
            dbo += rs2[e];
          } else {
            dm = dg * em[e];
          }
          mm[q] = e < mrows ? dm * (sg * (1.f + mm[q] * (1.f - sg))) : 0.f;  // dm silu'(mm)
          db2 += mm[q];
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int e = e0 + q;
          if (e < mrows) {
            As[e * ld + c] = mm[q];
            db[e * H] = mm[q];
          }
        }
      }
      float* part = a.part + row() * ps + c;
      part[0] += db2;
      part[H] += dwo;
      if (c == 0) part[2 * H] += dbo;
    }
    __syncthreads();

    // 5. d(silu(pre)) = d(mm) W2 (BF16: d(mm) f32 against bf16 W2, rounded).
    {
      float acc[2][8][4];
      tile_product<HP, true, BF16>(As, Wb, a.w2, H, mrows, acc);
      store_acc<HP, false, BF16>(As, acc, nullptr, H);
    }
    __syncthreads();

    // 6. d(pre) = d(silu(pre)) silu'(pre) into As and colpart; the window's
    //    row sum and edge-feature partials dWe[f][c] = sum_e ef[e][f]
    //    d(pre)[e][c] added to the CTA's.
    if (tile_tid() < H) {
      const int c = tile_tid();
      float we[kMaxEdgeFeat];
      edge_feat_weights<BF16>(a, c, we);
      const float bias1 = a.b1[c];
      float* cp = a.colpart + edge(j0) * H + c;
      float rsum = 0.f;
      for (int e0 = 0; e0 < mrows; e0 += kBatch) {
        float pre[kBatch], da[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) da[q] = As[(e0 + q) * ld + c];
        edge_pre_batch<HP, true, BF16>(a, we, bias1, blockIdx.y, e0, c, pre);
#pragma unroll
        for (int q = 0; q < kBatch; ++q) da[q] *= tile_dsilu(pre[q]);
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int e = e0 + q;
          if (e < mrows) {
            As[e * ld + c] = da[q];
            cp[e * H] = da[q];
            rsum += da[q];
          }
        }
      }
      a.rowsum[row() * H + c] += rsum;
      float* part = a.part + row() * ps + c;
      const float* ef = T::ef();
      for (int f = 0; f < E; ++f) {
        float s = 0.f;
#pragma unroll 8
        for (int e = 0; e < mrows; ++e)
          s = fmaf(operand<BF16>(ef[e * kMaxEdgeFeat + f]), As[e * ld + c], s);
        part[(3 + f) * H] += s;
      }
      Wb[c] = we[0];
      Wb[HP + c] = we[1];
    }

    // 7. Squared-distance features (not sin; dr, dr0 were cleared).
    if (!a.sin_emb) {
      __syncthreads();
      edge_dist_grads<HP, BF16>(a, As, Wb, blockIdx.y, mrows);
    }
    __syncthreads();  // the next window overwrites the tile
  }
}

// The stage backward's edge grid over a's row window: S x B CTAs of HP
// threads.
template <bool COORD, bool BF16 = false>
int launch_rows_bwd(const TileArgs& a, int B, cudaStream_t s) {
  const dim3 grid(a.S, B);
  if (a.H <= 64) return launch_tile<64>(rows_bwd_tile_kernel<64, COORD, BF16>, grid, a, s);
  if (a.H <= 128) return launch_tile<128>(rows_bwd_tile_kernel<128, COORD, BF16>, grid, a, s);
  if (a.H <= 256) return launch_tile<256>(rows_bwd_tile_kernel<256, COORD, BF16>, grid, a, s);
  return launch_tile<512>(rows_bwd_tile_kernel<512, COORD, BF16>, grid, a, s);
}

// Scratch of one group of G molecules, in floats: node-sized pieces for M =
// G*N rows (the src projection, the node chain, the row sums and the
// per-CTA partials use the first G*S of them), edge-sized ones for Me =
// G*S*N pairs, the split-K partials of the W2 gradient and of the node GEMM,
// and (bf16) the bf16 copy of W2.
struct RowsScratch : EdgeGradBufs {
  float *proj, *agg, *z, *u, *dtmp, *dagg, *dr, *dr0, *dcd, *w2bf;
};

size_t rows_scratch_layout(int G, int S, int N, int H, int E, int bf16, float* base,
                           RowsScratch* s) {
  const size_t M = (size_t)G * N, Me = (size_t)G * S * N;
  int kchunk;
  const size_t wsplits = (size_t)wgrad_splits((int)Me, H, &kchunk);
  const size_t sizes[] = {M * 2 * H, M * H, M * H, M * H, M * H, M * H, M * H, M * H,
                          (size_t)G * S * (3 + E) * H, Me * H, Me * H, Me * H, Me, Me, Me * 3,
                          wsplits * H * H, bf16 ? (size_t)H * H / 2 : 0,
                          (size_t)kMaxSplits * H * H};
  float** ptrs[] = {&s->proj, &s->agg, &s->z, &s->u, &s->dtmp, &s->dagg, &s->rowsum,
                    &s->colsum, &s->part, &s->abuf, &s->dbuf, &s->colpart, &s->dr, &s->dr0,
                    &s->dcd, &s->wsplit, &s->w2bf, &s->split.buf};
  s->split.cap = sizes[sizeof(sizes) / sizeof(sizes[0]) - 1];
  size_t off = 0;
  for (int k = 0; k < (int)(sizeof(sizes) / sizeof(sizes[0])); ++k) {
    if (base) *ptrs[k] = base + off;
    off += (sizes[k] + 63) / 64 * 64;  // 256-byte aligned pieces
  }
  return off;
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
// update); every gradient is overwritten. chain: a GCL's node chain over the
// slab, [3, B*S, H] (the aggregate, z and silu(z), as gcl_rows_host keeps
// them), or null to run it here with the same code (gcl_chain); both give
// the same bits. The molecules run in groups of G whose scratch is
// rows_scratch_layout(G, S, ...), each group's weight gradients added to the
// previous groups' in group order. BF16: the bf16 variant (the vjp of the
// bf16 forward, whose node chain it takes; egnn_block_bwd.cu gives its
// rounding sites), its weight gradients rounded to bf16 once, after the
// last group.
template <bool COORD, bool BF16 = false>
int rows_backward(bool whole, const float* h, const float* x, const float* x0,
                  const float* mask, const Slab& r, const float* gout, const float* chain,
                  const StageGrads& out, const float* const* w, float* const* g, float* scratch,
                  int B, int G, int N, int H, int E, int attention, int sin_emb, int use_tanh,
                  float coords_range, float norm_div, float norm_constant, cudaStream_t s) {
  const int S = r.S;
  RowsScratch sc;
  rows_scratch_layout(G, S, N, H, E, BF16, scratch, &sc);
  const size_t plane = (size_t)B * S * H;  // one tensor of the chain
  int rc;
  cudaError_t ce;
  if constexpr (BF16) {
    if ((rc = to_bf16(w[2], sc.w2bf, H * H, s))) return rc;
  }
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
    if ((rc = node_projection<BF16>(rg.h, Mr, hg, Mc, w[0], 2 * H + E, sc.proj, H, s))) return rc;
    TileArgs ea = stage_args(rg, xg, x0g, mg, sc.proj, w, N, H, E, sin_emb, norm_div,
                             norm_constant);
    if constexpr (BF16) ea.w2bf = reinterpret_cast<const uint32_t*>(sc.w2bf);
    if (!COORD) {
      // 1. The node chain (handed over, or run here), then the node MLP's
      //    backward, which gives the gradient of the aggregate.
      ea.attention = attention;
      ea.w_out = w[4]; ea.b_out = w[5];
      const float *agg = sc.agg, *z = sc.z, *u = sc.u;
      if (chain) {
        agg = chain + offr * H;
        z = agg + plane;
        u = z + plane;
      } else if ((rc = gcl_chain<BF16>(ea, rg.h, w, Bg, sc.agg, sc.z, sc.u, s))) {
        return rc;
      }
      if ((rc = node_mlp_backward<BF16>(gout + offr * H, rg.mask, rg.h, agg, z, u, w, g,
                                        sc.dtmp, sc.dagg, dhrg, Mr, H, acc, sc.split, s)))
        return rc;
      ea.dagg = sc.dagg;
    } else {
      ea.use_tanh = use_tanh; ea.coords_range = coords_range;
      ea.w_out = w[4]; ea.gx = gout + offr * 3;
    }
    // 2. The edge grid, then 3. the weight gradients, dh and the coordinates.
    ea.abuf = sc.abuf; ea.dbuf = sc.dbuf; ea.colpart = sc.colpart; ea.rowsum = sc.rowsum;
    ea.part = sc.part; ea.dr = sc.dr; ea.dr0 = sc.dr0; ea.dcd = sc.dcd;
    if ((rc = launch_rows_bwd<COORD, BF16>(ea, Bg, s))) return rc;
    const Dims d = {Bg, N, H, E, 2 * H + E, S, S};
    float* gwo = COORD || attention ? g[4] : nullptr;
    float* gbo = !COORD && attention ? g[5] : nullptr;
    if ((rc = stage_grads<BF16>(d, rg.h, hg, w[0], g[0], g[1], g[2], g[3], gwo, gbo, sc, dhrg,
                                dhg, acc, s)))
      return rc;
    const float* gxg = COORD ? gout + offr * 3 : nullptr;
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
  if constexpr (BF16) return round_weight_grads(g, COORD, H, E, s);
  return 0;
}

}  // namespace
