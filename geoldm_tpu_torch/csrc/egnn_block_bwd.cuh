// Device code of the whole-molecule backward (#2): the edge-stage tile
// kernel, the scratch layout and the backward's sequence of launches, in
// f32, bf16 (BF16) and low-precision (LOWP, with BF16) variants. Its entry
// points are in egnn_block_bwd.cu (f32, bf16) and egnn_block_bwd_lowp.cu,
// which instantiate only their own variants; egnn_block_bwd.cu explains the
// design.

#pragma once

#include "egnn_block_tile.cuh"
#include "egnn_bwd_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Edge-stage backward over one tile: CTA (ti, b), HP threads.
// ---------------------------------------------------------------------------

template <int HP, bool COORD, bool BF16 = false, bool LOWP = false>
__global__ void __launch_bounds__(HP, TileCfg<HP>::kMinBlocks) edge_tile_bwd_kernel(TileArgs a) {
  using C = TileCfg<HP>;
  constexpr int ld = C::kLdA;
  using T = TileEdges<HP>;
  float* As = tile_smem;  // silu(pre), then mm, then d(mm), then d(pre)
  float* Wb = As + kTileRows * ld;
  const float *ef = T::ef(), *em = T::em();
  float *rs = T::rs(), *rs2 = T::rs2();
  const int *ei = T::ei(), *ej = T::ej();
  const int H = a.H, N = a.N, E = a.E;
  const int c = threadIdx.x;
  const int b = blockIdx.y, ti = blockIdx.x, i0 = ti * a.R;
  const int nrows = min(a.R, N - i0), mrows = nrows * N;
  // Formed where used, so that they are not held across the products: the
  // edge index of tile edge e is edge0() + e; the tile's row of partials.
  auto edge0 = [&]() { return ((size_t)blockIdx.y * N + i0) * N; };
  auto prow = [&]() { return ((size_t)blockIdx.y * a.T + blockIdx.x) * (3 + E) * H; };

  // 1. Geometry and silu(pre), also written out for the W2 gradient.
  tile_geometry<HP>(a, b, i0, 0, N, mrows);
  __syncthreads();
  build_edge_tile<HP, false, BF16, LOWP>(a, As, b, mrows, a.abuf + edge0() * H);
  __syncthreads();

  // 2. Second layer: mm = silu(pre) W2^T + b2 (LOWP: t = bf16(mm) + bf16(b2)
  //    in bf16).
  {
    float acc[2][8][4];
    if constexpr (BF16) tile_product_bf16<HP>(As, Wb, a.w2bf, H, mrows, acc);
    else tile_product<HP, false>(As, Wb, a.w2, H, mrows, acc);
    store_acc<HP, false, false, LOWP>(As, acc, a.b2, H);
  }
  __syncthreads();

  // 3. Per-edge scalars: the gate's or the coordinate scale's backward.
  if (COORD || a.attention) edge_scalars_bwd<HP, COORD, BF16, LOWP>(a, As, b, mrows);

  // 4. d(mm) into As and dbuf; this tile's partials of db2, dw_out, db_out.
  //    kBatch edges at a time: loads, then arithmetic, then stores. BF16:
  //    the gate's or scale's product on bf16 m and w_out, the gradient it
  //    returns to m rounded.
  if (c < H) {
    const float inv_div = 1.f / a.norm_div;
    const float* dagg_b = COORD ? nullptr : a.dagg + (size_t)b * N * H;
    const float wo = (COORD || a.attention) ? operand<BF16>(a.w_out[c]) : 0.f;
    float* db = a.dbuf + edge0() * H + c;  // tile edge 0, channel c
    float db2 = 0.f, dwo = 0.f, dbo = 0.f;
    for (int e0 = 0; e0 < mrows; e0 += kBatch) {
      float mm[kBatch], dg[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = e0 + q;
        mm[q] = As[e * ld + c];
        if constexpr (LOWP) dg[q] = COORD ? 0.f : __ldg(dagg_b + ei[e] * H + c) / a.norm_div;
        else dg[q] = COORD ? 0.f : __ldg(dagg_b + ei[e] * H + c) * inv_div;
      }
      if constexpr (LOWP) {
        // mm[q] holds t; m = lowp_silu(t). The cotangent of m: that of the
        // gated message bf16(dg em) times the gate, and the gate product's
        // bf16(rs2 wo), summed in bf16; then through lowp_dsilu to t's.
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int e = e0 + q;
          const float m = lowp_silu(mm[q]);
          float dm;
          if (COORD) {
            dm = bf16_round(rs2[e] * wo);
            dwo = fmaf(rs2[e], m, dwo);
          } else if (a.attention) {
            dm = bf16_round(bf16_round(bf16_round(dg[q] * em[e]) * rs[e]) +
                            bf16_round(rs2[e] * wo));
            dwo = fmaf(rs2[e], m, dwo);
            dbo += rs2[e];
          } else {
            dm = bf16_round(dg[q] * em[e]);
          }
          mm[q] = e < mrows ? lowp_dsilu(mm[q], dm) : 0.f;
          db2 += mm[q];
        }
      } else {
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
            dm = dg[q] * em[e] * rs[e] + operand<BF16>(rs2[e] * wo);
            dwo = fmaf(rs2[e], operand<BF16>(m), dwo);
            dbo += rs2[e];
          } else {
            dm = dg[q] * em[e];
          }
          mm[q] = e < mrows ? dm * (sg * (1.f + mm[q] * (1.f - sg))) : 0.f;  // dm silu'(mm)
          db2 += mm[q];
        }
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
    float* part = a.part + prow() + c;
    part[0] = db2;
    part[H] = dwo;
    part[2 * H] = c == 0 ? dbo : 0.f;
  }
  __syncthreads();

  // 5. d(silu(pre)) = d(mm) W2 (BF16: d(mm) f32 against bf16 W2, rounded).
  {
    float acc[2][8][4];
    tile_product<HP, true, BF16>(As, Wb, a.w2, H, mrows, acc);
    store_acc<HP, false, BF16>(As, acc, nullptr, H);
  }
  __syncthreads();

  // 6. d(pre) = d(silu(pre)) silu'(pre) into As; row sums, the tile's column
  //    sums and its edge-feature partials dWe[f][c] = sum_e ef[e][f] d(pre)[e][c]
  //    (BF16: on the bf16 ef, as the forward's; LOWP: through the bf16
  //    silu of bf16(pre), lowp_dsilu).
  if (c < H) {
    float we[kMaxEdgeFeat];
    edge_feat_weights<BF16>(a, c, we);
    const float bias1 = a.b1[c];
    float rsum = 0.f;
    for (int e0 = 0; e0 < mrows; e0 += kBatch) {
      float pre[kBatch], da[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) da[q] = As[(e0 + q) * ld + c];
      edge_pre_batch<HP, false, BF16>(a, we, bias1, b, e0, c, pre);
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if constexpr (LOWP) da[q] = lowp_dsilu(bf16_round(pre[q]), da[q]);
        else da[q] *= tile_dsilu(pre[q]);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = e0 + q;
        if (e < mrows) {
          As[e * ld + c] = da[q];
          rsum += da[q];
          if (ej[e] == N - 1) {  // the row's last column
            a.rowsum[((size_t)b * N + ei[e]) * H + c] = rsum;
            rsum = 0.f;
          }
        }
      }
    }
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
      float cs = 0.f;
      for (int r = 0; r < nrows; ++r) cs += As[(r * N + j) * ld + c];
      a.colpart[(((size_t)b * a.T + ti) * N + j) * H + c] = cs;
    }
    for (int f = 0; f < E; ++f) {
      float s = 0.f;
#pragma unroll 8
      for (int e = 0; e < mrows; ++e)
        s = fmaf(operand<BF16>(ef[e * kMaxEdgeFeat + f]), As[e * ld + c], s);
      a.part[prow() + (3 + f) * H + c] = s;
    }
    Wb[c] = we[0];
    Wb[HP + c] = we[1];
  }

  // 7. Squared-distance features (not sin).
  if (!a.sin_emb) {
    __syncthreads();
    edge_dist_grads<HP, BF16>(a, As, Wb, b, mrows);
  }
}

template <bool COORD, bool BF16 = false, bool LOWP = false>
int launch_edge_tile_bwd(const TileArgs& a, int B, cudaStream_t s) {
  const dim3 grid(a.T, B);
  if (a.H <= 64)
    return launch_tile<64>(edge_tile_bwd_kernel<64, COORD, BF16, LOWP>, grid, a, s);
  if (a.H <= 128)
    return launch_tile<128>(edge_tile_bwd_kernel<128, COORD, BF16, LOWP>, grid, a, s);
  if (a.H <= 256)
    return launch_tile<256>(edge_tile_bwd_kernel<256, COORD, BF16, LOWP>, grid, a, s);
  return launch_tile<512>(edge_tile_bwd_kernel<512, COORD, BF16, LOWP>, grid, a, s);
}

// Scratch layout, in floats (M = B*N node rows, Me = B*N*N edge rows, P =
// B*T tiles). act ([4, n_gcl, M, H], the forward chain's activations) only
// when the backward recomputes them; w2bf, the bf16 variant's (n_gcl + 1)
// bf16 copies of W2 ([H, H] each, H*H/2 floats), only for it.
struct TileScratch : EdgeGradBufs {
  float *act, *proj, *dcur, *dnext, *dagg, *dtmp, *dr, *dr0, *dcd, *w2bf;
};

size_t scratch_layout(int B, int N, int H, int E, int n_gcl, int recompute, int bf16,
                      float* base, TileScratch* s) {
  const size_t M = (size_t)B * N, Me = M * N, P = (size_t)B * tiles_per_molecule(N);
  int kchunk;
  const size_t wsplits = (size_t)wgrad_splits((int)Me, H, &kchunk);
  const size_t sizes[] = {
      recompute ? 4 * (size_t)n_gcl * M * H : 0, M * 2 * H, Me * H, Me * H, P * N * H,
      M * H, M * H, M * H, M * H, M * H, M * H, P * (3 + E) * H, Me, Me, Me * 3,
      wsplits * H * H, bf16 ? (size_t)(n_gcl + 1) * H * H / 2 : 0,
      (size_t)kMaxSplits * H * H};
  float** ptrs[] = {&s->act, &s->proj, &s->abuf, &s->dbuf, &s->colpart, &s->rowsum,
                    &s->colsum, &s->dcur, &s->dnext, &s->dagg, &s->dtmp, &s->part, &s->dr,
                    &s->dr0, &s->dcd, &s->wsplit, &s->w2bf, &s->split.buf};
  s->split.cap = sizes[sizeof(sizes) / sizeof(sizes[0]) - 1];
  size_t off = 0;
  for (int k = 0; k < (int)(sizeof(sizes) / sizeof(sizes[0])); ++k) {
    if (base) *ptrs[k] = base + off;
    off += (sizes[k] + 63) / 64 * 64;  // 256-byte aligned pieces
  }
  return off;
}

// Gradients of one edge stage's weights and of its input h (added to
// dh_acc), after its edge_tile_bwd_kernel ran.
template <bool BF16>
int tile_stage_grads(const BlockShape& d, const float* hin, const float* w1, float* gw1,
                     float* gb1, float* gw2, float* gb2, float* gwo, float* gbo,
                     const TileScratch& sc, float* dh_acc, cudaStream_t s) {
  const Dims dims = {d.B, d.N, d.H, d.E, 2 * d.H + d.E, d.N, tiles_per_molecule(d.N)};
  return stage_grads<BF16>(dims, hin, hin, w1, gw1, gb1, gw2, gb2, gwo, gbo, sc, dh_acc, dh_acc,
                           0, s);
}

// The backward (egnn_block_backward's contract); BF16: the bf16 variant;
// LOWP (with BF16): the low-precision one.
template <bool BF16, bool LOWP = false>
int block_backward(const float* h, const float* x, const float* x0, const float* mask,
                   const float* gh, const float* gx, float* dh, float* dx, float* dx0,
                   const void* const* gcl_w, const void* const* coord_w, void* const* gcl_g,
                   void* const* coord_g, const float* saved, float* scratch, int B, int N, int H,
                   int E, int n_gcl, int attention, int sin_emb, int use_tanh, int mean_agg,
                   float coords_range, float norm_constant, float normalization_factor,
                   void* stream) {
  if (B < 1 || N < 1 || N > kMaxNodes || H < 32 || H > kMaxHidden || H % 32 ||
      E < 2 || E > kMaxEdgeFeat || n_gcl < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TileScratch sc;
  scratch_layout(B, N, H, E, n_gcl, saved == nullptr, BF16, scratch, &sc);
  const int M = B * N;
  const size_t Me = (size_t)M * N, MH = (size_t)M * H, plane = (size_t)n_gcl * MH;
  const size_t w2words = (size_t)H * H / 2;
  uint32_t* w2bf = reinterpret_cast<uint32_t*>(sc.w2bf);
  const BlockShape d = {B, N, H, E, n_gcl, attention, sin_emb, use_tanh, coords_range,
                        norm_constant, mean_agg ? (float)N : normalization_factor};
  const int nblk = (int)((MH + 255) / 256);
  int rc;
  cudaError_t ce;
  if ((ce = cudaMemsetAsync(sc.dr, 0, Me * sizeof(float), s))) return (int)ce;
  if ((ce = cudaMemsetAsync(sc.dr0, 0, Me * sizeof(float), s))) return (int)ce;
  if ((ce = cudaMemsetAsync(sc.dcd, 0, Me * 3 * sizeof(float), s))) return (int)ce;

  // 1. The forward chain's activations: saved, or recomputed by its own code.
  const float* act = saved;
  if (!act) {
    if ((rc = block_forward_chain<BF16, LOWP>(d, h, x, x0, mask, nullptr, nullptr, sc.proj,
                                              nullptr, nullptr, sc.act, gcl_w, coord_w, false, s,
                                              w2bf)))
      return rc;
    act = sc.act;
  }
  const float *hs = act, *aggs = act + plane, *zs = act + 2 * plane, *us = act + 3 * plane;
  const float* hc = hs + (size_t)(n_gcl - 1) * MH;

  TileArgs eb = tile_args(d, x, x0, mask, sc.proj);
  eb.abuf = sc.abuf; eb.dbuf = sc.dbuf; eb.rowsum = sc.rowsum; eb.colpart = sc.colpart;
  eb.part = sc.part; eb.dr = sc.dr; eb.dr0 = sc.dr0; eb.dcd = sc.dcd;

  // 2. Coordinate update: dL/dh_n = gh * mask + its edge stage's share.
  const float* const* cw = reinterpret_cast<const float* const*>(coord_w);
  float* const* cg = reinterpret_cast<float* const*>(coord_g);
  if ((rc = node_projection<BF16>(hc, M, hc, M, cw[0], eb.ld1, sc.proj, H, s))) return rc;
  eb.w1 = cw[0]; eb.b1 = cw[1]; eb.w2 = cw[2]; eb.b2 = cw[3]; eb.w_out = cw[4];
  eb.b_out = nullptr; eb.dagg = nullptr; eb.gx = gx;
  if constexpr (BF16) {
    eb.w2bf = w2bf + n_gcl * w2words;
    if ((rc = to_bf16(cw[2], w2bf + n_gcl * w2words, H * H, s))) return rc;
  }
  if ((rc = launch_edge_tile_bwd<true, BF16, LOWP>(eb, B, s))) return rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(gh, mask, sc.dcur, M, H);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = tile_stage_grads<BF16>(d, hc, cw[0], cg[0], cg[1], cg[2], cg[3], cg[4], nullptr, sc,
                                   sc.dcur, s)))
    return rc;
  if (BF16 && (rc = round_weight_grads(cg, true, H, E, s, LOWP))) return rc;

  // 3. GCLs in reverse. dcur = dL/d(output of GCL gi).
  const float* const* gw = reinterpret_cast<const float* const*>(gcl_w);
  float* const* gg = reinterpret_cast<float* const*>(gcl_g);
  float *dcur = sc.dcur, *dnext = sc.dnext;
  for (int gi = n_gcl - 1; gi >= 0; --gi) {
    const float* const* w = gw + 10 * gi;
    float* const* g = gg + 10 * gi;
    const float* hin = gi == 0 ? h : hs + (size_t)(gi - 1) * MH;
    const float* agg = aggs + (size_t)gi * MH;
    // Node MLP: out = (hin + silu([hin, agg] Wn1^T + bn1) Wn2^T + bn2) * mask.
    if ((rc = node_mlp_backward<BF16>(dcur, mask, hin, agg, zs + (size_t)gi * MH,
                                      us + (size_t)gi * MH, w, g, sc.dtmp, sc.dagg, dnext, M, H,
                                      0, sc.split, s)))
      return rc;
    // Edge stage.
    if ((rc = node_projection<BF16>(hin, M, hin, M, w[0], eb.ld1, sc.proj, H, s))) return rc;
    eb.w1 = w[0]; eb.b1 = w[1]; eb.w2 = w[2]; eb.b2 = w[3]; eb.w_out = w[4];
    eb.b_out = w[5]; eb.dagg = sc.dagg; eb.gx = nullptr;
    if constexpr (BF16) {
      eb.w2bf = w2bf + gi * w2words;
      if ((rc = to_bf16(w[2], w2bf + gi * w2words, H * H, s))) return rc;
    }
    if ((rc = launch_edge_tile_bwd<false, BF16, LOWP>(eb, B, s))) return rc;
    if ((rc = tile_stage_grads<BF16>(d, hin, w[0], g[0], g[1], g[2], g[3],
                                     attention ? g[4] : nullptr, attention ? g[5] : nullptr, sc,
                                     dnext, s)))
      return rc;
    if (BF16 && (rc = round_weight_grads(g, false, H, E, s, LOWP))) return rc;
    float* t = dcur; dcur = dnext; dnext = t;
  }
  if ((ce = cudaMemcpyAsync(dh, dcur, MH * sizeof(float), cudaMemcpyDeviceToDevice, s)))
    return (int)ce;

  // 4. Coordinates.
  coord_grad_kernel<true><<<(M + 127) / 128, 128, 0, s>>>(x, x0, mask, gx, sc.dcd, sc.dr,
                                                          sc.dr0, dx, dx0, M, N, norm_constant);
  return (int)cudaGetLastError();
}

}  // namespace

