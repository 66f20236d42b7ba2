// One EGNN EquivariantBlock backward in f32 on Hopper (sm_90a).
//
// Replaces the TPU kernel geoldm_tpu/ops/pallas_egnn.py:_make_bwd_kernel
// (pallas_call at :507, via _fused_block_bwd_impl :485); this is a redesign
// for the H100 of the port's first, one-row-per-CTA version. Same function:
// from the block inputs (h, x, x0, node mask), the weights and the
// cotangents of (h_out, x_out) it returns dh, dx, the exact dx0 and every
// weight gradient summed over the batch. As in _sin_features (:96-105) the
// sin/cos distance features carry no gradient.
//
// What bounds it on an H100: per edge stage three edge products of
// 2*N^2*H^2 FLOP per molecule (the second layer rebuilt, the transposed
// product d(mm) W2 and the W2 gradient d(mm)^T silu(pre)), run as split
// TF32 (3 products each) against 495 TFLOP/s of dense TF32; the rest (first
// layer, activations, reductions, node GEMMs) against 67 TFLOP/s of f32. The
// two edge-sized buffers it writes and reads again (2 x 55 MB per stage at
// B=64, N=29, H=256) take well under 0.1 ms at 3.35 TB/s: the operation
// structure, not the bytes, bounds it.
//
// Design. The Pallas kernel differentiates the whole block in VMEM with an
// in-kernel jax.vjp and accumulates weight gradients across a sequential
// grid. A CUDA grid runs in parallel, so this version splits the work into
// stages that each own their outputs and reduces across CTAs in separate,
// fixed-order passes (no atomics: a seeded run replays bit for bit):
//   1. the node-level chain of the forward (each GCL's output h, aggregate,
//      node-MLP z and silu(z)): taken from the forward when the autograd
//      Function saved it, else recomputed by the forward's own code
//      (block_forward_chain), so both routes give the same bits;
//   2. per edge stage, in reverse (coordinate update, then GCL n-1 ... 0),
//      edge_tile_bwd_kernel on the forward's multi-row tiles
//      (egnn_block_tile.cuh: R = 64/N rows of one molecule per CTA, W2
//      streamed through shared memory with cp.async, 3xTF32 mma.sync). It
//      rebuilds the tile's silu(pre), runs the second layer on the tensor
//      cores, back-propagates through the gate or coordinate scale (one warp
//      per edge), runs the transposed product d(mm) W2 on the tensor cores,
//      and reduces d(pre) in shared memory: row sums (src projection, b1),
//      the tile's column sums (dst projection, summed over the N/R tiles in
//      a second pass instead of writing d(pre) out), per-tile partials (db2,
//      the gate / coordinate weight, the edge-feature columns of W1) and the
//      distance-feature gradients;
//   3. the W2 gradient, sum over all B*N*N edges of d(mm)^T silu(pre), as a
//      split-K GEMM on the tensor cores (wgrad_tc_kernel of egnn_tc_gemm.cuh,
//      3xTF32, 128x128 tiles, partials summed in split order) over the two
//      edge buffers the tile kernel wrote. Per-CTA partials of the [H, H]
//      gradient would write and read 256 KB per 64 edges; the buffers cost
//      2 x 1 KB per edge;
//   4. the node-side products (dW1's src/dst columns, the node MLP, dh) on
//      the 3xTF32 node GEMM of egnn_tc_gemm.cuh (node_gemm, split-K for the
//      weight gradients, splits summed in order), and the shared passes of
//      egnn_bwd_common.cuh (stage_grads, node_mlp_backward, which the
//      row-tiled backward runs too): row reductions, and a coordinate pass that
//      turns the antisymmetric pair gradients into dx_i = sum_j (G_ij - G_ji)
//      and dx0 likewise.
// The split-TF32 products keep f32's accuracy (egnn_block.cu explains why);
// tests/test_torch_port_block_precision.py emulates them against float64.
//
// The bf16 variant (egnn_block_backward_bf16; JAX's bfloat16 and
// bfloat16_pallas compute dtypes, the jax.vjp of _block_math with _matmul's
// bf16 operands) is the vjp of the bf16 forward (egnn_block_forward_bf16,
// whose saved chain it reads), site by site as the transpose of a bf16
// product returns it: the recomputed forward products on bf16 operands
// (tile_product_bf16, node GEMMs as the forward's); in each transposed
// product and weight gradient the cotangent stays f32 (split TF32) against
// the bf16 operand (rounded as read, exact in TF32: two mma.m16n8k8 a k8
// step where split TF32 takes three), and the result, the gradient of a
// bf16 operand, is rounded to bf16: d(silu(pre)) in the tile, the distance
// features' gradients, the node GEMMs' operand gradients in their
// epilogue, and every weight gradient once after its f32 sum over all
// edges and molecules (round_weight_grads). The elementwise passes (silu',
// gate, mask, the row and column sums, the coordinate chain) stay f32. A
// bf16 mma on a rounded cotangent would round a site the forward's vjp does
// not round. Its bound is the same FLOP: the recomputed products at the
// 989 TFLOP/s of dense bf16, the backward products as two TF32 products.

#include "egnn_block_tile.cuh"
#include "egnn_bwd_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Edge-stage backward over one tile: CTA (ti, b), HP threads.
// ---------------------------------------------------------------------------

template <int HP, bool COORD, bool BF16 = false>
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
  build_edge_tile<HP, false, BF16>(a, As, b, mrows, a.abuf + edge0() * H);
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
  if (COORD || a.attention) edge_scalars_bwd<HP, COORD, BF16>(a, As, b, mrows);

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
        dg[q] = COORD ? 0.f : __ldg(dagg_b + ei[e] * H + c) * inv_div;
      }
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
  //    (BF16: on the bf16 ef, as the forward's).
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
      for (int q = 0; q < kBatch; ++q) da[q] *= tile_dsilu(pre[q]);
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

template <bool COORD, bool BF16 = false>
int launch_edge_tile_bwd(const TileArgs& a, int B, cudaStream_t s) {
  const dim3 grid(a.T, B);
  if (a.H <= 64) return launch_tile<64>(edge_tile_bwd_kernel<64, COORD, BF16>, grid, a, s);
  if (a.H <= 128) return launch_tile<128>(edge_tile_bwd_kernel<128, COORD, BF16>, grid, a, s);
  if (a.H <= 256) return launch_tile<256>(edge_tile_bwd_kernel<256, COORD, BF16>, grid, a, s);
  return launch_tile<512>(edge_tile_bwd_kernel<512, COORD, BF16>, grid, a, s);
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

// The backward (egnn_block_backward's contract); BF16: the bf16 variant.
template <bool BF16>
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
    if ((rc = block_forward_chain<BF16>(d, h, x, x0, mask, nullptr, nullptr, sc.proj, nullptr,
                                        nullptr, sc.act, gcl_w, coord_w, false, s, w2bf)))
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
  if ((rc = node_projection<BF16>(hc, cw[0], eb.ld1, sc.proj, M, H, s))) return rc;
  eb.w1 = cw[0]; eb.b1 = cw[1]; eb.w2 = cw[2]; eb.b2 = cw[3]; eb.w_out = cw[4];
  eb.b_out = nullptr; eb.dagg = nullptr; eb.gx = gx;
  if constexpr (BF16) {
    eb.w2bf = w2bf + n_gcl * w2words;
    if ((rc = to_bf16(cw[2], w2bf + n_gcl * w2words, H * H, s))) return rc;
  }
  if ((rc = launch_edge_tile_bwd<true, BF16>(eb, B, s))) return rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(gh, mask, sc.dcur, M, H);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = tile_stage_grads<BF16>(d, hc, cw[0], cg[0], cg[1], cg[2], cg[3], cg[4], nullptr, sc,
                                   sc.dcur, s)))
    return rc;
  if (BF16 && (rc = round_weight_grads(cg, true, H, E, s))) return rc;

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
    if ((rc = node_projection<BF16>(hin, w[0], eb.ld1, sc.proj, M, H, s))) return rc;
    eb.w1 = w[0]; eb.b1 = w[1]; eb.w2 = w[2]; eb.b2 = w[3]; eb.w_out = w[4];
    eb.b_out = w[5]; eb.dagg = sc.dagg; eb.gx = nullptr;
    if constexpr (BF16) {
      eb.w2bf = w2bf + gi * w2words;
      if ((rc = to_bf16(w[2], w2bf + gi * w2words, H * H, s))) return rc;
    }
    if ((rc = launch_edge_tile_bwd<false, BF16>(eb, B, s))) return rc;
    if ((rc = tile_stage_grads<BF16>(d, hin, w[0], g[0], g[1], g[2], g[3],
                                     attention ? g[4] : nullptr, attention ? g[5] : nullptr, sc,
                                     dnext, s)))
      return rc;
    if (BF16 && (rc = round_weight_grads(g, false, H, E, s))) return rc;
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

extern "C" {

const char* egnn_block_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of device scratch egnn_block_backward (bf16 0) or
// egnn_block_backward_bf16 (bf16 1) needs for these shapes; recompute 0
// when the caller passes the forward's saved activations.
size_t egnn_block_backward_scratch_floats(int B, int N, int H, int E, int n_gcl, int recompute,
                                          int bf16) {
  TileScratch s;
  return scratch_layout(B, N, H, E, n_gcl, recompute, bf16, nullptr, &s);
}

// gcl_w / coord_w: weight pointers in egnn_block_forward's order; gcl_g /
// coord_g: gradient outputs in the same order (att_mlp entries null without
// attention); every gradient is overwritten. saved: the forward's
// activations ([4, n_gcl, B*N, H], egnn_block_forward's save) or null to
// recompute them. scratch: a device buffer of
// egnn_block_backward_scratch_floats(..., saved == null, 0) floats. Returns a
// cudaError_t value.
int egnn_block_backward(const float* h, const float* x, const float* x0, const float* mask,
                        const float* gh, const float* gx, float* dh, float* dx, float* dx0,
                        const void* const* gcl_w, const void* const* coord_w,
                        void* const* gcl_g, void* const* coord_g, const float* saved,
                        float* scratch, int B, int N, int H, int E, int n_gcl, int attention,
                        int sin_emb, int use_tanh, int mean_agg, float coords_range,
                        float norm_constant, float normalization_factor, void* stream) {
  return block_backward<false>(h, x, x0, mask, gh, gx, dh, dx, dx0, gcl_w, coord_w, gcl_g,
                               coord_g, saved, scratch, B, N, H, E, n_gcl, attention, sin_emb,
                               use_tanh, mean_agg, coords_range, norm_constant,
                               normalization_factor, stream);
}

// The bf16 variant: egnn_block_backward's arguments; saved from
// egnn_block_forward_bf16's save (or null: recomputed in bf16), scratch of
// egnn_block_backward_scratch_floats(..., saved == null, 1) floats.
int egnn_block_backward_bf16(const float* h, const float* x, const float* x0, const float* mask,
                             const float* gh, const float* gx, float* dh, float* dx, float* dx0,
                             const void* const* gcl_w, const void* const* coord_w,
                             void* const* gcl_g, void* const* coord_g, const float* saved,
                             float* scratch, int B, int N, int H, int E, int n_gcl,
                             int attention, int sin_emb, int use_tanh, int mean_agg,
                             float coords_range, float norm_constant,
                             float normalization_factor, void* stream) {
  return block_backward<true>(h, x, x0, mask, gh, gx, dh, dx, dx0, gcl_w, coord_w, gcl_g,
                              coord_g, saved, scratch, B, N, H, E, n_gcl, attention, sin_emb,
                              use_tanh, mean_agg, coords_range, norm_constant,
                              normalization_factor, stream);
}

}  // extern "C"
