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
//      split-K GEMM on the tensor cores (wgrad_tc_kernel, 3xTF32, 128x128
//      tiles, partials summed in split order) over the two edge buffers the
//      tile kernel wrote. Per-CTA partials of the [H, H] gradient would write
//      and read 256 KB per 64 edges; the buffers cost 2 x 1 KB per edge;
//   4. the node-side products (dW1's src/dst columns, the node MLP, dh) on
//      #1/#2's 3xTF32 node GEMM (node_gemm, split-K for the weight
//      gradients, splits summed in order), and the shared passes of
//      egnn_bwd_common.cuh: row reductions, and a coordinate pass that
//      turns the antisymmetric pair gradients into dx_i = sum_j (G_ij - G_ji)
//      and dx0 likewise.
// The split-TF32 products keep f32's accuracy (egnn_block.cu explains why);
// tests/test_torch_port_block_precision.py emulates them against float64.

#include "egnn_block_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// Edge-stage backward over one tile: CTA (ti, b), HP threads.
// ---------------------------------------------------------------------------

template <int HP, bool COORD>
__global__ void __launch_bounds__(HP, TileCfg<HP>::kMinBlocks) edge_tile_bwd_kernel(TileArgs a) {
  using C = TileCfg<HP>;
  constexpr int ld = C::kLdA;
  using T = TileEdges<HP>;
  float* As = tile_smem;  // silu(pre), then mm, then d(mm), then d(pre)
  float* Wb = As + kTileRows * ld;
  const float *ef = T::ef(), *em = T::em(), *cd = T::cd();
  float *rs = T::rs(), *rs2 = T::rs2();
  const int *ei = T::ei(), *ej = T::ej();
  const int H = a.H, N = a.N, E = a.E;
  const int c = threadIdx.x, lane = c & 31, warp = c >> 5;
  const int b = blockIdx.y, ti = blockIdx.x, i0 = ti * a.R;
  const int nrows = min(a.R, N - i0), mrows = nrows * N;
  // Formed where used, so that they are not held across the products: the
  // edge index of tile edge e is edge0() + e; the tile's row of partials.
  auto edge0 = [&]() { return ((size_t)blockIdx.y * N + i0) * N; };
  auto prow = [&]() { return ((size_t)blockIdx.y * a.T + blockIdx.x) * (3 + E) * H; };

  // 1. Geometry and silu(pre), also written out for the W2 gradient.
  tile_geometry<HP>(a, b, i0, 0, N, mrows);
  __syncthreads();
  build_edge_tile<HP>(a, As, b, i0, mrows, a.abuf);
  __syncthreads();

  // 2. Second layer: mm = silu(pre) W2^T + b2.
  {
    float acc[2][8][4];
    tile_product<HP, false>(As, Wb, a.w2, H, mrows, acc);
    store_acc<HP, false>(As, acc, a.b2, H);
  }
  __syncthreads();

  // 3. Per-edge scalars: one warp per edge (two at a time) sums the gate /
  //    coordinate logit sum_c m[c] w_out[c] and, for the gate,
  //    sum_c d(m')[c] m[c].
  if (COORD || a.attention) {
    const float inv_div = 1.f / a.norm_div;
    const float* dagg_b = COORD ? nullptr : a.dagg + (size_t)b * N * H;  // molecule b's rows
    for (int e = warp; e < mrows; e += 2 * C::kWarps) {
      const int e2 = e + C::kWarps < mrows ? e + C::kWarps : e;
      float s[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll 4
      for (int k = lane; k < H; k += 32) {
        const float w = __ldg(a.w_out + k);
        const float m = tile_silu(As[e * ld + k]), m2 = tile_silu(As[e2 * ld + k]);
        s[0] = fmaf(m, w, s[0]);
        s[1] = fmaf(m2, w, s[1]);
        if (!COORD) {
          s2[0] = fmaf(m, __ldg(dagg_b + ei[e] * H + k) * inv_div, s2[0]);
          s2[1] = fmaf(m2, __ldg(dagg_b + ei[e2] * H + k) * inv_div, s2[1]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s[u] = warp_sum(s[u]);
        if (!COORD) s2[u] = warp_sum(s2[u]);
      }
      if (lane < 2 && (lane == 0 || e2 != e)) {  // lane u keeps edge u's sums
        rs[lane ? e2 : e] = lane ? s[1] : s[0];
        rs2[lane ? e2 : e] = lane ? s2[1] : s2[0];
      }
    }
    __syncthreads();
    // One thread per edge turns the sums into the edge's scalars.
    for (int e = c; e < mrows; e += C::kThreads) {
      if (COORD) {
        // s_ij = tanh(l) * range; ds_ij = em (daggx . cd); dcd = daggx s em.
        const size_t rr = (size_t)b * N + ei[e];
        const float mi = a.mask[rr];
        float daggx[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) daggx[q] = a.gx[rr * 3 + q] * mi / a.norm_div;
        const float l = rs[e];
        const float th = tanhf(l);
        const float scale = a.use_tanh ? th * a.coords_range : l;
        const float dotc = daggx[0] * cd[e * 3] + daggx[1] * cd[e * 3 + 1] +
                           daggx[2] * cd[e * 3 + 2];
        const float ds = em[e] * dotc;
#pragma unroll
        for (int q = 0; q < 3; ++q) a.dcd[(edge0() + e) * 3 + q] = daggx[q] * scale * em[e];
        rs2[e] = a.use_tanh ? ds * a.coords_range * (1.f - th * th) : ds;
      } else {
        // gate g = sigmoid(l + ba); q = g (1 - g) em (dagg . m).
        const float g = sigmoid_f(rs[e] + a.b_out[0]);
        rs[e] = g;
        rs2[e] = g * (1.f - g) * em[e] * rs2[e];
      }
    }
    __syncthreads();
  }

  // 4. d(mm) into As and dbuf; this tile's partials of db2, dw_out, db_out.
  //    kBatch edges at a time: loads, then arithmetic, then stores.
  if (c < H) {
    const float inv_div = 1.f / a.norm_div;
    const float* dagg_b = COORD ? nullptr : a.dagg + (size_t)b * N * H;
    const float wo = (COORD || a.attention) ? a.w_out[c] : 0.f;
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
        if (COORD) {
          dm = rs2[e] * wo;
          dwo = fmaf(rs2[e], m, dwo);
        } else if (a.attention) {
          dm = dg[q] * em[e] * rs[e] + rs2[e] * wo;
          dwo = fmaf(rs2[e], m, dwo);
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

  // 5. d(silu(pre)) = d(mm) W2.
  {
    float acc[2][8][4];
    tile_product<HP, true>(As, Wb, a.w2, H, mrows, acc);
    store_acc<HP, false>(As, acc, nullptr, H);
  }
  __syncthreads();

  // 6. d(pre) = d(silu(pre)) silu'(pre) into As; row sums, the tile's column
  //    sums and its edge-feature partials dWe[f][c] = sum_e ef[e][f] d(pre)[e][c].
  if (c < H) {
    float we[kMaxEdgeFeat];
    edge_feat_weights(a, c, we);
    const float bias1 = a.b1[c];
    float rsum = 0.f;
    for (int e0 = 0; e0 < mrows; e0 += kBatch) {
      float pre[kBatch], da[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) da[q] = As[(e0 + q) * ld + c];
      edge_pre_batch<HP>(a, we, bias1, b, e0, c, pre);
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
      for (int e = 0; e < mrows; ++e) s = fmaf(ef[e * kMaxEdgeFeat + f], As[e * ld + c], s);
      a.part[prow() + (3 + f) * H + c] = s;
    }
    Wb[c] = we[0];
    Wb[HP + c] = we[1];
  }

  // 7. Squared-distance features (not sin, whose features carry no
  //    gradient): dr_ij += sum_c d(pre)[c] We[c][0], dr0 with We[c][1]; one
  //    warp per edge, two at a time.
  if (!a.sin_emb) {
    __syncthreads();
    for (int e = warp; e < mrows; e += 2 * C::kWarps) {
      const int e2 = e + C::kWarps < mrows ? e + C::kWarps : e;
      float s[2] = {0.f, 0.f}, s0[2] = {0.f, 0.f};
#pragma unroll 4
      for (int k = lane; k < H; k += 32) {
        const float dp = As[e * ld + k], dp2 = As[e2 * ld + k];
        s[0] = fmaf(dp, Wb[k], s[0]);
        s0[0] = fmaf(dp, Wb[HP + k], s0[0]);
        s[1] = fmaf(dp2, Wb[k], s[1]);
        s0[1] = fmaf(dp2, Wb[HP + k], s0[1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s[u] = warp_sum(s[u]);
        s0[u] = warp_sum(s0[u]);
      }
      if (lane == 0) {
        const size_t e0 = edge0();
        a.dr[e0 + e] += s[0];
        a.dr0[e0 + e] += s0[0];
        if (e2 != e) {
          a.dr[e0 + e2] += s[1];
          a.dr0[e0 + e2] += s0[1];
        }
      }
    }
  }
}

template <bool COORD>
int launch_edge_tile_bwd(const TileArgs& a, int B, cudaStream_t s) {
  const dim3 grid(a.T, B);
  if (a.H <= 64) return launch_tile<64>(edge_tile_bwd_kernel<64, COORD>, grid, a, s);
  if (a.H <= 128) return launch_tile<128>(edge_tile_bwd_kernel<128, COORD>, grid, a, s);
  if (a.H <= 256) return launch_tile<256>(edge_tile_bwd_kernel<256, COORD>, grid, a, s);
  return launch_tile<512>(edge_tile_bwd_kernel<512, COORD>, grid, a, s);
}

// ---------------------------------------------------------------------------
// W2 gradient on the tensor cores: out[z][m][n] = sum over the edges e of
// split z of d[e][m] a[e][n] (m, n < H), both operands [Me, H] row-major,
// so each is K-outer: a 16-edge chunk of each streams into shared memory
// with cp.async (two stages, one barrier a chunk), 8 warps in a 2 x 4 grid of 64x32 register
// tiles, 3xTF32 as in the edge tiles. The splits are summed in order by
// splitk_reduce_kernel.
// ---------------------------------------------------------------------------

constexpr int kWgTile = 128, kWgKC = 16, kWgLd = kWgTile + 8, kWgMaxSplits = 64;

__global__ void __launch_bounds__(256) wgrad_tc_kernel(const float* d, const float* a, int Me,
                                                       int H, int kchunk, float* out) {
  __shared__ __align__(16) float Ds[2][kWgKC * kWgLd];
  __shared__ __align__(16) float Bs[2][kWgKC * kWgLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kWgTile, n0 = blockIdx.x * kWgTile;
  const int e_beg = blockIdx.z * kchunk, e_end = min(Me, e_beg + kchunk);
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  auto load = [&](int st, int k0) {
    for (int idx = tid; idx < kWgKC * (kWgTile / 4); idx += 256) {
      const int kk = idx / (kWgTile / 4), q = idx % (kWgTile / 4);
      const int e = k0 + kk;
      const bool okm = e < e_end && m0 + 4 * q < H, okn = e < e_end && n0 + 4 * q < H;
      cp_async16(&Ds[st][kk * kWgLd + 4 * q], okm ? d + (size_t)e * H + m0 + 4 * q : d, okm);
      cp_async16(&Bs[st][kk * kWgLd + 4 * q], okn ? a + (size_t)e * H + n0 + 4 * q : a, okn);
    }
    cp_async_commit();
  };
  const int nch = (e_end - e_beg + kWgKC - 1) / kWgKC;
  if (nch > 0) load(0, e_beg);
  for (int ck = 0; ck < nch; ++ck) {
    const int st = ck & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ck landed for all; all are done with chunk ck - 1
    if (ck + 1 < nch) load(st ^ 1, e_beg + (ck + 1) * kWgKC);
#pragma unroll
    for (int kk = 0; kk < kWgKC; kk += 8) {
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float* dr = &Ds[st][(kk + t) * kWgLd + wm * 64 + mi * 16 + g];
        split_tf32(dr[0], ahi[mi][0], alo[mi][0]);
        split_tf32(dr[8], ahi[mi][1], alo[mi][1]);
        split_tf32(dr[4 * kWgLd], ahi[mi][2], alo[mi][2]);
        split_tf32(dr[4 * kWgLd + 8], ahi[mi][3], alo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* br = &Bs[st][(kk + t) * kWgLd + wn * 32 + ni * 8 + g];
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(br[0], bh0, bl0);
        split_tf32(br[4 * kWgLd], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_3xtf32(acc[mi][ni], ahi[mi], alo[mi], bh0, bh1, bl0, bl1);
      }
    }
  }
  float* o = out + (size_t)blockIdx.z * H * H;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm * 64 + mi * 16 + g + (q >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + ni * 8 + 2 * t + (q & 1);
        if (m < H && n < H) o[(size_t)m * H + n] = acc[mi][ni][q];
      }
}

// Splits of the W2 gradient over Me edges: about two CTAs per SM.
int wgrad_splits(int Me, int H, int* kchunk) {
  const int tiles = ((H + kWgTile - 1) / kWgTile) * ((H + kWgTile - 1) / kWgTile);
  int splits = 256 / tiles;
  splits = splits < 1 ? 1 : (splits > kWgMaxSplits ? kWgMaxSplits : splits);
  int kc = (Me + splits - 1) / splits;
  kc = (kc + kWgKC - 1) / kWgKC * kWgKC;
  *kchunk = kc;
  return (Me + kc - 1) / kc;
}

// gw2[m][n] = sum_e dbuf[e][m] abuf[e][n]; wsplit holds the split partials.
int wgrad_tc(const float* dbuf, const float* abuf, int Me, int H, float* gw2, float* wsplit,
             cudaStream_t s) {
  int kchunk;
  const int splits = wgrad_splits(Me, H, &kchunk);
  const int nt = (H + kWgTile - 1) / kWgTile;
  wgrad_tc_kernel<<<dim3(nt, nt, splits), 256, 0, s>>>(dbuf, abuf, Me, H, kchunk, wsplit);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  splitk_reduce_kernel<<<(H * H + 255) / 256, 256, 0, s>>>(wsplit, splits, H, H, gw2, H, 0);
  return (int)cudaGetLastError();
}

// colsum[b, j, c] = sum over the T tiles of molecule b of colpart[b, t, j, c].
__global__ void tile_column_sum_kernel(const float* colpart, float* colsum, int T, int N, int H) {
  const int bj = blockIdx.x;  // b * N + j
  const int b = bj / N, j = bj % N;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += colpart[(((size_t)b * T + t) * N + j) * H + c];
    colsum[(size_t)bj * H + c] = s;
  }
}

// C (+)= A B on the node GEMM (egnn_block_tile.cuh) with gemm()'s arguments
// (egnn_bwd_common.cuh): ta, A stored [K][M]; tb, B stored [N][K]. K is
// split when the output has few tiles (the weight gradients, K = B*N), the
// splits summed in order.
int node_gemm(const float* a, int lda, int ta, const float* b, int ldb, int tb, float* c, int ldc,
              int M, int N, int K, int accumulate, const SplitBuf& sb, cudaStream_t s) {
  const int tiles = ((M + kNgTM - 1) / kNgTM) * ((N + kNgTN - 1) / kNgTN);
  int splits = 1;
  if (tiles < 200 && K >= 256) {
    splits = (K + 127) / 128;
    if (splits > kMaxSplits) splits = kMaxSplits;
    if ((size_t)splits * M * N > sb.cap) splits = 1;
  }
  int kchunk = (K + splits - 1) / splits;
  kchunk = (kchunk + kNgKC - 1) / kNgKC * kNgKC;
  splits = (K + kchunk - 1) / kchunk;
  NodeGemm g = {};
  g.a1 = a; g.lda1 = lda; g.k1 = K; g.ta = ta;
  g.b = b; g.ldb = ldb; g.tb = tb;
  g.M = M; g.N = N; g.K = K; g.kchunk = kchunk; g.epilogue = kEpiNone;
  if (splits == 1) {
    g.c = c; g.ldc = ldc; g.accumulate = accumulate;
    return launch_node_gemm(g, 1, s);
  }
  g.c = sb.buf; g.ldc = N; g.split_stride = (size_t)M * N;
  int rc = launch_node_gemm(g, splits, s);
  if (rc) return rc;
  splitk_reduce_kernel<<<(M * N + 255) / 256, 256, 0, s>>>(sb.buf, splits, M, N, c, ldc,
                                                           accumulate);
  return (int)cudaGetLastError();
}

// Node MLP backward of one GCL on the node GEMM: node_mlp_backward's
// contract (egnn_bwd_common.cuh) with acc 0.
int tile_node_mlp_backward(const float* dout, const float* mask, const float* hin,
                           const float* agg, const float* z, const float* u,
                           const float* const* w, float* const* g, float* dtmp, float* dagg,
                           float* dh, int M, int H, const SplitBuf& sb, cudaStream_t s) {
  const int nblk = (M * H + 255) / 256;
  int rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(dout, mask, dtmp, M, H);  // d(upd)
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = reduce_rows(dtmp, M, H, H, g[9], 1, 0, s))) return rc;
  if ((rc = node_gemm(dtmp, H, 1, u, H, 0, g[8], H, H, H, M, 0, sb, s))) return rc;
  if ((rc = node_gemm(dtmp, H, 0, w[8], H, 0, dagg, H, M, H, H, 0, sb, s)))
    return rc;  // d(u), in dagg for now
  dsilu_mul_kernel<<<nblk, 256, 0, s>>>(dagg, z, dtmp, M * H);  // d(z)
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = reduce_rows(dtmp, M, H, H, g[7], 1, 0, s))) return rc;
  if ((rc = node_gemm(dtmp, H, 1, hin, H, 0, g[6], 2 * H, H, H, M, 0, sb, s))) return rc;
  if ((rc = node_gemm(dtmp, H, 1, agg, H, 0, g[6] + H, 2 * H, H, H, M, 0, sb, s))) return rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(dout, mask, dh, M, H);  // residual path
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = node_gemm(dtmp, H, 0, w[6], 2 * H, 0, dh, H, M, H, H, 1, sb, s))) return rc;
  return node_gemm(dtmp, H, 0, w[6] + H, 2 * H, 0, dagg, H, M, H, H, 0, sb, s);
}

// Scratch layout, in floats (M = B*N node rows, Me = B*N*N edge rows, P =
// B*T tiles). act ([4, n_gcl, M, H], the forward chain's activations) only
// when the backward recomputes them.
struct TileScratch {
  float *act, *proj, *abuf, *dbuf, *colpart, *rowsum, *colsum, *dcur, *dnext, *dagg, *dtmp,
      *part, *dr, *dr0, *dcd, *wsplit;
  SplitBuf split;
};

size_t scratch_layout(int B, int N, int H, int E, int n_gcl, int recompute, float* base,
                      TileScratch* s) {
  const size_t M = (size_t)B * N, Me = M * N, P = (size_t)B * tiles_per_molecule(N);
  int kchunk;
  const size_t wsplits = (size_t)wgrad_splits((int)Me, H, &kchunk);
  const size_t sizes[] = {
      recompute ? 4 * (size_t)n_gcl * M * H : 0, M * 2 * H, Me * H, Me * H, P * N * H,
      M * H, M * H, M * H, M * H, M * H, M * H, P * (3 + E) * H, Me, Me, Me * 3,
      wsplits * H * H, (size_t)kMaxSplits * H * H};
  float** ptrs[] = {&s->act, &s->proj, &s->abuf, &s->dbuf, &s->colpart, &s->rowsum,
                    &s->colsum, &s->dcur, &s->dnext, &s->dagg, &s->dtmp, &s->part, &s->dr,
                    &s->dr0, &s->dcd, &s->wsplit, &s->split.buf};
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
int tile_stage_grads(const BlockShape& d, const float* hin, const float* w1, float* gw1,
                     float* gb1, float* gw2, float* gb2, float* gwo, float* gbo,
                     const TileScratch& sc, float* dh_acc, cudaStream_t s) {
  const int M = d.B * d.N, H = d.H, Me = M * d.N, ld1 = 2 * H + d.E;
  const int T = tiles_per_molecule(d.N), P = d.B * T, ps = (3 + d.E) * H;
  int rc;
  if ((rc = wgrad_tc(sc.dbuf, sc.abuf, Me, H, gw2, sc.wsplit, s))) return rc;
  if ((rc = reduce_rows(sc.part, P, ps, H, gb2, 1, 0, s))) return rc;
  if (gwo && (rc = reduce_rows(sc.part + H, P, ps, H, gwo, 1, 0, s))) return rc;
  if (gbo && (rc = reduce_rows(sc.part + 2 * H, P, ps, 1, gbo, 1, 0, s))) return rc;
  // W1: src columns from the row sums, dst columns from the column sums,
  // edge-feature columns from the per-tile partials; b1 from the row sums.
  tile_column_sum_kernel<<<M, 256, 0, s>>>(sc.colpart, sc.colsum, T, d.N, H);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = node_gemm(sc.rowsum, H, 1, hin, H, 0, gw1, ld1, H, H, M, 0, sc.split, s))) return rc;
  if ((rc = node_gemm(sc.colsum, H, 1, hin, H, 0, gw1 + H, ld1, H, H, M, 0, sc.split, s))) return rc;
  for (int e = 0; e < d.E; ++e)
    if ((rc = reduce_rows(sc.part + (3 + e) * H, P, ps, H, gw1 + 2 * H + e, ld1, 0, s)))
      return rc;
  if ((rc = reduce_rows(sc.rowsum, M, H, H, gb1, 1, 0, s))) return rc;
  // dh += rowsum W1[:, :H] + colsum W1[:, H:2H].
  if ((rc = node_gemm(sc.rowsum, H, 0, w1, ld1, 0, dh_acc, H, M, H, H, 1, sc.split, s))) return rc;
  return node_gemm(sc.colsum, H, 0, w1 + H, ld1, 0, dh_acc, H, M, H, H, 1, sc.split, s);
}

}  // namespace

extern "C" {

const char* egnn_block_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of device scratch egnn_block_backward needs for these shapes;
// recompute 0 when the caller passes the forward's saved activations.
size_t egnn_block_backward_scratch_floats(int B, int N, int H, int E, int n_gcl, int recompute) {
  TileScratch s;
  return scratch_layout(B, N, H, E, n_gcl, recompute, nullptr, &s);
}

// gcl_w / coord_w: weight pointers in egnn_block_forward's order; gcl_g /
// coord_g: gradient outputs in the same order (att_mlp entries null without
// attention); every gradient is overwritten. saved: the forward's
// activations ([4, n_gcl, B*N, H], egnn_block_forward's save) or null to
// recompute them. scratch: a device buffer of
// egnn_block_backward_scratch_floats(..., saved == null) floats. Returns a
// cudaError_t value.
int egnn_block_backward(const float* h, const float* x, const float* x0, const float* mask,
                        const float* gh, const float* gx, float* dh, float* dx, float* dx0,
                        const void* const* gcl_w, const void* const* coord_w,
                        void* const* gcl_g, void* const* coord_g, const float* saved,
                        float* scratch, int B, int N, int H, int E, int n_gcl, int attention,
                        int sin_emb, int use_tanh, int mean_agg, float coords_range,
                        float norm_constant, float normalization_factor, void* stream) {
  if (B < 1 || N < 1 || N > kMaxNodes || H < 32 || H > kMaxHidden || H % 32 ||
      E < 2 || E > kMaxEdgeFeat || n_gcl < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TileScratch sc;
  scratch_layout(B, N, H, E, n_gcl, saved == nullptr, scratch, &sc);
  const int M = B * N;
  const size_t Me = (size_t)M * N, MH = (size_t)M * H, plane = (size_t)n_gcl * MH;
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
    if ((rc = block_forward_chain(d, h, x, x0, mask, nullptr, nullptr, sc.proj, nullptr, nullptr,
                                  sc.act, gcl_w, coord_w, false, s)))
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
  if ((rc = node_projection(hc, cw[0], eb.ld1, sc.proj, M, H, s))) return rc;
  eb.w1 = cw[0]; eb.b1 = cw[1]; eb.w2 = cw[2]; eb.b2 = cw[3]; eb.w_out = cw[4];
  eb.b_out = nullptr; eb.dagg = nullptr; eb.gx = gx;
  if ((rc = launch_edge_tile_bwd<true>(eb, B, s))) return rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(gh, mask, sc.dcur, M, H);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = tile_stage_grads(d, hc, cw[0], cg[0], cg[1], cg[2], cg[3], cg[4], nullptr, sc,
                             sc.dcur, s)))
    return rc;

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
    if ((rc = tile_node_mlp_backward(dcur, mask, hin, agg, zs + (size_t)gi * MH,
                                     us + (size_t)gi * MH, w, g, sc.dtmp, sc.dagg, dnext, M, H,
                                     sc.split, s)))
      return rc;
    // Edge stage.
    if ((rc = node_projection(hin, w[0], eb.ld1, sc.proj, M, H, s))) return rc;
    eb.w1 = w[0]; eb.b1 = w[1]; eb.w2 = w[2]; eb.b2 = w[3]; eb.w_out = w[4];
    eb.b_out = w[5]; eb.dagg = sc.dagg; eb.gx = nullptr;
    if ((rc = launch_edge_tile_bwd<false>(eb, B, s))) return rc;
    if ((rc = tile_stage_grads(d, hin, w[0], g[0], g[1], g[2], g[3], attention ? g[4] : nullptr,
                               attention ? g[5] : nullptr, sc, dnext, s)))
      return rc;
    float* t = dcur; dcur = dnext; dnext = t;
  }
  if ((ce = cudaMemcpyAsync(dh, dcur, MH * sizeof(float), cudaMemcpyDeviceToDevice, s)))
    return (int)ce;

  // 4. Coordinates.
  coord_grad_kernel<true><<<(M + 127) / 128, 128, 0, s>>>(x, x0, mask, gx, sc.dcd, sc.dr,
                                                          sc.dr0, dx, dx0, M, N, norm_constant);
  return (int)cudaGetLastError();
}

}  // extern "C"
