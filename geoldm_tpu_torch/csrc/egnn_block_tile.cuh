// Device code of the whole-molecule EquivariantBlock kernels (#1 forward in
// egnn_block.cu, #2 backward in egnn_block_bwd.cu): the multi-row edge tile
// (on egnn_tile.cuh's tile machinery), the forward edge stages and the
// forward chain both libraries run on the tensor-core node GEMM of
// egnn_tc_gemm.cuh (the backward recomputes with it, so a recomputed
// activation equals the forward's saved one bit for bit), the bf16
// variant of both (BF16: every forward product on bf16 operands) and the
// low-precision one (LOWP, with BF16: the edge chain in bf16 too,
// egnn_block_lowp.cu). See egnn_block.cu for the design and what bounds it
// on an H100.

#pragma once

#include <stdint.h>

#include "egnn_tc_gemm.cuh"

namespace {

int tile_rows(int N) { return N >= kTileRows ? 1 : kTileRows / N; }
int tiles_per_molecule(int N) { const int r = tile_rows(N); return (N + r - 1) / r; }

// One forward edge stage over a tile: the GCL's aggregate of rows i0 ...
// (COORD false) or their coordinate update; BF16: on bf16 operands, W2 from
// its bf16 copy a.w2bf; LOWP (with BF16): the edge chain in bf16.
template <int HP, bool COORD, bool BF16 = false, bool LOWP = false>
__global__ void __launch_bounds__(HP, TileCfg<HP>::kMinBlocks) edge_tile_kernel(TileArgs a) {
  using C = TileCfg<HP>;
  float* As = tile_smem;
  float* Wb = As + kTileRows * C::kLdA;
  const int H = a.H, N = a.N;
  const int c = threadIdx.x;
  const int b = blockIdx.y, i0 = blockIdx.x * a.R;
  const int nrows = min(a.R, N - i0), mrows = nrows * N;

  tile_geometry<HP>(a, b, i0, 0, N, mrows);
  __syncthreads();
  build_edge_tile<HP, false, BF16, LOWP>(a, As, b, mrows, nullptr);
  __syncthreads();
  // m = silu(silu(pre) W2^T + b2).
  {
    float acc[2][8][4];
    if constexpr (BF16) tile_product_bf16<HP>(As, Wb, a.w2bf, H, mrows, acc);
    else tile_product<HP, false>(As, Wb, a.w2, H, mrows, acc);
    store_acc<HP, true, false, LOWP>(As, acc, a.b2, H);
  }
  __syncthreads();
  if (COORD || a.attention) edge_scalars<HP, COORD, BF16, LOWP>(a, As, mrows);
  if (!COORD) {
    if (c < H) {
      for (int r = 0; r < nrows; ++r)
        a.agg[((size_t)b * N + i0 + r) * H + c] =
            fold_messages<HP, LOWP>(a, As, r * N, N, c, 0.f) / a.norm_div;
    }
  } else {
    for (int q = c; q < nrows * 3; q += C::kThreads) {
      const int r = q / 3, d = q % 3;
      const float aggx = fold_coords<HP>(r * N, N, d, 0.f);
      const size_t row = (size_t)b * N + i0 + r;
      a.x_out[row * 3 + d] = (a.x[row * 3 + d] + aggx / a.norm_div) * a.mask[row];
    }
  }
}

template <bool COORD, bool BF16 = false, bool LOWP = false>
int launch_edge_tile(const TileArgs& a, int B, cudaStream_t s) {
  const dim3 grid(a.T, B);
  if (a.H <= 64) return launch_tile<64>(edge_tile_kernel<64, COORD, BF16, LOWP>, grid, a, s);
  if (a.H <= 128) return launch_tile<128>(edge_tile_kernel<128, COORD, BF16, LOWP>, grid, a, s);
  if (a.H <= 256) return launch_tile<256>(edge_tile_kernel<256, COORD, BF16, LOWP>, grid, a, s);
  return launch_tile<512>(edge_tile_kernel<512, COORD, BF16, LOWP>, grid, a, s);
}

// ---------------------------------------------------------------------------
// The forward chain, shared by the forward and the backward's recompute.
// ---------------------------------------------------------------------------

struct BlockShape {
  int B, N, H, E, n_gcl;
  int attention, sin_emb, use_tanh;
  float coords_range, norm_constant, norm_div;
};

TileArgs tile_args(const BlockShape& d, const float* x, const float* x0, const float* mask,
                   const float* proj) {
  TileArgs a = {};
  a.proj = proj; a.x = x; a.x0 = x0; a.mask = mask;
  a.xr = x; a.x0r = x0; a.maskr = mask; a.row0 = 0; a.S = d.N;
  a.ld1 = 2 * d.H + d.E; a.N = d.N; a.H = d.H; a.E = d.E;
  a.R = tile_rows(d.N); a.T = tiles_per_molecule(d.N);
  a.sin_emb = d.sin_emb; a.attention = d.attention; a.use_tanh = d.use_tanh;
  a.coords_range = d.coords_range; a.norm_constant = d.norm_constant; a.norm_div = d.norm_div;
  return a;
}

// The block's forward on stream s. save (or null): [4][n_gcl][B*N, H], each
// GCL's output h, aggregate, node-MLP pre-activation z and silu(z), which
// the backward reads; h_out is then a copy of the last GCL's output. With
// save null, agg and hidden ([B*N, H] scratch) hold the aggregate and silu(z)
// and h_out is written in place from the second GCL on. coord false skips
// the coordinate stage (x_out unread). proj: [B*N, 2H] scratch. BF16: every
// product on bf16 operands (the bf16 variant; with save, the chain its
// backward reads); w2bf holds (n_gcl + 1) [H, H] bf16 copies of the W2s,
// converted here, once a call. LOWP (with BF16): the edge stages' chain in
// bf16 (the low-precision variant; the node chain is the bf16 one's).
template <bool BF16 = false, bool LOWP = false>
int block_forward_chain(const BlockShape& d, const float* h, const float* x, const float* x0,
                        const float* mask, float* h_out, float* x_out, float* proj, float* agg,
                        float* hidden, float* save, const void* const* gcl_w,
                        const void* const* coord_w, bool coord, cudaStream_t s,
                        uint32_t* w2bf = nullptr) {
  const int M = d.B * d.N, H = d.H, ld1 = 2 * H + d.E;
  const size_t MH = (size_t)M * H, plane = (size_t)d.n_gcl * MH;
  const size_t w2words = (size_t)H * H / 2;
  TileArgs ea = tile_args(d, x, x0, mask, proj);
  const float* hc = h;
  int rc;
  for (int gi = 0; gi < d.n_gcl; ++gi) {
    const float* const* w = reinterpret_cast<const float* const*>(gcl_w) + 10 * gi;
    float* hn = save ? save + gi * MH : h_out;
    float* ag = save ? save + plane + gi * MH : agg;
    float* z = save ? save + 2 * plane + gi * MH : nullptr;
    float* u = save ? save + 3 * plane + gi * MH : hidden;
    if ((rc = node_projection<BF16>(hc, M, hc, M, w[0], ld1, proj, H, s))) return rc;
    ea.w1 = w[0]; ea.b1 = w[1]; ea.w2 = w[2]; ea.b2 = w[3];
    ea.w_out = w[4]; ea.b_out = w[5]; ea.agg = ag; ea.x_out = nullptr;
    if constexpr (BF16) {
      ea.w2bf = w2bf + gi * w2words;
      if ((rc = to_bf16(w[2], w2bf + gi * w2words, H * H, s))) return rc;
    }
    if ((rc = launch_edge_tile<false, BF16, LOWP>(ea, d.B, s))) return rc;

    // u = silu([h, agg] Wn1^T + bn1): fused, or through z when saved (the
    // same bits: silu of the stored f32 z).
    if ((rc = node_linear<BF16>(hc, ag, w[6], 2 * H, w[7], save ? kEpiNone : kEpiSilu, nullptr,
                                nullptr, save ? z : u, H, M, H, s)))
      return rc;
    if (save) {
      silu_kernel<<<(int)((MH + 255) / 256), 256, 0, s>>>(z, u, (int)MH);
      if ((rc = (int)cudaGetLastError())) return rc;
    }
    // In place for gi > 0 without save: each output element reads only its
    // own residual.
    if ((rc = node_linear<BF16>(u, nullptr, w[8], H, w[9], kEpiResidMask, hc, mask, hn, H, M, H,
                                s)))
      return rc;
    hc = hn;
  }
  if (save && h_out) {
    cudaError_t ce = cudaMemcpyAsync(h_out, hc, MH * sizeof(float), cudaMemcpyDeviceToDevice, s);
    if (ce != cudaSuccess) return (int)ce;
  }
  if (!coord) return 0;
  const float* const* cw = reinterpret_cast<const float* const*>(coord_w);
  if ((rc = node_projection<BF16>(hc, M, hc, M, cw[0], ld1, proj, H, s))) return rc;
  ea.w1 = cw[0]; ea.b1 = cw[1]; ea.w2 = cw[2]; ea.b2 = cw[3];
  ea.w_out = cw[4]; ea.b_out = nullptr; ea.agg = nullptr; ea.x_out = x_out;
  if constexpr (BF16) {
    ea.w2bf = w2bf + d.n_gcl * w2words;
    if ((rc = to_bf16(cw[2], w2bf + d.n_gcl * w2words, H * H, s))) return rc;
  }
  return launch_edge_tile<true, BF16, LOWP>(ea, d.B, s);
}

}  // namespace
