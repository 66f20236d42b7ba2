// The row-tiled EquivariantBlock stages' forward (egnn_tiled.cu, TPU kernels
// #3 and #4): one CTA per (molecule, row), the columns walked in 64-column
// windows, each a tile of egnn_tile.cuh (split-TF32 tensor-core product, W2
// through cp.async stages); the node-side products on the node GEMM of
// egnn_tc_gemm.cuh, as #1's. Shared by egnn_tiled.cu, whose header comment
// gives the design, by the stage backward (egnn_rows_bwd.cuh, TPU kernels #5
// and #7), which runs a GCL's node chain with it when the caller hands over
// none, and by the sequence-parallel slab stages (egnn_sp.cu, TPU kernel #6).
//
// Row window: a stage computes the rows row0..row0+S of every molecule (its
// slab) against all N columns. The slab's own tensors are [B*S, *] views,
// apart from the [B*N, *] views of the columns; the diagonal is masked at the
// global row row0 + s, and 'mean' divides by the caller's divisor. The
// single-device stages (#3, #4, #5) pass the full view as the slab: row0 0,
// S = N, the same pointers, and the same arithmetic as a slab's.

#pragma once

#include "egnn_tc_gemm.cuh"

namespace {

// The largest N the card tests hold; beyond it a CTA's sequential walk over
// N/64 column windows is untested, not impossible.
constexpr int kMaxTiledNodes = 1024;

// The forward edge grid: CTA (s, b) owns slab row s of molecule b (global
// row row0 + s) and walks its N columns in windows of kTileRows, each a
// 64-edge-row tile of egnn_tile.cuh (the last one masked, its m16 tiles past
// the live edges skipped). The row's sums stay in registers across windows:
// channel c's aggregate (thread c, #3) or coordinate c's update (thread c <
// 3, #4), each added in column order. A window whose edge mask is all zero
// adds exactly zero and is skipped (padding columns, every window of a
// padding row). Each CTA writes only its own row. BF16: on bf16 operands,
// W2 from its bf16 copy a.w2bf (the bf16 variants of #3/#4).
template <int HP, bool COORD, bool BF16 = false>
__global__ void __launch_bounds__(HP, TileCfg<HP>::kMinBlocks) rows_tile_kernel(TileArgs a) {
  using C = TileCfg<HP>;
  float* As = tile_smem;
  float* Wb = As + kTileRows * C::kLdA;
  const int H = a.H, N = a.N;
  const int c = tile_tid(), b = blockIdx.y, s = blockIdx.x;
  float sum = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTileRows) {
    const int mrows = min(kTileRows, N - j0);
    tile_geometry<HP>(a, b, s, j0, kTileRows, mrows);
    // The geometry's barrier (thread e wrote edge e, HP >= kTileRows).
    if (!__syncthreads_or(c < kTileRows && TileEdges<HP>::em()[c] != 0.f)) continue;
    build_edge_tile<HP, true, BF16>(a, As, b, mrows, nullptr);
    __syncthreads();
    // m = silu(silu(pre) W2^T + b2).
    {
      float acc[2][8][4];
      if constexpr (BF16) tile_product_bf16<HP>(As, Wb, a.w2bf, H, mrows, acc);
      else tile_product<HP, false>(As, Wb, a.w2, H, mrows, acc);
      store_acc<HP, true>(As, acc, a.b2, H);
    }
    __syncthreads();
    if (COORD || a.attention) edge_scalars<HP, COORD, BF16>(a, As, mrows);
    if (!COORD) {
      if (c < H) sum = fold_messages<HP>(a, As, 0, mrows, c, sum);
    } else if (c < 3) {
      sum = fold_coords<HP>(0, mrows, c, sum);
    }
    __syncthreads();  // the next window overwrites the tile
  }
  const size_t row = (size_t)b * a.S + s;
  if (!COORD) {
    if (c < H) a.agg[row * H + c] = sum / a.norm_div;
  } else if (c < 3) {
    a.x_out[row * 3 + c] = (a.xr[row * 3 + c] + sum / a.norm_div) * a.maskr[row];
  }
}

// The forward edge grid over a's row window: S x B CTAs of HP threads.
template <bool COORD, bool BF16 = false>
int launch_rows(const TileArgs& a, int B, cudaStream_t s) {
  const dim3 grid(a.S, B);
  if (a.H <= 64) return launch_tile<64>(rows_tile_kernel<64, COORD, BF16>, grid, a, s);
  if (a.H <= 128) return launch_tile<128>(rows_tile_kernel<128, COORD, BF16>, grid, a, s);
  if (a.H <= 256) return launch_tile<256>(rows_tile_kernel<256, COORD, BF16>, grid, a, s);
  return launch_tile<512>(rows_tile_kernel<512, COORD, BF16>, grid, a, s);
}

bool bad_dims(int B, int N, int H, int E, int sin_emb) {
  return B < 1 || B > 65535 || N < 1 || N > kMaxTiledNodes || H < 32 || H > kMaxHidden ||
         H % 32 || E != (sin_emb ? kMaxEdgeFeat : 2);
}

// A stage's rows: the slab row0..row0+S of every molecule, h, x, x0 and mask
// at [B*S, *].
struct Slab {
  const float *h, *x, *x0, *mask;
  int row0, S;
};

bool bad_slab(const Slab& r, int N) {
  return r.row0 < 0 || r.S < 1 || r.row0 + r.S > N;
}

// Edge-grid arguments of a stage over slab r against the columns x, x0,
// mask [B*N, *]; proj holds the src projection of the slab's rows in its
// first H columns and the dst projection of all columns in the next H.
TileArgs stage_args(const Slab& r, const float* x, const float* x0, const float* mask,
                    float* proj, const float* const* w, int N, int H, int E, int sin_emb,
                    float norm_div, float norm_constant) {
  TileArgs ea = {};
  ea.proj = proj; ea.x = x; ea.x0 = x0; ea.mask = mask;
  ea.xr = r.x; ea.x0r = r.x0; ea.maskr = r.mask;
  ea.row0 = r.row0; ea.S = r.S;
  ea.w1 = w[0]; ea.ld1 = 2 * H + E; ea.b1 = w[1]; ea.w2 = w[2]; ea.b2 = w[3];
  ea.N = N; ea.H = H; ea.E = E; ea.sin_emb = sin_emb;
  ea.norm_constant = norm_constant;
  ea.norm_div = norm_div;
  return ea;
}

// A GCL's node chain over a slab whose h is hr, once proj holds its
// projections: the aggregate agg [B*S, H] (the edge grid; ea from stage_args
// with the GCL's weights), then u = silu([hr, agg] Wn1^T + bn1) [B*S, H],
// through z, the pre-activation, when z is given (the same bits: silu of the
// stored f32 z).
// The forward (gcl_rows_host) and the stage backward (egnn_rows_bwd.cuh) run
// this same code, so a chain the forward hands to the backward equals the
// backward's own recompute bit for bit. BF16: the bf16 variant (ea.w2bf
// set).
template <bool BF16 = false>
int gcl_chain(const TileArgs& ea, const float* hr, const float* const* w, int B, float* agg,
              float* z, float* u, cudaStream_t s) {
  const int Mr = B * ea.S, H = ea.H;
  TileArgs a = ea;
  a.agg = agg;
  int rc;
  if ((rc = launch_rows<false, BF16>(a, B, s))) return rc;
  if ((rc = node_linear<BF16>(hr, agg, w[6], 2 * H, w[7], z ? kEpiNone : kEpiSilu, nullptr,
                              nullptr, z ? z : u, H, Mr, H, s)))
    return rc;
  if (!z) return 0;
  silu_kernel<<<(Mr * H + 255) / 256, 256, 0, s>>>(z, u, Mr * H);
  return (int)cudaGetLastError();
}

// One GCL over slab r (kernel #3 with the full view as the slab, #6 over an
// SP slab): h_out [B*S, H] = (h_r + node_mlp([h_r, agg])) * m_r. w: the GCL's
// 10 weight pointers (egnn_gcl_rows' order). Scratch: proj [B*N, 2H], agg and
// hidden [B*S, H], and z [B*S, H] or null: with z, the node chain (agg, z,
// hidden = silu(z)) is kept for the stage backward. Enqueues 4 grids over
// the full view (5 with z), 5 over an SP slab, whose projections are two
// (6 with z). BF16: the bf16 variant, W2 converted into w2bf ([H, H] bf16)
// first: one grid more.
template <bool BF16 = false>
int gcl_rows_host(const float* h, const float* x, const float* x0, const float* mask,
                  const Slab& r, float* h_out, float* proj, float* agg, float* hidden, float* z,
                  const float* const* w, int B, int N, int H, int E, int attention,
                  int sin_emb, float norm_div, float norm_constant, cudaStream_t s,
                  uint32_t* w2bf = nullptr) {
  const int Mr = B * r.S;
  int rc;
  if ((rc = node_projection<BF16>(r.h, Mr, h, B * N, w[0], 2 * H + E, proj, H, s))) return rc;
  TileArgs ea = stage_args(r, x, x0, mask, proj, w, N, H, E, sin_emb, norm_div, norm_constant);
  ea.attention = attention;
  ea.w_out = w[4]; ea.b_out = w[5];
  if constexpr (BF16) {
    if ((rc = to_bf16(w[2], w2bf, H * H, s))) return rc;
    ea.w2bf = w2bf;
  }
  if ((rc = gcl_chain<BF16>(ea, r.h, w, B, agg, z, hidden, s))) return rc;
  return node_linear<BF16>(hidden, nullptr, w[8], H, w[9], kEpiResidMask, r.h, r.mask, h_out, H,
                           Mr, H, s);
}

// The coordinate update over slab r (#4 / #6): x_out [B*S, 3]. w: 5 weight
// pointers (egnn_coord_rows' order). Scratch: proj [B*N, 2H]. Enqueues 2
// grids over the full view, 3 over an SP slab (one more for BF16, the bf16
// variant, whose W2 is converted into w2bf first).
template <bool BF16 = false>
int coord_rows_host(const float* h, const float* x, const float* x0, const float* mask,
                    const Slab& r, float* x_out, float* proj, const float* const* w, int B,
                    int N, int H, int E, int sin_emb, int use_tanh, float coords_range,
                    float norm_div, float norm_constant, cudaStream_t s,
                    uint32_t* w2bf = nullptr) {
  int rc;
  if ((rc = node_projection<BF16>(r.h, B * r.S, h, B * N, w[0], 2 * H + E, proj, H, s)))
    return rc;
  TileArgs ea = stage_args(r, x, x0, mask, proj, w, N, H, E, sin_emb, norm_div, norm_constant);
  ea.use_tanh = use_tanh; ea.coords_range = coords_range;
  ea.w_out = w[4]; ea.x_out = x_out;
  if constexpr (BF16) {
    if ((rc = to_bf16(w[2], w2bf, H * H, s))) return rc;
    ea.w2bf = w2bf;
  }
  return launch_rows<true, BF16>(ea, B, s);
}

}  // namespace
