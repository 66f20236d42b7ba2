// Row-tiled EquivariantBlock stages in f32, and their bf16 variants, on Hopper
// (sm_90a), for molecules too large for the whole-row kernel of
// egnn_block.cu (GEOM-Drugs pads to 96/136/184 atoms): one GCL update
// (egnn_gcl_rows) and the coordinate update (egnn_coord_rows).
//
// Replaces the TPU kernels
//   #3 geoldm_tpu/ops/pallas_egnn_tiled.py:152 _make_gcl_rows_kernel over
//      _gcl_rows_math :86 (pallas_call :356 in _call_rows), and
//   #4 geoldm_tpu/ops/pallas_egnn_tiled.py:166 _make_coord_rows_kernel over
//      _coord_rows_math :123 (pallas_call :356).
// Same math, for every row i of every molecule:
//   #3: h_i' = (h_i + node_mlp([h_i, agg_i])) * m_i, with
//       agg_i = sum_j e_ij * a_ij * silu(silu(pre_ij) W2 + b2) / div and the
//       attention gate a_ij = sigmoid(m_ij wa + ba) (1 without attention);
//   #4: x_i' = (x_i + sum_j coord_diff_ij * s_ij * e_ij / div) * m_i, with
//       s_ij = tanh(silu(silu(pre_ij) W2 + b2) w3) * coords_range (no tanh:
//       the raw product);
// pre_ij = h_i W1s + h_j W1d + f_ij W1e + b1, f_ij the distance features
// [r(x), r(x0)] or their sin/cos embedding, e_ij the node-mask outer product
// without the diagonal (at the global row index), coord_diff = diff /
// (sqrt(r + 1e-8) + norm_constant), and div = normalization_factor ('sum')
// or the caller's N ('mean').
//
// What bounds it on an H100: the edge products, 2*N^2*H^2 FLOP per molecule
// and stage for W2 alone (N=184, H=256: 4.4 GFLOP), against O(N*H) bytes of
// node tensors and the weights. Run as three TF32 products (below) W2 needs
// 3x its FLOP against 495 TFLOP/s of dense TF32; the first layer, the
// activations and the row sums run at f32's 67 TFLOP/s; the bytes are far
// below both (chip_smoke.py phase 9 prints both bounds). The TPU kernel
// holds a [T, N] row slab's [T*N, H] edge activations in VMEM with all N
// columns resident; on Hopper one row's [N, H] silu(pre) is 188 KB at N=184,
// H=256, over what two CTAs an SM may hold. So the grid (egnn_rows.cuh)
// walks the columns in windows:
//   - a CTA owns one row i of one molecule (grid N x B) and walks its
//     columns in windows of 64; each window is one 64-edge-row tile of
//     egnn_tile.cuh, the tile the whole-molecule kernels (#1/#2) use: pair
//     features, edge mask and coord_diff of the window, its [64, H]
//     silu(pre) in shared memory (edges 8 at a time), and the W2 product on
//     the tensor cores, mma.sync.m16n8k8 TF32 over a 2 x HP/64 warp grid, at
//     f32 accuracy by split TF32 (x = hi + lo, hi*hi + hi*lo + lo*hi in f32;
//     one TF32 product keeps 2^-11 and fails the 1e-4 gates), W2 streamed
//     through two 16-deep XOR-swizzled shared stages with cp.async, so each
//     W2 element serves 64 edges;
//   - bias and silu fuse into the accumulator store; one warp per edge forms
//     the gate sigmoid(m . wa + ba) or the scale tanh(m . w3) * range in a
//     fixed order; the row's sums stay in registers across windows: agg_i
//     per channel (#3) or the three coordinate sums (#4). No edge tensor
//     reaches device memory;
//   - up to H=256 two CTAs share an SM (at most 128 registers a thread, 105
//     KB of shared memory each), so one CTA's products overlap the other's
//     elementwise passes; H=512 runs one;
//   - the last window is masked and its m16 tiles past the live edges are
//     skipped, so every N from 1 to kMaxTiledNodes runs with no row or
//     column left out; a window whose edge mask is all zero (padding
//     columns, or every window of a padding row) adds exactly zero and is
//     skipped;
//   - each CTA writes only its own row: no atomics, and a run replays bit
//     for bit;
//   - the node-side products (src/dst projections, node MLP) run on the
//     split-TF32 node GEMM of egnn_tc_gemm.cuh, as #1's do
//     (node_gemm_tc_kernel: 64x64 tiles, a cp.async ring, the projection's
//     halves in one grouped launch, the bias / silu / residual*mask
//     epilogues fused).
// The bf16 variants (egnn_gcl_rows_bf16, egnn_coord_rows_bf16; JAX's
// bfloat16 compute dtypes, _matmul in _edge_pre_rows, _gcl_rows_math,
// _coord_rows_math) walk the same windows with every product on bf16
// operands and f32 accumulation: the W2 product as mma.sync.m16n8k16 bf16
// (egnn_tile.cuh: tile_product_bf16, W2 converted to bf16 once a call), the
// node GEMM's products as m16n8k16 bf16 mma, the first layer's edge-feature
// term and the gate / scale sums as f32 FMAs of rounded operands. Under grad the GCL's keeps its node chain (z) for the
// bf16 stage backward (egnn_tiled_bwd.cu), as the f32 one does.
// The stages take a row window (egnn_rows.cuh); here the window is every row.
// One call of egnn_gcl_rows enqueues 4 grids (5 when it keeps the node chain
// for the backward), one of egnn_coord_rows 2, on the caller's stream;
// neither synchronises.

#include "egnn_rows.cuh"

extern "C" {

const char* egnn_tiled_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Kernel #3: one GCL over all rows. w: host array of the GCL's 10 device
// pointers, edge_mlp.0.{weight,bias}, edge_mlp.2.{weight,bias},
// att_mlp.0.{weight,bias} (null without attention), node_mlp.0.{weight,bias},
// node_mlp.2.{weight,bias}. Scratch: proj [B*N, 2H], agg [B*N, H], hidden
// [B*N, H], and z [B*N, H] or null: with z, agg, z and hidden = silu(z) are
// the GCL's node chain, which the stage backward (egnn_gcl_rows_backward)
// takes as [3, B*N, H] when the three are consecutive. h_out must not alias
// h. Returns a cudaError_t value (0 on success).
int egnn_gcl_rows(const float* h, const float* x, const float* x0, const float* mask,
                  float* h_out, float* proj, float* agg, float* hidden, float* z,
                  const void* const* w_table, int B, int N, int H, int E, int attention,
                  int sin_emb, int mean_agg, float norm_constant, float normalization_factor,
                  void* stream) {
  if (bad_dims(B, N, H, E, sin_emb)) return (int)cudaErrorInvalidValue;
  const Slab all = {h, x, x0, mask, 0, N};
  return gcl_rows_host(h, x, x0, mask, all, h_out, proj, agg, hidden, z,
                       reinterpret_cast<const float* const*>(w_table), B, N, H, E, attention,
                       sin_emb, mean_agg ? (float)N : normalization_factor, norm_constant,
                       (cudaStream_t)stream);
}

// Kernel #4: the coordinate update over all rows. w: host array of 5 device
// pointers, coord_mlp.0.{weight,bias}, coord_mlp.2.{weight,bias},
// coord_mlp.4.weight. Scratch: proj [B*N, 2H]. Returns a cudaError_t value.
int egnn_coord_rows(const float* h, const float* x, const float* x0, const float* mask,
                    float* x_out, float* proj, const void* const* w_table, int B, int N,
                    int H, int E, int sin_emb, int use_tanh, int mean_agg, float coords_range,
                    float norm_constant, float normalization_factor, void* stream) {
  if (bad_dims(B, N, H, E, sin_emb)) return (int)cudaErrorInvalidValue;
  const Slab all = {h, x, x0, mask, 0, N};
  return coord_rows_host(h, x, x0, mask, all, x_out, proj,
                         reinterpret_cast<const float* const*>(w_table), B, N, H, E, sin_emb,
                         use_tanh, coords_range, mean_agg ? (float)N : normalization_factor,
                         norm_constant, (cudaStream_t)stream);
}

// The bf16 variant of kernel #3: egnn_gcl_rows' arguments (z null, or the
// node chain's z for egnn_gcl_rows_backward_bf16) with w2bf, [H, H] bf16
// scratch (16-byte aligned), after z.
int egnn_gcl_rows_bf16(const float* h, const float* x, const float* x0, const float* mask,
                       float* h_out, float* proj, float* agg, float* hidden, float* z,
                       void* w2bf, const void* const* w_table, int B, int N, int H, int E,
                       int attention, int sin_emb, int mean_agg, float norm_constant,
                       float normalization_factor, void* stream) {
  if (bad_dims(B, N, H, E, sin_emb) || !w2bf) return (int)cudaErrorInvalidValue;
  const Slab all = {h, x, x0, mask, 0, N};
  return gcl_rows_host<true>(h, x, x0, mask, all, h_out, proj, agg, hidden, z,
                             reinterpret_cast<const float* const*>(w_table), B, N, H, E,
                             attention, sin_emb, mean_agg ? (float)N : normalization_factor,
                             norm_constant, (cudaStream_t)stream, static_cast<uint32_t*>(w2bf));
}

// The bf16 variant of kernel #4: egnn_coord_rows' arguments and w2bf, [H, H]
// bf16 scratch (16-byte aligned), after proj.
int egnn_coord_rows_bf16(const float* h, const float* x, const float* x0, const float* mask,
                         float* x_out, float* proj, void* w2bf, const void* const* w_table,
                         int B, int N, int H, int E, int sin_emb, int use_tanh, int mean_agg,
                         float coords_range, float norm_constant, float normalization_factor,
                         void* stream) {
  if (bad_dims(B, N, H, E, sin_emb) || !w2bf) return (int)cudaErrorInvalidValue;
  const Slab all = {h, x, x0, mask, 0, N};
  return coord_rows_host<true>(h, x, x0, mask, all, x_out, proj,
                               reinterpret_cast<const float* const*>(w_table), B, N, H, E,
                               sin_emb, use_tanh, coords_range,
                               mean_agg ? (float)N : normalization_factor, norm_constant,
                               (cudaStream_t)stream, static_cast<uint32_t*>(w2bf));
}

}  // extern "C"
