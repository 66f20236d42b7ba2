// Row-tiled EquivariantBlock stages in f32 on Hopper (sm_90a), for molecules
// too large for the whole-row kernel of egnn_block.cu (GEOM-Drugs pads to
// 96/136/184 atoms): one GCL update (egnn_gcl_rows) and the coordinate
// update (egnn_coord_rows).
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
// node tensors and the weights; it is bound by operations (f32 FMA, no TF32
// and no wgmma in this version). The TPU kernel holds a [T, N] row slab's
// [T*N, H] edge activations in VMEM with all N columns resident. On Hopper
// one row's [N, H] silu(pre) tile is 188 KB at N=184, H=256: with the W2
// chunk and the pair features that is over the 227 KB a CTA may use, and
// the whole-row kernel's one register accumulator per column would need 184
// registers of a thread's 255. So this design streams the columns:
//   - a CTA owns one row i of one molecule (grid N x B), one thread per
//     hidden channel, and walks the columns in tiles of kColTile = 32;
//   - per tile it builds the pair features, the edge mask, coord_diff and
//     the [32, H] silu(pre) tile in shared memory (69 KB in all at H=256,
//     135 KB at H=512), streams W2 through shared memory in 32-deep K chunks
//     into 32 register accumulators, and folds the tile into the row's sums,
//     which stay in registers: agg_i per channel (#3), or the three
//     coordinate sums after a CTA-wide reduction of m . w3 per pair (#4).
//     No edge tensor reaches device memory;
//   - the last tile is masked, so every N from 1 to kMaxTiledNodes runs
//     with no row or column left out, and a tile whose edge mask is all zero
//     (padding columns, or every tile of a padding row) adds exactly zero
//     and is skipped;
//   - each CTA writes only its own row: no atomics, and a run replays bit
//     for bit;
//   - the node-side products (src/dst projections, node MLP) run in the
//     hand-written 64x64-tile GEMM of egnn_common.cuh with its fused bias /
//     silu / residual*mask epilogues.
// The stages take a row window (egnn_rows.cuh); here the window is every row.
// One call of egnn_gcl_rows enqueues 5 grids, one of egnn_coord_rows 3, on
// the caller's stream; neither synchronises.

#include "egnn_rows.cuh"

extern "C" {

const char* egnn_tiled_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Kernel #3: one GCL over all rows. w: host array of the GCL's 10 device
// pointers, edge_mlp.0.{weight,bias}, edge_mlp.2.{weight,bias},
// att_mlp.0.{weight,bias} (null without attention), node_mlp.0.{weight,bias},
// node_mlp.2.{weight,bias}. Scratch: proj [B*N, 2H], agg [B*N, H], hidden
// [B*N, H]. h_out must not alias h. Returns a cudaError_t value (0 on
// success).
int egnn_gcl_rows(const float* h, const float* x, const float* x0, const float* mask,
                  float* h_out, float* proj, float* agg, float* hidden,
                  const void* const* w_table, int B, int N, int H, int E, int attention,
                  int sin_emb, int mean_agg, float norm_constant, float normalization_factor,
                  void* stream) {
  if (bad_dims(B, N, H, E, sin_emb)) return (int)cudaErrorInvalidValue;
  const Slab all = {h, x, x0, mask, 0, N};
  return gcl_rows_host<3>(h, x, x0, mask, all, h_out, proj, agg, hidden,
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
  return coord_rows_host<4>(h, x, x0, mask, all, x_out, proj,
                            reinterpret_cast<const float* const*>(w_table), B, N, H, E, sin_emb,
                            use_tanh, coords_range, mean_agg ? (float)N : normalization_factor,
                            norm_constant, (cudaStream_t)stream);
}

}  // extern "C"
