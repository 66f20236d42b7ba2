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
// grid. A CUDA grid runs in parallel, so here the stage runs as
// deterministic passes without atomics (a seeded run replays bit for bit):
//   1. the src/dst projections on the node GEMM (egnn_tc_gemm.cuh, one
//      grouped launch); for a GCL its node chain (the aggregate, the node
//      MLP's pre-activation z and silu(z)): handed over by the caller,
//      which kept it when it re-ran the GCL forward (egnn_gcl_rows with z;
//      ops/egnn_tiled.py's TiledEquivariantBlockFunction does), or
//      else run here by the forward's own code (gcl_chain, egnn_rows.cuh),
//      so both routes give the same bits; then the node MLP's backward,
//      which gives the gradient of the aggregate;
//   2. the edge grid rows_bwd_tile_kernel (egnn_rows_bwd.cuh) on the 64-edge
//      tile of egnn_tile.cuh, as the forward grid: a CTA owns one row of one
//      molecule and walks its columns in 64-column windows. Per window it
//      rebuilds silu(pre), runs the second layer and the transposed product
//      d(mm) W2 on the tensor cores (mma.sync in split TF32: x = hi + lo,
//      hi*hi + hi*lo + lo*hi in f32, about f32's accuracy; W2 streamed
//      through cp.async stages, so each W2 element serves 64 edges), forms
//      the gate or scale and their gradients one warp per edge, and adds the
//      window's row sum of d(pre) (src projection, b1) and partials (db2, the
//      gate or scale weight and bias, the edge-feature columns of W1) to the
//      CTA's own rows. It writes silu(pre), d(mm) and d(pre) of its edges
//      for the passes that cross rows, and the squared-distance gradients of
//      its pairs (not sin). Up to H=256 two CTAs share an SM at <= 128
//      registers; a window whose edge mask is all zero adds nothing: it
//      writes zeros and is skipped;
//   3. the passes of egnn_bwd_common.cuh (stage_grads), those of kernel #2:
//      the W2 gradient sum_e d(mm)^T silu(pre) as a split-K GEMM on the
//      tensor cores (wgrad_tc), the column sums of d(pre) from the CTAs'
//      column partials (column_sum_kernel) for the dst projection, the
//      node-side products (dW1's src/dst columns, dh, the node MLP's six) on
//      the 3xTF32 node GEMM (egnn_tc_gemm.cuh, split-K partials summed in
//      order), the deterministic row reductions, and the coordinate pass
//      dx_i = sum_j (G_ij - G_ji), dx0 likewise.
// 'Mean' divides by the caller's N; the diagonal is masked at the global row.
// The edge grid, the passes and the host loop live in egnn_rows_bwd.cuh,
// which the sequence-parallel slab backward (egnn_sp.cu, #7) shares: here the
// row window is every row and the two views' gradients are summed.
//
// Memory. The grid writes three edge-sized buffers, silu(pre) and d(mm) (the
// W2 gradient's operands) and d(pre) as the CTAs' column partials: with one
// row per CTA a CTA's column partials are its d(pre) row, so summing them
// in a second pass moves the same bytes as reading d(pre) back. Each is
// G*N*N*H*4 bytes for a group of G molecules, 1.11 GB at G=32, N=184,
// H=256; with the node-sized pieces, the pair gradients and the split-K
// partials, egnn_rows_backward_scratch_floats gives the whole. The caller
// picks G so that the scratch stays under its cap and this function runs
// the molecules in groups of G, adding each group's weight gradients to the
// previous groups' in group order; one molecule over the cap is the
// caller's to refuse.
//
// What bounds it on an H100: three edge products of 2*H^2 FLOP per real
// pair and stage (the second layer rebuilt, the transposed product, the W2
// gradient), about 13 GFLOP per molecule at N=184, H=256, run as three
// TF32 products each against 495 TFLOP/s of dense TF32, and the first layer,
// the activations and the reductions at f32's 67 TFLOP/s; it is bound by
// operations (chip_smoke.py phase 12 prints both bounds). The edge buffers
// (written once, read once: 6.7 GB at G=32, N=184) take about 2 ms at 3.35
// TB/s, overlapped with the grid's products and the GEMMs' own. One call
// enqueues about 30 grids (GCL) or 20 (coordinate update) per group on the
// caller's stream and does not synchronise.
//
// The bf16 variants (egnn_gcl_rows_backward_bf16, egnn_coord_rows_backward_
// bf16; JAX's bfloat16 compute dtypes, the jax.vjp of _gcl_rows_math /
// _coord_rows_math with _matmul's bf16 operands) are the vjp of the bf16
// forward (egnn_gcl_rows_bf16, egnn_coord_rows_bf16), with #2's bf16
// rounding sites (egnn_block_bwd.cu): the recomputed projections, second
// layer and node chain on bf16 operands as the forward's, the cotangent of
// every backward product in f32 against its bf16 operand, each gradient of
// a bf16 operand rounded to bf16, the weight gradients once after the last
// group. A GCL's chain comes from egnn_gcl_rows_bf16 with z.

#include "egnn_rows_bwd.cuh"

extern "C" {

const char* egnn_tiled_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of device scratch either backward needs for a group of G molecules
// (bf16 1: either bf16 variant).
size_t egnn_rows_backward_scratch_floats(int G, int N, int H, int E, int bf16) {
  RowsScratch s;
  return rows_scratch_layout(G, N, N, H, E, bf16, nullptr, &s);
}

// Splits of the W2-gradient GEMM (egnn_tc_gemm.cuh) over Me edge rows at
// hidden width H; *kchunk receives the edge rows a split sums.
int egnn_wgrad_splits(int Me, int H, int* kchunk) { return wgrad_splits(Me, H, kchunk); }

// Kernel #5, GCL stage. h: the GCL's input; gh: the cotangent of its output
// [B*N, H]; chain: the GCL's node chain [3, B*N, H] (aggregate, z, silu(z))
// that egnn_gcl_rows kept for this h, or null to run it here (the same
// bits). w / g: host arrays of the GCL's 10 weight / gradient device
// pointers in egnn_gcl_rows' order (att_mlp entries null without
// attention); every gradient is overwritten. scratch: a device buffer of
// egnn_rows_backward_scratch_floats(G, ...) floats; the molecules run in
// groups of G. Returns a cudaError_t value (0 on success).
int egnn_gcl_rows_backward(const float* h, const float* x, const float* x0, const float* mask,
                           const float* gh, const float* chain, float* dh, float* dx,
                           float* dx0, const void* const* w_table, void* const* g_table,
                           float* scratch, int B, int G, int N, int H, int E, int attention,
                           int sin_emb, int mean_agg, float norm_constant,
                           float normalization_factor, void* stream) {
  if (bad_dims(B, N, H, E, sin_emb) || G < 1) return (int)cudaErrorInvalidValue;
  const Slab all = {h, x, x0, mask, 0, N};
  const StageGrads out = {dh, dx, dx0, dh, dx, dx0};
  return rows_backward<false>(
      true, h, x, x0, mask, all, gh, chain, out, reinterpret_cast<const float* const*>(w_table),
      reinterpret_cast<float* const*>(g_table), scratch, B, G, N, H, E, attention, sin_emb, 0,
      0.f, mean_agg ? (float)N : normalization_factor, norm_constant, (cudaStream_t)stream);
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
  const Slab all = {h, x, x0, mask, 0, N};
  const StageGrads out = {dh, dx, dx0, dh, dx, dx0};
  return rows_backward<true>(
      true, h, x, x0, mask, all, gx, nullptr, out, reinterpret_cast<const float* const*>(w_table),
      reinterpret_cast<float* const*>(g_table), scratch, B, G, N, H, E, 0, sin_emb, use_tanh,
      coords_range, mean_agg ? (float)N : normalization_factor, norm_constant,
      (cudaStream_t)stream);
}

// The bf16 variant of kernel #5, GCL stage: egnn_gcl_rows_backward's
// arguments; chain from egnn_gcl_rows_bf16 (or null: run here in bf16),
// scratch of egnn_rows_backward_scratch_floats(G, ..., 1) floats.
int egnn_gcl_rows_backward_bf16(const float* h, const float* x, const float* x0,
                                const float* mask, const float* gh, const float* chain,
                                float* dh, float* dx, float* dx0, const void* const* w_table,
                                void* const* g_table, float* scratch, int B, int G, int N, int H,
                                int E, int attention, int sin_emb, int mean_agg,
                                float norm_constant, float normalization_factor, void* stream) {
  if (bad_dims(B, N, H, E, sin_emb) || G < 1) return (int)cudaErrorInvalidValue;
  const Slab all = {h, x, x0, mask, 0, N};
  const StageGrads out = {dh, dx, dx0, dh, dx, dx0};
  return rows_backward<false, true>(
      true, h, x, x0, mask, all, gh, chain, out, reinterpret_cast<const float* const*>(w_table),
      reinterpret_cast<float* const*>(g_table), scratch, B, G, N, H, E, attention, sin_emb, 0,
      0.f, mean_agg ? (float)N : normalization_factor, norm_constant, (cudaStream_t)stream);
}

// The bf16 variant of kernel #5, coordinate stage: egnn_coord_rows_backward's
// arguments, scratch as egnn_gcl_rows_backward_bf16.
int egnn_coord_rows_backward_bf16(const float* h, const float* x, const float* x0,
                                  const float* mask, const float* gx, float* dh, float* dx,
                                  float* dx0, const void* const* w_table, void* const* g_table,
                                  float* scratch, int B, int G, int N, int H, int E, int sin_emb,
                                  int use_tanh, int mean_agg, float coords_range,
                                  float norm_constant, float normalization_factor,
                                  void* stream) {
  if (bad_dims(B, N, H, E, sin_emb) || G < 1) return (int)cudaErrorInvalidValue;
  const Slab all = {h, x, x0, mask, 0, N};
  const StageGrads out = {dh, dx, dx0, dh, dx, dx0};
  return rows_backward<true, true>(
      true, h, x, x0, mask, all, gx, nullptr, out, reinterpret_cast<const float* const*>(w_table),
      reinterpret_cast<float* const*>(g_table), scratch, B, G, N, H, E, 0, sin_emb, use_tanh,
      coords_range, mean_agg ? (float)N : normalization_factor, norm_constant,
      (cudaStream_t)stream);
}

}  // extern "C"
