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
// The edge grid, the passes and the host loop live in egnn_rows_bwd.cuh,
// which the sequence-parallel slab backward (egnn_sp.cu, #7) shares: here the
// row window is every row and the two views' gradients are summed.
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

#include "egnn_rows_bwd.cuh"

extern "C" {

const char* egnn_tiled_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of device scratch either backward needs for a group of G molecules.
size_t egnn_rows_backward_scratch_floats(int G, int N, int H, int E) {
  RowsScratch s;
  return rows_scratch_layout(G, N, N, H, E, nullptr, &s);
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
  const Slab all = {h, x, x0, mask, 0, N};
  const StageGrads out = {dh, dx, dx0, dh, dx, dx0};
  return rows_backward<5, false>(
      true, h, x, x0, mask, all, gh, out, reinterpret_cast<const float* const*>(w_table),
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
  return rows_backward<5, true>(
      true, h, x, x0, mask, all, gx, out, reinterpret_cast<const float* const*>(w_table),
      reinterpret_cast<float* const*>(g_table), scratch, B, G, N, H, E, 0, sin_emb, use_tanh,
      coords_range, mean_agg ? (float)N : normalization_factor, norm_constant,
      (cudaStream_t)stream);
}

}  // extern "C"
