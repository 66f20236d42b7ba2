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
//      weight gradients, splits summed in order; paired products of one
//      shape, such as dW1's src and dst columns, in one grouped launch),
//      and the shared passes of
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

#include "egnn_block_bwd.cuh"

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

// The node GEMM alone (egnn_tc_gemm.cuh: run_node_gemm, the launcher every
// caller takes), for the card tests: c (+)= epilogue(A B) as NodeGemm
// describes it, and with a1b, bb, cb non-null a second product of the same
// shape, cb (+)= A' B' (a1b [, a2] and bb; accumulate_b), in the same
// grouped launch. variant 0: f32 in split TF32; 1: BF16 (bf16 operands, ta
// 0 and tb 1 only); 2: GRAD16 (A in split TF32, B rounded to bf16, the
// result rounded when round_out). split: split_cap floats for the K splits
// (0: never split). Returns a cudaError_t value.
int egnn_node_gemm(const float* a1, const float* a2, const float* b, float* c, const float* a1b,
                   const float* bb, float* cb, const float* bias, const float* resid,
                   const float* row_mask, float* split, int lda1, int k1, int lda2, int ta,
                   int ldb, int tb, int ldc, int ldr, int M, int N, int K, int epilogue,
                   int accumulate, int accumulate_b, int round_out, int variant,
                   size_t split_cap, void* stream) {
  NodeGemm g = {};
  g.p[0] = {a1, a2, b, c, accumulate};
  g.p[1] = {a1b, a2, bb, cb, accumulate_b};
  g.problems = cb ? 2 : 1;
  g.lda1 = lda1; g.k1 = k1; g.lda2 = lda2; g.ta = ta; g.ldb = ldb; g.tb = tb;
  g.bias = bias; g.resid = resid; g.ldr = ldr; g.row_mask = row_mask; g.ldc = ldc;
  g.M = M; g.N = N; g.K = K; g.epilogue = epilogue; g.round_out = round_out;
  const SplitBuf sb = {split, split ? split_cap : 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (ta || !tb) return (int)cudaErrorInvalidValue;
    return run_node_gemm<true>(g, sb, s);
  }
  if (variant == 2) return run_node_gemm<false, true>(g, sb, s);
  return run_node_gemm<false>(g, sb, s);
}

// The node GEMM's plan (node_gemm_plan) for `problems` products of M x N
// over K: out = {CTA tile rows, CTA tile columns, K splits, K rows a split}.
int egnn_node_gemm_plan(int M, int N, int K, int problems, size_t cap, int may_split, int* out) {
  out[0] = kNgTM;
  out[1] = kNgTN;
  out[2] = node_gemm_plan(M, N, K, problems, cap, may_split, &out[3]);
  return 0;
}

}  // extern "C"
