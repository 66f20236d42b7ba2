// One EGNN EquivariantBlock forward in f32, and its bf16 variant, on Hopper
// (sm_90a).
//
// Replaces the TPU kernel geoldm_tpu/ops/pallas_egnn.py:_make_kernel over
// _block_math (pallas_call at :447, via fused_block_apply :392); this is a
// redesign for the H100 of the port's first, one-row-per-CTA version. Same
// math: edge mask = outer(node mask) minus the diagonal; distance features
// [radial(x), radial(x0)] (or their sin/cos embedding); coord_diff =
// diff/(sqrt(r+1e-8)+norm_constant); then each GCL
//   pre = h_i W1s + h_j W1d + e_ij W1e + b1 -> silu -> W2+b2 -> silu
//   -> * sigmoid(m wa + ba) -> masked sum over j / norm -> node MLP + residual
// and the coordinate MLP silu(silu(pre) W2 + b2) w3 -> tanh * coords_range,
// x += sum_j coord_diff * s * mask / norm.
//
// What bounds it on an H100: the edge products [B*N*N, H] x [H, H], 2*N^2*H^2
// FLOP per molecule per GCL/coordinate stage, and the node products (src/dst
// projection, node MLP), O(N*H^2). Run as three TF32 products (below) they
// need 3x their FLOP against 495 TFLOP/s of dense TF32; the rest (first
// layer, activations, reductions) against 67 TFLOP/s of f32; the bytes (node
// tensors and weights) are far below both (chip_smoke.py phase 2 prints
// both bounds).
//
// Design (egnn_block_tile.cuh over egnn_tile.cuh):
//   - a CTA owns a tile of R = 64/N whole rows of one molecule, R*N <= 64
//     edge rows (N=29: 2 rows, 58 edges; N=48/64: 1 row), builds their
//     silu(pre) in shared memory and streams W2 through two 16-deep shared
//     stages with cp.async (XOR-swizzled, one barrier a stage), so each W2
//     element serves R*N edges; the first version read all of W2 once per
//     row, for N edges;
//   - the product runs on the tensor cores, mma.sync.m16n8k8 TF32 with a
//     2 x HP/64 warp grid, each warp a 32x64 register tile (no acc[N]
//     arrays), at f32 accuracy by split TF32: x = hi + lo, each rounded to
//     TF32, hi*hi + hi*lo + lo*hi accumulated in f32 (3xTF32). The dropped
//     lo*lo term is below 2^-22 of a product, so an output stays within
//     ~1e-6 relative of the f32 plain version, inside the
//     1e-4*max(1, max|ref|) gates; one TF32 product keeps 2^-11, ~3e-4
//     relative, and fails them (tests/test_torch_port_block_precision.py
//     emulates both). An f32-FMA 2-D register tile was not built: even
//     tripled, the products' tensor-core peak (495/3 TFLOP/s) is above the
//     67 TFLOP/s of f32 FMA;
//   - two CTAs share an SM (at most 128 registers, 105 KB of shared memory
//     each at H=256), so one CTA's products overlap the other's elementwise
//     passes; the elementwise passes take edges in batches of 8 (loads,
//     then arithmetic, then stores) and find an edge's (i, j) in shared
//     memory;
//   - the epilogue keeps the tile in shared memory: one warp per edge forms
//     the gate logit or coordinate scale in a fixed order, one thread per
//     channel the masked sum over j, so no atomics and no edge tensor reach
//     device memory;
//   - the node GEMMs (projection, node MLP) run on the same 3xTF32 mma in
//     the node GEMM of egnn_tc_gemm.cuh (node_gemm_tc_kernel: 64x64 tiles,
//     a cp.async ring, the projection's halves in one grouped launch),
//     which every other EquivariantBlock kernel (#2-#7) shares.
// Ragged tiles (N not a multiple of R) are masked: their empty m16 tiles
// are skipped and their rows never written. No tile spills
// (chip_smoke.py phase 1 prints ptxas' lines and fails on a spill).
// The bf16 variant (egnn_block_forward_bf16; JAX's bfloat16 and
// bfloat16_pallas compute dtypes, _matmul in _block_math) is the same chain
// with every product on bf16 operands and f32 accumulation: the edge
// products as mma.sync.m16n8k16 bf16 (one mma a k16 step where split TF32
// takes three a k8 step, W2 converted to bf16 once a call and streamed
// through the same stages, 32 deep), the node GEMMs likewise, the first
// layer's edge-feature term and the gate / coordinate-scale sums as f32 FMAs
// of rounded operands; activations, biases and sums stay f32. Its bound is
// the same FLOP with the products at the 989 TFLOP/s of dense bf16.
// With grad, the autograd Function asks this forward (either entry) to save each GCL's
// h, aggregate, z and silu(z) ([B*N, H] each) for the backward, which then
// skips its forward recompute; under no_grad nothing extra is written.
// One call of egnn_block_forward enqueues 2 + 5 * inv_sublayers launches
// (two more per GCL with save) on the caller's stream and never synchronises.

#include "egnn_block_tile.cuh"

extern "C" {

const char* egnn_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// gcl_w: host array of n_gcl * 10 device pointers per GCL, in the order
//   edge_mlp.0.{weight,bias}, edge_mlp.2.{weight,bias}, att_mlp.0.{weight,bias}
//   (null without attention), node_mlp.0.{weight,bias}, node_mlp.2.{weight,bias}.
// coord_w: coord_mlp.0.{weight,bias}, coord_mlp.2.{weight,bias}, coord_mlp.4.weight.
// Scratch: proj [B*N, 2H], agg [B*N, H], hidden [B*N, H]. save: null, or
// [4, n_gcl, B*N, H] for the backward (block_forward_chain). Returns a
// cudaError_t value (0 on success).
int egnn_block_forward(const float* h, const float* x, const float* x0,
                       const float* mask, float* h_out, float* x_out, float* proj,
                       float* agg, float* hidden, float* save, const void* const* gcl_w,
                       const void* const* coord_w, int B, int N, int H, int E,
                       int n_gcl, int attention, int sin_emb, int use_tanh,
                       int mean_agg, float coords_range, float norm_constant,
                       float normalization_factor, void* stream) {
  if (B < 1 || N < 1 || N > kMaxNodes || H < 32 || H > kMaxHidden || H % 32 ||
      E < 0 || E > kMaxEdgeFeat || n_gcl < 1)
    return (int)cudaErrorInvalidValue;
  const BlockShape d = {B, N, H, E, n_gcl, attention, sin_emb, use_tanh, coords_range,
                        norm_constant, mean_agg ? (float)N : normalization_factor};
  return block_forward_chain(d, h, x, x0, mask, h_out, x_out, proj, agg, hidden, save, gcl_w,
                             coord_w, true, (cudaStream_t)stream);
}

// The bf16 variant: egnn_block_forward's arguments with w2bf, scratch for
// (n_gcl + 1) [H, H] bf16 W2 copies (16-byte aligned), after save, which
// (non-null: the autograd Function under grad) receives the same stack as
// the f32 entry's for the bf16 backward (egnn_block_backward_bf16).
int egnn_block_forward_bf16(const float* h, const float* x, const float* x0,
                            const float* mask, float* h_out, float* x_out, float* proj,
                            float* agg, float* hidden, float* save, void* w2bf,
                            const void* const* gcl_w, const void* const* coord_w, int B, int N,
                            int H, int E, int n_gcl, int attention, int sin_emb, int use_tanh,
                            int mean_agg, float coords_range, float norm_constant,
                            float normalization_factor, void* stream) {
  if (B < 1 || N < 1 || N > kMaxNodes || H < 32 || H > kMaxHidden || H % 32 ||
      E < 0 || E > kMaxEdgeFeat || n_gcl < 1 || !w2bf)
    return (int)cudaErrorInvalidValue;
  const BlockShape d = {B, N, H, E, n_gcl, attention, sin_emb, use_tanh, coords_range,
                        norm_constant, mean_agg ? (float)N : normalization_factor};
  return block_forward_chain<true>(d, h, x, x0, mask, h_out, x_out, proj, agg, hidden, save,
                                   gcl_w, coord_w, true, (cudaStream_t)stream,
                                   static_cast<uint32_t*>(w2bf));
}

}  // extern "C"
