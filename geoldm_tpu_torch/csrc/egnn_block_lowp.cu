// One EGNN EquivariantBlock forward with its edge chain in bf16 on Hopper
// (sm_90a): the low-precision variant of kernel #1.
//
// Replaces the TPU kernel geoldm_tpu/ops/pallas_egnn.py:_make_kernel over
// _block_math (pallas_call at :447) under GEOLDM_PALLAS_EDGE_LOWP=1 with a
// bf16 compute dtype (:49-55, edge_dtype at :160-228): the bf16 variant
// (egnn_block_forward_bf16, egnn_block.cu) with the edge activations in
// bf16 as well. Per edge stage: pre = h_i W1s + h_j W1d + e_ij W1e + b1 in
// f32, rounded to bf16; silu(pre) = pre * bf16(sigmoid(pre)) in bf16; the W2
// product on bf16 operands with f32 accumulation, rounded to bf16; + bf16(b2)
// in bf16; its silu in bf16; the gate bf16(sigmoid(bf16(m wa) + bf16(ba)))
// and m times it in bf16; the message back in f32 for the masked row sum.
// The coordinate stage follows the chain to silu(. + b2) and keeps the w3
// product's output in f32. Each sigmoid is taken in f32 from its bf16 input
// (JAX's _sigmoid: the transcendental stays f32), each bf16 sum and product
// is one packed bf16 operation (__hadd2 / __hmul2, rounded to nearest even)
// where the values come in pairs (egnn_tile.cuh: lowp_silu2, store_acc).
// The node chain (projection, node MLP) is the bf16 variant's.
//
// What bounds it on an H100: the bf16 variant's FLOP and bytes (the chain
// changes neither): the products at the 989 TFLOP/s of dense bf16.
//
// Design: egnn_block.cu's tile grid (egnn_block_tile.cuh) with LOWP: the
// edge tile keeps its f32 shared memory, whose chain values are bf16
// exactly, so the bf16 mma operands are exact copies. With save (the
// autograd Function under grad) it writes the node chain the low-precision
// backward (egnn_block_bwd_lowp.cu) reads; that backward recomputes the
// edge chain with the same device functions, so its saved and recomputed
// routes give the same bits.

#include "egnn_block_tile.cuh"

extern "C" {

const char* egnn_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// egnn_block_forward_bf16's arguments and contract (egnn_block.cu), with the
// edge chain in bf16. Returns a cudaError_t value (0 on success).
int egnn_block_forward_lowp(const float* h, const float* x, const float* x0,
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
  return block_forward_chain<true, true>(d, h, x, x0, mask, h_out, x_out, proj, agg, hidden,
                                         save, gcl_w, coord_w, true, (cudaStream_t)stream,
                                         static_cast<uint32_t*>(w2bf));
}

}  // extern "C"
