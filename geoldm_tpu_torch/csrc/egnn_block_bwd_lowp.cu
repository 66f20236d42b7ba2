// One EGNN EquivariantBlock backward with its edge chain in bf16 on Hopper
// (sm_90a): the low-precision variant of kernel #2.
//
// Replaces the TPU kernel geoldm_tpu/ops/pallas_egnn.py:_make_bwd_kernel
// (pallas_call at :507) under GEOLDM_PALLAS_EDGE_LOWP=1 with a bf16 compute
// dtype: the in-kernel jax.vjp of _block_math with edge_dtype bf16 (:160-228).
// It is the bf16 variant (egnn_block_backward_bf16, egnn_block_bwd.cu) with
// the edge chain's vjp site by site, as autograd through the plain version
// returns it: the cotangent of every bf16 value of the chain rounded to
// bf16 (the gated message, the gate, m, t = mm + b2, silu(pre), pre); each
// bf16 product's two operand cotangents rounded before they are summed in
// bf16 (lowp_dsilu, egnn_tile.cuh); each sigmoid's derivative in f32 from
// its f32 value, its result rounded; the gate's channel sum in f32 of
// rounded products, rounded once; the W2 and gate products' cotangents in
// f32 (their outputs' bf16 cotangents, exact) against their bf16 operands
// as in the bf16 variant; and the gradients of b2 and of the gate's bias,
// cast to bf16 and added in bf16, rounded once after their f32 sums over
// every edge and molecule, as every weight gradient (round_weight_grads).
//
// What bounds it on an H100: the bf16 variant's FLOP and bytes.
//
// Design: egnn_block_bwd.cu's stages (egnn_block_bwd.cuh) with LOWP. The
// forward's chain comes from the low-precision forward's saved stack
// (egnn_block_forward_lowp) or is recomputed by its own code
// (block_forward_chain<true, true>), so both routes give the same bits.

#include "egnn_block_bwd.cuh"

extern "C" {

const char* egnn_block_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// egnn_block_backward_bf16's arguments and contract (egnn_block_bwd.cu):
// saved from egnn_block_forward_lowp's save (or null: recomputed with the
// chain in bf16), scratch of egnn_block_backward_scratch_floats(..., saved
// == null, 1) floats (the bf16 variant's layout).
int egnn_block_backward_lowp(const float* h, const float* x, const float* x0, const float* mask,
                             const float* gh, const float* gx, float* dh, float* dx, float* dx0,
                             const void* const* gcl_w, const void* const* coord_w,
                             void* const* gcl_g, void* const* coord_g, const float* saved,
                             float* scratch, int B, int N, int H, int E, int n_gcl,
                             int attention, int sin_emb, int use_tanh, int mean_agg,
                             float coords_range, float norm_constant,
                             float normalization_factor, void* stream) {
  return block_backward<true, true>(h, x, x0, mask, gh, gx, dh, dx, dx0, gcl_w, coord_w, gcl_g,
                                    coord_g, saved, scratch, B, N, H, E, n_gcl, attention,
                                    sin_emb, use_tanh, mean_agg, coords_range, norm_constant,
                                    normalization_factor, stream);
}

}  // extern "C"
