// One EGNN EquivariantBlock forward in f32 on Hopper (sm_90a).
//
// Replaces the TPU kernel geoldm_tpu/ops/pallas_egnn.py:_make_kernel over
// _block_math (pallas_call at :447, via fused_block_apply :392). Same math:
// edge mask = outer(node mask) minus the diagonal; distance features
// [radial(x), radial(x0)] (or their sin/cos embedding); coord_diff =
// diff/(sqrt(r+1e-8)+norm_constant); then each GCL
//   pre = h_i W1s + h_j W1d + e_ij W1e + b1 -> silu -> W2+b2 -> silu
//   -> * sigmoid(m wa + ba) -> masked sum over j / norm -> node MLP + residual
// and the coordinate MLP silu(silu(pre) W2 + b2) w3 -> tanh * coords_range,
// x += sum_j coord_diff * s * mask / norm.
//
// What bounds it on an H100: at the QM9 shapes (H=256, N<=32) the edge
// products [N*N, H] x [H, H] dominate, ~2*N^2*H^2 FLOP per molecule per
// GCL/coord stage, against only O(N*H) bytes of node tensors and the
// weights; it is bound by operations (f32 FMA, no TF32 and no wgmma in this
// first version). The TPU kernel kept the whole [G*N*N, H] edge tensor in
// VMEM; one molecule's edge activations at N=32 are 1 MB in f32, more than
// the 227 KB of shared memory a block may use. So this design tiles by row:
//   - a node GEMM (64x64 tiles, fused bias / silu / residual*mask epilogue)
//     computes the src/dst projections and the node MLP;
//   - an edge kernel runs one CTA per (molecule, row i) with one thread per
//     hidden channel. It builds its row's [N, H] silu(pre) tile in shared
//     memory, streams W2 through shared memory in 32-deep K chunks, and
//     reduces its own row's aggregate (or coordinate update), so no atomics
//     and no edge tensor ever reach device memory.
// One call of egnn_block_forward enqueues 2 + 5 * inv_sublayers launches on
// the caller's stream and never synchronises.

#include "egnn_common.cuh"

extern "C" {

const char* egnn_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// gcl_w: host array of n_gcl * 10 device pointers per GCL, in the order
//   edge_mlp.0.{weight,bias}, edge_mlp.2.{weight,bias}, att_mlp.0.{weight,bias}
//   (null without attention), node_mlp.0.{weight,bias}, node_mlp.2.{weight,bias}.
// coord_w: coord_mlp.0.{weight,bias}, coord_mlp.2.{weight,bias}, coord_mlp.4.weight.
// Scratch: proj [B*N, 2H], agg [B*N, H], hidden [B*N, H]. Returns a
// cudaError_t value (0 on success).
int egnn_block_forward(const float* h, const float* x, const float* x0,
                       const float* mask, float* h_out, float* x_out, float* proj,
                       float* agg, float* hidden, const void* const* gcl_w,
                       const void* const* coord_w, int B, int N, int H, int E,
                       int n_gcl, int attention, int sin_emb, int use_tanh,
                       int mean_agg, float coords_range, float norm_constant,
                       float normalization_factor, void* stream) {
  if (B < 1 || N < 1 || N > kMaxNodes || H < 32 || H > kMaxHidden || H % 32 ||
      E < 0 || E > kMaxEdgeFeat || n_gcl < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * N;
  const int ld1 = 2 * H + E;
  const float norm_div = mean_agg ? (float)N : normalization_factor;

  EdgeArgs ea = {};
  ea.x = x; ea.x0 = x0; ea.mask = mask; ea.proj = proj;
  ea.ld1 = ld1; ea.N = N; ea.H = H; ea.E = E;
  ea.sin_emb = sin_emb; ea.attention = attention; ea.use_tanh = use_tanh;
  ea.coords_range = coords_range; ea.norm_constant = norm_constant;
  ea.norm_div = norm_div;

  const float* hc = h;
  int rc;
  for (int gi = 0; gi < n_gcl; ++gi) {
    const float* const* w = reinterpret_cast<const float* const*>(gcl_w) + 10 * gi;
    if ((rc = launch_projection(hc, w[0], ld1, proj, M, H, s))) return rc;
    ea.w1 = w[0]; ea.b1 = w[1]; ea.w2 = w[2]; ea.b2 = w[3];
    ea.w_out = w[4]; ea.b_out = w[5]; ea.agg = agg; ea.x_out = nullptr;
    if ((rc = launch_edge<false>(ea, B, s))) return rc;

    GemmArgs n1 = {};
    n1.a1 = hc; n1.lda1 = H; n1.k1 = H; n1.a2 = agg; n1.lda2 = H;
    n1.w = w[6]; n1.ldw = 2 * H; n1.bias = w[7];
    n1.c = hidden; n1.ldc = H; n1.M = M; n1.Nout = H; n1.K = 2 * H;
    n1.epilogue = kEpiSilu;
    if ((rc = launch_gemm(n1, s))) return rc;

    // In place for gi > 0: each output element reads only its own residual.
    GemmArgs n2 = {};
    n2.a1 = hidden; n2.lda1 = H; n2.k1 = H;
    n2.w = w[8]; n2.ldw = H; n2.bias = w[9];
    n2.resid = hc; n2.ldr = H; n2.row_mask = mask;
    n2.c = h_out; n2.ldc = H; n2.M = M; n2.Nout = H; n2.K = H;
    n2.epilogue = kEpiResidMask;
    if ((rc = launch_gemm(n2, s))) return rc;
    hc = h_out;
  }

  const float* const* cw = reinterpret_cast<const float* const*>(coord_w);
  if ((rc = launch_projection(hc, cw[0], ld1, proj, M, H, s))) return rc;
  ea.w1 = cw[0]; ea.b1 = cw[1]; ea.w2 = cw[2]; ea.b2 = cw[3];
  ea.w_out = cw[4]; ea.b_out = nullptr; ea.agg = nullptr; ea.x_out = x_out;
  return launch_edge<true>(ea, B, s);
}

}  // extern "C"
