// Sequence-parallel (SP) EquivariantBlock stages in f32 on Hopper (sm_90a):
// one GCL or the coordinate update over this rank's slab of rows against all
// N columns, forward and backward. The EGNN's atom rows are split over the SP
// ranks (parallel/sp.py); each rank gathers the [B, N, *] node tensors and
// runs these kernels on its [B, S, *] slab, S = N / ranks.
//
// Replaces the TPU kernels
//   #6 geoldm_tpu/ops/pallas_egnn_sp.py:144 _make_sp_fwd_kernel (pallas_call
//      :219, via sp_stage_apply :284): #3's or #4's math for the S-row slab
//      at the global row offset r0 (an SMEM scalar there, used for the
//      diagonal mask), 'mean' over the EGNN's N before the SP pad; and
//   #7 pallas_egnn_sp.py:158 _make_sp_bwd_kernel (pallas_call :252): #5 on
//      the slab, with the full-view gradients (dh, dx, dx0 [B,N,*], summed
//      over the slab's rows) returned apart from the row-view gradients
//      ([B,S,*]) (:278-281), and the weight gradients summed over the grid.
//
// Design. The same kernels as the single-device row-tiled stages (#3, #4,
// #5), run over a row window (egnn_rows.cuh, egnn_rows_bwd.cuh): one CTA per
// (molecule, slab row), the columns walked in 64-column windows of the
// tensor-core tile of egnn_tile.cuh, forward and backward, no atomics. What
// differs:
//   - the slab's h, x, x0 and mask are their own [B*S, *] tensors and the
//     CTA's global row is row0 + blockIdx.x, which the diagonal mask uses;
//   - a GCL's first layer splits: the src half h_r W1s over the B*S slab
//     rows, the dst half h W1d over all B*N columns; the node MLP runs on the
//     B*S rows;
//   - backward: the src half's gradient (rowsum) goes to the row view and
//     dW1s, the dst half's (the column sum of d(pre) over the slab's rows)
//     to the full view and dW1d. The coordinate pass splits as well: the
//     slab holds only its own rows' pairs, so the row view gets sum_j G_ij
//     and the full view -sum_{i in slab} G_ij (slab_coord_rows_kernel,
//     slab_coord_cols_kernel), where #5 reads the transposed pair;
//   - the CUDA kernels mask their ragged tails, so the TPU's 8-row slab
//     alignment (sp_stage_tiles) does not carry over: any S from 1 to N.
// The edge scratch of the backward is [G, S, N, H] x 3 for a group of G
// molecules: 1.66 GB at G = 32, S = 92, N = 184, H = 256. Where the caller
// kept the slab's node chain when it re-ran the GCL forward (egnn_sp_gcl_rows
// with z; parallel/sp.py's SPEquivariantBlockFunction does), the backward
// takes it instead of running the GCL's edge grid again.
//
// The bf16 variants (the *_bf16 entries; JAX's bfloat16 compute dtypes in
// sp_stage_apply) run the bf16 grids of #3/#4 (egnn_tiled.cu) and #5
// (egnn_tiled_bwd.cu) over the slab, forward (keeping the slab's node chain
// under grad) and backward, with their rounding sites; a rank's weight
// gradients are its slab's share, rounded to bf16 once on the rank.
//
// What bounds it on an H100: as #3-#5, the edge products over the slab's
// S*N pairs, bound by operations: the forward's W2 product and the
// backward's three (the second layer, the transposed product, the W2
// gradient) in split TF32 on the tensor cores.

#include "egnn_rows_bwd.cuh"

namespace {

bool bad_sp(int B, int N, int H, int E, int sin_emb, const Slab& r, int mean_div) {
  return bad_dims(B, N, H, E, sin_emb) || bad_slab(r, N) || mean_div < 1;
}

}  // namespace

extern "C" {

const char* egnn_sp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Kernel #6, GCL: the full view h [B*N, H], x, x0 [B*N, 3], mask [B*N]; the
// slab hr [B*S, H], xr, x0r [B*S, 3], mr [B*S] at global rows row0..row0+S.
// w: the GCL's 10 weight pointers in egnn_gcl_rows' order. Scratch: proj
// [B*N, 2H], agg and hidden [B*S, H], and z [B*S, H] or null (with z, the
// slab's node chain for egnn_sp_gcl_rows_backward, as egnn_gcl_rows keeps
// it). h_out [B*S, H] must not alias hr. 'Mean' divides by mean_div.
// Returns a cudaError_t value (0 on success).
int egnn_sp_gcl_rows(const float* h, const float* x, const float* x0, const float* mask,
                     const float* hr, const float* xr, const float* x0r, const float* mr,
                     float* h_out, float* proj, float* agg, float* hidden, float* z,
                     const void* const* w_table, int B, int N, int S, int row0, int H, int E,
                     int attention, int sin_emb, int mean_agg, int mean_div,
                     float norm_constant, float normalization_factor, void* stream) {
  const Slab r = {hr, xr, x0r, mr, row0, S};
  if (bad_sp(B, N, H, E, sin_emb, r, mean_div)) return (int)cudaErrorInvalidValue;
  return gcl_rows_host(h, x, x0, mask, r, h_out, proj, agg, hidden, z,
                       reinterpret_cast<const float* const*>(w_table), B, N, H, E, attention,
                       sin_emb, mean_agg ? (float)mean_div : normalization_factor,
                       norm_constant, (cudaStream_t)stream);
}

// Kernel #6, coordinate update: views as egnn_sp_gcl_rows; w: 5 weight
// pointers in egnn_coord_rows' order. Scratch: proj [B*N, 2H]. x_out [B*S, 3].
int egnn_sp_coord_rows(const float* h, const float* x, const float* x0, const float* mask,
                       const float* hr, const float* xr, const float* x0r, const float* mr,
                       float* x_out, float* proj, const void* const* w_table, int B, int N,
                       int S, int row0, int H, int E, int sin_emb, int use_tanh, int mean_agg,
                       int mean_div, float coords_range, float norm_constant,
                       float normalization_factor, void* stream) {
  const Slab r = {hr, xr, x0r, mr, row0, S};
  if (bad_sp(B, N, H, E, sin_emb, r, mean_div)) return (int)cudaErrorInvalidValue;
  return coord_rows_host(h, x, x0, mask, r, x_out, proj,
                         reinterpret_cast<const float* const*>(w_table), B, N, H, E, sin_emb,
                         use_tanh, coords_range,
                         mean_agg ? (float)mean_div : normalization_factor, norm_constant,
                         (cudaStream_t)stream);
}

// Floats of device scratch either SP backward needs for a group of G
// molecules (bf16 1: either bf16 variant).
size_t egnn_sp_backward_scratch_floats(int G, int S, int N, int H, int E, int bf16) {
  RowsScratch s;
  return rows_scratch_layout(G, S, N, H, E, bf16, nullptr, &s);
}

// Kernel #7, GCL: views as egnn_sp_gcl_rows; gh [B*S, H] the cotangent of the
// slab's output; chain: the slab's node chain [3, B*S, H] that
// egnn_sp_gcl_rows kept for these inputs, or null to run it here (the same
// bits). Writes the full-view gradients dh [B*N, H], dx, dx0 [B*N, 3] and the
// slab's dhr [B*S, H], dxr, dx0r [B*S, 3]; w / g: the GCL's 10 weight /
// gradient pointers (att_mlp null without attention), every gradient
// overwritten with the slab's share summed over the batch. scratch: a device
// buffer of egnn_sp_backward_scratch_floats(G, ...) floats; the molecules run
// in groups of G. Returns a cudaError_t value.
int egnn_sp_gcl_rows_backward(const float* h, const float* x, const float* x0,
                              const float* mask, const float* hr, const float* xr,
                              const float* x0r, const float* mr, const float* gh,
                              const float* chain, float* dh, float* dx, float* dx0, float* dhr,
                              float* dxr, float* dx0r, const void* const* w_table,
                              void* const* g_table, float* scratch, int B, int G, int N, int S,
                              int row0, int H, int E, int attention, int sin_emb, int mean_agg,
                              int mean_div, float norm_constant, float normalization_factor,
                              void* stream) {
  const Slab r = {hr, xr, x0r, mr, row0, S};
  if (bad_sp(B, N, H, E, sin_emb, r, mean_div) || G < 1) return (int)cudaErrorInvalidValue;
  const StageGrads out = {dh, dx, dx0, dhr, dxr, dx0r};
  return rows_backward<false>(
      false, h, x, x0, mask, r, gh, chain, out, reinterpret_cast<const float* const*>(w_table),
      reinterpret_cast<float* const*>(g_table), scratch, B, G, N, H, E, attention, sin_emb, 0,
      0.f, mean_agg ? (float)mean_div : normalization_factor, norm_constant,
      (cudaStream_t)stream);
}

// Kernel #7, coordinate update: gx [B*S, 3] the cotangent of the slab's
// x_out; outputs, w / g (5 pointers), scratch and G as
// egnn_sp_gcl_rows_backward.
int egnn_sp_coord_rows_backward(const float* h, const float* x, const float* x0,
                                const float* mask, const float* hr, const float* xr,
                                const float* x0r, const float* mr, const float* gx, float* dh,
                                float* dx, float* dx0, float* dhr, float* dxr, float* dx0r,
                                const void* const* w_table, void* const* g_table,
                                float* scratch, int B, int G, int N, int S, int row0, int H,
                                int E, int sin_emb, int use_tanh, int mean_agg, int mean_div,
                                float coords_range, float norm_constant,
                                float normalization_factor, void* stream) {
  const Slab r = {hr, xr, x0r, mr, row0, S};
  if (bad_sp(B, N, H, E, sin_emb, r, mean_div) || G < 1) return (int)cudaErrorInvalidValue;
  const StageGrads out = {dh, dx, dx0, dhr, dxr, dx0r};
  return rows_backward<true>(
      false, h, x, x0, mask, r, gx, nullptr, out, reinterpret_cast<const float* const*>(w_table),
      reinterpret_cast<float* const*>(g_table), scratch, B, G, N, H, E, 0, sin_emb, use_tanh,
      coords_range, mean_agg ? (float)mean_div : normalization_factor, norm_constant,
      (cudaStream_t)stream);
}

// The bf16 variant of kernel #6, GCL: egnn_sp_gcl_rows' arguments with w2bf,
// [H, H] bf16 scratch (16-byte aligned), after z.
int egnn_sp_gcl_rows_bf16(const float* h, const float* x, const float* x0, const float* mask,
                          const float* hr, const float* xr, const float* x0r, const float* mr,
                          float* h_out, float* proj, float* agg, float* hidden, float* z,
                          void* w2bf, const void* const* w_table, int B, int N, int S, int row0,
                          int H, int E, int attention, int sin_emb, int mean_agg, int mean_div,
                          float norm_constant, float normalization_factor, void* stream) {
  const Slab r = {hr, xr, x0r, mr, row0, S};
  if (bad_sp(B, N, H, E, sin_emb, r, mean_div) || !w2bf) return (int)cudaErrorInvalidValue;
  return gcl_rows_host<true>(h, x, x0, mask, r, h_out, proj, agg, hidden, z,
                             reinterpret_cast<const float* const*>(w_table), B, N, H, E,
                             attention, sin_emb,
                             mean_agg ? (float)mean_div : normalization_factor, norm_constant,
                             (cudaStream_t)stream, static_cast<uint32_t*>(w2bf));
}

// The bf16 variant of kernel #6, coordinate update: egnn_sp_coord_rows'
// arguments with w2bf, [H, H] bf16 scratch, after proj.
int egnn_sp_coord_rows_bf16(const float* h, const float* x, const float* x0, const float* mask,
                            const float* hr, const float* xr, const float* x0r, const float* mr,
                            float* x_out, float* proj, void* w2bf, const void* const* w_table,
                            int B, int N, int S, int row0, int H, int E, int sin_emb,
                            int use_tanh, int mean_agg, int mean_div, float coords_range,
                            float norm_constant, float normalization_factor, void* stream) {
  const Slab r = {hr, xr, x0r, mr, row0, S};
  if (bad_sp(B, N, H, E, sin_emb, r, mean_div) || !w2bf) return (int)cudaErrorInvalidValue;
  return coord_rows_host<true>(h, x, x0, mask, r, x_out, proj,
                               reinterpret_cast<const float* const*>(w_table), B, N, H, E,
                               sin_emb, use_tanh, coords_range,
                               mean_agg ? (float)mean_div : normalization_factor,
                               norm_constant, (cudaStream_t)stream,
                               static_cast<uint32_t*>(w2bf));
}

// The bf16 variant of kernel #7, GCL: egnn_sp_gcl_rows_backward's arguments;
// chain from egnn_sp_gcl_rows_bf16 (or null), scratch of
// egnn_sp_backward_scratch_floats(G, ..., 1) floats.
int egnn_sp_gcl_rows_backward_bf16(const float* h, const float* x, const float* x0,
                                   const float* mask, const float* hr, const float* xr,
                                   const float* x0r, const float* mr, const float* gh,
                                   const float* chain, float* dh, float* dx, float* dx0,
                                   float* dhr, float* dxr, float* dx0r, const void* const* w_table,
                                   void* const* g_table, float* scratch, int B, int G, int N,
                                   int S, int row0, int H, int E, int attention, int sin_emb,
                                   int mean_agg, int mean_div, float norm_constant,
                                   float normalization_factor, void* stream) {
  const Slab r = {hr, xr, x0r, mr, row0, S};
  if (bad_sp(B, N, H, E, sin_emb, r, mean_div) || G < 1) return (int)cudaErrorInvalidValue;
  const StageGrads out = {dh, dx, dx0, dhr, dxr, dx0r};
  return rows_backward<false, true>(
      false, h, x, x0, mask, r, gh, chain, out, reinterpret_cast<const float* const*>(w_table),
      reinterpret_cast<float* const*>(g_table), scratch, B, G, N, H, E, attention, sin_emb, 0,
      0.f, mean_agg ? (float)mean_div : normalization_factor, norm_constant,
      (cudaStream_t)stream);
}

// The bf16 variant of kernel #7, coordinate update:
// egnn_sp_coord_rows_backward's arguments, scratch as
// egnn_sp_gcl_rows_backward_bf16.
int egnn_sp_coord_rows_backward_bf16(const float* h, const float* x, const float* x0,
                                     const float* mask, const float* hr, const float* xr,
                                     const float* x0r, const float* mr, const float* gx,
                                     float* dh, float* dx, float* dx0, float* dhr, float* dxr,
                                     float* dx0r, const void* const* w_table,
                                     void* const* g_table, float* scratch, int B, int G, int N,
                                     int S, int row0, int H, int E, int sin_emb, int use_tanh,
                                     int mean_agg, int mean_div, float coords_range,
                                     float norm_constant, float normalization_factor,
                                     void* stream) {
  const Slab r = {hr, xr, x0r, mr, row0, S};
  if (bad_sp(B, N, H, E, sin_emb, r, mean_div) || G < 1) return (int)cudaErrorInvalidValue;
  const StageGrads out = {dh, dx, dx0, dhr, dxr, dx0r};
  return rows_backward<true, true>(
      false, h, x, x0, mask, r, gx, nullptr, out, reinterpret_cast<const float* const*>(w_table),
      reinterpret_cast<float* const*>(g_table), scratch, B, G, N, H, E, 0, sin_emb, use_tanh,
      coords_range, mean_agg ? (float)mean_div : normalization_factor, norm_constant,
      (cudaStream_t)stream);
}

}  // extern "C"
