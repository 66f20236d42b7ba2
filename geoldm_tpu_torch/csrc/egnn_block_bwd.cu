// One EGNN EquivariantBlock backward in f32 on Hopper (sm_90a).
//
// Replaces the TPU kernel geoldm_tpu/ops/pallas_egnn.py:_make_bwd_kernel
// (pallas_call at :507, via _fused_block_bwd_impl :485). Same function: from
// the block inputs (h, x, x0, node mask), the weights and the cotangents of
// (h_out, x_out) it recomputes the forward and returns dh, dx, the exact dx0
// and every weight gradient summed over the batch. As in _sin_features
// (:96-105) the sin/cos distance features carry no gradient.
//
// Design. The Pallas kernel differentiates the whole block in VMEM with an
// in-kernel jax.vjp and accumulates weight gradients across a sequential
// grid. A CUDA grid runs in parallel, so this version splits the work into
// stages that each own their outputs, and reduces across CTAs in separate,
// deterministic passes (no atomics: a seeded run replays bit for bit):
//   1. forward recompute of the node-level chain (the forward's node GEMM and edge
//      kernel), keeping each GCL's input h, aggregate, node-MLP
//      pre-activation and silu output ([B*N, H] each);
//   2. per edge stage, in reverse (coordinate update, then GCL n-1 ... 0), an
//      edge-backward kernel with one CTA per (molecule b, row i) and one
//      thread per hidden channel. It rebuilds row i's silu(pre) tile in shared
//      memory, recomputes the second layer, back-propagates through the
//      attention gate / coordinate scale, and runs the transposed W2 product
//      on its own row. Row sums (dst of the src projection, db1), per-CTA
//      partials (db2, the gate/coordinate weight, the edge-feature columns of
//      W1) and the distance-feature gradients of row i are written by the CTA
//      that owns them;
//   3. the terms that cross rows run as their own passes: a column sum of
//      d(pre) over i for the dst projection, hand-written tiled GEMMs for the
//      weight gradients (split over K with a summing pass where the output is
//      only 256x256) and the node-side products, and a coordinate pass that
//      turns the antisymmetric pair gradients into dx_i = sum_j (G_ij - G_ji)
//      and dx0 likewise.
//
// Memory: this first version writes three edge-sized activations to device
// memory per stage (silu(pre), d(mm) for the W2 gradient, d(pre) for the
// column sum): 3 * B*N*N*H*4 bytes, 3 x 55 MB at B=64, N=29, H=256, reused
// from stage to stage. The autograd Function saves only the block inputs.
//
// What bounds it on an H100: per edge stage about 6*N^2*H^2 FLOP per
// molecule (recompute, the transposed product and the W2 gradient), all f32
// FMA outside the tensor cores, against a few hundred MB of edge traffic: it
// is bound by operations, like the forward.
//
// The passes that take any N (the split-K GEMM, the reductions, the
// coordinate pass, stage_grads, the node-MLP backward) live in
// egnn_bwd_common.cuh, shared with the row-tiled stage backward
// (egnn_tiled_bwd.cu); this file keeps the whole-row edge-backward kernel.

#include "egnn_bwd_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Edge-stage backward: one CTA per (molecule b, row i), blockDim.x == H, the
// whole row of at most NMAX columns at once.
// ---------------------------------------------------------------------------

template <int NMAX, bool COORD>
__global__ void __launch_bounds__(kMaxHidden, 1) edge_bwd_kernel(EdgeBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, N = a.N, E = a.E;
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5, nwarp = H >> 5;
  const int b = blockIdx.y, i = blockIdx.x;
  const size_t row_i = (size_t)b * N + i;
  const size_t edge0 = row_i * N;  // edge index of (b, i, j) is edge0 + j

  float* As = smem;                          // [NMAX][H] silu(pre), then d(mm), then d(pre)
  float* Ws = As + NMAX * H;                 // [kKChunk][H + 1] W2 chunk
  float* ef = Ws + kKChunk * (H + 1);        // [NMAX][kMaxEdgeFeat]
  float* em = ef + NMAX * kMaxEdgeFeat;      // [NMAX] edge mask of row i
  float* cd = em + NMAX;                     // [NMAX][3] coord_diff
  float* red = cd + NMAX * 3;                // [nwarp][NMAX]
  float* red2 = red + nwarp * NMAX;          // [nwarp][NMAX]
  float* rs = red2 + nwarp * NMAX;           // [NMAX] per-edge scalars
  float* rs2 = rs + NMAX;                    // [NMAX]

  // 1. Edge features, edge mask and coord_diff of row i (as the forward).
  const float mi = a.mask[row_i];
  for (int j = c; j < NMAX; j += H) {
    float* f = ef + j * kMaxEdgeFeat;
#pragma unroll
    for (int e = 0; e < kMaxEdgeFeat; ++e) f[e] = 0.f;
    em[j] = 0.f;
    cd[j * 3 + 0] = cd[j * 3 + 1] = cd[j * 3 + 2] = 0.f;
    if (j >= N) continue;
    const size_t rj = (size_t)b * N + j;
    float d[3], d0[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      d[q] = a.x[row_i * 3 + q] - a.x[rj * 3 + q];
      d0[q] = a.x0[row_i * 3 + q] - a.x0[rj * 3 + q];
    }
    const float r = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float r0 = d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2];
    const float norm = sqrtf(r + 1e-8f);
#pragma unroll
    for (int q = 0; q < 3; ++q) cd[j * 3 + q] = d[q] / (norm + a.norm_constant);
    if (a.sin_emb) {
      const float dist0 = sqrtf(r0 + 1e-8f);
#pragma unroll
      for (int k = 0; k < kNumFreq; ++k) {
        f[k] = sinf(norm * kFreq[k]);
        f[kNumFreq + k] = cosf(norm * kFreq[k]);
        f[2 * kNumFreq + k] = sinf(dist0 * kFreq[k]);
        f[3 * kNumFreq + k] = cosf(dist0 * kFreq[k]);
      }
    } else {
      f[0] = r;
      f[1] = r0;
    }
    em[j] = j == i ? 0.f : mi * a.mask[rj];
  }
  __syncthreads();

  // 2. Row i's silu(pre) tile, also written out for the W2 gradient.
  const float src = a.proj[row_i * 2 * H + c];
  const float bias1 = a.b1[c];
  float we[kMaxEdgeFeat];
#pragma unroll
  for (int e = 0; e < kMaxEdgeFeat; ++e)
    we[e] = e < E ? a.w1[(size_t)c * a.ld1 + 2 * H + e] : 0.f;
  for (int j = 0; j < NMAX; ++j) {
    float v = 0.f;
    if (j < N) {
      const float dst = a.proj[((size_t)b * N + j) * 2 * H + H + c];
      float ew = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxEdgeFeat; ++e) ew = fmaf(ef[j * kMaxEdgeFeat + e], we[e], ew);
      v = silu_f(src + dst + ew + bias1);
      a.abuf[(edge0 + j) * H + c] = v;
    }
    As[j * H + c] = v;
  }
  __syncthreads();

  // 3. Second layer: acc[j] = mm_j[c] - b2[c].
  float acc[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) acc[j] = 0.f;
  row_tile_product<NMAX, false>(As, Ws, a.w2, H, c, acc);
  const float bias2 = a.b2[c];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) acc[j] += bias2;  // mm_j[c]

  // 4. Per-edge scalars: the gate / coordinate logit sum_c m_j[c] w_out[c]
  //    and, for the gate, sum_c d(m'_j)[c] m_j[c].
  const float wo = (COORD || a.attention) ? a.w_out[c] : 0.f;
  const float dagg = COORD ? 0.f : a.dagg[row_i * H + c] / a.norm_div;
  if (COORD || a.attention) {
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      const float m = silu_f(acc[j]);
      float p = m * wo, p2 = m * dagg;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, o);
        p2 += __shfl_xor_sync(0xffffffffu, p2, o);
      }
      if (lane == 0) {
        red[warp * NMAX + j] = p;
        red2[warp * NMAX + j] = p2;
      }
    }
    __syncthreads();
    float daggx[3] = {0.f, 0.f, 0.f};
    if (COORD) {
#pragma unroll
      for (int q = 0; q < 3; ++q) daggx[q] = a.gx[row_i * 3 + q] * mi / a.norm_div;
    }
    for (int j = c; j < NMAX; j += H) {
      float s = 0.f, s2 = 0.f;
      for (int w = 0; w < nwarp; ++w) {
        s += red[w * NMAX + j];
        s2 += red2[w * NMAX + j];
      }
      if (COORD) {
        // s_ij = tanh(l) * range; ds_ij = em (daggx . cd); dcd = daggx s em.
        const float th = tanhf(s);
        const float scale = a.use_tanh ? th * a.coords_range : s;
        const float dotc = daggx[0] * cd[j * 3] + daggx[1] * cd[j * 3 + 1] +
                           daggx[2] * cd[j * 3 + 2];
        const float ds = em[j] * dotc;
        if (j < N) {
#pragma unroll
          for (int q = 0; q < 3; ++q) a.dcd[(edge0 + j) * 3 + q] = daggx[q] * scale * em[j];
        }
        rs2[j] = a.use_tanh ? ds * a.coords_range * (1.f - th * th) : ds;
      } else {
        // gate g = sigmoid(l + ba); q = g (1 - g) em (dagg . m).
        const float g = sigmoid_f(s + a.b_out[0]);
        rs[j] = g;
        rs2[j] = g * (1.f - g) * em[j] * s2;
      }
    }
    __syncthreads();
  }

  // 5. d(mm_j)[c] into As (the silu(pre) tile is no longer read) and out.
  float db2 = 0.f, dwo = 0.f, dbo = 0.f;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    const float mm = acc[j];
    const float m = silu_f(mm);
    float dm;
    if (COORD) {
      dm = rs2[j] * wo;
      dwo = fmaf(rs2[j], m, dwo);
    } else if (a.attention) {
      dm = dagg * em[j] * rs[j] + rs2[j] * wo;
      dwo = fmaf(rs2[j], m, dwo);
      dbo += rs2[j];
    } else {
      dm = dagg * em[j];
    }
    const float dmm = dm * dsilu_f(mm);
    db2 += dmm;
    As[j * H + c] = dmm;
    if (j < N) a.dbuf[(edge0 + j) * H + c] = dmm;
  }
  const int ps = (3 + E) * H;
  a.part[row_i * ps + c] = db2;
  a.part[row_i * ps + H + c] = dwo;
  a.part[row_i * ps + 2 * H + c] = c == 0 ? dbo : 0.f;
  __syncthreads();

  // 6. d(silu(pre_j))[c] = sum_k d(mm_j)[k] W2[k][c].
#pragma unroll
  for (int j = 0; j < NMAX; ++j) acc[j] = 0.f;
  row_tile_product<NMAX, true>(As, Ws, a.w2, H, c, acc);

  // 7. d(pre_j)[c]: into As, pbuf and the row sum.
  float rsum = 0.f;
  for (int j = 0; j < NMAX; ++j) {
    float dp = 0.f;
    if (j < N) {
      const float dst = a.proj[((size_t)b * N + j) * 2 * H + H + c];
      float ew = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxEdgeFeat; ++e) ew = fmaf(ef[j * kMaxEdgeFeat + e], we[e], ew);
      dp = acc[j] * dsilu_f(src + dst + ew + bias1);
      a.pbuf[(edge0 + j) * H + c] = dp;
    }
    As[j * H + c] = dp;
    rsum += dp;
  }
  a.rowsum[row_i * H + c] = rsum;
  __syncthreads();

  // 8. Edge-feature columns of W1: dWe[e][c] = sum_j ef[j][e] d(pre_j)[c].
  for (int e = 0; e < E; ++e) {
    float s = 0.f;
    for (int j = 0; j < N; ++j) s = fmaf(ef[j * kMaxEdgeFeat + e], As[j * H + c], s);
    a.part[row_i * ps + (3 + e) * H + c] = s;
  }

  // 9. Squared-distance features (not sin, whose features carry no
  //    gradient): dr_ij += sum_c d(pre_j)[c] We[c][0], dr0 with We[c][1].
  if (!a.sin_emb) {
    for (int j = 0; j < N; ++j) {
      const float dp = As[j * H + c];
      float p = dp * we[0], p0 = dp * we[1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, o);
        p0 += __shfl_xor_sync(0xffffffffu, p0, o);
      }
      if (lane == 0) {
        red[warp * NMAX + j] = p;
        red2[warp * NMAX + j] = p0;
      }
    }
    __syncthreads();
    for (int j = c; j < N; j += H) {
      float s = 0.f, s0 = 0.f;
      for (int w = 0; w < nwarp; ++w) {
        s += red[w * NMAX + j];
        s0 += red2[w * NMAX + j];
      }
      a.dr[edge0 + j] += s;
      a.dr0[edge0 + j] += s0;
    }
  }
}

template <int NMAX, bool COORD>
int launch_edge_bwd_n(const EdgeBwdArgs& a, int B, cudaStream_t s) {
  const size_t smem = edge_bwd_smem_bytes(NMAX, a.H);
  cudaError_t e = cudaFuncSetAttribute(edge_bwd_kernel<NMAX, COORD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  edge_bwd_kernel<NMAX, COORD><<<dim3(a.N, B), a.H, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool COORD>
int launch_edge_bwd(const EdgeBwdArgs& a, int B, cudaStream_t s) {
  if (a.N <= 16) return launch_edge_bwd_n<16, COORD>(a, B, s);
  if (a.N <= 24) return launch_edge_bwd_n<24, COORD>(a, B, s);
  if (a.N <= 32) return launch_edge_bwd_n<32, COORD>(a, B, s);
  return launch_edge_bwd_n<kMaxNodes, COORD>(a, B, s);
}

// Scratch layout, in floats (M = B*N node rows, Me = B*N*N edge rows).
struct Scratch : EdgeGradBufs {
  float *hs, *aggs, *zs, *us, *proj, *dcur, *dnext, *dagg, *dtmp, *dr, *dr0, *dcd;
};

size_t scratch_layout(int B, int N, int H, int E, int n_gcl, float* base, Scratch* s) {
  const size_t M = (size_t)B * N, Me = M * N;
  const size_t sizes[] = {
      n_gcl * M * H, n_gcl * M * H, n_gcl * M * H, n_gcl * M * H, M * 2 * H,
      Me * H, Me * H, Me * H, M * H, M * H, M * H, M * H, M * H, M * H,
      M * (3 + E) * H, Me, Me, Me * 3, (size_t)kMaxSplits * H * H};
  float** ptrs[] = {&s->hs, &s->aggs, &s->zs, &s->us, &s->proj, &s->abuf, &s->dbuf,
                    &s->pbuf, &s->rowsum, &s->colsum, &s->dcur, &s->dnext, &s->dagg,
                    &s->dtmp, &s->part, &s->dr, &s->dr0, &s->dcd, &s->split.buf};
  s->split.cap = sizes[sizeof(sizes) / sizeof(sizes[0]) - 1];
  size_t off = 0;
  for (int k = 0; k < (int)(sizeof(sizes) / sizeof(sizes[0])); ++k) {
    if (base) *ptrs[k] = base + off;
    off += (sizes[k] + 63) / 64 * 64;  // 256-byte aligned pieces
  }
  return off;
}

}  // namespace

extern "C" {

const char* egnn_block_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of device scratch egnn_block_backward needs for these shapes.
size_t egnn_block_backward_scratch_floats(int B, int N, int H, int E, int n_gcl) {
  Scratch s;
  return scratch_layout(B, N, H, E, n_gcl, nullptr, &s);
}

// gcl_w / coord_w: weight pointers in egnn_block_forward's order; gcl_g /
// coord_g: gradient outputs in the same order (att_mlp entries null without
// attention); every gradient is overwritten. scratch: a device buffer of
// egnn_block_backward_scratch_floats floats. Returns a cudaError_t value.
int egnn_block_backward(const float* h, const float* x, const float* x0, const float* mask,
                        const float* gh, const float* gx, float* dh, float* dx, float* dx0,
                        const void* const* gcl_w, const void* const* coord_w,
                        void* const* gcl_g, void* const* coord_g, float* scratch, int B,
                        int N, int H, int E, int n_gcl, int attention, int sin_emb,
                        int use_tanh, int mean_agg, float coords_range, float norm_constant,
                        float normalization_factor, void* stream) {
  if (B < 1 || N < 1 || N > kMaxNodes || H < 32 || H > kMaxHidden || H % 32 ||
      E < 2 || E > kMaxEdgeFeat || n_gcl < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Scratch sc;
  scratch_layout(B, N, H, E, n_gcl, scratch, &sc);
  const int M = B * N;
  const size_t Me = (size_t)M * N;
  Dims d = {B, N, H, E, 2 * H + E, mean_agg ? (float)N : normalization_factor, N};
  const int nblk = (M * H + 255) / 256;
  int rc;
  cudaError_t ce;
  if ((ce = cudaMemsetAsync(sc.dr, 0, Me * sizeof(float), s))) return (int)ce;
  if ((ce = cudaMemsetAsync(sc.dr0, 0, Me * sizeof(float), s))) return (int)ce;
  if ((ce = cudaMemsetAsync(sc.dcd, 0, Me * 3 * sizeof(float), s))) return (int)ce;

  // 1. Forward recompute of the node-level chain.
  EdgeArgs ea = {};
  ea.x = x; ea.x0 = x0; ea.mask = mask; ea.proj = sc.proj;
  ea.ld1 = d.ld1; ea.N = N; ea.H = H; ea.E = E;
  ea.sin_emb = sin_emb; ea.attention = attention; ea.use_tanh = use_tanh;
  ea.coords_range = coords_range; ea.norm_constant = norm_constant; ea.norm_div = d.norm_div;
  const float* const* gw = reinterpret_cast<const float* const*>(gcl_w);
  const float* hc = h;
  for (int gi = 0; gi < n_gcl; ++gi) {
    const float* const* w = gw + 10 * gi;
    float* agg = sc.aggs + (size_t)gi * M * H;
    float* z = sc.zs + (size_t)gi * M * H;
    float* u = sc.us + (size_t)gi * M * H;
    float* hn = sc.hs + (size_t)gi * M * H;
    if ((rc = launch_projection(hc, w[0], d.ld1, sc.proj, M, H, s))) return rc;
    ea.w1 = w[0]; ea.b1 = w[1]; ea.w2 = w[2]; ea.b2 = w[3];
    ea.w_out = w[4]; ea.b_out = w[5]; ea.agg = agg; ea.x_out = nullptr;
    if ((rc = launch_edge<false>(ea, B, s))) return rc;
    GemmArgs n1 = {};
    n1.a1 = hc; n1.lda1 = H; n1.k1 = H; n1.a2 = agg; n1.lda2 = H;
    n1.w = w[6]; n1.ldw = 2 * H; n1.bias = w[7];
    n1.c = z; n1.ldc = H; n1.M = M; n1.Nout = H; n1.K = 2 * H;
    n1.epilogue = kEpiNone;
    if ((rc = launch_gemm(n1, s))) return rc;
    silu_kernel<<<nblk, 256, 0, s>>>(z, u, M * H);
    if ((rc = (int)cudaGetLastError())) return rc;
    GemmArgs n2 = {};
    n2.a1 = u; n2.lda1 = H; n2.k1 = H;
    n2.w = w[8]; n2.ldw = H; n2.bias = w[9];
    n2.resid = hc; n2.ldr = H; n2.row_mask = mask;
    n2.c = hn; n2.ldc = H; n2.M = M; n2.Nout = H; n2.K = H;
    n2.epilogue = kEpiResidMask;
    if ((rc = launch_gemm(n2, s))) return rc;
    hc = hn;
  }

  EdgeBwdArgs eb = {};
  eb.proj = sc.proj; eb.x = x; eb.x0 = x0; eb.mask = mask; eb.ld1 = d.ld1;
  eb.abuf = sc.abuf; eb.dbuf = sc.dbuf; eb.pbuf = sc.pbuf; eb.rowsum = sc.rowsum;
  eb.part = sc.part; eb.dr = sc.dr; eb.dr0 = sc.dr0; eb.dcd = sc.dcd;
  eb.N = N; eb.H = H; eb.E = E; eb.sin_emb = sin_emb; eb.attention = attention;
  eb.use_tanh = use_tanh; eb.coords_range = coords_range; eb.norm_constant = norm_constant;
  eb.norm_div = d.norm_div;

  // 2. Coordinate update: dL/dh_n = gh * mask + its edge stage's share.
  const float* const* cw = reinterpret_cast<const float* const*>(coord_w);
  float* const* cg = reinterpret_cast<float* const*>(coord_g);
  if ((rc = launch_projection(hc, cw[0], d.ld1, sc.proj, M, H, s))) return rc;
  eb.w1 = cw[0]; eb.b1 = cw[1]; eb.w2 = cw[2]; eb.b2 = cw[3]; eb.w_out = cw[4];
  eb.b_out = nullptr; eb.dagg = nullptr; eb.gx = gx;
  if ((rc = launch_edge_bwd<true>(eb, B, s))) return rc;
  rows_mask_kernel<<<nblk, 256, 0, s>>>(gh, mask, sc.dcur, M, H);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = stage_grads(d, hc, cw[0], cg[0], cg[1], cg[2], cg[3], cg[4], nullptr, sc, sc.dcur,
                        0, s)))
    return rc;

  // 3. GCLs in reverse. dcur = dL/d(output of GCL gi).
  float* const* gg = reinterpret_cast<float* const*>(gcl_g);
  float *dcur = sc.dcur, *dnext = sc.dnext;
  for (int gi = n_gcl - 1; gi >= 0; --gi) {
    const float* const* w = gw + 10 * gi;
    float* const* g = gg + 10 * gi;
    const float* hin = gi == 0 ? h : sc.hs + (size_t)(gi - 1) * M * H;
    const float* agg = sc.aggs + (size_t)gi * M * H;
    const float* z = sc.zs + (size_t)gi * M * H;
    const float* u = sc.us + (size_t)gi * M * H;
    // Node MLP: out = (hin + silu([hin, agg] Wn1^T + bn1) Wn2^T + bn2) * mask.
    if ((rc = node_mlp_backward(dcur, mask, hin, agg, z, u, w, g, sc.dtmp, sc.dagg, dnext, M, H,
                                0, sc.split, s)))
      return rc;
    // Edge stage.
    if ((rc = launch_projection(hin, w[0], d.ld1, sc.proj, M, H, s))) return rc;
    eb.w1 = w[0]; eb.b1 = w[1]; eb.w2 = w[2]; eb.b2 = w[3]; eb.w_out = w[4];
    eb.b_out = w[5]; eb.dagg = sc.dagg; eb.gx = nullptr;
    if ((rc = launch_edge_bwd<false>(eb, B, s))) return rc;
    if ((rc = stage_grads(d, hin, w[0], g[0], g[1], g[2], g[3], attention ? g[4] : nullptr,
                          attention ? g[5] : nullptr, sc, dnext, 0, s)))
      return rc;
    float* t = dcur; dcur = dnext; dnext = t;
  }
  if ((ce = cudaMemcpyAsync(dh, dcur, (size_t)M * H * sizeof(float), cudaMemcpyDeviceToDevice,
                            s)))
    return (int)ce;

  // 4. Coordinates.
  coord_grad_kernel<true><<<(M + 127) / 128, 128, 0, s>>>(x, x0, mask, gx, sc.dcd, sc.dr,
                                                          sc.dr0, dx, dx0, M, N, norm_constant);
  return (int)cudaGetLastError();
}

}  // extern "C"
