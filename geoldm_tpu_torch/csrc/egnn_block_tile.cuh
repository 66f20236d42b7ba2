// Device code of the whole-molecule EquivariantBlock kernels (#1 forward in
// egnn_block.cu, #2 backward in egnn_block_bwd.cu): the multi-row edge tile,
// its split-TF32 tensor-core product, the forward edge stages and the
// forward chain both libraries run (the backward recomputes with it, so a
// recomputed activation equals the forward's saved one bit for bit). See
// egnn_block.cu for the design and what bounds it on an H100.

#pragma once

#include <stdint.h>

#include "egnn_bwd_common.cuh"

// The tile kernels' dynamic shared memory. Its regions sit at fixed offsets
// from this symbol (TileCfg, TileEdges), so an address costs no register.
extern __shared__ __align__(16) float tile_smem[];

namespace {

// Edge rows (M) of one tile: R = kTileRows / N whole rows i of one molecule,
// each with its N columns j, edge row e = (i - i0) * N + j.
constexpr int kTileRows = 64;

// The edge tiles' activations use the fast exponential and division (a few
// ulp; the outputs stay ~1e-6 relative to the plain version).
__device__ __forceinline__ float tile_sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float tile_silu(float v) { return v * tile_sigmoid(v); }
__device__ __forceinline__ float tile_dsilu(float v) {
  const float s = tile_sigmoid(v);
  return s * (1.f + v * (1.f - s));
}

int tile_rows(int N) { return N >= kTileRows ? 1 : kTileRows / N; }
int tiles_per_molecule(int N) { const int r = tile_rows(N); return (N + r - 1) / r; }

// A tile kernel runs HP threads, HP = the hidden width rounded up to 64,
// 128, 256 or 512 (channels past H are masked). Its warps form a 2 x HP/64
// grid over the [64, HP] product; each warp owns 32 rows x 64 columns, two
// m16 and eight n8 mma tiles (64 f32 accumulators a thread). Up to HP=256
// two CTAs share an SM (at most 128 registers a thread, 105 KB of shared
// memory each), so one CTA's products overlap the other's elementwise passes.
template <int HP>
struct TileCfg {
  static constexpr int kThreads = HP;
  static constexpr int kWarps = HP / 32;
  static constexpr int kMinBlocks = HP >= 512 ? 1 : 2;
  static constexpr int kKC = 16;         // W2 depth of one shared stage
  static constexpr int kLdA = HP + 4;    // [64][HP] tile, conflict-free fragments
  static constexpr int kWStage = HP * kKC;  // XOR-swizzled (w_index), no padding
  // As | two W2 stages | ef [64][kMaxEdgeFeat] | em [64] | cd [64][3] | rs [64] |
  // rs2 [64] | ei, ej [64] (ints)
  static constexpr size_t kSmemFloats = (size_t)kTileRows * kLdA + 2 * kWStage +
                                        kTileRows * (kMaxEdgeFeat + 1 + 3 + 2 + 2);
};

// Offset of W2 element (k, n) of a K chunk in a shared stage. The forward
// product's stage is [n][kk] (B(k, n) = W2[n][kk]), the transposed one's
// [kk][n] (B(k, n) = W2[kk][n]); the XOR swizzle keeps the 16-byte groups
// that cp.async writes whole and spreads an mma fragment's 32 reads over the
// 32 banks.
template <int HP, bool TRANS>
__device__ __forceinline__ int w_index(int kk, int n) {
  return TRANS ? kk * HP + (n ^ ((kk & 3) << 3)) : n * 16 + (kk ^ (((n >> 1) & 3) << 2));
}

// ---------------------------------------------------------------------------
// Split TF32 on the tensor cores: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi); a*b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b, each product
// exact in the mma and summed in f32. The dropped lo_a lo_b is below 2^-22
// |a b|, so a product keeps about f32's accuracy (one TF32 product alone
// keeps 2^-11, which fails the 1e-4 gates).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b over one m16n8k8 tile (a row-major 16x8, b col-major 8x8).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three split products of one tile, small terms first.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ahi, const uint32_t* alo,
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(c, alo, bh0, bh1);
  mma_tf32(c, ahi, bl0, bl1);
  mma_tf32(c, ahi, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// One K chunk of W2 [H, H] into a shared stage, zero past H.
template <int HP, bool TRANS>
__device__ __forceinline__ void load_w_chunk(float* Ws, const float* w, int H, int k0) {
  using C = TileCfg<HP>;
  constexpr int KC = C::kKC;
  if (!TRANS) {
    for (int idx = threadIdx.x; idx < HP * (KC / 4); idx += C::kThreads) {
      const int n = idx / (KC / 4), q = idx % (KC / 4);
      const bool ok = n < H;
      cp_async16(Ws + w_index<HP, false>(4 * q, n), ok ? w + (size_t)n * H + k0 + 4 * q : w, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < KC * (HP / 4); idx += C::kThreads) {
      const int kk = idx / (HP / 4), q = idx % (HP / 4);
      const bool ok = 4 * q < H;
      cp_async16(Ws + w_index<HP, true>(kk, 4 * q), ok ? w + (size_t)(k0 + kk) * H + 4 * q : w,
                 ok);
    }
  }
  cp_async_commit();
}

// acc = As[0:64, 0:H] B over k < H, B = W2^T (forward) or W2 (TRANS), W2
// streamed through two shared stages with cp.async, one barrier a chunk:
// chunk ck+1 loads while ck is multiplied. m16 tiles at or past mrows are
// skipped (warp-uniform). Ends with a barrier: As and the stages may be
// overwritten right after.
template <int HP, bool TRANS>
__device__ __forceinline__ void tile_product(const float* As, float* Wb, const float* w, int H,
                                             int mrows, float (&acc)[2][8][4]) {
  using C = TileCfg<HP>;
  constexpr int KC = C::kKC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  const bool live0 = wm * 32 < mrows, live1 = wm * 32 + 16 < mrows;
  const int nchunks = H / KC;
  load_w_chunk<HP, TRANS>(Wb, w, H, 0);
  for (int ck = 0; ck < nchunks; ++ck) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ck landed for all; all are done with chunk ck - 1
    if (ck + 1 < nchunks)
      load_w_chunk<HP, TRANS>(Wb + ((ck + 1) & 1) * C::kWStage, w, H, (ck + 1) * KC);
    const float* Ws = Wb + (ck & 1) * C::kWStage;
    if (live0) {
      // One k8 step per unrolled body keeps fewer fragments live (two CTAs
      // an SM leave 128 registers a thread).
#pragma unroll 1
      for (int kk = 0; kk < KC; kk += 8) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* ar = As + (wm * 32 + mi * 16 + g) * C::kLdA + ck * KC + kk + t;
          split_tf32(ar[0], ahi[mi][0], alo[mi][0]);
          split_tf32(ar[8 * C::kLdA], ahi[mi][1], alo[mi][1]);
          split_tf32(ar[4], ahi[mi][2], alo[mi][2]);
          split_tf32(ar[8 * C::kLdA + 4], ahi[mi][3], alo[mi][3]);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int n = wn * 64 + ni * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(Ws[w_index<HP, TRANS>(kk + t, n)], bh0, bl0);
          split_tf32(Ws[w_index<HP, TRANS>(kk + t + 4, n)], bh1, bl1);
          mma_3xtf32(acc[0][ni], ahi[0], alo[0], bh0, bh1, bl0, bl1);
          if (live1) mma_3xtf32(acc[1][ni], ahi[1], alo[1], bh0, bh1, bl0, bl1);
        }
      }
    }
  }
  __syncthreads();
}

// As[row][col] = acc + bias[col] (0 past H), through silu when SILU; the
// fragment layout of mma.m16n8k8's C.
template <int HP, bool SILU>
__device__ __forceinline__ void store_acc(float* As, const float (&acc)[2][8][4],
                                          const float* bias, int H) {
  using C = TileCfg<HP>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = wn * 64 + ni * 8 + 2 * t;
    const float b0 = bias && col < H ? __ldg(bias + col) : 0.f;
    const float b1 = bias && col + 1 < H ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = wm * 32 + mi * 16 + g;
      float v[4] = {acc[mi][ni][0] + b0, acc[mi][ni][1] + b1, acc[mi][ni][2] + b0,
                    acc[mi][ni][3] + b1};
      if (SILU) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = tile_silu(v[q]);
      }
      *reinterpret_cast<float2*>(As + row * C::kLdA + col) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(As + (row + 8) * C::kLdA + col) = make_float2(v[2], v[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The edge tile: CTA (ti, b) owns rows i0 = ti * R ... of molecule b.
// ---------------------------------------------------------------------------

struct TileArgs {
  const float* proj;  // [B*N, 2H]: src | dst projections of the stage input
  const float* x;     // [B*N, 3] current coordinates
  const float* x0;    // [B*N, 3] EGNN input coordinates
  const float* mask;  // [B*N]
  const float* w1; int ld1;  // [H, 2H+E]; edge-feature columns start at 2H
  const float* b1;
  const float* w2; const float* b2;  // [H, H], [H]
  const float* w_out;  // GCL: att_mlp.0.weight [1, H]; coord: coord_mlp.4.weight [1, H]
  const float* b_out;  // GCL: att_mlp.0.bias [1]
  float* agg;          // forward GCL output [B*N, H]
  float* x_out;        // forward coordinate output [B*N, 3]
  // Backward (egnn_block_bwd.cu); the edge index of (b, i, j) is (b*N + i)*N + j.
  const float* dagg;   // GCL: [B*N, H] gradient of the aggregate
  const float* gx;     // coord: [B*N, 3] gradient of x_out
  float* abuf;         // [B*N*N, H] silu(pre)
  float* dbuf;         // [B*N*N, H] gradient of the second layer's pre-activation
  float* rowsum;       // [B*N, H] sum_j d(pre)
  float* colpart;      // [B, T, N, H] sum over a tile's rows of d(pre)
  float* part;         // [B*T, (3 + E) * H] per-tile partials: db2 | dw_out | db_out | dWe
  float* dr;           // [B*N*N] += gradient of the squared distance (not sin)
  float* dr0;          // [B*N*N] += gradient of the initial squared distance (not sin)
  float* dcd;          // [B*N*N, 3] coord stage: gradient of coord_diff
  int N, H, E, R, T;
  int sin_emb, attention, use_tanh;
  float coords_range, norm_constant, norm_div;
};

// The per-edge shared arrays of a tile (TileCfg's layout after the W2
// stages).
template <int HP>
struct TileEdges {
  static constexpr int kBase = kTileRows * TileCfg<HP>::kLdA + 2 * TileCfg<HP>::kWStage;
  __device__ static float* ef() { return tile_smem + kBase; }  // [64][kMaxEdgeFeat]
  __device__ static float* em() { return ef() + kTileRows * kMaxEdgeFeat; }
  __device__ static float* cd() { return em() + kTileRows; }  // [64][3]
  __device__ static float* rs() { return cd() + kTileRows * 3; }
  __device__ static float* rs2() { return rs() + kTileRows; }
  // Row i and column j of tile edge e (i0 and 0 past mrows).
  __device__ static int* ei() { return reinterpret_cast<int*>(rs2() + kTileRows); }
  __device__ static int* ej() { return ei() + kTileRows; }
};

// Edge features, edge mask, coord_diff and (i, j) of the tile's mrows edges,
// zero past them.
template <int HP>
__device__ __forceinline__ void tile_geometry(const TileArgs& a, int b, int i0, int mrows) {
  using T = TileEdges<HP>;
  const int N = a.N;
  float *ef = T::ef(), *em = T::em(), *cd = T::cd();
  for (int e = threadIdx.x; e < kTileRows; e += blockDim.x) {
    float* f = ef + e * kMaxEdgeFeat;
#pragma unroll
    for (int k = 0; k < kMaxEdgeFeat; ++k) f[k] = 0.f;
    em[e] = T::rs()[e] = T::rs2()[e] = 0.f;
    cd[e * 3 + 0] = cd[e * 3 + 1] = cd[e * 3 + 2] = 0.f;
    T::ei()[e] = e < mrows ? i0 + e / N : i0;
    T::ej()[e] = e < mrows ? e % N : 0;
    if (e >= mrows) continue;
    const int i = i0 + e / N, j = e % N;
    const size_t ri = (size_t)b * N + i, rj = (size_t)b * N + j;
    float d[3], d0[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      d[q] = a.x[ri * 3 + q] - a.x[rj * 3 + q];
      d0[q] = a.x0[ri * 3 + q] - a.x0[rj * 3 + q];
    }
    const float r = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float r0 = d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2];
    const float norm = sqrtf(r + 1e-8f);
#pragma unroll
    for (int q = 0; q < 3; ++q) cd[e * 3 + q] = d[q] / (norm + a.norm_constant);
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
    em[e] = j == i ? 0.f : a.mask[ri] * a.mask[rj];
  }
}

// The first layer's edge-feature weights of channel c (zero past E or H).
__device__ __forceinline__ void edge_feat_weights(const TileArgs& a, int c, float* we) {
#pragma unroll
  for (int k = 0; k < kMaxEdgeFeat; ++k)
    we[k] = (c < a.H && k < a.E) ? a.w1[(size_t)c * a.ld1 + 2 * a.H + k] : 0.f;
}

// Tile edges are taken kBatch at a time: their projections are loaded
// first, so the loads of a batch overlap.
constexpr int kBatch = 8;

// pre[q] = src_i[c] + dst_j[c] + e_ij . We[c] + b1[c] for tile edges e0 + q
// (0 past mrows), channel c < H.
template <int HP>
__device__ __forceinline__ void edge_pre_batch(const TileArgs& a, const float* we, float bias1,
                                               int b, int e0, int c, float* pre) {
  using T = TileEdges<HP>;
  const int H = a.H;
  const float* pb = a.proj + (size_t)b * a.N * 2 * H + c;  // molecule b's rows, channel c
  float src[kBatch], dst[kBatch];
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const int e = e0 + q;
    src[q] = __ldg(pb + T::ei()[e] * 2 * H);
    dst[q] = __ldg(pb + T::ej()[e] * 2 * H + H);
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const float* f = T::ef() + (e0 + q) * kMaxEdgeFeat;
    float ew = fmaf(f[1], we[1], f[0] * we[0]);
    if (a.sin_emb) {
#pragma unroll
      for (int k = 2; k < kMaxEdgeFeat; ++k) ew = fmaf(f[k], we[k], ew);
    }
    pre[q] = src[q] + dst[q] + ew + bias1;
  }
}

// As[e][c] = silu(pre) for the tile's edges (thread c), zero elsewhere; the
// backward also writes it to abuf.
template <int HP>
__device__ __forceinline__ void build_edge_tile(const TileArgs& a, float* As, int b, int i0,
                                                int mrows, float* abuf) {
  using C = TileCfg<HP>;
  const int c = threadIdx.x, H = a.H, N = a.N;
  float we[kMaxEdgeFeat];
  edge_feat_weights(a, c, we);
  const float bias1 = c < H ? a.b1[c] : 0.f;
  float* ab = abuf ? abuf + ((size_t)b * N + i0) * N * H + c : nullptr;  // tile edge 0, channel c
  for (int e0 = 0; e0 < kTileRows; e0 += kBatch) {
    float pre[kBatch];
    if (c < H) edge_pre_batch<HP>(a, we, bias1, b, e0, c, pre);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + q;
      float v = 0.f;
      if (e < mrows && c < H) {
        v = tile_silu(pre[q]);
        if (ab) ab[e * H] = v;
      }
      As[e * C::kLdA + c] = v;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One forward edge stage over a tile: the GCL's aggregate of rows i0 ...
// (COORD false) or their coordinate update.
template <int HP, bool COORD>
__global__ void __launch_bounds__(HP, TileCfg<HP>::kMinBlocks) edge_tile_kernel(TileArgs a) {
  using C = TileCfg<HP>;
  using T = TileEdges<HP>;
  float* As = tile_smem;
  float* Wb = As + kTileRows * C::kLdA;
  const float *em = T::em(), *cd = T::cd();
  float* rs = T::rs();
  const int H = a.H, N = a.N;
  const int c = threadIdx.x, lane = c & 31, warp = c >> 5;
  const int b = blockIdx.y, i0 = blockIdx.x * a.R;
  const int nrows = min(a.R, N - i0), mrows = nrows * N;

  tile_geometry<HP>(a, b, i0, mrows);
  __syncthreads();
  build_edge_tile<HP>(a, As, b, i0, mrows, nullptr);
  __syncthreads();
  // m = silu(silu(pre) W2^T + b2).
  {
    float acc[2][8][4];
    tile_product<HP, false>(As, Wb, a.w2, H, mrows, acc);
    store_acc<HP, true>(As, acc, a.b2, H);
  }
  __syncthreads();
  // rs_e = sum_c m_e[c] w_out[c] (the gate logit or coordinate scale), one
  // warp per edge (two at a time) in a fixed order.
  if (COORD || a.attention) {
    for (int e = warp; e < mrows; e += 2 * C::kWarps) {
      const int e2 = e + C::kWarps < mrows ? e + C::kWarps : e;
      float s = 0.f, s2 = 0.f;
#pragma unroll 4
      for (int k = lane; k < H; k += 32) {
        const float w = __ldg(a.w_out + k);
        s = fmaf(As[e * C::kLdA + k], w, s);
        s2 = fmaf(As[e2 * C::kLdA + k], w, s2);
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      if (lane == 0) {
        rs[e] = COORD ? (a.use_tanh ? tanhf(s) * a.coords_range : s) : sigmoid_f(s + a.b_out[0]);
        if (e2 != e)
          rs[e2] = COORD ? (a.use_tanh ? tanhf(s2) * a.coords_range : s2)
                         : sigmoid_f(s2 + a.b_out[0]);
      }
    }
    __syncthreads();
  }
  if (!COORD) {
    if (c < H) {
      for (int r = 0; r < nrows; ++r) {
        float agg = 0.f;
#pragma unroll 8
        for (int j = 0; j < N; ++j) {
          const int e = r * N + j;
          const float m = As[e * C::kLdA + c];
          agg += (a.attention ? m * rs[e] : m) * em[e];
        }
        a.agg[((size_t)b * N + i0 + r) * H + c] = agg / a.norm_div;
      }
    }
  } else {
    for (int q = c; q < nrows * 3; q += C::kThreads) {
      const int r = q / 3, d = q % 3;
      float aggx = 0.f;
      for (int j = 0; j < N; ++j) {
        const int e = r * N + j;
        aggx += cd[e * 3 + d] * rs[e] * em[e];
      }
      const size_t row = (size_t)b * N + i0 + r;
      a.x_out[row * 3 + d] = (a.x[row * 3 + d] + aggx / a.norm_div) * a.mask[row];
    }
  }
}

template <int HP>
int set_tile_smem(const void* kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(TileCfg<HP>::kSmemFloats * sizeof(float)));
}

template <int HP, bool COORD>
int launch_edge_tile_hp(const TileArgs& a, int B, cudaStream_t s) {
  int rc = set_tile_smem<HP>((const void*)edge_tile_kernel<HP, COORD>);
  if (rc) return rc;
  edge_tile_kernel<HP, COORD><<<dim3(a.T, B), HP, TileCfg<HP>::kSmemFloats * sizeof(float), s>>>(a);
  return (int)cudaGetLastError();
}

template <bool COORD>
int launch_edge_tile(const TileArgs& a, int B, cudaStream_t s) {
  if (a.H <= 64) return launch_edge_tile_hp<64, COORD>(a, B, s);
  if (a.H <= 128) return launch_edge_tile_hp<128, COORD>(a, B, s);
  if (a.H <= 256) return launch_edge_tile_hp<256, COORD>(a, B, s);
  return launch_edge_tile_hp<512, COORD>(a, B, s);
}

// ---------------------------------------------------------------------------
// Node GEMM on the tensor cores (3xTF32), the whole-block kernels' own: C =
// epilogue(A B) with A(m, k) from [M][K] (split by columns at k1 into a1 |
// a2, the node MLP's [h, agg] input without a concat) or, with ta, from
// [K][M]; B(k, n) from an nn.Linear weight [N][K] (tb) or from [K][N].
// 32x64 tiles, 4 warps of 32x16, K in chunks of 32 through shared memory
// while the next chunk's loads wait in registers (plain loads: W1's row
// stride 2H+E is not 16-byte aligned). blockIdx.z splits K; a split writes
// its partial tile to c + z * split_stride.
// ---------------------------------------------------------------------------

struct NodeGemm {
  const float* a1; int lda1; int k1;
  const float* a2; int lda2;
  int ta;
  const float* b; int ldb; int tb;
  const float* bias;      // [N] or null
  const float* resid; int ldr;
  const float* row_mask;  // [M], kEpiResidMask
  float* c; int ldc;
  int M, N, K;
  int epilogue, accumulate;
  int kchunk; size_t split_stride;
};

constexpr int kNgTM = 32, kNgTN = 64, kNgKC = 32;
constexpr int kNgLdR = kNgKC + 4;  // [row][k] stages
constexpr int kNgLdAT = kNgTM + 8, kNgLdBT = kNgTN + 8;  // [k][row] stages
constexpr int kNgA = kNgTM * kNgLdR > kNgKC * kNgLdAT ? kNgTM * kNgLdR : kNgKC * kNgLdAT;
constexpr int kNgB = kNgTN * kNgLdR > kNgKC * kNgLdBT ? kNgTN * kNgLdR : kNgKC * kNgLdBT;
constexpr int kNgAPer = kNgTM * kNgKC / 128, kNgBPer = kNgTN * kNgKC / 128;

__global__ void __launch_bounds__(128) node_gemm_tc_kernel(NodeGemm g) {
  __shared__ __align__(16) float As[kNgA];
  __shared__ __align__(16) float Bs[kNgB];
  const int tid = threadIdx.x, lane = tid & 31, wn = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kNgTM, n0 = blockIdx.x * kNgTN;
  const int kbeg = blockIdx.z * g.kchunk, kend = min(g.K, kbeg + g.kchunk);
  float acc[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  // One chunk is 32x32 of A and 64x32 of B, neighbouring threads on
  // neighbouring addresses.
  float ra[kNgAPer], rb[kNgBPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kNgAPer; ++q) {
      const int idx = tid + 128 * q;
      const int ar = g.ta ? idx % kNgTM : idx / kNgKC, ak = g.ta ? idx / kNgTM : idx % kNgKC;
      const int m = m0 + ar, ka = k0 + ak;
      float v = 0.f;
      if (m < g.M && ka < kend)
        v = g.ta ? g.a1[(size_t)ka * g.lda1 + m]
                 : (ka < g.k1 ? g.a1[(size_t)m * g.lda1 + ka] : g.a2[(size_t)m * g.lda2 + ka - g.k1]);
      ra[q] = v;
    }
#pragma unroll
    for (int q = 0; q < kNgBPer; ++q) {
      const int idx = tid + 128 * q;
      const int bn = g.tb ? idx / kNgKC : idx % kNgTN, bk = g.tb ? idx % kNgKC : idx / kNgTN;
      const int n = n0 + bn, kb = k0 + bk;
      rb[q] = (n < g.N && kb < kend)
                  ? (g.tb ? g.b[(size_t)n * g.ldb + kb] : g.b[(size_t)kb * g.ldb + n])
                  : 0.f;
    }
  };
  if (kbeg < kend) fetch(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += kNgKC) {
#pragma unroll
    for (int q = 0; q < kNgAPer; ++q) {
      const int idx = tid + 128 * q;
      if (g.ta) As[(idx / kNgTM) * kNgLdAT + idx % kNgTM] = ra[q];
      else As[(idx / kNgKC) * kNgLdR + idx % kNgKC] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < kNgBPer; ++q) {
      const int idx = tid + 128 * q;
      if (g.tb) Bs[(idx / kNgKC) * kNgLdR + idx % kNgKC] = rb[q];
      else Bs[(idx / kNgTN) * kNgLdBT + idx % kNgTN] = rb[q];
    }
    __syncthreads();
    if (k0 + kNgKC < kend) fetch(k0 + kNgKC);
#pragma unroll
    for (int kk = 0; kk < kNgKC; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = mi * 16 + gq;
        float v[4];
        if (g.ta) {
          v[0] = As[(kk + t) * kNgLdAT + r]; v[1] = As[(kk + t) * kNgLdAT + r + 8];
          v[2] = As[(kk + t + 4) * kNgLdAT + r]; v[3] = As[(kk + t + 4) * kNgLdAT + r + 8];
        } else {
          v[0] = As[r * kNgLdR + kk + t]; v[1] = As[(r + 8) * kNgLdR + kk + t];
          v[2] = As[r * kNgLdR + kk + t + 4]; v[3] = As[(r + 8) * kNgLdR + kk + t + 4];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(v[q], ahi[mi][q], alo[mi][q]);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int n = wn * 16 + ni * 8 + gq;
        const float b0 = g.tb ? Bs[n * kNgLdR + kk + t] : Bs[(kk + t) * kNgLdBT + n];
        const float b1 = g.tb ? Bs[n * kNgLdR + kk + t + 4] : Bs[(kk + t + 4) * kNgLdBT + n];
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b0, bh0, bl0);
        split_tf32(b1, bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_3xtf32(acc[mi][ni], ahi[mi], alo[mi], bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();
  }
  float* c = g.c + blockIdx.z * g.split_stride;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + mi * 16 + gq + (q >= 2 ? 8 : 0);
        const int n = n0 + wn * 16 + ni * 8 + 2 * t + (q & 1);
        if (m >= g.M || n >= g.N) continue;
        float v = acc[mi][ni][q];
        if (g.bias) v += g.bias[n];
        if (g.epilogue == kEpiSilu) v = silu_f(v);
        if (g.epilogue == kEpiResidMask) v = (g.resid[(size_t)m * g.ldr + n] + v) * g.row_mask[m];
        float* dst = c + (size_t)m * g.ldc + n;
        *dst = g.accumulate ? *dst + v : v;
      }
}

int launch_node_gemm(const NodeGemm& g, int splits, cudaStream_t s) {
  dim3 grid((g.N + kNgTN - 1) / kNgTN, (g.M + kNgTM - 1) / kNgTM, splits);
  node_gemm_tc_kernel<<<grid, 128, 0, s>>>(g);
  return (int)cudaGetLastError();
}

// The node GEMM with launch_gemm's arguments (egnn_common.cuh): A [M][K]
// split at k1, W [Nout][K], a fused epilogue.
int node_gemm_nt(const GemmArgs& a, cudaStream_t s) {
  NodeGemm g = {};
  g.a1 = a.a1; g.lda1 = a.lda1; g.k1 = a.k1; g.a2 = a.a2; g.lda2 = a.lda2;
  g.b = a.w; g.ldb = a.ldw; g.tb = 1;
  g.bias = a.bias; g.resid = a.resid; g.ldr = a.ldr; g.row_mask = a.row_mask;
  g.c = a.c; g.ldc = a.ldc; g.M = a.M; g.N = a.Nout; g.K = a.K;
  g.epilogue = a.epilogue; g.kchunk = a.K;
  return launch_node_gemm(g, 1, s);
}

// proj[:, :H] = h W1[:, :H]^T and proj[:, H:2H] = h W1[:, H:2H]^T (row
// stride 2H), no bias: b1 is added per edge in the tile.
int node_projection(const float* h, const float* w1, int ld1, float* proj, int M, int H,
                    cudaStream_t s) {
  for (int half = 0; half < 2; ++half) {
    GemmArgs g = {};
    g.a1 = h; g.lda1 = H; g.k1 = H;
    g.w = w1 + half * H; g.ldw = ld1;
    g.c = proj + half * H; g.ldc = 2 * H;
    g.M = M; g.Nout = H; g.K = H;
    g.epilogue = kEpiNone;
    const int rc = node_gemm_nt(g, s);
    if (rc) return rc;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The forward chain, shared by the forward and the backward's recompute.
// ---------------------------------------------------------------------------

struct BlockShape {
  int B, N, H, E, n_gcl;
  int attention, sin_emb, use_tanh;
  float coords_range, norm_constant, norm_div;
};

TileArgs tile_args(const BlockShape& d, const float* x, const float* x0, const float* mask,
                   const float* proj) {
  TileArgs a = {};
  a.proj = proj; a.x = x; a.x0 = x0; a.mask = mask;
  a.ld1 = 2 * d.H + d.E; a.N = d.N; a.H = d.H; a.E = d.E;
  a.R = tile_rows(d.N); a.T = tiles_per_molecule(d.N);
  a.sin_emb = d.sin_emb; a.attention = d.attention; a.use_tanh = d.use_tanh;
  a.coords_range = d.coords_range; a.norm_constant = d.norm_constant; a.norm_div = d.norm_div;
  return a;
}

// The block's forward on stream s. save (or null): [4][n_gcl][B*N, H], each
// GCL's output h, aggregate, node-MLP pre-activation z and silu(z), which
// the backward reads; h_out is then a copy of the last GCL's output. With
// save null, agg and hidden ([B*N, H] scratch) hold the aggregate and silu(z)
// and h_out is written in place from the second GCL on. coord false skips
// the coordinate stage (x_out unread). proj: [B*N, 2H] scratch.
int block_forward_chain(const BlockShape& d, const float* h, const float* x, const float* x0,
                        const float* mask, float* h_out, float* x_out, float* proj, float* agg,
                        float* hidden, float* save, const void* const* gcl_w,
                        const void* const* coord_w, bool coord, cudaStream_t s) {
  const int M = d.B * d.N, H = d.H, ld1 = 2 * H + d.E;
  const size_t MH = (size_t)M * H, plane = (size_t)d.n_gcl * MH;
  TileArgs ea = tile_args(d, x, x0, mask, proj);
  const float* hc = h;
  int rc;
  for (int gi = 0; gi < d.n_gcl; ++gi) {
    const float* const* w = reinterpret_cast<const float* const*>(gcl_w) + 10 * gi;
    float* hn = save ? save + gi * MH : h_out;
    float* ag = save ? save + plane + gi * MH : agg;
    float* z = save ? save + 2 * plane + gi * MH : nullptr;
    float* u = save ? save + 3 * plane + gi * MH : hidden;
    if ((rc = node_projection(hc, w[0], ld1, proj, M, H, s))) return rc;
    ea.w1 = w[0]; ea.b1 = w[1]; ea.w2 = w[2]; ea.b2 = w[3];
    ea.w_out = w[4]; ea.b_out = w[5]; ea.agg = ag; ea.x_out = nullptr;
    if ((rc = launch_edge_tile<false>(ea, d.B, s))) return rc;

    // u = silu([h, agg] Wn1^T + bn1): fused, or through z when saved (the
    // same bits: silu of the stored f32 z).
    GemmArgs n1 = {};
    n1.a1 = hc; n1.lda1 = H; n1.k1 = H; n1.a2 = ag; n1.lda2 = H;
    n1.w = w[6]; n1.ldw = 2 * H; n1.bias = w[7];
    n1.c = save ? z : u; n1.ldc = H; n1.M = M; n1.Nout = H; n1.K = 2 * H;
    n1.epilogue = save ? kEpiNone : kEpiSilu;
    if ((rc = node_gemm_nt(n1, s))) return rc;
    if (save) {
      silu_kernel<<<(int)((MH + 255) / 256), 256, 0, s>>>(z, u, (int)MH);
      if ((rc = (int)cudaGetLastError())) return rc;
    }
    // In place for gi > 0 without save: each output element reads only its
    // own residual.
    GemmArgs n2 = {};
    n2.a1 = u; n2.lda1 = H; n2.k1 = H;
    n2.w = w[8]; n2.ldw = H; n2.bias = w[9];
    n2.resid = hc; n2.ldr = H; n2.row_mask = mask;
    n2.c = hn; n2.ldc = H; n2.M = M; n2.Nout = H; n2.K = H;
    n2.epilogue = kEpiResidMask;
    if ((rc = node_gemm_nt(n2, s))) return rc;
    hc = hn;
  }
  if (save && h_out) {
    cudaError_t ce = cudaMemcpyAsync(h_out, hc, MH * sizeof(float), cudaMemcpyDeviceToDevice, s);
    if (ce != cudaSuccess) return (int)ce;
  }
  if (!coord) return 0;
  const float* const* cw = reinterpret_cast<const float* const*>(coord_w);
  if ((rc = node_projection(hc, cw[0], ld1, proj, M, H, s))) return rc;
  ea.w1 = cw[0]; ea.b1 = cw[1]; ea.w2 = cw[2]; ea.b2 = cw[3];
  ea.w_out = cw[4]; ea.b_out = nullptr; ea.agg = nullptr; ea.x_out = x_out;
  return launch_edge_tile<true>(ea, d.B, s);
}

}  // namespace
