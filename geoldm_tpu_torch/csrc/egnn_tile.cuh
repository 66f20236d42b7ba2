// The 64-edge-row tile of the EquivariantBlock edge stages on Hopper, shared
// by the whole-molecule kernels (egnn_block_tile.cuh: #1, #2) and the
// row-tiled grids (egnn_rows.cuh: #3, #4, #6; egnn_rows_bwd.cuh: #5, #7):
// the tile's shared-memory layout, its split-TF32 tensor-core product with
// W2 streamed through cp.async stages (and the bf16 products of the bf16
// variants: both operands in bf16 for the forward products, an f32
// cotangent against a bf16 W2 for the backward's transposed product), the
// edge geometry and first layer of a tile, and the per-edge gate / scale
// and the row sums in a fixed order.
// A tile's edges are (row, column) pairs of one molecule: whole rows for #1
// and #2, a window of one row's columns for the row grid. See egnn_block.cu
// and egnn_tiled.cu for the designs and what bounds them on an H100.

#pragma once

#include <stdint.h>

#include "egnn_common.cuh"

// The tile kernels' dynamic shared memory. Its regions sit at fixed offsets
// from this symbol (TileCfg, TileEdges), so an address costs no register.
extern __shared__ __align__(16) float tile_smem[];

namespace {

// threadIdx.x, read anew where used: a tile kernel that loops over tiles
// (the row grid) would otherwise keep every thread-derived index live across
// the product.
__device__ __forceinline__ int tile_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Edge rows (M) of one tile: #1/#2 take R = kTileRows / N whole rows i of
// one molecule, each with its N columns j, edge row e = (i - i0) * N + j; the
// row grid takes one row i and a window of kTileRows columns j0 + e.
constexpr int kTileRows = 64;

// The edge tiles' activations use the fast exponential and division (a few
// ulp; the outputs stay ~1e-6 relative to the plain version).
__device__ __forceinline__ float tile_sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float tile_silu(float v) { return v * tile_sigmoid(v); }
__device__ __forceinline__ float tile_dsilu(float v) {
  const float s = tile_sigmoid(v);
  return s * (1.f + v * (1.f - s));
}

// ---------------------------------------------------------------------------
// The low-precision edge chain (LOWP: kernels #1/#2's variants for JAX's
// GEOLDM_PALLAS_EDGE_LOWP, _block_math with edge_dtype bf16): every value of
// the chain is a bf16 (held exactly in f32 registers and shared memory);
// each sigmoid is taken in f32 from its bf16 input and rounded to bf16
// (JAX's _sigmoid), and each product or sum of two chain values is one bf16
// operation (packed, two a register where the values come in pairs; a bf16
// sum or product rounded once equals the f32 one rounded, since f32 holds
// more than twice bf16's 8 bits). The backward rounds each cotangent of a
// bf16 value to bf16, as autograd through the plain version and jax.vjp of
// _block_math do. The chain's sigmoid is the tiles' fast one: with the
// accurate one (sigmoid_f) #1/#2's mean distance to their plain versions was
// the same to four digits.
// ---------------------------------------------------------------------------

// _silu of two bf16 values x: x * bf16(sigmoid(x)), the product in bf16.
__device__ __forceinline__ __nv_bfloat162 lowp_silu2(__nv_bfloat162 x) {
  const float2 f = __bfloat1622float2(x);
  return __hmul2(x, __floats2bfloat162_rn(tile_sigmoid(f.x), tile_sigmoid(f.y)));
}

// _silu of one bf16 value (the same bits as lowp_silu2's).
__device__ __forceinline__ float lowp_silu(float x) {
  return bf16_round(x * bf16_round(tile_sigmoid(x)));
}

// The cotangent of bf16 x through _silu(x) from dy, that of its output:
// dy * s and dy * x rounded to bf16 (the product's two operands, s =
// bf16(sigmoid(x))), the latter through the f32 sigmoid's derivative and
// rounded (the cotangent of the sigmoid's bf16 input), the two summed in
// bf16. Written in the order torch's sigmoid backward takes, g (1 - y) y.
__device__ __forceinline__ float lowp_dsilu(float x, float dy) {
  const float y = tile_sigmoid(x);
  const float dx = bf16_round(dy * bf16_round(y));
  const float ds = bf16_round(dy * x);
  return bf16_round(dx + bf16_round(ds * (1.f - y) * y));
}

// The attention gate of one edge from its logit sum s (f32, of bf16
// operands): the product's output rounded, the bias rounded and added in
// bf16, the sigmoid in f32 rounded. y: the f32 sigmoid (for the backward).
__device__ __forceinline__ float lowp_gate(float s, float bias, float* y = nullptr) {
  const float u = bf16_round(bf16_round(s) + bf16_round(bias));
  const float yv = sigmoid_f(u);
  if (y) *y = yv;
  return bf16_round(yv);
}

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

// A split f32 a against a b that is exact in TF32 (a bf16 value: its 8
// mantissa bits fit TF32's 10), small term first: two products where split
// TF32 takes three, a kept to about 2^-22 (the bf16 backward's cotangent
// side of a product, whose other operand is rounded to bf16).
__device__ __forceinline__ void mma_2xtf32(float* c, const uint32_t* ahi, const uint32_t* alo,
                                           uint32_t b0, uint32_t b1) {
  mma_tf32(c, alo, b0, b1);
  mma_tf32(c, ahi, b0, b1);
}

// x rounded to bf16, as a TF32 operand (exact).
__device__ __forceinline__ uint32_t bf16_tf32(float x) { return __float_as_uint(bf16_round(x)); }

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
    for (int idx = tile_tid(); idx < HP * (KC / 4); idx += C::kThreads) {
      const int n = idx / (KC / 4), q = idx % (KC / 4);
      const bool ok = n < H;
      cp_async16(Ws + w_index<HP, false>(4 * q, n), ok ? w + (size_t)n * H + k0 + 4 * q : w, ok);
    }
  } else {
    for (int idx = tile_tid(); idx < KC * (HP / 4); idx += C::kThreads) {
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
// overwritten right after. RB (the bf16 backward's transposed product): B
// rounded to bf16 as it is read, As kept in f32 by split TF32, two mma a
// k8 step (mma_2xtf32).
template <int HP, bool TRANS, bool RB = false>
__device__ __forceinline__ void tile_product(const float* As, float* Wb, const float* w, int H,
                                             int mrows, float (&acc)[2][8][4]) {
  using C = TileCfg<HP>;
  constexpr int KC = C::kKC;
  const int lane = tile_tid() & 31, warp = tile_tid() >> 5;
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
          if constexpr (RB) {
            const uint32_t b0 = bf16_tf32(Ws[w_index<HP, TRANS>(kk + t, n)]);
            const uint32_t b1 = bf16_tf32(Ws[w_index<HP, TRANS>(kk + t + 4, n)]);
            mma_2xtf32(acc[0][ni], ahi[0], alo[0], b0, b1);
            if (live1) mma_2xtf32(acc[1][ni], ahi[1], alo[1], b0, b1);
          } else {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(Ws[w_index<HP, TRANS>(kk + t, n)], bh0, bl0);
            split_tf32(Ws[w_index<HP, TRANS>(kk + t + 4, n)], bh1, bl1);
            mma_3xtf32(acc[0][ni], ahi[0], alo[0], bh0, bh1, bl0, bl1);
            if (live1) mma_3xtf32(acc[1][ni], ahi[1], alo[1], bh0, bh1, bl0, bl1);
          }
        }
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the bf16 forward variants): operands rounded to
// bf16, each product exact, f32 accumulation, as JAX's _matmul with a bf16
// compute dtype. mma.sync's f32 accumulation rounds toward zero: at the
// forward's K = H <= 512 that drift stays near 2^-24 K of the sum, far
// inside the bf16 operands' own 2^-9.
// ---------------------------------------------------------------------------

// c += a b over one m16n8k16 tile: a row-major 16x16 (a[i] holds row g or
// g+8, k pairs 2t / 2t+8), b col-major 16x8 (b0: k = 2t, 2t+1; b1: k = 2t+8,
// 2t+9; column g); c as mma.m16n8k8's.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// W2 depth of one bf16 shared stage: 32 k of each row n in the bytes of an
// f32 stage's 16, the same XOR-swizzled [n][16 words] layout (w_index over
// words: word kw holds k = 2 kw and 2 kw + 1).
constexpr int kKCBf16 = 32;

// One K chunk of the bf16 W2 (w: [H][H/2] words, converted once per launch)
// into a shared stage, zero past H.
template <int HP>
__device__ __forceinline__ void load_w_chunk_bf16(float* Ws, const uint32_t* w, int H, int k0) {
  using C = TileCfg<HP>;
  for (int idx = tile_tid(); idx < HP * 4; idx += C::kThreads) {
    const int n = idx >> 2, q = idx & 3;
    const bool ok = n < H;
    cp_async16(Ws + w_index<HP, false>(4 * q, n), ok ? w + (size_t)n * (H / 2) + k0 / 2 + 4 * q : w,
               ok);
  }
  cp_async_commit();
}

// tile_product<HP, false> in bf16: acc = bf16(As[0:64, 0:H]) bf16(W2)^T,
// W2 from its bf16 copy w through two shared stages of kKCBf16, the A
// fragments rounded from the f32 tile as they are read (As stays f32 for
// the epilogue). m16 tiles at or past mrows are skipped. Ends with a
// barrier.
template <int HP>
__device__ __forceinline__ void tile_product_bf16(const float* As, float* Wb, const uint32_t* w,
                                                  int H, int mrows, float (&acc)[2][8][4]) {
  using C = TileCfg<HP>;
  const int lane = tile_tid() & 31, warp = tile_tid() >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  const bool live0 = wm * 32 < mrows, live1 = wm * 32 + 16 < mrows;
  const int nchunks = H / kKCBf16;
  load_w_chunk_bf16<HP>(Wb, w, H, 0);
  for (int ck = 0; ck < nchunks; ++ck) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ck landed for all; all are done with chunk ck - 1
    if (ck + 1 < nchunks)
      load_w_chunk_bf16<HP>(Wb + ((ck + 1) & 1) * C::kWStage, w, H, (ck + 1) * kKCBf16);
    const uint32_t* Ws = reinterpret_cast<const uint32_t*>(Wb + (ck & 1) * C::kWStage);
    if (live0) {
#pragma unroll 1
      for (int ks = 0; ks < kKCBf16 / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* ar = As + (wm * 32 + mi * 16 + g) * C::kLdA + ck * kKCBf16 + ks * 16 + 2 * t;
          const float2 r0 = *reinterpret_cast<const float2*>(ar);
          const float2 r1 = *reinterpret_cast<const float2*>(ar + 8 * C::kLdA);
          const float2 r2 = *reinterpret_cast<const float2*>(ar + 8);
          const float2 r3 = *reinterpret_cast<const float2*>(ar + 8 * C::kLdA + 8);
          a[mi][0] = pack_bf16(r0.x, r0.y);
          a[mi][1] = pack_bf16(r1.x, r1.y);
          a[mi][2] = pack_bf16(r2.x, r2.y);
          a[mi][3] = pack_bf16(r3.x, r3.y);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int n = wn * 64 + ni * 8 + g;
          const uint32_t b0 = Ws[w_index<HP, false>(ks * 8 + t, n)];
          const uint32_t b1 = Ws[w_index<HP, false>(ks * 8 + t + 4, n)];
          mma_bf16(acc[0][ni], a[0], b0, b1);
          if (live1) mma_bf16(acc[1][ni], a[1], b0, b1);
        }
      }
    }
  }
  __syncthreads();
}

// As[row][col] = acc + bias[col] (0 past H), through silu when SILU, or
// rounded to bf16 when ROUND (the bf16 backward's transposed product, whose
// result is the gradient of a bf16 operand); the fragment layout of
// mma.m16n8k8's C. LOWP: acc and the bias each rounded to bf16 and added in
// bf16, the silu in bf16 (two adjacent columns a register).
template <int HP, bool SILU, bool ROUND = false, bool LOWP = false>
__device__ __forceinline__ void store_acc(float* As, const float (&acc)[2][8][4],
                                          const float* bias, int H) {
  using C = TileCfg<HP>;
  const int lane = tile_tid() & 31, warp = tile_tid() >> 5;
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
      if constexpr (LOWP) {
        const __nv_bfloat162 bb = __floats2bfloat162_rn(b0, b1);
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          __nv_bfloat162 u = __hadd2(
              __floats2bfloat162_rn(acc[mi][ni][q], acc[mi][ni][q + 1]), bb);
          if (SILU) u = lowp_silu2(u);
          const float2 f = __bfloat1622float2(u);
          v[q] = f.x;
          v[q + 1] = f.y;
        }
      } else if (SILU) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = tile_silu(v[q]);
      }
      if constexpr (ROUND) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = bf16_round(v[q]);
      }
      *reinterpret_cast<float2*>(As + row * C::kLdA + col) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(As + (row + 8) * C::kLdA + col) = make_float2(v[2], v[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// A tile's arguments and edges.
// ---------------------------------------------------------------------------

struct TileArgs {
  // src | dst projections of the stage input, row stride 2H: the src half of
  // the rows' view [B*S], the dst half of the columns' [B*N].
  const float* proj;
  const float* x;     // [B*N, 3] current coordinates of the columns
  const float* x0;    // [B*N, 3] EGNN input coordinates
  const float* mask;  // [B*N]
  // The rows: the slab row0..row0+S of every molecule, its own [B*S, *]
  // views; its diagonal sits at the global row row0 + s. The whole-molecule
  // kernels and the single-device row-tiled stages pass the full view (the
  // same pointers, row0 0, S = N).
  const float* xr; const float* x0r; const float* maskr;
  int row0, S;
  const float* w1; int ld1;  // [H, 2H+E]; edge-feature columns start at 2H
  const float* b1;
  const float* w2; const float* b2;  // [H, H], [H]
  const uint32_t* w2bf;  // bf16 variants: W2 in bf16, [H][H/2] words
  const float* w_out;  // GCL: att_mlp.0.weight [1, H]; coord: coord_mlp.4.weight [1, H]
  const float* b_out;  // GCL: att_mlp.0.bias [1]
  float* agg;          // forward GCL output [B*S, H]
  float* x_out;        // forward coordinate output [B*S, 3]
  // Backward (#2: egnn_block_bwd.cu; #5/#7: egnn_rows_bwd.cuh) over the
  // rows' view: the edge index of (b, row i, column j) is (b*S + i)*N + j,
  // and T is the tiles (#2) or CTAs (the row grid, one row each) of a
  // molecule.
  const float* dagg;   // GCL: [B*S, H] gradient of the aggregate
  const float* gx;     // coord: [B*S, 3] gradient of x_out
  float* abuf;         // [B*S*N, H] silu(pre)
  float* dbuf;         // [B*S*N, H] gradient of the second layer's pre-activation
  float* rowsum;       // [B*S, H] sum_j d(pre)
  float* colpart;      // [B, T, N, H] sum over a tile's rows of d(pre)
  float* part;         // [B*T, (3 + E) * H] per-tile partials: db2 | dw_out | db_out | dWe
  float* dr;           // [B*S*N] gradient of the squared distance (not sin)
  float* dr0;          // [B*S*N] gradient of the initial squared distance (not sin)
  float* dcd;          // [B*S*N, 3] coord stage: gradient of coord_diff
  int N, H, E, R, T;   // R, T: #1/#2's rows a tile and tiles a molecule
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
  // Row i (of the rows' view) and column j of tile edge e (i0 and j0 past
  // mrows).
  __device__ static int* ei() { return reinterpret_cast<int*>(rs2() + kTileRows); }
  __device__ static int* ej() { return ei() + kTileRows; }
};

// Edge features, edge mask, coord_diff and (i, j) of the tile's mrows edges,
// zero past them: edge e is (row i0 + e / W, column j0 + e % W) of molecule
// b (#1/#2: W = N, j0 = 0).
template <int HP>
__device__ __forceinline__ void tile_geometry(const TileArgs& a, int b, int i0, int j0, int W,
                                              int mrows) {
  using T = TileEdges<HP>;
  float *ef = T::ef(), *em = T::em(), *cd = T::cd();
  for (int e = tile_tid(); e < kTileRows; e += blockDim.x) {
    float* f = ef + e * kMaxEdgeFeat;
#pragma unroll
    for (int k = 0; k < kMaxEdgeFeat; ++k) f[k] = 0.f;
    em[e] = T::rs()[e] = T::rs2()[e] = 0.f;
    cd[e * 3 + 0] = cd[e * 3 + 1] = cd[e * 3 + 2] = 0.f;
    T::ei()[e] = e < mrows ? i0 + e / W : i0;
    T::ej()[e] = e < mrows ? j0 + e % W : j0;
    if (e >= mrows) continue;
    const int i = i0 + e / W, j = j0 + e % W;
    const size_t ri = (size_t)b * a.S + i, rj = (size_t)b * a.N + j;
    float d[3], d0[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      d[q] = a.xr[ri * 3 + q] - a.x[rj * 3 + q];
      d0[q] = a.x0r[ri * 3 + q] - a.x0[rj * 3 + q];
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
    em[e] = j == a.row0 + i ? 0.f : a.maskr[ri] * a.mask[rj];
  }
}

// The first layer's edge-feature weights of channel c (zero past E or H),
// rounded to bf16 operands when BF16.
template <bool BF16 = false>
__device__ __forceinline__ void edge_feat_weights(const TileArgs& a, int c, float* we) {
#pragma unroll
  for (int k = 0; k < kMaxEdgeFeat; ++k)
    we[k] = (c < a.H && k < a.E) ? operand<BF16>(a.w1[(size_t)c * a.ld1 + 2 * a.H + k]) : 0.f;
}

// Tile edges are taken kBatch at a time: their projections are loaded
// first, so the loads of a batch overlap.
constexpr int kBatch = 8;

// pre[q] = src_i[c] + dst_j[c] + e_ij . We[c] + b1[c] for tile edges e0 + q
// (0 past mrows), channel c < H. SLAB: the tile's rows are a slab's, whose
// src projections sit at [B*S] rows of proj (the row grid); else they are
// the molecule's own rows (#1/#2). BF16: e_ij rounded to bf16 operands (we
// comes rounded from edge_feat_weights<true>).
template <int HP, bool SLAB = false, bool BF16 = false>
__device__ __forceinline__ void edge_pre_batch(const TileArgs& a, const float* we, float bias1,
                                               int b, int e0, int c, float* pre) {
  using T = TileEdges<HP>;
  const int H = a.H;
  const float* pb = a.proj + (size_t)b * a.N * 2 * H + c;  // molecule b's columns, channel c
  const float* ps = SLAB ? a.proj + (size_t)b * a.S * 2 * H + c : pb;  // its rows
  float src[kBatch], dst[kBatch];
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const int e = e0 + q;
    src[q] = __ldg(ps + T::ei()[e] * 2 * H);
    dst[q] = __ldg(pb + T::ej()[e] * 2 * H + H);
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const float* f = T::ef() + (e0 + q) * kMaxEdgeFeat;
    float ew = fmaf(operand<BF16>(f[1]), we[1], operand<BF16>(f[0]) * we[0]);
    if (a.sin_emb) {
#pragma unroll
      for (int k = 2; k < kMaxEdgeFeat; ++k) ew = fmaf(operand<BF16>(f[k]), we[k], ew);
    }
    pre[q] = src[q] + dst[q] + ew + bias1;
  }
}

// As[e][c] = silu(pre) for the tile's edges (thread c), zero elsewhere; the
// backward also writes it to ab, the tile's edge 0 in abuf ([edge][H], the
// tile's edges consecutive). SLAB, BF16 as edge_pre_batch. LOWP (with BF16):
// pre rounded to bf16 and the silu in bf16 (lowp_silu2, edges in pairs).
template <int HP, bool SLAB = false, bool BF16 = false, bool LOWP = false>
__device__ __forceinline__ void build_edge_tile(const TileArgs& a, float* As, int b, int mrows,
                                                float* ab) {
  using C = TileCfg<HP>;
  const int c = tile_tid(), H = a.H;
  float we[kMaxEdgeFeat];
  edge_feat_weights<BF16>(a, c, we);
  const float bias1 = c < H ? a.b1[c] : 0.f;
  if (ab) ab += c;  // channel c
  for (int e0 = 0; e0 < kTileRows; e0 += kBatch) {
    float pre[kBatch];
    if (c < H) {
      edge_pre_batch<HP, SLAB, BF16>(a, we, bias1, b, e0, c, pre);
      if constexpr (LOWP) {
#pragma unroll
        for (int q = 0; q < kBatch; q += 2) {
          const float2 v = __bfloat1622float2(lowp_silu2(__floats2bfloat162_rn(pre[q], pre[q + 1])));
          pre[q] = v.x;
          pre[q + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int q = 0; q < kBatch; ++q) pre[q] = tile_silu(pre[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + q;
      float v = 0.f;
      if (e < mrows && c < H) {
        v = pre[q];
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

// rs_e = sum_c m_e[c] w_out[c] of the tile's mrows edges, m in As: the
// attention gate sigmoid(. + b_out) or the coordinate scale (through tanh
// when use_tanh), one warp per edge (two at a time) in a fixed order; BF16:
// m and w_out rounded to bf16 operands; LOWP: the gate as lowp_gate (the
// coordinate scale stays f32, as JAX's w3 product). Ends with a barrier.
template <int HP, bool COORD, bool BF16 = false, bool LOWP = false>
__device__ __forceinline__ void edge_scalars(const TileArgs& a, const float* As, int mrows) {
  using C = TileCfg<HP>;
  float* rs = TileEdges<HP>::rs();
  const int H = a.H, lane = tile_tid() & 31, warp = tile_tid() >> 5;
  for (int e = warp; e < mrows; e += 2 * C::kWarps) {
    const int e2 = e + C::kWarps < mrows ? e + C::kWarps : e;
    float s = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int k = lane; k < H; k += 32) {
      const float w = operand<BF16>(__ldg(a.w_out + k));
      s = fmaf(operand<BF16>(As[e * C::kLdA + k]), w, s);
      s2 = fmaf(operand<BF16>(As[e2 * C::kLdA + k]), w, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      auto scalar = [&](float v) {
        if (COORD) return a.use_tanh ? tanhf(v) * a.coords_range : v;
        if constexpr (LOWP) return lowp_gate(v, a.b_out[0]);
        return sigmoid_f(v + a.b_out[0]);
      };
      rs[e] = scalar(s);
      if (e2 != e) rs[e2] = scalar(s2);
    }
  }
  __syncthreads();
}

// agg + the messages of channel c over tile edges e0 .. e0+n-1, in edge
// order: m (times the gate with attention; LOWP: their bf16 product) times
// the edge mask.
template <int HP, bool LOWP = false>
__device__ __forceinline__ float fold_messages(const TileArgs& a, const float* As, int e0, int n,
                                               int c, float agg) {
  using T = TileEdges<HP>;
  const float *em = T::em(), *rs = T::rs();
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const int e = e0 + j;
    const float m = As[e * TileCfg<HP>::kLdA + c];
    agg += (a.attention ? (LOWP ? bf16_round(m * rs[e]) : m * rs[e]) : m) * em[e];
  }
  return agg;
}

// aggx + coordinate d's update over tile edges e0 .. e0+n-1, in edge order:
// coord_diff times the scale times the edge mask.
template <int HP>
__device__ __forceinline__ float fold_coords(int e0, int n, int d, float aggx) {
  using T = TileEdges<HP>;
  const float *cd = T::cd(), *rs = T::rs(), *em = T::em();
  for (int j = 0; j < n; ++j) {
    const int e = e0 + j;
    aggx += cd[e * 3 + d] * rs[e] * em[e];
  }
  return aggx;
}

// ---------------------------------------------------------------------------
// Per-edge passes of the edge-stage backward (#2's tile grid and the row
// grid of #5/#7); tile edge e is edge (b*S + ei[e])*N + ej[e].
// ---------------------------------------------------------------------------

// The gate's or the coordinate scale's backward over the tile's mrows edges,
// the second layer's mm in As: one warp per edge (two at a time) sums the
// logit sum_c silu(mm)[c] w_out[c] and, for the gate, sum_c dagg_i[c]
// silu(mm)[c] / div over the edge's row i; then one thread per edge turns
// them into rs (the gate) and rs2 (the logit's gradient) and, for the
// coordinate stage, writes the edge's gradient of coord_diff. Ends with a
// barrier. BF16: the logit's product on bf16 operands, as the bf16
// forward's (the gate's own sum stays f32: an elementwise product). LOWP:
// As holds the bf16 t = mm + b2 and m = lowp_silu(t); the gate's sum is
// over bf16(bf16(dagg / div) m) (the cotangent of the gated bf16 message
// times m, rounded), rounded as the gate's cotangent, and rs2 is that of
// the gate logit's bf16 output (lowp_gate's vjp).
template <int HP, bool COORD, bool BF16 = false, bool LOWP = false>
__device__ __forceinline__ void edge_scalars_bwd(const TileArgs& a, const float* As, int b,
                                                 int mrows) {
  using C = TileCfg<HP>;
  using T = TileEdges<HP>;
  float *rs = T::rs(), *rs2 = T::rs2();
  const int *ei = T::ei(), *ej = T::ej();
  const int H = a.H, lane = tile_tid() & 31, warp = tile_tid() >> 5;
  const float inv_div = 1.f / a.norm_div;
  const float* dagg_b = COORD ? nullptr : a.dagg + (size_t)b * a.S * H;  // molecule b's rows
  for (int e = warp; e < mrows; e += 2 * C::kWarps) {
    const int e2 = e + C::kWarps < mrows ? e + C::kWarps : e;
    float s[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll 4
    for (int k = lane; k < H; k += 32) {
      const float w = __ldg(a.w_out + k);
      if constexpr (LOWP) {
        const float m = lowp_silu(As[e * C::kLdA + k]), m2 = lowp_silu(As[e2 * C::kLdA + k]);
        const float wr = bf16_round(w);
        s[0] = fmaf(m, wr, s[0]);
        s[1] = fmaf(m2, wr, s[1]);
        if (!COORD) {
          s2[0] += bf16_round(bf16_round(__ldg(dagg_b + ei[e] * H + k) / a.norm_div) * m);
          s2[1] += bf16_round(bf16_round(__ldg(dagg_b + ei[e2] * H + k) / a.norm_div) * m2);
        }
        continue;
      }
      const float m = tile_silu(As[e * C::kLdA + k]), m2 = tile_silu(As[e2 * C::kLdA + k]);
      if constexpr (BF16) {
        const float wr = bf16_round(w);
        s[0] = fmaf(bf16_round(m), wr, s[0]);
        s[1] = fmaf(bf16_round(m2), wr, s[1]);
      } else {
        s[0] = fmaf(m, w, s[0]);
        s[1] = fmaf(m2, w, s[1]);
      }
      if (!COORD) {
        s2[0] = fmaf(m, __ldg(dagg_b + ei[e] * H + k) * inv_div, s2[0]);
        s2[1] = fmaf(m2, __ldg(dagg_b + ei[e2] * H + k) * inv_div, s2[1]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      s[u] = warp_sum(s[u]);
      if (!COORD) s2[u] = warp_sum(s2[u]);
    }
    if (lane < 2 && (lane == 0 || e2 != e)) {  // lane u keeps edge u's sums
      rs[lane ? e2 : e] = lane ? s[1] : s[0];
      rs2[lane ? e2 : e] = lane ? s2[1] : s2[0];
    }
  }
  __syncthreads();
  const float *em = T::em(), *cd = T::cd();
  for (int e = tile_tid(); e < mrows; e += C::kThreads) {
    if (COORD) {
      // s_ij = tanh(l) * range; ds_ij = em (daggx . cd); dcd = daggx s em.
      const size_t rr = (size_t)b * a.S + ei[e];
      const float mi = a.maskr[rr];
      float daggx[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) daggx[q] = a.gx[rr * 3 + q] * mi / a.norm_div;
      const float l = rs[e];
      const float th = tanhf(l);
      const float scale = a.use_tanh ? th * a.coords_range : l;
      const float dotc = daggx[0] * cd[e * 3] + daggx[1] * cd[e * 3 + 1] +
                         daggx[2] * cd[e * 3 + 2];
      const float ds = em[e] * dotc;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        a.dcd[(rr * a.N + ej[e]) * 3 + q] = daggx[q] * scale * em[e];
      rs2[e] = a.use_tanh ? ds * a.coords_range * (1.f - th * th) : ds;
    } else if constexpr (LOWP) {
      // g = lowp_gate(l, ba); the gate's cotangent bf16(em sum), through
      // the f32 sigmoid's derivative, rounded: the logit output's.
      float y;
      rs[e] = lowp_gate(rs[e], a.b_out[0], &y);
      rs2[e] = bf16_round(bf16_round(em[e] * rs2[e]) * (1.f - y) * y);
    } else {
      // gate g = sigmoid(l + ba); q = g (1 - g) em (dagg . m).
      const float g = sigmoid_f(rs[e] + a.b_out[0]);
      rs[e] = g;
      rs2[e] = g * (1.f - g) * em[e] * rs2[e];
    }
  }
  __syncthreads();
}

// Squared-distance features (not sin, whose features carry no gradient):
// dr_e += sum_c d(pre)[e][c] We[c][0] and dr0_e with We[c][1], d(pre) in As
// and We's two columns in Wb[0:HP], Wb[HP:2HP]; one warp per edge, two at a
// time. BF16: each sum rounded to bf16 (the gradient of the bf16 edge
// features of this stage's product) before it is added.
template <int HP, bool BF16 = false>
__device__ __forceinline__ void edge_dist_grads(const TileArgs& a, const float* As,
                                                const float* Wb, int b, int mrows) {
  using C = TileCfg<HP>;
  const int *ei = TileEdges<HP>::ei(), *ej = TileEdges<HP>::ej();
  const int lane = tile_tid() & 31, warp = tile_tid() >> 5;
  for (int e = warp; e < mrows; e += 2 * C::kWarps) {
    const int e2 = e + C::kWarps < mrows ? e + C::kWarps : e;
    float s[2] = {0.f, 0.f}, s0[2] = {0.f, 0.f};
#pragma unroll 4
    for (int k = lane; k < a.H; k += 32) {
      const float dp = As[e * C::kLdA + k], dp2 = As[e2 * C::kLdA + k];
      s[0] = fmaf(dp, Wb[k], s[0]);
      s0[0] = fmaf(dp, Wb[HP + k], s0[0]);
      s[1] = fmaf(dp2, Wb[k], s[1]);
      s0[1] = fmaf(dp2, Wb[HP + k], s0[1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      s[u] = warp_sum(s[u]);
      s0[u] = warp_sum(s0[u]);
      if constexpr (BF16) {
        s[u] = bf16_round(s[u]);
        s0[u] = bf16_round(s0[u]);
      }
    }
    if (lane == 0) {
      const size_t k1 = ((size_t)b * a.S + ei[e]) * a.N + ej[e];
      a.dr[k1] += s[0];
      a.dr0[k1] += s0[0];
      if (e2 != e) {
        const size_t k2 = ((size_t)b * a.S + ei[e2]) * a.N + ej[e2];
        a.dr[k2] += s[1];
        a.dr0[k2] += s0[1];
      }
    }
  }
}

template <int HP>
int set_tile_smem(const void* kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(TileCfg<HP>::kSmemFloats * sizeof(float)));
}

// Launches a tile kernel of HP threads on grid with its shared memory.
template <int HP>
int launch_tile(void (*kernel)(TileArgs), dim3 grid, const TileArgs& a, cudaStream_t s) {
  int rc = set_tile_smem<HP>((const void*)kernel);
  if (rc) return rc;
  kernel<<<grid, HP, TileCfg<HP>::kSmemFloats * sizeof(float), s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
