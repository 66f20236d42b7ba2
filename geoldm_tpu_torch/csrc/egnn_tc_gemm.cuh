// The tensor-core GEMMs of the EquivariantBlock kernels: the node GEMM, which
// runs every node-side product of #1-#7 (the projections and the node MLP of
// the forward chains, egnn_block_tile.cuh and egnn_rows.cuh, which #2, #5
// and #7 recompute with; the backward products of #2, #5 and #7, split K for
// the weight gradients), and the W2 gradient over every edge (#2, #5, #7).
// Both run split TF32 on mma.sync (egnn_tile.cuh: hi*hi + hi*lo + lo*hi,
// f32 accumulation, about f32's accuracy); split-K partials are summed in
// split order by splitk_reduce_kernel, without atomics, so a seeded run
// replays bit for bit. In the bf16 backward
// (GRAD16) every backward product has an f32 cotangent as A and a bf16
// operand as B (an activation or a weight, rounded as read): A stays split
// TF32 and B, exact in TF32, takes no lo term, two mma a k8 step.

#pragma once

#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "egnn_tile.cuh"

namespace {

// Sums of split-K partials: o.c[p][m, n] (+)= sum_z buf[p][z][m][n] for each
// product p (blockIdx.y), summed in split order; four elements a thread,
// read as float4 where N % 4 == 0.
struct SplitSum {
  float* c[2];
  int accumulate[2];
  int ldc;
};

__global__ void splitk_reduce_kernel(const float* buf, int splits, int M, int N, SplitSum o) {
  const int p = blockIdx.y;
  const size_t MN = (size_t)M * N;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= MN) return;
  const float* src = buf + (size_t)p * splits * MN + i;
  const int n = MN - i < 4 ? (int)(MN - i) : 4;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (n == 4 && N % 4 == 0) {
#pragma unroll 8
    for (int z = 0; z < splits; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(src + (size_t)z * MN);
      s[0] += v.x; s[1] += v.y; s[2] += v.z; s[3] += v.w;
    }
  } else {
    for (int z = 0; z < splits; ++z)
      for (int j = 0; j < n; ++j) s[j] += src[(size_t)z * MN + j];
  }
  float* c = o.c[p];
  for (int j = 0; j < n; ++j) {
    const size_t idx = i + j;
    float* dst = c + (idx / N) * o.ldc + idx % N;
    *dst = o.accumulate[p] ? *dst + s[j] : s[j];
  }
}

int splitk_reduce(const float* buf, int splits, int M, int N, int problems, const SplitSum& o,
                  cudaStream_t s) {
  const size_t quads = ((size_t)M * N + 3) / 4;
  splitk_reduce_kernel<<<dim3((unsigned)((quads + 255) / 256), problems), 256, 0, s>>>(
      buf, splits, M, N, o);
  return (int)cudaGetLastError();
}

constexpr int kMaxSplits = 32;

struct SplitBuf {
  float* buf;
  size_t cap;  // floats
};

// ---------------------------------------------------------------------------
// Node GEMM on the tensor cores: c = epilogue(A B) for one product or two of
// one shape in one launch (NodeGemm::p; blockIdx.z: the product, then its K
// split). A(m, k) from [M][K] (split by columns at k1 into a1 | a2, the node
// MLP's [h, agg] input without a concat) or, with ta, from [K][M]; B(k, n)
// from an nn.Linear weight [N][K] (tb) or from [K][N].
//
// What bounds it on an H100: at the QM9 recipe (M = 1856 node rows, N = 256,
// K = 256 or 512; the weight gradients 256 x 256 over K = 1856) a product is
// 243 MFLOP, three TF32 products in split TF32 (~1.5 us at 495 TFLOP/s) and
// ~4 MB of operands (~1.2 us at 3.35 TB/s): each launch is small, so the
// card fills only if the grid does, and the time goes to latency: the
// launch, the first chunk's copy and the epilogue's reads cost about as much
// as the main loop (PERF.md, the node GEMM alone).
//
// Design. 64x64 CTA tiles of 8 warps, two CTAs an SM: four 32x32 warp tiles
// (every B fragment's split feeding two m16 tiles, every A fragment's four
// n8 tiles), each shared by kNgSlices warps that take their slice of each
// chunk's K rows and meet in shared memory at the end, summed in slice
// order. K in chunks of 64 through a double-buffered stage filled by
// cp.async, 16-byte copies where the operand allows them (aligned base, row
// stride a multiple of 4 floats; W1's row stride 2H + E is not, so W1 takes
// 8- or 4-byte copies), zero-filled past M, N and K; one barrier a chunk.
// Each stage keeps its operand as global memory holds it ([row][k] or
// [k][row]), padded so that the fragment reads are free of bank conflicts;
// within each mma's k range the fragment's k slots (t, t + 4) read k (2t,
// 2t + 1) of both operands (k (4t ... 4t + 3) for the bf16 m16n8k16), so a
// [row][k] stage is read as float2 (float4): the product is the same sum in
// another order. Each k8 step's split products of a tile sum into a zeroed
// fragment that is added to the tile's accumulator rounding to nearest (the
// mma's own f32 accumulation rounds toward zero). The weight gradients (few
// output tiles, K the node rows) split K into splits of at most kNgMaxRows
// rows while the split buffer holds them (node_gemm_plan), summed in order
// by splitk_reduce_kernel, without atomics, so a seeded run replays bit for
// bit.
// The epilogue reads what it adds (bias, residual, mask, c) before it
// stores, and stores float2.
//
// Variants: f32 in split TF32 (egnn_tile.cuh: hi*hi + hi*lo + lo*hi, f32
// accumulation, about f32's accuracy); BF16 (the bf16 forward variants of
// #1, #3, #4 and #6, A [M][K] and B [N][K] only): the operands rounded to
// bf16 as they enter the fragments, one m16n8k16 bf16 mma a k16 step;
// GRAD16 (the bf16 backward): A, the cotangent, in split TF32 and B rounded
// to bf16 (exact in TF32, no lo term), two mma a k8 step; round_out rounds
// the result (an operand's gradient) before it is stored or added.
// ---------------------------------------------------------------------------

enum { kEpiNone = 0, kEpiSilu = 1, kEpiResidMask = 2 };

struct NgProblem {
  const float* a1;
  const float* a2;  // A's columns k1 ... K (ta 0), or null
  const float* b;
  float* c;
  int accumulate;
};

struct NodeGemm {
  NgProblem p[2]; int problems;
  int lda1, k1, lda2, ta;
  int ldb, tb;
  const float* bias;      // [N] or null
  const float* resid; int ldr;
  const float* row_mask;  // [M], kEpiResidMask
  int ldc;
  int M, N, K;
  int epilogue;
  int round_out;  // GRAD16: the result rounded to bf16 before it is stored or added
  // Set by the launcher: the K rows a split sums, the splits, the stride of
  // a split's partial tile, the floats of each operand's copies (4, 2, 1).
  int kchunk, splits; size_t split_stride;
  int copy_a, copy_b;
};

// kNgSlices warps share each of the CTA's four 32x32 warp tiles, each over
// its slice of every chunk's K rows; each then finishes kNgPairs of the
// tile's output pairs (two columns of one row a lane).
constexpr int kNgTM = 64, kNgTN = 64, kNgKC = 64, kNgStages = 2, kNgSlices = 2;
constexpr int kNgThreads = 128 * kNgSlices, kNgPairs = 16 / kNgSlices;
// The split plan: K rows a split sums at most, two chunks (each of a warp
// tile's K slices 64 rows), while the split buffer holds the splits; the
// H100's SMs.
constexpr int kNgMaxRows = 2 * kNgKC, kNgSMs = 132;

// Stage geometry: [row][k] stages of kLdK floats a row (conflict-free float2
// fragment reads; float4 for the bf16 variant), [k][row] stages of kLdM.
template <bool BF16>
struct NgLayout {
  static constexpr int kLdK = kNgKC + (BF16 ? 16 : 8);
  static constexpr int kLdM = kNgTM + 4;
  static constexpr int kOperand = kNgTM * kLdK;
  static constexpr int kStage = 2 * kOperand;
  static constexpr int kSmemBytes = kNgStages * kStage * (int)sizeof(float);
  static_assert(kNgTM == kNgTN && kNgKC * kLdM <= kOperand, "stage sizes");
  static_assert(4 * kNgSlices * 32 * 32 <= kNgStages * kStage, "the slices' exchange");
};

// W floats (4, 8 or 16 bytes) into shared memory, of which the first
// `bytes` are read and the rest zero-filled.
template <int W>
__device__ __forceinline__ void cp_async_w(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(s), "l"(gmem),
                 "n"(4 * W), "r"(bytes)
                 : "memory");
}

// A 64-row x kNgKC [row][k] stage from x1 (columns < k1) | x2 (from k1) of
// row stride ld1 | ld2, W floats a copy: rows row0 ... of `rows`, k from k0,
// zero past kend.
template <int LD, int W>
__device__ __forceinline__ void ng_load_rows(float* S, const float* x1, int ld1, const float* x2,
                                             int ld2, int k1, int row0, int rows, int k0,
                                             int kend) {
#pragma unroll 4
  for (int q = 0; q < kNgTM * kNgKC / W / kNgThreads; ++q) {
    const int i = threadIdx.x + kNgThreads * q;
    const int r = i / (kNgKC / W), kq = W * (i % (kNgKC / W));
    const int row = row0 + r, k = k0 + kq;
    int n = kend - k;
    n = row < rows ? (n < 0 ? 0 : (n > W ? W : n)) : 0;
    const float* src = x1;
    if (n) src = k < k1 ? x1 + (size_t)row * ld1 + k : x2 + (size_t)row * ld2 + (k - k1);
    cp_async_w<W>(S + r * LD + kq, src, 4 * n);
  }
}

// A kNgKC x 64-column [k][col] stage from x [K][...] of row stride ld, W
// floats a copy: columns col0 ... of `cols`, k from k0, zero past kend.
template <int LD, int W>
__device__ __forceinline__ void ng_load_cols(float* S, const float* x, int ld, int col0, int cols,
                                             int k0, int kend) {
#pragma unroll 4
  for (int q = 0; q < kNgTM * kNgKC / W / kNgThreads; ++q) {
    const int i = threadIdx.x + kNgThreads * q;
    const int kr = i / (kNgTM / W), cq = W * (i % (kNgTM / W));
    const int k = k0 + kr, col = col0 + cq;
    int n = cols - col;
    n = k < kend ? (n < 0 ? 0 : (n > W ? W : n)) : 0;
    cp_async_w<W>(S + kr * LD + cq, n ? x + (size_t)k * ld + col : x, 4 * n);
  }
}

// An operand's stage with the widest copies its alignment allows (w: 4, 2
// or 1 floats; the same for every thread).
template <bool KMAJOR, int LD>
__device__ __forceinline__ void ng_load(int w, float* S, const float* x1, int ld1, const float* x2,
                                        int ld2, int k1, int row0, int rows, int k0, int kend) {
  if constexpr (KMAJOR) {
    if (w == 4) ng_load_rows<LD, 4>(S, x1, ld1, x2, ld2, k1, row0, rows, k0, kend);
    else if (w == 2) ng_load_rows<LD, 2>(S, x1, ld1, x2, ld2, k1, row0, rows, k0, kend);
    else ng_load_rows<LD, 1>(S, x1, ld1, x2, ld2, k1, row0, rows, k0, kend);
  } else {
    if (w == 4) ng_load_cols<LD, 4>(S, x1, ld1, row0, rows, k0, kend);
    else if (w == 2) ng_load_cols<LD, 2>(S, x1, ld1, row0, rows, k0, kend);
    else ng_load_cols<LD, 1>(S, x1, ld1, row0, rows, k0, kend);
  }
}

// One CTA's tile: TA / TB, the operand layouts (ta / tb) as compile-time
// constants (one kernel name a variant: node_gemm_tc_kernel picks the body).
template <bool BF16, bool GRAD16, bool TA, bool TB>
__device__ __forceinline__ void node_gemm_tile(const NodeGemm& g) {
  using L = NgLayout<BF16>;
  float* smem = tile_smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Warps 4 wk ... 4 wk + 3 take slice wk of each chunk's K rows for the
  // same 2 x 2 grid of 32x32 warp tiles (wm, wn).
  const int wk = warp >> 2, wm = warp & 1, wn = (warp >> 1) & 1, gq = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kNgTM, n0 = blockIdx.x * kNgTN;
  const int prob = blockIdx.z / g.splits, split = blockIdx.z % g.splits;
  const NgProblem p = prob ? g.p[1] : g.p[0];
  const int kbeg = split * g.kchunk, kend = min(g.K, kbeg + g.kchunk);
  const int nch = kend > kbeg ? (kend - kbeg + kNgKC - 1) / kNgKC : 0;

  auto load = [&](int st, int k0) {
    float* As = smem + st * L::kStage;
    float* Bs = As + L::kOperand;
    if constexpr (TA) ng_load<false, L::kLdM>(g.copy_a, As, p.a1, g.lda1, p.a1, 0, 0, m0, g.M, k0, kend);
    else ng_load<true, L::kLdK>(g.copy_a, As, p.a1, g.lda1, p.a2, g.lda2, g.k1, m0, g.M, k0, kend);
    if constexpr (TB) ng_load<true, L::kLdK>(g.copy_b, Bs, p.b, g.ldb, p.b, g.ldb, g.K, n0, g.N, k0, kend);
    else ng_load<false, L::kLdM>(g.copy_b, Bs, p.b, g.ldb, p.b, 0, 0, n0, g.N, k0, kend);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int st = 0; st < kNgStages - 1; ++st) {
    if (st < nch) load(st, kbeg + st * kNgKC);
    cp_async_commit();
  }
  for (int ck = 0; ck < nch; ++ck) {
    cp_async_wait<kNgStages - 2>();
    __syncthreads();  // chunk ck landed for all; all are done with chunk ck - 1's stage
    if (ck + kNgStages - 1 < nch) load((ck + kNgStages - 1) % kNgStages, kbeg + (ck + kNgStages - 1) * kNgKC);
    cp_async_commit();
    const float* As = smem + (ck % kNgStages) * L::kStage;
    const float* Bs = As + L::kOperand;
    if constexpr (BF16) {
#pragma unroll
      for (int kk = wk * (kNgKC / kNgSlices); kk < (wk + 1) * (kNgKC / kNgSlices); kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* ar = As + (wm * 32 + mi * 16 + gq) * L::kLdK + kk + 4 * t;
          const float4 x0 = *reinterpret_cast<const float4*>(ar);
          const float4 x1 = *reinterpret_cast<const float4*>(ar + 8 * L::kLdK);
          af[mi][0] = pack_bf16(x0.x, x0.y);
          af[mi][1] = pack_bf16(x1.x, x1.y);
          af[mi][2] = pack_bf16(x0.z, x0.w);
          af[mi][3] = pack_bf16(x1.z, x1.w);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float4 y = *reinterpret_cast<const float4*>(
              Bs + (wn * 32 + ni * 8 + gq) * L::kLdK + kk + 4 * t);
          const uint32_t b0 = pack_bf16(y.x, y.y), b1 = pack_bf16(y.z, y.w);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
        }
      }
    } else {
      // Not unrolled: unrolled, the k8 steps' fragments and the folds' live
      // at once and spill past the 128 registers of two CTAs an SM.
#pragma unroll 1
      for (int kk = wk * (kNgKC / kNgSlices); kk < (wk + 1) * (kNgKC / kNgSlices); kk += 8) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + gq;
          float v[4];
          if constexpr (TA) {
            const float* ac = As + (kk + 2 * t) * L::kLdM + r;
            v[0] = ac[0]; v[1] = ac[8]; v[2] = ac[L::kLdM]; v[3] = ac[L::kLdM + 8];
          } else {
            const float2 x0 = *reinterpret_cast<const float2*>(As + r * L::kLdK + kk + 2 * t);
            const float2 x1 = *reinterpret_cast<const float2*>(As + (r + 8) * L::kLdK + kk + 2 * t);
            v[0] = x0.x; v[1] = x1.x; v[2] = x0.y; v[3] = x1.y;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(v[q], ahi[mi][q], alo[mi][q]);
        }
        // Per n8 column of tiles: B's split, then the split products of its
        // two tiles, small terms first (mma_3xtf32's order; GRAD16: B exact
        // in TF32, no lo term, mma_2xtf32's; consecutive mma feed different
        // tiles), each tile's k8 step into a zeroed fragment that is then
        // added to acc rounding to nearest. mma's f32 accumulation rounds
        // toward zero: accumulated in place over a whole K, its drift put
        // the forward products 1.1-1.8e-6 of max|ref| off float64, which
        // #5's gate-bias gradient at pad 184 and the GEOM train step's loss
        // carried past their gates (PERF.md §6).
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = wn * 32 + ni * 8 + gq;
          float b0, b1;
          if constexpr (TB) {
            const float2 y = *reinterpret_cast<const float2*>(Bs + n * L::kLdK + kk + 2 * t);
            b0 = y.x; b1 = y.y;
          } else {
            b0 = Bs[(kk + 2 * t) * L::kLdM + n];
            b1 = Bs[(kk + 2 * t + 1) * L::kLdM + n];
          }
          uint32_t bh0, bh1, bl0 = 0, bl1 = 0;
          if constexpr (GRAD16) {
            bh0 = bf16_tf32(b0);
            bh1 = bf16_tf32(b1);
          } else {
            split_tf32(b0, bh0, bl0);
            split_tf32(b1, bh1, bl1);
          }
          float f[2][4] = {};
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_tf32(f[mi], alo[mi], bh0, bh1);
          if constexpr (!GRAD16) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) mma_tf32(f[mi], ahi[mi], bl0, bl1);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_tf32(f[mi], ahi[mi], bh0, bh1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mi][ni][q] += f[mi][q];
        }
      }
    }
  }
  // The slices of each warp tile meet in shared memory ([slice][value][lane]
  // per tile): the warp of slice wk sums output pairs wk * kNgPairs ... over
  // the slices in slice order.
  cp_async_wait<0>();
  __syncthreads();  // every stage read and every copy landed: the stages are free
  float* red = smem + (warp & 3) * (kNgSlices * 32 * 32);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) red[(wk * 32 + (mi * 4 + ni) * 4 + q) * 32 + lane] = acc[mi][ni][q];
  __syncthreads();
  // Pair i: value index 2 P (+ 1) of acc[2][4][4], P = wk * kNgPairs + i,
  // at rows gq (+ 8) of m16 tile P / 8 and columns 2t, 2t + 1 of n8 tile
  // P / 2 % 4.
  float v[kNgPairs][2];
  int pm[kNgPairs], pn[kNgPairs];
#pragma unroll
  for (int i = 0; i < kNgPairs; ++i) {
    const int P = wk * kNgPairs + i;
    pm[i] = m0 + wm * 32 + (P >> 3) * 16 + gq + 8 * (P & 1);
    pn[i] = n0 + wn * 32 + ((P >> 1) & 3) * 8 + 2 * t;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = red[(2 * P + j) * 32 + lane];
#pragma unroll
      for (int sl = 1; sl < kNgSlices; ++sl) s += red[(sl * 32 + 2 * P + j) * 32 + lane];
      v[i][j] = s;
    }
  }

  // The epilogue's reads (bias, residual and mask, and c where the product
  // is added) go out together before any result is stored, float2 where the
  // rows allow (then a quad of lanes covers one 32-byte sector).
  float* c = p.c + split * g.split_stride;
  const bool resid = g.epilogue == kEpiResidMask;
  auto pairs = [](const float* q, int ld) { return ld % 2 == 0 && ((uintptr_t)q & 7) == 0; };
  const bool two = pairs(c, g.ldc) && (!resid || pairs(g.resid, g.ldr));
  auto read2 = [&](const float* q, int n) {
    if (two && n + 1 < g.N) return *reinterpret_cast<const float2*>(q);
    return make_float2(q[0], n + 1 < g.N ? q[1] : 0.f);
  };
  // Four pairs at a time, to hold the registers down.
  constexpr int kRun = kNgPairs < 4 ? kNgPairs : 4;
#pragma unroll
  for (int i0 = 0; i0 < kNgPairs; i0 += kRun) {
    float2 rs[kRun], cs[kRun], bs[kRun];
    float mask[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int m = pm[i0 + i], n = pn[i0 + i];
      rs[i] = cs[i] = bs[i] = make_float2(0.f, 0.f);
      mask[i] = 0.f;
      if (m >= g.M || n >= g.N) continue;
      if (g.bias) bs[i] = make_float2(g.bias[n], n + 1 < g.N ? g.bias[n + 1] : 0.f);
      if (resid) {
        mask[i] = g.row_mask[m];
        rs[i] = read2(g.resid + (size_t)m * g.ldr + n, n);
      }
      if (p.accumulate) cs[i] = read2(c + (size_t)m * g.ldc + n, n);
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int m = pm[i0 + i], n = pn[i0 + i];
      if (m >= g.M || n >= g.N) continue;
      float o[2] = {v[i0 + i][0], v[i0 + i][1]};
      const float rin[2] = {rs[i].x, rs[i].y}, cin[2] = {cs[i].x, cs[i].y};
      const float bin[2] = {bs[i].x, bs[i].y};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (g.bias) o[j] += bin[j];
        if (g.epilogue == kEpiSilu) o[j] = silu_f(o[j]);
        if (resid) o[j] = (rin[j] + o[j]) * mask[i];
        if constexpr (GRAD16) {
          if (g.round_out) o[j] = bf16_round(o[j]);
        }
        if (p.accumulate) o[j] = cin[j] + o[j];
      }
      float* dst = c + (size_t)m * g.ldc + n;
      if (two && n + 1 < g.N) {
        *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
      } else {
        dst[0] = o[0];
        if (n + 1 < g.N) dst[1] = o[1];
      }
    }
  }
}

// Two CTAs an SM (128 registers a thread), so that a grid of up to 264
// tiles runs in one wave.
template <bool BF16 = false, bool GRAD16 = false>
__global__ void __launch_bounds__(kNgThreads, 2) node_gemm_tc_kernel(NodeGemm g) {
  if constexpr (BF16) {
    node_gemm_tile<true, false, false, true>(g);
  } else if (g.ta) {
    if (g.tb) node_gemm_tile<false, GRAD16, true, true>(g);
    else node_gemm_tile<false, GRAD16, true, false>(g);
  } else {
    if (g.tb) node_gemm_tile<false, GRAD16, false, true>(g);
    else node_gemm_tile<false, GRAD16, false, false>(g);
  }
}

// The plan of `problems` products of M x N over K: K splits into chunks of
// *kchunk rows (a multiple of kNgKC; the last one may be short). K is split
// only where may_split (no epilogue, bias or rounding of the output) and the
// output tiles of every product fill at most half the card: then into
// splits of kNgMaxRows rows, or fewer and longer ones where the buffer of
// cap floats holds fewer. Mirrored by ops/egnn_block.py:node_gemm_plan.
int node_gemm_plan(int M, int N, int K, int problems, size_t cap, int may_split, int* kchunk) {
  auto cdiv = [](int a, int b) { return (a + b - 1) / b; };
  const int tiles = cdiv(M, kNgTM) * cdiv(N, kNgTN) * problems;
  int splits = 1;
  if (may_split && 2 * tiles <= kNgSMs && K > kNgMaxRows) {
    splits = cdiv(K, kNgMaxRows);
    const size_t fit = cap / ((size_t)problems * M * N);
    if ((size_t)splits > fit) splits = fit > 0 ? (int)fit : 1;
  }
  int kc = cdiv(cdiv(K, splits), kNgKC) * kNgKC;
  if (kc < kNgKC) kc = kNgKC;
  *kchunk = kc;
  return cdiv(K, kc);
}

// The kernel's dynamic shared memory, allowed once per device.
template <bool BF16, bool GRAD16>
int node_gemm_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return 0;
  e = cudaFuncSetAttribute((const void*)node_gemm_tc_kernel<BF16, GRAD16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           NgLayout<BF16>::kSmemBytes);
  if (e == cudaSuccess) done.fetch_or(bit);
  return (int)e;
}

// Runs g (its problems, operands, epilogue and outputs set) on the plan of
// its shape: split over sb's buffer where the plan splits (sb.cap 0: never),
// the partials then summed in order into each product's c. A pair whose
// splits would sum more than kNgMaxRows rows (the buffer holds too few
// splits for two products) runs one product at a time.
template <bool BF16 = false, bool GRAD16 = false>
int run_node_gemm(NodeGemm g, const SplitBuf& sb, cudaStream_t s) {
  const int may_split = !BF16 && g.epilogue == kEpiNone && !g.bias && !g.round_out && sb.cap > 0;
  g.splits = node_gemm_plan(g.M, g.N, g.K, g.problems, sb.cap, may_split, &g.kchunk);
  if (g.problems == 2 && may_split && g.kchunk > kNgMaxRows) {
    NodeGemm one = g;
    one.problems = 1;
    int rc = run_node_gemm<BF16, GRAD16>(one, sb, s);
    if (rc) return rc;
    one.p[0] = g.p[1];
    return run_node_gemm<BF16, GRAD16>(one, sb, s);
  }
  // The widest copy (4, 2 or 1 floats) every row of an operand allows.
  auto width = [](const void* q, int ld) {
    for (int w = 4; w > 1; w /= 2)
      if ((uintptr_t)q % (4 * w) == 0 && ld % w == 0) return w;
    return 1;
  };
  g.copy_a = g.copy_b = 4;
  for (int i = 0; i < g.problems; ++i) {
    g.copy_a = std::min(g.copy_a, width(g.p[i].a1, g.lda1));
    if (!g.ta && g.k1 < g.K)  // and no copy across k1
      g.copy_a = std::min({g.copy_a, width(g.p[i].a2, g.lda2), g.k1 % 4 ? (g.k1 % 2 ? 1 : 2) : 4});
    g.copy_b = std::min(g.copy_b, width(g.p[i].b, g.ldb));
  }
  int rc = node_gemm_smem<BF16, GRAD16>();
  if (rc) return rc;
  const dim3 grid((g.N + kNgTN - 1) / kNgTN, (g.M + kNgTM - 1) / kNgTM, g.problems * g.splits);
  if (g.splits == 1) {
    g.split_stride = 0;
    node_gemm_tc_kernel<BF16, GRAD16><<<grid, kNgThreads, NgLayout<BF16>::kSmemBytes, s>>>(g);
    return (int)cudaGetLastError();
  }
  const size_t MN = (size_t)g.M * g.N;
  SplitSum o = {};
  o.ldc = g.ldc;
  for (int i = 0; i < g.problems; ++i) {
    o.c[i] = g.p[i].c;
    o.accumulate[i] = g.p[i].accumulate;
    g.p[i].c = sb.buf + (size_t)i * g.splits * MN;
    g.p[i].accumulate = 0;
  }
  g.ldc = g.N;
  g.split_stride = MN;
  node_gemm_tc_kernel<BF16, GRAD16><<<grid, kNgThreads, NgLayout<BF16>::kSmemBytes, s>>>(g);
  if ((rc = (int)cudaGetLastError())) return rc;
  return splitk_reduce(sb.buf, g.splits, g.M, g.N, g.problems, o, s);
}

// c (+)= A B: ta, A stored [K][M] (A(m, k) = a[k * lda + m]), else [M][K];
// tb, B stored [N][K] (B(k, n) = b[n * ldb + k]), else [K][N]. K is split
// where the plan says (the weight gradients, K = the node rows). GRAD16: A
// is an f32 cotangent and B is rounded to bf16 (the bf16 backward), and
// round_out rounds the product (then never split) before it is stored or
// added to c.
template <bool GRAD16 = false>
int node_gemm(const float* a, int lda, int ta, const float* b, int ldb, int tb, float* c, int ldc,
              int M, int N, int K, int accumulate, const SplitBuf& sb, cudaStream_t s,
              int round_out = 0) {
  NodeGemm g = {};
  g.p[0] = {a, nullptr, b, c, accumulate};
  g.problems = 1;
  g.lda1 = lda; g.k1 = K; g.ta = ta; g.ldb = ldb; g.tb = tb; g.ldc = ldc;
  g.M = M; g.N = N; g.K = K; g.epilogue = kEpiNone; g.round_out = round_out;
  return run_node_gemm<false, GRAD16>(g, sb, s);
}

// Two node_gemm products of one shape and layout in one grouped launch:
// c0 (+)= A0 B0 (accumulate0), c1 (+)= A1 B1 (accumulate1).
template <bool GRAD16 = false>
int node_gemm_pair(const float* a0, const float* a1, int lda, int ta, const float* b0,
                   const float* b1, int ldb, int tb, float* c0, float* c1, int ldc, int M, int N,
                   int K, int accumulate0, int accumulate1, const SplitBuf& sb, cudaStream_t s,
                   int round_out = 0) {
  NodeGemm g = {};
  g.p[0] = {a0, nullptr, b0, c0, accumulate0};
  g.p[1] = {a1, nullptr, b1, c1, accumulate1};
  g.problems = 2;
  g.lda1 = lda; g.k1 = K; g.ta = ta; g.ldb = ldb; g.tb = tb; g.ldc = ldc;
  g.M = M; g.N = N; g.K = K; g.epilogue = kEpiNone; g.round_out = round_out;
  return run_node_gemm<false, GRAD16>(g, sb, s);
}

// The forward chains' node-side products (#1's, #3/#4/#6's, and the
// recomputes of #2/#5/#7): out [M][H] (row stride ldc) = epilogue(A W^T +
// bias), A = a [M][H], or [a | agg] [M][2H] when agg is given (the node
// MLP's input without a concat), W an nn.Linear weight [H][K] of row stride
// ldw; kEpiResidMask: out = (resid + .) * row_mask, resid [M][H]. BF16: on
// bf16 operands. Never split K: a forward's products fill the card with
// their output tiles, and a recompute is then the forward's code bit for
// bit.
template <bool BF16 = false>
int node_linear(const float* a, const float* agg, const float* w, int ldw, const float* bias,
                int epilogue, const float* resid, const float* row_mask, float* out, int ldc,
                int M, int H, cudaStream_t s) {
  NodeGemm g = {};
  g.p[0] = {a, agg, w, out, 0};
  g.problems = 1;
  g.lda1 = H; g.k1 = H; g.lda2 = H; g.ldb = ldw; g.tb = 1;
  g.bias = bias; g.resid = resid; g.ldr = H; g.row_mask = row_mask;
  g.ldc = ldc; g.M = M; g.N = H; g.K = agg ? 2 * H : H;
  g.epilogue = epilogue;
  return run_node_gemm<BF16>(g, SplitBuf{nullptr, 0}, s);
}

// A stage's projections, no bias (b1 is added per edge in the tile):
// proj[:Mr, :H] = hr W1[:, :H]^T over the rows it computes and proj[:Mc,
// H:2H] = hc W1[:, H:2H]^T over the columns, row stride 2H. Over the whole
// view (hr is hc) the halves run as one grouped launch, over an SP slab as
// two launches of their own M; each output tile is the same sum either way.
template <bool BF16 = false>
int node_projection(const float* hr, int Mr, const float* hc, int Mc, const float* w1, int ld1,
                    float* proj, int H, cudaStream_t s) {
  if (hr != hc || Mr != Mc) {
    const int rc = node_linear<BF16>(hr, nullptr, w1, ld1, nullptr, kEpiNone, nullptr, nullptr,
                                     proj, 2 * H, Mr, H, s);
    if (rc) return rc;
    return node_linear<BF16>(hc, nullptr, w1 + H, ld1, nullptr, kEpiNone, nullptr, nullptr,
                             proj + H, 2 * H, Mc, H, s);
  }
  NodeGemm g = {};
  g.p[0] = {hr, nullptr, w1, proj, 0};
  g.p[1] = {hr, nullptr, w1 + H, proj + H, 0};
  g.problems = 2;
  g.lda1 = H; g.k1 = H; g.ldb = ld1; g.tb = 1;
  g.ldc = 2 * H; g.M = Mr; g.N = H; g.K = H;
  g.epilogue = kEpiNone;
  return run_node_gemm<BF16>(g, SplitBuf{nullptr, 0}, s);
}

// ---------------------------------------------------------------------------
// W2 gradient on the tensor cores: out[z][m][n] = sum over the edges e of
// split z of d[e][m] a[e][n] (m, n < H), both operands [Me, H] row-major,
// so each is K-outer: a 16-edge chunk of each streams into shared memory
// with cp.async (two stages, one barrier a chunk), 8 warps in a 2 x 4 grid of 64x32 register
// tiles, 3xTF32 as in the edge tiles. The splits are summed in order by
// splitk_reduce_kernel. GRAD16 (the bf16 backward): a, silu(pre), rounded to
// bf16 as read, d in split TF32, two mma a k8 step; the caller rounds the
// summed gradient once.
// ---------------------------------------------------------------------------

constexpr int kWgTile = 128, kWgKC = 16, kWgLd = kWgTile + 8, kWgMaxSplits = 64;
// Edges a split sums at most. The mma's f32 accumulation rounds toward zero,
// so one accumulator fed ~17K edges (1.08 M edges in 64 splits) drifts to
// ~1e-4 of the gradient; 2048 edges keep the drift near 1e-5, and the split
// partials are summed in f32 in order.
// The bf16 backward keeps the cap but not the drift: its gradient is rounded
// to bf16 after the splits are summed, and a split's drift (up to ~1e-5 of
// it: ~half an f32 ulp lost at each of 2048 / 8 * 2 mma) moves enough sums
// across a bf16 rounding tie to flip ~10% of the elements against a plain
// f32 sum. GRAD16 therefore folds every kWgFold chunks' mma sum into the
// split's total with a rounded f32 add, so the truncation runs over 64 edges
// (16 mma) at a time.
constexpr int kWgMaxChunk = 2048, kWgFold = 4;

template <bool GRAD16 = false>
__global__ void __launch_bounds__(256) wgrad_tc_kernel(const float* d, const float* a, int Me,
                                                       int H, int kchunk, float* out) {
  __shared__ __align__(16) float Ds[2][kWgKC * kWgLd];
  __shared__ __align__(16) float Bs[2][kWgKC * kWgLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kWgTile, n0 = blockIdx.x * kWgTile;
  const int e_beg = blockIdx.z * kchunk, e_end = min(Me, e_beg + kchunk);
  float acc[4][4][4], part[4][4][4];  // GRAD16: part, the current fold's mma sum
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = part[mi][ni][q] = 0.f;

  auto load = [&](int st, int k0) {
    for (int idx = tid; idx < kWgKC * (kWgTile / 4); idx += 256) {
      const int kk = idx / (kWgTile / 4), q = idx % (kWgTile / 4);
      const int e = k0 + kk;
      const bool okm = e < e_end && m0 + 4 * q < H, okn = e < e_end && n0 + 4 * q < H;
      cp_async16(&Ds[st][kk * kWgLd + 4 * q], okm ? d + (size_t)e * H + m0 + 4 * q : d, okm);
      cp_async16(&Bs[st][kk * kWgLd + 4 * q], okn ? a + (size_t)e * H + n0 + 4 * q : a, okn);
    }
    cp_async_commit();
  };
  const int nch = (e_end - e_beg + kWgKC - 1) / kWgKC;
  if (nch > 0) load(0, e_beg);
  for (int ck = 0; ck < nch; ++ck) {
    const int st = ck & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ck landed for all; all are done with chunk ck - 1
    if (ck + 1 < nch) load(st ^ 1, e_beg + (ck + 1) * kWgKC);
#pragma unroll
    for (int kk = 0; kk < kWgKC; kk += 8) {
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float* dr = &Ds[st][(kk + t) * kWgLd + wm * 64 + mi * 16 + g];
        split_tf32(dr[0], ahi[mi][0], alo[mi][0]);
        split_tf32(dr[8], ahi[mi][1], alo[mi][1]);
        split_tf32(dr[4 * kWgLd], ahi[mi][2], alo[mi][2]);
        split_tf32(dr[4 * kWgLd + 8], ahi[mi][3], alo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* br = &Bs[st][(kk + t) * kWgLd + wn * 32 + ni * 8 + g];
        if constexpr (GRAD16) {
          const uint32_t b0 = bf16_tf32(br[0]), b1 = bf16_tf32(br[4 * kWgLd]);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma_2xtf32(part[mi][ni], ahi[mi], alo[mi], b0, b1);
        } else {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(br[0], bh0, bl0);
          split_tf32(br[4 * kWgLd], bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
            mma_3xtf32(acc[mi][ni], ahi[mi], alo[mi], bh0, bh1, bl0, bl1);
        }
      }
    }
    if constexpr (GRAD16) {
      if ((ck + 1) % kWgFold == 0 || ck + 1 == nch) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[mi][ni][q] += part[mi][ni][q];
              part[mi][ni][q] = 0.f;
            }
      }
    }
  }
  float* o = out + (size_t)blockIdx.z * H * H;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm * 64 + mi * 16 + g + (q >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + ni * 8 + 2 * t + (q & 1);
        if (m < H && n < H) o[(size_t)m * H + n] = acc[mi][ni][q];
      }
}

// Splits of the W2 gradient over Me edges: about two CTAs per SM, and more
// where a split would sum over kWgMaxChunk edges.
int wgrad_splits(int Me, int H, int* kchunk) {
  const int tiles = ((H + kWgTile - 1) / kWgTile) * ((H + kWgTile - 1) / kWgTile);
  int splits = 256 / tiles;
  splits = splits < 1 ? 1 : (splits > kWgMaxSplits ? kWgMaxSplits : splits);
  const int need = (Me + kWgMaxChunk - 1) / kWgMaxChunk;
  if (splits < need) splits = need;
  int kc = (Me + splits - 1) / splits;
  kc = (kc + kWgKC - 1) / kWgKC * kWgKC;
  *kchunk = kc;
  return (Me + kc - 1) / kc;
}

// gw2[m][n] (+)= sum_e dbuf[e][m] abuf[e][n]; wsplit holds the split
// partials (wgrad_splits(Me, H) x H x H floats). GRAD16: abuf rounded to
// bf16 (wgrad_tc_kernel).
template <bool GRAD16 = false>
int wgrad_tc(const float* dbuf, const float* abuf, int Me, int H, float* gw2, float* wsplit,
             int accumulate, cudaStream_t s) {
  int kchunk;
  const int splits = wgrad_splits(Me, H, &kchunk);
  const int nt = (H + kWgTile - 1) / kWgTile;
  wgrad_tc_kernel<GRAD16><<<dim3(nt, nt, splits), 256, 0, s>>>(dbuf, abuf, Me, H, kchunk,
                                                               wsplit);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  SplitSum o = {};
  o.c[0] = gw2;
  o.accumulate[0] = accumulate;
  o.ldc = H;
  return splitk_reduce(wsplit, splits, H, H, 1, o, s);
}

}  // namespace
