// The tensor-core GEMMs of the EquivariantBlock kernels, shared by the
// whole-molecule kernels (#1/#2: egnn_block_tile.cuh, egnn_block_bwd.cu) and
// the row-tiled stage backward (#5/#7: egnn_rows_bwd.cuh): the node GEMM
// (node-side products, split K for the weight gradients) and the W2
// gradient over every edge. Both run split TF32 on mma.sync (egnn_tile.cuh:
// hi*hi + hi*lo + lo*hi, f32 accumulation, about f32's accuracy); split-K
// partials are summed in split order by splitk_reduce_kernel, without
// atomics, so a seeded run replays bit for bit. In the bf16 backward
// (GRAD16) every backward product has an f32 cotangent as A and a bf16
// operand as B (an activation or a weight, rounded as read): A stays split
// TF32 and B, exact in TF32, takes no lo term, two mma a k8 step.

#pragma once

#include <stdint.h>

#include "egnn_tile.cuh"

namespace {

// c[m, n] (+)= sum_z buf[z][m][n], summed in split order.
__global__ void splitk_reduce_kernel(const float* buf, int splits, int M, int N, float* c,
                                     int ldc, int accumulate) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * N) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += buf[(size_t)z * M * N + idx];
  float* dst = c + (size_t)(idx / N) * ldc + idx % N;
  *dst = accumulate ? *dst + s : s;
}

constexpr int kMaxSplits = 32;

struct SplitBuf {
  float* buf;
  size_t cap;  // floats
};

// ---------------------------------------------------------------------------
// Node GEMM on the tensor cores (3xTF32): C = epilogue(A B) with A(m, k)
// from [M][K] (split by columns at k1 into a1 | a2, the node MLP's [h, agg]
// input without a concat) or, with ta, from [K][M]; B(k, n) from an
// nn.Linear weight [N][K] (tb) or from [K][N]. 32x64 tiles, 4 warps of
// 32x16, K in chunks of 32 through shared memory while the next chunk's
// loads wait in registers (plain loads: W1's row stride 2H+E is not 16-byte
// aligned). blockIdx.z splits K; a split writes its partial tile to c + z *
// split_stride.
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
  int round_out;  // GRAD16: the result rounded to bf16 before it is stored or added
};

constexpr int kNgTM = 32, kNgTN = 64, kNgKC = 32;
constexpr int kNgLdR = kNgKC + 4;  // [row][k] stages
constexpr int kNgLdAT = kNgTM + 8, kNgLdBT = kNgTN + 8;  // [k][row] stages
constexpr int kNgA = kNgTM * kNgLdR > kNgKC * kNgLdAT ? kNgTM * kNgLdR : kNgKC * kNgLdAT;
constexpr int kNgB = kNgTN * kNgLdR > kNgKC * kNgLdBT ? kNgTN * kNgLdR : kNgKC * kNgLdBT;
constexpr int kNgAPer = kNgTM * kNgKC / 128, kNgBPer = kNgTN * kNgKC / 128;

// BF16 (the bf16 forward variant of #1, A [M][K] and B [N][K] only): the
// operands rounded to bf16 as they enter the fragments, one m16n8k16 bf16
// mma a k16 step instead of three TF32 ones a k8 step. GRAD16 (the bf16
// backward): A, the cotangent, in split TF32 and B rounded to bf16, two
// mma a k8 step; g.round_out rounds the result (an operand's gradient).
template <bool BF16 = false, bool GRAD16 = false>
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
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < kNgKC; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* ar = As + (mi * 16 + gq) * kNgLdR + kk + 2 * t;
          af[mi][0] = pack_bf16(ar[0], ar[1]);
          af[mi][1] = pack_bf16(ar[8 * kNgLdR], ar[8 * kNgLdR + 1]);
          af[mi][2] = pack_bf16(ar[8], ar[9]);
          af[mi][3] = pack_bf16(ar[8 * kNgLdR + 8], ar[8 * kNgLdR + 9]);
        }
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const float* br = Bs + (wn * 16 + ni * 8 + gq) * kNgLdR + kk + 2 * t;
          const uint32_t b0 = pack_bf16(br[0], br[1]), b1 = pack_bf16(br[8], br[9]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
        }
      }
      __syncthreads();
      continue;
    }
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
        if constexpr (GRAD16) {
          const uint32_t br0 = bf16_tf32(b0), br1 = bf16_tf32(b1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_2xtf32(acc[mi][ni], ahi[mi], alo[mi], br0, br1);
        } else {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b0, bh0, bl0);
          split_tf32(b1, bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_3xtf32(acc[mi][ni], ahi[mi], alo[mi], bh0, bh1, bl0, bl1);
        }
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
        if constexpr (GRAD16) {
          if (g.round_out) v = bf16_round(v);
        }
        float* dst = c + (size_t)m * g.ldc + n;
        *dst = g.accumulate ? *dst + v : v;
      }
}

template <bool BF16 = false, bool GRAD16 = false>
int launch_node_gemm(const NodeGemm& g, int splits, cudaStream_t s) {
  dim3 grid((g.N + kNgTN - 1) / kNgTN, (g.M + kNgTM - 1) / kNgTM, splits);
  node_gemm_tc_kernel<BF16, GRAD16><<<grid, 128, 0, s>>>(g);
  return (int)cudaGetLastError();
}

// C (+)= A B on the node GEMM: ta, A stored [K][M] (A(m, k) = a[k * lda +
// m]), else [M][K]; tb, B stored [N][K] (B(k, n) = b[n * ldb + k]), else
// [K][N]. K is split when the output has few tiles and K is long (the
// weight gradients, K = the node rows), so that the grid fills the card;
// the splits are summed in order. GRAD16: A is an f32 cotangent and B is
// rounded to bf16 (the bf16 backward), and round_out rounds the product
// (then never split) before it is stored or added to c.
template <bool GRAD16 = false>
int node_gemm(const float* a, int lda, int ta, const float* b, int ldb, int tb, float* c, int ldc,
              int M, int N, int K, int accumulate, const SplitBuf& sb, cudaStream_t s,
              int round_out = 0) {
  const int tiles = ((M + kNgTM - 1) / kNgTM) * ((N + kNgTN - 1) / kNgTN);
  int splits = 1;
  if (tiles < 200 && K >= 256 && !round_out) {
    splits = (K + 127) / 128;
    if (splits > kMaxSplits) splits = kMaxSplits;
    if ((size_t)splits * M * N > sb.cap) splits = 1;
  }
  int kchunk = (K + splits - 1) / splits;
  kchunk = (kchunk + kNgKC - 1) / kNgKC * kNgKC;
  splits = (K + kchunk - 1) / kchunk;
  NodeGemm g = {};
  g.a1 = a; g.lda1 = lda; g.k1 = K; g.ta = ta;
  g.b = b; g.ldb = ldb; g.tb = tb;
  g.M = M; g.N = N; g.K = K; g.kchunk = kchunk; g.epilogue = kEpiNone;
  if (splits == 1) {
    g.c = c; g.ldc = ldc; g.accumulate = accumulate; g.round_out = round_out;
    return launch_node_gemm<false, GRAD16>(g, 1, s);
  }
  g.c = sb.buf; g.ldc = N; g.split_stride = (size_t)M * N;
  int rc = launch_node_gemm<false, GRAD16>(g, splits, s);
  if (rc) return rc;
  splitk_reduce_kernel<<<(M * N + 255) / 256, 256, 0, s>>>(sb.buf, splits, M, N, c, ldc,
                                                           accumulate);
  return (int)cudaGetLastError();
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
  splitk_reduce_kernel<<<(H * H + 255) / 256, 256, 0, s>>>(wsplit, splits, H, H, gw2, H,
                                                           accumulate);
  return (int)cudaGetLastError();
}

}  // namespace
