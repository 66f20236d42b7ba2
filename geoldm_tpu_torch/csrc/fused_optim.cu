// One training step's optimizer tail in three launches on Hopper (sm_90a):
// the adaptive clip's global norm, its threshold, and one elementwise pass
// that clips each gradient, steps AMSGrad (torch.optim.AdamW with
// amsgrad=True, decoupled weight decay) and moves the EMA.
//
// Replaces no TPU kernel: XLA fuses optax's clip, AMSGrad chain and EMA
// (geoldm_tpu/train/optim.py) into a few ops of one compiled step. Eager
// PyTorch issued them per tensor instead: a multiply, a sum and an add per
// gradient for the norm, torch's foreach AdamW (about nine foreach ops, each
// several multi-tensor launches) and the EMA's two foreach ops, ~920
// launches a QM9 step, whose issue the host could not keep up with.
//
// What bounds it on an H100: memory. The norm reads every stepped gradient
// once; the update reads p, g, m, v, vmax and the EMA and writes all six
// back; the EMA-only tensors (no gradient this step: the encoder's, frozen
// ones) read p and e and write e. At QM9's 10,675,482 stepped and 727,044
// EMA-only elements that is 42.7 MB, 512 MB and 8.7 MB: 0.17 ms together at
// 3.35 TB/s. The arithmetic is a few flops an element.
//
// Design:
//   - every tensor is reached through a device table of pointers and sizes
//     (Tensor), built when the state is built or loaded, and a list of
//     (tensor, chunk) entries of kChunk elements (Chunk); nothing is copied
//     into a flat buffer. Gradients are reallocated by autograd every step,
//     so their pointers travel in the launch's parameter block (Grads, at
//     most kMaxGrads a launch, under the 4 KB limit): no host-to-device copy,
//     no synchronisation;
//   - the norm's blocks each sum the squares of a fixed slice of the chunk
//     list in double, in a fixed order per thread and a fixed tree per
//     block, and write a partial; the last block to finish (a ticket
//     counter) adds the partials in index order. The result does not depend
//     on which block finishes last, so a seeded step replays bit for bit.
//     Under tensor parallelism the tensors marked as shards are summed apart,
//     so their sum can go through the caller's one all-reduce;
//   - the threshold is one thread: the norm, the clip's ring-buffer
//     statistics (1.5 * mean + 2 * std, in double, rounded once), the scale
//     min(thr / (norm + 1e-12), 1) and the ring-buffer entry min(norm, thr)
//     in f32, written to the device; nothing goes back to the host;
//   - the update is one block a chunk, four elements a thread a step as
//     float4 where all six pointers are 16-byte aligned, element by element
//     otherwise (views at odd offsets, ragged ends). Each element follows
//     the foreach ops of torch's non-capturable AdamW in their order, each
//     op rounded as its own kernel rounds it (explicit _rn intrinsics and
//     fmaf where torch's kernels compute a + s * b), with IEEE sqrt and
//     division (no --use_fast_math).
// Launches: norm and update one per kMaxGrads gradients (every stepped
// tensor at one step count), threshold one: three a step for every recipe
// of the port.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;            // elements of one chunk: 16 a thread
constexpr int kNormChunksPerBlock = 4;  // a norm block's slice of the chunk list
constexpr int kMaxGrads = 448;          // 3584 bytes of pointers in the parameter block

// One tensor of the table (fused_optim.py:TENSOR_DTYPE mirrors the layout).
// m, v and vmax are null for a tensor the step only averages into the EMA;
// e is null without EMA.
struct Tensor {
  float* p;
  float* m;
  float* v;
  float* vmax;
  float* e;
  long long n;
  int shard;  // a TP shard: its squares are the norm's second sum
  int pad;
};

struct Chunk {
  int tensor;  // index in the table
  int index;   // elements [index * kChunk, min((index + 1) * kChunk, n))
};

// The gradients of the launch's tensors t0, t0 + 1, ... (table order).
struct Grads {
  float* g[kMaxGrads];
};

// AdamW's scalars as torch's foreach path hands them to its kernels: each
// computed in double on the host, then rounded to float.
struct Hyper {
  float decay;      // 1 - lr * weight_decay
  float w1;         // 1 - beta1, the lerp weight of exp_avg
  float beta2;
  float omb2;       // 1 - beta2
  float step_size;  // -lr / (1 - beta1^step)
  float bc2_sqrt;   // sqrt(1 - beta2^step)
  float eps;
  float ema_d;      // the EMA's decay d
  float ema_omd;    // 1 - d
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The sum over the block, valid on thread 0; the same tree every call.
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  return v;
}

__device__ __forceinline__ double sq(float x) { return (double)__fmul_rn(x, x); }

// This thread's share of the squares of g[s:e); s is a multiple of 4.
__device__ double chunk_sumsq(const float* g, long long s, long long e) {
  double acc = 0.0;
  long long i = s;
  if (aligned16(g)) {
    const long long e4 = s + ((e - s) & ~3LL);
    const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll 4
    for (long long k = s / 4 + threadIdx.x; k < e4 / 4; k += kThreads) {
      const float4 x = g4[k];
      acc += sq(x.x);
      acc += sq(x.y);
      acc += sq(x.z);
      acc += sq(x.w);
    }
    i = e4;
  }
  for (long long k = i + threadIdx.x; k < e; k += kThreads) acc += sq(g[k]);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    norm_kernel(const Tensor* __restrict__ table, const Chunk* __restrict__ chunks, int c0, int c1,
                int t0, const __grid_constant__ Grads grads, double* partials, int slot0,
                unsigned int* counter, int total_blocks, float* sums) {
  __shared__ double red[kThreads / 32];
  __shared__ bool last;
  double rep = 0.0, shard = 0.0;
  const int begin = c0 + blockIdx.x * kNormChunksPerBlock;
  const int end = min(c1, begin + kNormChunksPerBlock);
  for (int c = begin; c < end; ++c) {
    const Chunk ch = chunks[c];
    const long long n = table[ch.tensor].n;
    const long long s = (long long)ch.index * kChunk;
    const double v = chunk_sumsq(grads.g[ch.tensor - t0], s, min(s + kChunk, n));
    if (table[ch.tensor].shard)
      shard += v;
    else
      rep += v;
  }
  rep = block_sum(rep, red);
  shard = block_sum(shard, red);
  const int slot = slot0 + blockIdx.x;
  if (threadIdx.x == 0) {
    partials[2 * slot] = rep;
    partials[2 * slot + 1] = shard;
    __threadfence();
    last = atomicAdd(counter, 1u) == (unsigned int)(total_blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  rep = shard = 0.0;
  for (int b = threadIdx.x; b < total_blocks; b += kThreads) {
    rep += __ldcg(partials + 2 * b);
    shard += __ldcg(partials + 2 * b + 1);
  }
  rep = block_sum(rep, red);
  shard = block_sum(shard, red);
  if (threadIdx.x == 0) {
    sums[0] = (float)rep;
    sums[1] = (float)shard;
    *counter = 0u;  // ready for the next step's launch
  }
}

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

// train/optim.py:AdaptiveGradClip.__call__ after global_norm, op for op.
__global__ void threshold_kernel(const float* sums, const float* shard_sum, float* norms,
                                 int count, int head, int len, float* out_norm, float* scale) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const float norm = __fsqrt_rn(__fadd_rn(sums[0], shard_sum ? shard_sum[0] : sums[1]));
  *out_norm = norm;
  float s = 1.0f;
  if (norms) {
    // The buffer's statistics in double, rounded once: a sequential f32 sum
    // of 50 entries would be off by up to ~3e-6 of the mean.
    double total = 0.0;
    for (int i = 0; i < count; ++i) total += (double)norms[i];
    const double mean = total / count;
    double var = 0.0;
    for (int i = 0; i < count; ++i) {
      const double d = (double)norms[i] - mean;
      var += d * d;
    }
    const float thr = __double2float_rn(1.5 * mean + 2.0 * sqrt(var / count));
    const float r = __fdiv_rn(thr, __fadd_rn(norm, 1e-12f));
    s = r > 1.0f ? 1.0f : r;  // clamp(max=1) keeps a NaN
    norms[head % len] = nan_min(norm, thr);
  }
  *scale = s;
}

// One element: the clip's in-place scale, then torch's foreach AdamW
// (weight decay, lerp, exp_avg_sq, maximum, sqrt / bc2_sqrt + eps,
// addcdiv), then the EMA (mul, add with alpha).
__device__ __forceinline__ void step_elem(float& p, float& g, float& m, float& v, float& x,
                                          float& e, float scale, const Hyper& h, bool ema) {
  g = __fmul_rn(g, scale);
  p = __fmul_rn(p, h.decay);
  m = fmaf(h.w1, __fsub_rn(g, m), m);
  v = fmaf(h.omb2, __fmul_rn(g, g), __fmul_rn(v, h.beta2));
  x = nan_max(x, v);
  const float denom = __fadd_rn(__fdiv_rn(__fsqrt_rn(x), h.bc2_sqrt), h.eps);
  p = fmaf(h.step_size, __fdiv_rn(m, denom), p);
  if (ema) e = fmaf(h.ema_omd, p, __fmul_rn(e, h.ema_d));
}

__device__ __forceinline__ float ema_elem(float e, float p, const Hyper& h) {
  return fmaf(h.ema_omd, p, __fmul_rn(e, h.ema_d));
}

__global__ void __launch_bounds__(kThreads)
    update_kernel(const Tensor* __restrict__ table, const Chunk* __restrict__ chunks, int c0,
                  int t0, const __grid_constant__ Grads grads, const float* __restrict__ scale_ptr,
                  Hyper h, int ema) {
  const Chunk ch = chunks[c0 + blockIdx.x];
  const Tensor t = table[ch.tensor];
  const long long s = (long long)ch.index * kChunk;
  const long long end = min(s + kChunk, t.n);
  const long long e4 = s + ((end - s) & ~3LL);
  if (t.m == nullptr) {  // EMA only
    long long i = s;
    if (aligned16(t.p) && aligned16(t.e)) {
      const float4* p4 = reinterpret_cast<const float4*>(t.p);
      float4* q4 = reinterpret_cast<float4*>(t.e);
      for (long long k = s / 4 + threadIdx.x; k < e4 / 4; k += kThreads) {
        const float4 p = p4[k];
        float4 q = q4[k];
        q.x = ema_elem(q.x, p.x, h);
        q.y = ema_elem(q.y, p.y, h);
        q.z = ema_elem(q.z, p.z, h);
        q.w = ema_elem(q.w, p.w, h);
        q4[k] = q;
      }
      i = e4;
    }
    for (long long k = i + threadIdx.x; k < end; k += kThreads)
      t.e[k] = ema_elem(t.e[k], t.p[k], h);
    return;
  }
  float* g = grads.g[ch.tensor - t0];
  const float scale = *scale_ptr;
  const bool with_ema = ema != 0;
  long long i = s;
  if (aligned16(t.p) && aligned16(g) && aligned16(t.m) && aligned16(t.v) && aligned16(t.vmax) &&
      (!with_ema || aligned16(t.e))) {
    float4* p4 = reinterpret_cast<float4*>(t.p);
    float4* g4 = reinterpret_cast<float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(t.m);
    float4* v4 = reinterpret_cast<float4*>(t.v);
    float4* x4 = reinterpret_cast<float4*>(t.vmax);
    float4* q4 = reinterpret_cast<float4*>(t.e);
    for (long long k = s / 4 + threadIdx.x; k < e4 / 4; k += kThreads) {
      float4 p = p4[k], gg = g4[k], m = m4[k], v = v4[k], x = x4[k];
      float4 q = with_ema ? q4[k] : make_float4(0.f, 0.f, 0.f, 0.f);
      step_elem(p.x, gg.x, m.x, v.x, x.x, q.x, scale, h, with_ema);
      step_elem(p.y, gg.y, m.y, v.y, x.y, q.y, scale, h, with_ema);
      step_elem(p.z, gg.z, m.z, v.z, x.z, q.z, scale, h, with_ema);
      step_elem(p.w, gg.w, m.w, v.w, x.w, q.w, scale, h, with_ema);
      p4[k] = p;
      g4[k] = gg;
      m4[k] = m;
      v4[k] = v;
      x4[k] = x;
      if (with_ema) q4[k] = q;
    }
    i = e4;
  }
  for (long long k = i + threadIdx.x; k < end; k += kThreads) {
    float p = t.p[k], gg = g[k], m = t.m[k], v = t.v[k], x = t.vmax[k];
    float q = with_ema ? t.e[k] : 0.0f;
    step_elem(p, gg, m, v, x, q, scale, h, with_ema);
    t.p[k] = p;
    g[k] = gg;
    t.m[k] = m;
    t.v[k] = v;
    t.vmax[k] = x;
    if (with_ema) t.e[k] = q;
  }
}

bool fill_grads(Grads& out, const void* const* grads, int n) {
  if (n < 1 || n > kMaxGrads || grads == nullptr) return false;
  for (int i = 0; i < kMaxGrads; ++i) out.g[i] = i < n ? (float*)grads[i] : nullptr;
  return true;
}

}  // namespace

extern "C" {

const char* fused_optim_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The layout the wrapper builds its tables in: {kChunk, kNormChunksPerBlock,
// kMaxGrads, sizeof(Tensor), sizeof(Chunk)}.
int fused_optim_layout(int* out) {
  out[0] = kChunk;
  out[1] = kNormChunksPerBlock;
  out[2] = kMaxGrads;
  out[3] = (int)sizeof(Tensor);
  out[4] = (int)sizeof(Chunk);
  return 0;
}

// The squares of the gradients of chunks [c0, c1) (tensors t0, t0 + 1, ...,
// their n gradients in grads, a host array of device pointers) into
// partials[2 * slot0 ...]; the last of the step's total_blocks blocks writes
// sums[0] (replicated tensors) and sums[1] (TP shards). Returns a
// cudaError_t value.
int fused_optim_norm(const void* table, const void* chunks, int c0, int c1, int t0,
                     const void* const* grads, int n, void* partials, int slot0, void* counter,
                     int total_blocks, void* sums, void* stream) {
  Grads g;
  if (!fill_grads(g, grads, n) || c1 <= c0 || slot0 < 0 || total_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (c1 - c0 + kNormChunksPerBlock - 1) / kNormChunksPerBlock;
  norm_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const Tensor*)table, (const Chunk*)chunks, c0, c1, t0, g, (double*)partials, slot0,
      (unsigned int*)counter, total_blocks, (float*)sums);
  return (int)cudaGetLastError();
}

// The norm sqrt(sums[0] + (shard_sum ? *shard_sum : sums[1])) into out_norm
// and, with the clip's ring buffer norms (null: no clip, scale 1), its
// threshold over norms[:count], the scale and norms[head % len].
int fused_optim_threshold(const void* sums, const void* shard_sum, void* norms, int count,
                          int head, int len, void* out_norm, void* scale, void* stream) {
  if (norms && (count < 1 || count > len || head < 0 || len < 1))
    return (int)cudaErrorInvalidValue;
  threshold_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)sums, (const float*)shard_sum, (float*)norms, count, head, len,
      (float*)out_norm, (float*)scale);
  return (int)cudaGetLastError();
}

// The clip, AMSGrad and EMA over chunks [c0, c1): the chunks of tensors t0,
// t0 + 1, ... (n gradients in grads), then any EMA-only chunks in the
// range. scale: the threshold kernel's output.
int fused_optim_update(const void* table, const void* chunks, int c0, int c1, int t0,
                       const void* const* grads, int n, const void* scale, float decay,
                       float w1, float beta2, float omb2, float step_size, float bc2_sqrt,
                       float eps, float ema_d, float ema_omd, int ema, void* stream) {
  Grads g;
  if (!fill_grads(g, grads, n) || c1 <= c0) return (int)cudaErrorInvalidValue;
  const Hyper h = {decay, w1, beta2, omb2, step_size, bc2_sqrt, eps, ema_d, ema_omd};
  update_kernel<<<c1 - c0, kThreads, 0, (cudaStream_t)stream>>>(
      (const Tensor*)table, (const Chunk*)chunks, c0, t0, g, (const float*)scale, h, ema);
  return (int)cudaGetLastError();
}

}  // extern "C"
