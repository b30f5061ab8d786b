// Kernel N: the VAE's GroupNorm statistics, and its plain apply (+ swish).
//
// Replaces XLA fusions, not a Pallas kernel: visualcloze_tpu/models/
// autoencoder.py `group_norm_affine` (:37), the statistics every resnet
// half-block, attention block and norm_out takes, and `group_norm` (:61)
// followed by `swish` where it is not folded into a conv (the attention
// block's norm, :144, and the two norm_outs, :192 and :208).
//
// group_norm_stats: x (B, H, W, C) bf16 NHWC -> a, bb (B, C) fp32, the affine
// y = x * a + bb that kernel B's pre_affine takes. JAX's order, all in fp32:
//
//     m_c   = sum_hw x / HW                  (per channel)
//     mu_g  = sum_{c in g} m_c / cg          (cg = C / groups)
//     v_c   = sum_hw (x - mu_g)^2 / HW       (a second read of x)
//     var_g = sum_{c in g} v_c / cg
//     a     = rsqrt(var_g + eps) * scale_c,  bb = bias_c - mu_g * a
//
// Two launches (one a pass over x). A CTA streams a slab of pixels of one
// batch element with 16-byte loads: C / 8 threads cover a pixel, 8 channels a
// thread, and the CTA's P = 256 / (C / 8) lanes of threads take every P-th
// pixel, 8 loads in flight a thread. Each thread sums its channels in fp32,
// the CTA sums its lanes in lane order and writes one row of C partial sums;
// the last CTA of the batch element to arrive (an atomic ticket after a
// __threadfence) sums the rows in the same lane layout and forms the group
// means (pass 1: mu, kept for pass 2; pass 2: a and bb). Every sum has a
// fixed order, so repeats give the same bits. Not Welford, not E[x^2] -
// E[x]^2: the second pass subtracts the group mean as JAX does.
//
// group_norm_apply: y = act(bf16(x * a + bb)) with act none or swish, swish
// as JAX's bf16 chain rounds it: s = bf16(sigmoid(h)), y = bf16(h * s) on
// the bf16 h. One pass, the same pixel layout, a and bb in registers.
//
// Bound on the H100 (3.35 TB/s): the bytes. The statistics read x twice
// unless it fits in the 50 MB L2 (then the second read hits L2 and the bound
// counts x once): 2 x 268 MB at (1, 1024, 1024, 128), 0.160 ms. The apply
// reads x and writes y: 0.160 ms at the same shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;       // channels a thread: one 16-byte load of bf16
constexpr int THREADS = 256;  // at most; a CTA is (C / 8) x P threads
constexpr int MAX_C = 2048;   // C / 8 <= THREADS
constexpr int UNROLL = 8;     // loads in flight a thread

struct Slab {
  int t, p, T, P, c0, start, end;
};

// this thread's channel chunk and lane, and the CTA's pixels [start, end)
__device__ __forceinline__ Slab slab(int HW, int C) {
  Slab s;
  s.T = C / VEC;
  s.P = blockDim.x / s.T;
  s.t = threadIdx.x % s.T;
  s.p = threadIdx.x / s.T;
  s.c0 = s.t * VEC;
  const int per = (HW + gridDim.x - 1) / gridDim.x;
  s.start = blockIdx.x * per;
  s.end = min(HW, s.start + per);
  return s;
}

template <bool SECOND>
__device__ __forceinline__ void accumulate(const uint4& u, const float* mean, float* acc) {
  float f[VEC];
  vc::unpack8(u, f);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (SECOND) {
      const float d = __fsub_rn(f[j], mean[j]);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
    } else {
      acc[j] = __fadd_rn(acc[j], f[j]);
    }
  }
}

// the P lanes' VEC sums of each thread -> out[c] for every channel, in lane order
__device__ __forceinline__ void sum_lanes(float* red, const Slab& s, const float* acc, int C, float* out) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) red[s.p * C + s.c0 + j] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float v = 0.f;
    for (int q = 0; q < s.P; ++q) v = __fadd_rn(v, red[q * C + c]);
    out[c] = v;
  }
}

// a GroupNorm parameter (C,) in fp32, stored as bf16 (the VAE's) or fp32
__device__ __forceinline__ float param(const void* p, int c, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[c]) : static_cast<const float*>(p)[c];
}

// Pass 1 (SECOND false): mu (B, C) = the group mean of each channel's group.
// Pass 2: a and bb from mu, scale and bias. partial: (B, gridDim.x, C) fp32
// scratch; ticket: (B,) zero on entry, zero again on exit.
template <bool SECOND>
__global__ void __launch_bounds__(THREADS)
    group_norm_stats_pass(const bf16* __restrict__ x, float* __restrict__ mu, const void* __restrict__ scale,
                          const void* __restrict__ bias, int params_bf16, float* __restrict__ a,
                          float* __restrict__ bb, float* partial, unsigned* ticket, int HW, int C, int groups,
                          float eps) {
  __shared__ float red[MAX_C];
  __shared__ float chan[MAX_C];
  __shared__ bool last;
  const int b = blockIdx.y, nblk = gridDim.x;
  const Slab s = slab(HW, C);
  float mean[VEC], acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mean[j] = SECOND ? mu[(size_t)b * C + s.c0 + j] : 0.f;
    acc[j] = 0.f;
  }
  const bf16* xb = x + (size_t)b * HW * C + s.c0;
  int i = s.start + s.p;
  for (; i + (UNROLL - 1) * s.P < s.end; i += UNROLL * s.P) {
    uint4 u[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) u[k] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)(i + k * s.P) * C));
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) accumulate<SECOND>(u[k], mean, acc);
  }
  for (; i < s.end; i += s.P) accumulate<SECOND>(__ldg(reinterpret_cast<const uint4*>(xb + (size_t)i * C)), mean, acc);

  float* rows = partial + (size_t)b * nblk * C;
  sum_lanes(red, s, acc, C, rows + (size_t)blockIdx.x * C);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket + b, 1u) == (unsigned)(nblk - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last CTA: the rows of every CTA, lane p taking rows p, p + P, ...
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int r = s.p; r < nblk; r += s.P) {
    const float4 lo = __ldcg(reinterpret_cast<const float4*>(rows + (size_t)r * C + s.c0));
    const float4 hi = __ldcg(reinterpret_cast<const float4*>(rows + (size_t)r * C + s.c0) + 1);
    const float f[VEC] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], f[j]);
  }
  __syncthreads();  // every lane has read red in sum_lanes
  sum_lanes(red, s, acc, C, chan);
  __syncthreads();
  const float n = (float)HW;
  for (int c = threadIdx.x; c < C; c += blockDim.x) chan[c] = __fdiv_rn(chan[c], n);
  __syncthreads();
  const int cg = C / groups;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g0 = (c / cg) * cg;
    float v = 0.f;
    for (int j = 0; j < cg; ++j) v = __fadd_rn(v, chan[g0 + j]);
    v = __fdiv_rn(v, (float)cg);
    const size_t o = (size_t)b * C + c;
    if (!SECOND) {
      mu[o] = v;
    } else {
      const float av = __fmul_rn(rsqrtf(__fadd_rn(v, eps)), param(scale, c, params_bf16));
      a[o] = av;
      bb[o] = __fsub_rn(param(bias, c, params_bf16), __fmul_rn(mu[o], av));
    }
  }
  if (threadIdx.x == 0) ticket[b] = 0u;
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <bool SWISH>
__device__ __forceinline__ uint4 apply8(const uint4& u, const float* av, const float* bv) {
  float f[VEC];
  vc::unpack8(u, f);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float h = round_bf16(__fadd_rn(__fmul_rn(f[j], av[j]), bv[j]));
    if (SWISH) {
      const float sg = round_bf16(1.0f / (1.0f + expf(-h)));
      f[j] = __fmul_rn(h, sg);
    } else {
      f[j] = h;
    }
  }
  return vc::pack8(f);
}

template <bool SWISH>
__global__ void __launch_bounds__(THREADS)
    group_norm_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ bb,
                            bf16* __restrict__ y, int HW, int C) {
  const int b = blockIdx.y;
  const Slab s = slab(HW, C);
  float av[VEC], bv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    av[j] = a[(size_t)b * C + s.c0 + j];
    bv[j] = bb[(size_t)b * C + s.c0 + j];
  }
  const size_t base = (size_t)b * HW * C + s.c0;
  const bf16* xb = x + base;
  bf16* yb = y + base;
  constexpr int U = UNROLL / 2;
  int i = s.start + s.p;
  for (; i + (U - 1) * s.P < s.end; i += U * s.P) {
    uint4 u[U];
#pragma unroll
    for (int k = 0; k < U; ++k) u[k] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)(i + k * s.P) * C));
#pragma unroll
    for (int k = 0; k < U; ++k)
      *reinterpret_cast<uint4*>(yb + (size_t)(i + k * s.P) * C) = apply8<SWISH>(u[k], av, bv);
  }
  for (; i < s.end; i += s.P)
    *reinterpret_cast<uint4*>(yb + (size_t)i * C) =
        apply8<SWISH>(__ldg(reinterpret_cast<const uint4*>(xb + (size_t)i * C)), av, bv);
}

int threads_for(int C) {
  const int T = C / VEC;
  return T * (T >= THREADS ? 1 : THREADS / T);
}

bool bad_shape(int B, int HW, int C, int nblk) {
  return B <= 0 || HW <= 0 || C <= 0 || C % VEC || C > MAX_C || nblk <= 0 || nblk > 65535;
}

}  // namespace

// Kernel N, statistics. x (B, HW, C) bf16 contiguous, 16-byte aligned; scale,
// bias (C,) bf16 (params_bf16 1) or fp32 (0); a, bb, mu (B, C) fp32 (mu:
// scratch); partial (B, nblk, C)
// fp32 scratch; ticket (B,) uint32 scratch (zeroed here). C a multiple of 8
// up to 2048, groups dividing C. Launches a memset and both passes on
// `stream`; returns a cudaError_t (0 on success).
extern "C" int group_norm_stats(const void* x, const void* scale, const void* bias, int params_bf16, void* a,
                                void* bb, void* mu, void* partial, void* ticket, int B, int HW, int C, int groups,
                                int nblk, float eps, void* stream) {
  if (bad_shape(B, HW, C, nblk) || groups <= 0 || C % groups) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned) * B, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nblk, B);
  const int threads = threads_for(C);
  const bf16* xp = static_cast<const bf16*>(x);
  float* mp = static_cast<float*>(mu);
  float* ap = static_cast<float*>(a);
  float* bbp = static_cast<float*>(bb);
  float* pp = static_cast<float*>(partial);
  unsigned* tp = static_cast<unsigned*>(ticket);
  group_norm_stats_pass<false><<<grid, threads, 0, s>>>(xp, mp, scale, bias, params_bf16, ap, bbp, pp, tp, HW, C,
                                                         groups, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_norm_stats_pass<true><<<grid, threads, 0, s>>>(xp, mp, scale, bias, params_bf16, ap, bbp, pp, tp, HW, C,
                                                         groups, eps);
  return (int)cudaGetLastError();
}

// Kernel N, apply. x, y (B, HW, C) bf16 contiguous, 16-byte aligned; a, bb
// (B, C) fp32; swish 0 or 1. Launches on `stream`; returns a cudaError_t.
extern "C" int group_norm_apply(const void* x, const void* a, const void* bb, void* y, int B, int HW, int C,
                                int swish, int nblk, void* stream) {
  if (bad_shape(B, HW, C, nblk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nblk, B);
  const int threads = threads_for(C);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(bb);
  bf16* yp = static_cast<bf16*>(y);
  if (swish)
    group_norm_apply_kernel<true><<<grid, threads, 0, s>>>(xp, ap, bp, yp, HW, C);
  else
    group_norm_apply_kernel<false><<<grid, threads, 0, s>>>(xp, ap, bp, yp, HW, C);
  return (int)cudaGetLastError();
}
