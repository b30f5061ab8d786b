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
// Two designs, picked by ops/group_norm.py's `stats_plan` from the shape and
// the card (both are this function, both count as kernel N's statistics):
//
// Cluster (entry group_norm_stats_cluster, kernel group_norm_stats_resident),
// where a group block's slab fits the shared memory of a thread-block
// cluster of at most 8 CTAs (the portable size): on an H100 the VAE's
// latents and its 512- and 256-channel half-resolution levels. One launch,
// no global scratch, no atomics. A cluster takes one batch element and one
// group block: neighbouring groups whose CB = 8 K channels (K a power of
// two up to 32) the plan picks up to 128 bytes a pixel, since the L2
// serves a request for every pixel's row and narrow rows bound the loads
// (4 groups at C = 512, 16 at C = 128 where the slab fits). Its CTAs split
// the pixels evenly. Each copies its share of the slab, pixels x CB bf16,
// into shared memory once (16-byte cp.async through L2, two commit groups
// so that the first half's sums start while the second half lands) and
// sums each channel: thread t owns the 16-byte chunks t, t + 512, ... of
// the slab (chunk i is pixel i / K, channel chunk i % K), so it reads back
// only what it copied itself; then a butterfly over a warp's lanes of the
// same chunk, the 16 warps in order. After a cluster barrier every CTA
// reads the cluster's per-channel sums through distributed shared memory in
// rank order and forms the channel means and the group means (the order
// below). Pass 2 reads the resident slab, not global memory, and subtracts
// the group mean; its sums go through DSMEM again, and rank 0 writes a and
// bb for the block's channels. A last cluster barrier keeps every CTA's
// shared memory alive until rank 0 has read it. Bound: x read once; on the
// H100 a launch and three cluster barriers cost ~5.5 us of the (1, 48,
// 144, 512) call's 8 (PERF.md).
//
// Stream (group_norm_stats) elsewhere: the full-resolution levels, and
// slabs that 8 CTAs hold only in 16-byte rows while x fits in L2 (there two
// dense reads cost the L2 no more). Two launches (one a pass over x). A CTA
// streams a slab of pixels of one batch element with 16-byte loads: C / 8
// threads cover a pixel, 8 channels a thread, and the CTA's P = 256 / (C /
// 8) lanes of threads take every P-th pixel, 8 loads in flight a thread.
// Each thread sums its channels in fp32, the CTA sums its lanes in lane
// order and writes one row of C partial sums; the last CTA of the batch
// element to arrive (an atomic ticket after a __threadfence) sums the rows
// in the same lane layout and forms the group means (pass 1: mu, kept for
// pass 2; pass 2: a and bb).
//
// In both every sum has a fixed order, so repeats give the same bits. Not
// Welford, not E[x^2] - E[x]^2: the second pass subtracts the group mean as
// JAX does.
//
// group_norm_apply: y = act(bf16(x * a + bb)) with act none or swish, swish
// as JAX's bf16 chain rounds it: s = bf16(sigmoid(h)), y = bf16(h * s) on
// the bf16 h. One pass, the same pixel layout, a and bb in registers.
//
// Bound on the H100 (3.35 TB/s): the bytes, x read once: 0.080 ms at (1,
// 1024, 1024, 128), where the streaming design reads it twice from HBM.
// The apply reads x and writes y: 0.160 ms at the same shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- the cluster design

constexpr int CL_THREADS = 512;
constexpr int CL_WARPS = CL_THREADS / 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// this thread's VEC sums -> out[k * VEC + j] (k = its channel chunk), summed
// over the CTA: a butterfly over the warp's lanes of chunk k (lane ^ K, 2K,
// ..., 16 hold the same chunk), then the warps in order. wsum: CL_WARPS x CB
// floats of shared memory, free on entry; out: CB floats.
template <int K>
__device__ __forceinline__ void cta_sums(float* acc, float* wsum, float* out) {
  constexpr int CB = K * VEC;
#pragma unroll
  for (int off = 16; off >= K; off /= 2) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane < K) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) wsum[warp * CB + lane * VEC + j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < CB) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < CL_WARPS; ++w) v = __fadd_rn(v, wsum[w * CB + threadIdx.x]);
    out[threadIdx.x] = v;
  }
}

// the cluster's sum of `part` (CB floats at the same offset in every CTA),
// rank by rank in order, for channel threadIdx.x < CB: every rank's value
// loaded first (ranks past the cluster add +0)
__device__ __forceinline__ float cluster_total(const float* part, int cluster) {
  const uint32_t addr = vc::smem_addr(part + threadIdx.x);
  float p[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) p[r] = r < cluster ? vc::ld_cluster_f32(vc::mapa(addr, r)) : 0.f;
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) v = __fadd_rn(v, p[r]);
  return v;
}

// the mean of channel c's group: the sum of its group's cg values of chan
// in order, over cg
__device__ __forceinline__ float group_mean(const float* chan, int c, int cg) {
  const int g0 = (c / cg) * cg;
  float v = 0.f;
#pragma unroll 8
  for (int j = 0; j < cg; ++j) v = __fadd_rn(v, chan[g0 + j]);
  return __fdiv_rn(v, (float)cg);
}

// One cluster: batch element blockIdx.y, group block blockIdx.x / cluster
// (CB = K * VEC channels from CB * block), pixels [rank * per, rank * per +
// per) of HW for the CTA of rank `rank`. Dynamic shared memory: the slab (per
// x CB bf16), then fp32 wsum (CL_WARPS x CB), part (2 x CB: pass 1's sums,
// pass 2's), chan (CB), mu (CB).
template <int K>
__global__ void __launch_bounds__(CL_THREADS, 1)
    group_norm_stats_resident(const bf16* __restrict__ x, const void* __restrict__ scale,
                              const void* __restrict__ bias, int params_bf16, float* __restrict__ a,
                              float* __restrict__ bb, int HW, int C, int cg, int cluster, int per, float eps) {
  constexpr int CB = K * VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* slab = reinterpret_cast<uint4*>(smem);
  float* wsum = reinterpret_cast<float*>(smem + (size_t)per * CB * sizeof(bf16));
  float* part = wsum + CL_WARPS * CB;
  float* chan = part + 2 * CB;
  float* mu = chan + CB;

  const int rank = (int)vc::cluster_rank(), b = blockIdx.y, c0 = (blockIdx.x / cluster) * CB;
  const int p0 = rank * per;
  const int n = max(0, min(per, HW - p0)) * K;  // the CTA's 16-byte chunks
  const int t = threadIdx.x, k = t % K;
  // rank 0's parameters, loaded while the slab lands
  float sc = 0.f, bi = 0.f;
  if (t < CB) {
    sc = param(scale, c0 + t, params_bf16);
    bi = param(bias, c0 + t, params_bf16);
  }

  // this thread's chunks t + j * CL_THREADS, j < mine: those below `split` in a first group
  const int mine = t < n ? (n - t + CL_THREADS - 1) / CL_THREADS : 0;
  const int split = t + (mine / 2) * CL_THREADS;
  const bf16* xb = x + ((size_t)b * HW + p0) * C + c0 + k * VEC;
  for (int i = t; i < n; i += CL_THREADS) {
    vc::cp_async16(vc::smem_addr(slab + i), xb + (size_t)(i / K) * C);
    if (i + CL_THREADS == split) vc::cp_async_commit();
  }
  vc::cp_async_commit();

  float zero[VEC], acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) zero[j] = acc[j] = 0.f;
  vc::cp_async_wait<1>();
  int i = t;
  for (; i < split; i += CL_THREADS) accumulate<false>(slab[i], zero, acc);
  vc::cp_async_wait<0>();
  for (; i < n; i += CL_THREADS) accumulate<false>(slab[i], zero, acc);
  cta_sums<K>(acc, wsum, part);
  vc::cluster_sync();  // every CTA's part written; also a CTA barrier

  // the channel means and the group means, the same bits in every CTA
  const float npix = (float)HW;
  if (t < CB) chan[t] = __fdiv_rn(cluster_total(part, cluster), npix);
  __syncthreads();
  if (t < CB) mu[t] = group_mean(chan, t, cg);
  __syncthreads();

  // pass 2 from the resident slab
  float m[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = mu[k * VEC + j];
    acc[j] = 0.f;
  }
  for (i = t; i < n; i += CL_THREADS) accumulate<true>(slab[i], m, acc);
  cta_sums<K>(acc, wsum, part + CB);
  vc::cluster_sync();  // every CTA's pass-2 sums written

  if (rank == 0) {
    if (t < CB) chan[t] = __fdiv_rn(cluster_total(part + CB, cluster), npix);
    __syncthreads();
    if (t < CB) {
      const float var = group_mean(chan, t, cg);
      const size_t o = (size_t)b * C + c0 + t;
      const float av = __fmul_rn(rsqrtf(__fadd_rn(var, eps)), sc);
      a[o] = av;
      bb[o] = __fsub_rn(bi, __fmul_rn(mu[t], av));
    }
  }
  vc::cluster_sync();  // no CTA exits while rank 0 reads its shared memory
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

// the cluster design's dynamic shared memory: the slab of `per` pixels x CB
// channels, then the CTA's fp32 sums (CL_WARPS + 4 rows of CB)
size_t cluster_smem(int per, int CB) { return (size_t)per * CB * sizeof(bf16) + (size_t)(CL_WARPS + 4) * CB * 4; }

template <int K>
int launch_stats_cluster(const void* x, const void* scale, const void* bias, int params_bf16, void* a, void* bb,
                         int B, int HW, int C, int groups, int cluster, float eps, cudaStream_t s) {
  constexpr int CB = K * VEC;
  auto kern = group_norm_stats_resident<K>;
  const int per = (HW + cluster - 1) / cluster;
  const size_t smem = cluster_smem(per, CB);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(C / CB * cluster, B);
  return vc::launch_cluster(kern, grid, CL_THREADS, smem, s, cluster, static_cast<const bf16*>(x), scale, bias,
                            params_bf16, static_cast<float*>(a), static_cast<float*>(bb), HW, C, C / groups, cluster,
                            per, eps);
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

// Kernel N, statistics, the cluster design: one launch, no scratch. x (B, HW,
// C) bf16 contiguous, 16-byte aligned; scale, bias (C,) bf16 (params_bf16 1)
// or fp32 (0); a, bb (B, C) fp32. A cluster of `cluster` CTAs (1, 2, 4 or 8)
// per batch element and group block of `block_groups` groups, whose channels
// are 8 K for K a power of two up to 32; the slab's share of a CTA must fit
// the card's shared memory (ops/group_norm.py `stats_plan`). Launches on
// `stream`; returns a cudaError_t (0 on success; a shape or plan it cannot
// take: cudaErrorInvalidValue).
extern "C" int group_norm_stats_cluster(const void* x, const void* scale, const void* bias, int params_bf16,
                                        void* a, void* bb, int B, int HW, int C, int groups, int block_groups,
                                        int cluster, float eps, void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || groups <= 0 || C % groups || block_groups <= 0 ||
      groups % block_groups)
    return (int)cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const int CB = block_groups * (C / groups);
  if (CB % VEC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VC_GN_CASE(k)                                                                                             \
  case k:                                                                                                         \
    return launch_stats_cluster<k>(x, scale, bias, params_bf16, a, bb, B, HW, C, groups, cluster, eps, s);
  switch (CB / VEC) {
    VC_GN_CASE(1)
    VC_GN_CASE(2)
    VC_GN_CASE(4)
    VC_GN_CASE(8)
    VC_GN_CASE(16)
    VC_GN_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VC_GN_CASE
}

// How many clusters of the cluster design the card runs at once for a plan
// (as group_norm_stats_cluster takes it): 0 or more, or minus a cudaError_t.
extern "C" int group_norm_cluster_occupancy(int HW, int C, int groups, int block_groups, int cluster) {
  if (HW <= 0 || C <= 0 || groups <= 0 || C % groups || block_groups <= 0 || cluster <= 0 || cluster > MAX_CLUSTER)
    return -(int)cudaErrorInvalidValue;
  const int CB = block_groups * (C / groups), per = (HW + cluster - 1) / cluster;
  const size_t smem = cluster_smem(per, CB);
  auto occupancy = [&](auto kern) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return e != cudaSuccess ? -(int)e : vc::max_active_clusters(kern, CL_THREADS, smem, cluster);
  };
  switch (CB % VEC ? 0 : CB / VEC) {
    case 1: return occupancy(group_norm_stats_resident<1>);
    case 2: return occupancy(group_norm_stats_resident<2>);
    case 4: return occupancy(group_norm_stats_resident<4>);
    case 8: return occupancy(group_norm_stats_resident<8>);
    case 16: return occupancy(group_norm_stats_resident<16>);
    case 32: return occupancy(group_norm_stats_resident<32>);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// Kernel N's limits on device `device`: its SMs, the shared memory a CTA may
// opt in to and its L2 (bytes), the inputs of ops/group_norm.py's
// `stats_plan`. Returns a cudaError_t.
extern "C" int group_norm_device_limits(int device, int* sms, int* smem_per_cta, int* l2_bytes) {
  cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(smem_per_cta, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(l2_bytes, cudaDevAttrL2CacheSize, device);
  return (int)e;
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
