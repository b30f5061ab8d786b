// Kernel J': the backward of kernel J (LayerNorm + adaLN modulate).
//
// Replaces an XLA fusion, not a Pallas kernel: the transpose, under
// jax.grad, of visualcloze_tpu/models/layers.py `layer_norm` (:145) and
// `(1 + scale) * x + shift` in `double_block` (:247, :273), `single_block`
// (:330) and `last_layer` (:370).
//
//     x32 = float(x[b, l, :]); mu, rstd as kernel J (the same sums, the same bits)
//     n = (x32 - mu) * rstd;  g = dy * (1 + scale[b])               (fp32)
//     dx[b, l, :] = bf16(rstd * (g - mean(g) - n * mean(g * n)))
//     dshift[b, c] = sum_l dy[b, l, c];  dscale[b, c] = sum_l dy[b, l, c] * n[b, l, c]
//
// mean and rstd are recomputed from the row rather than saved; mean(g * n)
// is taken as rstd * mean(g * (x32 - mu)), which needs no rstd yet, so a
// row takes two reductions, not three.
//
// Bound on the H100 (3.35 TB/s): the bytes. x and dy read once, dx written
// once: 73.1 MB at (3968, 3072) bf16 (0.022 ms), plus the (B, C) vectors.
// What the design does about it:
//   - Persistent CTAs, one an SM: `ctas` CTAs a batch element (the wrapper
//     gives ceil(132 / B)), each a fixed, contiguous range of its rows, so a
//     CTA's column sums never mix two batch elements.
//   - A ring of 2 stages in dynamic shared memory, each R = 2 rows of x and
//     of dy (24 KB at C = 3072 with bf16 dy). One producer warp fills them
//     with 1-D bulk copies, one a row (x's rows may be strided), each stage
//     with a full and an empty mbarrier. Every consumer thread copies its 8
//     columns of the stage's rows into registers and frees the stage at
//     once, so the next loads are in flight during the whole of its work.
//   - A C / 8-thread consumer, a warp a 256-column chunk, as kernel J's CTA
//     is, so the row sums keep J's order: a thread sums its 8 elements, a
//     shuffle tree sums the warp, and every thread adds the warps' partials
//     (exchanged through shared memory) in warp order. Two named barriers a
//     stage of R rows (the sums of x and g; then of (x - mu)^2 and g (x -
//     mu)), in place of three CTA-wide sums a row.
//   - Then each thread writes dx of its 8 columns with 16-byte stores and
//     adds dy and dy * n into fp32 register partials.
// The design's alternatives were timed against it on the H100
// (scripts/ab_jprime_variants.py at commit f7487ae, PERF.md): one warp a
// row computing its statistics from shared memory while the other warps
// wait (0.048 ms at (3968, 3072) with bf16 dy, against 0.036), three
// reductions a stage, 4 rows a stage (spills) and 4 stages (the first
// stage lands later) were each slower.
// The column sums stay deterministic: each CTA writes its partials once,
// (2, B, ctas, C) fp32 (3.2 MB at 132 CTAs, L2-resident), and a second
// pass (colsum.cuh) adds them in a fixed order. The split of rows to CTAs
// depends only on the shape, so every launch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "colsum.cuh"
#include "hopper.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_C = 4096;
constexpr int R = 2;       // rows a stage
constexpr int STAGES = 2;  // ring stages

// shared memory: full barriers at 0, empty at 16, the warps' partial sums
// at 64 (four sets of R x NCH fp32: sets 0-1 and 2-3 each [2 R][NCH], at
// most 512 bytes), the ring at 640
constexpr uint32_t OFF_EMPTY = 16, OFF_SUMS = 64, OFF_RING = 640;

// 8 consecutive values of a row in shared memory, held raw in registers
template <typename T>
struct Raw8;
template <>
struct Raw8<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(uint32_t a) { u = vc::lds128(a); }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float* f) const { vc::unpack8(u, f); }
};
template <>
struct Raw8<float> {
  uint4 u, v;
  __device__ __forceinline__ void load(uint32_t a) {
    u = vc::lds128(a);
    v = vc::lds128(a + 16);
  }
  __device__ __forceinline__ void zero() { u = v = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y), f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
    f[4] = __uint_as_float(v.x), f[5] = __uint_as_float(v.y), f[6] = __uint_as_float(v.z), f[7] = __uint_as_float(v.w);
  }
};

// the consumer warps (named barrier 1; the producer warp never joins it)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// each of the R values v[r] and w[r] summed over the warp (2 R shuffle trees
// side by side); lane 0 stores the warp's sums at buf[r][warp] (v) and
// buf[R + r][warp] (w)
template <int NCH>
__device__ __forceinline__ void warp_partials(float* v, float* w, uint32_t buf, int warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
      w[r] += __shfl_xor_sync(0xffffffffu, w[r], o);
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      vc::sts32(buf + (r * NCH + warp) * 4, __float_as_uint(v[r]));
      vc::sts32(buf + ((R + r) * NCH + warp) * 4, __float_as_uint(w[r]));
    }
  }
}

// row r's sum of the NCH warps' partials in warp order (kernel J's), over C
template <int NCH>
__device__ __forceinline__ float row_mean(uint32_t buf, int r, int C) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NCH; w += 4) {
    const uint4 t = vc::lds128(buf + (r * NCH + w) * 4);
    s += __uint_as_float(t.x);
    s += __uint_as_float(t.y);
    s += __uint_as_float(t.z);
    s += __uint_as_float(t.w);
  }
  return __fdiv_rn(s, (float)C);
}

// grid (ctas, B); NCH + 1 warps: a consumer warp a 256-column chunk (NCH >=
// ceil(C / 256); the warps past C add zeros, as kernel J's would), then the
// producer warp
template <typename DyT, int NCH>
__global__ void __launch_bounds__(32 * (NCH + 1), 1)
    ln_modulate_bwd_kernel(const bf16* __restrict__ x, long long sb, long long sl, const float* __restrict__ scale,
                           long long s_scale, const DyT* __restrict__ dy, bf16* __restrict__ dx,
                           float* __restrict__ partial, int L, int C) {
  constexpr int CW = NCH;                // consumer warps
  constexpr uint32_t SET = R * NCH * 4;  // bytes of a set of sums
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = vc::smem_addr(smem);
  const uint32_t full = base, empty = base + OFF_EMPTY, sums = base + OFF_SUMS, ring = base + OFF_RING;
  const uint32_t xrow = 2 * C, dyrow = sizeof(DyT) * C, stage_bytes = R * (xrow + dyrow);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, ctas = gridDim.x;
  const int l0 = (int)((long long)blockIdx.x * L / ctas), l1 = (int)((long long)(blockIdx.x + 1) * L / ctas);
  const int nstage = (l1 - l0 + R - 1) / R;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      vc::mbar_init(full + 8 * s, 1);         // the producer's arrive, with the bulk copies' bytes
      vc::mbar_init(empty + 8 * s, 32 * CW);  // every consumer thread
    }
    vc::mbar_init_fence();
  }
  __syncthreads();

  if (warp == CW) {  // the producer: stage k holds rows l0 + R k ... of x, then of dy
    for (int k = 0; k < nstage; ++k) {
      const int s = k % STAGES;
      if (k >= STAGES) vc::mbar_wait(empty + 8 * s, ((k / STAGES) & 1) ^ 1);
      const int r0 = l0 + R * k, nr = min(R, l1 - r0);
      const uint32_t st = ring + s * stage_bytes, bar = full + 8 * s;
      if (lane == 0) vc::mbar_arrive_expect_tx(bar, nr * (xrow + dyrow));
      __syncwarp();
      if (lane < nr)
        vc::bulk_load(st + lane * xrow, x + b * sb + (long long)(r0 + lane) * sl, xrow, bar);
      else if (lane >= R && lane < R + nr)
        vc::bulk_load(st + R * xrow + (lane - R) * dyrow, dy + ((size_t)b * L + r0 + lane - R) * C, dyrow, bar);
    }
    return;
  }

  // this thread's 8 columns, their (1 + scale) and the column sums' partials
  const int c = VEC * threadIdx.x;
  const bool on = c < C;
  float sc1[VEC], acc_shift[VEC], acc_scale[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sc1[i] = acc_shift[i] = acc_scale[i] = 0.0f;
  if (on) {
    const float4* sp = reinterpret_cast<const float4*>(scale + b * s_scale + c);
    const float4 a = __ldg(sp), d = __ldg(sp + 1);
    const float raw[VEC] = {a.x, a.y, a.z, a.w, d.x, d.y, d.z, d.w};
#pragma unroll
    for (int i = 0; i < VEC; ++i) sc1[i] = __fadd_rn(1.0f, raw[i]);
  }
  for (int k = 0; k < nstage; ++k) {
    const int s = k % STAGES;
    const int r0 = l0 + R * k, nr = min(R, l1 - r0);
    const uint32_t st = ring + s * stage_bytes;
    vc::mbar_wait(full + 8 * s, (k / STAGES) & 1);
    Raw8<bf16> xr[R];
    Raw8<DyT> dr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (on && r < nr) {
        xr[r].load(st + r * xrow + 2 * c);
        dr[r].load(st + R * xrow + r * dyrow + sizeof(DyT) * c);
      } else {
        xr[r].zero();
        dr[r].zero();
      }
    }
    vc::mbar_arrive(empty + 8 * s);  // the stage is in registers: the producer may refill it

    // the sums of x (kernel J's order) and of g: sets 0 and 1 of the sums
    float v[R], w[R], mu[R], rs[R], mg[R], mgn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float f[VEC], g[VEC];
      xr[r].get(f);
      dr[r].get(g);
      v[r] = w[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[r] += f[i];
        w[r] += __fmul_rn(g[i], sc1[i]);
      }
    }
    warp_partials<NCH>(v, w, sums, warp);
    consumers_sync(32 * CW);
    // the sums of (x - mu)^2 (kernel J's) and of g (x - mu): sets 2 and 3
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mu[r] = row_mean<NCH>(sums, r, C);
      mg[r] = row_mean<NCH>(sums, R + r, C);
      float f[VEC], g[VEC];
      xr[r].get(f);
      dr[r].get(g);
      v[r] = w[r] = 0.0f;
      if (on) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = __fsub_rn(f[i], mu[r]);
          v[r] = __fmaf_rn(d, d, v[r]);
          w[r] = __fmaf_rn(__fmul_rn(g[i], sc1[i]), d, w[r]);
        }
      }
    }
    warp_partials<NCH>(v, w, sums + 2 * SET, warp);
    consumers_sync(32 * CW);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rs[r] = rsqrtf(__fadd_rn(row_mean<NCH>(sums + 2 * SET, r, C), 1e-6f));
      mgn[r] = __fmul_rn(rs[r], row_mean<NCH>(sums + 2 * SET, R + r, C));
    }
    // (the next stage's first sums overwrite sets 0 and 1 only after every
    // thread has passed the second barrier, so after it read them; sets 2
    // and 3 likewise after the next stage's first barrier)
    if (!on) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) break;
      float f[VEC], g[VEC];
      xr[r].get(f);
      dr[r].get(g);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float n = __fmul_rn(__fsub_rn(f[i], mu[r]), rs[r]);
        acc_shift[i] += g[i];
        acc_scale[i] = __fmaf_rn(g[i], n, acc_scale[i]);
        f[i] = __fmul_rn(rs[r], __fsub_rn(__fsub_rn(__fmul_rn(g[i], sc1[i]), mg[r]), __fmul_rn(n, mgn[r])));
      }
      if (dx != nullptr) *reinterpret_cast<uint4*>(dx + ((size_t)b * L + r0 + r) * C + c) = vc::pack8(f);
    }
  }
  if (partial == nullptr || !on) return;
  // partial (2, B, ctas, C): set 0 dshift, set 1 dscale
  const size_t at = ((size_t)b * ctas + blockIdx.x) * C + c;
  const size_t set = (size_t)gridDim.y * ctas * C;
  float4* p0 = reinterpret_cast<float4*>(partial + at);
  float4* p1 = reinterpret_cast<float4*>(partial + set + at);
  p0[0] = make_float4(acc_shift[0], acc_shift[1], acc_shift[2], acc_shift[3]);
  p0[1] = make_float4(acc_shift[4], acc_shift[5], acc_shift[6], acc_shift[7]);
  p1[0] = make_float4(acc_scale[0], acc_scale[1], acc_scale[2], acc_scale[3]);
  p1[1] = make_float4(acc_scale[4], acc_scale[5], acc_scale[6], acc_scale[7]);
}

template <typename DyT, int NCH>
cudaError_t launch_nch(const bf16* x, long long sb, long long sl, const float* scale, long long s_scale, const DyT* dy,
                       bf16* dx, float* partial, int B, int L, int C, int ctas, cudaStream_t stream) {
  const size_t smem = OFF_RING + (size_t)STAGES * R * C * (2 + sizeof(DyT));  // at most 96.6 KB
  auto kern = ln_modulate_bwd_kernel<DyT, NCH>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(ctas, B), 32 * (NCH + 1), smem, stream>>>(x, sb, sl, scale, s_scale, dy, dx, partial, L, C);
  return cudaGetLastError();
}

// the chunk count rounded up to an instantiated one: 4, 8, 12 (the DiT's
// 3072 columns) or 16
template <typename DyT>
cudaError_t launch(const bf16* x, long long sb, long long sl, const float* scale, long long s_scale, const DyT* dy,
                   bf16* dx, float* partial, int B, int L, int C, int ctas, cudaStream_t stream) {
  const int nch = (C + 255) / 256;
  if (nch <= 4) return launch_nch<DyT, 4>(x, sb, sl, scale, s_scale, dy, dx, partial, B, L, C, ctas, stream);
  if (nch <= 8) return launch_nch<DyT, 8>(x, sb, sl, scale, s_scale, dy, dx, partial, B, L, C, ctas, stream);
  if (nch <= 12) return launch_nch<DyT, 12>(x, sb, sl, scale, s_scale, dy, dx, partial, B, L, C, ctas, stream);
  return launch_nch<DyT, 16>(x, sb, sl, scale, s_scale, dy, dx, partial, B, L, C, ctas, stream);
}

}  // namespace

// Kernel J'. x (B, L, C) bf16 at element strides sb (batch) and sl (row),
// its rows contiguous; scale fp32 rows of C at element stride s_scale a
// batch; dy (B, L, C) contiguous, bf16 (dy_bf16 = 1) or fp32; dx (B, L, C)
// bf16 contiguous or null (not wanted); `ctas` CTAs a batch element (1 to
// L), each a contiguous range of rows; partial (2, B, ctas, C) fp32
// scratch, dshift and dscale (B, C) fp32, all three null when the vectors'
// gradients are not wanted. Every row start and vector 16-byte aligned; C a
// multiple of 8, at most 4096. Launches on `stream` (the row pass, then the
// column sums); returns a cudaError_t (0 on success).
extern "C" int layernorm_modulate_bwd(const void* x, long long sb, long long sl, const void* scale, long long s_scale,
                                      const void* dy, int dy_bf16, void* dx, void* partial, void* dshift,
                                      void* dscale, int B, int L, int C, int ctas, void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % VEC || C > MAX_C || ctas <= 0 || ctas > L ||
      (partial == nullptr) != (dshift == nullptr) || (dshift == nullptr) != (dscale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sc = static_cast<const float*>(scale);
  float* part = static_cast<float*>(partial);
  bf16* dxp = static_cast<bf16*>(dx);
  cudaError_t err = dy_bf16 ? launch(xp, sb, sl, sc, s_scale, static_cast<const bf16*>(dy), dxp, part, B, L, C, ctas, s)
                            : launch(xp, sb, sl, sc, s_scale, static_cast<const float*>(dy), dxp, part, B, L, C, ctas, s);
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  return (int)vc::launch_column_sums(part, 2, B, ctas, C, static_cast<float*>(dshift), static_cast<float*>(dscale),
                                     s);
}
