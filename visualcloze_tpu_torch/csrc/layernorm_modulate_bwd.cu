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
// mean and rstd are recomputed from the row rather than saved. The column
// sums run over thousands of tokens: each CTA keeps its rows' sums in
// registers (a thread owns 8 columns) and writes them as one fp32 partial;
// a second pass (colsum.cuh) adds the partials in a fixed order, so the
// result has the same bits at every launch.
//
// Bound on the H100 (3.35 TB/s): the bytes. x and dy read once, dx written
// once: 73.1 MB at (3968, 3072) bf16 (0.022 ms), plus the (B, C) vectors.
// A CTA takes `rows` consecutive rows of one batch element (about two CTAs
// an SM), C / 8 threads, 16-byte loads; the next row's x and dy are loaded
// before the current row's three block sums, so a row's loads overlap the
// previous row's reductions. The partials (rows / 16 of the traffic at
// 3968 tokens) stay in L2 for the second pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "colsum.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_THREADS = 512;  // C up to 4096; 128 registers a thread hold the row state without spills

// the sums of a and b over the CTA, the same bits in every thread; as kernel
// J's block_sum for each of them (warp shuffles, then the warps in order).
// red is one of two buffers the caller alternates between consecutive
// calls: a thread writes a buffer only after every thread passed the
// previous call's barrier, so its reads of that buffer two calls back are
// done, and one barrier a sum is enough.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.0f, 0.0f);
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) {
    s.x += red[w].x;
    s.y += red[w].y;
  }
  return s;
}

// 8 elements in flight: loaded now, converted when used
template <typename T>
struct Raw8;
template <>
struct Raw8<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) { u = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void get(float* f) const { vc::unpack8(u, f); }
};
template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
};

template <typename DyT>
__global__ void __launch_bounds__(MAX_THREADS)
    ln_modulate_bwd_kernel(const bf16* __restrict__ x, long long sb, long long sl, const float* __restrict__ scale,
                           long long s_scale, const DyT* __restrict__ dy, bf16* __restrict__ dx,
                           float* __restrict__ partial, int L, int C, int rows) {
  __shared__ float2 red[2][MAX_THREADS / 32];  // block_sum2's two alternating buffers
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * rows;
  const int l1 = min(L, l0 + rows);
  const int c = threadIdx.x * VEC;
  const bool on = c < C;
  float sc1[VEC], acc_shift[VEC], acc_scale[VEC];
  Raw8<float> sraw;
  if (on) sraw.load(scale + b * s_scale + c);
  sraw.get(sc1);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sc1[i] = on ? __fadd_rn(1.0f, sc1[i]) : 0.0f;
    acc_shift[i] = 0.0f;
    acc_scale[i] = 0.0f;
  }
  const bf16* xb = x + b * sb + c;
  const DyT* dyb = dy + (size_t)b * L * C + c;
  Raw8<bf16> xr;
  Raw8<DyT> dr;
  if (on) {
    xr.load(xb + l0 * sl);
    dr.load(dyb + (size_t)l0 * C);
  }
  for (int l = l0; l < l1; ++l) {
    float f[VEC], g[VEC];
    xr.get(f);
    dr.get(g);
    if (!on) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = g[i] = 0.0f;
    } else if (l + 1 < l1) {
      xr.load(xb + (l + 1) * sl);
      dr.load(dyb + (size_t)(l + 1) * C);
    }
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += f[i];
    // three sums a row, on buffers 0, 1, 0 and (the next row) 1, 0, 1: alternating across rows too
    const int buf = (l - l0) & 1;
    const float mu = __fdiv_rn(block_sum2(s, 0.0f, red[buf]).x, (float)C);
    float d2 = 0.0f;
    if (on) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = __fsub_rn(f[i], mu);
        d2 = __fmaf_rn(d, d, d2);
      }
    }
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(block_sum2(d2, 0.0f, red[buf ^ 1]).x, (float)C), 1e-6f));
    float n[VEC], gs[VEC];
    float sg = 0.0f, sgn = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      n[i] = on ? __fmul_rn(__fsub_rn(f[i], mu), r) : 0.0f;
      gs[i] = __fmul_rn(g[i], sc1[i]);
      sg += gs[i];
      sgn = __fmaf_rn(gs[i], n[i], sgn);
      acc_shift[i] += g[i];
      acc_scale[i] = __fmaf_rn(g[i], n[i], acc_scale[i]);
    }
    const float2 t = block_sum2(sg, sgn, red[buf]);
    if (on && dx != nullptr) {
      const float mg = __fdiv_rn(t.x, (float)C), mgn = __fdiv_rn(t.y, (float)C);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = __fmul_rn(r, __fsub_rn(__fsub_rn(gs[i], mg), __fmul_rn(n[i], mgn)));
      *reinterpret_cast<uint4*>(dx + ((size_t)b * L + l) * C + c) = vc::pack8(f);
    }
  }
  if (partial == nullptr || !on) return;
  // partial (2, B, chunks, C): set 0 dshift, set 1 dscale
  const size_t at = ((size_t)b * gridDim.x + blockIdx.x) * C + c;
  const size_t set = (size_t)gridDim.y * gridDim.x * C;
  float4* p0 = reinterpret_cast<float4*>(partial + at);
  float4* p1 = reinterpret_cast<float4*>(partial + set + at);
  p0[0] = make_float4(acc_shift[0], acc_shift[1], acc_shift[2], acc_shift[3]);
  p0[1] = make_float4(acc_shift[4], acc_shift[5], acc_shift[6], acc_shift[7]);
  p1[0] = make_float4(acc_scale[0], acc_scale[1], acc_scale[2], acc_scale[3]);
  p1[1] = make_float4(acc_scale[4], acc_scale[5], acc_scale[6], acc_scale[7]);
}

}  // namespace

// Kernel J'. x (B, L, C) bf16 at element strides sb (batch) and sl (row),
// its rows contiguous; scale fp32 rows of C at element stride s_scale a
// batch; dy (B, L, C) contiguous, bf16 (dy_bf16 = 1) or fp32; dx (B, L, C)
// bf16 contiguous or null (not wanted); partial (2, B, ceil(L / rows), C)
// fp32 scratch, dshift and dscale (B, C) fp32, all three null when the
// vectors' gradients are not wanted. Every row start and vector 16-byte
// aligned; C a multiple of 8, at most 4096. Launches on `stream` (the row
// pass, then the column sums); returns a cudaError_t (0 on success).
extern "C" int layernorm_modulate_bwd(const void* x, long long sb, long long sl, const void* scale, long long s_scale,
                                      const void* dy, int dy_bf16, void* dx, void* partial, void* dshift,
                                      void* dscale, int B, int L, int C, int rows, void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % VEC || C > VEC * MAX_THREADS || rows <= 0 ||
      (partial == nullptr) != (dshift == nullptr) || (dshift == nullptr) != (dscale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = ((C / VEC + 31) / 32) * 32;
  const int chunks = (L + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, B);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sc = static_cast<const float*>(scale);
  float* part = static_cast<float*>(partial);
  if (dy_bf16)
    ln_modulate_bwd_kernel<bf16><<<grid, threads, 0, s>>>(xp, sb, sl, sc, s_scale, static_cast<const bf16*>(dy),
                                                          static_cast<bf16*>(dx), part, L, C, rows);
  else
    ln_modulate_bwd_kernel<float><<<grid, threads, 0, s>>>(xp, sb, sl, sc, s_scale, static_cast<const float*>(dy),
                                                           static_cast<bf16*>(dx), part, L, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  return (int)vc::launch_column_sums(part, 2, B, chunks, C, static_cast<float*>(dshift), static_cast<float*>(dscale),
                                     s);
}
