// Kernel L': the backward of kernel L (head split + q/k RMSNorm).
//
// Replaces an XLA fusion, not a Pallas kernel: the transpose, under
// jax.grad, of visualcloze_tpu/models/layers.py `_split_heads` (:195) and
// `qk_norm` (:161) / `rms_norm` (:153), and of the double block's
// concatenation of its txt and img streams.
//
// For q (k likewise, with k_scale), per token and head, x32 the raw q row of
// qkv (re-read, not saved) and dq's row at token offset + l:
//     rrms = rsqrt(mean(x32^2) + 1e-6);  n = x32 * rrms         (as kernel L)
//     dn = float(bf16(dq * float(q_scale)))   (rms_norm's bf16 multiply)
//     dqkv[b, l, (0 * H + h) * D + d] = bf16(rrms * (dn - n * mean(dn * n)))
//     dq_scale[d] = sum over b, h, l of float(dq) * float(bf16(n))     (fp32)
//     dqkv[b, l, (2 * H + h) * D + d] = dv[b, h, offset + l, d]          (a copy)
//
// dqkv is written in _split_heads' feature order (k, h, d) through its
// strides: the single block's gradient buffer of linear1's whole output
// (21504 columns), whose last columns kernel M' fills. The scales' sums run
// over B, H and L: a CTA sums its tokens in registers, then its heads in
// order through shared memory, into one fp32 partial; a second pass
// (colsum.cuh) adds the partials in a fixed order. Deterministic.
//
// Bound on the H100 (3.35 TB/s): the bytes. dq, dk, dv read once at the
// stream's tokens, the raw q and k read once, dqkv written once: 195 MB
// for the single block at 3968 tokens (0.058 ms). A CTA takes `rows`
// consecutive tokens of one batch element and one of q, k, v; D / 8
// threads a head, one 16-byte load each of the raw row and its gradient,
// the head's two sums by shuffles inside its D / 8 lanes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "colsum.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_THREADS = 512;  // H * D up to 4096; 128 registers a thread

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__global__ void __launch_bounds__(MAX_THREADS)
    qk_norm_split_bwd_kernel(const bf16* __restrict__ qkv, long long sb, long long sl,
                             const bf16* __restrict__ q_scale, const bf16* __restrict__ k_scale,
                             const bf16* __restrict__ dq, const bf16* __restrict__ dk, const bf16* __restrict__ dv,
                             bf16* __restrict__ dqkv, long long ob, long long ol, float* __restrict__ partial, int L,
                             int H, int D, int L_total, int offset, int rows) {
  __shared__ float red[MAX_THREADS * VEC];  // (H, D) of the CTA's scale sums
  const int part = blockIdx.y;              // 0: q, 1: k, 2: v (uniform over the CTA)
  const int b = blockIdx.z;
  const int l0 = blockIdx.x * rows;
  const int l1 = min(L, l0 + rows);
  const int lanes = D / VEC;
  const int h = threadIdx.x / lanes;
  const int d = (threadIdx.x - h * lanes) * VEC;
  const bool on = h < H;  // the CTA is rounded up to whole warps
  const bf16* grad = (part == 0 ? dq : part == 1 ? dk : dv) + (((size_t)b * H + h) * L_total + offset) * D + d;
  bf16* dst = dqkv + b * ob + (size_t)(part * H + h) * D + d;
  if (part == 2) {
    if (!on) return;
    for (int l = l0; l < l1; ++l)
      *reinterpret_cast<uint4*>(dst + l * ol) = __ldg(reinterpret_cast<const uint4*>(grad + (size_t)l * D));
    return;
  }
  const bf16* src = qkv + b * sb + (size_t)(part * H + h) * D + d;
  float s[VEC], acc[VEC];
  uint4 su = make_uint4(0u, 0u, 0u, 0u);
  if (on) su = __ldg(reinterpret_cast<const uint4*>((part == 0 ? q_scale : k_scale) + d));
  vc::unpack8(su, s);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  for (int l = l0; l < l1; ++l) {
    uint4 xu = make_uint4(0u, 0u, 0u, 0u), gu = xu;
    if (on) {
      xu = __ldg(reinterpret_cast<const uint4*>(src + l * sl));
      gu = __ldg(reinterpret_cast<const uint4*>(grad + (size_t)l * D));
    }
    float f[VEC], g[VEC];
    vc::unpack8(xu, f);
    vc::unpack8(gu, g);
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) ss = __fmaf_rn(f[i], f[i], ss);
    for (int o = lanes >> 1; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);  // inside the head's lanes
    const float rrms = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)D), 1e-6f));
    float n[VEC], dn[VEC];
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      n[i] = __fmul_rn(f[i], rrms);
      dn[i] = round_bf16(__fmul_rn(g[i], s[i]));
      dot = __fmaf_rn(dn[i], n[i], dot);
      acc[i] = __fmaf_rn(g[i], round_bf16(n[i]), acc[i]);
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (!on) continue;
    const float mdot = __fdiv_rn(dot, (float)D);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = __fmul_rn(rrms, __fsub_rn(dn[i], __fmul_rn(n[i], mdot)));
    *reinterpret_cast<uint4*>(dst + l * ol) = vc::pack8(f);
  }
  if (partial == nullptr) return;
  if (on) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[h * D + d + i] = acc[i];
  }
  __syncthreads();
  // partial (2, B * chunks, D): the CTA's heads summed in order
  float* p = partial + (((size_t)part * gridDim.z + b) * gridDim.x + blockIdx.x) * D;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    float t = 0.0f;
    for (int hh = 0; hh < H; ++hh) t += red[hh * D + j];
    p[j] = t;
  }
}

}  // namespace

// Kernel L'. qkv (B, L, >= 3 H D) bf16 at element strides sb (batch) and sl
// (token), its feature axis contiguous (kernel L's input); q_scale, k_scale
// (D,) bf16; dq, dk, dv (B, H, L_total, D) bf16 contiguous, read at tokens
// [offset, offset + L); dqkv (B, L, >= 3 H D) bf16 at element strides ob,
// ol, its feature axis contiguous, written in columns [0, 3 H D); partial
// (2, B * ceil(L / rows), D) fp32 scratch and dscales (2, D) fp32 (q's sums,
// then k's), both null when the scales' gradients are not wanted. D / 8 a
// power of two of at most 32, H * D / 8 at most 512; every row start and the
// scales 16-byte aligned. Launches on `stream` (the token pass, then the
// column sums); returns a cudaError_t (0 on success).
extern "C" int qk_norm_split_bwd(const void* qkv, long long sb, long long sl, const void* q_scale,
                                 const void* k_scale, const void* dq, const void* dk, const void* dv, void* dqkv,
                                 long long ob, long long ol, void* partial, void* dscales, int B, int L, int H, int D,
                                 int L_total, int offset, int rows, void* stream) {
  const int lanes = D / VEC;
  if (B <= 0 || L <= 0 || H <= 0 || D % VEC || lanes > 32 || (lanes & (lanes - 1)) || H * lanes > MAX_THREADS ||
      offset < 0 || offset + L > L_total || rows <= 0 || (partial == nullptr) != (dscales == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = ((H * lanes + 31) / 32) * 32;
  const int chunks = (L + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  qk_norm_split_bwd_kernel<<<dim3(chunks, 3, B), threads, 0, s>>>(
      static_cast<const bf16*>(qkv), sb, sl, static_cast<const bf16*>(q_scale), static_cast<const bf16*>(k_scale),
      static_cast<const bf16*>(dq), static_cast<const bf16*>(dk), static_cast<const bf16*>(dv),
      static_cast<bf16*>(dqkv), ob, ol, part, L, H, D, L_total, offset, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  float* out = static_cast<float*>(dscales);
  return (int)vc::launch_column_sums(part, 2, 1, B * chunks, D, out, out + D, s);
}
