// Kernel L: the head split of a DiT block's qkv projection with the q/k
// RMSNorm, written straight into attention's (B, H, L, D) buffers.
//
// Replaces an XLA fusion, not a Pallas kernel: visualcloze_tpu/models/
// layers.py `_split_heads` (:195) and `qk_norm` (:161) / `rms_norm` (:153),
// and the concatenation of the txt and img streams in `double_block`.
//
//     q[b, h, off + l, :] = bf16(float(bf16(x32 * rrms)) * float(q_scale)),
//       x32 = float(qkv[b, l, (0 * H + h) * D : ... + D]),
//       rrms = rsqrt(mean(x32^2) + 1e-6)                 (per token and head)
//     k likewise from the columns (1 * H + h) * D with k_scale;
//     v[b, h, off + l, :] = qkv[b, l, (2 * H + h) * D : ... + D]  (a copy)
//
// qkv is read through its strides: the single block reads the first 3 H D
// of linear1's 21504 columns, and under tensor parallelism H is this rank's
// heads. The double block writes its txt stream at token offset 0 and its
// img stream at offset 512 of one joint buffer, so no concatenation follows;
// the buffers are contiguous, as kernel A takes them. The two roundings of
// the plain version are kept (the normalized value to bf16, then the bf16
// product with the scale); the row sum runs in another order than
// PyTorch's, so q and k can differ from it by a bf16 ulp; v is copied bit
// for bit. Deterministic.
//
// Bound on the H100 (3.35 TB/s): the bytes. 3 H D columns of every token
// read once and written once: 146 MB for the single block at 3968 tokens
// (0.044 ms). A CTA a token and one of q, k, v; D / 8 threads a head, each
// with one 16-byte load, the head's sum of squares by shuffles inside its
// group of D / 8 lanes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_THREADS = 1024;

__global__ void __launch_bounds__(MAX_THREADS)
    qk_norm_split_kernel(const bf16* __restrict__ qkv, long long sb, long long sl, const bf16* __restrict__ q_scale,
                         const bf16* __restrict__ k_scale, bf16* __restrict__ q, bf16* __restrict__ k,
                         bf16* __restrict__ v, int L, int H, int D, int L_total, int offset) {
  const int row = blockIdx.x;
  const int b = row / L, l = row - b * L;
  const int part = blockIdx.y;  // 0: q, 1: k, 2: v (uniform over the CTA)
  const int lanes = D / VEC;
  const int h = threadIdx.x / lanes;
  const int d = (threadIdx.x - h * lanes) * VEC;
  const bool on = h < H;  // the CTA is rounded up to whole warps
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (on) u = __ldg(reinterpret_cast<const uint4*>(qkv + b * sb + l * sl + (size_t)(part * H + h) * D + d));
  bf16* dst = (part == 0 ? q : part == 1 ? k : v) + (((size_t)b * H + h) * L_total + offset + l) * D + d;
  if (part == 2) {
    if (on) *reinterpret_cast<uint4*>(dst) = u;
    return;
  }
  float f[VEC];
  vc::unpack8(u, f);
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) ss = __fmaf_rn(f[i], f[i], ss);
  for (int o = lanes >> 1; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);  // inside the head's lanes
  if (!on) return;
  const float rrms = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)D), 1e-6f));
  float s[VEC];
  vc::unpack8(__ldg(reinterpret_cast<const uint4*>((part == 0 ? q_scale : k_scale) + d)), s);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float t = __bfloat162float(__float2bfloat16_rn(__fmul_rn(f[i], rrms)));
    f[i] = __fmul_rn(t, s[i]);
  }
  *reinterpret_cast<uint4*>(dst) = vc::pack8(f);
}

}  // namespace

// Kernel L. qkv (B, L, >= 3 H D) bf16 at element strides sb (batch) and sl
// (token), its feature axis contiguous; q_scale, k_scale (D,) bf16; q, k, v
// (B, H, L_total, D) bf16 contiguous, written at tokens [offset, offset + L).
// D / 8 a power of two of at most 32, H * D / 8 at most 1024; every row
// start and the scales 16-byte aligned. Launches on `stream`; returns a
// cudaError_t (0 on success).
extern "C" int qk_norm_split(const void* qkv, long long sb, long long sl, const void* q_scale, const void* k_scale,
                             void* q, void* k, void* v, int B, int L, int H, int D, int L_total, int offset,
                             void* stream) {
  const int lanes = D / VEC;
  if (B <= 0 || L <= 0 || H <= 0 || D % VEC || lanes > 32 || (lanes & (lanes - 1)) || H * lanes > MAX_THREADS ||
      offset < 0 || offset + L > L_total)
    return (int)cudaErrorInvalidValue;
  const int threads = ((H * lanes + 31) / 32) * 32;
  qk_norm_split_kernel<<<dim3(B * L, 3), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), sb, sl, static_cast<const bf16*>(q_scale), static_cast<const bf16*>(k_scale),
      static_cast<bf16*>(q), static_cast<bf16*>(k), static_cast<bf16*>(v), L, H, D, L_total, offset);
  return (int)cudaGetLastError();
}
