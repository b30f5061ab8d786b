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
// With RoPE tables (cos, sin: (B or 1, L_total, D / 2) fp32, row offset +
// l), q and k are then rotated as `rope_qk` (visualcloze_tpu/ops/
// attention.py:117, rope.py:90 `apply_rope` and `apply_rope_half`) rotates
// them, which XLA fuses into this chain: the bf16 value above, in fp32,
//     e' = cos * e - sin * o,   o' = sin * e + cos * o,
// each product and the sum rounded separately (__fmul_rn, __fsub_rn,
// __fadd_rn: nothing contracts into an FMA, as PyTorch's elementwise passes
// round), then one rounding to bf16. The interleaved layout (the trainer's)
// pairs columns (2i, 2i + 1), inside one thread's 8; the half layout pairs
// column i with i + D / 2, which lies in the lane D / 16 away in the head's
// group: a shuffle of the bf16 row brings it. Every route but kernel A's
// (which rotates inside itself) rotates here, so no rotated copy of q and
// k crosses device memory again.
//
// Bound on the H100 (3.35 TB/s): the bytes. 3 H D columns of every token
// read once and written once: 146 MB for the single block at 3968 tokens
// (0.044 ms), plus the tables' L D * 4 bytes (2 MB) when rotating. A CTA a
// token and one of q, k, v; D / 8 threads a head, each with one 16-byte
// load, the head's sum of squares by shuffles inside its group of D / 8
// lanes; every head of a CTA reads the same table row (from L1 after the
// first).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_THREADS = 1024;
constexpr int ROPE_NONE = 0, ROPE_INTERLEAVED = 1, ROPE_HALF = 2;

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// 8 fp32 table values from t (16-byte aligned)
__device__ __forceinline__ void load8f(const float* t, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(t)), b = __ldg(reinterpret_cast<const float4*>(t) + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__global__ void __launch_bounds__(MAX_THREADS)
    qk_norm_split_kernel(const bf16* __restrict__ qkv, long long sb, long long sl, const bf16* __restrict__ q_scale,
                         const bf16* __restrict__ k_scale, bf16* __restrict__ q, bf16* __restrict__ k,
                         bf16* __restrict__ v, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                         long long tb, int rope, int L, int H, int D, int L_total, int offset) {
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
  if (!on && rope != ROPE_HALF) return;  // the half layout's shuffle below wants every lane of the warp
  const float rrms = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)D), 1e-6f));
  float s[VEC];
  vc::unpack8(__ldg(reinterpret_cast<const uint4*>((part == 0 ? q_scale : k_scale) + d)), s);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float t = round_bf16(__fmul_rn(f[i], rrms));
    f[i] = __fmul_rn(t, s[i]);
  }
  if (rope != ROPE_NONE) {
    // the rotation reads the bf16 q / k row; table row offset + l
    const float* tc = cos_t + b * tb + (size_t)(offset + l) * (D / 2);
    const float* ts = sin_t + b * tb + (size_t)(offset + l) * (D / 2);
    float r[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[i] = round_bf16(f[i]);
    if (rope == ROPE_INTERLEAVED) {  // pairs (d + 2p, d + 2p + 1), table column d / 2 + p
      const float4 c4 = __ldg(reinterpret_cast<const float4*>(tc + d / 2));
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(ts + d / 2));
      const float c[4] = {c4.x, c4.y, c4.z, c4.w}, sn[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int p = 0; p < VEC / 2; ++p) {
        const float e = r[2 * p], o = r[2 * p + 1];
        f[2 * p] = __fsub_rn(__fmul_rn(c[p], e), __fmul_rn(sn[p], o));
        f[2 * p + 1] = __fadd_rn(__fmul_rn(sn[p], e), __fmul_rn(c[p], o));
      }
    } else {  // half: column i pairs with i + D / 2, the lane lanes / 2 away (whole heads share a warp)
      const uint4 mine = vc::pack8(r);
      uint4 theirs;
      theirs.x = __shfl_xor_sync(0xffffffffu, mine.x, lanes >> 1);
      theirs.y = __shfl_xor_sync(0xffffffffu, mine.y, lanes >> 1);
      theirs.z = __shfl_xor_sync(0xffffffffu, mine.z, lanes >> 1);
      theirs.w = __shfl_xor_sync(0xffffffffu, mine.w, lanes >> 1);
      if (!on) return;
      float pr[VEC], c[VEC], sn[VEC];
      vc::unpack8(theirs, pr);
      const bool even = d < D / 2;  // this lane holds the pair-even half
      load8f(tc + (even ? d : d - D / 2), c);
      load8f(ts + (even ? d : d - D / 2), sn);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        f[i] = even ? __fsub_rn(__fmul_rn(c[i], r[i]), __fmul_rn(sn[i], pr[i]))
                    : __fadd_rn(__fmul_rn(sn[i], pr[i]), __fmul_rn(c[i], r[i]));
    }
  }
  *reinterpret_cast<uint4*>(dst) = vc::pack8(f);
}

}  // namespace

// Kernel L. qkv (B, L, >= 3 H D) bf16 at element strides sb (batch) and sl
// (token), its feature axis contiguous; q_scale, k_scale (D,) bf16; q, k, v
// (B, H, L_total, D) bf16 contiguous, written at tokens [offset, offset + L);
// rope 0 (no rotation; cos_t, sin_t null), 1 (interleaved) or 2 (half),
// with cos_t, sin_t (B, L_total, D / 2) fp32, their rows contiguous, tb elements
// from one batch element to the next (0: one table for every element).
// D / 8 a power of two of at most 32 (at least 2 for the half layout), H *
// D / 8 at most 1024; every row start, the scales and the tables 16-byte
// aligned. Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int qk_norm_split(const void* qkv, long long sb, long long sl, const void* q_scale, const void* k_scale,
                             void* q, void* k, void* v, const void* cos_t, const void* sin_t, long long tb, int rope,
                             int B, int L, int H, int D, int L_total, int offset, void* stream) {
  const int lanes = D / VEC;
  if (B <= 0 || L <= 0 || H <= 0 || D % VEC || lanes > 32 || (lanes & (lanes - 1)) || H * lanes > MAX_THREADS ||
      offset < 0 || offset + L > L_total || rope < ROPE_NONE || rope > ROPE_HALF ||
      (rope != ROPE_NONE && (cos_t == nullptr || sin_t == nullptr)) || (rope == ROPE_HALF && lanes < 2))
    return (int)cudaErrorInvalidValue;
  const int threads = ((H * lanes + 31) / 32) * 32;
  qk_norm_split_kernel<<<dim3(B * L, 3), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), sb, sl, static_cast<const bf16*>(q_scale), static_cast<const bf16*>(k_scale),
      static_cast<bf16*>(q), static_cast<bf16*>(k), static_cast<bf16*>(v), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), tb, rope, L, H, D, L_total, offset);
  return (int)cudaGetLastError();
}
