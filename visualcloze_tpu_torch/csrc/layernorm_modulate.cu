// Kernel J: the affine-free LayerNorm of a DiT block's input with the adaLN
// modulate, in one pass.
//
// Replaces an XLA fusion, not a Pallas kernel: visualcloze_tpu/models/
// layers.py `layer_norm` (:145) followed by `(1 + scale) * x + shift` in
// `double_block` (:247, :273), `single_block` (:330) and `last_layer`.
//
//     x32 = float(x[b, l, :]);  mu = mean(x32);  var = mean((x32 - mu)^2)
//     n = (x32 - mu) * rsqrt(var + 1e-6)
//     y[b, l, c] = (1 + scale[b, c]) * n + shift[b, c]       (fp32)
//
// stored as bf16 (round to nearest even) or fp32: bf16 where a cast to bf16
// follows (a dense, int8 or int4 linear, or the single block's .to(x.dtype)),
// fp32 where a w8a8 linear quantizes the fp32 value. The variance is JAX's
// two-pass formula; the modulate rounds after each of its three operations,
// as the plain version's separate PyTorch ops do (no contraction into an
// FMA). The row sums run in another order than PyTorch's, so a bf16 output
// can differ by one ulp; the order is fixed, so two launches give the same
// bits.
//
// Bound on the H100 (3.35 TB/s): the bytes. A (3968, 3072) bf16 x read once
// (24.4 MB), the output written once (24.4 MB bf16, 48.8 MB fp32) and the
// (B, C) fp32 vectors: 0.015 ms bf16, 0.022 ms fp32. One CTA a row, C / 8
// threads (384 at C = 3072), each holding its 8 elements in registers from
// one 16-byte load, so x is read from device memory exactly once; two block
// sums (warp shuffles, then the warps' partials summed by every thread in
// one order).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;        // elements a thread
constexpr int MAX_THREADS = 1024;

// the sum of v over the CTA, the same bits in every thread
__device__ __forceinline__ float block_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) s += partial[w];
  __syncthreads();  // partial is reused by the next sum
  return s;
}

__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* y, const float* f) { *reinterpret_cast<uint4*>(y) = vc::pack8(f); }
__device__ __forceinline__ void store8(float* y, const float* f) {
  reinterpret_cast<float4*>(y)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename OutT>
__global__ void __launch_bounds__(MAX_THREADS)
    ln_modulate_kernel(const bf16* __restrict__ x, long long sb, long long sl, const float* __restrict__ scale,
                       long long s_scale, const float* __restrict__ shift, long long s_shift, OutT* __restrict__ y,
                       int L, int C) {
  __shared__ float partial[MAX_THREADS / 32];
  const int row = blockIdx.x;
  const int b = row / L, l = row - b * L;
  const int c = threadIdx.x * VEC;
  const bool on = c < C;
  float f[VEC];
  if (on) {
    vc::unpack8(__ldg(reinterpret_cast<const uint4*>(x + b * sb + l * sl + c)), f);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = 0.0f;
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s += f[i];
  const float mu = __fdiv_rn(block_sum(s, partial), (float)C);
  float d2 = 0.0f;
  if (on) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = __fsub_rn(f[i], mu);
      d2 = __fmaf_rn(d, d, d2);
    }
  }
  const float var = __fdiv_rn(block_sum(d2, partial), (float)C);
  const float r = rsqrtf(__fadd_rn(var, 1e-6f));
  if (!on) return;
  float sc[VEC], sh[VEC];
  load8f(scale + b * s_scale + c, sc);
  load8f(shift + b * s_shift + c, sh);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float n = __fmul_rn(__fsub_rn(f[i], mu), r);
    f[i] = __fadd_rn(__fmul_rn(__fadd_rn(1.0f, sc[i]), n), sh[i]);
  }
  store8(y + (size_t)row * C + c, f);
}

}  // namespace

// Kernel J. x (B, L, C) bf16 with element strides sb (batch) and sl (row),
// its rows contiguous; scale and shift fp32 rows of C at element strides
// s_scale and s_shift a batch; y (B, L, C) contiguous, bf16 (y_bf16 = 1) or
// fp32. Every row start and both vectors 16-byte aligned; C a multiple of 8,
// at most 8192. Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int layernorm_modulate(const void* x, long long sb, long long sl, const void* scale, long long s_scale,
                                  const void* shift, long long s_shift, void* y, int B, int L, int C, int y_bf16,
                                  void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % VEC || C > VEC * MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int threads = ((C / VEC + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (y_bf16)
    ln_modulate_kernel<bf16><<<B * L, threads, 0, s>>>(xp, sb, sl, sc, s_scale, sh, s_shift,
                                                       static_cast<bf16*>(y), L, C);
  else
    ln_modulate_kernel<float><<<B * L, threads, 0, s>>>(xp, sb, sl, sc, s_scale, sh, s_shift,
                                                        static_cast<float*>(y), L, C);
  return (int)cudaGetLastError();
}
