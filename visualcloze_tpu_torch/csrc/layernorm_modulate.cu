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
// fp32 where a w8a8 linear quantizes the fp32 value itself (kernel I: under a
// LoRA entry, a tp shard or autograd). On the fused w8a8 route the
// quantized variant (`layernorm_modulate_quant`) writes the consumer
// linear's int8 codes and row scale instead, kernel I folded in: y (fp32, or
// rounded to bf16 first where JAX casts it: the single block's linear1)
// times a_sinv, then act_quant.cuh's quantize over the row held in
// registers: the codes and scales of kernel I applied to J's own output,
// bit for bit. The variance is JAX's
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
// one order), and for the codes a block max. Quantized, (3968, 3072): x read,
// M * C int8 and M * 4 written (36.6 MB, 0.011 ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
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

__device__ __forceinline__ void store8(bf16* y, const float* f) { *reinterpret_cast<uint4*>(y) = vc::pack8(f); }
__device__ __forceinline__ void store8(float* y, const float* f) {
  reinterpret_cast<float4*>(y)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The modulated row's 8 values of this thread into f (zeros past C, where it
// returns false): every thread of the CTA takes part in the two block sums.
__device__ __forceinline__ bool modulate8(const bf16* __restrict__ x, long long sb, long long sl,
                                         const float* __restrict__ scale, long long s_scale,
                                         const float* __restrict__ shift, long long s_shift, int L, int C,
                                         float* partial, float* f) {
  const int row = blockIdx.x;
  const int b = row / L, l = row - b * L;
  const int c = threadIdx.x * VEC;
  const bool on = c < C;
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
  if (!on) return false;
  const float4* sc = reinterpret_cast<const float4*>(scale + b * s_scale + c);
  const float4* sh = reinterpret_cast<const float4*>(shift + b * s_shift + c);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // four columns at a time: fewer values live at once
    const float4 s4 = __ldg(sc + h), t4 = __ldg(sh + h);
    const float scs[4] = {s4.x, s4.y, s4.z, s4.w}, shs[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float& v = f[4 * h + j];
      const float n = __fmul_rn(__fsub_rn(v, mu), r);
      v = __fadd_rn(__fmul_rn(__fadd_rn(1.0f, scs[j]), n), shs[j]);
    }
  }
  return true;
}

template <typename OutT>
__global__ void __launch_bounds__(MAX_THREADS)
    ln_modulate_kernel(const bf16* __restrict__ x, long long sb, long long sl, const float* __restrict__ scale,
                       long long s_scale, const float* __restrict__ shift, long long s_shift, OutT* __restrict__ y,
                       int L, int C) {
  __shared__ float partial[MAX_THREADS / 32];
  float f[VEC];
  if (!modulate8(x, sb, sl, scale, s_scale, shift, s_shift, L, C, partial, f)) return;
  store8(y + (size_t)blockIdx.x * C + threadIdx.x * VEC, f);
}

// The same row, (rounded to bf16 where RoundBf16,) times a_sinv, quantized:
// codes[row, :] int8 and xscale[row] fp32.
template <bool RoundBf16>
__global__ void __launch_bounds__(MAX_THREADS, 1)  // with the 1, ptxas keeps the row in registers unspilled
    ln_modulate_quant_kernel(const bf16* __restrict__ x, long long sb, long long sl, const float* __restrict__ scale,
                             long long s_scale, const float* __restrict__ shift, long long s_shift,
                             const float* __restrict__ a_sinv, int8_t* __restrict__ codes, float* __restrict__ xscale,
                             int L, int C) {
  __shared__ float partial[MAX_THREADS / 32];
  float f[VEC];
  const int c = threadIdx.x * VEC;
  const bool on = modulate8(x, sb, sl, scale, s_scale, shift, s_shift, L, C, partial, f);
  if (on) {
    if (RoundBf16) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = __bfloat162float(__float2bfloat16_rn(f[i]));
    }
    vc::smooth8(f, a_sinv, c);
  }
  const float s = vc::quant_scale(vc::block_max(vc::absmax8(f, 0.0f), partial));
  const float r = vc::quant_rcp(s);
  if (threadIdx.x == 0) xscale[blockIdx.x] = s;
  if (on) *reinterpret_cast<uint2*>(codes + (size_t)blockIdx.x * C + c) = vc::quant8(f, s, r);
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

// Kernel J with the quantize: x, scale, shift as layernorm_modulate; a_sinv
// (C,) fp32 16-byte aligned or null; codes (B * L, C) int8 and xscale
// (B * L,) fp32 contiguous, codes 8-byte aligned; round_bf16: the value is
// rounded to bf16 before a_sinv. Launches on `stream`; returns a cudaError_t
// (0 on success).
extern "C" int layernorm_modulate_quant(const void* x, long long sb, long long sl, const void* scale,
                                        long long s_scale, const void* shift, long long s_shift, const void* a_sinv,
                                        void* codes, void* xscale, int B, int L, int C, int round_bf16,
                                        void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % VEC || C > VEC * MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int threads = ((C / VEC + 31) / 32) * 32;
  auto kernel = round_bf16 ? ln_modulate_quant_kernel<true> : ln_modulate_quant_kernel<false>;
  kernel<<<B * L, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), sb, sl, static_cast<const float*>(scale), s_scale,
      static_cast<const float*>(shift), s_shift, static_cast<const float*>(a_sinv), static_cast<int8_t*>(codes),
      static_cast<float*>(xscale), L, C);
  return (int)cudaGetLastError();
}
