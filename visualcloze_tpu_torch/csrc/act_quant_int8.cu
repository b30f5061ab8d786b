// Kernel I: the per-token int8 quantize of a w8a8 linear's input.
//
// Replaces the activation quantize of visualcloze_tpu/models/quant.py:
// act_quant_int8 (and the SmoothQuant divide of layers.linear's w8a8
// branch), which XLA fuses into one pass; there is no Pallas kernel.
//
//     xf = float(x[m, :]) (* a_sinv)        fp32
//     scale[m] = max(max_k |xf|, 1e-8) / 127
//     codes[m, k] = clamp(rint(xf / scale[m]), -127, 127)   int8
//
// x (M, K) fp32 or bf16, a_sinv (K,) fp32 or null. The division is the IEEE
// one (__fdiv_rn, no reciprocal), the rounding half to even
// (__float2int_rn) and the a_sinv product one fp32 multiply, as jnp does:
// the codes and scales equal the JAX package's and the plain version's bit
// for bit. A max is exact in any order, so two launches give the same bits.
//
// Bound on the H100 (3.35 TB/s): the bytes, M*K*(4 or 2) read, M*K int8 and
// M*4 written (M = 3968, K = 3072, fp32: 0.018 ms). One CTA of 256 threads a
// row, 8 elements a thread a step with 16-byte loads (K <= 15360: at most 8
// steps); the row is read twice, the second time from L1/L2, so the device
// memory sees it once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using vc::bf16;

constexpr int THREADS = 256;
constexpr int VEC = 8;  // elements a thread a step

__device__ __forceinline__ void load8(const float* x, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(x));
  const float4 b = __ldg(reinterpret_cast<const float4*>(x) + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* x, float* f) {
  vc::unpack8(__ldg(reinterpret_cast<const uint4*>(x)), f);
}

template <typename T>
__device__ __forceinline__ void load_scaled(const T* row, const float* a_sinv, int k, float* f) {
  load8(row + k, f);
  if (a_sinv != nullptr) {
    float s[8];
    load8(a_sinv + k, s);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = __fmul_rn(f[i], s[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) act_quant_kernel(const T* __restrict__ x, const float* __restrict__ a_sinv,
                                                            int8_t* __restrict__ codes, float* __restrict__ scale,
                                                            int K) {
  __shared__ float warp_max[THREADS / 32];
  const size_t m = blockIdx.x;
  const T* row = x + m * K;
  float amax = 0.0f;
  for (int k = threadIdx.x * VEC; k < K; k += THREADS * VEC) {
    float f[VEC];
    load_scaled(row, a_sinv, k, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (threadIdx.x == 0) scale[m] = s;

  int8_t* out = codes + m * K;
  for (int k = threadIdx.x * VEC; k < K; k += THREADS * VEC) {
    float f[VEC];
    load_scaled(row, a_sinv, k, f);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int q = min(127, max(-127, __float2int_rn(__fdiv_rn(f[i], s))));
      packed[i / 4] |= (uint32_t)(q & 0xff) << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(out + k) = make_uint2(packed[0], packed[1]);
  }
}

}  // namespace

// Kernel I. x (M, K) fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1), a_sinv (K,) fp32
// or null, codes (M, K) int8, scale (M,) fp32; all contiguous, x and a_sinv
// 16-byte aligned, codes 8-byte aligned; K a multiple of 8. Launches on
// `stream`; returns a cudaError_t (0 on success).
extern "C" int act_quant_int8(const void* x, const void* a_sinv, void* codes, void* scale, int M, int K, int x_bf16,
                              void* stream) {
  if (M <= 0 || K <= 0 || K % VEC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sinv = static_cast<const float*>(a_sinv);
  int8_t* c = static_cast<int8_t*>(codes);
  float* sc = static_cast<float*>(scale);
  if (x_bf16)
    act_quant_kernel<bf16><<<M, THREADS, 0, s>>>(static_cast<const bf16*>(x), sinv, c, sc, K);
  else
    act_quant_kernel<float><<<M, THREADS, 0, s>>>(static_cast<const float*>(x), sinv, c, sc, K);
  return (int)cudaGetLastError();
}
