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
// x (M, K) fp32 or bf16, a_sinv (K,) fp32 or null. The arithmetic is
// act_quant.cuh's (IEEE quotients, round half to even), which J, M and O
// share where they write the codes of their own output: the codes and scales
// equal the JAX package's and the plain version's bit for bit, and two
// launches give the same bits.
//
// Bound on the H100 (3.35 TB/s): the bytes, M*K*(4 or 2) read, M*K int8 and
// M*4 written (M = 3968, K = 3072, fp32: 0.018 ms). One CTA of 256 threads a
// row, 8 elements a thread a step with 16-byte loads (K <= 15360: at most 8
// steps); the row is read twice, the second time from L1/L2, so the device
// memory sees it once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
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
__global__ void __launch_bounds__(THREADS) act_quant_kernel(const T* __restrict__ x, const float* __restrict__ a_sinv,
                                                            int8_t* __restrict__ codes, float* __restrict__ scale,
                                                            int K) {
  __shared__ float partial[THREADS / 32];
  const size_t m = blockIdx.x;
  const T* row = x + m * K;
  float amax = 0.0f;
  for (int k = threadIdx.x * VEC; k < K; k += THREADS * VEC) {
    float f[VEC];
    load8(row + k, f);
    vc::smooth8(f, a_sinv, k);
    amax = vc::absmax8(f, amax);
  }
  const float s = vc::quant_scale(vc::block_max(amax, partial));
  const float r = vc::quant_rcp(s);
  if (threadIdx.x == 0) scale[m] = s;

  int8_t* out = codes + m * K;
  for (int k = threadIdx.x * VEC; k < K; k += THREADS * VEC) {
    float f[VEC];
    load8(row + k, f);
    vc::smooth8(f, a_sinv, k);
    *reinterpret_cast<uint2*>(out + k) = vc::quant8(f, s, r);
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
