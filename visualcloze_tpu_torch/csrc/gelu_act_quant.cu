// Kernel O: gelu(tanh) of the double blocks' mlp.0 output with the int8
// quantize of mlp.2's input, in one pass.
//
// Replaces an XLA fusion, not a Pallas kernel: `jax.nn.gelu(h,
// approximate=True)` in visualcloze_tpu/models/layers.py `double_block`
// (:276) followed by linear's w8a8 branch on the result (the SmoothQuant
// divide and models/quant.py `act_quant_int8` :181), which XLA fuses.
//
//     g = bf16(gelu_tanh(float(h[m, k])))            gelu.cuh, as kernel M
//     xf = float(g) (* a_sinv[k]);  scale[m] = max(max_k |xf|, 1e-8) / 127
//     codes[m, k] = clamp(rint(xf / scale[m]), -127, 127)     act_quant.cuh
//
// The same bits as kernel I applied to kernel M's gelu of h (one gelu and one
// quantize definition); against PyTorch's F.gelu, the gelu can move a bf16
// value by one ulp and so a code by one.
//
// Bound on the H100 (3.35 TB/s): the bytes, h read once (bf16), the codes and
// scales written once: (3456, 12288) 127 MB, 0.038 ms; (512, 12288) 0.0056
// ms. A CTA a row, 16-byte loads: the row's gelu rounded to bf16 is staged in
// shared memory (24 KB at 12288 columns) while its absmax is taken, then
// quantized from there, so h is read from device memory once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "bf16.cuh"
#include "gelu.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
// 256 threads a row and at most 64 registers, so that several rows (CTAs) share an SM and one's loads overlap
// another's reductions
constexpr int THREADS = 256;
constexpr int MAX_ROW = 20 * 1024;  // its bf16 row staged in 40 KB, under the 48 KB a CTA gets without opting in

__global__ void __launch_bounds__(THREADS, 4)
    gelu_act_quant_kernel(const bf16* __restrict__ h, const float* __restrict__ a_sinv, int8_t* __restrict__ codes,
                          float* __restrict__ scale, int K) {
  extern __shared__ uint4 stage[];  // the row's K / 8 vectors of 8 bf16
  __shared__ float partial[THREADS / 32];
  const size_t m = blockIdx.x;
  const bf16* row = h + m * K;
  const int vecs = K / VEC;
  float amax = 0.0f;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    float f[VEC];
    stage[i] = vc::gelu8(__ldg(reinterpret_cast<const uint4*>(row) + i), f);
    vc::smooth8(f, a_sinv, i * VEC);
    amax = vc::absmax8(f, amax);
  }
  const float s = vc::quant_scale(vc::block_max(amax, partial));  // its barriers publish the staged row
  const float r = vc::quant_rcp(s);
  if (threadIdx.x == 0) scale[m] = s;
  int8_t* out = codes + m * K;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    float f[VEC];
    vc::unpack8(stage[i], f);
    vc::smooth8(f, a_sinv, i * VEC);
    *reinterpret_cast<uint2*>(out + i * VEC) = vc::quant8(f, s, r);
  }
}

}  // namespace

// Kernel O. h (M, K) bf16 contiguous, 16-byte aligned; a_sinv (K,) fp32
// 16-byte aligned or null; codes (M, K) int8 (8-byte aligned) and scale (M,)
// fp32 contiguous; K a multiple of 8, at most MAX_ROW. Launches on `stream`;
// returns a cudaError_t (0 on success).
extern "C" int gelu_act_quant(const void* h, const void* a_sinv, void* codes, void* scale, int M, int K,
                              void* stream) {
  if (M <= 0 || K <= 0 || K % VEC || K > MAX_ROW) return (int)cudaErrorInvalidValue;
  gelu_act_quant_kernel<<<M, THREADS, K * 2, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const float*>(a_sinv), static_cast<int8_t*>(codes),
      static_cast<float*>(scale), K);
  return (int)cudaGetLastError();
}
