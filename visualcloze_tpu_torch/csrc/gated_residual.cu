// Kernel K: a DiT block's gated residual add, in one pass.
//
// Replaces an XLA fusion, not a Pallas kernel: visualcloze_tpu/models/
// layers.py `x + (gate * y.astype(f32)).astype(x.dtype)` in `double_block`
// (:280-288, four a block) and `single_block` (:346).
//
//     out[b, l, c] = bf16(float(x) + float(bf16(gate[b, c] * float(y))))
//
// x and y bf16 (B, L, C), gate fp32 (B, C). Both roundings of the plain
// version are kept (the product to bf16, then the bf16 sum, each round to
// nearest even), so the kernel equals the plain version and JAX bit for bit.
// Out of place.
//
// Bound on the H100 (3.35 TB/s): the bytes. x and y read once, out written
// once: 73.1 MB at (3968, 3072), 0.022 ms. One CTA a row, C / 8 threads
// (384 at C = 3072; up to 8 elements a thread a step beyond 8192), 16-byte
// loads and stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_THREADS = 1024;

__global__ void __launch_bounds__(MAX_THREADS)
    gated_residual_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const float* __restrict__ gate,
                          long long s_gate, bf16* __restrict__ out, int L, int C) {
  const int row = blockIdx.x;
  const int b = row / L;
  const size_t base = (size_t)row * C;
  const float* g = gate + b * s_gate;
  for (int c = threadIdx.x * VEC; c < C; c += blockDim.x * VEC) {
    float xf[VEC], yf[VEC];
    vc::unpack8(__ldg(reinterpret_cast<const uint4*>(x + base + c)), xf);
    vc::unpack8(__ldg(reinterpret_cast<const uint4*>(y + base + c)), yf);
    const float4 g0 = __ldg(reinterpret_cast<const float4*>(g + c));
    const float4 g1 = __ldg(reinterpret_cast<const float4*>(g + c) + 1);
    const float gf[VEC] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float t = __bfloat162float(__float2bfloat16_rn(__fmul_rn(gf[i], yf[i])));
      xf[i] = __fadd_rn(xf[i], t);
    }
    *reinterpret_cast<uint4*>(out + base + c) = vc::pack8(xf);
  }
}

}  // namespace

// Kernel K. x, y, out (B, L, C) bf16 contiguous; gate fp32 rows of C at
// element stride s_gate a batch. x, y, out, gate 16-byte aligned; C a
// multiple of 8. Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int gated_residual(const void* x, const void* y, const void* gate, long long s_gate, void* out, int B,
                              int L, int C, void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % VEC) return (int)cudaErrorInvalidValue;
  const int vecs = C / VEC;
  const int threads = vecs >= MAX_THREADS ? MAX_THREADS : ((vecs + 31) / 32) * 32;
  gated_residual_kernel<<<B * L, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<const float*>(gate), s_gate,
      static_cast<bf16*>(out), L, C);
  return (int)cudaGetLastError();
}
