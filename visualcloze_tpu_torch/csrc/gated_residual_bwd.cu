// Kernel K': the backward of kernel K (the gated residual add).
//
// Replaces an XLA fusion, not a Pallas kernel: the transpose, under
// jax.grad, of visualcloze_tpu/models/layers.py
// `x + (gate * y.astype(f32)).astype(x.dtype)` in `double_block`
// (:280-288) and `single_block` (:346).
//
//     dx = dout                                     (the wrapper returns it: no pass)
//     dy[b, l, c] = bf16(gate[b, c] * float(dout[b, l, c]))
//     dgate[b, c] = sum_l float(dout[b, l, c]) * float(y[b, l, c])      (fp32)
//
// dy rounds once, as the plain version's bf16 cast does: bit for bit. The
// column sum dgate is per-CTA fp32 partials and a fixed-order second pass
// (colsum.cuh): the same bits at every launch.
//
// Bound on the H100 (3.35 TB/s): the bytes. dout and y read once, dy
// written once: 73.1 MB at (3968, 3072) (0.022 ms). A CTA takes `rows`
// consecutive rows of one batch element (about two CTAs an SM), C / 8
// threads, 16-byte loads, the next row's loads issued before the current
// row's arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "colsum.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_THREADS = 512;  // C up to 4096

__global__ void __launch_bounds__(MAX_THREADS)
    gated_residual_bwd_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                              const float* __restrict__ gate, long long s_gate, bf16* __restrict__ dy,
                              float* __restrict__ partial, int L, int C, int rows) {
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * rows;
  const int l1 = min(L, l0 + rows);
  const int c = threadIdx.x * VEC;
  if (c >= C) return;  // no CTA-wide step follows
  const float4 g0 = __ldg(reinterpret_cast<const float4*>(gate + b * s_gate + c));
  const float4 g1 = __ldg(reinterpret_cast<const float4*>(gate + b * s_gate + c) + 1);
  const float gf[VEC] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  const size_t base = (size_t)b * L * C + c;
  uint4 du = __ldg(reinterpret_cast<const uint4*>(dout + base + (size_t)l0 * C));
  uint4 yu = partial != nullptr ? __ldg(reinterpret_cast<const uint4*>(y + base + (size_t)l0 * C)) : du;
  for (int l = l0; l < l1; ++l) {
    float d[VEC], yf[VEC];
    vc::unpack8(du, d);
    vc::unpack8(yu, yf);
    if (l + 1 < l1) {
      du = __ldg(reinterpret_cast<const uint4*>(dout + base + (size_t)(l + 1) * C));
      if (partial != nullptr) yu = __ldg(reinterpret_cast<const uint4*>(y + base + (size_t)(l + 1) * C));
    }
    if (dy != nullptr) {
      float t[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) t[i] = __fmul_rn(d[i], gf[i]);
      *reinterpret_cast<uint4*>(dy + base + (size_t)l * C) = vc::pack8(t);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = __fmaf_rn(d[i], yf[i], acc[i]);
  }
  if (partial == nullptr) return;
  float4* p = reinterpret_cast<float4*>(partial + ((size_t)b * gridDim.x + blockIdx.x) * C + c);
  p[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  p[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

}  // namespace

// Kernel K'. y, dout (B, L, C) bf16 contiguous; gate fp32 rows of C at
// element stride s_gate a batch; dy (B, L, C) bf16 contiguous or null (not
// wanted); partial (B, ceil(L / rows), C) fp32 scratch and dgate (B, C) fp32,
// both null when the gate's gradient is not wanted (then y is not read).
// All 16-byte aligned; C a multiple of 8, at most 4096. Launches on `stream`
// (the row pass, then the column sums); returns a cudaError_t (0 on success).
extern "C" int gated_residual_bwd(const void* y, const void* dout, const void* gate, long long s_gate, void* dy,
                                  void* partial, void* dgate, int B, int L, int C, int rows, void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % VEC || C > VEC * MAX_THREADS || rows <= 0 ||
      (partial == nullptr) != (dgate == nullptr) || (dy == nullptr && dgate == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = ((C / VEC + 31) / 32) * 32;
  const int chunks = (L + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  gated_residual_bwd_kernel<<<dim3(chunks, B), threads, 0, s>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(dout), static_cast<const float*>(gate), s_gate,
      static_cast<bf16*>(dy), part, L, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  return (int)vc::launch_column_sums(part, 1, B, chunks, C, static_cast<float*>(dgate), nullptr, s);
}
