// Kernel M': the backward of kernel M (head merge + gelu).
//
// Replaces an XLA fusion, not a Pallas kernel: the transpose, under
// jax.grad, of the head merge of visualcloze_tpu/ops/attention.py (:176:
// transpose, reshape, mask multiply) and of
// `concatenate([attn, gelu(mlp_h, approximate=True)])` in
// visualcloze_tpu/models/layers.py `single_block` (:342).
//
//     dx[b, h, l, d] = dout[b, l, h * D + d] if mask[b, l] else 0      (a copy)
//     dg[b, l, j] = bf16(float(dout[b, l, H * D + j]) * gelu_tanh'(float(g[b, l, j])))
//
// gelu_tanh' in fp32 in PyTorch's order (its gelu backward's constants and
// terms; tanhf may differ from PyTorch's by an fp32 ulp), rounded once. dg
// is written through its strides: the single block's gradient buffer of
// linear1's whole output, whose first 3 H D columns kernel L' fills, so
// linear1 gets one gradient with no zero-filled slice gradient and no sum.
// A double block uses the merge alone (G = 0).
//
// Bound on the H100 (3.35 TB/s): the bytes. dout and g read once, dx and
// dg written once: 342 MB for the single block at 3968 tokens (0.10 ms),
// 48.8 MB for the merge alone (0.015 ms). A CTA a token, 16-byte loads and
// stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float gelu_tanh_grad(float dy, float x) {
  const float kBeta = (float)(1.4142135623730951 * 1.1283791670955126 * 0.5);  // M_SQRT2 * M_2_SQRTPI / 2
  const float kKappa = 0.044715f;
  const float x_sq = x * x;
  const float x_cube = x_sq * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  const float t = tanhf(inner);
  const float left = 0.5f * x;
  const float right = 1.0f + t;
  const float left_derivative = 0.5f * right;
  const float tanh_derivative = 1.0f - t * t;
  const float inner_derivative = kBeta * (1.0f + 3.0f * kKappa * x_sq);
  const float right_derivative = left * tanh_derivative * inner_derivative;
  return dy * (left_derivative + right_derivative);
}

__global__ void __launch_bounds__(MAX_THREADS)
    merge_heads_bwd_kernel(const bf16* __restrict__ dout, const int* __restrict__ mask, const bf16* __restrict__ g,
                           long long gb, long long gl, bf16* __restrict__ dx, bf16* __restrict__ dg, long long dgb,
                           long long dgl, int L, int H, int D, int G) {
  const int row = blockIdx.x;
  const int b = row / L, l = row - b * L;
  const bf16* o = dout + (size_t)row * (H * D + G);
  if (dx != nullptr) {
    const bool keep = mask == nullptr || mask[row] != 0;
    const int lanes = D / VEC;
    for (int i = threadIdx.x; i < H * lanes; i += blockDim.x) {
      const int h = i / lanes, d = (i - h * lanes) * VEC;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (keep) u = __ldg(reinterpret_cast<const uint4*>(o + h * D + d));
      *reinterpret_cast<uint4*>(dx + (((size_t)b * H + h) * L + l) * D + d) = u;
    }
  }
  if (dg == nullptr) return;
  const bf16* gr = g + b * gb + l * gl;
  bf16* out = dg + b * dgb + l * dgl;
  for (int j = threadIdx.x * VEC; j < G; j += blockDim.x * VEC) {
    float dy[VEC], x[VEC];
    vc::unpack8(__ldg(reinterpret_cast<const uint4*>(o + H * D + j)), dy);
    vc::unpack8(__ldg(reinterpret_cast<const uint4*>(gr + j)), x);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dy[i] = gelu_tanh_grad(dy[i], x[i]);
    *reinterpret_cast<uint4*>(out + j) = vc::pack8(dy);
  }
}

}  // namespace

// Kernel M'. dout (B, L, H * D + G) bf16 contiguous; mask (B, L) int32
// contiguous or null (nothing padded); g (B, L, G) bf16 at element strides
// gb, gl, its feature axis contiguous (kernel M's gelu input), and dg
// likewise at dgb, dgl, both null with G = 0 or when dg is not wanted; dx
// (B, H, L, D) bf16 contiguous or null (not wanted). D and G multiples of
// 8; every row start 16-byte aligned. Launches on `stream`; returns a
// cudaError_t (0 on success).
extern "C" int merge_heads_bwd(const void* dout, const void* mask, const void* g, long long gb, long long gl,
                               void* dx, void* dg, long long dgb, long long dgl, int B, int L, int H, int D, int G,
                               void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || D % VEC || G % VEC || G < 0 || (g == nullptr) != (dg == nullptr) ||
      (dx == nullptr && dg == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vecs = (H * D > G ? H * D : G) / VEC;
  const int threads = vecs >= MAX_THREADS ? MAX_THREADS : ((vecs + 31) / 32) * 32;
  merge_heads_bwd_kernel<<<B * L, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dout), static_cast<const int*>(mask), static_cast<const bf16*>(g), gb, gl,
      static_cast<bf16*>(dx), static_cast<bf16*>(dg), dgb, dgl, L, H, D, G);
  return (int)cudaGetLastError();
}
