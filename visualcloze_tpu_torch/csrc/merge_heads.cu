// Kernel M: attention's head merge with the padded query rows zeroed and, in
// the single block, gelu(tanh) of the MLP half written beside it: linear2's
// whole input in one pass.
//
// Replaces an XLA fusion, not a Pallas kernel: the head merge of
// visualcloze_tpu/ops/attention.py (transpose, reshape, mask multiply) and
// `concatenate([attn, gelu(mlp_h, approximate=True)])` in
// visualcloze_tpu/models/layers.py `single_block` (:342).
//
//     out[b, l, h * D + d] = attn[b, h, l, d] if mask[b, l] else 0
//     out[b, l, H * D + j] = bf16(gelu_tanh(float(mlp[b, l, j])))   (j < G)
//
// gelu_tanh(x) = 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))) in fp32, as
// PyTorch's approximate="tanh" computes it for bf16 (its constants; tanhf may
// differ from PyTorch's by an fp32 ulp, which can move the bf16 result by
// one ulp). The merge is a copy: bit for bit. A double block uses the merge
// alone (G = 0).
//
// Bound on the H100 (3.35 TB/s): the bytes. attn and mlp read once, out
// written once: 244 MB for the single block at 3968 tokens (0.073 ms), 48.8
// MB for the merge alone (0.015 ms). A CTA a token, 16-byte loads and stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = (float)(1.4142135623730951 * 1.1283791670955126 * 0.5);  // M_SQRT2 * M_2_SQRTPI / 2
  const float kKappa = 0.044715f;
  const float cube = x * x * x;
  const float inner = kBeta * (x + kKappa * cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__global__ void __launch_bounds__(MAX_THREADS)
    merge_heads_kernel(const bf16* __restrict__ attn, const int* __restrict__ mask, const bf16* __restrict__ mlp,
                       long long mb, long long ml, bf16* __restrict__ out, int L, int H, int D, int G, int ldo) {
  const int row = blockIdx.x;
  const int b = row / L, l = row - b * L;
  const bool keep = mask == nullptr || mask[row] != 0;
  bf16* o = out + (size_t)row * ldo;
  const int lanes = D / VEC;
  for (int i = threadIdx.x; i < H * lanes; i += blockDim.x) {
    const int h = i / lanes, d = (i - h * lanes) * VEC;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (keep) u = __ldg(reinterpret_cast<const uint4*>(attn + (((size_t)b * H + h) * L + l) * D + d));
    *reinterpret_cast<uint4*>(o + h * D + d) = u;
  }
  if (mlp == nullptr) return;
  const bf16* m = mlp + b * mb + l * ml;
  for (int j = threadIdx.x * VEC; j < G; j += blockDim.x * VEC) {
    float f[VEC];
    vc::unpack8(__ldg(reinterpret_cast<const uint4*>(m + j)), f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = gelu_tanh(f[i]);
    *reinterpret_cast<uint4*>(o + H * D + j) = vc::pack8(f);
  }
}

}  // namespace

// Kernel M. attn (B, H, L, D) bf16 contiguous; mask (B, L) int32 contiguous
// or null (nothing padded); mlp (B, L, G) bf16 at element strides mb, ml, its
// feature axis contiguous, or null with G = 0; out (B, L, ldo) bf16,
// ldo >= H * D + G, written in columns [0, H * D + G). D and G multiples of 8;
// ldo a multiple of 8; attn, mlp's rows and out 16-byte aligned. Launches on
// `stream`; returns a cudaError_t (0 on success).
extern "C" int merge_heads(const void* attn, const void* mask, const void* mlp, long long mb, long long ml, void* out,
                           int B, int L, int H, int D, int G, int ldo, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D % VEC || G % VEC || G < 0 || ldo % VEC || ldo < H * D + G ||
      (mlp == nullptr) != (G == 0))
    return (int)cudaErrorInvalidValue;
  const int vecs = H * D / VEC;
  const int threads = vecs >= MAX_THREADS ? MAX_THREADS : ((vecs + 31) / 32) * 32;
  merge_heads_kernel<<<B * L, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(attn), static_cast<const int*>(mask), static_cast<const bf16*>(mlp), mb, ml,
      static_cast<bf16*>(out), L, H, D, G, ldo);
  return (int)cudaGetLastError();
}
