// gelu(tanh) of bf16 values rounded back to bf16, shared by kernel M
// (merge_heads.cu, the single block's MLP half) and kernel O
// (gelu_act_quant.cu, the double blocks' mlp.0 output).
//
// gelu_tanh(x) = 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))) in fp32, as
// PyTorch's approximate="tanh" computes it for bf16 (its constants; tanhf may
// differ from PyTorch's by an fp32 ulp, which can move the bf16 result by one
// ulp). One definition, so M and O give the same bits for the same input.
#pragma once

#include "bf16.cuh"

namespace vc {

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = (float)(1.4142135623730951 * 1.1283791670955126 * 0.5);  // M_SQRT2 * M_2_SQRTPI / 2
  const float kKappa = 0.044715f;
  const float cube = x * x * x;
  const float inner = kBeta * (x + kKappa * cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// 8 bf16 values -> their gelu as 8 bf16 (round to nearest even), returned
// packed; f receives the rounded values in fp32
__device__ __forceinline__ uint4 gelu8(const uint4& in, float* f) {
  unpack8(in, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = gelu_tanh(f[i]);
  const uint4 out = pack8(f);
  unpack8(out, f);
  return out;
}

}  // namespace vc
