// gelu(tanh) of bf16 values rounded back to bf16, shared by kernel M
// (merge_heads.cu: the single block's MLP half, plain and quantizing) and
// kernel O (gelu_act_quant.cu, the double blocks' mlp.0 output).
//
// gelu_tanh(x) = 0.5 x (1 + tanh(u)),  u = sqrt(2 / pi) (x + 0.044715 x^3),
// in fp32 with PyTorch's approximate="tanh" constants. tanh(u) is taken as
// sign(u) tanh|u| with tanh|u| = 1 - 2 / (e^(2|u|) + 1): one ex2.approx and
// one rcp.approx in place of tanhf (fewer instructions and no branch: the
// gelu is most of kernel M's and O's instructions). 1 + tanh(u) is still
// formed in fp32 from the rounded tanh, as F.gelu forms it: for u << 0 that
// sum is a small multiple of 2^-24 (about 1e-7 at x = -5), and it is the
// multiple, not the exact 2 / (1 + e^(-2u)), that F.gelu's bf16 result
// follows there. So the exact identity x / (1 + e^(-2u)) is not used: it is
// closer to the real gelu and farther from PyTorch's (141 bf16 inputs more
// than one ulp away, tests/test_torch_gelu_formula.py). Every bf16 input's
// result lies within one bf16 ulp of F.gelu's on the card
// (chip_smoke.py `check_gelu_exhaustive`; the CPU test emulates this order).
// One definition, so M and O give the same bits for the same input.
#pragma once

#include "approx.cuh"
#include "bf16.cuh"

namespace vc {

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = (float)(1.4142135623730951 * 1.1283791670955126 * 0.5);  // M_SQRT2 * M_2_SQRTPI / 2
  const float kKappa = 0.044715f;
  const float kTwoLog2e = 2.8853900817779268f;  // 2 / ln 2: e^(2a) = 2^(2a / ln 2)
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float u = __fmul_rn(kBeta, __fmaf_rn(kKappa, cube, x));
  const float e = ex2_approx(__fmul_rn(fabsf(u), kTwoLog2e));        // +inf past |u| ~ 44: tanh|u| = 1
  const float t = __fmaf_rn(-2.0f, rcp_approx(__fadd_rn(e, 1.0f)), 1.0f);  // tanh|u|
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, copysignf(t, u)));
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
