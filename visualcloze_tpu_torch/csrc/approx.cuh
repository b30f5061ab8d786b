// The special-function unit's approximations, as PTX gives them, shared by
// gelu.cuh (kernels M and O) and group_norm.cu's swish (kernel N).
// ex2.approx: about 2 ulps; rcp.approx: about 1 ulp. Both flush subnormal
// inputs and results to zero (ftz): a caller whose result can be subnormal
// guards that range itself.
#pragma once

namespace vc {

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace vc
