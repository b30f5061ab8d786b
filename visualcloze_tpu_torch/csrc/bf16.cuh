// bf16 <-> fp32 helpers shared by the kernels: 8 bf16 values in one 16-byte
// vector, bf16 pairs in one 32-bit register.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// round-to-nearest-even, as JAX's astype(bfloat16)
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// two fp32 values -> a bf16 pair, round-to-nearest-even (JAX's astype)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// one or two fp32 values stored to y, rounded (round-to-nearest-even) where
// y is bf16
__device__ __forceinline__ void store2(bf16* y, float a, float b) { *reinterpret_cast<uint32_t*>(y) = pack2(a, b); }
__device__ __forceinline__ void store2(float* y, float a, float b) { *reinterpret_cast<float2*>(y) = make_float2(a, b); }
__device__ __forceinline__ void store1(bf16* y, float a) { *y = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store1(float* y, float a) { *y = a; }

// a pair of fp32 values into shared memory at `addr` as OutT (the pointer
// only picks the type): a bf16 pair rounded to nearest even, or two fp32
__device__ __forceinline__ void stage2(uint32_t addr, float a, float b, const bf16*) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(pack2(a, b)) : "memory");
}
__device__ __forceinline__ void stage2(uint32_t addr, float a, float b, const float*) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

// v rounded to bf16, plus a bf16 bias b in fp32 (the caller rounds the sum):
// a linear's bf16 output y, then the bf16 `y + b` (as PyTorch adds two bf16
// tensors: in fp32, one rounding)
__device__ __forceinline__ float add_bias(float v, float b) {
  return __fadd_rn(__bfloat162float(__float2bfloat16_rn(v)), b);
}

// two bf16 pairs added, the exact sums rounded to nearest even once: for
// bf16 operands the same bits as add_bias's fp32 sum rounded to bf16 (the
// fp32 sum is exact unless one operand is below 2^-16 of the other, and
// then both round to the larger)
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// a bf16 pair times s in fp32, rounded back to bf16: bf16(q * scale * log2(e))
__device__ __forceinline__ uint32_t scale2(uint32_t x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack2(f.x * s, f.y * s);
}

}  // namespace vc
