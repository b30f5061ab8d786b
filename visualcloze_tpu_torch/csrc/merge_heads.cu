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
// gelu_tanh is gelu.cuh's (PyTorch's approximate="tanh" in fp32, shared with
// kernel O). The merge is a copy: bit for bit. A double block uses the merge
// alone (G = 0).
//
// On the fused w8a8 route the quantized variant (`merge_heads_quant`) writes
// the consumer linears' int8 codes and row scales instead, kernel I folded
// in: the row's bf16 values (the merge, then the rounded gelu) staged in
// shared memory, times a_sinv, their absmax, then act_quant.cuh's quantize
// from the staged row, so the row is read from device memory once; the codes
// and scales of kernel I applied to M's own output, bit for bit. In a double
// block the joint rows [0, split) (the text tokens) feed txt_attn.proj and
// the rest img_attn.proj: each segment takes its own a_sinv and is written
// to its own contiguous (B * rows, H * D) buffers. A padded row's merge is
// zero (codes 0, scale 1e-8 / 127 in a double block).
//
// Bound on the H100 (3.35 TB/s): the bytes. attn and mlp read once, out
// written once: 244 MB for the single block at 3968 tokens (0.073 ms), 48.8
// MB for the merge alone (0.015 ms); quantized, 183 MB (0.055 ms) and 36.6
// MB (0.011 ms). A CTA a token, 16-byte loads and stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "bf16.cuh"
#include "gelu.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_THREADS = 1024;
// the quantizing variant: 256 threads a row and at most 64 registers, so that several rows (CTAs) share an SM
// and one's loads overlap another's reductions
constexpr int QUANT_THREADS = 256;

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
    *reinterpret_cast<uint4*>(o + H * D + j) = vc::gelu8(__ldg(reinterpret_cast<const uint4*>(m + j)), f);
  }
}

// Kernel M quantized: the row of W = H * D + G bf16 values (as merge_heads_kernel
// writes them) staged in shared memory, then its codes and scale in the
// segment's buffers (rows [0, split) of each batch element: segment 0).
__global__ void __launch_bounds__(QUANT_THREADS, 4)
    merge_heads_quant_kernel(const bf16* __restrict__ attn, const int* __restrict__ mask,
                             const bf16* __restrict__ mlp, long long mb, long long ml, int L, int H, int D, int G,
                             int split, const float* __restrict__ sinv0, int8_t* __restrict__ codes0,
                             float* __restrict__ scale0, const float* __restrict__ sinv1,
                             int8_t* __restrict__ codes1, float* __restrict__ scale1) {
  extern __shared__ uint4 stage[];  // the row's W / 8 vectors of 8 bf16
  __shared__ float partial[QUANT_THREADS / 32];
  const int row = blockIdx.x;
  const int b = row / L, l = row - b * L;
  const bool keep = mask == nullptr || mask[row] != 0;
  const bool first = l < split;
  const float* sinv = first ? sinv0 : sinv1;
  const size_t seg_row = first ? (size_t)b * split + l : (size_t)b * (L - split) + (l - split);
  const int hd = H * D, vecs = (hd + G) / VEC, lanes = D / VEC;
  const bf16* m = mlp + b * mb + l * ml;
  float amax = 0.0f;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const int col = i * VEC;
    float f[VEC];
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (col < hd) {
      const int h = i / lanes, d = (i - h * lanes) * VEC;
      if (keep) u = __ldg(reinterpret_cast<const uint4*>(attn + (((size_t)b * H + h) * L + l) * D + d));
      vc::unpack8(u, f);
    } else {
      u = vc::gelu8(__ldg(reinterpret_cast<const uint4*>(m + (col - hd))), f);
    }
    stage[i] = u;
    vc::smooth8(f, sinv, col);
    amax = vc::absmax8(f, amax);
  }
  const float s = vc::quant_scale(vc::block_max(amax, partial));  // its barriers publish the staged row
  const float r = vc::quant_rcp(s);
  if (threadIdx.x == 0) (first ? scale0 : scale1)[seg_row] = s;
  int8_t* out = (first ? codes0 : codes1) + seg_row * (hd + G);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    float f[VEC];
    vc::unpack8(stage[i], f);
    vc::smooth8(f, sinv, i * VEC);
    *reinterpret_cast<uint2*>(out + i * VEC) = vc::quant8(f, s, r);
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

// Kernel M quantized. attn, mask, mlp (mb, ml), B, L, H, D, G as merge_heads;
// W = H * D + G at most MAX_QUANT_ROW (its bf16 row staged in 40 KB of shared
// memory). Rows l < split of each batch element go to segment 0 (a_sinv0,
// codes0 (B * split, W) int8, scale0 (B * split,) fp32), the others to
// segment 1 (a_sinv1, codes1 (B * (L - split), W), scale1); split 0: segment
// 1 alone (its pointers may be null). a_sinv (W,) fp32 16-byte aligned or
// null; codes 8-byte aligned. Launches on `stream`; returns a cudaError_t (0
// on success).
extern "C" int merge_heads_quant(const void* attn, const void* mask, const void* mlp, long long mb, long long ml,
                                 int B, int L, int H, int D, int G, int split, const void* a_sinv0, void* codes0,
                                 void* scale0, const void* a_sinv1, void* codes1, void* scale1, void* stream) {
  constexpr int MAX_QUANT_ROW = 20 * 1024;  // under the 48 KB a CTA gets without opting in
  const int w = H * D + G;
  if (B <= 0 || L <= 0 || H <= 0 || D % VEC || G % VEC || G < 0 || w > MAX_QUANT_ROW || split < 0 || split >= L ||
      (mlp == nullptr) != (G == 0) || (split > 0 && (codes0 == nullptr || scale0 == nullptr)) ||
      codes1 == nullptr || scale1 == nullptr)
    return (int)cudaErrorInvalidValue;
  merge_heads_quant_kernel<<<B * L, QUANT_THREADS, w * 2, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(attn), static_cast<const int*>(mask), static_cast<const bf16*>(mlp), mb, ml, L, H, D,
      G, split, static_cast<const float*>(a_sinv0), static_cast<int8_t*>(codes0), static_cast<float*>(scale0),
      static_cast<const float*>(a_sinv1), static_cast<int8_t*>(codes1), static_cast<float*>(scale1));
  return (int)cudaGetLastError();
}
