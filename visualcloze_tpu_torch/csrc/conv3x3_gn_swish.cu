// Kernel B: GroupNorm affine + swish + 3x3 SAME conv in one pass, NHWC.
//
// Replaces visualcloze_tpu/ops/conv2d.py:conv3x3_fused (Pallas bodies _kernel
// and _kernel_wtiled), called from every VAE resnet half-block
// (autoencoder._gn_swish_conv) and, without affine or activation, from every
// upsample conv:
//
//   y = conv3x3_SAME(act(x * a + b0), w) + bias
//
// x (B, H, W, C) bf16, w (3, 3, C, Cout) bf16, bias (Cout) fp32, a and b0
// (B, C) fp32 or null, y (B, H, W, Cout) bf16. The activation runs in fp32 and
// is rounded to bf16; positions outside the image are zero AFTER the
// activation (swish(b0) != 0 on the border). The residual add stays outside.
//
// Bound on the H100: 2*H*W*C*Cout*9 tensor-core FLOPs against
// (H*W*(C + Cout) + 9*C*Cout)*2 bytes: at 384x1152 with C = Cout = 128 that
// is 1.30e11 FLOPs -> 0.132 ms at 989 TFLOP/s versus 0.068 ms for the 226 MB
// at 3.35 TB/s, so compute-bound; the deep levels (48x144x512) likewise.
//
// Design (an implicit GEMM, right and simple first):
//   - a CTA owns an 8x16 tile of output pixels x 128 output channels; the 8
//     warps each own one pixel row (16 pixels) x 128 channels, eight 16x16
//     fp32 wmma accumulators;
//   - the reduction runs over 32-channel chunks of C: the (8+2)x(16+2) halo of
//     the chunk is loaded once, transformed (affine, swish, border zeroing,
//     bf16 rounding) in fp32 on the way into shared memory, and the 9 taps x
//     32 channels x 128 outputs of the weights sit beside it (~96 KB in all;
//     at 140 registers a thread, one CTA per SM);
//   - each tap is then a plain shifted view of the halo: the 16 pixels of a
//     warp's row are 16 consecutive halo entries, so the A operand loads
//     straight from shared memory with no im2col copy;
//   - the TPU kernel's VMEM budget and its column tiling (VMEM_BUDGET,
//     fusable, _pick_bw) are TPU facts and do not carry over: every H and W
//     is taken, ragged tiles masked; C and Cout must be multiples of 8.
#include <cuda_runtime.h>
#include <mma.h>

#include "bf16.cuh"

namespace {

using vc::bf16;
using vc::pack8;
using vc::unpack8;
namespace wmma = nvcuda::wmma;

constexpr int TH = 8, TW = 16;  // output pixel tile
constexpr int BN = 128;         // output channels per CTA
constexpr int KC = 32;          // input channels per reduction chunk
constexpr int HH = TH + 2, HW = TW + 2;
constexpr int LDA = KC + 16;  // bf16 per halo pixel: 96 bytes keeps tile pointers 32-byte aligned
constexpr int LDW = BN + 8;   // bf16 weight row stride
constexpr int LDC = BN + 4;   // fp32 output staging row stride
constexpr int NWARPS = 8, NT = NWARPS * 32;
constexpr size_t HALO_BYTES = (size_t)HH * HW * LDA * 2;
constexpr size_t W_BYTES = (size_t)9 * KC * LDW * 2;
constexpr size_t SMEM = HALO_BYTES + W_BYTES;
static_assert(TH == NWARPS, "one pixel row per warp");
static_assert((size_t)TH * TW * LDC * 4 <= W_BYTES, "output staging must fit the weight buffer");
static_assert(HALO_BYTES % 32 == 0, "weight buffer alignment");

template <bool PRE, bool SWISH>
__global__ void __launch_bounds__(NT)
    conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ a,
                   const float* __restrict__ b0, bf16* __restrict__ y, int H, int W, int C,
                   int Cout, int tiles_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* Ws = reinterpret_cast<bf16*>(smem + HALO_BYTES);
  float* Cs = reinterpret_cast<float*>(smem + HALO_BYTES);  // epilogue staging over Ws

  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < C; k0 += KC) {
    __syncthreads();
    // halo of this channel chunk: affine + swish in fp32, zero outside the image
    for (int u = tid; u < HH * HW * (KC / 8); u += NT) {
      const int p = u / (KC / 8);
      const int ch = k0 + (u % (KC / 8)) * 8;
      const int gr = r0 - 1 + p / HW;
      const int gc = c0 - 1 + p % HW;
      uint4 val = zero;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W && ch < C) {
        val = *reinterpret_cast<const uint4*>(x + (((size_t)b * H + gr) * W + gc) * C + ch);
        if (PRE) {
          float f[8];
          unpack8(val, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float t = f[i] * a[(size_t)b * C + ch + i] + b0[(size_t)b * C + ch + i];
            if (SWISH) t = t * (1.0f / (1.0f + expf(-t)));
            f[i] = t;
          }
          val = pack8(f);
        }
      }
      *reinterpret_cast<uint4*>(halo + p * LDA + (u % (KC / 8)) * 8) = val;
    }
    // weights of this chunk: 9 taps x KC input channels x BN output channels
    for (int u = tid; u < 9 * KC * (BN / 8); u += NT) {
      const int tap = u / (KC * (BN / 8));
      const int rem = u % (KC * (BN / 8));
      const int kr = rem / (BN / 8);
      const int nv = (rem % (BN / 8)) * 8;
      const int ch = k0 + kr;
      uint4 val = zero;
      if (ch < C && n0 + nv < Cout)
        val = *reinterpret_cast<const uint4*>(w + ((size_t)tap * C + ch) * Cout + n0 + nv);
      *reinterpret_cast<uint4*>(Ws + (tap * KC + kr) * LDW + nv) = val;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int di = tap / 3, dj = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, halo + ((warp + di) * HW + dj) * LDA + ks * 16, LDA);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Ws + (tap * KC + ks * 16) * LDW + j * 16, LDW);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(Cs + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int u = tid; u < TH * TW * (BN / 8); u += NT) {
    const int pix = u / (BN / 8);
    const int nv = (u % (BN / 8)) * 8;
    const int r = r0 + pix / TW;
    const int c = c0 + pix % TW;
    const int n = n0 + nv;
    if (r < H && c < W && n < Cout) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = Cs[pix * LDC + nv + i] + bias[n + i];
      *reinterpret_cast<uint4*>(y + (((size_t)b * H + r) * W + c) * Cout + n) = pack8(f);
    }
  }
}

template <bool PRE, bool SWISH>
int launch(const void* x, const void* w, const void* bias, const void* a, const void* b0, void* y,
           int B, int H, int W, int C, int Cout, cudaStream_t stream) {
  auto kern = conv3x3_kernel<PRE, SWISH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_h * tiles_w, (Cout + BN - 1) / BN, B);
  kern<<<grid, NT, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(a), static_cast<const float*>(b0), static_cast<bf16*>(y), H, W, C,
      Cout, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int conv3x3_gn_swish(const void* x, const void* w, const void* bias, const void* a,
                                const void* b0, void* y, int B, int H, int W, int C, int Cout,
                                int pre, int swish, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % 8 || Cout % 8 || (swish && !pre))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pre && swish) return launch<true, true>(x, w, bias, a, b0, y, B, H, W, C, Cout, s);
  if (pre) return launch<true, false>(x, w, bias, a, b0, y, B, H, W, C, Cout, s);
  return launch<false, false>(x, w, bias, a, b0, y, B, H, W, C, Cout, s);
}
