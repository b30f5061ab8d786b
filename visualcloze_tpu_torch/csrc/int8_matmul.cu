// Kernel G: the int8 weight-only matmul of every quantized DiT linear.
//
// Replaces visualcloze_tpu/ops/int8_matmul.py:int8_matmul (Pallas body
// _kernel): y = x @ (w_int8 * scale), x (M, K) bf16, w_int8 (K, N) int8
// row-major (the JAX layout), scale (N,) fp32; the products are summed in fp32
// and the per-output-channel scale is applied once, in the epilogue, before a
// single rounding to the output type (bf16 or fp32). The int8 -> bf16 convert
// of w is exact (every int8, -128 included, is a bf16 integer), so the kernel
// computes x . w exactly up to the order of the fp32 sums.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): 2*M*N*K FLOPs against
// 2*M*K + K*N + 2*M*N bytes. At M >= ~300 tokens it is bound by operations
// (linear1 at M = 3968: 0.53 ms); at M = 1 (the modulation and embedder
// linears on the (1, 3072) vector) it is a GEMV bound by the weight bytes
// (56.6 MB of int8 for a double block's modulation: 0.017 ms).
//
// Design (a simple kernel that is right; wgmma, TMA and warp specialisation
// are later work):
//   - one CTA of 8 warps per 128 x 128 output tile, the warps 2 x 4, each
//     owning 64 rows x 32 columns in fp32 registers; mma.sync m16n8k16 bf16;
//   - K steps of 64: the x tile (bf16) and the raw int8 w tile stream into a
//     3-stage cp.async ring in shared memory, so two tiles load while one
//     computes; w crosses device memory as int8, half the bytes of bf16;
//   - each K step converts its int8 tile to a bf16 (k, n) tile in shared
//     memory once, for all 8 warps; B fragments then come through
//     ldmatrix.trans as V does in kernel A, A fragments through ldmatrix;
//   - the CTA index walks M fastest, so the CTAs that share a weight column
//     tile run together and read it from device memory once (the activations,
//     24 MB at M = 3968, stay in the 50 MB L2);
//   - for the GEMV (M = 1) the grid still spreads N over the SMs (144 CTAs at
//     N = 18432), and a warp skips the MMAs of its 16-row tiles that hold no
//     row of x (7 of 8 at M = 1), so the weight stream, not the wasted tensor
//     work, sets the time; ragged M and N (N = 64 for final_layer.linear) are
//     masked in the loads (zero-filled) and the stores, never padded in memory.
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "mma.cuh"

namespace {

using namespace vc;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 3;
constexpr int NWARPS = 8, NT = NWARPS * 32;
constexpr int WM = 64, WN = 32;  // warp tile; the warps are 2 (M) x 4 (N)
constexpr int LDX = BK + 8;      // bf16 row stride of an x tile: 144 bytes, conflict-free ldmatrix
constexpr int LDB = BN + 8;      // bf16 row stride of the converted w tile: 272 bytes
constexpr size_t XS_ELEMS = (size_t)BM * LDX;
constexpr size_t W8_BYTES = (size_t)BK * BN;
constexpr size_t SMEM = STAGES * XS_ELEMS * 2 + STAGES * W8_BYTES + (size_t)BK * LDB * 2;  // 97,280

// tile k0 of x (rows m0.., zero past M) and of w (columns n0.., zero past N)
__device__ __forceinline__ void load_stage(bf16* xs, int8_t* w8, const bf16* __restrict__ x,
                                           const int8_t* __restrict__ w, int M, int N, int K, int m0,
                                           int n0, int k0) {
  for (int u = threadIdx.x; u < BM * (BK / 8); u += NT) {
    const int r = u / (BK / 8);
    const int c = (u % (BK / 8)) * 8;
    const int row = m0 + r;
    const bool ok = row < M;
    cp_async16(xs + r * LDX + c, x + (size_t)(ok ? row : 0) * K + k0 + c, ok);
  }
  for (int u = threadIdx.x; u < BK * (BN / 16); u += NT) {
    const int r = u / (BN / 16);
    const int c = (u % (BN / 16)) * 16;
    const bool ok = n0 + c < N;
    cp_async16_bytes(w8 + r * BN + c, w + (size_t)(k0 + r) * N + (ok ? n0 + c : 0), ok);
  }
}

__device__ __forceinline__ void store2(bf16* y, float a, float b) {
  *reinterpret_cast<uint32_t*>(y) = pack2(a, b);
}

__device__ __forceinline__ void store2(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(NT, 2)
    int8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, OutT* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  int8_t* W8 = reinterpret_cast<int8_t*>(smem + STAGES * XS_ELEMS * 2);
  bf16* Wb = reinterpret_cast<bf16*>(smem + STAGES * XS_ELEMS * 2 + STAGES * W8_BYTES);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int nk = K / BK;
  // warp-uniform: does this warp's 32-column strip hold a column of y?
  const bool cols_live = n0 + wn * WN < N;

  float acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(Xs + s * XS_ELEMS, W8 + s * W8_BYTES, x, w, M, N, K, m0, n0, s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt % STAGES;
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();              // ... everyone's; and every warp is done with tile kt - 1
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)  // into the stage tile kt - 1 used
      load_stage(Xs + (nxt % STAGES) * XS_ELEMS, W8 + (nxt % STAGES) * W8_BYTES, x, w, M, N, K, m0, n0,
                 nxt * BK);
    cp_async_commit();  // an empty group at the tail keeps the wait count right

    // int8 -> bf16, exact: 16 values per thread and chunk
    const int8_t* w8 = W8 + cur * W8_BYTES;
    for (int u = threadIdx.x; u < BK * (BN / 16); u += NT) {
      const int r = u / (BN / 16);
      const int c = (u % (BN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(w8 + r * BN + c);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float f[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(static_cast<int8_t>(words[i / 4] >> (8 * (i % 4))));
      *reinterpret_cast<uint4*>(Wb + r * LDB + c) = pack8(f);
      *reinterpret_cast<uint4*>(Wb + r * LDB + c + 8) = pack8(f + 8);
    }
    __syncthreads();

    if (cols_live) {
      const bf16* xs = Xs + cur * XS_ELEMS;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t bfr[WN / 8][2];
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) {
          uint32_t r[4];
          ldmatrix_x4_trans(
              r, Wb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + wn * WN + j * 16 + (lane >> 4) * 8);
          bfr[2 * j][0] = r[0];
          bfr[2 * j][1] = r[1];
          bfr[2 * j + 1][0] = r[2];
          bfr[2 * j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < WM / 16; ++i) {
          if (m0 + wm * WM + i * 16 >= M) break;  // warp-uniform: no row of x left in this warp
          uint32_t a[4];
          ldmatrix_x4(a, xs + (wm * WM + i * 16 + (lane & 15)) * LDX + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < WN / 8; ++j) mma16816(acc[i][j], a, bfr[j][0], bfr[j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: acc * scale[n] in fp32, one rounding to OutT; N is a multiple of
  // 16, so a live column pair is whole
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = n0 + wn * WN + j * 8 + 2 * t;
    if (col >= N) continue;
    const float s0 = __ldg(scale + col), s1 = __ldg(scale + col + 1);
#pragma unroll
    for (int i = 0; i < WM / 16; ++i) {
      const int row = m0 + wm * WM + i * 16 + g;
      if (row < M) store2(y + (size_t)row * N + col, acc[i][j][0] * s0, acc[i][j][1] * s1);
      if (row + 8 < M) store2(y + (size_t)(row + 8) * N + col, acc[i][j][2] * s0, acc[i][j][3] * s1);
    }
  }
}

template <typename OutT>
cudaError_t launch(const bf16* x, const int8_t* w, const float* scale, OutT* y, int M, int N, int K,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_matmul_kernel<OutT><<<grid, NT, SMEM, s>>>(x, w, scale, y, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// Kernel G. x (M, K) bf16, w (K, N) int8, scale (N,) fp32, y (M, N) bf16
// (out_f32 = 0) or fp32 (out_f32 = 1), all contiguous and 16-byte aligned;
// K a multiple of 64, N a multiple of 16. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* y, int M, int N, int K,
                           int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  if (out_f32) return (int)launch<float>(xp, wp, sp, static_cast<float*>(y), M, N, K, s);
  return (int)launch<bf16>(xp, wp, sp, static_cast<bf16*>(y), M, N, K, s);
}
