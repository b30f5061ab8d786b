// The wide-M body of the weight-only matmuls, kernels G (int8_matmul.cu) and
// G4 (int4_matmul.cu): y = x @ W, x (M, K) bf16, W (K, N) stored quantized
// and converted to bf16 once per CTA in shared memory. A convert policy Cv
// says how a stored tile becomes bf16; everything else is shared:
// a warp-specialised wgmma kernel of 512 threads, one CTA an SM, one 128 x
// 256 output tile a CTA:
//   - warp 0 issues TMA loads into two 4-stage mbarrier rings: lane 0 the x
//     tiles (128 rows x 64 K, bf16, 128-byte swizzle: the K-major A operand;
//     rows past M arrive as zeros), lane 1 the stored w tiles (Cv::W_ROWS
//     rows x 256 N bytes, the 64 K rows of a stage; columns past N arrive as
//     zeros), so w crosses device memory in its stored form, and each ring
//     is freed by its own readers (the transform runs ahead of the products
//     by up to 3 stages);
//   - warps 1 .. 7 (setmaxnreg Cv::TRANSFORM_REGS, with warp 0) convert
//     each stored tile once for the CTA (Cv::convert) into a 3-stage bf16 B
//     buffer in the 128-byte swizzled MN-major layout (four 64-column blocks
//     of 64 rows, b_offset): a (K, N) row-major tile converted is an
//     MN-major B operand, so no operand is transposed;
//   - warpgroups 2 and 3 (setmaxnreg Cv::CONSUMER_REGS) own 64 rows x 256
//     columns each in fp32 (128 registers) and issue SS wgmma, two
//     m64n128k16 a k16 step (x from the ring, K-major; the converted w,
//     MN-major; one m64n256 needs more than the 128 registers ptxas allows a
//     thread of a 512-thread CTA), one commit group in flight: a stage's x
//     and its bf16 buffer are freed once the products of the next stage are
//     issued and the ones reading them are done;
//   - the epilogue scales the sums by scale[n] in fp32 where the policy
//     leaves the scale to it (Cv::EPILOGUE_SCALE), rounds once and stores
//     the rows and columns inside (M, N);
//   - the CTA index walks M fastest, so the CTAs that run together share
//     weight column tiles (read from device memory once) while x (24 MB at
//     M = 3968) stays in the 50 MB L2.
//
// A policy Cv has:
//   W_ROWS, PACK        stored rows a stage, K rows a stored row (64, 1 for
//                       int8; 32, 2 for int4)
//   TRANSFORM_REGS, CONSUMER_REGS, EPILOGUE_SCALE
//   Cv(tt, wpitch, n0, N, group)  the state of transform thread tt (0 ..
//                       223) of the CTA at column n0
//   begin(i, scale, n0, N)  before stage i's waits (its global loads)
//   convert(w, b, wpitch)  the stored tile at shared address w -> the B
//                       buffer b
// The kernel's parameters go to begin and convert at each call instead of
// living in the policy: read from the constant bank, they cost the
// transform no registers (copied into G4's policy, they made G4 1.7%
// slower on the H100).
// No atomics and no split of K across CTAs: the order of every sum is fixed,
// so two launches give the same bits.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "hopper.cuh"

namespace vc {
namespace wide {

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int STAGES = 4;  // each TMA ring: x tiles, stored w tiles
constexpr int BST = 3;     // the converted bf16 w tiles
constexpr int NT = 512;    // TMA warp and transform warps (warpgroups 0, 1), two consumer warpgroups
constexpr int TRANSFORM_THREADS = 224;  // warps 1 .. 7
constexpr int QUARTERS = TRANSFORM_THREADS / 8;
constexpr int X_BYTES = BM * BK * 2;  // 16 KB
constexpr int B_BYTES = BK * BN * 2;  // 32 KB: four [64 K][64 N] swizzled blocks

// byte offset in a B buffer of the first 16-byte chunk (columns 8 * (2h) ..
// +7) of row k: block h / 4 of 64 columns, 128-byte rows, chunks XORed with
// k % 8; the second chunk (columns 16h + 8 ..) is its neighbour, offset ^ 16
__device__ __forceinline__ int b_offset(int k, int h) {
  return (h >> 2) * (BK * 128) + k * 128 + ((((2 * h) & 7) ^ (k & 7)) << 4);
}

template <class Cv>
struct Layout {
  static constexpr int W_BYTES = Cv::W_ROWS * BN;
  static constexpr int SM_X = 0, SM_W = STAGES * X_BYTES, SM_B = SM_W + STAGES * W_BYTES;
  // the barriers: xfull[STAGES], xempty[STAGES], wfull[STAGES], wempty[STAGES], bfull[BST], bempty[BST]
  static constexpr int SM_BAR = SM_B + BST * B_BYTES;
  static constexpr size_t SMEM = SM_BAR + 8 * (4 * STAGES + 2 * BST) + 1024;
  static_assert(SM_B % 1024 == 0, "the swizzled B buffers start on 1024-byte boundaries");
  static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
  // setmaxnreg from the 128 registers a thread has at launch (512 threads,
  // one CTA an SM)
  static_assert(256 * (128 - Cv::TRANSFORM_REGS) >= 256 * (Cv::CONSUMER_REGS - 128), "registers over-committed");
};

// wpitch: the bytes of one stored w row in shared memory (the w box's width:
// 256, or N where N < 256); x_bytes: what TMA brings of an x tile
template <class Cv, typename OutT>
__global__ void __launch_bounds__(NT, 1)
    matmul_wide(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const float* __restrict__ scale, OutT* __restrict__ y, int M, int N, int K, int group, int wpitch,
                uint32_t x_bytes) {
  using L = Layout<Cv>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t xfull = base + L::SM_BAR, xempty = xfull + 8 * STAGES, wfull = xempty + 8 * STAGES,
                 wempty = wfull + 8 * STAGES, bfull = wempty + 8 * STAGES, bempty = bfull + 8 * BST;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, nk = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(xfull + 8 * s, 1);  // a TMA thread, with the bytes
      mbar_init(wfull + 8 * s, 1);
      mbar_init(xempty + 8 * s, 256);  // every consumer thread
      mbar_init(wempty + 8 * s, TRANSFORM_THREADS);
    }
    for (int b = 0; b < BST; ++b) {
      mbar_init(bfull + 8 * b, TRANSFORM_THREADS);
      mbar_init(bempty + 8 * b, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg < 2) {
    setmaxnreg_dec<Cv::TRANSFORM_REGS>();
    if (threadIdx.x < 32) {  // ------------------------------------------------ TMA
      // two rings, each freed by its own readers (x by the consumers, w by
      // the transform): lane 0 streams x, lane 1 w
      if (threadIdx.x < 2) {
        const bool is_x = threadIdx.x == 0;
        const uint32_t ful = is_x ? xfull : wfull, emp = is_x ? xempty : wempty;
        const uint32_t bytes = is_x ? x_bytes : Cv::W_ROWS * wpitch;
        Slot<STAGES> sl;
        for (int i = 0; i < nk; ++i, sl.next()) {
          if (i >= STAGES) mbar_wait(emp + 8 * sl.s, sl.phase ^ 1);
          const uint32_t f = ful + 8 * sl.s;
          mbar_arrive_expect_tx(f, bytes);
          if (is_x)
            tma_load_3d(base + L::SM_X + sl.s * X_BYTES, &tx, i * BK, m0, 0, f);
          else
            tma_load_3d(base + L::SM_W + sl.s * L::W_BYTES, &tw, n0, i * Cv::W_ROWS, 0, f);
        }
      }
    } else {  // ------------------------------------------------ transform
      Cv cv(threadIdx.x - 32, wpitch, n0, N, group);
      Slot<STAGES> sl;
      for (int i = 0; i < nk; ++i, sl.next()) {
        cv.begin(i, scale, n0, N);
        const int bb = i % BST;
        if (i >= BST) mbar_wait(bempty + 8 * bb, (i / BST - 1) & 1);
        mbar_wait(wfull + 8 * sl.s, sl.phase);
        cv.convert(base + L::SM_W + sl.s * L::W_BYTES, base + L::SM_B + bb * B_BYTES, wpitch);
        fence_proxy_async();  // the B buffer is read by wgmma (the async proxy)
        mbar_arrive(bfull + 8 * bb);
        mbar_arrive(wempty + 8 * sl.s);
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<Cv::CONSUMER_REGS>();
    const int c = wg - 2;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    Slot<STAGES> sl, prev;
    for (int i = 0; i < nk; ++i, sl.next()) {
      const int bb = i % BST;
      mbar_wait(xfull + 8 * sl.s, sl.phase);
      mbar_wait(bfull + 8 * bb, (i / BST) & 1);
      const uint32_t xa = base + L::SM_X + sl.s * X_BYTES, ba = base + L::SM_B + bb * B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t a = desc_kmajor<BM>(xa, 64 * c, kk);
        wgmma_m64n128_ss_tb(acc, a, desc_mnmajor<BK>(ba, kk));
        wgmma_m64n128_ss_tb(acc + 64, a, desc_mnmajor<BK>(ba + 2 * BK * 128, kk));
      }
      wgmma_commit();
      if (i > 0) {  // the stage before is done: free its x and its bf16 buffer
        wgmma_wait<1>();
        fence_operands<128>(acc);
        mbar_arrive(xempty + 8 * prev.s);
        mbar_arrive(bempty + 8 * ((i - 1) % BST));
        prev.next();
      }
    }
    wgmma_wait0();
    fence_operands<128>(acc);

    // epilogue: acc (* scale[n]) in fp32, one rounding to OutT; N is a
    // multiple of 16, so a live column pair is whole
    const int tid = threadIdx.x % 128, t = tid % 4;
    const int row = m0 + 64 * c + 16 * (tid / 32) + (tid % 32) / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= N) break;
      float s0 = 1.0f, s1 = 1.0f;
      if constexpr (Cv::EPILOGUE_SCALE) {
        s0 = __ldg(scale + col);
        s1 = __ldg(scale + col + 1);
      }
      if (row < M) store2(y + (size_t)row * N + col, acc[4 * j] * s0, acc[4 * j + 1] * s1);
      if (row + 8 < M) store2(y + (size_t)(row + 8) * N + col, acc[4 * j + 2] * s0, acc[4 * j + 3] * s1);
    }
  }
}

// x (M, K) bf16, w the stored (K / Cv::PACK, N) bytes row-major; returns a
// cudaError_t or CUresult (0 on success)
template <class Cv, typename OutT>
int launch_wide(const void* x, const void* w, const float* scale, OutT* y, int M, int N, int K, int group,
                cudaStream_t s) {
  using L = Layout<Cv>;
  CUtensorMap m[2];
  const int xrows = M < BM ? M : BM, wpitch = N < BN ? N : BN;  // boxes no larger than the tensor
  {  // x (M, K) bf16: boxes of 64 K x 128 rows, 128-byte swizzle
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
    const cuuint32_t box[3] = {BK, (cuuint32_t)xrows, 1};
    int err = encode_map(&m[0], x, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  {  // w: boxes of 256 N (or N) bytes x W_ROWS stored rows, row-major
    const cuuint64_t rows = (cuuint64_t)K / Cv::PACK;
    const cuuint64_t dims[3] = {(cuuint64_t)N, rows, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)N, rows * N};
    const cuuint32_t box[3] = {(cuuint32_t)wpitch, Cv::W_ROWS, 1};
    int err = encode_map(&m[1], w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_DATA_TYPE_UINT8);
    if (err) return err;
  }
  cudaError_t e =
      cudaFuncSetAttribute(matmul_wide<Cv, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  matmul_wide<Cv, OutT><<<grid, NT, L::SMEM, s>>>(m[0], m[1], scale, y, M, N, K, group, wpitch,
                                                  (uint32_t)(xrows * BK * 2));
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace vc
