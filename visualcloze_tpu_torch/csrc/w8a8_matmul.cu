// Kernel H: the int8 x int8 matmul of every w8a8 DiT linear.
//
// Replaces the product of visualcloze_tpu/models/layers.py:linear's w8a8
// branch ("a8" entries: einsum s8 x s8 -> s32, then acc * x_scale *
// w_scale), which XLA fuses into one pass; there is no Pallas kernel.
//
//     y[m, n] = bf16((float(sum_k a[m, k] * w[n, k]) * x_scale[m]) * w_scale[n])
//     y[m, n] = bf16(float(y[m, n]) + float(bias[n]))      (with a bf16 bias)
//
// a (M, K) int8 codes of the activations (kernel I), w (N, K) int8: the
// weight K-major, i.e. the JAX entry's (K, N) w_int8 transposed once when the
// linear is quantized or converted, because Hopper's 8-bit wgmma takes both
// operands K-major only. The sums are exact in s32 (|acc| <= 127^2 * 15360
// < 2^31), the convert to fp32 rounds to nearest even (__int2float_rn, as
// XLA's convert), and the two fp32 products keep JAX's order; one rounding
// to bf16, then the bias added as JAX adds it (a bf16 add: an fp32 sum of
// the two bf16 values, rounded to bf16), in the epilogue rather than in a
// pass of its own over the output. So the kernel equals its plain version
// bit for bit, and two launches give the same bits.
//
// Bound on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s): 2*M*N*K operations
// against M*K + N*K + 4*(M + N) + 2*M*N bytes; linear1 at M = 3968
// (K 3072, N 21504): 0.265 ms, by operations.
//
// A warp-specialised wgmma kernel of 384 threads, one 128 x 256 output tile
// a CTA, one CTA an SM:
//   - warp 0 (setmaxnreg 40) issues TMA loads of the codes tile (128 rows x
//     128 K bytes) and the weight tile (256 rows x 128 K bytes) into a
//     4-stage mbarrier ring, both with the 128-byte swizzle, i.e. the
//     K-major wgmma operand layout as TMA writes it; rows past M or N arrive
//     as zeros (or, where M or N is below the box, are never written, and
//     only feed outputs that are not stored);
//   - warpgroups 1 and 2 (setmaxnreg 232) own 64 rows x 256 columns each in
//     s32 (128 registers) and issue four SS m64n256k32 s8 wgmma a stage, one
//     commit group in flight: a stage is freed once the products of the
//     next are issued and its own are done;
//   - the epilogue converts, scales, rounds, adds the bias and stores the
//     rows and columns inside (M, N).
// The CTA index walks M fastest, so the CTAs that run together share weight
// tiles, read from device memory once, while the codes (12 MB at M = 3968,
// K = 3072) stay in the 50 MB L2. No atomics and no split of K: two
// launches give the same bits.
#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "hopper.cuh"

namespace {

using namespace vc;

constexpr int BM = 128, BN = 256, BK = 128;  // BK in int8 elements (bytes): one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int NT = 384;  // the TMA warpgroup, two consumer warpgroups
constexpr int A_BYTES = BM * BK;  // 16 KB
constexpr int B_BYTES = BN * BK;  // 32 KB
constexpr int SM_A = 0, SM_B = STAGES * A_BYTES;
constexpr int SM_BAR = SM_B + STAGES * B_BYTES;  // full[STAGES], empty[STAGES]
constexpr size_t SMEM = SM_BAR + 8 * 2 * STAGES + 1024;
static_assert(SMEM <= 232448, "more shared memory than a CTA may have");

// setmaxnreg from the 168 registers a thread has at launch (384 threads, one
// CTA an SM): 128 * 40 + 256 * 232 <= 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

#define H_R4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define H_R16(d, i) H_R4(d, i), H_R4(d, i + 4), H_R4(d, i + 8), H_R4(d, i + 12)

// d (64 x 256, s32) += A (64 x 32, s8, smem K-major) . B (32 x 256, s8, smem K-major)
__device__ __forceinline__ void wgmma_m64n256k32_s8(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : H_R16(d, 0), H_R16(d, 16), H_R16(d, 32), H_R16(d, 48), H_R16(d, 64), H_R16(d, 80), H_R16(d, 96),
        H_R16(d, 112)
      : "l"(a), "l"(b), "r"(1));
}

#undef H_R16
#undef H_R4

// keeps the compiler from moving accumulator reads across the async MMAs
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// bf16((float(acc) * xs) * ws), then + b as a bf16 add, for a column pair
__device__ __forceinline__ uint32_t out2(int acc0, int acc1, float xs, float ws0, float ws1, float2 b, bool has_bias) {
  float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc0), xs), ws0);
  float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc1), xs), ws1);
  if (has_bias) {
    v0 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v0)), b.x);
    v1 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v1)), b.y);
  }
  return pack2(v0, v1);
}

// a_bytes, b_bytes: what TMA brings of a codes tile and a weight tile
__global__ void __launch_bounds__(NT, 1)
    w8a8_matmul_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                       const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                       const bf16* __restrict__ bias, bf16* __restrict__ y, int M, int N, int K, uint32_t a_bytes,
                       uint32_t b_bytes) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + SM_BAR, empty = full + 8 * STAGES;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, nk = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);     // the TMA thread, with the bytes
      mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 0) {  // ------------------------------------------------ TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      Slot<STAGES> sl;
      for (int i = 0; i < nk; ++i, sl.next()) {
        if (i >= STAGES) mbar_wait(empty + 8 * sl.s, sl.phase ^ 1);
        const uint32_t f = full + 8 * sl.s;
        mbar_arrive_expect_tx(f, a_bytes + b_bytes);
        tma_load_3d(base + SM_A + sl.s * A_BYTES, &ta, i * BK, m0, 0, f);
        tma_load_3d(base + SM_B + sl.s * B_BYTES, &tw, i * BK, n0, 0, f);
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    Slot<STAGES> sl, prev;
    for (int i = 0; i < nk; ++i, sl.next()) {
      mbar_wait(full + 8 * sl.s, sl.phase);
      const uint32_t ta_s = base + SM_A + sl.s * A_BYTES, tb_s = base + SM_B + sl.s * B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)  // 32 bytes of K a product: the bf16 k16 step's bytes
        wgmma_m64n256k32_s8(acc, desc_kmajor<BM>(ta_s, 64 * c, kk), desc_kmajor<BN>(tb_s, 0, kk));
      wgmma_commit();
      if (i > 0) {  // the stage before is done: free it
        wgmma_wait<1>();
        fence_acc(acc);
        mbar_arrive(empty + 8 * prev.s);
        prev.next();
      }
    }
    wgmma_wait0();
    fence_acc(acc);

    // epilogue: (float(acc) * x_scale[m]) * w_scale[n], one rounding to bf16,
    // + bias[n] in bf16; N is a multiple of 16, so a live column pair is whole
    const int tid = threadIdx.x % 128, t = tid % 4;
    const int row = m0 + 64 * c + 16 * (tid / 32) + (tid % 32) / 4;
    const float xs0 = row < M ? __ldg(x_scale + row) : 0.0f;
    const float xs1 = row + 8 < M ? __ldg(x_scale + row + 8) : 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= N) break;
      const float s0 = __ldg(w_scale + col), s1 = __ldg(w_scale + col + 1);
      float2 b = make_float2(0.0f, 0.0f);
      if (bias != nullptr) b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
      if (row < M)
        *reinterpret_cast<uint32_t*>(y + (size_t)row * N + col) =
            out2(acc[4 * j], acc[4 * j + 1], xs0, s0, s1, b, bias != nullptr);
      if (row + 8 < M)
        *reinterpret_cast<uint32_t*>(y + (size_t)(row + 8) * N + col) =
            out2(acc[4 * j + 2], acc[4 * j + 3], xs1, s0, s1, b, bias != nullptr);
    }
  }
}

}  // namespace

// Kernel H. a (M, K) int8, w (N, K) int8, x_scale (M,) fp32, w_scale (N,) fp32,
// bias (N,) bf16 or null, y (M, N) bf16; all contiguous, a and w 16-byte
// aligned, bias 4-byte aligned; K a multiple of 128, N a multiple of 16.
// Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int w8a8_matmul(const void* a, const void* w, const void* x_scale, const void* w_scale, const void* bias,
                           void* y, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || N % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  const int arows = M < BM ? M : BM, brows = N < BN ? N : BN;  // boxes no larger than the tensor
  {  // a (M, K) int8: boxes of 128 K x arows rows, 128-byte swizzle
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)M * K};
    const cuuint32_t box[3] = {BK, (cuuint32_t)arows, 1};
    const int err = encode_map(&maps[0], a, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                               CU_TENSOR_MAP_DATA_TYPE_UINT8);
    if (err) return err;
  }
  {  // w (N, K) int8: boxes of 128 K x brows rows, 128-byte swizzle
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)N * K};
    const cuuint32_t box[3] = {BK, (cuuint32_t)brows, 1};
    const int err = encode_map(&maps[1], w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                               CU_TENSOR_MAP_DATA_TYPE_UINT8);
    if (err) return err;
  }
  const cudaError_t e = cudaFuncSetAttribute(w8a8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  w8a8_matmul_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<const bf16*>(bias), static_cast<bf16*>(y), M, N, K, (uint32_t)(arows * BK), (uint32_t)(brows * BK));
  return (int)cudaGetLastError();
}
