// Kernel G: the int8 weight-only matmul of every quantized DiT linear.
//
// Replaces visualcloze_tpu/ops/int8_matmul.py:int8_matmul (Pallas body
// _kernel): y = x @ (w_int8 * scale), x (M, K) bf16, w_int8 (K, N) int8
// row-major (the JAX layout), scale (N,) fp32; the products are summed in fp32
// and the per-output-channel scale is applied once, in the epilogue, before a
// single rounding to the output type (bf16 or fp32). The int8 -> bf16 (or
// fp32) convert of w is exact (every int8, -128 included, is a bf16 integer),
// so the kernel computes x . w exactly up to the order of the fp32 sums.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): 2*M*N*K FLOPs against
// 2*M*K + K*N + 2*M*N bytes. At M >= ~300 tokens it is bound by operations
// (linear1 at M = 3968: 0.53 ms); at M = 1 (the modulation and embedder
// linears on the (1, 3072) vector) it is a GEMV bound by the weight bytes
// (56.6 MB of int8 for a double block's modulation: 0.017 ms).
//
// Two bodies behind the one entry point, chosen by M:
//
// Wide M (M > SMALL_M), int8_matmul_wide: a warp-specialised wgmma kernel of
// 512 threads, one CTA an SM, one 128 x 256 output tile a CTA:
//   - warp 0 issues TMA loads into two 4-stage mbarrier rings: lane 0 the x
//     tiles (128 rows x 64 K, bf16, 128-byte swizzle: the K-major A operand;
//     rows past M arrive as zeros), lane 1 the raw w tiles (64 K rows x 256
//     N, int8; columns past N arrive as zeros), so w crosses device memory
//     as int8, half the bytes of bf16, and each ring is freed by its own
//     readers (the transform runs ahead of the products by up to 3 stages);
//   - warps 1 .. 7 (setmaxnreg 56, with warp 0) convert each int8 tile once
//     for the CTA, exactly (a byte permute into the mantissa of 2^23, one
//     fp32 subtraction, the upper half of the fp32 bits), into a 3-stage
//     bf16 B buffer in the 128-byte swizzled MN-major layout (four 64-column
//     blocks of 64 rows): a (K, N) row-major tile converted is an MN-major B
//     operand, so no operand is transposed. Their 16-byte shared-memory
//     reads and writes are free of bank conflicts (piece_offsets);
//   - warpgroups 2 and 3 (setmaxnreg 200) own 64 rows x 256 columns each in
//     fp32 (128 registers) and issue SS wgmma, two m64n128k16 a k16 step (x
//     from the ring, K-major; the converted w, MN-major; one m64n256 needs
//     more than the 128 registers ptxas allows a thread of a 512-thread
//     CTA), one commit group in flight: a stage's x and its bf16 buffer are
//     freed once the products of the next stage are issued and the ones
//     reading them are done;
//   - the epilogue scales the sums by scale[n] in fp32 (each scale loaded
//     once per column a thread holds), rounds once and stores the rows and
//     columns inside (M, N);
//   - the CTA index walks M fastest, so the CTAs that run together share
//     weight column tiles (read from device memory once) while x (24 MB at
//     M = 3968) stays in the 50 MB L2.
// On the H100 the convert, not the tensor cores, sets the pace (PERF.md):
// hence seven transform warps, three bf16 buffers and piece offsets
// computed once.
//
// Small M (M <= SMALL_M; in the query only M = 1), int8_gemv: no tensor
// cores. A CTA of 8 warps owns 64 columns; each thread streams 16 int8
// columns of every 64th weight row with 16-byte loads, several in flight,
// against x held in shared memory in fp32 (in chunks of K), and sums in fp32;
// the 64 slices of K are reduced in a fixed order (shuffles within a warp,
// then shared memory across warps), then the same epilogue.
//
// No atomics and no split of K across CTAs: the order of every sum is fixed,
// so two launches give the same bits.
#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "hopper.cuh"

namespace {

using namespace vc;

constexpr int SMALL_M = 16;  // M at or below it takes the GEMV body

// ---------------------------------------------------------------- int8 -> float, exact

// int8 byte i of w as an exact fp32: 2^23 + (b + 128) from a byte permute of
// w ^ 0x80808080 into the mantissa of 2^23, minus 2^23 + 128
__device__ __forceinline__ float int8_to_f32(uint32_t w_offset, int i) {
  return __uint_as_float(__byte_perm(w_offset, 0x4B000000u, 0x7440 | i)) - 8388736.0f;
}

// four int8 -> two bf16 pairs: the upper halves of their exact fp32 values
// (at most 8 significant bits, so the cut is exact)
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t f0 = __float_as_uint(int8_to_f32(u, 0)), f1 = __float_as_uint(int8_to_f32(u, 1));
  const uint32_t f2 = __float_as_uint(int8_to_f32(u, 2)), f3 = __float_as_uint(int8_to_f32(u, 3));
  lo = __byte_perm(f0, f1, 0x7632);
  hi = __byte_perm(f2, f3, 0x7632);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void store2(bf16* y, float a, float b) {
  *reinterpret_cast<uint32_t*>(y) = pack2(a, b);
}

__device__ __forceinline__ void store2(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}

__device__ __forceinline__ void store1(bf16* y, float a) { *y = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store1(float* y, float a) { *y = a; }

// ---------------------------------------------------------------- wide M

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int STAGES = 4;  // each TMA ring: x tiles, raw w tiles
constexpr int BST = 3;     // the converted bf16 w tiles
constexpr int NT = 512;    // TMA warp and transform warps (warpgroups 0, 1), two consumer warpgroups
constexpr int TRANSFORM_THREADS = 224;  // warps 1 .. 7
constexpr int QUARTERS = TRANSFORM_THREADS / 8;
constexpr int PIECES = (128 + QUARTERS - 1) / QUARTERS;  // sets of 8 pieces a quarter warp converts a stage
constexpr int X_BYTES = BM * BK * 2;   // 16 KB
constexpr int W8_BYTES = BK * BN;      // 16 KB
constexpr int B_BYTES = BK * BN * 2;   // 32 KB: four [64 K][64 N] swizzled blocks
constexpr int SM_X = 0, SM_W8 = STAGES * X_BYTES, SM_B = SM_W8 + STAGES * W8_BYTES;
// the barriers: xfull[STAGES], xempty[STAGES], wfull[STAGES], wempty[STAGES], bfull[BST], bempty[BST]
constexpr int SM_BAR = SM_B + BST * B_BYTES;
constexpr size_t SMEM = SM_BAR + 8 * (4 * STAGES + 2 * BST) + 1024;
static_assert(SMEM <= 232448, "more shared memory than a CTA may have");

// setmaxnreg from the 128 registers a thread has at launch (512 threads, one
// CTA an SM): 256 * (128 - 56) >= 256 * (200 - 128)
constexpr int TRANSFORM_REGS = 56, CONSUMER_REGS = 200;

// a stage of a ring and the parity of its current phase
template <int N>
struct Slot {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == N) {
      s = 0;
      phase ^= 1;
    }
  }
};

// A w tile is 64 rows x 16 groups of 16 columns: 1024 pieces in 128 sets
// of 8, set g = (a, b, c) = bits (0-2, 3, 4-6) holding the pieces (row 8a +
// (s ^ c), group 8b + s), s = 0..7. A quarter warp converts a set, its lane
// s8 the piece s = s8, so its reads (row pitch 256) and its swizzled writes
// hit 8 distinct 16-byte chunks. Piece (g, s8) as byte offsets into a w
// tile (rd; -1: columns past the box, zeros) and into a B buffer (wr: the
// first of its two 8-column chunks; the second is the neighbouring chunk,
// wr ^ 16)
__device__ __forceinline__ void piece_offsets(int g, int s8, int wpitch, int& rd, int& wr) {
  const int k = 8 * (g & 7) + (s8 ^ (g >> 4)), h = 8 * ((g >> 3) & 1) + s8;
  rd = 16 * h < wpitch ? k * wpitch + 16 * h : -1;
  wr = (h >> 2) * (BK * 128) + k * 128 + ((((2 * h) & 7) ^ (k & 7)) << 4);
}

// 16 raw int8 -> 16 bf16 at offset wr of the B buffer at bt
__device__ __forceinline__ void store_piece(uint32_t bt, int wr, const uint4& raw) {
  uint4 lo, hi;
  int8x4_to_bf16(raw.x, lo.x, lo.y);
  int8x4_to_bf16(raw.y, lo.z, lo.w);
  int8x4_to_bf16(raw.z, hi.x, hi.y);
  int8x4_to_bf16(raw.w, hi.z, hi.w);
  sts128(bt + wr, lo);
  sts128(bt + (wr ^ 16), hi);
}

// wpitch: the bytes of one raw w row in shared memory (the w box's width:
// 256, or N where N < 256); x_bytes: what TMA brings of an x tile
template <typename OutT>
__global__ void __launch_bounds__(NT, 1)
    int8_matmul_wide(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                     const float* __restrict__ scale, OutT* __restrict__ y, int M, int N, int K, int wpitch,
                     uint32_t x_bytes) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t xfull = base + SM_BAR, xempty = xfull + 8 * STAGES, wfull = xempty + 8 * STAGES,
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
    setmaxnreg_dec<TRANSFORM_REGS>();
    if (threadIdx.x < 32) {  // ------------------------------------------------ TMA
      // two rings, each freed by its own readers (x by the consumers, w by
      // the transform): lane 0 streams x, lane 1 w
      if (threadIdx.x < 2) {
        const bool is_x = threadIdx.x == 0;
        const uint32_t ful = is_x ? xfull : wfull, emp = is_x ? xempty : wempty;
        const uint32_t bytes = is_x ? x_bytes : BK * wpitch;
        Slot<STAGES> sl;
        for (int i = 0; i < nk; ++i, sl.next()) {
          if (i >= STAGES) mbar_wait(emp + 8 * sl.s, sl.phase ^ 1);
          const uint32_t f = ful + 8 * sl.s;
          mbar_arrive_expect_tx(f, bytes);
          if (is_x)
            tma_load_3d(base + SM_X + sl.s * X_BYTES, &tx, i * BK, m0, 0, f);
          else
            tma_load_3d(base + SM_W8 + sl.s * W8_BYTES, &tw, n0, i * BK, 0, f);
        }
      }
    } else {  // ------------------------------------------------ transform
      // quarter warp qw converts the sets qw, qw + 28, ...
      const int tt = threadIdx.x - 32, s8 = tt % 8, qw = tt / 8;
      int rd[PIECES], wr[PIECES];
#pragma unroll
      for (int j = 0; j < PIECES; ++j) {
        piece_offsets(qw + QUARTERS * j, s8, wpitch, rd[j], wr[j]);
        if (qw + QUARTERS * j >= 128) rd[j] = wr[j] = -1;
      }
      Slot<STAGES> sl;
      for (int i = 0; i < nk; ++i, sl.next()) {
        const int bb = i % BST;
        if (i >= BST) mbar_wait(bempty + 8 * bb, (i / BST - 1) & 1);
        mbar_wait(wfull + 8 * sl.s, sl.phase);
        const uint32_t w8 = base + SM_W8 + sl.s * W8_BYTES, bt = base + SM_B + bb * B_BYTES;
        uint4 raw[PIECES];  // all of a stage's loads, then its stores
#pragma unroll
        for (int j = 0; j < PIECES; ++j) raw[j] = rd[j] >= 0 ? lds128(w8 + rd[j]) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < PIECES; ++j)
          if (wr[j] >= 0) store_piece(bt, wr[j], raw[j]);
        fence_proxy_async();  // the B buffer is read by wgmma (the async proxy)
        mbar_arrive(bfull + 8 * bb);
        mbar_arrive(wempty + 8 * sl.s);
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 2;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    Slot<STAGES> sl, prev;
    for (int i = 0; i < nk; ++i, sl.next()) {
      const int bb = i % BST;
      mbar_wait(xfull + 8 * sl.s, sl.phase);
      mbar_wait(bfull + 8 * bb, (i / BST) & 1);
      const uint32_t xa = base + SM_X + sl.s * X_BYTES, ba = base + SM_B + bb * B_BYTES;
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

    // epilogue: acc * scale[n] in fp32, one rounding to OutT; N is a
    // multiple of 16, so a live column pair is whole
    const int tid = threadIdx.x % 128, t = tid % 4;
    const int row = m0 + 64 * c + 16 * (tid / 32) + (tid % 32) / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= N) break;
      const float s0 = __ldg(scale + col), s1 = __ldg(scale + col + 1);
      if (row < M) store2(y + (size_t)row * N + col, acc[4 * j] * s0, acc[4 * j + 1] * s1);
      if (row + 8 < M) store2(y + (size_t)(row + 8) * N + col, acc[4 * j + 2] * s0, acc[4 * j + 3] * s1);
    }
  }
}

template <typename OutT>
int launch_wide(const void* x, const void* w, const float* scale, OutT* y, int M, int N, int K, cudaStream_t s) {
  CUtensorMap m[2];
  const int xrows = M < BM ? M : BM, wpitch = N < BN ? N : BN;  // boxes no larger than the tensor
  {  // x (M, K) bf16: boxes of 64 K x 128 rows, 128-byte swizzle
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
    const cuuint32_t box[3] = {BK, (cuuint32_t)xrows, 1};
    int err = encode_map(&m[0], x, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  {  // w (K, N) int8: boxes of 256 N (or N) x 64 K rows, row-major
    const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
    const cuuint32_t box[3] = {(cuuint32_t)wpitch, BK, 1};
    int err = encode_map(&m[1], w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_DATA_TYPE_UINT8);
    if (err) return err;
  }
  cudaError_t e = cudaFuncSetAttribute(int8_matmul_wide<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_matmul_wide<OutT><<<grid, NT, SMEM, s>>>(m[0], m[1], scale, y, M, N, K, wpitch, (uint32_t)(xrows * BK * 2));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- small M

constexpr int GV_THREADS = 256, GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 64;                    // columns a CTA: 4 threads of 16
constexpr int GV_SLICES = GV_THREADS / 4;      // slices of K: row k goes to slice k % 64
constexpr int GV_KCH = 1024;                   // rows of x staged in shared memory at once
constexpr int GV_UNROLL = 4;                   // 16-byte weight loads in flight a thread

// MR rows of x (blockIdx.y * MR ..) against GV_COLS columns of w (blockIdx.x)
template <typename OutT, int MR>
__global__ void __launch_bounds__(GV_THREADS)
    int8_gemv(const bf16* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
              OutT* __restrict__ y, int M, int N, int K) {
  __shared__ float xs[MR][GV_KCH];
  __shared__ float red[GV_WARPS][MR][GV_COLS];
  const int n0 = blockIdx.x * GV_COLS, m0 = blockIdx.y * MR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = lane % 4, slice = warp * 8 + lane / 4;
  const int col = n0 + 16 * cg;
  const bool live = col < N;  // N is a multiple of 16: a live group is whole

  float acc[MR][16];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[m][e] = 0.0f;

  for (int kc = 0; kc < K; kc += GV_KCH) {
    const int kn = K - kc < GV_KCH ? K - kc : GV_KCH;
    __syncthreads();  // the previous chunk is read
    for (int u = threadIdx.x; u < MR * kn; u += GV_THREADS) {
      const int m = u / kn, k = u % kn;
      xs[m][k] = m0 + m < M ? __bfloat162float(x[(size_t)(m0 + m) * K + kc + k]) : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    const int8_t* wp = w + (size_t)(kc + slice) * N + col;
    for (int k = slice; k < kn; k += GV_UNROLL * GV_SLICES) {
      uint4 raw[GV_UNROLL];
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u)
        if (k + u * GV_SLICES < kn) raw[u] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)u * GV_SLICES * N));
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u) {
        if (k + u * GV_SLICES >= kn) break;
        const uint32_t words[4] = {raw[u].x ^ 0x80808080u, raw[u].y ^ 0x80808080u, raw[u].z ^ 0x80808080u,
                                   raw[u].w ^ 0x80808080u};
        float f[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) f[e] = int8_to_f32(words[e / 4], e % 4);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float xv = xs[m][k + u * GV_SLICES];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[m][e] = fmaf(xv, f[e], acc[m][e]);
        }
      }
      wp += (size_t)GV_UNROLL * GV_SLICES * N;
    }
  }

  // the 8 slices of a warp (lanes 4 apart), then the 8 warps, in a fixed order
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float v = acc[m][e];
      v += __shfl_xor_sync(0xffffffff, v, 4);
      v += __shfl_xor_sync(0xffffffff, v, 8);
      v += __shfl_xor_sync(0xffffffff, v, 16);
      acc[m][e] = v;
    }
  if (lane < 4) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) red[warp][m][16 * cg + e] = acc[m][e];
  }
  __syncthreads();
  for (int u = threadIdx.x; u < MR * GV_COLS; u += GV_THREADS) {
    const int m = u / GV_COLS, cc = u % GV_COLS;
    if (m0 + m >= M || n0 + cc >= N) continue;
    float v = 0.0f;
#pragma unroll
    for (int wi = 0; wi < GV_WARPS; ++wi) v += red[wi][m][cc];
    store1(y + (size_t)(m0 + m) * N + n0 + cc, v * __ldg(scale + n0 + cc));
  }
}

template <typename OutT>
int launch_gemv(const bf16* x, const int8_t* w, const float* scale, OutT* y, int M, int N, int K, cudaStream_t s) {
  const int cols = (N + GV_COLS - 1) / GV_COLS;
  if (M == 1)
    int8_gemv<OutT, 1><<<dim3(cols, 1), GV_THREADS, 0, s>>>(x, w, scale, y, M, N, K);
  else
    int8_gemv<OutT, 4><<<dim3(cols, (M + 3) / 4), GV_THREADS, 0, s>>>(x, w, scale, y, M, N, K);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const void* x, const void* w, const float* scale, OutT* y, int M, int N, int K, cudaStream_t s) {
  if (M <= SMALL_M)
    return launch_gemv(static_cast<const bf16*>(x), static_cast<const int8_t*>(w), scale, y, M, N, K, s);
  return launch_wide(x, w, scale, y, M, N, K, s);
}

}  // namespace

// Kernel G. x (M, K) bf16, w (K, N) int8, scale (N,) fp32, y (M, N) bf16
// (out_f32 = 0) or fp32 (out_f32 = 1), all contiguous and 16-byte aligned;
// K a multiple of 64, N a multiple of 16. Launches on `stream`; returns a
// cudaError_t (0 on success).
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* y, int M, int N, int K,
                           int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  if (out_f32) return launch<float>(x, w, sp, static_cast<float*>(y), M, N, K, s);
  return launch<bf16>(x, w, sp, static_cast<bf16*>(y), M, N, K, s);
}
