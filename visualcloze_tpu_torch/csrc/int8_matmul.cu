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
// Wide M (M > SMALL_M): the shared warp-specialised wgmma body
// (weight_only_wide.cuh: a TMA warp, seven transform warps, two consumer
// warpgroups, 128 x 256 tiles) with the int8 policy Int8Convert:
//   - the stored tile is 64 int8 rows x 256 N, half the bytes of bf16;
//   - the 8 transform warps (setmaxnreg 56) convert it exactly (a byte permute
//     into the mantissa of 2^23, one fp32 subtraction, the upper half of the
//     fp32 bits) into the bf16 B buffer. Their 16-byte shared-memory reads
//     and writes are free of bank conflicts (piece_offsets);
//   - the consumers run at setmaxnreg 200, and the epilogue scales the sums
//     by scale[n] in fp32 (each scale loaded once per column a thread holds)
//     before the one rounding; given a bias (N,) bf16 (bf16 output only),
//     it then adds b[n] as JAX's linear does, bf16(float(bf16(acc *
//     scale[n])) + float(b[n])): the bf16 `y + b` of the rounded product.
// On the H100 the convert, not the tensor cores, sets the pace (PERF.md):
// hence eight transform warps and piece offsets computed once, and the
// CTAs in pairs along M where that adds no wave (each CTA converts half of
// each w tile for both, with a 4-deep B ring; alone, 3 deep).
//
// Small M (M <= SMALL_M; in the query only M = 1), int8_gemv: no tensor
// cores. A CTA of 8 warps owns 64 columns; each thread streams 16 int8
// columns of every 64th weight row with 16-byte loads, several in flight,
// against x held in shared memory in fp32 (in chunks of K), and sums in fp32;
// the 64 slices of K are reduced in a fixed order (shuffles within a warp,
// then shared memory across warps), then the same epilogue (and bias).
//
// No atomics and no split of K across CTAs: the order of every sum is fixed,
// so two launches give the same bits.
#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "hopper.cuh"
#include "weight_only_wide.cuh"

namespace {

using namespace vc;
using namespace vc::wide;

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

// ---------------------------------------------------------------- wide M

// CTAs that share each stored w tile in the wide body: 2 (the pair of
// weight_only_wide.cuh) or 1 (each CTA converts its whole tile)
// A w tile is 64 rows x 16 groups of 16 columns: 1024 pieces in 128 sets
// of 8; a CTA of a pair converts the 64 sets of its 32 rows. Set g = (a, b,
// c), a = g % A (A = 8 / CL row groups of 8 in the CTA's share), b = (g / A)
// % 2, c = g / (2A), holds the pieces (row 8a + (s ^ c), group 8b + s), s =
// 0..7. A quarter warp converts a set, its lane s8 the piece s = s8, so its
// reads (row pitch 256) and its swizzled writes hit 8 distinct 16-byte
// chunks. Piece (g, s8) as byte offsets into the CTA's w share (rd; -1:
// columns past the box, zeros) and into a B buffer (wr: the first of its two
// 8-column chunks; the second is the neighbouring chunk, wr ^ 16), row0 the
// share's first row
template <int CL>
__device__ __forceinline__ void piece_offsets(int g, int s8, int wpitch, int row0, int& rd, int& wr) {
  constexpr int A = 8 / CL;
  const int k = 8 * (g % A) + (s8 ^ (g / (2 * A))), h = 8 * ((g / A) & 1) + s8;
  rd = 16 * h < wpitch ? k * wpitch + 16 * h : -1;
  wr = b_offset(row0 + k, h);
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

// the int8 policy of the wide body: quarter warp qw (of 32) converts the
// sets qw, qw + 32, ... (< 128 / CL: 4 alone, 2 paired), its offsets
// computed once; the B ring is 4 deep paired, 3 alone (shared memory)
template <int CL>
struct Int8Convert {
  static constexpr int W_ROWS = BK, PACK = 1, CLUSTER = CL, BST = CL == 2 ? 4 : 3;
  static constexpr int TRANSFORM_REGS = 56, CONSUMER_REGS = 200;
  static constexpr bool EPILOGUE_SCALE = true;
  static constexpr int SETS = 128 / CL, PIECES = (SETS + QUARTERS - 1) / QUARTERS;
  int rd[PIECES], wr[PIECES];

  __device__ __forceinline__ Int8Convert(int tt, int wpitch, int, int, int, int rank) {
    const int s8 = tt % 8, qw = tt / 8;
#pragma unroll
    for (int j = 0; j < PIECES; ++j) {
      piece_offsets<CL>(qw + QUARTERS * j, s8, wpitch, rank * (BK / CL), rd[j], wr[j]);
      if (qw + QUARTERS * j >= SETS) rd[j] = wr[j] = -1;
    }
  }

  __device__ __forceinline__ void begin(int, const float*, int, int) {}

  __device__ __forceinline__ void convert(uint32_t w8, uint32_t bt, int) {
    uint4 raw[PIECES];  // all of a stage's loads, then its stores
#pragma unroll
    for (int j = 0; j < PIECES; ++j) raw[j] = rd[j] >= 0 ? lds128(w8 + rd[j]) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < PIECES; ++j)
      if (wr[j] >= 0) store_piece(bt, wr[j], raw[j]);
  }
};

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
              const bf16* __restrict__ bias, OutT* __restrict__ y, int M, int N, int K) {
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
    v *= __ldg(scale + n0 + cc);
    if (bias != nullptr) v = add_bias(v, __bfloat162float(bias[n0 + cc]));  // bf16 out only
    store1(y + (size_t)(m0 + m) * N + n0 + cc, v);
  }
}

template <typename OutT>
int launch_gemv(const bf16* x, const int8_t* w, const float* scale, const bf16* bias, OutT* y, int M, int N, int K,
                cudaStream_t s) {
  const int cols = (N + GV_COLS - 1) / GV_COLS;
  if (M == 1)
    int8_gemv<OutT, 1><<<dim3(cols, 1), GV_THREADS, 0, s>>>(x, w, scale, bias, y, M, N, K);
  else
    int8_gemv<OutT, 4><<<dim3(cols, (M + 3) / 4), GV_THREADS, 0, s>>>(x, w, scale, bias, y, M, N, K);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const void* x, const void* w, const float* scale, const bf16* bias, OutT* y, int M, int N, int K,
           int pair, cudaStream_t s) {
  if (M <= SMALL_M)
    return launch_gemv(static_cast<const bf16*>(x), static_cast<const int8_t*>(w), scale, bias, y, M, N, K, s);
  return launch_wide<Int8Convert>(x, w, scale, bias, y, M, N, K, 0, pair, s);
}

}  // namespace

// Kernel G. x (M, K) bf16, w (K, N) int8, scale (N,) fp32, bias (N,) bf16
// or null, y (M, N) bf16 (out_f32 = 0) or fp32 (out_f32 = 1, no bias), x,
// w, scale and y contiguous and 16-byte aligned, bias contiguous; K a
// multiple of 64, N a multiple of 16; pair: the wide body's CTAs in
// clusters of two (ops/int8_matmul.py:wide_pairs decides). Launches on
// `stream`; returns a cudaError_t (0 on success).
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, const void* bias, void* y, int M, int N,
                           int K, int out_f32, int pair, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || N % 16 || (out_f32 && bias != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  const bf16* bp = static_cast<const bf16*>(bias);
  if (out_f32) return launch<float>(x, w, sp, nullptr, static_cast<float*>(y), M, N, K, pair, s);
  return launch<bf16>(x, w, sp, bp, static_cast<bf16*>(y), M, N, K, pair, s);
}
