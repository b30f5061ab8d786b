// Kernel G4: the int4 weight-only matmul of every int4 DiT linear.
//
// Replaces the int4 branch of visualcloze_tpu/models/layers.py:linear
// (:124-133, through quant.dequant_weight_int4 :358), an XLA fusion with no
// Pallas kernel: y = x @ W, x (M, K) bf16, W[k, n] = bf16(q[k, n] *
// scale[k / g, n]) with q the sign-extended nibble of w_int4[k / 2, n]
// (uint8 (K/2, N) row-major, the low nibble the even row k), scale (K/g, N)
// fp32 with g the input-group size. The dequantized weight is JAX's bit for
// bit: an fp32 product, one round-to-nearest-even to bf16, before the MMA
// (the scale varies along K, so it cannot move to the epilogue). The
// products are summed in fp32 and rounded once to the output type (bf16 or
// fp32).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): 2*M*N*K FLOPs against
// 2*M*K + K*N/2 + 4*N*K/g + 2*M*N bytes. At M >= ~300 tokens it is bound by
// operations (linear1 at M = 3968: 0.53 ms); at M = 1 (the modulation and
// embedder linears on the (1, 3072) vector) by the weight bytes (30 MB for a
// double block's modulation: 0.009 ms).
//
// Two bodies behind the one entry point, chosen by M, both G's
// (int8_matmul.cu) with the int4 convert:
//
// Wide M (M > SMALL_M): G's warp-specialised wgmma body
// (weight_only_wide.cuh: a TMA warp, seven transform warps, two consumer
// warpgroups, 128 x 256 tiles) with the int4 policy Int4Convert:
//   - the stored tile is 32 packed rows x 256 N, uint8: the 64 K rows of a
//     stage in half of G's bytes;
//   - the 8 transform warps (setmaxnreg 64) convert it into the bf16 B buffer.
//     A quarter warp takes one packed row, its low or its high nibbles (bf16
//     row 2kp or 2kp + 1), and 8 pieces of 16 columns (lane s8 the piece 8b
//     + s8): one 16-byte read, 16 nibbles, each sign-extended exactly (a
//     byte permute into the mantissa of 2^23), multiplied by its column's
//     fp32 scale and rounded with cvt.rn.bf16x2.f32, then two 16-byte
//     stores. The reads of a quarter warp hit 8 distinct 16-byte chunks; its
//     stores would pair up on 4 (a row's two chunks are neighbours in the
//     swizzle), so lanes with bit 2 of s8 set store the row's second chunk
//     first (row 2kp; the first for row 2kp + 1): every store of a quarter
//     warp is free of bank conflicts. The 128 sets of a stage go 4 to each
//     of the 32 quarter warps of a lone CTA; in a pair along M (where it adds
//     no wave) each CTA converts the 64 sets of its half of the stage, 2 a
//     quarter warp, for both CTAs' products, so the convert per MMA halves.
//     A stage lies inside one scale group (g
//     is a multiple of 64), so a thread keeps the 16 scales of its columns
//     in registers and reloads them when the group changes;
//   - the consumers run at setmaxnreg 192, and the epilogue only rounds
//     (given a bias (N,) bf16, bf16 output only: to bf16, then + b[n] in
//     fp32, rounded again, bf16(float(bf16(acc)) + float(b[n])): JAX's
//     linear's bias add, the bf16 `y + b` of the rounded product).
//
// Small M (M <= SMALL_M; in the query only M = 1), int4_gemv: no tensor
// cores. A CTA of 8 warps owns 64 columns; each thread streams 16 columns of
// 4 consecutive packed rows (8 K rows, one scale group) a step with 16-byte
// loads, dequantizes them as above (bf16-rounded, as the MMA sees them) and
// sums against x held in shared memory in fp32; the 64 slices of K are
// reduced in a fixed order; then the bias, as above.
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

// ---------------------------------------------------------------- int4 -> float, exact

// the nibbles of a packed word (four bytes, four columns) as offset codes
// q + 8 in the low nibble of each byte: row 2kp (hi = false) or 2kp + 1
__device__ __forceinline__ uint32_t nibbles(uint32_t w, bool hi) {
  return ((hi ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// byte i of an offset-code word as the exact fp32 q: 2^23 + (q + 8) from a
// byte permute into the mantissa of 2^23, minus 2^23 + 8
__device__ __forceinline__ float nibble_to_f32(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)) - 8388616.0f;
}

// 16 columns of one row (four offset-code words) times their scales ->
// 16 bf16 in two 16-byte chunks (columns 0-7, 8-15): fp32 product, one
// round to nearest even, as JAX's dequant_weight_int4
__device__ __forceinline__ void dequant16(const uint32_t* u, const float* sc, uint4& c0, uint4& c1) {
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = pack2(nibble_to_f32(u[i], 0) * sc[4 * i], nibble_to_f32(u[i], 1) * sc[4 * i + 1]);
    o[2 * i + 1] = pack2(nibble_to_f32(u[i], 2) * sc[4 * i + 2], nibble_to_f32(u[i], 3) * sc[4 * i + 3]);
  }
  c0 = make_uint4(o[0], o[1], o[2], o[3]);
  c1 = make_uint4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ uint4 sel(bool c, const uint4& a, const uint4& b) {
  return make_uint4(c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z, c ? a.w : b.w);
}

__device__ __forceinline__ void load16(const float* p, float* sc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    sc[4 * i] = v.x;
    sc[4 * i + 1] = v.y;
    sc[4 * i + 2] = v.z;
    sc[4 * i + 3] = v.w;
  }
}

// ---------------------------------------------------------------- wide M

// a set: (packed row, its low or high nibbles, half of the 256 columns), 8
// pieces of 16 columns of one bf16 row; a stage has 128, a CTA of a pair
// converts the 64 of its 16 packed rows (its rank's half of the 32)
static_assert(QUARTERS % 2 == 0, "a quarter warp keeps one column half, so its scales, across its sets");

// the int4 policy of the wide body: quarter warp qw (of 32) converts the
// sets qw, qw + 32, ... (< SETS: 4 alone, 2 paired): set = 4 * packed row
// kp + 2 * nibble r + column half b, kp counted in the CTA's share, bf16
// row 2 (row0 + kp) + r; lane s8 the 16 columns 16 h, h = 8b + s8 (b is the
// same for all of a quarter warp's sets), into this CTA's B buffer (the
// body copies a pair's half to the peer). The transform keeps 16 scales in
// registers, 8 more than G's at 56: 256 * (128 - 64) >= 256 * (192 - 128).
// A thread's sets are unrolled (5-9% faster on the H100 than rolled,
// PERF.md; with 28 quarter warps, 5 sets unrolled spilled). The B ring is 4
// deep paired, 3 alone (shared memory).
template <int CL>
struct Int4Convert {
  static constexpr int W_ROWS = BK / 2, PACK = 2, CLUSTER = CL, BST = CL == 2 ? 4 : 3;
  static constexpr int TRANSFORM_REGS = 64, CONSUMER_REGS = 192;
  static constexpr bool EPILOGUE_SCALE = false;
  static constexpr int SETS = W_ROWS / CL * 4, PIECES = (SETS + QUARTERS - 1) / QUARTERS;
  int qw, h, per_group, row0;
  bool live, swap;
  float sc[16];  // the scales of the thread's 16 columns in the current group

  __device__ __forceinline__ Int4Convert(int tt, int wpitch, int n0, int N, int group, int rank)
      : qw(tt / 8), h(8 * ((tt / 8) & 1) + tt % 8), per_group(group / BK), row0(rank * (W_ROWS / CL)) {
    live = 16 * h < wpitch && n0 + 16 * h < N;  // N % 16 == 0: a live piece is whole
    swap = ((tt % 8) >> 2) & 1;                 // store a row's second chunk first
  }

  __device__ __forceinline__ void begin(int i, const float* scale, int n0, int N) {
    if (live && i % per_group == 0) load16(scale + (size_t)(i / per_group) * N + n0 + 16 * h, sc);
  }

  // set qw + QUARTERS * j of the stored share at w4 into the B buffer at bt
  __device__ __forceinline__ void convert_set(int j, uint32_t w4, uint32_t bt, int wpitch) {
    const int set = qw + QUARTERS * j;
    if (set >= SETS) return;
    const int kp = set >> 2, r = (set >> 1) & 1;
    uint4 c0 = make_uint4(0, 0, 0, 0), c1 = c0;
    if (live) {
      const uint4 raw = lds128(w4 + kp * wpitch + 16 * h);
      const uint32_t u[4] = {nibbles(raw.x, r), nibbles(raw.y, r), nibbles(raw.z, r), nibbles(raw.w, r)};
      dequant16(u, sc, c0, c1);
    }
    // row 2kp stores chunk `swap` first, row 2kp + 1 chunk !swap: the
    // chunk index's low bit is then s8 >> 2 for the first and second store
    // alike, its upper bits (s8 % 4) ^ (kp % 4) (row0 is a multiple of 4)
    const bool second_first = r == 0 ? swap : !swap;
    const int wr = b_offset(2 * (row0 + kp) + r, h);
    sts128(bt + (wr ^ (second_first ? 16 : 0)), sel(second_first, c1, c0));
    sts128(bt + (wr ^ (second_first ? 0 : 16)), sel(second_first, c0, c1));
  }

  __device__ __forceinline__ void convert(uint32_t w4, uint32_t bt, int wpitch) {
#pragma unroll
    for (int j = 0; j < PIECES; ++j) convert_set(j, w4, bt, wpitch);
  }
};

// ---------------------------------------------------------------- small M

constexpr int GV_THREADS = 256, GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 64;                // columns a CTA: 4 threads of 16
constexpr int GV_SLICES = GV_THREADS / 4;  // slices of K: block b (8 K rows) goes to slice b % 64
constexpr int GV_ROWS = 4;                 // packed rows a block: 16-byte weight loads in flight a thread
constexpr int GV_KCH = 1024;               // rows of x staged in shared memory at once

// MR rows of x (blockIdx.y * MR ..) against GV_COLS columns of w (blockIdx.x)
template <typename OutT, int MR>
__global__ void __launch_bounds__(GV_THREADS)
    int4_gemv(const bf16* __restrict__ x, const uint8_t* __restrict__ w, const float* __restrict__ scale,
              const bf16* __restrict__ bias, OutT* __restrict__ y, int M, int N, int K, int group) {
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
    for (int b = slice; b < kn / (2 * GV_ROWS); b += GV_SLICES) {
      const int k0 = 2 * GV_ROWS * b;  // the block's first row of x in the chunk
      float sc[16];
      load16(scale + (size_t)((kc + k0) / group) * N + col, sc);
      const uint8_t* wp = w + (size_t)((kc + k0) / 2) * N + col;
      uint4 raw[GV_ROWS];
#pragma unroll
      for (int u = 0; u < GV_ROWS; ++u) raw[u] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)u * N));
#pragma unroll
      for (int u = 0; u < GV_ROWS; ++u) {
        const uint32_t words[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float f[16];
#pragma unroll
          for (int e = 0; e < 16; ++e)  // the bf16 weight the MMA would see, back in fp32 (exact)
            f[e] = __bfloat162float(__float2bfloat16_rn(nibble_to_f32(nibbles(words[e / 4], r), e % 4) * sc[e]));
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float xv = xs[m][k0 + 2 * u + r];
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[m][e] = fmaf(xv, f[e], acc[m][e]);
          }
        }
      }
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
    if (bias != nullptr) v = add_bias(v, __bfloat162float(bias[n0 + cc]));  // bf16 out only
    store1(y + (size_t)(m0 + m) * N + n0 + cc, v);
  }
}

template <typename OutT>
int launch_gemv(const bf16* x, const uint8_t* w, const float* scale, const bf16* bias, OutT* y, int M, int N, int K,
                int group, cudaStream_t s) {
  const int cols = (N + GV_COLS - 1) / GV_COLS;
  if (M == 1)
    int4_gemv<OutT, 1><<<dim3(cols, 1), GV_THREADS, 0, s>>>(x, w, scale, bias, y, M, N, K, group);
  else
    int4_gemv<OutT, 4><<<dim3(cols, (M + 3) / 4), GV_THREADS, 0, s>>>(x, w, scale, bias, y, M, N, K, group);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const void* x, const void* w, const float* scale, const bf16* bias, OutT* y, int M, int N, int K,
           int group, int pair, cudaStream_t s) {
  if (M <= SMALL_M)
    return launch_gemv(static_cast<const bf16*>(x), static_cast<const uint8_t*>(w), scale, bias, y, M, N, K, group,
                       s);
  return launch_wide<Int4Convert>(x, w, scale, bias, y, M, N, K, group, pair, s);
}

}  // namespace

// Kernel G4. x (M, K) bf16, w (K/2, N) uint8 (two codes a byte, the low
// nibble the even row), scale (K/group, N) fp32, bias (N,) bf16 or null, y
// (M, N) bf16 (out_f32 = 0) or fp32 (out_f32 = 1, no bias), x, w, scale and
// y contiguous and 16-byte aligned, bias contiguous; K and group multiples
// of 64, K of group, N a multiple of 16; pair: the wide body's CTAs in
// clusters of two (ops/int8_matmul.py:wide_pairs decides). Launches on
// `stream`; returns a cudaError_t (0 on success).
extern "C" int int4_matmul(const void* x, const void* w, const void* scale, const void* bias, void* y, int M, int N,
                           int K, int group, int out_f32, int pair, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 || K % BK || group % BK || K % group || N % 16 ||
      (out_f32 && bias != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  const bf16* bp = static_cast<const bf16*>(bias);
  if (out_f32) return launch<float>(x, w, sp, nullptr, static_cast<float*>(y), M, N, K, group, pair, s);
  return launch<bf16>(x, w, sp, bp, static_cast<bf16*>(y), M, N, K, group, pair, s);
}
