// Kernel C: single-head D = 512 flash forward of the VAE bottleneck attention.
//
// Replaces visualcloze_tpu/ops/flash_attention.py:_flash_fwd (Pallas body
// _flash_kernel, fastmax off) as models/autoencoder._flash_fwd_only calls it
// with block_q = 512, block_k = 1024. q, k, v (B, H, L, 512) bf16 (H = 1 on
// the main path), no bias.
//
// Function, in the log2 domain as in JAX: q is scaled by scale*log2(e) in fp32
// and rounded to bf16; S = q.k^T in fp32; P = exp2(S - rowmax) rounded to
// bf16 before P.V; o = (P.V) / rowsum(P).
//
// Bound on the H100: 4*L^2*512 FLOPs -> about 0.099 ms at L = 6912 (a
// 384x1152 row) and 0.56 ms at L = 16384 (the 1024^2 SDEdit image) at
// 989 TFLOP/s; compute-bound.
//
// Design (right and simple first):
//   - the TPU's 512x1024 blocks do not fit 227 KB of shared memory: one CTA
//     of 8 warps per 32 query rows, a loop over 64-key tiles; Q 33 KB, K and
//     V 67 KB each, S and P 13 KB, ~176 KB in all, opted in above 48 KB with
//     cudaFuncSetAttribute;
//   - bf16 tensor-core tiles through nvcuda::wmma, S staged through shared
//     memory for the softmax;
//   - two passes over the keys: the first finds each row's max, the second
//     forms P with the FINAL max, so P rounds exactly as the one-shot plain
//     version does and the (32, 512) fp32 output accumulator stays in
//     registers (8 16x16 tiles a warp) with no rescaling; the price is a
//     second Q.K^T.
#include <cuda_runtime.h>
#include <mma.h>

#include "bf16.cuh"

namespace {

using vc::bf16;
using vc::pack8;
using vc::unpack8;
namespace wmma = nvcuda::wmma;

constexpr int D = 512, BQ = 32, BK = 64;
constexpr int NWARPS = 8, NT = NWARPS * 32;
// padded row strides (elements): every wmma tile pointer stays 32-byte aligned
constexpr int LDB = D + 8;   // bf16 Q, K, V tiles
constexpr int LDS = BK + 4;  // fp32 S tile
constexpr int LDP = BK + 8;  // bf16 P tile
constexpr int LDO = D + 4;   // fp32 output staging
constexpr int TPR = NT / BQ;  // threads per softmax row
constexpr int CPT = BK / TPR;  // S columns per thread
constexpr int RB = BQ / 16;    // 16-row blocks of the q tile
constexpr int OGROUPS = NWARPS / RB;
constexpr int OCT = (D / 16) / OGROUPS;  // 16x16 O tiles per warp
constexpr int ST_PER_WARP = RB * (BK / 16) / NWARPS;
constexpr size_t SMEM = (size_t)(BQ + 2 * BK) * LDB * 2 + (size_t)BQ * LDS * 4 +
                        (size_t)BQ * LDP * 2 + (size_t)BQ * 4;
constexpr float kNegInf = -1e30f;
static_assert(RB * (BK / 16) % NWARPS == 0, "S tiles must split over warps");
static_assert((size_t)BQ * LDO * 4 <= (size_t)(BQ + BK) * LDB * 2, "O staging must fit Q+K");
static_assert(SMEM <= 232448, "shared memory per block");

// rows [row0, row0 + ROWS) of one head's (L, D) matrix -> shared memory,
// times `scale` (rounded to bf16) unless scale == 1; rows >= L are zero
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int row0, int L,
                                          float scale) {
  constexpr int VPR = D / 8;
  for (int u = threadIdx.x; u < ROWS * VPR; u += NT) {
    const int r = u / VPR;
    const int c = (u % VPR) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < L) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * D + c);
      if (scale != 1.0f) {
        float f[8];
        unpack8(val, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] *= scale;
        val = pack8(f);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDB + c) = val;
  }
}

__device__ __forceinline__ void compute_s(const bf16* Qs, const bf16* Ks, float* Ss, int warp) {
#pragma unroll
  for (int i = 0; i < ST_PER_WARP; ++i) {
    const int t = warp + i * NWARPS;
    const int rb = t / (BK / 16);
    const int cb = t % (BK / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + rb * 16 * LDB + kk * 16, LDB);
      wmma::load_matrix_sync(b, Ks + cb * 16 * LDB + kk * 16, LDB);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Ss + rb * 16 * LDS + cb * 16, acc, LDS, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(NT)
    flash_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int H, int L, float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LDB;
  bf16* Vs = Ks + BK * LDB;
  float* Ss = reinterpret_cast<float*>(Vs + BK * LDB);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * LDS);
  float* row_l = reinterpret_cast<float*>(Ps + BQ * LDP);
  float* Os = reinterpret_cast<float*>(smem);  // epilogue staging over Qs and Ks

  const int q0 = blockIdx.x * BQ;
  const size_t head = ((size_t)blockIdx.z * H + blockIdx.y) * (size_t)L * D;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int srow = tid / TPR;   // softmax row of this thread
  const int spart = tid % TPR;  // its share of the row's columns
  const int nk = (L + BK - 1) / BK;

  load_tile<BQ>(Qs, q + head, q0, L, qscale);

  // pass 1: the row max over all keys, floored at -1e30
  float m = kNegInf;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<BK>(Ks, k + head, kt * BK, L, 1.0f);
    __syncthreads();
    compute_s(Qs, Ks, Ss, warp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = spart * CPT + j;
      if (kt * BK + col < L) m = fmaxf(m, Ss[srow * LDS + col]);
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  // pass 2: P = exp2(S - m) rounded to bf16, O += P.V in registers
  const int rb = warp % RB;
  const int og = warp / RB;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[OCT];
#pragma unroll
  for (int j = 0; j < OCT; ++j) wmma::fill_fragment(oacc[j], 0.0f);
  float l = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<BK>(Ks, k + head, kt * BK, L, 1.0f);
    load_tile<BK>(Vs, v + head, kt * BK, L, 1.0f);
    __syncthreads();
    compute_s(Qs, Ks, Ss, warp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = spart * CPT + j;
      const float p = (kt * BK + col < L) ? exp2f(Ss[srow * LDS + col] - m) : 0.0f;
      l += p;
      Ps[srow * LDP + col] = __float2bfloat16(p);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, Ps + rb * 16 * LDP + kk * 16, LDP);
#pragma unroll
      for (int j = 0; j < OCT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kk * 16 * LDB + (og * OCT + j) * 16, LDB);
        wmma::mma_sync(oacc[j], pa, vb, oacc[j]);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (spart == 0) row_l[srow] = (l == 0.0f) ? 1.0f : l;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < OCT; ++j)
    wmma::store_matrix_sync(Os + rb * 16 * LDO + (og * OCT + j) * 16, oacc[j], LDO,
                            wmma::mem_row_major);
  __syncthreads();
  constexpr int VPR = D / 8;
  for (int u = tid; u < BQ * VPR; u += NT) {
    const int r = u / VPR;
    const int c = (u % VPR) * 8;
    const int row = q0 + r;
    if (row < L) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = Os[r * LDO + c + i] / row_l[r];
      *reinterpret_cast<uint4*>(o + head + (size_t)row * D + c) = pack8(f);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int flash_attn_d512(const void* q, const void* k, const void* v, void* o, int B, int H,
                               int L, float qscale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_d512_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((L + BQ - 1) / BQ, H, B);
  flash_d512_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, L, qscale);
  return (int)cudaGetLastError();
}
