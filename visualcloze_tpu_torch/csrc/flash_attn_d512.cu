// Kernel C: single-head D = 512 flash forward of the VAE bottleneck attention.
//
// Replaces visualcloze_tpu/ops/flash_attention.py:_flash_fwd (Pallas body
// _flash_kernel, fastmax off) as models/autoencoder._flash_fwd_only calls it
// with block_q = 512, block_k = 1024. q, k, v (B, H, L, 512) bf16 (B = H = 1
// on the main path), no bias.
//
// Function, in the log2 domain as in JAX: q' = bf16(q * scale*log2(e));
// S = q'.k^T in fp32; an online row max starting at -1e30; P = exp2(S - max)
// rounded to bf16 before P.V; O / l rounded once to bf16. The order of every
// sum is fixed: two launches on the same inputs give the same bits.
//
// Bound on the H100: 4*L^2*512 FLOPs -> about 0.099 ms at L = 6912 (a
// 384x1152 row) and 0.56 ms at L = 16384 (the 1024^2 SDEdit image) at
// 989 TFLOP/s; compute-bound.
//
// Design (Hopper: TMA, wgmma, warp specialisation, after flash_fwd in
// flash_attn_rope.cu). What makes D = 512 differ from D = 128:
//   - O of 64 query rows x 512 in fp32 is 256 registers a thread, more than a
//     warpgroup has. So a CTA of 384 threads owns 64 query rows, and its two
//     consumer warpgroups split the head dimension: warpgroup c owns columns
//     [256c, 256c + 256) of q, k, v and O (O: 128 registers a thread);
//   - S = q'.K^T is then a sum of two halves: each consumer computes its
//     partial S over its 256 columns (wgmma m64n32k16, q' held in registers
//     as the A operand: 64 registers, loaded once from global memory and
//     scaled on the way), writes it to shared memory, and after one named
//     barrier adds the other's (s0 + s1 in both: the same bits). Both then
//     run the same online softmax on the full S, so each holds the same P
//     as its register A operand of O += P.V (m64n256k16, V MN-major);
//   - shared memory holds no Q: a warp of the producer warpgroup (setmaxnreg
//     24; the consumers 240) streams 32-key K and V tiles (32 KB each, eight
//     64-column boxes, 128-byte swizzle) by TMA into a 3-stage ring with
//     separate full/empty mbarriers; rows past L arrive as zeros and are
//     masked to -inf in the softmax;
//   - one pass with online rescaling (JAX's block_k = 1024 becomes 32-key
//     tiles): per tile S, the exchange and the softmax, then O rescaled and
//     P.V (not skewed: see below). A warp skips the rescale of its 128
//     accumulators when none of its rows' max moved (alpha == 1: the same
//     bits), as it stops moving after the first tiles;
//   - exp2 is one ex2.approx.ftz; fully masked rows cannot occur (L >= 1).
// The grid is (L / 64, H, B): 108 CTAs at L = 6912 (one wave, 82% of the
// SMs), 256 at 16384 (two waves, 97% full).
// Variants measured on the H100 and not kept (PERF.md): flash_fwd's
// skewed loop (S_j issued under P_{j-1}.V_{j-1}: 216 live registers made
// ptxas spill and serialise every wgmma, C7512; 0.337 against 0.264 ms at
// 6912); a 2-CTA cluster multicasting each K and V tile to two query tiles
// (half the L2 reads; 0.279 against 0.267 ms).
#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "hopper.cuh"

namespace {

using namespace vc;

constexpr int D = 512;
constexpr int HALF = D / 2;      // columns per consumer warpgroup
constexpr int NT = 384;          // producer warpgroup + two consumer warpgroups
constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 32;           // keys per tile
constexpr int ST = 3;            // stages of the K/V ring
constexpr int BOX = BK * 128;    // one 64-column box of a tile: BK rows of 128 bytes
constexpr int TILE = D / 64 * BOX;  // a K or V tile: 8 boxes, 32 KB
constexpr int SREGS = BK / 2;    // S accumulator registers a thread (m64n32)
constexpr float kNegInf = -1e30f;

// shared memory (bytes from a 1024-byte aligned base): K[ST], V[ST], the
// partial-S exchange [warpgroup][tile parity][SREGS][128 threads] fp32, then
// the mbarriers K full[ST], V full[ST], K empty[ST], V empty[ST]
constexpr int SM_K = 0, SM_V = ST * TILE, SM_X = 2 * ST * TILE;
constexpr int X_BYTES = 2 * 2 * SREGS * 128 * 4;
constexpr int SM_BAR = SM_X + X_BYTES;
constexpr size_t SMEM = SM_BAR + 8 * 4 * ST + 1024;
static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
enum Ring { K_FULL = 0, V_FULL = 1, K_EMPTY = 2, V_EMPTY = 3 };

constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 * (168 - 24) = 256 * (240 - 168)
constexpr int XBAR = 1;  // named barrier of the two consumer warpgroups

// 2^x with subnormal results flushed to zero (one MUFU.EX2)
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// this thread's A fragments of q' = bf16(q * qscale) for columns [256c,
// 256c + 256) of rows row and row + 8 of the tile (16 k16 steps); rows past
// L are zero
__device__ __forceinline__ void load_q(const bf16* qh, int row, int L, int t, float qscale, uint32_t* qf) {
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row + 8 * (i & 1), col = 16 * kk + 2 * t + 8 * (i >> 1);
      const uint32_t x = r < L ? *reinterpret_cast<const uint32_t*>(qh + (size_t)r * D + col) : 0u;
      qf[4 * kk + i] = scale2(x, qscale);
    }
  }
}

// partial S = q'.K^T over this warpgroup's 256 columns: 16 k16 steps of the
// K tile at ka (its boxes 4c .. 4c + 3)
__device__ __forceinline__ void issue_s(float* sc, const uint32_t* qf, uint32_t ka, int c) {
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk)
    wgmma_m64n32_rs(sc, qf + 4 * kk, desc_kmajor<BK>(ka, 0, HALF / 16 * c + kk), kk > 0);
  wgmma_commit();
}

// O += P.V on this warpgroup's 256 columns: P (64 x BK) in registers, the V
// tile at va (boxes 4c .. 4c + 3, one MN-major B of N = 256)
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t* pa, uint32_t va, int c) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n256_rs_tb(acc, pa + 4 * kk, gmma_desc(va + 4 * c * BOX + kk * 16 * 128, BOX, 1024));
  wgmma_commit();
}

// S += the other warpgroup's partial S of tile j (the exchange buffer of
// warpgroup w and tile parity at xs[(2 * w + parity) * SREGS * 128]): both
// warpgroups end with s0 + s1, the same bits
__device__ __forceinline__ void exchange(float* sc, float* xs, int c, int j, int tid) {
  float* mine = xs + (2 * c + (j & 1)) * SREGS * 128;
  const float* theirs = xs + (2 * (1 - c) + (j & 1)) * SREGS * 128;
#pragma unroll
  for (int r = 0; r < SREGS; ++r) mine[r * 128 + tid] = sc[r];
  named_barrier<XBAR, 256>();
#pragma unroll
  for (int r = 0; r < SREGS; ++r) sc[r] += theirs[r * 128 + tid];
}

// keys from `valid` on masked to -inf, the online row max m (rows g and g + 8
// of the warp; the 4 threads of a row agree), alpha = 2^(m_old - m), and in
// place of S the fp32 P = 2^(S - m), whose row sums update l = l * alpha + sum
__device__ __forceinline__ void softmax(float* sc, int valid, int t, float* m, float* l, float* alpha) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * j + 2 * t + (e & 1) >= valid) sc[4 * j + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[4 * j + e] = exp2_(sc[4 * j + e] - m[e >> 1]);
    l[0] += sc[4 * j] + sc[4 * j + 1];
    l[1] += sc[4 * j + 2] + sc[4 * j + 3];
  }
}

__device__ __forceinline__ void rescale(float* acc, const float* alpha) {
#pragma unroll
  for (int i = 0; i < 128; i += 4) {
    acc[i] *= alpha[0];
    acc[i + 1] *= alpha[0];
    acc[i + 2] *= alpha[1];
    acc[i + 3] *= alpha[1];
  }
}

// P rounded to bf16 pairs as the A operand of P.V: two neighbouring 8-key
// accumulator blocks are one k16 step (hopper.cuh)
__device__ __forceinline__ void pack_p(const float* sc, uint32_t* pa) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    pa[2 * j] = pack2(sc[4 * j], sc[4 * j + 1]);
    pa[2 * j + 1] = pack2(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(NT, 1)
    flash_d512(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
               const bf16* __restrict__ q, bf16* __restrict__ o, int H, int L, float qscale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  auto bar = [&](Ring r, int s) { return base + SM_BAR + 8 * (r * ST + s); };
  auto k_tile = [&](int s) { return base + SM_K + s * TILE; };
  auto v_tile = [&](int s) { return base + SM_V + s * TILE; };

  const int bh = blockIdx.z * H + blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int nk = (L + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar(K_FULL, s), 1);  // the producer, with the TMA bytes
      mbar_init(bar(V_FULL, s), 1);
      mbar_init(bar(K_EMPTY, s), 256);  // every consumer thread
      mbar_init(bar(V_EMPTY, s), 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 0) {  // ------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      Slot<ST> sl;
      for (int kt = 0; kt < nk; ++kt, sl.next()) {
        const int s = sl.s;
        // from the second round on, wait for the release of the stage's last tile
        if (kt >= ST) mbar_wait(bar(K_EMPTY, s), sl.phase ^ 1);
        mbar_arrive_expect_tx(bar(K_FULL, s), TILE);
        for (int b = 0; b < D / 64; ++b) tma_load_3d(k_tile(s) + b * BOX, &tk, 64 * b, kt * BK, bh, bar(K_FULL, s));
        if (kt >= ST) mbar_wait(bar(V_EMPTY, s), sl.phase ^ 1);
        mbar_arrive_expect_tx(bar(V_FULL, s), TILE);
        for (int b = 0; b < D / 64; ++b) tma_load_3d(v_tile(s) + b * BOX, &tv, 64 * b, kt * BK, bh, bar(V_FULL, s));
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;  // this warpgroup's half of the head dimension
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, t = lane % 4;
    const int rq = 16 * (tid / 32) + lane / 4;  // this thread's rows of the tile: rq, rq + 8
    float* xs = reinterpret_cast<float*>(smem + SM_X);

    uint32_t qf[64];  // q', the A operand of the partial S: 16 k16 steps
    load_q(q + (size_t)bh * L * D + (size_t)q0 * D + HALF * c, rq, L - q0, t, qscale, qf);

    float acc[128], sc[SREGS], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];
    uint32_t pa[SREGS / 2];  // P of the tile, the A operand of its P.V
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    Slot<ST> ks;

    // tile j: S_j, the exchange and softmax, then O rescaled and P_j.V_j
    for (int j = 0; j < nk; ++j, ks.next()) {
      mbar_wait(bar(K_FULL, ks.s), ks.phase);
      wgmma_fence();
      issue_s(sc, qf, k_tile(ks.s), c);
      wgmma_wait0();
      fence_operands<SREGS>(sc);
      mbar_arrive(bar(K_EMPTY, ks.s));
      exchange(sc, xs, c, j, tid);
      softmax(sc, L - j * BK, t, m, l, alpha);
      pack_p(sc, pa);
      // O *= alpha, skipped where no row max of the warp moved (alpha == 1 exactly: the same bits)
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) rescale(acc, alpha);
      mbar_wait(bar(V_FULL, ks.s), ks.phase);
      fence_operands<128>(acc);
      wgmma_fence();
      issue_pv(acc, pa, v_tile(ks.s), c);
      wgmma_wait0();
      fence_operands<128>(acc);
      fence_operands<SREGS / 2>(pa);
      mbar_arrive(bar(V_EMPTY, ks.s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (l[r] == 0.0f) l[r] = 1.0f;
    }
    const int row0 = q0 + rq;
    bf16* out = o + (size_t)bh * L * D + HALF * c;
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (row0 < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row0 * D + col) = pack2(acc[4 * j] / l[0], acc[4 * j + 1] / l[0]);
      if (row0 + 8 < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + 8) * D + col) =
            pack2(acc[4 * j + 2] / l[1], acc[4 * j + 3] / l[1]);
    }
  }
}

}  // namespace

// q, k, v, o: (B, H, L, 512) bf16, contiguous, 16-byte aligned. Launches on
// `stream`; returns a cudaError_t (0 on success).
extern "C" int flash_attn_d512(const void* q, const void* k, const void* v, void* o, int B, int H, int L,
                               float qscale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap m[2];
  int err = tensor_map(&m[0], k, L, B * H, D, BK);
  if (!err) err = tensor_map(&m[1], v, L, B * H, D, BK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_d512, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + BQ - 1) / BQ, H, B);
  flash_d512<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], static_cast<const bf16*>(q), static_cast<bf16*>(o), H, L, qscale);
  return (int)cudaGetLastError();
}
