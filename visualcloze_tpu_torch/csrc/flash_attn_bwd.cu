// Kernel F: the flash-attention backward of every FLUX block (D = 128), as two
// kernels split the way the TPU splits it, so that neither needs atomics.
//
// Replaces visualcloze_tpu/ops/flash_attention.py:_pallas_bwd_padded (:863),
// i.e. the Pallas bodies _dq_kernel (:699; F-dq, entry flash_attn_bwd_dq) and
// _dkv_kernel (:730; F-dkv, entry flash_attn_bwd_dkv). q, do (B, H, Lq, 128),
// k, v (B, H, Lk, 128) bf16; bias (B, Lk) fp32 (0 / -1e30) or null; lse, delta
// (B, H, Lq) fp32, lse in log2 units as kernel E stores it, delta = rowsum(do *
// o). Both come in as inputs, so a ring over sequence chunks can pass global
// ones. Any Lq, Lk >= 1, Lq != Lk allowed.
//
// Function, in the log2 domain of the forward: q' = bf16(q * scale*log2(e)),
// s = q'.k^T + bias*log2(e), p = 2^(s - lse), dp = do.v^T, dl = p * (dp - delta)
// in fp32; then
//   dq = scale * bf16(dl).k,  dk = scale * bf16(dl)^T.q (q unscaled),
//   dv = bf16(p)^T.do,
// in fp32 accumulators rounded to bf16 once, as the Pallas kernels round.
// Keys >= Lk get p = 0 (their bias is -inf here: the zeros TMA fills in would
// give s = 0 and p = 2^-lse); query rows >= Lq read no lse or delta and get
// p = 0 (lse = +inf). Padded query rows inside Lq carry do = 0 (the attention
// wrapper zeroes their outputs), so dl = 0 there; masked keys (bias -1e30) get
// p = 0 and so dk = dv = 0 exactly. The order of every sum is fixed: two
// launches on the same inputs give the same bits.
//
// Bound on the H100 at (1, 24, 3968, 128), 989 TFLOP/s: F-dq does three
// products (q'.k^T, do.v^T, dl.k): 6*B*H*Lq*Lk*128 FLOPs, 0.29 ms; F-dkv four
// (k.q'^T, v.do^T, p^T.do, dl^T.q): 8*B*H*Lq*Lk*128, 0.39 ms. Compute-bound
// (each reads ~0.1 GB).
//
// Design (Hopper: wgmma, TMA, warp specialisation), 384 threads per CTA:
// warpgroup 0 is the producer (setmaxnreg down to 40 registers), warpgroups
// 1 and 2 the consumers (up to 232), each owning 64 rows of the CTA's 128.
//   - F-dq: a CTA owns 128 query rows. Q and dO arrive once by TMA; each
//     consumer scales its 64 rows of Q in place once (q' rounded as above).
//     K and V tiles of 64 keys stream through a 3-stage mbarrier ring that
//     one producer warp fills by TMA, writing the tile's bias * log2(e)
//     (-inf past Lk) beside it. S = q'.K^T and dP = dO.V^T are wgmma
//     m64n64k16 from shared memory; lse and delta of the thread's two rows
//     stay in registers; dl, rounded to bf16 in the accumulator layout, is the
//     register A operand of dQ += dl.K (m64n128k16, K as an MN-major B).
//   - F-dkv: a CTA owns 128 keys; K and V arrive once and stay. Tiles of 64
//     queries (Q, dO, and their lse and delta, +inf / 0 past Lq) stream
//     through the ring. Three producer warps write q' = bf16(q * qscale) of
//     each Q tile into a second buffer (S^T needs q', dK the unscaled q).
//     S^T = K.q'^T and dP^T = V.dO^T from shared memory; P^T and dl^T, rounded
//     in registers, are the A operands of dV += P^T.dO and dK += dl^T.Q with
//     dO and Q as MN-major B.
//   - Every tile is loaded by TMA (128-byte swizzle, boxes of 64 x 64 of a 3-D
//     map {128, L, B*H}, rows past L zero-filled) into 1024-byte aligned
//     shared memory, which the wgmma descriptors read as it lies.
//   - The tensor maps are encoded on the host per call with
//     cuTensorMapEncodeTiled, a driver-API function fetched through the
//     runtime's cudaGetDriverEntryPoint(ByVersion), so the library links no
//     -lcuda; they reach the kernel as __grid_constant__ parameters. A base
//     pointer that is not 16-byte aligned is refused (cudaErrorMisalignedAddress).
#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "hopper.cuh"

namespace {

using namespace vc;

constexpr int NT = 384;  // producer warpgroup + two consumer warpgroups
constexpr int ST = 3;    // stages of the ring (2 stages: F-dkv 0.78 ms instead of 0.69 on the H100)
constexpr int TILE = 128 * 128 * 2, HALF_TILE = 64 * 128 * 2;  // bytes of 128 / 64 rows
constexpr float kLog2e = 1.4426950408889634f;

// F-dq shared memory (bytes from a 1024-byte aligned base)
constexpr int DQ_Q = 0, DQ_DO = TILE, DQ_KV = 2 * TILE;  // stage s: K at DQ_KV + s*2*HALF_TILE, V after
constexpr int DQ_BIAS = DQ_KV + ST * 2 * HALF_TILE;       // [ST][64] fp32
constexpr int DQ_BAR = DQ_BIAS + ST * 64 * 4;             // qbar, full[ST], empty[ST]
constexpr size_t DQ_SMEM = DQ_BAR + 8 * (1 + 2 * ST) + 1024;

// F-dkv shared memory
constexpr int KV_K = 0, KV_V = TILE, KV_STAGE = 2 * TILE;  // stage s: Q, dO, q' (64 rows each)
constexpr int KV_STAGE_BYTES = 3 * HALF_TILE;
constexpr int KV_LSE = KV_STAGE + ST * KV_STAGE_BYTES;  // lse[ST][64], delta[ST][64] fp32
constexpr int KV_BAR = KV_LSE + 2 * ST * 64 * 4;        // kvbar, full[ST], qfull[ST], empty[ST]
constexpr size_t KV_SMEM = KV_BAR + 8 * (1 + 3 * ST) + 1024;

constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 = 384 * 168

// a 16-byte vector of 8 bf16 values of q -> q' = bf16(q * qscale)
__device__ __forceinline__ void scale8(uint4& x, float qscale) {
  x.x = scale2(x.x, qscale);
  x.y = scale2(x.y, qscale);
  x.z = scale2(x.z, qscale);
  x.w = scale2(x.w, qscale);
}

__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ bias, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Lq, int Lk,
                 float qscale, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  float* bias_s = reinterpret_cast<float*>(smem + DQ_BIAS);
  const uint32_t qbar = base + DQ_BAR;
  auto full = [&](int s) { return qbar + 8 + 8 * s; };
  auto empty = [&](int s) { return qbar + 8 + 8 * ST + 8 * s; };

  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const int q0 = blockIdx.x * 128;
  const int nk = (Lk + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 32);    // the producer warp: one arrive with the TMA bytes, 31 after the bias
      mbar_init(empty(s), 256);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 0) {  // ------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(qbar, 2 * TILE);
        tma_load_tile<128>(base + DQ_Q, &tq, q0, bh, qbar);
        tma_load_tile<128>(base + DQ_DO, &tdo, q0, bh, qbar);
      }
      const float* biasb = bias ? bias + (size_t)b * Lk : nullptr;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(empty(s), ((kt / ST) - 1) & 1);
        for (int i = lane; i < 64; i += 32) {
          const int key = kt * 64 + i;
          bias_s[s * 64 + i] = key < Lk ? (biasb ? biasb[key] * kLog2e : 0.0f) : -INFINITY;
        }
        __syncwarp();
        if (lane == 0) {
          const uint32_t kv = base + DQ_KV + s * 2 * HALF_TILE;
          mbar_arrive_expect_tx(full(s), 2 * HALF_TILE);
          tma_load_tile<64>(kv, &tk, kt * 64, bh, full(s));
          tma_load_tile<64>(kv + HALF_TILE, &tv, kt * 64, bh, full(s));
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = 64 * c;
    const int row0 = q0 + r0 + 16 * w + g;  // this thread's rows: row0, row0 + 8
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse_r[r] = row < Lq ? lse[(size_t)bh * Lq + row] : INFINITY;  // p = 0 beyond Lq
      delta_r[r] = row < Lq ? delta[(size_t)bh * Lq + row] : 0.0f;
    }

    // q' = bf16(q * qscale), once: this warpgroup's 64 rows of both halves
    mbar_wait(qbar, 0);
    uint4* qv = reinterpret_cast<uint4*>(smem + DQ_Q);
    for (int u = tid; u < 1024; u += 128) scale8(qv[(u >> 9) * 1024 + c * 512 + (u & 511)], qscale);
    fence_proxy_async();
    if (c == 0)
      named_barrier<1, 128>();
    else
      named_barrier<2, 128>();

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ST;
      mbar_wait(full(s), (kt / ST) & 1);
      const uint32_t qa = base + DQ_Q, doa = qa + DQ_DO;
      const uint32_t ka = base + DQ_KV + s * 2 * HALF_TILE, va = ka + HALF_TILE;

      // S = q'.K^T and dP = dO.V^T: this warpgroup's 64 rows x 64 keys
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64_ss(sc, desc_kmajor<128>(qa, r0, kk), desc_kmajor<64>(ka, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64_ss(dp, desc_kmajor<128>(doa, r0, kk), desc_kmajor<64>(va, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_operands<32>(sc);
      fence_operands<32>(dp);

      // p = 2^(s + bias - lse), dl = p * (dp - delta), rounded to bf16 A operands
      const float* bs = bias_s + s * 64;
      uint32_t da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
        float dl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[4 * j + e] + ((e & 1) ? bj.y : bj.x) - lse_r[e >> 1]);
          dl[e] = p * (dp[4 * j + e] - delta_r[e >> 1]);
        }
        da[j / 2][(j & 1) * 2] = pack2(dl[0], dl[1]);
        da[j / 2][(j & 1) * 2 + 1] = pack2(dl[2], dl[3]);
      }

      // dQ += dl.K
      fence_operands<64>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n128_rs_tb(acc, da[kk], desc_mnmajor<64>(ka, kk));
      wgmma_commit();
      wgmma_wait0();
      fence_operands<64>(acc);
      mbar_arrive(empty(s));
    }

    bf16* out = dq + (size_t)bh * Lq * 128;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      if (row0 < Lq)
        *reinterpret_cast<uint32_t*>(out + (size_t)row0 * 128 + col) = pack2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (row0 + 8 < Lq)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + 8) * 128 + col) =
            pack2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkv(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ bias, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                  int Lq, int Lk, float qscale, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  float* lse_s = reinterpret_cast<float*>(smem + KV_LSE);
  float* delta_s = lse_s + ST * 64;
  const uint32_t kvbar = base + KV_BAR;
  auto full = [&](int s) { return kvbar + 8 + 8 * s; };
  auto qfull = [&](int s) { return kvbar + 8 + 8 * ST + 8 * s; };
  auto empty = [&](int s) { return kvbar + 8 + 16 * ST + 8 * s; };
  auto stage = [&](int s) { return KV_STAGE + s * KV_STAGE_BYTES; };  // Q, dO, q'

  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const int k0 = blockIdx.x * 128;
  const int nq = (Lq + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 32);    // the producer warp: TMA bytes + lse and delta
      mbar_init(qfull(s), 96);   // the three warps that write q'
      mbar_init(empty(s), 256);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 0) {  // ------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {  // TMA and the tile's lse, delta
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(kvbar, 2 * TILE);
        tma_load_tile<128>(base + KV_K, &tk, k0, bh, kvbar);
        tma_load_tile<128>(base + KV_V, &tv, k0, bh, kvbar);
      }
      const float* lseh = lse + (size_t)bh * Lq;
      const float* deltah = delta + (size_t)bh * Lq;
      for (int qt = 0; qt < nq; ++qt) {
        const int s = qt % ST;
        if (qt >= ST) mbar_wait(empty(s), ((qt / ST) - 1) & 1);
        for (int i = lane; i < 64; i += 32) {
          const int row = qt * 64 + i;
          lse_s[s * 64 + i] = row < Lq ? lseh[row] : INFINITY;  // p = 0 beyond Lq
          delta_s[s * 64 + i] = row < Lq ? deltah[row] : 0.0f;
        }
        __syncwarp();
        if (lane == 0) {
          const uint32_t st = base + stage(s);
          mbar_arrive_expect_tx(full(s), 2 * HALF_TILE);
          tma_load_tile<64>(st, &tq, qt * 64, bh, full(s));
          tma_load_tile<64>(st + HALF_TILE, &tdo, qt * 64, bh, full(s));
        } else {
          mbar_arrive(full(s));
        }
      }
    } else {  // q' = bf16(q * qscale) of each Q tile, into the stage's third buffer
      for (int qt = 0; qt < nq; ++qt) {
        const int s = qt % ST;
        mbar_wait(full(s), (qt / ST) & 1);
        const uint4* src = reinterpret_cast<const uint4*>(smem + stage(s));
        uint4* dst = reinterpret_cast<uint4*>(smem + stage(s) + 2 * HALF_TILE);
        for (int u = threadIdx.x - 32; u < HALF_TILE / 16; u += 96) {
          uint4 x = src[u];
          scale8(x, qscale);
          dst[u] = x;
        }
        fence_proxy_async();
        mbar_arrive(qfull(s));
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = 64 * c;
    const int key0 = k0 + r0 + 16 * w + g;  // this thread's keys: key0, key0 + 8
    float kbias[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      kbias[r] = key < Lk ? (bias ? bias[(size_t)b * Lk + key] * kLog2e : 0.0f) : -INFINITY;
    }
    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
    mbar_wait(kvbar, 0);

    for (int qt = 0; qt < nq; ++qt) {
      const int s = qt % ST;
      const uint32_t ph = (qt / ST) & 1;
      mbar_wait(full(s), ph);
      mbar_wait(qfull(s), ph);
      const uint32_t ka = base + KV_K, va = ka + KV_V;
      const uint32_t qa = base + stage(s), doa = qa + HALF_TILE, qsa = qa + 2 * HALF_TILE;

      // S^T = K.q'^T and dP^T = V.dO^T: this warpgroup's 64 keys x 64 queries
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64_ss(st, desc_kmajor<128>(ka, r0, kk), desc_kmajor<64>(qsa, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64_ss(dpt, desc_kmajor<128>(va, r0, kk), desc_kmajor<64>(doa, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_operands<32>(st);
      fence_operands<32>(dpt);

      // p^T = 2^(s^T + bias - lse), dl^T = p^T * (dp^T - delta), as bf16 A operands
      const float* ls = lse_s + s * 64;
      const float* ds = delta_s + s * 64;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
        const float2 dj = *reinterpret_cast<const float2*>(ds + 8 * j + 2 * t);
        float p[4], dl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(st[4 * j + e] + kbias[e >> 1] - ((e & 1) ? lj.y : lj.x));
          dl[e] = p[e] * (dpt[4 * j + e] - ((e & 1) ? dj.y : dj.x));
        }
        pa[j / 2][(j & 1) * 2] = pack2(p[0], p[1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack2(p[2], p[3]);
        da[j / 2][(j & 1) * 2] = pack2(dl[0], dl[1]);
        da[j / 2][(j & 1) * 2 + 1] = pack2(dl[2], dl[3]);
      }

      // dV += P^T.dO and dK += dl^T.Q (unscaled q)
      fence_operands<64>(dv_acc);
      fence_operands<64>(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n128_rs_tb(dv_acc, pa[kk], desc_mnmajor<64>(doa, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n128_rs_tb(dk_acc, da[kk], desc_mnmajor<64>(qa, kk));
      wgmma_commit();
      wgmma_wait0();
      fence_operands<64>(dv_acc);
      fence_operands<64>(dk_acc);
      mbar_arrive(empty(s));
    }

    const size_t head = (size_t)bh * Lk * 128;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key < Lk) {
          const size_t off = head + (size_t)key * 128 + col;
          *reinterpret_cast<uint32_t*>(dk + off) =
              pack2(dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off) = pack2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host

// maps of q, k, v, do; 0 or the first error
int tensor_maps(CUtensorMap* m, const void* q, const void* k, const void* v, const void* dout, int BH, int Lq,
                int Lk) {
  int err = tensor_map(&m[0], q, Lq, BH);
  if (!err) err = tensor_map(&m[1], k, Lk, BH);
  if (!err) err = tensor_map(&m[2], v, Lk, BH);
  if (!err) err = tensor_map(&m[3], dout, Lq, BH);
  return err;
}

}  // namespace

// F-dq: dq (B, H, Lq, 128) bf16. qscale = scale * log2(e), scale = 128^-0.5.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                                 const void* dout, const void* lse, const void* delta, void* dq, int B,
                                 int H, int Lq, int Lk, float qscale, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  int err = tensor_maps(m, q, k, v, dout, B * H, Lq, Lk);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + 127) / 128, H, B);
  flash_bwd_dq<<<grid, NT, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Lq, Lk, qscale, scale);
  return (int)cudaGetLastError();
}

// F-dkv: dk, dv (B, H, Lk, 128) bf16.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* bias,
                                  const void* dout, const void* lse, const void* delta, void* dk,
                                  void* dv, int B, int H, int Lq, int Lk, float qscale, float scale,
                                  void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  int err = tensor_maps(m, q, k, v, dout, B * H, Lq, Lk);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KV_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lk + 127) / 128, H, B);
  flash_bwd_dkv<<<grid, NT, KV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Lq, Lk, qscale,
      scale);
  return (int)cudaGetLastError();
}
