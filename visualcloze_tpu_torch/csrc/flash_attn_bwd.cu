// Kernel F: the flash-attention backward of every FLUX block (D = 128), as two
// kernels split the way the TPU splits it, so that neither needs atomics.
//
// Replaces visualcloze_tpu/ops/flash_attention.py:_pallas_bwd_padded, i.e. the
// Pallas bodies _dq_kernel (F-dq, entry flash_attn_bwd_dq) and _dkv_kernel
// (F-dkv, entry flash_attn_bwd_dkv). q, do (B, H, Lq, 128), k, v (B, H, Lk,
// 128) bf16; bias (B, Lk) fp32 (0 / -1e30) or null; lse, delta (B, H, Lq)
// fp32, lse in log2 units as kernel E stores it, delta = rowsum(do * o). Both
// come in as inputs, so a ring over sequence chunks can pass global ones.
//
// Function, in the log2 domain of the forward: q' = bf16(q * scale*log2(e)),
// s = q'.k^T + bias*log2(e), p = 2^(s - lse), dp = do.v^T, dl = p * (dp - delta)
// in fp32; then
//   dq = scale * bf16(dl).k,  dk = scale * bf16(dl)^T.q (q unscaled),
//   dv = bf16(p)^T.do,
// in fp32 accumulators rounded to bf16 once, as the Pallas kernels round.
// Keys >= Lk get p = 0; query rows >= Lq take no part. Padded query rows inside
// Lq carry do = 0 (the attention wrapper zeroes their outputs), so dl = 0 there.
//
// Bound on the H100 at (1, 24, 3968, 128), 989 TFLOP/s: F-dq does three
// products (q.k^T, do.v^T, dl.k): 6*B*H*Lq*Lk*128 FLOPs, 0.29 ms; F-dkv four
// (k.q^T, v.do^T, p^T.do, dl^T.q): 8*B*H*Lq*Lk*128, 0.39 ms. Compute-bound.
//
// Design (the FlashAttention-2 backward split, simple first):
//   - F-dq: one CTA of 8 warps per 128 query rows, each warp owning 16 rows
//     and its (16, 128) fp32 dq accumulator in registers; K and V tiles of 64
//     keys double-buffered in shared memory with cp.async; S, dP and dl stay
//     in registers, dl's accumulators becoming the A operand of dl.K;
//   - F-dkv: one CTA of 8 warps per 128 keys, each warp owning 16 keys and
//     their (16, 128) dk and dv accumulators (128 fp32 registers); Q and dO
//     tiles of 32 queries double-buffered; S and dP are computed transposed
//     (K.Q'^T, V.dO^T) so that P^T and dl^T come out as A operands;
//   - q' is formed where the Q fragments are read (scale2), never stored;
//   - mma.sync m16n8k16 bf16 with fp32 accumulation throughout; wgmma, TMA
//     and warp specialisation are for a later, faster version.
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "mma.cuh"

namespace {

using namespace vc;

constexpr int D = 128;
constexpr int NWARPS = 8, NT = NWARPS * 32;
constexpr int LDS = D + 8;  // bf16 smem row stride: 272 bytes, conflict-free fragment loads
constexpr float kLog2e = 1.4426950408889634f;

// F-dq tiling
constexpr int DQ_BQ = 16 * NWARPS;  // query rows per CTA
constexpr int DQ_BK = 64;           // keys per tile
constexpr size_t DQ_SMEM = (size_t)(2 * DQ_BQ + 4 * DQ_BK) * LDS * 2;  // Q, dO + 2 x (K, V)

// F-dkv tiling
constexpr int KV_BK = 16 * NWARPS;  // keys per CTA
constexpr int KV_BQ = 32;           // query rows per tile
constexpr size_t KV_SMEM = (size_t)(2 * KV_BK + 4 * KV_BQ) * LDS * 2;  // K, V + 2 x (Q, dO)

// A fragment (16 rows x 16 columns at column 16 kk) of a row-major smem tile
__device__ __forceinline__ void a_frag(uint32_t* a, const bf16* rows, int kk, int g, int t) {
  a[0] = ld32(rows + g * LDS + kk * 16 + 2 * t);
  a[1] = ld32(rows + (g + 8) * LDS + kk * 16 + 2 * t);
  a[2] = ld32(rows + g * LDS + kk * 16 + 8 + 2 * t);
  a[3] = ld32(rows + (g + 8) * LDS + kk * 16 + 8 + 2 * t);
}

__global__ void __launch_bounds__(NT)
    flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const float* __restrict__ bias, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int H, int Lq, int Lk, float qscale, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + DQ_BQ * LDS;
  bf16* Ks[2] = {dOs + DQ_BQ * LDS, dOs + (DQ_BQ + 2 * DQ_BK) * LDS};
  bf16* Vs[2] = {dOs + (DQ_BQ + DQ_BK) * LDS, dOs + (DQ_BQ + 3 * DQ_BK) * LDS};

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * DQ_BQ;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const size_t qhead = bh * (size_t)Lq * D;
  const size_t khead = bh * (size_t)Lk * D;
  const float* biasb = bias ? bias + (size_t)b * Lk : nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int nk = (Lk + DQ_BK - 1) / DQ_BK;

  load_rows_async<DQ_BQ, NT, D, LDS>(Qs, q + qhead, q0, Lq);
  load_rows_async<DQ_BQ, NT, D, LDS>(dOs, dout + qhead, q0, Lq);
  load_rows_async<DQ_BK, NT, D, LDS>(Ks[0], k + khead, 0, Lk);
  load_rows_async<DQ_BK, NT, D, LDS>(Vs[0], v + khead, 0, Lk);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < Lq ? lse[bh * Lq + row] : INFINITY;  // p = 0 beyond Lq
    delta_r[r] = row < Lq ? delta[bh * Lq + row] : 0.0f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const bf16* qw = Qs + warp * 16 * LDS;
  const bf16* dow = dOs + warp * 16 * LDS;

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_rows_async<DQ_BK, NT, D, LDS>(Ks[cur ^ 1], k + khead, (kt + 1) * DQ_BK, Lk);
      load_rows_async<DQ_BK, NT, D, LDS>(Vs[cur ^ 1], v + khead, (kt + 1) * DQ_BK, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = q'.k^T and dP = do.v^T for this warp's 16 rows x 64 keys
    float s[DQ_BK / 8][4], dp[DQ_BK / 8][4];
#pragma unroll
    for (int j = 0; j < DQ_BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      a_frag(a, qw, kk, g, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = scale2(a[i], qscale);
#pragma unroll
      for (int j = 0; j < DQ_BK / 8; ++j) {
        const bf16* kp = Ks[cur] + (j * 8 + g) * LDS + kk * 16 + 2 * t;
        mma16816(s[j], a, ld32(kp), ld32(kp + 8));
      }
      a_frag(a, dow, kk, g, t);
#pragma unroll
      for (int j = 0; j < DQ_BK / 8; ++j) {
        const bf16* vp = Vs[cur] + (j * 8 + g) * LDS + kk * 16 + 2 * t;
        mma16816(dp[j], a, ld32(vp), ld32(vp + 8));
      }
    }

    // p = 2^(s + bias - lse), dl = p * (dp - delta), rounded to bf16 A fragments
    uint32_t da[DQ_BK / 16][4];
#pragma unroll
    for (int j = 0; j < DQ_BK / 8; ++j) {
      float dl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * DQ_BK + j * 8 + 2 * t + (e & 1);
        float p = 0.0f;
        if (key < Lk) {
          float sv = s[j][e];
          if (biasb) sv += __ldg(biasb + key) * kLog2e;
          p = exp2f(sv - lse_r[e >> 1]);
        }
        dl[e] = p * (dp[j][e] - delta_r[e >> 1]);
      }
      da[j / 2][(j & 1) * 2] = pack2(dl[0], dl[1]);
      da[j / 2][(j & 1) * 2 + 1] = pack2(dl[2], dl[3]);
    }

    // dq += dl.K
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(
            kb, Ks[cur] + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + n * 8 + (lane >> 4) * 8);
        mma16816(acc[n], da[kk], kb[0], kb[1]);
        mma16816(acc[n + 1], da[kk], kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < Lq)
      *reinterpret_cast<uint32_t*>(dq + qhead + (size_t)row0 * D + col) =
          pack2(acc[n][0] * scale, acc[n][1] * scale);
    if (row0 + 8 < Lq)
      *reinterpret_cast<uint32_t*>(dq + qhead + (size_t)(row0 + 8) * D + col) =
          pack2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

__global__ void __launch_bounds__(NT)
    flash_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const float* __restrict__ bias, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq, int Lk, float qscale,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + KV_BK * LDS;
  bf16* Qs[2] = {Vs + KV_BK * LDS, Vs + (KV_BK + 2 * KV_BQ) * LDS};
  bf16* dOs[2] = {Vs + (KV_BK + KV_BQ) * LDS, Vs + (KV_BK + 3 * KV_BQ) * LDS};

  const int b = blockIdx.z;
  const int k0 = blockIdx.x * KV_BK;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const size_t qhead = bh * (size_t)Lq * D;
  const size_t khead = bh * (size_t)Lk * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int nq = (Lq + KV_BQ - 1) / KV_BQ;

  load_rows_async<KV_BK, NT, D, LDS>(Ks, k + khead, k0, Lk);
  load_rows_async<KV_BK, NT, D, LDS>(Vs, v + khead, k0, Lk);
  load_rows_async<KV_BQ, NT, D, LDS>(Qs[0], q + qhead, 0, Lq);
  load_rows_async<KV_BQ, NT, D, LDS>(dOs[0], dout + qhead, 0, Lq);
  cp_async_commit();

  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  bool kvalid[2];
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    kvalid[r] = key < Lk;
    kbias[r] = (kvalid[r] && bias) ? bias[(size_t)b * Lk + key] * kLog2e : 0.0f;
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.0f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.0f;
  }
  const bf16* kw = Ks + warp * 16 * LDS;
  const bf16* vw = Vs + warp * 16 * LDS;

  for (int qt = 0; qt < nq; ++qt) {
    const int cur = qt & 1;
    if (qt + 1 < nq) {
      load_rows_async<KV_BQ, NT, D, LDS>(Qs[cur ^ 1], q + qhead, (qt + 1) * KV_BQ, Lq);
      load_rows_async<KV_BQ, NT, D, LDS>(dOs[cur ^ 1], dout + qhead, (qt + 1) * KV_BQ, Lq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = k.q'^T and dP^T = v.do^T for this warp's 16 keys x 32 queries
    float st[KV_BQ / 8][4], dpt[KV_BQ / 8][4];
#pragma unroll
    for (int j = 0; j < KV_BQ / 8; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.0f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      a_frag(a, kw, kk, g, t);
#pragma unroll
      for (int j = 0; j < KV_BQ / 8; ++j) {
        const bf16* qp = Qs[cur] + (j * 8 + g) * LDS + kk * 16 + 2 * t;
        mma16816(st[j], a, scale2(ld32(qp), qscale), scale2(ld32(qp + 8), qscale));
      }
      a_frag(a, vw, kk, g, t);
#pragma unroll
      for (int j = 0; j < KV_BQ / 8; ++j) {
        const bf16* dp = dOs[cur] + (j * 8 + g) * LDS + kk * 16 + 2 * t;
        mma16816(dpt[j], a, ld32(dp), ld32(dp + 8));
      }
    }

    // p^T = 2^(s^T + bias - lse), dl^T = p^T * (dp^T - delta), both as bf16 A fragments
    uint32_t pa[KV_BQ / 16][4], da[KV_BQ / 16][4];
#pragma unroll
    for (int j = 0; j < KV_BQ / 8; ++j) {
      float p[4], dl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qt * KV_BQ + j * 8 + 2 * t + (e & 1);  // query
        const int r = e >> 1;                                  // key row g or g + 8
        const bool ok = kvalid[r] && row < Lq;
        p[e] = ok ? exp2f(st[j][e] + kbias[r] - __ldg(lse + bh * Lq + row)) : 0.0f;
        dl[e] = ok ? p[e] * (dpt[j][e] - __ldg(delta + bh * Lq + row)) : 0.0f;
      }
      pa[j / 2][(j & 1) * 2] = pack2(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack2(p[2], p[3]);
      da[j / 2][(j & 1) * 2] = pack2(dl[0], dl[1]);
      da[j / 2][(j & 1) * 2 + 1] = pack2(dl[2], dl[3]);
    }

    // dv += P^T.dO and dk += dl^T.Q (unscaled q)
#pragma unroll
    for (int kk = 0; kk < KV_BQ / 16; ++kk) {
      const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, dOs[cur] + r * LDS + n * 8 + (lane >> 4) * 8);
        mma16816(dv_acc[n], pa[kk], fb[0], fb[1]);
        mma16816(dv_acc[n + 1], pa[kk], fb[2], fb[3]);
        ldmatrix_x4_trans(fb, Qs[cur] + r * LDS + n * 8 + (lane >> 4) * 8);
        mma16816(dk_acc[n], da[kk], fb[0], fb[1]);
        mma16816(dk_acc[n + 1], da[kk], fb[2], fb[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (kvalid[0]) {
      const size_t off = khead + (size_t)key0 * D + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack2(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack2(dv_acc[n][0], dv_acc[n][1]);
    }
    if (kvalid[1]) {
      const size_t off = khead + (size_t)(key0 + 8) * D + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack2(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack2(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

}  // namespace

// F-dq: dq (B, H, Lq, 128) bf16. qscale = scale * log2(e), scale = 128^-0.5.
// Returns cudaGetLastError() (0 on success).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                                 const void* dout, const void* lse, const void* delta, void* dq, int B,
                                 int H, int Lq, int Lk, float qscale, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + DQ_BQ - 1) / DQ_BQ, H, B);
  flash_bwd_dq<<<grid, NT, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Lq, Lk, qscale, scale);
  return (int)cudaGetLastError();
}

// F-dkv: dk, dv (B, H, Lk, 128) bf16.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* bias,
                                  const void* dout, const void* lse, const void* delta, void* dk,
                                  void* dv, int B, int H, int Lq, int Lk, float qscale, float scale,
                                  void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + KV_BK - 1) / KV_BK, H, B);
  flash_bwd_dkv<<<grid, NT, KV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Lq, Lk,
      qscale, scale);
  return (int)cudaGetLastError();
}
