// Kernel A: RoPE flash attention of every FLUX block (D = 128).
//
// Replaces visualcloze_tpu/ops/flash_attention.py:flash_mha_rope, i.e. the
// Pallas bodies _flash_kernel_pipe_rope (pipelined forward) and
// _flash_kernel_rope (blocked forward): one function, one kernel pair here.
// q, k, v (B, H, L, 128) bf16, unrotated, half RoPE layout; bias (B, L) fp32
// (0 / -1e30) or null; cos/sin (B, L, 64) fp32.
//
// Function, in the log2 domain as in JAX: rot(x) = [cos*x1 - sin*x2 |
// cos*x2 + sin*x1] in fp32; q' = bf16(rot(q) * scale*log2(e)),
// k' = bf16(rot(k)); S = q'.k'^T + bias*log2(e) in fp32; an online row max
// starting at -1e30; P = exp2(S - max) rounded to bf16 before P.V; rows
// whose keys are all masked give 0.
//
// Bound on the H100: 4*B*H*L^2*128 FLOPs -> about 0.20 ms at L = 3968 and
// 0.26 ms at L = 4608 (B = 1, H = 24) at 989 TFLOP/s; compute-bound.
//
// Design:
//   - rope_rotate rotates (and scales) q and k ONCE into bf16 scratch: about
//     25 MB each way at L = 3968, against the ~3 GB of L2 reads that
//     rotating every k tile in every q-tile CTA from the fp32 tables costs;
//   - flash_fwd: one CTA of 8 warps per 128 query rows, each warp owning 16
//     rows (the FlashAttention-2 split); mma.sync m16n8k16 bf16 with fp32
//     accumulation; S, P and the (16, 128) output accumulator of a warp stay
//     in registers (the S accumulator layout of two 8-key tiles IS the A
//     operand layout of P.V); K and V tiles of 64 keys are double-buffered in
//     shared memory with cp.async, so the next tile loads while this one
//     computes; V's B operand comes through ldmatrix.trans;
//   - the TPU's ping-pong s-tile pipeline and pipelined/blocked split do not
//     carry over: one kernel takes every length, ragged edges masked.
#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

using vc::bf16;
using vc::pack8;
using vc::unpack8;

constexpr int D = 128;
constexpr int NWARPS = 8, NT = NWARPS * 32;
constexpr int BQ = 16 * NWARPS;  // query rows per CTA
constexpr int BK = 64;           // keys per tile
constexpr int LDS = D + 8;       // bf16 smem row stride: 272 bytes, conflict-free fragment loads
constexpr size_t SMEM = (size_t)(BQ + 4 * BK) * LDS * 2;  // Q + 2 x (K, V)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// q' = bf16(rot(q) * qscale), k' = bf16(rot(k)); one thread per 8 channel pairs
__global__ void __launch_bounds__(256)
    rope_rotate(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                bf16* __restrict__ qr, bf16* __restrict__ kr, int H, int L, float qscale,
                long long units) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  const int c = (int)(u % (D / 16)) * 8;
  const long long row = u / (D / 16);  // over (B, H, L)
  const int l = (int)(row % L);
  const int b = (int)(row / ((long long)H * L));
  const float* cp = cos_t + ((size_t)b * L + l) * (D / 2) + c;
  const float* sp = sin_t + ((size_t)b * L + l) * (D / 2) + c;
  float cs[8], sn[8];
  *reinterpret_cast<float4*>(cs) = *reinterpret_cast<const float4*>(cp);
  *reinterpret_cast<float4*>(cs + 4) = *reinterpret_cast<const float4*>(cp + 4);
  *reinterpret_cast<float4*>(sn) = *reinterpret_cast<const float4*>(sp);
  *reinterpret_cast<float4*>(sn + 4) = *reinterpret_cast<const float4*>(sp + 4);
  const size_t off = (size_t)row * D + c;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const bf16* src = t == 0 ? q : k;
    bf16* dst = t == 0 ? qr : kr;
    const float scale = t == 0 ? qscale : 1.0f;
    float x1[8], x2[8], r1[8], r2[8];
    unpack8(*reinterpret_cast<const uint4*>(src + off), x1);
    unpack8(*reinterpret_cast<const uint4*>(src + off + D / 2), x2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r1[i] = (cs[i] * x1[i] - sn[i] * x2[i]) * scale;
      r2[i] = (cs[i] * x2[i] + sn[i] * x1[i]) * scale;
    }
    *reinterpret_cast<uint4*>(dst + off) = pack8(r1);
    *reinterpret_cast<uint4*>(dst + off + D / 2) = pack8(r2);
  }
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + ROWS) of a (L, D) matrix -> shared memory; rows >= L zero
template <int ROWS>
__device__ __forceinline__ void load_async(bf16* dst, const bf16* __restrict__ src, int row0,
                                           int L) {
  for (int u = threadIdx.x; u < ROWS * (D / 8); u += NT) {
    const int r = u / (D / 8);
    const int c = (u % (D / 8)) * 8;
    const int row = row0 + r;
    const bool ok = row < L;
    cp_async16(dst + r * LDS + c, src + (size_t)(ok ? row : 0) * D + c, ok);
  }
}

__global__ void __launch_bounds__(NT)
    flash_fwd(const bf16* __restrict__ qr, const bf16* __restrict__ kr,
              const bf16* __restrict__ v, const float* __restrict__ bias,
              bf16* __restrict__ o, int H, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks[2] = {Qs + BQ * LDS, Qs + (BQ + 2 * BK) * LDS};
  bf16* Vs[2] = {Qs + (BQ + BK) * LDS, Qs + (BQ + 3 * BK) * LDS};

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const size_t head = ((size_t)b * H + blockIdx.y) * (size_t)L * D;
  const float* biasb = bias ? bias + (size_t)b * L : nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int nk = (L + BK - 1) / BK;

  load_async<BQ>(Qs, qr + head, q0, L);
  load_async<BK>(Ks[0], kr + head, 0, L);
  load_async<BK>(Vs[0], v + head, 0, L);
  cp_async_commit();

  uint32_t qa[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8 of this warp
  float l[2] = {0.0f, 0.0f};

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {  // the next tile loads while this one computes
      load_async<BK>(Ks[cur ^ 1], kr + head, (kt + 1) * BK, L);
      load_async<BK>(Vs[cur ^ 1], v + head, (kt + 1) * BK, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
      const bf16* qw = Qs + warp * 16 * LDS;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qa[kk][0] = ld32(qw + g * LDS + kk * 16 + 2 * t);
        qa[kk][1] = ld32(qw + (g + 8) * LDS + kk * 16 + 2 * t);
        qa[kk][2] = ld32(qw + g * LDS + kk * 16 + 8 + 2 * t);
        qa[kk][3] = ld32(qw + (g + 8) * LDS + kk * 16 + 8 + 2 * t);
      }
    }

    // S = q'.k'^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const bf16* kp = Ks[cur] + (j * 8 + g) * LDS + kk * 16 + 2 * t;
        mma16816(s[j], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }

    // bias, ragged edge, online max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BK + j * 8 + 2 * t + (e & 1);
        float val = s[j][e];
        if (key >= L) {
          val = -INFINITY;
        } else if (biasb) {
          val += __ldg(biasb + key) * kLog2e;
        }
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // P = exp2(S - m) in fp32 for the row sums, bf16 for P.V
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = exp2f(s[j][0] - m[0]);
      const float p1 = exp2f(s[j][1] - m[0]);
      const float p2 = exp2f(s[j][2] - m[1]);
      const float p3 = exp2f(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j / 2][(j & 1) * 2] = pack2(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack2(p2, p3);
    }

    // O += P.V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, Vs[cur] + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + n * 8 + (lane >> 4) * 8);
        mma16816(acc[n], pa[kk], vb[0], vb[1]);
        mma16816(acc[n + 1], pa[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.0f) l[r] = 1.0f;  // fully masked rows -> 0, not NaN
  }
  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(o + head + (size_t)row0 * D + col) =
          pack2(acc[n][0] / l[0], acc[n][1] / l[0]);
    if (row0 + 8 < L)
      *reinterpret_cast<uint32_t*>(o + head + (size_t)(row0 + 8) * D + col) =
          pack2(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
}

}  // namespace

// qr, kr: (B, H, L, 128) bf16 scratch for the rotated q and k. Launches both
// kernels on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int flash_attn_rope(const void* q, const void* k, const void* v, const void* bias,
                               const void* cos_t, const void* sin_t, void* qr, void* kr, void* o,
                               int B, int H, int L, float qscale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long units = (long long)B * H * L * (D / 16);
  rope_rotate<<<(unsigned)((units + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(qr), static_cast<bf16*>(kr), H, L, qscale,
      units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BQ - 1) / BQ, H, B);
  flash_fwd<<<grid, NT, SMEM, s>>>(static_cast<const bf16*>(qr), static_cast<const bf16*>(kr),
                                   static_cast<const bf16*>(v), static_cast<const float*>(bias),
                                   static_cast<bf16*>(o), H, L);
  return (int)cudaGetLastError();
}
