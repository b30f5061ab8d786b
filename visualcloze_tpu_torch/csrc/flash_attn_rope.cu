// Kernels A, D and E: the D = 128 flash attention of every FLUX block.
//
// Kernel A replaces visualcloze_tpu/ops/flash_attention.py:flash_mha_rope, i.e.
// the Pallas bodies _flash_kernel_pipe_rope (pipelined forward) and
// _flash_kernel_rope (blocked forward): q, k, v (B, H, L, 128) bf16,
// unrotated, half RoPE layout; bias (B, L) fp32 (0 / -1e30) or null; cos/sin
// (B, L, 64) fp32. Entry flash_attn_rope.
// Kernel D replaces flash_mha's primal (_flash_kernel_pipe without RoPE, and
// _flash_kernel): the same attention on the caller's pre-rotated q and k.
// Kernel E replaces _fwd_lse_kernel (the forward of flash_mha's VJP): D plus
// the row log-sum-exp in log2 units, lse = m + log2(l) (l = 0 -> 1), stored
// compact as (B, H, Lq) fp32 where the TPU stored a 128-lane broadcast.
// D and E share the entry flash_attn_fwd (lse null -> D); Lq and Lk may differ.
//
// Function, in the log2 domain as in JAX: rot(x) = [cos*x1 - sin*x2 |
// cos*x2 + sin*x1] in fp32 (kernel A only); q' = bf16(q * scale*log2(e)),
// k' = bf16(rot(k)) or k; S = q'.k'^T + bias*log2(e) in fp32; an online row
// max starting at -1e30; P = exp2(S - max) rounded to bf16 before P.V;
// O / l rounded once to bf16; rows whose keys are all masked give 0
// (and lse -1e30). The order of every sum is
// fixed: two launches on the same inputs give the same bits.
//
// Bound on the H100: 4*B*H*Lq*Lk*128 FLOPs -> about 0.20 ms at L = 3968 and
// 0.26 ms at L = 4608 (B = 1, H = 24) at 989 TFLOP/s; compute-bound.
//
// Design:
//   - rope_rotate (kernel A) rotates and scales q and k ONCE into bf16
//     scratch: about 25 MB each way at L = 3968, against the ~3 GB of L2
//     reads that rotating every k tile in every q-tile CTA from the fp32
//     tables costs. D and E skip it and read the caller's q and k. The DiT
//     no longer takes this route: its kernel L writes q and k rotated
//     (models/layers.py) and kernel D attends, so the pass's read and write
//     of q and k are gone. A stays for direct callers of flash_mha_rope and
//     for calibration's plain blocks;
//   - flash_fwd (Hopper: TMA, wgmma, warp specialisation, after
//     FlashAttention-3's forward): a CTA of 384 threads owns 128 query rows
//     of one (b, h). Warpgroup 0 is the producer (setmaxnreg down to 24
//     registers): one warp loads Q once and streams K and V tiles of 128
//     keys by TMA into a 3-stage ring, K and V with their own full and empty
//     mbarriers (a K stage is free once its S and the softmax's read of its
//     bias row are done, a V stage only after P.V), and writes each key
//     tile's bias * log2(e) beside it, -inf past Lk (TMA fills rows past L
//     with zeros, which would score s = 0). Warpgroups
//     1 and 2 (up to 240 registers) own 64 query rows each: each thread
//     reads its A fragments of Q once from the swizzled tile, as q' =
//     bf16(q * qscale) (D and E; A's q comes scaled, qscale = 1), then per
//     key tile S = q'.K^T is wgmma m64n128k16 with q' in registers and K a
//     K-major operand in shared memory, the online softmax runs in registers
//     (a tile inside Lk with no bias adds none), and P, rounded to bf16 in
//     the accumulator layout, is the register A operand of O += P.V
//     (m64n128k16, V an MN-major B). Query rows past Lq are computed and
//     never stored. With both A operands in registers the products read
//     only K and V from shared memory: 64 bytes a tensor-core cycle, where
//     S with q' from shared memory reads 96, beside TMA's 32 of the SM's 128;
//   - the loop is skewed: step j issues S_j, rescales O by the previous
//     tile's alpha while S_j runs, issues P_{j-1}.V_{j-1}, and runs the
//     softmax of S_j as soon as S_j is done (wgmma.wait_group 1), while
//     P_{j-1}.V_{j-1} still runs. The two consumer warpgroups take turns
//     issuing their products (named barriers 3 and 4: ping-pong), so one's
//     softmax (exp2 on the SFU, reductions on the CUDA cores) also overlaps
//     the other's products;
//   - exp2 is one ex2.approx.ftz (a P below 2^-126 is flushed to 0 where
//     exp2f would keep it subnormal: invisible after the sum over keys, and
//     exp2f's subnormal guard costs three instructions an element);
//   - every tile lies in shared memory as TMA writes it (128-byte swizzle,
//     boxes of 64 x 64 of a 3-D map {128, L, B*H}, 1024-byte aligned), read
//     by the wgmma descriptors as it lies (hopper.cuh);
//   - the tensor maps are encoded on the host per call (hopper.cuh:
//     tensor_map); a base pointer that is not 16-byte aligned is refused
//     (cudaErrorMisalignedAddress).
// Variants measured on the H100 and not kept (PERF.md): q' from shared
// memory, 64-key tiles, 2 stages, one wait for both products, exp2f, one
// softmax body that adds the bias row to every tile (+7% without a bias).
#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "hopper.cuh"

namespace {

using namespace vc;

constexpr int D = 128;
constexpr int NT = 384;  // producer warpgroup + two consumer warpgroups
constexpr int BQ = 128;  // query rows per CTA, 64 per consumer warpgroup
constexpr int BK = 128;  // keys per tile
constexpr int ST = 3;    // stages of the K/V ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// shared memory (bytes from a 1024-byte aligned base): Q, K[ST], V[ST],
// bias[ST][BK] fp32, then the mbarriers qbar, K full[ST], V full[ST],
// K empty[ST], V empty[ST]
constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
constexpr int SM_Q = 0, SM_K = Q_BYTES, SM_V = SM_K + ST * KV_BYTES, SM_BIAS = SM_V + ST * KV_BYTES;
constexpr int SM_BAR = SM_BIAS + ST * BK * 4;
constexpr size_t SMEM = SM_BAR + 8 * (1 + 4 * ST) + 1024;
static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
enum Ring { K_FULL = 0, V_FULL = 1, K_EMPTY = 2, V_EMPTY = 3 };

// setmaxnreg: the consumers take what the producer gives up from the 168
// registers a thread has at launch (384 threads a CTA, one CTA an SM)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 * (168 - 24) = 256 * (240 - 168)

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

// this thread's A fragments of S = q'.K^T, q' = bf16(q * qscale) (rows row
// and row + 8 of the Q tile, 8 k16 steps), from the swizzled tile (hopper.cuh)
__device__ __forceinline__ void load_q(const unsigned char* qs, int row, int t, float qscale, uint32_t* qf) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row + 8 * (i & 1), col = 16 * kk + 2 * t + 8 * (i >> 1);
      const int off = (col >> 6) * BQ * 128 + r * 128 + ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
      const uint32_t x = *reinterpret_cast<const uint32_t*>(qs + off);
      qf[4 * kk + i] = qscale != 1.0f ? scale2(x, qscale) : x;
    }
  }
}

// S = q'.K^T: q' of 64 rows in registers x the BK keys of the K tile at ka
__device__ __forceinline__ void issue_s(float* sc, const uint32_t* qf, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n128_rs(sc, qf + 4 * kk, desc_kmajor<BK>(ka, 0, kk), kk > 0);
  wgmma_commit();
}

// O += P.V: P (64 x BK) in registers, the V tile at va as an MN-major B
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t* pa, uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_m64n128_rs_tb(acc, pa + 4 * kk, desc_mnmajor<BK>(va, kk));
  wgmma_commit();
}

// 2^x with subnormal results flushed to zero (one MUFU.EX2)
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S + bias (kBias: a tile without bias inside Lk adds nothing), the online
// row max m (rows g and g + 8 of the warp; the 4 threads of a row agree),
// alpha = 2^(m_old - m), and in place of S the fp32 P = 2^(S - m), whose row
// sums update l = l * alpha + sum
template <bool kBias>
__device__ __forceinline__ void softmax_tile(float* sc, const float* bs, int t, float* m, float* l, float* alpha) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float2 bj = kBias ? *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t) : float2{0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kBias) sc[4 * j + e] += (e & 1) ? bj.y : bj.x;
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

__device__ __forceinline__ void softmax(bool biased, float* sc, const float* bs, int t, float* m, float* l,
                                        float* alpha) {
  if (biased)
    softmax_tile<true>(sc, bs, t, m, l, alpha);
  else
    softmax_tile<false>(sc, bs, t, m, l, alpha);
}

__device__ __forceinline__ void rescale(float* acc, const float* alpha) {
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
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

// the ping-pong: consumer warpgroup c waits for its turn to issue products,
// and hands the turn to the other one after issuing
__device__ __forceinline__ void turn_begin(int c) {
  if (c == 0)
    named_barrier<3, 256>();
  else
    named_barrier<4, 256>();
}

__device__ __forceinline__ void turn_end(int c) {
  if (c == 0)
    named_arrive<4, 256>();
  else
    named_arrive<3, 256>();
}

template <bool kLse>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const float* __restrict__ bias,
              bf16* __restrict__ o, float* __restrict__ lse, int H, int Lq, int Lk, float qscale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  float* bias_s = reinterpret_cast<float*>(smem + SM_BIAS);
  const uint32_t qbar = base + SM_BAR;
  auto bar = [&](Ring r, int s) { return qbar + 8 + 8 * (r * ST + s); };
  auto k_tile = [&](int s) { return base + SM_K + s * KV_BYTES; };
  auto v_tile = [&](int s) { return base + SM_V + s * KV_BYTES; };

  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int nk = (Lk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar(K_FULL, s), 32);    // the producer warp: one arrive with the TMA bytes, 31 after the bias
      mbar_init(bar(V_FULL, s), 1);     // the producer's lane 0, with the TMA bytes
      mbar_init(bar(K_EMPTY, s), 256);  // every consumer thread
      mbar_init(bar(V_EMPTY, s), 256);
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
        mbar_arrive_expect_tx(qbar, Q_BYTES);
        tma_load_tile<BQ>(base + SM_Q, &tq, q0, bh, qbar);
      }
      const float* biasb = bias ? bias + (size_t)b * Lk : nullptr;
      Slot<ST> sl;
      for (int kt = 0; kt < nk; ++kt, sl.next()) {
        const int s = sl.s;
        // from the second round on, wait for the release of the stage's last tile
        if (kt >= ST) mbar_wait(bar(K_EMPTY, s), sl.phase ^ 1);
        for (int i = lane; i < BK; i += 32) {
          const int key = kt * BK + i;
          bias_s[s * BK + i] = key < Lk ? (biasb ? biasb[key] * kLog2e : 0.0f) : -INFINITY;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(bar(K_FULL, s), KV_BYTES);
          tma_load_tile<BK>(k_tile(s), &tk, kt * BK, bh, bar(K_FULL, s));
          if (kt >= ST) mbar_wait(bar(V_EMPTY, s), sl.phase ^ 1);
          mbar_arrive_expect_tx(bar(V_FULL, s), KV_BYTES);
          tma_load_tile<BK>(v_tile(s), &tv, kt * BK, bh, bar(V_FULL, s));
        } else {
          mbar_arrive(bar(K_FULL, s));
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, t = lane % 4;
    const int rq = 64 * c + 16 * (tid / 32) + lane / 4;  // this thread's rows of the tile: rq, rq + 8
    const int row0 = q0 + rq;

    mbar_wait(qbar, 0);
    uint32_t qf[32];  // q', the A operand of S: 8 k16 steps
    load_q(smem + SM_Q, rq, t, qscale, qf);
    if (c == 1) turn_end(c);  // warpgroup 1 issues first

    float acc[64], sc[BK / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];
    uint32_t pa[BK / 4];  // P of the tile before, the A operand of its P.V
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    Slot<ST> ks, vs;  // the K tile of this step, the V tile of the step before

    // a key tile adds its bias row unless there is none and the tile lies inside Lk
    auto biased = [&](int kt) { return bias != nullptr || (kt + 1) * BK > Lk; };

    // step 0: S_0 alone
    mbar_wait(bar(K_FULL, 0), 0);
    turn_begin(c);
    wgmma_fence();
    issue_s(sc, qf, k_tile(0));
    turn_end(c);
    wgmma_wait0();
    fence_operands<BK / 2>(sc);
    softmax(biased(0), sc, bias_s, t, m, l, alpha);
    mbar_arrive(bar(K_EMPTY, 0));  // the stage's K tile and bias row are read
    pack_p(sc, pa);

    // step j: S_j, then O rescaled by alpha of S_{j-1} while S_j runs, then
    // P_{j-1}.V_{j-1}; the softmax of S_j follows the burst
    for (int j = 1; j < nk; ++j) {
      ks.next();
      mbar_wait(bar(K_FULL, ks.s), ks.phase);
      mbar_wait(bar(V_FULL, vs.s), vs.phase);
      turn_begin(c);
      wgmma_fence();
      issue_s(sc, qf, k_tile(ks.s));
      rescale(acc, alpha);
      fence_operands<64>(acc);
      wgmma_fence();
      issue_pv(acc, pa, v_tile(vs.s));
      turn_end(c);
      wgmma_wait<1>();  // S_j is done; P_{j-1}.V_{j-1} may still run
      fence_operands<BK / 2>(sc);
      softmax(biased(j), sc, bias_s + ks.s * BK, t, m, l, alpha);
      mbar_arrive(bar(K_EMPTY, ks.s));  // only now may the producer rewrite the bias row
      wgmma_wait0();
      fence_operands<64>(acc);
      fence_operands<BK / 4>(pa);
      mbar_arrive(bar(V_EMPTY, vs.s));
      vs.next();
      pack_p(sc, pa);
    }

    // the last step: P_{nk-1}.V_{nk-1} alone
    mbar_wait(bar(V_FULL, vs.s), vs.phase);
    turn_begin(c);
    rescale(acc, alpha);
    fence_operands<64>(acc);
    wgmma_fence();
    issue_pv(acc, pa, v_tile(vs.s));
    turn_end(c);
    wgmma_wait0();
    fence_operands<64>(acc);
    fence_operands<BK / 4>(pa);
    if (c == 0) turn_begin(c);  // takes warpgroup 2's last hand-over: every arrive is matched

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (l[r] == 0.0f) l[r] = 1.0f;  // fully masked rows -> 0, not NaN
    }
    bf16* out = o + (size_t)bh * Lq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (row0 < Lq)
        *reinterpret_cast<uint32_t*>(out + (size_t)row0 * D + col) = pack2(acc[4 * j] / l[0], acc[4 * j + 1] / l[0]);
      if (row0 + 8 < Lq)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + 8) * D + col) =
            pack2(acc[4 * j + 2] / l[1], acc[4 * j + 3] / l[1]);
    }
    if (kLse && t == 0) {  // m and l are the same in the 4 threads of a row
      if (row0 < Lq) lse[(size_t)bh * Lq + row0] = m[0] + log2f(l[0]);
      if (row0 + 8 < Lq) lse[(size_t)bh * Lq + row0 + 8] = m[1] + log2f(l[1]);
    }
  }
}

template <bool kLse>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bias, bf16* o, float* lse,
                       int B, int H, int Lq, int Lk, float qscale, cudaStream_t s) {
  CUtensorMap m[3];
  int err = tensor_map(&m[0], q, Lq, B * H);
  if (!err) err = tensor_map(&m[1], k, Lk, B * H);
  if (!err) err = tensor_map(&m[2], v, Lk, B * H);
  if (err) return (cudaError_t)err;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd<kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd<kLse><<<grid, NT, SMEM, s>>>(m[0], m[1], m[2], bias, o, lse, H, Lq, Lk, qscale);
  return cudaGetLastError();
}

}  // namespace

// Kernel A. qr, kr: (B, H, L, 128) bf16 scratch for the rotated (and, for q,
// scaled) q and k, 16-byte aligned. Launches both kernels on `stream`;
// returns a cudaError_t (0 on success).
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
  return (int)launch_fwd<false>(qr, kr, v, static_cast<const float*>(bias), static_cast<bf16*>(o), nullptr, B, H,
                                L, L, 1.0f, s);
}

// Kernels D (lse null) and E: q (B, H, Lq, 128), k, v (B, H, Lk, 128) bf16,
// 16-byte aligned; bias (B, Lk) fp32 or null; o (B, H, Lq, 128) bf16; lse
// (B, H, Lq) fp32.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                              void* lse, int B, int H, int Lq, int Lk, float qscale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(o);
  if (lse == nullptr) return (int)launch_fwd<false>(q, k, v, bp, op, nullptr, B, H, Lq, Lk, qscale, s);
  return (int)launch_fwd<true>(q, k, v, bp, op, static_cast<float*>(lse), B, H, Lq, Lk, qscale, s);
}
