// Kernel N: the VAE's GroupNorm statistics, its apply (+ swish), and both in
// one launch where a cluster holds the slab.
//
// Replaces XLA fusions, not a Pallas kernel: visualcloze_tpu/models/
// autoencoder.py `group_norm_affine` (:37), the statistics every resnet
// half-block, attention block and norm_out takes, and `group_norm` (:61)
// followed by `swish` where it is not folded into a conv (the attention
// block's norm, :144, and the two norm_outs, :192 and :208).
//
// group_norm_stats: x (B, H, W, C) bf16 NHWC -> a, bb (B, C) fp32, the affine
// y = x * a + bb that kernel B's pre_affine takes. JAX's statistics, in fp32:
//
//     m_c   = sum_hw x / HW                  (per channel)
//     mu_g  = sum_{c in g} m_c / cg          (cg = C / groups)
//     var_g = sum_{hw, c in g} (x - mu_g)^2 / HW / cg
//     a     = rsqrt(var_g + eps) * scale_c,  bb = bias_c - mu_g * a
//
// Two designs, picked by ops/group_norm.py's `stats_plan` from the shape and
// the card (both are this function, both count as kernel N's statistics):
//
// Cluster (entry group_norm_stats_cluster, kernel group_norm_stats_resident),
// where a group block's slab fits the shared memory of a thread-block
// cluster of at most 8 CTAs (the portable size) in rows of 32 bytes or
// more and x is 30 MiB or less: on an H100 the latent and three
// half-resolution levels. One launch, no global scratch, no atomics. A
// cluster takes one batch element and one
// group block: neighbouring groups whose CB = 8 K channels (K a power of
// two up to 32) the plan picks up to 128 bytes a pixel, since the L2
// serves a request for every pixel's row and narrow rows bound the loads
// (4 groups at C = 512, 16 at C = 128 where the slab fits). Its CTAs split
// the pixels evenly. Each copies its share of the slab, pixels x CB bf16,
// into shared memory once (16-byte cp.async through L2, two commit groups
// so that the first half's sums start while the second half lands) and
// sums each channel: thread t owns the 16-byte chunks t, t + 512, ... of
// the slab (chunk i is pixel i / K, channel chunk i % K), so it reads back
// only what it copied itself; then a butterfly over a warp's lanes of the
// same chunk, the 16 warps in order. After a cluster barrier every CTA
// reads the cluster's per-channel sums through distributed shared memory in
// rank order and forms the channel means and the group means (the order
// above). Pass 2 reads the resident slab, not global memory, and subtracts
// the group mean; its sums go through DSMEM again, and rank 0 writes a and
// bb for the block's channels. A last cluster barrier keeps every CTA's
// shared memory alive until rank 0 has read it. Bound: x read once; on the
// H100 a launch and three cluster barriers cost ~5.5 us of the (1, 48,
// 144, 512) call's 8 (PERF.md).
//
// Moments (entry group_norm_stats_moments, kernel group_norm_stats_moments_kernel)
// elsewhere: x read from HBM once, in one launch. Persistent CTAs, about
// one an SM, each take a contiguous run of pixels of one batch element: a
// run of pixels x all C channels is one span of NHWC memory. A producer
// warp streams it in tiles of up to 32 KB by 1-D bulk copies into a ring
// of shared-memory stages (2 measured fastest of 2 to 6; on the H100 the
// stream runs at ~3.3 TB/s, PERF.md); C / 8 x P consumer threads (P = 256 / (C / 8)
// lanes) hold a tile's 16-byte vectors in registers, 8 pixels of 8
// channels a thread, and give the stage back. For each tile a thread forms
// its channels' sums, then the tile's mean of each piece (its channels
// that lie in one group, W = gcd(cg, 8) of them) and the tile's moment
// about that mean, M2_t = sum (x - m_t)^2, from the same registers. It
// merges its tiles in order by the parallel-variance identity (Chan,
// Golub and LeVeque):
//
//     M2 = M2_a + M2_b + (m_b - m_a)^2 n_a n_b / (n_a + n_b)
//
// and the CTA merges its threads' pieces about the CTA's group mean m:
// M2_g = sum_i [M2_i + n_i (m_i - m)^2], lanes in order. It writes one row
// of C channel sums, G group means and G moments. The CTAs form teams of
// ~sqrt(CTAs); the last of a team to arrive (an atomic ticket after a
// __threadfence) merges its team's rows in CTA order by the same identity,
// and the last team merges the teams' rows in order: channel means and
// group means in JAX's order, then var_g from the pooled moment about
// mu_g. Two short levels instead of one CTA reading every row: a row is
// (C + 2G) floats, 2.3 KB at C = 512. The tickets are a device global,
// one slot of them a stream, each wrapped back to 0 by atomicInc as its
// last CTA arrives, so no launch zeroes them.
//
// Numerics: every piece is centred on its own mean before it is squared,
// and every merge adds non-negative moments plus a correction from a
// difference of two means, so nothing like E[x^2] - E[x]^2 cancels; the
// result is as stable as JAX's second pass over x - mu_g, whose value it
// is, summed in another order. All in fp32 (counts of up to 2^24 elements
// are exact). Every sum has a fixed order, so repeats give the same bits.
//
// group_norm_apply: y = act(bf16(x * a + bb)) with act none or swish, swish
// as JAX's bf16 chain rounds it: s = bf16(sigmoid(h)), y = bf16(h * s) on
// the bf16 h. One pass over x, a and bb in registers. sigmoid is one
// ex2.approx and one rcp.approx, not expf and an IEEE division, and the
// roundings to bf16 go two values at a time (`sigmoid`, `apply8` below), so
// that the swish costs little more than its bytes.
//
// group_norm_fused_cluster: the statistics and the apply in one launch where
// the cluster design holds the slab (the VAE's attention-block norm and the
// encoder's norm_out at the latent shapes). After pass 2's barrier every CTA,
// not only rank 0, reads all ranks' sums through DSMEM in rank order, so a
// and bb are the same bits in every CTA (and the same as the statistics
// launch's); each CTA normalises its resident share of the slab as the apply
// does and stores y with 16-byte stores, K neighbouring threads a pixel's
// row of the block. Rank 0 still writes a and bb. Each thread arrives on the
// cluster barrier once its DSMEM reads are done and waits before it exits,
// so the apply runs between the two halves. Bound: x read and y written
// once.
//
// Bound on the H100 (3.35 TB/s): the bytes, x read once: 0.080 ms at (1,
// 1024, 1024, 128). The apply reads x and writes y: 0.160 ms at the same
// shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "approx.cuh"
#include "bf16.cuh"
#include "hopper.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;       // channels a thread: one 16-byte load of bf16
constexpr int THREADS = 256;  // the apply: at most; a CTA is (C / 8) x P threads
constexpr int MAX_C = 2048;   // C / 8 <= THREADS
constexpr int UNROLL = 8;     // the apply: loads in flight a thread

struct Slab {
  int t, p, T, P, c0, start, end;
};

// this thread's channel chunk and lane, and the CTA's pixels [start, end)
__device__ __forceinline__ Slab slab(int HW, int C) {
  Slab s;
  s.T = C / VEC;
  s.P = blockDim.x / s.T;
  s.t = threadIdx.x % s.T;
  s.p = threadIdx.x / s.T;
  s.c0 = s.t * VEC;
  const int per = (HW + gridDim.x - 1) / gridDim.x;
  s.start = blockIdx.x * per;
  s.end = min(HW, s.start + per);
  return s;
}

template <bool SECOND>
__device__ __forceinline__ void accumulate(const uint4& u, const float* mean, float* acc) {
  float f[VEC];
  vc::unpack8(u, f);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (SECOND) {
      const float d = __fsub_rn(f[j], mean[j]);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
    } else {
      acc[j] = __fadd_rn(acc[j], f[j]);
    }
  }
}

// a GroupNorm parameter (C,) in fp32, stored as bf16 (the VAE's) or fp32
__device__ __forceinline__ float param(const void* p, int c, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[c]) : static_cast<const float*>(p)[c];
}

// sigmoid(h) in fp32 of a bf16 value h: 1 / (1 + 2^(-h log2 e)) as one
// ex2.approx and one rcp.approx. 1 / d is subnormal for d >= 2^126 (h below
// about -87.3: -87.5, -88 and -88.5 among bf16 values), which rcp.approx.ftz
// would flush to zero, far from the plain version's h * sigmoid(h) there.
// So the reciprocal is taken of d 2^-64 (exact, normal for every d >= 1)
// and scaled back by an fp32 multiply that keeps subnormals: two
// multiplies, no branch, so the compiler interleaves a thread's elements.
__device__ __forceinline__ float sigmoid(float h) {
  const float kLog2e = 1.4426950408889634f;
  const float d = __fadd_rn(vc::ex2_approx(__fmul_rn(h, -kLog2e)), 1.0f);  // +inf below h ~ -88.7: s = 0
  return __fmul_rn(vc::rcp_approx(__fmul_rn(d, 0x1p-64f)), 0x1p-64f);
}

// 8 channels of a pixel: act(bf16(x * a + bb)), x * a and + bb rounded
// apart as JAX's chain rounds them. Two values at a time: h = bf16(x * a +
// bb) by one pack instruction, and swish as JAX's bf16 chain rounds it, y =
// bf16(h * bf16(sigmoid(h))), by one more pack and one bf16x2 multiply (a
// product of two bf16 values is exact in fp32, so the multiply's one
// rounding is the fp32 chain's). A single-value fp32 -> bf16 conversion
// (F2F) shares the special-function operations' quarter rate; the pairs'
// pack instructions do not (on the H100 the swish apply at (1, 48, 144, 512)
// went 0.0092 -> 0.0056 ms with this and the short sigmoid, PERF.md). Every
// finite bf16 h lies within one bf16 ulp of PyTorch's bf16 h * sigmoid(h)
// (chip_smoke.py `check_swish_exhaustive` on the card;
// tests/test_torch_group_norm.py emulates this order on the CPU).
template <bool SWISH>
__device__ __forceinline__ uint4 apply8(const uint4& u, const float* av, const float* bv) {
  float f[VEC];
  vc::unpack8(u, f);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(f[2 * j], av[2 * j]), bv[2 * j]),
                                                   __fadd_rn(__fmul_rn(f[2 * j + 1], av[2 * j + 1]), bv[2 * j + 1]));
    if (SWISH) {
      const float2 hf = __bfloat1622float2(h);
      o[j] = __hmul2(h, __floats2bfloat162_rn(sigmoid(hf.x), sigmoid(hf.y)));
    } else {
      o[j] = h;
    }
  }
  return out;
}

// ---------------------------------------------------------------- the moments design

constexpr int MO_CONSUMERS = 256;              // consumer threads: (C / 8) x P of them hold a tile
constexpr int MO_WARPS = MO_CONSUMERS / 32;
constexpr int MO_THREADS = MO_CONSUMERS + 32;  // + the producer warp
constexpr int MO_VECS = 8;                     // a consumer's 16-byte vectors a tile: 8 pixels of 8 channels
constexpr int MO_STAGE_BYTES = MO_VECS * MO_CONSUMERS * 16;  // 32 KB: a tile, at most
constexpr int MO_MAX_STAGES = 6;
constexpr int MO_SLOTS = 256;          // ticket slots: one a stream (ops/group_norm.py picks it)
constexpr int MO_SLOT_TICKETS = 4096;  // B x (teams + 1) at most: 4 MB of tickets in all

// zero when the library loads; atomicInc wraps every ticket back to 0 as its last CTA arrives
__device__ unsigned g_tickets[MO_SLOTS * MO_SLOT_TICKETS];

// the pixels of unit i, units of U pixels (a CTA's run, or a team's)
__device__ __forceinline__ int unit_pixels(long long i, long long U, int HW) {
  return (int)(min((long long)HW, (i + 1) * U) - min((long long)HW, i * U));
}

// A tile of this thread: raw[k] its channels c0 .. c0 + 7 at its k-th pixel
// of the tile (zeros past cnt). Adds the tile's channel sums to acc and
// merges the tile's pieces (W channels of one group each) into the thread's
// pieces, which hold `seen` pixels: mean[i] and M2[i] about it.
template <int W>
__device__ __forceinline__ void moments_tile(const uint4* raw, int cnt, float* acc, float* mean, float* m2,
                                             float& seen) {
  constexpr int NP = VEC / W;
  float ts[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) ts[j] = 0.f;
#pragma unroll
  for (int k = 0; k < MO_VECS; ++k) {
    float f[VEC];
    vc::unpack8(raw[k], f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ts[j] = __fadd_rn(ts[j], f[j]);
  }
  const float nb = (float)cnt;
  float tm[NP], tq[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < W; ++j) s = __fadd_rn(s, ts[i * W + j]);
    tm[i] = __fdiv_rn(s, nb * (float)W);
    tq[i] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < MO_VECS; ++k) {
    if (k < cnt) {
      float f[VEC];
      vc::unpack8(raw[k], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = __fsub_rn(f[j], tm[j / W]);
        tq[j / W] = __fadd_rn(tq[j / W], __fmul_rn(d, d));
      }
    }
  }
  // the identity: n_a = seen pixels, n_b = cnt, elements W times as many
  const float n = __fadd_rn(seen, nb);
  const float frac = __fdiv_rn(nb, n);
  const float w = __fmul_rn(__fmul_rn(seen, frac), (float)W);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float d = __fsub_rn(tm[i], mean[i]);
    mean[i] = __fadd_rn(mean[i], __fmul_rn(d, frac));
    m2[i] = __fadd_rn(m2[i], __fadd_rn(tq[i], __fmul_rn(w, __fmul_rn(d, d))));
  }
  seen = n;
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], ts[j]);
}

// the floats of a row of partial moments: C channel sums, G group means, G
// moments about them, padded to 16 bytes
__host__ __device__ __forceinline__ int row_floats(int C, int G) { return (C + 2 * G + 3) / 4 * 4; }

// The CTA merges n rows (row_floats(C, G) apart: channel sums, group means,
// the moments about them) of units first .. first + n - 1 (U pixels a
// unit), in order. final false: writes the merged row at out (the group
// means the union's own). final true: the channel means and group means in
// JAX's order, var_g from the moment about mu_g, a and bb of batch element
// b from the parameters in shared memory (sc, bi). The rows are copied into
// shared memory at smem (n rows, then C + 2G floats of sums) by 16-byte
// loads of every thread at once, so a merge waits for about one round trip
// to L2; the phases after it read shared memory. Not inlined: the team
// merge and the final merge share its code, warm in the last CTA's
// instruction cache.
__device__ __noinline__ void moments_combine(const float* rows, int n, long long first, long long U, int HW, int C,
                                             int G, float* smem, bool final, float* out, const float* sc,
                                             const float* bi, float* a, float* bb, int b, float eps) {
  const int R = row_floats(C, G), cg = C / G;
  const float4* src = reinterpret_cast<const float4*>(rows);
  float4* dst = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < n * R / 4; i += blockDim.x) dst[i] = __ldcg(src + i);
  __syncthreads();
  float* chan = smem + n * R;  // C channel sums, then final: G group means, G rsqrt(var + eps)
  float* gm = chan + C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float v = 0.f;
    for (int i = 0; i < n; ++i) v = __fadd_rn(v, smem[i * R + c]);
    chan[c] = final ? __fdiv_rn(v, (float)HW) : v;
    if (!final) out[c] = v;
  }
  __syncthreads();
  const int npix = (int)(min((long long)HW, (first + n) * U) - first * U);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float m = 0.f;
    for (int j = 0; j < cg; ++j) m = __fadd_rn(m, chan[g * cg + j]);
    m = __fdiv_rn(final ? m : __fdiv_rn(m, (float)npix), (float)cg);
    float M2 = 0.f;
    for (int i = 0; i < n; ++i) {
      const float d = __fsub_rn(smem[i * R + C + g], m);
      const float w = __fmul_rn((float)unit_pixels(first + i, U, HW), (float)cg);
      M2 = __fadd_rn(M2, __fadd_rn(smem[i * R + C + G + g], __fmul_rn(w, __fmul_rn(d, d))));
    }
    if (final) {
      gm[g] = m;
      gm[G + g] = rsqrtf(__fadd_rn(__fdiv_rn(__fdiv_rn(M2, (float)HW), (float)cg), eps));
    } else {
      out[C + g] = m;
      out[C + G + g] = M2;
    }
  }
  if (!final) return;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const size_t o = (size_t)b * C + c;
    const float av = __fmul_rn(gm[G + g], sc[c]);
    a[o] = av;
    bb[o] = __fsub_rn(bi[c], __fmul_rn(gm[g], av));
  }
}

// the ring's bytes a CTA needs beyond its stages' use: the CTA's merge of
// its threads' pieces (P lanes x C sums, 2 x P x C / W piece moments, P
// counts, C + 2G sums) and a team or final merge of `rows` rows
__host__ __device__ __forceinline__ size_t moments_scratch(int C, int G, int W, int rows) {
  const int P = MO_CONSUMERS / (C / VEC);
  const size_t own = (size_t)P * C + 2 * (size_t)P * (C / W) + P + C + 2 * G;
  const size_t merge = (size_t)rows * row_floats(C, G) + C + 2 * G;
  return 4 * (own > merge ? own : merge);
}

// One CTA: batch element blockIdx.y, pixels [blockIdx.x * per, + per) of HW
// (per a multiple of the tile's 8 P pixels). rows: (B, gridDim.x, R) fp32,
// team_rows (B, teams, R) fp32 scratch; tickets: B x (teams + 1), zero on
// entry and on exit. Dynamic shared memory: `stages` stages of
// MO_STAGE_BYTES.
template <int W>
__global__ void __launch_bounds__(MO_THREADS, 1)
    group_norm_stats_moments_kernel(const bf16* __restrict__ x, const void* __restrict__ scale,
                                    const void* __restrict__ bias, int params_bf16, float* __restrict__ a,
                                    float* __restrict__ bb, float* rows, float* team_rows, unsigned* tickets, int HW,
                                    int C, int G, int per, int team, int stages, float eps) {
  constexpr int NP = VEC / W;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[2 * MO_MAX_STAGES];  // full, then empty
  __shared__ float sc[MAX_C], bi[MAX_C];  // the parameters, for whichever CTA merges last
  __shared__ bool last;
  const int T = C / VEC, P = MO_CONSUMERS / T, TP = MO_VECS * P;
  const int b = blockIdx.y, r = blockIdx.x, n = gridDim.x, R = row_floats(C, G);
  const int p0 = r * per, npix = min(HW, p0 + per) - p0, ntiles = (npix + TP - 1) / TP;
  const uint32_t stage0 = vc::smem_addr(ring), full = vc::smem_addr(bars), empty = full + 8 * stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      vc::mbar_init(full + 8 * s, 1);         // the producer's arrive, with the copy's bytes
      vc::mbar_init(empty + 8 * s, MO_WARPS);  // a lane of every consumer warp
    }
    vc::mbar_init_fence();
  }
  __syncthreads();

  const int t = threadIdx.x % T, p = threadIdx.x / T, c0 = t * VEC;
  const bool active = threadIdx.x < P * T;  // a consumer holding vectors (P * T < 256 where T does not divide it)
  float acc[VEC], mean[NP], m2[NP], seen = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) mean[i] = m2[i] = 0.f;
  const bf16* xb = x + ((size_t)b * HW + p0) * C;
  if (warp == MO_WARPS) {  // the producer: tile k into stage k % stages
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int k = 0; k < ntiles; ++k) {
        if (k >= stages) vc::mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t bytes = (uint32_t)min(TP, npix - k * TP) * C * 2;
        vc::mbar_arrive_expect_tx(full + 8 * s, bytes);
        vc::bulk_load(stage0 + s * MO_STAGE_BYTES, xb + (size_t)k * TP * C, bytes, full + 8 * s);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    for (int c = threadIdx.x; c < C; c += MO_CONSUMERS) {  // while the first tiles land
      sc[c] = param(scale, c, params_bf16);
      bi[c] = param(bias, c, params_bf16);
    }
    int s = 0;
    uint32_t ph = 0;
    for (int k = 0; k < ntiles; ++k) {
      const int pix = min(TP, npix - k * TP);
      const int cnt = active ? max(0, min(MO_VECS, (pix - p + P - 1) / P)) : 0;
      vc::mbar_wait(full + 8 * s, ph);
      uint4 raw[MO_VECS];
#pragma unroll
      for (int q = 0; q < MO_VECS; ++q)
        raw[q] = q < cnt ? vc::lds128(stage0 + s * MO_STAGE_BYTES + ((p + q * P) * C + c0) * 2)
                         : make_uint4(0u, 0u, 0u, 0u);
      __syncwarp();
      if (lane == 0) vc::mbar_arrive(empty + 8 * s);  // the warp's vectors are in registers
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
      if (cnt > 0) moments_tile<W>(raw, cnt, acc, mean, m2, seen);
    }
  }
  __syncthreads();  // every stage read: the ring is scratch from here

  // the CTA's row: lanes in order, a group's pieces about the CTA's group mean
  float* red = reinterpret_cast<float*>(ring);  // P x C channel sums
  float* pmean = red + P * C;                   // P x C / W piece means
  float* pm2 = pmean + P * (C / W);             // P x C / W piece moments
  float* lanes = pm2 + P * (C / W);             // P: each lane's pixels
  float* chan = lanes + P;                      // C
  if (active) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[p * C + c0 + j] = acc[j];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      pmean[p * (C / W) + c0 / W + i] = mean[i];
      pm2[p * (C / W) + c0 / W + i] = m2[i];
    }
    if (t == 0) lanes[p] = seen;
  }
  __syncthreads();
  float* row = rows + ((size_t)b * n + r) * R;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float v = 0.f;
    for (int q = 0; q < P; ++q) v = __fadd_rn(v, red[q * C + c]);
    chan[c] = v;
    row[c] = v;
  }
  __syncthreads();
  const int cg = C / G, pieces = cg / W;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float m = 0.f;
    for (int j = 0; j < cg; ++j) m = __fadd_rn(m, chan[g * cg + j]);
    m = __fdiv_rn(__fdiv_rn(m, (float)npix), (float)cg);
    float M2 = 0.f;
    for (int q = 0; q < P; ++q) {
      const float w = __fmul_rn(lanes[q], (float)W);
      for (int i = 0; i < pieces; ++i) {
        const int o = q * (C / W) + g * pieces + i;
        const float d = __fsub_rn(pmean[o], m);
        M2 = __fadd_rn(M2, __fadd_rn(pm2[o], __fmul_rn(w, __fmul_rn(d, d))));
      }
    }
    row[C + g] = m;
    row[C + G + g] = M2;
  }

  // the team's last CTA merges the team's rows; the last team's, the teams'
  const int teams = (n + team - 1) / team, j = r / team, members = min(team, n - j * team);
  unsigned* tb = tickets + (size_t)b * (teams + 1);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(tb + j, (unsigned)(members - 1)) == (unsigned)(members - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* brows = rows + (size_t)b * n * R;
  if (teams == 1) {
    moments_combine(brows, n, 0, per, HW, C, G, red, true, nullptr, sc, bi, a, bb, b, eps);
    return;
  }
  float* trows = team_rows + (size_t)b * teams * R;
  moments_combine(brows + (size_t)j * team * R, members, (long long)j * team, per, HW, C, G, red, false,
                  trows + (size_t)j * R, sc, bi, a, bb, b, eps);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(tb + teams, (unsigned)(teams - 1)) == (unsigned)(teams - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  moments_combine(trows, teams, 0, (long long)team * per, HW, C, G, red, true, nullptr, sc, bi, a, bb, b, eps);
}

// ---------------------------------------------------------------- the cluster design

constexpr int CL_THREADS = 512;
constexpr int CL_WARPS = CL_THREADS / 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// this thread's VEC sums -> out[k * VEC + j] (k = its channel chunk), summed
// over the CTA: a butterfly over the warp's lanes of chunk k (lane ^ K, 2K,
// ..., 16 hold the same chunk), then the warps in order. wsum: CL_WARPS x CB
// floats of shared memory, free on entry; out: CB floats.
template <int K>
__device__ __forceinline__ void cta_sums(float* acc, float* wsum, float* out) {
  constexpr int CB = K * VEC;
#pragma unroll
  for (int off = 16; off >= K; off /= 2) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane < K) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) wsum[warp * CB + lane * VEC + j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < CB) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < CL_WARPS; ++w) v = __fadd_rn(v, wsum[w * CB + threadIdx.x]);
    out[threadIdx.x] = v;
  }
}

// the cluster's sum of `part` (CB floats at the same offset in every CTA),
// rank by rank in order, for channel threadIdx.x < CB: every rank's value
// loaded first (ranks past the cluster add +0)
__device__ __forceinline__ float cluster_total(const float* part, int cluster) {
  const uint32_t addr = vc::smem_addr(part + threadIdx.x);
  float p[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) p[r] = r < cluster ? vc::ld_cluster_f32(vc::mapa(addr, r)) : 0.f;
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) v = __fadd_rn(v, p[r]);
  return v;
}

// the mean of channel c's group: the sum of its group's cg values of chan
// in order, over cg
__device__ __forceinline__ float group_mean(const float* chan, int c, int cg) {
  const int g0 = (c / cg) * cg;
  float v = 0.f;
#pragma unroll 8
  for (int j = 0; j < cg; ++j) v = __fadd_rn(v, chan[g0 + j]);
  return __fdiv_rn(v, (float)cg);
}

// One cluster: batch element blockIdx.y, group block blockIdx.x / cluster
// (CB = K * VEC channels from CB * block), pixels [rank * per, rank * per +
// per) of HW for the CTA of rank `rank`. Dynamic shared memory: the slab (per
// x CB bf16), then fp32 wsum (CL_WARPS x CB), part (2 x CB: pass 1's sums,
// pass 2's), chan (CB), mu (CB). Y 0: the statistics alone, rank 0 writes a
// and bb. Y 1 (no act) or 2 (swish): the statistics exactly as Y 0 takes
// them; then every CTA forms a and bb from all ranks' sums in rank order
// (the same bits as rank 0's), normalises its resident share of the slab as
// the apply does and writes it to y; rank 0 still writes a and bb.
template <int K, int Y>
__device__ __forceinline__ void resident_body(const bf16* __restrict__ x, const void* __restrict__ scale,
                                              const void* __restrict__ bias, int params_bf16, float* __restrict__ a,
                                              float* __restrict__ bb, bf16* __restrict__ y, int HW, int C, int cg,
                                              int cluster, int per, float eps) {
  constexpr int CB = K * VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* slab = reinterpret_cast<uint4*>(smem);
  float* wsum = reinterpret_cast<float*>(smem + (size_t)per * CB * sizeof(bf16));
  float* part = wsum + CL_WARPS * CB;
  float* chan = part + 2 * CB;
  float* mu = chan + CB;

  const int rank = (int)vc::cluster_rank(), b = blockIdx.y, c0 = (blockIdx.x / cluster) * CB;
  const int p0 = rank * per;
  const int n = max(0, min(per, HW - p0)) * K;  // the CTA's 16-byte chunks
  const int t = threadIdx.x, k = t % K;
  // the parameters of channel c0 + t, loaded while the slab lands
  float sc = 0.f, bi = 0.f;
  if (t < CB) {
    sc = param(scale, c0 + t, params_bf16);
    bi = param(bias, c0 + t, params_bf16);
  }

  // this thread's chunks t + j * CL_THREADS, j < mine: those below `split` in a first group
  const int mine = t < n ? (n - t + CL_THREADS - 1) / CL_THREADS : 0;
  const int split = t + (mine / 2) * CL_THREADS;
  const bf16* xb = x + ((size_t)b * HW + p0) * C + c0 + k * VEC;
  for (int i = t; i < n; i += CL_THREADS) {
    vc::cp_async16(vc::smem_addr(slab + i), xb + (size_t)(i / K) * C);
    if (i + CL_THREADS == split) vc::cp_async_commit();
  }
  vc::cp_async_commit();

  float zero[VEC], acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) zero[j] = acc[j] = 0.f;
  vc::cp_async_wait<1>();
  int i = t;
  for (; i < split; i += CL_THREADS) accumulate<false>(slab[i], zero, acc);
  vc::cp_async_wait<0>();
  for (; i < n; i += CL_THREADS) accumulate<false>(slab[i], zero, acc);
  cta_sums<K>(acc, wsum, part);
  vc::cluster_sync();  // every CTA's part written; also a CTA barrier

  // the channel means and the group means, the same bits in every CTA
  const float npix = (float)HW;
  if (t < CB) chan[t] = __fdiv_rn(cluster_total(part, cluster), npix);
  __syncthreads();
  if (t < CB) mu[t] = group_mean(chan, t, cg);
  __syncthreads();

  // pass 2 from the resident slab
  float m[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = mu[k * VEC + j];
    acc[j] = 0.f;
  }
  for (i = t; i < n; i += CL_THREADS) accumulate<true>(slab[i], m, acc);
  cta_sums<K>(acc, wsum, part + CB);
  vc::cluster_sync();  // every CTA's pass-2 sums written

  const size_t o = (size_t)b * C + c0 + t;
  if constexpr (Y == 0) {
    if (rank == 0) {
      if (t < CB) chan[t] = __fdiv_rn(cluster_total(part + CB, cluster), npix);
      __syncthreads();
      if (t < CB) {
        const float var = group_mean(chan, t, cg);
        const float av = __fmul_rn(rsqrtf(__fadd_rn(var, eps)), sc);
        a[o] = av;
        bb[o] = __fsub_rn(bi, __fmul_rn(mu[t], av));
      }
    }
    vc::cluster_sync();  // no CTA exits while rank 0 reads its shared memory
    return;
  }
  // every CTA: the variance from all ranks' sums in rank order, a and bb
  // into wsum (free since cta_sums), then the apply from the slab
  if (t < CB) chan[t] = __fdiv_rn(cluster_total(part + CB, cluster), npix);
  vc::cluster_arrive();  // this thread's reads of its peers' shared memory are done
  __syncthreads();
  if (t < CB) {
    const float var = group_mean(chan, t, cg);
    const float av = __fmul_rn(rsqrtf(__fadd_rn(var, eps)), sc);
    const float bv = __fsub_rn(bi, __fmul_rn(mu[t], av));
    wsum[t] = av;
    wsum[CB + t] = bv;
    if (rank == 0) {
      a[o] = av;
      bb[o] = bv;
    }
  }
  __syncthreads();
  float av[VEC], bv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    av[j] = wsum[k * VEC + j];
    bv[j] = wsum[CB + k * VEC + j];
  }
  // chunk i is pixel p0 + i / K at channels c0 + 8 (i % K), and i % K == k:
  // K neighbouring threads store one pixel's row of the block (16 bytes each)
  bf16* yb = y + ((size_t)b * HW + p0) * C + c0 + k * VEC;
  for (i = t; i < n; i += CL_THREADS)
    *reinterpret_cast<uint4*>(yb + (size_t)(i / K) * C) = apply8<Y == 2>(slab[i], av, bv);
  vc::cluster_wait();  // no CTA exits while a peer reads its shared memory
}

template <int K>
__global__ void __launch_bounds__(CL_THREADS, 1)
    group_norm_stats_resident(const bf16* __restrict__ x, const void* __restrict__ scale,
                              const void* __restrict__ bias, int params_bf16, float* __restrict__ a,
                              float* __restrict__ bb, int HW, int C, int cg, int cluster, int per, float eps) {
  resident_body<K, 0>(x, scale, bias, params_bf16, a, bb, nullptr, HW, C, cg, cluster, per, eps);
}

// the statistics and the apply in one launch (entry group_norm_fused_cluster)
template <int K, bool SWISH>
__global__ void __launch_bounds__(CL_THREADS, 1)
    group_norm_fused_resident(const bf16* __restrict__ x, const void* __restrict__ scale,
                              const void* __restrict__ bias, int params_bf16, float* __restrict__ a,
                              float* __restrict__ bb, bf16* __restrict__ y, int HW, int C, int cg, int cluster,
                              int per, float eps) {
  resident_body<K, SWISH ? 2 : 1>(x, scale, bias, params_bf16, a, bb, y, HW, C, cg, cluster, per, eps);
}

template <bool SWISH>
__global__ void __launch_bounds__(THREADS)
    group_norm_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ bb,
                            bf16* __restrict__ y, int HW, int C) {
  const int b = blockIdx.y;
  const Slab s = slab(HW, C);
  float av[VEC], bv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    av[j] = a[(size_t)b * C + s.c0 + j];
    bv[j] = bb[(size_t)b * C + s.c0 + j];
  }
  const size_t base = (size_t)b * HW * C + s.c0;
  const bf16* xb = x + base;
  bf16* yb = y + base;
  constexpr int U = UNROLL / 2;
  int i = s.start + s.p;
  for (; i + (U - 1) * s.P < s.end; i += U * s.P) {
    uint4 u[U];
#pragma unroll
    for (int k = 0; k < U; ++k) u[k] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)(i + k * s.P) * C));
#pragma unroll
    for (int k = 0; k < U; ++k)
      *reinterpret_cast<uint4*>(yb + (size_t)(i + k * s.P) * C) = apply8<SWISH>(u[k], av, bv);
  }
  for (; i < s.end; i += s.P)
    *reinterpret_cast<uint4*>(yb + (size_t)i * C) =
        apply8<SWISH>(__ldg(reinterpret_cast<const uint4*>(xb + (size_t)i * C)), av, bv);
}

int threads_for(int C) {
  const int T = C / VEC;
  return T * (T >= THREADS ? 1 : THREADS / T);
}

bool bad_shape(int B, int HW, int C, int nblk) {
  return B <= 0 || HW <= 0 || C <= 0 || C % VEC || C > MAX_C || nblk <= 0 || nblk > 65535;
}

// the cluster design's dynamic shared memory: the slab of `per` pixels x CB
// channels, then the CTA's fp32 sums (CL_WARPS + 4 rows of CB)
size_t cluster_smem(int per, int CB) { return (size_t)per * CB * sizeof(bf16) + (size_t)(CL_WARPS + 4) * CB * 4; }

// the cluster design's launch: the statistics alone (y null) or with the
// apply (y, swish 0 or 1)
template <int K>
int launch_stats_cluster(const void* x, const void* scale, const void* bias, int params_bf16, void* a, void* bb,
                         void* y, int swish, int B, int HW, int C, int groups, int cluster, float eps,
                         cudaStream_t s) {
  constexpr int CB = K * VEC;
  const int per = (HW + cluster - 1) / cluster;
  const size_t smem = cluster_smem(per, CB);
  const dim3 grid(C / CB * cluster, B);
  const bf16* xp = static_cast<const bf16*>(x);
  float* ap = static_cast<float*>(a);
  float* bp = static_cast<float*>(bb);
  auto launch = [&](auto kern, auto... out) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    return vc::launch_cluster(kern, grid, CL_THREADS, smem, s, cluster, xp, scale, bias, params_bf16, ap, bp,
                              out..., HW, C, C / groups, cluster, per, eps);
  };
  bf16* yp = static_cast<bf16*>(y);
  if (!y) return launch(group_norm_stats_resident<K>);
  return swish ? launch(group_norm_fused_resident<K, true>, yp) : launch(group_norm_fused_resident<K, false>, yp);
}

}  // namespace

// Kernel N, statistics, the moments design: one launch. x (B, HW, C) bf16
// contiguous, 16-byte aligned; scale, bias (C,) bf16 (params_bf16 1) or fp32
// (0); a, bb (B, C) fp32; scratch (B, ctas + teams, row_floats(C, groups))
// fp32, 16-byte aligned, teams = ceil(ctas / team). `ctas` CTAs per batch
// element of `per` pixels each (per a multiple of 8 x (256 / (C / 8)), every
// CTA given at least one pixel), teams of `team` CTAs, `stages` ring stages
// of 32 KB (2 to 6; enough to hold a merge's rows, moments_scratch), the
// tickets of slot `slot` (0 to 255; a slot serves one stream at a time). C a
// multiple of 8 up to 2048, groups dividing C. Launches on `stream`; returns
// a cudaError_t (0 on success; a shape or plan it cannot take:
// cudaErrorInvalidValue).
extern "C" int group_norm_stats_moments(const void* x, const void* scale, const void* bias, int params_bf16,
                                        void* a, void* bb, void* scratch, int slot, int B, int HW, int C,
                                        int groups, int ctas, int per, int team, int stages, float eps,
                                        void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % VEC || C > MAX_C || groups <= 0 || C % groups)
    return (int)cudaErrorInvalidValue;
  const int T = C / VEC, TP = MO_VECS * (MO_CONSUMERS / T);
  if (per <= 0 || per % TP || ctas <= 0 || (long long)ctas * per < HW || (long long)(ctas - 1) * per >= HW)
    return (int)cudaErrorInvalidValue;
  const int teams = team > 0 ? (ctas + team - 1) / team : 0;
  if (teams <= 0 || stages < 2 || stages > MO_MAX_STAGES || slot < 0 || slot >= MO_SLOTS ||
      (long long)B * (teams + 1) > MO_SLOT_TICKETS)
    return (int)cudaErrorInvalidValue;
  unsigned* tickets = nullptr;
  cudaError_t e = cudaGetSymbolAddress(reinterpret_cast<void**>(&tickets), g_tickets);
  if (e != cudaSuccess) return (int)e;
  tickets += (size_t)slot * MO_SLOT_TICKETS;
  const int cg = C / groups, W = cg % 8 == 0 ? 8 : cg % 4 == 0 ? 4 : cg % 2 == 0 ? 2 : 1;  // gcd(cg, 8)
  const size_t smem = (size_t)stages * MO_STAGE_BYTES;
  if (moments_scratch(C, groups, W, team > teams ? team : teams) > smem) return (int)cudaErrorInvalidValue;
  float* rows = static_cast<float*>(scratch);
  float* team_rows = rows + (size_t)B * ctas * row_floats(C, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ctas, B);
  auto launch = [&](auto kern) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    return vc::launch_cluster(kern, grid, MO_THREADS, smem, s, 1, static_cast<const bf16*>(x), scale, bias,
                              params_bf16, static_cast<float*>(a), static_cast<float*>(bb), rows, team_rows, tickets,
                              HW, C, groups, per, team, stages, eps);
  };
  switch (W) {
    case 8: return launch(group_norm_stats_moments_kernel<8>);
    case 4: return launch(group_norm_stats_moments_kernel<4>);
    case 2: return launch(group_norm_stats_moments_kernel<2>);
    default: return launch(group_norm_stats_moments_kernel<1>);
  }
}

namespace {

int cluster_entry(const void* x, const void* scale, const void* bias, int params_bf16, void* a, void* bb, void* y,
                  int swish, int B, int HW, int C, int groups, int block_groups, int cluster, float eps,
                  void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || groups <= 0 || C % groups || block_groups <= 0 ||
      groups % block_groups)
    return (int)cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const int CB = block_groups * (C / groups);
  if (CB % VEC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VC_GN_CASE(k)                                                                                             \
  case k:                                                                                                         \
    return launch_stats_cluster<k>(x, scale, bias, params_bf16, a, bb, y, swish, B, HW, C, groups, cluster, eps, s);
  switch (CB / VEC) {
    VC_GN_CASE(1)
    VC_GN_CASE(2)
    VC_GN_CASE(4)
    VC_GN_CASE(8)
    VC_GN_CASE(16)
    VC_GN_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VC_GN_CASE
}

}  // namespace

// Kernel N, statistics, the cluster design: one launch, no scratch. x (B, HW,
// C) bf16 contiguous, 16-byte aligned; scale, bias (C,) bf16 (params_bf16 1)
// or fp32 (0); a, bb (B, C) fp32. A cluster of `cluster` CTAs (1, 2, 4 or 8)
// per batch element and group block of `block_groups` groups, whose channels
// are 8 K for K a power of two up to 32; the slab's share of a CTA must fit
// the card's shared memory (ops/group_norm.py `stats_plan`). Launches on
// `stream`; returns a cudaError_t (0 on success; a shape or plan it cannot
// take: cudaErrorInvalidValue).
extern "C" int group_norm_stats_cluster(const void* x, const void* scale, const void* bias, int params_bf16,
                                        void* a, void* bb, int B, int HW, int C, int groups, int block_groups,
                                        int cluster, float eps, void* stream) {
  return cluster_entry(x, scale, bias, params_bf16, a, bb, nullptr, 0, B, HW, C, groups, block_groups, cluster, eps,
                       stream);
}

// Kernel N, the statistics and the apply in one launch of the cluster
// design: group_norm_stats_cluster's arguments, a plan it takes and its
// outputs a and bb, and y (B, HW, C) bf16 contiguous, 16-byte aligned: y =
// act(bf16(x * a + bb)), swish 0 (none) or 1, the same bits as
// group_norm_apply on group_norm_stats_cluster's a and bb. Returns a
// cudaError_t.
extern "C" int group_norm_fused_cluster(const void* x, const void* scale, const void* bias, int params_bf16,
                                        void* a, void* bb, void* y, int swish, int B, int HW, int C, int groups,
                                        int block_groups, int cluster, float eps, void* stream) {
  if (!y || (swish != 0 && swish != 1)) return (int)cudaErrorInvalidValue;
  return cluster_entry(x, scale, bias, params_bf16, a, bb, y, swish, B, HW, C, groups, block_groups, cluster, eps,
                       stream);
}

// How many clusters of the cluster design the card runs at once for a plan
// (as group_norm_stats_cluster takes it): 0 or more, or minus a cudaError_t.
extern "C" int group_norm_cluster_occupancy(int HW, int C, int groups, int block_groups, int cluster) {
  if (HW <= 0 || C <= 0 || groups <= 0 || C % groups || block_groups <= 0 || cluster <= 0 || cluster > MAX_CLUSTER)
    return -(int)cudaErrorInvalidValue;
  const int CB = block_groups * (C / groups), per = (HW + cluster - 1) / cluster;
  const size_t smem = cluster_smem(per, CB);
  auto occupancy = [&](auto kern) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return e != cudaSuccess ? -(int)e : vc::max_active_clusters(kern, CL_THREADS, smem, cluster);
  };
  switch (CB % VEC ? 0 : CB / VEC) {
    case 1: return occupancy(group_norm_stats_resident<1>);
    case 2: return occupancy(group_norm_stats_resident<2>);
    case 4: return occupancy(group_norm_stats_resident<4>);
    case 8: return occupancy(group_norm_stats_resident<8>);
    case 16: return occupancy(group_norm_stats_resident<16>);
    case 32: return occupancy(group_norm_stats_resident<32>);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// Kernel N's limits on device `device`: its SMs, the shared memory a CTA may
// opt in to and its L2 (bytes), the inputs of ops/group_norm.py's
// `stats_plan`. Returns a cudaError_t.
extern "C" int group_norm_device_limits(int device, int* sms, int* smem_per_cta, int* l2_bytes) {
  cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(smem_per_cta, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(l2_bytes, cudaDevAttrL2CacheSize, device);
  return (int)e;
}

// Kernel N, apply. x, y (B, HW, C) bf16 contiguous, 16-byte aligned; a, bb
// (B, C) fp32; swish 0 or 1. Launches on `stream`; returns a cudaError_t.
extern "C" int group_norm_apply(const void* x, const void* a, const void* bb, void* y, int B, int HW, int C,
                                int swish, int nblk, void* stream) {
  if (bad_shape(B, HW, C, nblk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nblk, B);
  const int threads = threads_for(C);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(bb);
  bf16* yp = static_cast<bf16*>(y);
  if (swish)
    group_norm_apply_kernel<true><<<grid, threads, 0, s>>>(xp, ap, bp, yp, HW, C);
  else
    group_norm_apply_kernel<false><<<grid, threads, 0, s>>>(xp, ap, bp, yp, HW, C);
  return (int)cudaGetLastError();
}
