// Kernel M: attention's head merge with the padded query rows zeroed and, in
// the single block, gelu(tanh) of the MLP half written beside it: linear2's
// whole input in one pass.
//
// Replaces an XLA fusion, not a Pallas kernel: the head merge of
// visualcloze_tpu/ops/attention.py (transpose, reshape, mask multiply) and
// `concatenate([attn, gelu(mlp_h, approximate=True)])` in
// visualcloze_tpu/models/layers.py `single_block` (:342).
//
//     out[b, l, h * D + d] = attn[b, h, l, d] if mask[b, l] else 0
//     out[b, l, H * D + j] = bf16(gelu_tanh(float(mlp[b, l, j])))   (j < G)
//
// gelu_tanh is gelu.cuh's (PyTorch's approximate="tanh" in fp32, shared with
// kernel O). The merge is a copy: bit for bit. A double block uses the merge
// alone (G = 0).
//
// On the fused w8a8 route the quantized variant (`merge_heads_quant`) writes
// the consumer linears' int8 codes and row scales instead, kernel I folded
// in: the row's bf16 values (the merge, then the rounded gelu) times a_sinv,
// their absmax, then act_quant.cuh's quantize; the codes and scales of
// kernel I applied to M's own output, bit for bit. In a double block the
// joint rows [0, split) (the text tokens) feed txt_attn.proj and the rest
// img_attn.proj: each segment takes its own a_sinv and is written to its
// own contiguous (B * rows, H * D) buffers. A padded row's merge is zero
// (codes 0, scale 1e-8 / 127 in a double block).
//
// Bound on the H100 (3.35 TB/s): the bytes. attn and mlp read once, out
// written once: 244 MB for the single block at 3968 tokens (0.073 ms), 48.8
// MB for the merge alone (0.015 ms); quantized, 183 MB (0.055 ms) and 36.6
// MB (0.011 ms). The plain merge: a CTA a token, 16-byte loads and stores.
// The quantizing variant is bound by instructions as much as by bytes (the
// gelu's, the quantize's): as a CTA a row, each row's loads waited behind
// its own reduction, and every value paid a branch around its quotient. So:
//   - persistent CTAs (two an SM, four for rows of at most 4096 values, one
//     above 16384), each walking the rows with a stride of the grid;
//   - a ring of two row stages in dynamic shared memory, filled by a
//     producer warp with 1-D bulk copies completing on the stage's full
//     mbarrier: a row's H head slices of attn (D * 2 bytes each; none for a
//     padded row) and, in the single block, the G-column gelu half of
//     linear1's strided row in one copy. Row n + 1 (and, once row n's stage
//     is read, row n + 2) is in flight while row n is gelu'd, reduced and
//     quantized;
//   - 256 consumer threads, each holding the same 16 columns of every row
//     (NP pairs of 8): a thread copies its raw vectors out of the stage and
//     frees it at once, keeps the smoothed fp32 values in registers across
//     the one named barrier of the row's absmax (warps' partials
//     double-buffered by row), and quantizes from registers: a_sinv is read
//     once a row, the stage once, and each thread stores 16 codes at a time;
//   - gelu.cuh's tanh as one ex2 and one rcp; the codes by act_quant.cuh's
//     quant8_rcp (one branch a row, none a value, no conversion
//     instruction).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "bf16.cuh"
#include "gelu.cuh"
#include "hopper.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;
constexpr int MAX_THREADS = 1024;
// the quantizing variant: consumer threads (a producer warp beside them) and ring stages
constexpr int QUANT_THREADS = 256;
constexpr int QUANT_WARPS = QUANT_THREADS / 32;
constexpr int STAGES = 2;
constexpr int MAX_QUANT_ROW = 20 * 1024;  // W: its two bf16 stages in 80 KB of shared memory

__global__ void __launch_bounds__(MAX_THREADS)
    merge_heads_kernel(const bf16* __restrict__ attn, const int* __restrict__ mask, const bf16* __restrict__ mlp,
                       long long mb, long long ml, bf16* __restrict__ out, int L, int H, int D, int G, int ldo) {
  const int row = blockIdx.x;
  const int b = row / L, l = row - b * L;
  const bool keep = mask == nullptr || mask[row] != 0;
  bf16* o = out + (size_t)row * ldo;
  const int lanes = D / VEC;
  for (int i = threadIdx.x; i < H * lanes; i += blockDim.x) {
    const int h = i / lanes, d = (i - h * lanes) * VEC;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (keep) u = __ldg(reinterpret_cast<const uint4*>(attn + (((size_t)b * H + h) * L + l) * D + d));
    *reinterpret_cast<uint4*>(o + h * D + d) = u;
  }
  if (mlp == nullptr) return;
  const bf16* m = mlp + b * mb + l * ml;
  for (int j = threadIdx.x * VEC; j < G; j += blockDim.x * VEC) {
    float f[VEC];
    *reinterpret_cast<uint4*>(o + H * D + j) = vc::gelu8(__ldg(reinterpret_cast<const uint4*>(m + j)), f);
  }
}

// the consumer threads (named barrier 1; the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(QUANT_THREADS) : "memory");
}

// CTAs an SM for NP pairs a thread: registers bound it (16 NP fp32 values held a thread)
constexpr int quant_ctas_per_sm(int np) { return np == 1 ? 4 : np <= 4 ? 2 : 1; }

// the codes of a row's values held by this thread (pairs 2 p, 2 p + 1 of vectors, p = threadIdx.x + j *
// QUANT_THREADS), 16 at a time where the row's codes start 16-byte aligned (wide); Rcp: the row's reciprocal
// is not 0 (act_quant.cuh quant8_rcp, no branch a value)
template <int NP, bool Rcp>
__device__ __forceinline__ void store_codes(const float (&f)[NP][2][VEC], float sc, float r, int8_t* out, int vecs,
                                            bool wide) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int v = 2 * (threadIdx.x + j * QUANT_THREADS);
    if (v >= vecs) continue;
    const uint2 lo = Rcp ? vc::quant8_rcp(f[j][0], sc, r) : vc::quant8(f[j][0], sc, r);
    if (v + 1 < vecs) {
      const uint2 hi = Rcp ? vc::quant8_rcp(f[j][1], sc, r) : vc::quant8(f[j][1], sc, r);
      if (wide) {
        *reinterpret_cast<uint4*>(out + v * VEC) = make_uint4(lo.x, lo.y, hi.x, hi.y);
        continue;
      }
      *reinterpret_cast<uint2*>(out + (v + 1) * VEC) = hi;
    }
    *reinterpret_cast<uint2*>(out + v * VEC) = lo;
  }
}

// Kernel M quantized: each CTA walks rows blockIdx.x, + gridDim.x, ... of
// the B * L; a row of W = H * D + G bf16 values (as merge_heads_kernel writes
// them) is staged by the producer warp, its codes and scale written in the
// segment's buffers (rows [0, split) of each batch element: segment 0).
// Consumer thread t holds the row's vectors 2 p and 2 p + 1 for p = t + j *
// QUANT_THREADS, j < NP.
template <int NP>
__global__ void __launch_bounds__(QUANT_THREADS + 32, quant_ctas_per_sm(NP))
    merge_heads_quant_kernel(const bf16* __restrict__ attn, const int* __restrict__ mask,
                             const bf16* __restrict__ mlp, long long mb, long long ml, int B, int L, int H, int D,
                             int G, int split, const float* __restrict__ sinv0, int8_t* __restrict__ codes0,
                             float* __restrict__ scale0, const float* __restrict__ sinv1,
                             int8_t* __restrict__ codes1, float* __restrict__ scale1) {
  extern __shared__ __align__(128) unsigned char ring[];  // STAGES rows of W bf16
  __shared__ __align__(8) uint64_t bars[2 * STAGES];      // full, then empty
  __shared__ float partial[2][QUANT_WARPS];
  const int hd = H * D, W = hd + G, vecs = W / VEC, rows = B * L;
  const uint32_t row_bytes = 2 * W, stage0 = vc::smem_addr(ring);
  const uint32_t full = vc::smem_addr(bars), empty = full + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      vc::mbar_init(full + 8 * s, 1);                // the producer's arrive, with the copies' bytes
      vc::mbar_init(empty + 8 * s, QUANT_THREADS);   // every consumer thread
    }
    vc::mbar_init_fence();
  }
  __syncthreads();

  if (warp == QUANT_WARPS) {  // the producer: the k-th row of this CTA into stage k % STAGES
    int k = 0;
    for (int row = blockIdx.x; row < rows; row += gridDim.x, ++k) {
      const int s = k % STAGES;
      if (k >= STAGES) vc::mbar_wait(empty + 8 * s, ((k / STAGES) & 1) ^ 1);
      const int b = row / L, l = row - b * L;
      const bool keep = mask == nullptr || __ldg(mask + row) != 0;
      const uint32_t st = stage0 + s * row_bytes, bar = full + 8 * s;
      if (lane == 0) vc::mbar_arrive_expect_tx(bar, (keep ? 2 * hd : 0) + 2 * G);
      __syncwarp();
      if (keep) {
        for (int h = lane; h < H; h += 32)
          vc::bulk_load(st + h * D * 2, attn + (((size_t)b * H + h) * L + l) * D, D * 2, bar);
      }
      if (G > 0 && lane == 31) vc::bulk_load(st + hd * 2, mlp + b * mb + l * ml, G * 2, bar);
    }
    return;
  }

  const bool wide = W % 16 == 0;  // a codes row starts 16-byte aligned: a pair's codes in one store
  int k = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, ++k) {
    const int s = k % STAGES;
    const int b = row / L, l = row - b * L;
    const bool keep = mask == nullptr || __ldg(mask + row) != 0;
    const bool first = l < split;
    const float* sinv = first ? sinv0 : sinv1;
    const uint32_t st = stage0 + s * row_bytes;
    uint4 raw[NP][2];
    vc::mbar_wait(full + 8 * s, (k / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 2 * (threadIdx.x + j * QUANT_THREADS) + h;
        raw[j][h] = make_uint4(0u, 0u, 0u, 0u);
        if (v < vecs && (keep || v * VEC >= hd)) raw[j][h] = vc::lds128(st + 16 * v);
      }
    }
    vc::mbar_arrive(empty + 8 * s);  // the stage is in registers: the producer may refill it

    float f[NP][2][VEC];
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 2 * (threadIdx.x + j * QUANT_THREADS) + h;
        if (v * VEC >= hd && v < vecs)
          vc::gelu8(raw[j][h], f[j][h]);
        else
          vc::unpack8(raw[j][h], f[j][h]);  // zeros past the row
        if (v < vecs) vc::smooth8(f[j][h], sinv, v * VEC);
        amax = vc::absmax8(f[j][h], amax);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) partial[k & 1][warp] = amax;
    consumers_sync();  // one barrier a row: the next row writes the other half of partial
    float m = partial[k & 1][0];
#pragma unroll
    for (int w = 1; w < QUANT_WARPS; ++w) m = fmaxf(m, partial[k & 1][w]);
    const float sc = vc::quant_scale(m);
    const float r = vc::quant_rcp(sc);
    const size_t seg_row = first ? (size_t)b * split + l : (size_t)b * (L - split) + (l - split);
    if (threadIdx.x == 0) (first ? scale0 : scale1)[seg_row] = sc;
    int8_t* out = (first ? codes0 : codes1) + seg_row * W;
    if (r != 0.0f)
      store_codes<NP, true>(f, sc, r, out, vecs, wide);
    else
      store_codes<NP, false>(f, sc, r, out, vecs, wide);
  }
}

template <int NP>
int launch_quant(const bf16* attn, const int* mask, const bf16* mlp, long long mb, long long ml, int B, int L, int H,
                 int D, int G, int split, const float* sinv0, int8_t* codes0, float* scale0, const float* sinv1,
                 int8_t* codes1, float* scale1, cudaStream_t stream) {
  const int smem = STAGES * 2 * (H * D + G);
  auto kern = merge_heads_quant_kernel<NP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * L, ctas = (long long)sms * quant_ctas_per_sm(NP);
  kern<<<(int)(rows < ctas ? rows : ctas), QUANT_THREADS + 32, smem, stream>>>(
      attn, mask, mlp, mb, ml, B, L, H, D, G, split, sinv0, codes0, scale0, sinv1, codes1, scale1);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel M. attn (B, H, L, D) bf16 contiguous; mask (B, L) int32 contiguous
// or null (nothing padded); mlp (B, L, G) bf16 at element strides mb, ml, its
// feature axis contiguous, or null with G = 0; out (B, L, ldo) bf16,
// ldo >= H * D + G, written in columns [0, H * D + G). D and G multiples of 8;
// ldo a multiple of 8; attn, mlp's rows and out 16-byte aligned. Launches on
// `stream`; returns a cudaError_t (0 on success).
extern "C" int merge_heads(const void* attn, const void* mask, const void* mlp, long long mb, long long ml, void* out,
                           int B, int L, int H, int D, int G, int ldo, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D % VEC || G % VEC || G < 0 || ldo % VEC || ldo < H * D + G ||
      (mlp == nullptr) != (G == 0))
    return (int)cudaErrorInvalidValue;
  const int vecs = H * D / VEC;
  const int threads = vecs >= MAX_THREADS ? MAX_THREADS : ((vecs + 31) / 32) * 32;
  merge_heads_kernel<<<B * L, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(attn), static_cast<const int*>(mask), static_cast<const bf16*>(mlp), mb, ml,
      static_cast<bf16*>(out), L, H, D, G, ldo);
  return (int)cudaGetLastError();
}

// Kernel M quantized. attn, mask, mlp (mb, ml), B, L, H, D, G as merge_heads;
// W = H * D + G at most MAX_QUANT_ROW. Rows l < split of each batch element
// go to segment 0 (a_sinv0, codes0 (B * split, W) int8, scale0 (B * split,)
// fp32), the others to segment 1 (a_sinv1, codes1 (B * (L - split), W),
// scale1); split 0: segment 1 alone (its pointers may be null). a_sinv (W,)
// fp32 16-byte aligned or null; codes 16-byte aligned. Launches on `stream`;
// returns a cudaError_t (0 on success).
extern "C" int merge_heads_quant(const void* attn, const void* mask, const void* mlp, long long mb, long long ml,
                                 int B, int L, int H, int D, int G, int split, const void* a_sinv0, void* codes0,
                                 void* scale0, const void* a_sinv1, void* codes1, void* scale1, void* stream) {
  const int w = H * D + G;
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || D % VEC || G % VEC || G < 0 || w > MAX_QUANT_ROW || split < 0 ||
      split >= L || (mlp == nullptr) != (G == 0) || (split > 0 && (codes0 == nullptr || scale0 == nullptr)) ||
      codes1 == nullptr || scale1 == nullptr)
    return (int)cudaErrorInvalidValue;
  const int pairs = (w / VEC + 1) / 2, np = (pairs + QUANT_THREADS - 1) / QUANT_THREADS;
  auto launch = np <= 1 ? launch_quant<1> : np <= 2 ? launch_quant<2> : np <= 4 ? launch_quant<4> : launch_quant<5>;
  return launch(static_cast<const bf16*>(attn), static_cast<const int*>(mask), static_cast<const bf16*>(mlp), mb, ml,
                B, L, H, D, G, split, static_cast<const float*>(a_sinv0), static_cast<int8_t*>(codes0),
                static_cast<float*>(scale0), static_cast<const float*>(a_sinv1), static_cast<int8_t*>(codes1),
                static_cast<float*>(scale1), static_cast<cudaStream_t>(stream));
}
