// Kernel J: the affine-free LayerNorm of a DiT block's input with the adaLN
// modulate, in one pass.
//
// Replaces an XLA fusion, not a Pallas kernel: visualcloze_tpu/models/
// layers.py `layer_norm` (:145) followed by `(1 + scale) * x + shift` in
// `double_block` (:247, :273), `single_block` (:330) and `last_layer`.
//
//     x32 = float(x[b, l, :]);  mu = mean(x32);  var = mean((x32 - mu)^2)
//     n = (x32 - mu) * rsqrt(var + 1e-6)
//     y[b, l, c] = (1 + scale[b, c]) * n + shift[b, c]       (fp32)
//
// stored as bf16 (round to nearest even) or fp32: bf16 where a cast to bf16
// follows (a dense, int8 or int4 linear, or the single block's .to(x.dtype)),
// fp32 where a w8a8 linear quantizes the fp32 value itself (kernel I: under a
// LoRA entry, a tp shard or autograd). On the fused w8a8 route the
// quantized variant (`layernorm_modulate_quant`) writes the consumer
// linear's int8 codes and row scale instead, kernel I folded in: y (fp32, or
// rounded to bf16 first where JAX casts it: the single block's linear1)
// times a_sinv, then act_quant.cuh's quantize over the row held in
// registers: the codes and scales of kernel I applied to J's own output,
// bit for bit. The variance is JAX's
// two-pass formula; the modulate rounds after each of its three operations,
// as the plain version's separate PyTorch ops do (no contraction into an
// FMA). The row sums run in another order than PyTorch's, so a bf16 output
// can differ by one ulp; the order is fixed, so two launches give the same
// bits.
//
// Bound on the H100 (3.35 TB/s): the bytes. A (3968, 3072) bf16 x read once
// (24.4 MB), the output written once (24.4 MB bf16, 48.8 MB fp32) and the
// (B, C) fp32 vectors: 0.015 ms bf16, 0.022 ms fp32. One CTA a row, C / 8
// threads (384 at C = 3072), each holding its 8 elements in registers from
// one 16-byte load, so x is read from device memory exactly once; two block
// sums (warp shuffles, then the warps' partials summed by every thread in
// one order). Quantized, (3968, 3072): x read, M * C int8 and M * 4 written
// (36.6 MB, 0.011 ms). There a CTA a row of C / 8 threads is bound by
// instructions, not bytes: each row's scalar work (three CTA-wide
// reductions, the divisions, the indexing) is repeated by all 384 threads
// for 8 values each, and 24-36 KB of vectors come from L2 for every 6 KB
// row. So the quantizing variant runs persistent CTAs (four an SM at C <=
// 3072), each walking rows blockIdx.x, + gridDim.x, ... of the B * L:
//   - 24 columns a thread (NCH = 3 chunks of 8: 128 threads a row at C =
//     3072), each chunk's sums kept apart, so every row sum is still kernel
//     J's: the chunk's 8 values in order, the xor butterfly of J's warp for
//     that chunk (a "virtual warp"), then those warps' partials in ascending
//     order. The codes stay, bit for bit, kernel I applied to J's output;
//   - (1 + scale), shift and a_sinv of the thread's columns read from L2
//     only where the batch element changes, kept in the thread's own slots
//     of shared memory (registers bind the CTAs an SM);
//   - x of the walk's next row loaded before the current row's reductions;
//   - one barrier a reduction, the partials double-buffered;
//   - the codes by act_quant.cuh's quant8_rcp (no conversion instruction).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "bf16.cuh"

namespace {

using vc::bf16;

constexpr int VEC = 8;        // elements a thread
constexpr int MAX_THREADS = 1024;

// the sum of v over the CTA, the same bits in every thread
__device__ __forceinline__ float block_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) s += partial[w];
  __syncthreads();  // partial is reused by the next sum
  return s;
}

__device__ __forceinline__ void store8(bf16* y, const float* f) { *reinterpret_cast<uint4*>(y) = vc::pack8(f); }
__device__ __forceinline__ void store8(float* y, const float* f) {
  reinterpret_cast<float4*>(y)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The modulated row's 8 values of this thread into f (zeros past C, where it
// returns false): every thread of the CTA takes part in the two block sums.
__device__ __forceinline__ bool modulate8(const bf16* __restrict__ x, long long sb, long long sl,
                                         const float* __restrict__ scale, long long s_scale,
                                         const float* __restrict__ shift, long long s_shift, int L, int C,
                                         float* partial, float* f) {
  const int row = blockIdx.x;
  const int b = row / L, l = row - b * L;
  const int c = threadIdx.x * VEC;
  const bool on = c < C;
  if (on) {
    vc::unpack8(__ldg(reinterpret_cast<const uint4*>(x + b * sb + l * sl + c)), f);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = 0.0f;
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s += f[i];
  const float mu = __fdiv_rn(block_sum(s, partial), (float)C);
  float d2 = 0.0f;
  if (on) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = __fsub_rn(f[i], mu);
      d2 = __fmaf_rn(d, d, d2);
    }
  }
  const float var = __fdiv_rn(block_sum(d2, partial), (float)C);
  const float r = rsqrtf(__fadd_rn(var, 1e-6f));
  if (!on) return false;
  const float4* sc = reinterpret_cast<const float4*>(scale + b * s_scale + c);
  const float4* sh = reinterpret_cast<const float4*>(shift + b * s_shift + c);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // four columns at a time: fewer values live at once
    const float4 s4 = __ldg(sc + h), t4 = __ldg(sh + h);
    const float scs[4] = {s4.x, s4.y, s4.z, s4.w}, shs[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float& v = f[4 * h + j];
      const float n = __fmul_rn(__fsub_rn(v, mu), r);
      v = __fadd_rn(__fmul_rn(__fadd_rn(1.0f, scs[j]), n), shs[j]);
    }
  }
  return true;
}

template <typename OutT>
__global__ void __launch_bounds__(MAX_THREADS)
    ln_modulate_kernel(const bf16* __restrict__ x, long long sb, long long sl, const float* __restrict__ scale,
                       long long s_scale, const float* __restrict__ shift, long long s_shift, OutT* __restrict__ y,
                       int L, int C) {
  __shared__ float partial[MAX_THREADS / 32];
  float f[VEC];
  if (!modulate8(x, sb, sl, scale, s_scale, shift, s_shift, L, C, partial, f)) return;
  store8(y + (size_t)blockIdx.x * C + threadIdx.x * VEC, f);
}

// The quantizing kernel's CTA: NCH chunks of 8 columns a thread, chunk k =
// threadIdx.x + j * blockDim.x (j < NCH), so a row of C columns takes
// ceil(C / (8 NCH)) threads rounded up to warps. Chunk k belongs to kernel
// J's warp k / 32 -- its "virtual warp" j * (blockDim.x / 32) + warp -- so a
// row sum can be taken in J's order: each chunk's 8 values in order, the
// xor butterfly of each virtual warp (one butterfly a chunk slot, across the
// real warp's lanes), then the virtual warps' partials in ascending order.
constexpr int NCH = 3;
// CTAs an SM by the largest CTA (registers bind it): 4 of the DiT's 128 threads (C = 3072)
constexpr int quant_ctas_per_sm(int max_threads) { return max_threads <= 128 ? 4 : 1; }

// The sum over the row of the per-chunk values v[j], in kernel J's order,
// with one barrier: buf is a half of the double-buffered partials (one slot
// a virtual warp, MAXW in all), which the next reduction does not write. Its
// slots past the CTA's virtual warps hold +0 (set at the kernel's start), so
// the sum runs over all MAXW with no bound to test: J's sum, then + 0 (exact:
// that sum starts from +0, so it is never -0; the chunks past C are zeros,
// and their virtual warps follow every one that holds columns).
template <int MAXW>
__device__ __forceinline__ float row_sum(float (&v)[NCH], float* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) buf[j * (blockDim.x >> 5) + (threadIdx.x >> 5)] = v[j];
  }
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) s += buf[w];
  return s;
}

// the max over the row of the per-chunk values v[j] >= 0, as row_sum (the +0 slots change no max)
template <int MAXW>
__device__ __forceinline__ float row_max(float (&v)[NCH], float* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) v[j] = fmaxf(v[j], __shfl_xor_sync(0xffffffffu, v[j], o));
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) buf[j * (blockDim.x >> 5) + (threadIdx.x >> 5)] = v[j];
  }
  __syncthreads();
  float m = buf[0];
#pragma unroll
  for (int w = 1; w < MAXW; ++w) m = fmaxf(m, buf[w]);
  return m;
}

// A thread's own (1 + scale), shift and a_sinv (vector 0, 1, 2) of its
// chunks, kept in dynamic shared memory rather than registers: float4
// planes of blockDim.x, thread t's at [plane][t], written and read by t
// alone (no barrier).
struct OwnVectors {
  float4* p;
  __device__ __forceinline__ float4* at(int vec, int j, int half) const {
    return p + ((vec * NCH + j) * 2 + half) * blockDim.x + threadIdx.x;
  }
  __device__ __forceinline__ void put(int vec, int j, const float* v) const {
    *at(vec, j, 0) = make_float4(v[0], v[1], v[2], v[3]);
    *at(vec, j, 1) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ __forceinline__ void get(int vec, int j, float* v) const {
    const float4 a = *at(vec, j, 0), b = *at(vec, j, 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
};
constexpr int OWN_VECTORS = 3;

__device__ __forceinline__ void load8f(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p)), b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Kernel J quantized, persistent: a CTA walks rows blockIdx.x, + gridDim.x,
// ... of the B * L, each through modulate8's arithmetic in its order, (rounded
// to bf16 where RoundBf16,) times a_sinv, quantized: codes[row, :] int8 and
// xscale[row] fp32.
template <bool RoundBf16, int MAXT>
__global__ void __launch_bounds__(MAXT, quant_ctas_per_sm(MAXT))
    ln_modulate_quant_kernel(const bf16* __restrict__ x, long long sb, long long sl, const float* __restrict__ scale,
                             long long s_scale, const float* __restrict__ shift, long long s_shift,
                             const float* __restrict__ a_sinv, int8_t* __restrict__ codes, float* __restrict__ xscale,
                             int B, int L, int C) {
  constexpr int MAXW = MAXT / 32 * NCH;
  extern __shared__ float4 own_planes[];
  __shared__ __align__(16) float partial[2][MAXW];
  const OwnVectors own{own_planes};
  const int rows = B * L, stride = gridDim.x;
  int col[NCH];
  bool on[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    col[j] = VEC * (threadIdx.x + j * blockDim.x);
    on[j] = col[j] < C;
  }
  for (int i = threadIdx.x; i < 2 * MAXW; i += blockDim.x)  // the slots of virtual warps this CTA does not have
    if (i % MAXW >= NCH * (int)(blockDim.x >> 5)) (&partial[0][0])[i] = 0.0f;
  if (a_sinv != nullptr) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (!on[j]) continue;
      float v[VEC];
      load8f(a_sinv + col[j], v);
      own.put(2, j, v);
    }
  }
  // x of the next row of the walk in flight: its registers are refilled with the row after as soon as they
  // are read. (b, l) of that row followed by adding the stride, not by a division a row.
  uint4 xs[NCH];
  int b = blockIdx.x / L, l = blockIdx.x - (blockIdx.x / L) * L;  // the next row's
  auto load_next = [&]() {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      xs[j] = make_uint4(0u, 0u, 0u, 0u);
      if (on[j]) xs[j] = __ldg(reinterpret_cast<const uint4*>(x + b * sb + l * sl + col[j]));
    }
  };
  if (blockIdx.x < rows) load_next();
  int held = -1, red = 0;  // held: the batch element of the thread's (1 + scale) and shift
  for (int row = blockIdx.x; row < rows; row += stride) {
    float f[NCH][VEC];
#pragma unroll
    for (int j = 0; j < NCH; ++j) vc::unpack8(xs[j], f[j]);  // zeros past C
    const int rb = b;
    for (l += stride; l >= L; l -= L) ++b;
    if (row + stride < rows) load_next();
    if (rb != held) {
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        if (!on[j]) continue;
        float v[VEC];
        load8f(scale + rb * s_scale + col[j], v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = __fadd_rn(1.0f, v[i]);
        own.put(0, j, v);
        load8f(shift + rb * s_shift + col[j], v);
        own.put(1, j, v);
      }
      held = rb;
    }
    // modulate8's arithmetic in its order
    float t[NCH];
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      t[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) t[j] += f[j][i];
    }
    const float mu = __fdiv_rn(row_sum<MAXW>(t, partial[red++ & 1]), (float)C);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      t[j] = 0.0f;
      if (on[j]) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = __fsub_rn(f[j][i], mu);
          t[j] = __fmaf_rn(d, d, t[j]);
        }
      }
    }
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(row_sum<MAXW>(t, partial[red++ & 1]), (float)C), 1e-6f));
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (on[j]) {
        float sc1[VEC], sh[VEC];
        own.get(0, j, sc1);
        own.get(1, j, sh);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float n = __fmul_rn(__fsub_rn(f[j][i], mu), r);
          f[j][i] = __fadd_rn(__fmul_rn(sc1[i], n), sh[i]);
          if (RoundBf16) f[j][i] = __bfloat162float(__float2bfloat16_rn(f[j][i]));
        }
        if (a_sinv != nullptr) {
          float as[VEC];
          own.get(2, j, as);
#pragma unroll
          for (int i = 0; i < VEC; ++i) f[j][i] = __fmul_rn(f[j][i], as[i]);
        }
      }
      t[j] = vc::absmax8(f[j], 0.0f);  // zeros past C
    }
    const float sc = vc::quant_scale(row_max<MAXW>(t, partial[red++ & 1]));
    const float rc = vc::quant_rcp(sc);
    if (threadIdx.x == 0) xscale[row] = sc;
    int8_t* out = codes + (size_t)row * C;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (on[j])
        *reinterpret_cast<uint2*>(out + col[j]) = rc != 0.0f ? vc::quant8_rcp(f[j], sc, rc) : vc::quant8(f[j], sc, rc);
    }
  }
}

template <bool RoundBf16, int MAXT>
int launch_quant(const bf16* x, long long sb, long long sl, const float* scale, long long s_scale,
                 const float* shift, long long s_shift, const float* a_sinv, int8_t* codes, float* xscale, int B,
                 int L, int C, int threads, cudaStream_t stream) {
  const int smem = OWN_VECTORS * NCH * 2 * threads * (int)sizeof(float4);  // 36 KB at C = 3072, 96 KB at 8192
  auto kern = ln_modulate_quant_kernel<RoundBf16, MAXT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * L, ctas = (long long)sms * quant_ctas_per_sm(MAXT);
  kern<<<(int)(rows < ctas ? rows : ctas), threads, smem, stream>>>(x, sb, sl, scale, s_scale, shift, s_shift, a_sinv,
                                                                    codes, xscale, B, L, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel J. x (B, L, C) bf16 with element strides sb (batch) and sl (row),
// its rows contiguous; scale and shift fp32 rows of C at element strides
// s_scale and s_shift a batch; y (B, L, C) contiguous, bf16 (y_bf16 = 1) or
// fp32. Every row start and both vectors 16-byte aligned; C a multiple of 8,
// at most 8192. Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int layernorm_modulate(const void* x, long long sb, long long sl, const void* scale, long long s_scale,
                                  const void* shift, long long s_shift, void* y, int B, int L, int C, int y_bf16,
                                  void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % VEC || C > VEC * MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int threads = ((C / VEC + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (y_bf16)
    ln_modulate_kernel<bf16><<<B * L, threads, 0, s>>>(xp, sb, sl, sc, s_scale, sh, s_shift,
                                                       static_cast<bf16*>(y), L, C);
  else
    ln_modulate_kernel<float><<<B * L, threads, 0, s>>>(xp, sb, sl, sc, s_scale, sh, s_shift,
                                                        static_cast<float*>(y), L, C);
  return (int)cudaGetLastError();
}

// Kernel J with the quantize: x, scale, shift as layernorm_modulate; a_sinv
// (C,) fp32 16-byte aligned or null; codes (B * L, C) int8 and xscale
// (B * L,) fp32 contiguous, codes 8-byte aligned; round_bf16: the value is
// rounded to bf16 before a_sinv. Launches on `stream`; returns a cudaError_t
// (0 on success).
extern "C" int layernorm_modulate_quant(const void* x, long long sb, long long sl, const void* scale,
                                        long long s_scale, const void* shift, long long s_shift, const void* a_sinv,
                                        void* codes, void* xscale, int B, int L, int C, int round_bf16,
                                        void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % VEC || C > VEC * MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int threads = (((C / VEC + NCH - 1) / NCH + 31) / 32) * 32;  // chunks of 8, NCH a thread
  constexpr int SMALL = 128, LARGE = 384;  // C <= 3072 (the DiT's), C <= 8192
  auto launch = threads <= SMALL ? (round_bf16 ? launch_quant<true, SMALL> : launch_quant<false, SMALL>)
                                 : (round_bf16 ? launch_quant<true, LARGE> : launch_quant<false, LARGE>);
  return launch(static_cast<const bf16*>(x), sb, sl, static_cast<const float*>(scale), s_scale,
                static_cast<const float*>(shift), s_shift, static_cast<const float*>(a_sinv),
                static_cast<int8_t*>(codes), static_cast<float*>(xscale), B, L, C, threads,
                static_cast<cudaStream_t>(stream));
}
