// Kernel B: GroupNorm affine + swish + 3x3 SAME conv in one pass, NHWC.
//
// Replaces visualcloze_tpu/ops/conv2d.py:conv3x3_fused (Pallas bodies _kernel
// and _kernel_wtiled), called from every VAE resnet half-block
// (autoencoder._gn_swish_conv) and, without affine or activation, from every
// upsample conv:
//
//   y = conv3x3_SAME(act(x * a + b0), w) + bias
//
// x (B, H, W, C) bf16, w (3, 3, C, Cout) bf16, bias (Cout) fp32, a and b0
// (B, C) fp32 or null, y (B, H, W, Cout) bf16. The activation runs in fp32 and
// is rounded to bf16; positions outside the image are zero AFTER the
// activation (swish(b0) != 0 on the border). The residual add stays outside.
//
// Bound on the H100: 2*H*W*C*Cout*9 tensor-core FLOPs against
// (H*W*(C + Cout) + 9*C*Cout)*2 bytes: at 384x1152 with C = Cout = 128 that
// is 1.30e11 FLOPs -> 0.132 ms at 989 TFLOP/s versus 0.068 ms for the 226 MB
// at 3.35 TB/s, so compute-bound; every VAE level likewise.
//
// Design (Hopper: an implicit GEMM on wgmma, TMA, warp specialisation):
//   - the GEMM: M = output pixels, N = 128 output channels, K = 9 taps x C in
//     64-channel chunks. A CTA of 512 threads owns 4 output rows x 64 columns
//     (256 pixels: each wgmma's 64 rows are 64 consecutive pixels of one
//     output row) x 128 output channels; consumer warpgroup c (warpgroups 2
//     and 3, setmaxnreg 200) owns output rows 2c and 2c + 1, two m64n128
//     fp32 accumulators;
//   - the halo: a warp of warpgroup 0 (setmaxnreg 40) loads the raw
//     (4 + 2) x (64 + 2) x 64-channel halo of each chunk by TMA from a 4-D
//     tensor map over NHWC x (pixels outside the image and channels past C
//     arrive as zeros). Warpgroup 1 (setmaxnreg 64; a warp on each of the
//     SM's four sub-partitions, for the SFU's exp and rcp) transforms it
//     once per chunk into the A buffer: the fp32 affine + swish (ex2 and rcp
//     approximations within 2 fp32 ulps), zero outside the image AFTER
//     the activation, one rounding to bf16, written in the unswizzled
//     K-major layout [8-channel group][halo pixel][8 channels] (two A
//     buffers: the next chunk's transform runs under this chunk's products);
//   - each tap is a shifted view of that buffer: the A descriptor of output
//     row r and tap (di, dj) starts at halo pixel (r + di) * 66 + dj, 16
//     bytes a pixel (LBO = one channel group, SBO = 8 pixels), so the 9 taps
//     read the one transformed halo and nothing is transformed twice;
//   - the weights stream by TMA per (chunk, tap): 64 channels x 128 outputs,
//     128-byte swizzle, an MN-major B operand, in a 4-stage ring; the
//     consumers free a stage as soon as the wgmma reading it is done
//     (wgmma.wait_group 1 after the next tap's products are issued). 256
//     pixels a CTA re-read 9*64*128*2 bytes of weights per chunk: ~1.9 TB/s
//     from L2 at the tensor cores' rate;
//   - persistent CTAs, one an SM, walk the output tiles; the producer's
//     warps run ahead across tile boundaries, so the next tile's first halo
//     is loaded and transformed while this tile's last products run;
//   - the epilogue adds the fp32 bias, rounds once to bf16 into a swizzled
//     staging tile (in the tile's last A buffer, once both warpgroups'
//     products are done) and stores it by TMA: rows, columns and channels
//     past the tensor's end are not written. The residual add stays with
//     the caller, as in JAX.
// Every H, W >= 1 is taken; C and Cout must be multiples of 8 (TMA strides).
// The order of every sum is fixed: two launches give the same bits.
// Variants measured on the H100 and not kept (PERF.md): the transform in two
// warps of the TMA warpgroup with an IEEE divide (0.81 against 0.24 ms at
// 384x1152: the swish, not the tensor cores, set the pace); one CTA a tile
// instead of persistent CTAs (0.89 ms, with that transform); 2-row tiles
// for small grids (+25% at the large shapes, +4% at 48x144x512, whose 144
// tiles on 132 SMs they were meant to even out).
#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "hopper.cuh"

namespace {

using namespace vc;

constexpr int NT = 512;          // TMA warpgroup, transform warpgroup, two consumer warpgroups
constexpr int TH = 4, TW = 64;   // output pixel tile: 4 rows of 64
constexpr int BN = 128;          // output channels per CTA
constexpr int KC = 64;           // input channels per chunk
constexpr int HW = TW + 2;       // halo columns
constexpr int WST = 4;           // stages of the weight ring
constexpr int W_BYTES = KC * BN * 2;   // one tap of one chunk: 2 boxes [64 ch][64 n], 16 KB
constexpr int HH = TH + 2, HP = HH * HW;  // the halo: 6 x 66 pixels
constexpr int RAW_BYTES = HP * KC * 2;      // the raw halo [6][66][64 ch], 50,688
constexpr int GSTRIDE = HP * 16;            // one 8-channel group of the A buffer
constexpr int A_BYTES = KC / 8 * GSTRIDE;   // the A buffer [8 groups][396 pixels][8 ch], 50,688
constexpr int A_STRIDE = (A_BYTES + 1023) / 1024 * 1024;  // A buffers start on 1024 bytes: staging tiles
constexpr int MT = TH / 2;                  // m-tiles (output rows) of each consumer warpgroup
constexpr int TRANSFORM_THREADS = 128;  // warpgroup 1: a warp on each SM sub-partition

// shared memory (bytes from a 1024-byte aligned base): W[WST], raw halo, A[2]
// (each also the epilogue's staging tiles of the tile whose last chunk it
// held), then the mbarriers W full[WST], W empty[WST], raw full, raw empty,
// A full[2], A empty[2]
constexpr int SM_W = 0, SM_RAW = WST * W_BYTES;
constexpr int SM_A = SM_RAW + (RAW_BYTES + 1023) / 1024 * 1024;
constexpr int SM_BAR = SM_A + 2 * A_STRIDE;
constexpr size_t SMEM = SM_BAR + 8 * (2 * WST + 6) + 1024;
static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
static_assert(2 * TW * BN * 2 <= A_BYTES, "the staging tiles must fit an A buffer");

// setmaxnreg from the 128 registers a thread has at launch (512 threads, one
// CTA an SM): 128 * (128 - 40) + 128 * (128 - 64) >= 256 * (200 - 128)
constexpr int TMA_REGS = 40, TRANSFORM_REGS = 64, CONSUMER_REGS = 200;

// t * sigmoid(t): one ex2 and one rcp (MUFU), each within 2 ulps in fp32,
// far below the bf16 rounding that follows
__device__ __forceinline__ float swish(float t) { return __fdividef(t, 1.0f + __expf(-t)); }

// the MT m-tiles of one (chunk, tap): k16 steps of the A buffer at abuf
// (output rows lr0 .. lr0 + MT - 1 of the tile) against the weight stage at wt
__device__ __forceinline__ void issue_tap(float (*acc)[64], uint32_t abuf, uint32_t wt, int lr0, int tap) {
  const int di = tap / 3, dj = tap % 3;
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    const uint64_t b = gmma_desc(wt + ks * 16 * 128, KC * 128, 1024);  // MN-major, N = 2 boxes of 64
    const uint32_t a = abuf + 2 * ks * GSTRIDE;                        // channel groups 2ks, 2ks + 1
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      wgmma_m64n128_ss_tb(acc[mt], gmma_desc_plain(a + ((lr0 + mt + di) * HW + dj) * 16, GSTRIDE, 128), b);
  }
  wgmma_commit();
}

// named barrier 2 + c among the 128 threads of consumer warpgroup c
__device__ __forceinline__ void wg_barrier(int c) {
  if (c == 0)
    named_barrier<2, 128>();
  else
    named_barrier<3, 128>();
}

// acc (64 pixels x 128 channels of output row `row`) + bias, rounded to bf16
// into the staging tile at st ([2 halves][64 pixels][64 channels], 128-byte
// swizzle), then stored by TMA (one thread of the warpgroup); returns once
// the store has read the tile
__device__ __forceinline__ void store_tile(const float* acc, const float* bias_r, unsigned char* st, uint32_t st_addr,
                                           const CUtensorMap* ty, int tid, int c, int n0, int c0, int row, int b) {
  const int lane = tid % 32, t = lane % 4;
  const int p = 16 * (tid / 32) + lane / 4;  // this thread's pixels p, p + 8
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int px = p + 8 * r;
      const int off = (j / 8) * TW * 128 + px * 128 + (((j & 7) ^ (px & 7)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(st + off) =
          pack2(acc[4 * j + 2 * r] + bias_r[2 * j], acc[4 * j + 2 * r + 1] + bias_r[2 * j + 1]);
    }
  }
  fence_proxy_async();
  wg_barrier(c);
  if (tid == 0) {
    tma_store_4d(ty, st_addr, n0, c0, row, b);
    tma_store_4d(ty, st_addr + TW * 128, n0 + 64, c0, row, b);
    bulk_commit();
    bulk_wait_read();
  }
  wg_barrier(c);
}

// the output tiles in launch order: the Cout blocks of one pixel tile are
// neighbours (they read the same halo), then columns, rows, images
struct Tiles {
  int nblocks, tiles_w, tiles_h, count;
  __device__ __forceinline__ void at(int i, int& b, int& r0, int& c0, int& n0) const {
    n0 = (i % nblocks) * BN;
    i /= nblocks;
    c0 = (i % tiles_w) * TW;
    i /= tiles_w;
    r0 = (i % tiles_h) * TH;
    b = i / tiles_h;
  }
};

template <bool PRE, bool SWISH>
__global__ void __launch_bounds__(NT, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap ty, const float* __restrict__ bias,
                   const float* __restrict__ a, const float* __restrict__ b0, int H, int W, int C, int Cout,
                   Tiles tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t wfull = base + SM_BAR, wempty = wfull + 8 * WST, rfull = wempty + 8 * WST, rempty = rfull + 8,
                 afull = rempty + 8, aempty = afull + 16;
  const int nchunks = (C + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WST; ++s) {
      mbar_init(wfull + 8 * s, 1);     // the weight warp, with the TMA bytes
      mbar_init(wempty + 8 * s, 256);  // every consumer thread
    }
    mbar_init(rfull, 1);
    mbar_init(rempty, TRANSFORM_THREADS);
    for (int i = 0; i < 2; ++i) {
      mbar_init(afull + 8 * i, TRANSFORM_THREADS);
      mbar_init(aempty + 8 * i, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // every role walks the same tiles (blockIdx.x, + gridDim.x, ...) and
  // counts the chunks it has passed (gk): chunk gk fills A buffer gk & 1
  int b, r0, c0, n0;
  const int wg = warpgroup();
  if (wg == 0) {  // ------------------------------------------------ TMA
    setmaxnreg_dec<TMA_REGS>();
    const int warp = threadIdx.x / 32;
    if (warp == 0) {  // the weights: one (chunk, tap) a stage
      if (threadIdx.x == 0) {
        Slot<WST> sl;
        int i = 0;
        for (int tile = blockIdx.x; tile < tiles.count; tile += gridDim.x) {
          tiles.at(tile, b, r0, c0, n0);
          for (int step = 0; step < nchunks * 9; ++step, ++i, sl.next()) {
            if (i >= WST) mbar_wait(wempty + 8 * sl.s, sl.phase ^ 1);
            const uint32_t dst = base + SM_W + sl.s * W_BYTES, full = wfull + 8 * sl.s;
            mbar_arrive_expect_tx(full, W_BYTES);
            const int k0 = (step / 9) * KC, tap = step % 9;
            tma_load_4d(dst, &tw, n0, k0, tap, 0, full);
            tma_load_4d(dst + KC * 128, &tw, n0 + 64, k0, tap, 0, full);
          }
        }
      }
    } else if (warp == 1) {  // the raw halo of each chunk
      if (threadIdx.x == 32) {
        int gk = 0;
        for (int tile = blockIdx.x; tile < tiles.count; tile += gridDim.x) {
          tiles.at(tile, b, r0, c0, n0);
          for (int k = 0; k < nchunks; ++k, ++gk) {
            if (gk > 0) mbar_wait(rempty, (gk - 1) & 1);
            mbar_arrive_expect_tx(rfull, RAW_BYTES);
            tma_load_4d(base + SM_RAW, &tx, k * KC, c0 - 1, r0 - 1, b, rfull);
          }
        }
      }
    }
  } else if (wg == 1) {  // ------------------------------------------------ transform
    // raw halo -> act(x * a + b0), zero outside the image, bf16 -> A buffer
    setmaxnreg_dec<TRANSFORM_REGS>();
    {
      const int tt = threadIdx.x - 128;
      const int grp = tt % 8;  // this thread's 8-channel group of every chunk
      const unsigned char* raw = smem + SM_RAW;
      int gk = 0;
      for (int tile = blockIdx.x; tile < tiles.count; tile += gridDim.x) {
        tiles.at(tile, b, r0, c0, n0);
        for (int k = 0; k < nchunks; ++k, ++gk) {
          const int ab = gk & 1;
          float sa[8], sb[8];
          const int ch0 = k * KC + 8 * grp;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool in = PRE && ch0 + i < C;
            sa[i] = in ? a[(size_t)b * C + ch0 + i] : 0.0f;
            sb[i] = in ? b0[(size_t)b * C + ch0 + i] : 0.0f;
          }
          if (gk >= 2) mbar_wait(aempty + 8 * ab, ((gk - 2) >> 1) & 1);
          mbar_wait(rfull, gk & 1);
          unsigned char* abuf = smem + SM_A + ab * A_STRIDE + grp * GSTRIDE;
          for (int p = tt / 8; p < HP; p += TRANSFORM_THREADS / 8) {
            uint4 v = *reinterpret_cast<const uint4*>(raw + p * (KC * 2) + grp * 16);
            if (PRE) {
              const int gr = r0 - 1 + p / HW, gc = c0 - 1 + p % HW;
              if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
                float f[8];
                unpack8(v, f);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  const float u = f[i] * sa[i] + sb[i];
                  f[i] = SWISH ? swish(u) : u;
                }
                v = pack8(f);
              } else {
                v = make_uint4(0, 0, 0, 0);
              }
            }
            *reinterpret_cast<uint4*>(abuf + p * 16) = v;
          }
          fence_proxy_async();  // the A buffer is read by wgmma (the async proxy)
          mbar_arrive(rempty);
          mbar_arrive(afull + 8 * ab);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 2;
    const int tid = threadIdx.x % 128, t = tid % 4;
    const int lr0 = MT * c;  // this warpgroup's output rows of the tile: lr0 .. lr0 + MT - 1
    float acc[MT][64];
    Slot<WST> ws, prev;
    int gk = 0;
    for (int tile = blockIdx.x; tile < tiles.count; tile += gridDim.x) {
      tiles.at(tile, b, r0, c0, n0);
#pragma unroll
      for (int i = 0; i < MT * 64; ++i) acc[i / 64][i % 64] = 0.0f;
      for (int step = 0; step < nchunks * 9; ++step, ws.next()) {
        const int tap = step % 9;
        if (tap == 0) {
          if (step > 0) ++gk;
          mbar_wait(afull + 8 * (gk & 1), (gk >> 1) & 1);
        }
        mbar_wait(wfull + 8 * ws.s, ws.phase);
        wgmma_fence();
        issue_tap(acc, base + SM_A + (gk & 1) * A_STRIDE, base + SM_W + ws.s * W_BYTES, lr0, tap);
        if (step > 0) {  // the step before is done: free its weight stage (and its A buffer after its last tap)
          wgmma_wait<1>();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) fence_operands<64>(acc[mt]);
          mbar_arrive(wempty + 8 * prev.s);
          if (tap == 0) mbar_arrive(aempty + 8 * ((gk - 1) & 1));
          prev.next();
        }
      }
      wgmma_wait0();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_operands<64>(acc[mt]);
      mbar_arrive(wempty + 8 * prev.s);
      prev.next();

      // epilogue: + bias, bf16, TMA store, staged in this tile's last A
      // buffer once both warpgroups' products are done; the next tile's
      // loads and transform meanwhile fill the other
      float bias_r[BN / 4];  // this thread's 32 output channels: 8j + 2t, + 1
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + 2 * t + e;
          bias_r[2 * j + e] = n < Cout ? bias[n] : 0.0f;
        }
      named_barrier<1, 256>();
      const int off = SM_A + (gk & 1) * A_STRIDE + c * TW * BN * 2;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        store_tile(acc[mt], bias_r, smem + off, base + off, &ty, tid, c, n0, c0, r0 + lr0 + mt, b);
      mbar_arrive(aempty + 8 * (gk & 1));
      ++gk;
    }
    if (tid == 0) bulk_wait();
  }
}

template <bool PRE, bool SWISH>
int launch(const void* x, const void* w, const void* bias, const void* a, const void* b0, void* y, int B, int H,
           int W, int C, int Cout, cudaStream_t stream) {
  CUtensorMap m[3];
  {  // x (B, H, W, C): boxes of 64 channels x 66 columns x 6 rows, unswizzled
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
    const cuuint32_t box[4] = {KC, HW, HH, 1};
    int err = encode_map(&m[0], x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
  }
  {  // w (9, C, Cout): boxes of 64 outputs x 64 channels of one tap, 128-byte swizzle
    const cuuint64_t dims[4] = {(cuuint64_t)Cout, (cuuint64_t)C, 9, 1};
    const cuuint64_t strides[3] = {(cuuint64_t)Cout * 2, (cuuint64_t)C * Cout * 2, (cuuint64_t)9 * C * Cout * 2};
    const cuuint32_t box[4] = {64, KC, 1, 1};
    int err = encode_map(&m[1], w, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  {  // y (B, H, W, Cout): boxes of 64 outputs x 64 pixels of one row, 128-byte swizzle
    const cuuint64_t dims[4] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)Cout * 2, (cuuint64_t)W * Cout * 2, (cuuint64_t)H * W * Cout * 2};
    const cuuint32_t box[4] = {64, TW, 1, 1};
    int err = encode_map(&m[2], y, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  auto kern = conv3x3_kernel<PRE, SWISH>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  Tiles tiles;
  tiles.nblocks = (Cout + BN - 1) / BN;
  tiles.tiles_w = (W + TW - 1) / TW;
  tiles.tiles_h = (H + TH - 1) / TH;
  tiles.count = B * tiles.nblocks * tiles.tiles_w * tiles.tiles_h;
  const int grid = tiles.count < sms ? tiles.count : sms;  // persistent: one CTA an SM
  kern<<<grid, NT, SMEM, stream>>>(m[0], m[1], m[2], static_cast<const float*>(bias), static_cast<const float*>(a),
                                   static_cast<const float*>(b0), H, W, C, Cout, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int conv3x3_gn_swish(const void* x, const void* w, const void* bias, const void* a,
                                const void* b0, void* y, int B, int H, int W, int C, int Cout,
                                int pre, int swish, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % 8 || Cout % 8 || (swish && !pre))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pre && swish) return launch<true, true>(x, w, bias, a, b0, y, B, H, W, C, Cout, s);
  if (pre) return launch<true, false>(x, w, bias, a, b0, y, B, H, W, C, Cout, s);
  return launch<false, false>(x, w, bias, a, b0, y, B, H, W, C, Cout, s);
}
