// The wide-M body of the weight-only matmuls, kernels G (int8_matmul.cu) and
// G4 (int4_matmul.cu): y = x @ W, x (M, K) bf16, W (K, N) stored quantized
// and converted to bf16 in shared memory. A convert policy Cv<CL> says how a
// stored tile becomes bf16; everything else is shared: a warp-specialised
// wgmma kernel of 512 threads, one CTA an SM, one 128 x 256 output tile a
// CTA, launched alone (CL = 1) or in pairs (CL = 2) as the wrapper asks.
//
// The pair: the CTAs run as clusters of two along M. The two CTAs of a
// cluster share n0 and take neighbouring 128-row x tiles, and each
// converts HALF of every stage's stored w tile (the K rows [32 r, 32 r + 32)
// of the 64, r its rank) into its own bf16 B buffer, then sends that half
// into its peer's buffer by bulk copy (cp.async.bulk from shared memory to
// the peer's, its bytes completing on the peer's bfull as a TMA load's do;
// generic stores to the peer published by cluster-scope fences and arrives
// cost the H100 1-2 us a stage). So a w tile crosses L2 once and is
// converted once for 256 rows of x, where a lone CTA pays both for 128 rows:
// the convert, which sets the pace of the lone body on the H100, halves per
// MMA, and the B ring deepens (a CTA's share of w takes half the shared
// memory). The grid's M dimension is rounded up to even: a CTA whose rows
// all lie past M loads no x, converts and arrives as its peer needs, and
// stores nothing. Where that rounding adds a wave of CTAs (an odd count of
// 128-row tiles whose last pair would start a wave of its own) the wrapper
// launches lone CTAs instead (ops/int8_matmul.py:wide_pairs).
//
//   - the x tiles (128 rows x 64 K, bf16, 128-byte swizzle: the K-major A
//     operand; rows past M arrive as zeros) and the CTA's share of the
//     stored w tiles (Cv::W_ROWS / CL rows x 256 N bytes; columns past N
//     arrive as zeros, so w crosses device memory in its stored form) come
//     by TMA into two 4-stage mbarrier rings, each loaded by its readers:
//     each consumer warpgroup's first thread loads its 64 rows of x, and
//     refills a slot once its products of that stage are done; the
//     transform's thread 0 loads w, and refills a slot once every transform
//     warp has read it. So no warp only issues loads, and all eight warps
//     of warpgroups 0 and 1 convert;
//   - warpgroups 0 and 1 (setmaxnreg Cv::TRANSFORM_REGS) convert the CTA's
//     share (Cv::convert) into a Cv::BST-stage bf16 B ring in the 128-byte
//     swizzled MN-major layout (two K halves of four 64-column blocks of 32
//     rows, b_offset): a (K, N) row-major tile converted is an MN-major B
//     operand, so no operand is transposed. The 32 quarter warps take the
//     stage's sets evenly (64 or 128; 28 quarter warps beside a warp that
//     only loaded took 3 where 2.3 was their share, and the slowest sets the
//     pace). Alone, each warp then arrives on bfull; paired, they meet at a
//     named barrier, then thread 0 arrives on bfull with the byte count of
//     the peer's half and copies this CTA's half to the peer (one 16 KB bulk
//     copy; four of 4 KB, a 64-column block each, were 2-4% slower);
//   - warpgroups 2 and 3 (setmaxnreg Cv::CONSUMER_REGS) own 64 rows x 256
//     columns each in fp32 (128 registers) and issue SS wgmma, two
//     m64n128k16 a k16 step (x from the ring, K-major; the converted w,
//     MN-major; one m64n256 needs more than the 128 registers ptxas allows a
//     thread of a 512-thread CTA), one commit group in flight: a stage's x
//     and its bf16 buffer are freed (the x slot refilled, one arrival a
//     warp on bempty) once the products of the next stage are issued and
//     the ones reading them are done. A paired B buffer is written by both
//     CTAs, so each consumer warp arrives on bempty of both: it is refilled
//     only when the consumers of the pair are done with it;
//   - the epilogue scales the sums by scale[n] in fp32 where the policy
//     leaves the scale to it (Cv::EPILOGUE_SCALE; each consumer thread
//     loads one column's before the products and the epilogue exchanges
//     them through the w ring), rounds once to OutT; where a bias is given
//     (BIAS, bf16 out only) it then adds the column pair's bf16 bias with
//     one add.rn.bf16x2, bf16(float(bf16(acc * scale[n])) + float(b[n])):
//     the product rounded to bf16 and then `y + b` in bf16, as JAX's linear
//     adds its bias to the dot's output (each consumer thread copies one
//     column's bias into a 512-byte slot of shared memory of its own
//     before the products, so no register holds it through them; the
//     bf16x2 add rounds the exact sum once, which for two bf16 values is
//     the fp32 sum rounded once, bit for bit: two conversions and an fp32
//     add an element instead cost G 4-6% at the linear shapes on the H100,
//     the bf16x2 add ~0.4%), staged into the x ring (free once both
//     warpgroups' last products are done; the B ring may still feed the
//     peer's last copy: a bf16 tile at once, fp32 in two halves) as
//     128-byte-swizzled boxes of 64 rows, each stored by TMA: rows and
//     columns past (M, N) are not written. One flat unrolled loop, so that
//     acc is indexed by constants;
//   - the CTA index walks M fastest, so the CTAs that run together share
//     weight column tiles (read from device memory once) while x (24 MB at
//     M = 3968) stays in the 50 MB L2;
//   - no CTA of a pair exits while the other may still write to its shared
//     memory or arrive on its barriers (a cluster barrier at the end).
//
// A policy Cv (a template on CL) has:
//   W_ROWS, PACK        stored rows a stage, K rows a stored row (64, 1 for
//                       int8; 32, 2 for int4)
//   CLUSTER             CL: CTAs that share each stored tile
//   BST                 the depth of the bf16 B ring
//   TRANSFORM_REGS, CONSUMER_REGS, EPILOGUE_SCALE
//   Cv(tt, wpitch, n0, N, group, rank)  the state of transform thread tt (0
//                       .. 255) of the CTA of that rank at column n0
//   begin(i, scale, n0, N)  before stage i's waits (its global loads)
//   convert(w, b, wpitch)  the CTA's share of the stored tile at shared
//                       address w -> its rows of the B buffer b
// The kernel's parameters go to begin and convert at each call instead of
// living in the policy: read from the constant bank, they cost the
// transform no registers (copied into G4's policy, they made G4 1.7%
// slower on the H100).
// No atomics and no split of K across CTAs: the order of every sum is fixed,
// so two launches give the same bits.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "hopper.cuh"

namespace vc {
namespace wide {

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int NT = 512;  // two transform warpgroups, two consumer warpgroups
constexpr int TRANSFORM_THREADS = 256;
constexpr int QUARTERS = TRANSFORM_THREADS / 8;
constexpr int X_BYTES = BM * BK * 2;  // 16 KB
constexpr int B_BYTES = BK * BN * 2;  // 32 KB: four [64 K][64 N] swizzled blocks

// A B buffer holds the 64 K rows of a stage as two contiguous halves (K
// rows [0, 32), [32, 64): a pair's CTAs convert one each, and one bulk copy
// moves it), each four 64-column blocks of 32 rows of 128 bytes, 16-byte
// chunks XORed with k % 8 (the 128-byte swizzle). The byte offset of the
// first chunk (columns 8 * (2h) .. +7) of row k; the second chunk (columns
// 16h + 8 ..) is its neighbour, offset ^ 16
__device__ __forceinline__ int b_offset(int k, int h) {
  return (k >> 5) * (BK * 256) + (h >> 2) * (BK * 64) + (k & 31) * 128 + ((((2 * h) & 7) ^ (k & 7)) << 4);
}

// the MN-major B operand of k16 step kk, 128 columns from block blk0, of a
// B buffer at b: 64-column blocks BK * 64 bytes apart (LBO), 8 K rows 1024
// (SBO)
__device__ __forceinline__ uint64_t b_desc(uint32_t b, int kk, int blk0) {
  return gmma_desc(b + (kk >> 1) * (BK * 256) + blk0 * (BK * 64) + (kk & 1) * 16 * 128, BK * 64, 1024);
}

constexpr int STAGES = 4;          // each TMA ring: x tiles, stored w tiles
constexpr int OUT_BOX = 64 * 128;  // an output box: 64 rows of 128 bytes (64 bf16 or 32 fp32 columns)

template <class Cv>
struct Layout {
  static constexpr int CL = Cv::CLUSTER, BST = Cv::BST;
  static constexpr int W_ROWS = Cv::W_ROWS / CL;  // the stored rows a CTA loads a stage
  static constexpr int W_BYTES = W_ROWS * BN;
  static constexpr int SM_X = 0, SM_W = STAGES * X_BYTES, SM_B = SM_W + STAGES * W_BYTES;
  // the barriers: xfull[2][STAGES], wfull[STAGES], bfull[BST], bempty[BST]; then the bias slot
  static constexpr int SM_BAR = SM_B + BST * B_BYTES;
  static constexpr int SM_BIAS = (SM_BAR + 8 * (3 * STAGES + 2 * BST) + 15) / 16 * 16;  // the tile's bias, bf16
  static constexpr size_t SMEM = SM_BIAS + 2 * BN + 1024;
  static_assert(CL == 1 || CL == 2, "CTAs pair up or run alone");
  static_assert(SM_B % 1024 == 0, "the swizzled B buffers start on 1024-byte boundaries");
  static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
  // an fp32 output chunk (two warpgroups x 64 rows x 128 columns) is staged in the x ring
  static_assert(STAGES * X_BYTES >= 2 * 4 * OUT_BOX, "the x ring cannot stage an output chunk");
  // setmaxnreg from the 128 registers a thread has at launch (512 threads,
  // one CTA an SM)
  static_assert(256 * (128 - Cv::TRANSFORM_REGS) >= 256 * (Cv::CONSUMER_REGS - 128), "registers over-committed");
};

// wpitch: the bytes of one stored w row in shared memory (the w box's width:
// 256, or N where N < 256); x_bytes: what TMA brings of a warpgroup's 64
// rows of an x tile; ty: y's
// map, boxes of 64 rows x 128 bytes, 128-byte swizzle
template <class Cv, typename OutT, bool BIAS>
__global__ void __launch_bounds__(NT, 1)
    matmul_wide(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap ty, const float* __restrict__ scale,
                const bf16* __restrict__ bias, int M, int N, int K, int group, int wpitch, uint32_t x_bytes) {
  static_assert(!BIAS || sizeof(OutT) == 2, "the bias is added to a bf16 output only");
  using L = Layout<Cv>;
  constexpr int CL = L::CL, BST = L::BST;
  constexpr int CONSUMER_WARPS = 8, HALF_BYTES = B_BYTES / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  // xfull[2][STAGES] (a warpgroup's half of an x tile), wfull[STAGES], bfull[BST], bempty[BST]
  const uint32_t xfull = base + L::SM_BAR, wfull = xfull + 16 * STAGES, bfull = wfull + 8 * STAGES,
                 bempty = bfull + 8 * BST;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, nk = K / BK;
  const int rank = CL == 2 ? (int)cluster_rank() : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(xfull + 8 * s, 1);  // the loading thread, with the bytes
      mbar_init(xfull + 8 * (STAGES + s), 1);
      mbar_init(wfull + 8 * s, 1);
    }
    for (int b = 0; b < BST; ++b) {
      // alone: every transform warp; paired: one transform thread, with the bytes of the peer's copy
      mbar_init(bfull + 8 * b, CL == 2 ? 1 : TRANSFORM_THREADS / 32);
      mbar_init(bempty + 8 * b, CONSUMER_WARPS * CL);  // a consumer warp of each CTA
    }
    mbar_init_fence();
  }
  if constexpr (CL == 2)
    cluster_sync();  // the peer's barriers are initialised before anyone arrives on them
  else
    __syncthreads();
  // the peer's shared memory: a local address plus `peer` (a shared::cluster address)
  const uint32_t peer = CL == 2 ? mapa(base, rank ^ 1) - base : 0;

  const int wg = warpgroup(), lane = threadIdx.x % 32;
  if (wg < 2) {  // ------------------------------------------------ transform
    setmaxnreg_dec<Cv::TRANSFORM_REGS>();
    // thread 0 loads the CTA's share of the stored w tiles (W_ROWS / CL rows
    // x 256 N bytes; columns past N arrive as zeros) into a STAGES-deep ring:
    // the first STAGES, then each stage's refill once every transform warp
    // has read it (paired: the named barrier that closes the stage; alone:
    // the stage's bfull, waited for a stage later)
    const uint32_t w_bytes = L::W_ROWS * wpitch;
    auto load_w = [&](int i) {
      const uint32_t f = wfull + 8 * (i % STAGES);
      mbar_arrive_expect_tx(f, w_bytes);
      tma_load_3d(base + L::SM_W + i % STAGES * L::W_BYTES, &tw, n0, i * Cv::W_ROWS + rank * L::W_ROWS, 0, f);
    };
    if (threadIdx.x == 0)
      for (int i = 0; i < STAGES && i < nk; ++i) load_w(i);
    Cv cv(threadIdx.x, wpitch, n0, N, group, rank);
    Slot<STAGES> sl;
    for (int i = 0; i < nk; ++i, sl.next()) {
      cv.begin(i, scale, n0, N);
      const int bb = i % BST;
      const uint32_t b = base + L::SM_B + bb * B_BYTES;
      if (i >= BST) mbar_wait(bempty + 8 * bb, (i / BST - 1) & 1);  // the consumers (of both CTAs) are done
      mbar_wait(wfull + 8 * sl.s, sl.phase);
      cv.convert(base + L::SM_W + sl.s * L::W_BYTES, b, wpitch);
      fence_proxy_async();  // the B buffer is read by wgmma and the bulk copy (the async proxy)
      if constexpr (CL == 2) {
        named_barrier<1, TRANSFORM_THREADS>();  // this CTA's half of the buffer is whole, the w slot read
        if (threadIdx.x == 0) {
          if (i + STAGES < nk) load_w(i + STAGES);
          // this half is done; the peer's half lands here by its copy
          mbar_arrive_expect_tx(bfull + 8 * bb, HALF_BYTES);
          const uint32_t src = b + rank * HALF_BYTES;  // this CTA's half, contiguous
          bulk_copy_to_peer(src + peer, src, HALF_BYTES, bfull + 8 * bb + peer);
        }
      } else {  // alone, each warp arrives when its sets are done (no barrier couples the warps)
        __syncwarp();
        if (lane == 0) mbar_arrive(bfull + 8 * bb);
        if (threadIdx.x == 0 && i > 0 && i - 1 + STAGES < nk) {
          mbar_wait(bfull + 8 * ((i - 1) % BST), ((i - 1) / BST) & 1);  // every warp has read the last stage's w
          load_w(i - 1 + STAGES);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<Cv::CONSUMER_REGS>();
    const int c = wg - 2, tid = threadIdx.x % 128, ci = 128 * c + tid;
    // the epilogue's scale of column n0 + ci, loaded while the products run
    const float sc_col = Cv::EPILOGUE_SCALE && n0 + ci < N ? __ldg(scale + n0 + ci) : 1.0f;
    if constexpr (BIAS) {  // likewise its bias, parked in shared memory until the epilogue
      const bf16 b = n0 + ci < N ? bias[n0 + ci] : __float2bfloat16_rn(0.0f);
      sts16(base + L::SM_BIAS + 2 * ci, __bfloat16_as_ushort(b));
    }
    // the warpgroup's first thread loads its 64 rows of each x tile (64 K,
    // bf16, 128-byte swizzle: the K-major A operand; rows past M arrive as
    // zeros) into the ring: the first STAGES, then each stage's refill once
    // the products reading it are done. Rows all past M: no load, the
    // products run on whatever the slot holds and nothing is stored
    const uint32_t xf = xfull + 8 * STAGES * c;
    const bool x_live = m0 + 64 * c < M;
    auto load_x = [&](int i) {
      const uint32_t f = xf + 8 * (i % STAGES);
      if (!x_live) {
        mbar_arrive(f);
        return;
      }
      mbar_arrive_expect_tx(f, x_bytes);
      tma_load_3d(base + L::SM_X + i % STAGES * X_BYTES + 64 * c * 128, &tx, i * BK, m0 + 64 * c, 0, f);
    };
    if (tid == 0)
      for (int i = 0; i < STAGES && i < nk; ++i) load_x(i);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    Slot<STAGES> sl;
    for (int i = 0; i < nk; ++i, sl.next()) {
      const int bb = i % BST;
      mbar_wait(xf + 8 * sl.s, sl.phase);
      mbar_wait(bfull + 8 * bb, (i / BST) & 1);
      const uint32_t xa = base + L::SM_X + sl.s * X_BYTES, ba = base + L::SM_B + bb * B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t a = desc_kmajor<BM>(xa, 64 * c, kk);
        wgmma_m64n128_ss_tb(acc, a, b_desc(ba, kk, 0));
        wgmma_m64n128_ss_tb(acc + 64, a, b_desc(ba, kk, 2));
      }
      wgmma_commit();
      if (i > 0) {  // the stage before is done: refill its x slot, free its bf16 buffer (this CTA's and the peer's)
        wgmma_wait<1>();
        fence_operands<128>(acc);
        if (tid == 0 && i - 1 + STAGES < nk) load_x(i - 1 + STAGES);
        __syncwarp();
        if (lane == 0) {
          const uint32_t e = bempty + 8 * ((i - 1) % BST);
          mbar_arrive(e);
          if constexpr (CL == 2) mbar_arrive_remote(e + peer);
        }
      }
    }
    wgmma_wait0();
    fence_operands<128>(acc);

    // epilogue: acc (* scale[n]) in fp32, one rounding to OutT (with a
    // bias: that rounded to bf16, + bias[n] in fp32, rounded again; N is a
    // multiple of 16, so a live column pair is whole), staged in the x ring
    // once both warpgroups are done with it (a bf16 tile at once, fp32 in
    // two halves), each warpgroup's 64 rows as boxes of 128-byte rows, and
    // stored by TMA
    constexpr int E = sizeof(OutT), BOX_COLS = 128 / E, CHUNK = E == 2 ? BN : BN / 2;
    const int r = 16 * (tid / 32) + (tid % 32) / 4, t = tid % 4;  // rows r and r + 8 of the warpgroup's 64
    const uint32_t st = base + L::SM_X + c * (CHUNK / BOX_COLS) * OUT_BOX;
    // the thread's (row r, column pair t) of a swizzled box (bytes 2Et of the
    // row, its 16-byte chunks XORed with r % 8): the pair at byte b of a row
    // (b a multiple of 8E, so disjoint from 2Et) is tb ^ b, row r + 8 is
    // + 1024 (8 rows of 128 bytes)
    const uint32_t tb = st + r * 128 + ((2 * E * t) ^ ((r & 7) << 4));
    named_barrier<3, 256>();  // both warpgroups' last products have read the x ring
    // the w ring, read by the transform long before: the tile's scales; the
    // bias slot, written before the products
    const uint32_t col_s = base + L::SM_W, col_b = base + L::SM_BIAS;
    if constexpr (Cv::EPILOGUE_SCALE) {
      sts32(col_s + 4 * ci, __float_as_uint(sc_col));
      named_barrier<3, 256>();
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = 8 * j + 2 * t, cj = 8 * j % CHUNK;  // the thread's column pair in the tile; j's in the chunk
      if (n0 + cl < N) {
        float s0 = 1.0f, s1 = 1.0f;
        if constexpr (Cv::EPILOGUE_SCALE) {
          const float2 sw = lds64f(col_s + 4 * cl);
          s0 = sw.x;
          s1 = sw.y;
        }
        const uint32_t a = (tb + cj / BOX_COLS * OUT_BOX) ^ (cj % BOX_COLS * E);
        if constexpr (BIAS) {
          const uint32_t bb = lds32(col_b + 2 * cl);
          sts32(a, add_bf16x2(pack2(acc[4 * j] * s0, acc[4 * j + 1] * s1), bb));
          sts32(a + 1024, add_bf16x2(pack2(acc[4 * j + 2] * s0, acc[4 * j + 3] * s1), bb));
        } else {
          stage2(a, acc[4 * j] * s0, acc[4 * j + 1] * s1, (OutT*)nullptr);
          stage2(a + 1024, acc[4 * j + 2] * s0, acc[4 * j + 3] * s1, (OutT*)nullptr);
        }
      }
      if ((8 * j + 8) % CHUNK == 0) {  // a chunk is staged: store it
        const int c0 = n0 + 8 * j + 8 - CHUNK;  // its first column
        fence_proxy_async();                    // the staging is read by TMA (the async proxy)
        named_barrier<128>(4 + c);
        if (tid == 0 && m0 + 64 * c < M) {
          for (int bx = 0; bx < CHUNK / BOX_COLS; ++bx)
            if (c0 + BOX_COLS * bx < N) tma_store_2d(&ty, st + bx * OUT_BOX, c0 + BOX_COLS * bx, m0 + 64 * c);
          bulk_commit();
        }
        if (8 * j + 8 < BN) {  // the staging is rewritten by the next chunk once the stores have read it
          if (tid == 0) bulk_wait_read();
          named_barrier<128>(4 + c);
        }
      }
    }
    if (tid == 0) bulk_wait_read();  // the stores have read the staging
  }
  if constexpr (CL == 2) cluster_sync();  // the peer no longer touches this CTA's shared memory
}

// x (M, K) bf16, w the stored (K / Cv::PACK, N) bytes row-major, bias (N,)
// bf16 or null (BIAS); returns a cudaError_t or CUresult (0 on success)
template <class Cv, typename OutT, bool BIAS>
int launch_wide(const void* x, const void* w, const float* scale, const bf16* bias, OutT* y, int M, int N, int K,
                int group, cudaStream_t s) {
  using L = Layout<Cv>;
  CUtensorMap m[3];
  const int xrows = M < 64 ? M : 64, wpitch = N < BN ? N : BN;  // boxes no larger than the tensor
  {  // x (M, K) bf16: boxes of 64 K x a warpgroup's 64 rows, 128-byte swizzle
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
    const cuuint32_t box[3] = {BK, (cuuint32_t)xrows, 1};
    int err = encode_map(&m[0], x, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  {  // w: boxes of 256 N (or N) bytes x the stored rows a CTA converts, row-major
    const cuuint64_t rows = (cuuint64_t)K / Cv::PACK;
    const cuuint64_t dims[3] = {(cuuint64_t)N, rows, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)N, rows * N};
    const cuuint32_t box[3] = {(cuuint32_t)wpitch, (cuuint32_t)L::W_ROWS, 1};
    int err = encode_map(&m[1], w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_DATA_TYPE_UINT8);
    if (err) return err;
  }
  {  // y (M, N): stored by boxes of 128 bytes x 64 rows, 128-byte swizzle (columns past N are not written)
    constexpr int E = sizeof(OutT);
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)N * E};
    const cuuint32_t box[2] = {128 / E, 64};
    int err = encode_map(&m[2], y, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                         E == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
    if (err) return err;
  }
  cudaError_t e = cudaFuncSetAttribute(matmul_wide<Cv, OutT, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int mt = (M + BM - 1) / BM;
  const dim3 grid((mt + L::CL - 1) / L::CL * L::CL, (N + BN - 1) / BN);  // M rounded up to whole clusters
  return launch_cluster(matmul_wide<Cv, OutT, BIAS>, grid, NT, L::SMEM, s, L::CL, m[0], m[1], m[2], scale, bias, M,
                        N, K, group, wpitch, (uint32_t)(xrows * BK * 2));
}

// the wide body of policy Pol, its CTAs paired (pair != 0) or alone, with a
// bias (bf16 out only) where bias is not null
template <template <int> class Pol, typename OutT>
int launch_wide(const void* x, const void* w, const float* scale, const bf16* bias, OutT* y, int M, int N, int K,
                int group, int pair, cudaStream_t s) {
  if constexpr (sizeof(OutT) == 2) {
    if (bias != nullptr) {
      if (pair) return launch_wide<Pol<2>, OutT, true>(x, w, scale, bias, y, M, N, K, group, s);
      return launch_wide<Pol<1>, OutT, true>(x, w, scale, bias, y, M, N, K, group, s);
    }
  } else if (bias != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (pair) return launch_wide<Pol<2>, OutT, false>(x, w, scale, nullptr, y, M, N, K, group, s);
  return launch_wide<Pol<1>, OutT, false>(x, w, scale, nullptr, y, M, N, K, group, s);
}

}  // namespace wide
}  // namespace vc
