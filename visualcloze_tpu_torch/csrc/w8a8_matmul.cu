// Kernel H: the int8 x int8 matmul of every w8a8 DiT linear.
//
// Replaces the product of visualcloze_tpu/models/layers.py:linear's w8a8
// branch ("a8" entries: einsum s8 x s8 -> s32, then acc * x_scale *
// w_scale), which XLA fuses into one pass; there is no Pallas kernel.
//
//     y[m, n] = bf16((float(sum_k a[m, k] * w[n, k]) * x_scale[m]) * w_scale[n])
//     y[m, n] = bf16(float(y[m, n]) + float(bias[n]))      (with a bf16 bias)
//
// a (M, K) int8 codes of the activations (kernel I), w (N, K) int8: the
// weight K-major, i.e. the JAX entry's (K, N) w_int8 transposed once when the
// linear is quantized or converted, because Hopper's 8-bit wgmma takes both
// operands K-major only. The sums are exact in s32 (|acc| <= 127^2 * 15360
// < 2^31), the convert to fp32 rounds to nearest even (__int2float_rn, as
// XLA's convert), and the two fp32 products keep JAX's order; one rounding
// to bf16, then the bias added as JAX adds it (a bf16 add: an fp32 sum of
// the two bf16 values, rounded to bf16), in the epilogue rather than in a
// pass of its own over the output. So the kernel equals its plain version
// bit for bit, and two launches give the same bits.
//
// Bound on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s): 2*M*N*K operations
// against M*K + N*K + 4*(M + N) + 2*M*N bytes; linear1 at M = 3968
// (K 3072, N 21504): 0.265 ms, by operations.
//
// A warp-specialised wgmma kernel of 384 threads, one CTA an SM, the CTAs
// resident and walking the output tiles (persistent), in clusters of two
// along M (a pair) or alone, as the wrapper's tile_plan chooses:
//   - the tiles are 128 x BN, BN 256, or 128 where that takes fewer rounds
//     of the resident CTAs (the 512-row text stream, whose 256-column tiles
//     fill under half of the 132 SMs); a pair shares n0 and takes
//     neighbouring 128-row tiles of M. Pairs round the 128-row tiles up to
//     even, so they run only where that costs no round (an odd count of
//     tiles, as the DiT's 3968 and 3456 rows have, can cost one: linear1
//     then runs alone). The clusters walk the (M group, N) tiles with M
//     fastest, so those that run together share weight tiles, read from
//     device memory once, while the codes (12 MB at M = 3968, K = 3072)
//     stay in the 50 MB L2;
//   - warp 0 (setmaxnreg 40) issues TMA loads of the codes tile (128 rows x
//     128 K bytes) and of the weight tile (BN rows x 128 K bytes, as two
//     halves; paired, each CTA loads one half multicast into both, so a
//     weight tile crosses L2 once for 256 rows) into an mbarrier ring, both
//     with the 128-byte swizzle, i.e. the K-major wgmma operand layout as
//     TMA writes it. Rows past M or N arrive as zeros (or, where M or N is
//     below the box, are never written, and only feed outputs that are not
//     stored); a weight half wholly past N is not loaded, and a CTA whose
//     rows all lie past M loads no codes (paired, its weight half and its
//     arrivals still serve the peer). It runs on into the next tile's
//     stages while the consumers finish a tile's epilogue;
//   - warpgroups 1 and 2 (setmaxnreg 232) own 64 rows x BN columns each in
//     s32 (BN / 2 registers) and issue four SS m64nBNk32 s8 wgmma a stage,
//     one commit group in flight: a stage is freed (one arrival a warp)
//     once the products of the next are issued and its own are done (the
//     last of a tile after its products); paired, a stage holds the peer's
//     multicast too, so each consumer warp arrives on the empty barrier of
//     both CTAs, and a producer refills a slot only when both are done;
//   - the epilogue converts, scales, rounds and adds the bias into a
//     128-byte-swizzled staging buffer a warpgroup, 128 columns at a time,
//     each chunk stored by TMA while the next is computed (rows and columns
//     past (M, N) are not written). The tile's x_scale, w_scale and bias
//     are loaded before its products and w_scale and bias exchanged through
//     shared memory. On the H100 at linear1, read from device memory in the
//     epilogue, one column pair at a time, they made H 33% slower, and
//     4-byte stores from the registers straight to device memory 25%;
//   - no CTA of a pair exits while its peer may still write to its shared
//     memory or arrive on its barriers (a cluster barrier at the end).
// No atomics and no split of K: two launches give the same bits.
#include <cuda.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "hopper.cuh"

namespace {

using namespace vc;

constexpr int BM = 128, BK = 128;  // BK in int8 elements (bytes): one 128-byte swizzle row
constexpr int NT = 384;            // the TMA warpgroup, two consumer warpgroups
constexpr int A_BYTES = BM * BK;   // 16 KB
constexpr int BOX_BYTES = 64 * 128;      // an output box: 64 rows x 64 bf16 columns
constexpr int OUT_BYTES = 2 * BOX_BYTES;  // a warpgroup's staging buffer


template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int B_BYTES = BN * BK;  // 32 or 16 KB
  static constexpr int SM_A = 0, SM_B = STAGES * A_BYTES;
  // each consumer warpgroup's output staging: a ring of two boxes of 64 rows x 64 bf16 columns
  static constexpr int SM_OUT = SM_B + STAGES * B_BYTES;
  // the tile's w_scale (BN fp32) and bias (BN bf16), for the epilogue
  static constexpr int SM_COL = SM_OUT + 2 * OUT_BYTES;
  static constexpr int SM_BAR = SM_COL + BN * 6;  // full[STAGES], empty[STAGES]
  static constexpr size_t SMEM = SM_BAR + 8 * 2 * STAGES + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
};

// setmaxnreg from the 168 registers a thread has at launch (384 threads, one
// CTA an SM): 128 * 40 + 256 * 232 <= 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

#define H_R4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define H_R16(d, i) H_R4(d, i), H_R4(d, i + 4), H_R4(d, i + 8), H_R4(d, i + 12)

// d (64 x 256, s32) += A (64 x 32, s8, smem K-major) . B (32 x 256, s8, smem K-major)
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b, Cfg<256>*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : H_R16(d, 0), H_R16(d, 16), H_R16(d, 32), H_R16(d, 48), H_R16(d, 64), H_R16(d, 80), H_R16(d, 96),
        H_R16(d, 112)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, s32) += A (64 x 32, s8, smem K-major) . B (32 x 128, s8, smem K-major)
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b, Cfg<128>*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : H_R16(d, 0), H_R16(d, 16), H_R16(d, 32), H_R16(d, 48)
      : "l"(a), "l"(b), "r"(1));
}

#undef H_R16
#undef H_R4

// keeps the compiler from moving accumulator reads across the async MMAs
template <int N>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// bf16((float(acc) * xs) * ws), then + b as a bf16 add, for a column pair
__device__ __forceinline__ uint32_t out2(int acc0, int acc1, float xs, float ws0, float ws1, float2 b, bool has_bias) {
  float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc0), xs), ws0);
  float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc1), xs), ws1);
  if (has_bias) {
    v0 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v0)), b.x);
    v1 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v1)), b.y);
  }
  return pack2(v0, v1);
}

// a consumer warp frees a stage: it arrives on the stage's empty barrier in
// this CTA and, paired, in the peer
template <int CL>
__device__ __forceinline__ void free_stage(uint32_t bar, uint32_t peer, int lane) {
  __syncwarp();
  if (lane == 0) {
    mbar_arrive(bar);
    if constexpr (CL == 2) mbar_arrive_remote(bar + peer);
  }
}

// CL: CTAs a cluster (2: a pair along M, 1: alone); mgroups: the groups of
// CL 128-row tiles along M; tiles: mgroups x the N tiles; a_bytes, b_bytes:
// what TMA brings of a codes tile and of a weight half
template <int BN, int CL>
__global__ void __launch_bounds__(NT, 1)
    w8a8_matmul_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap ty, const float* __restrict__ x_scale,
                       const float* __restrict__ w_scale, const bf16* __restrict__ bias, int M, int N, int K,
                       int mgroups, int tiles, uint32_t a_bytes, uint32_t b_bytes) {
  using C = Cfg<BN>;
  constexpr int STAGES = C::STAGES, HALF = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + C::SM_BAR, empty = full + 8 * STAGES;
  const int rank = CL == 2 ? (int)cluster_rank() : 0, nk = K / BK;
  const int cluster = blockIdx.x / CL, clusters = gridDim.x / CL;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);          // the TMA thread, with the bytes of both CTAs' loads
      mbar_init(empty + 8 * s, 8 * CL);  // a consumer warp of each CTA
    }
    mbar_init_fence();
  }
  if constexpr (CL == 2)
    cluster_sync();  // the peer's barriers are initialised before its loads and arrivals reach them
  else
    __syncthreads();
  const uint32_t peer = CL == 2 ? mapa(base, rank ^ 1) - base : 0;

  const int wg = warpgroup(), lane = threadIdx.x % 32;
  if (wg == 0) {  // ------------------------------------------------ TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      Slot<STAGES> sl;
      int it = 0;  // stages issued so far, over all tiles
      for (int t = cluster; t < tiles; t += clusters) {
        const int m0 = (CL * (t % mgroups) + rank) * BM, n0 = (t / mgroups) * BN;
        const bool rows = m0 < M;
        const uint32_t bytes = (rows ? a_bytes : 0) + (n0 + HALF < N ? 2 : 1) * b_bytes;
        for (int i = 0; i < nk; ++i, ++it, sl.next()) {
          if (it >= STAGES) mbar_wait(empty + 8 * sl.s, sl.phase ^ 1);
          const uint32_t f = full + 8 * sl.s;
          mbar_arrive_expect_tx(f, bytes);
          if (rows) tma_load_3d(base + C::SM_A + sl.s * A_BYTES, &ta, i * BK, m0, 0, f);
          if constexpr (CL == 2) {  // this CTA's half of the weight tile, into both
            if (n0 + rank * HALF < N)
              tma_load_3d_multicast(base + C::SM_B + sl.s * C::B_BYTES + rank * HALF * BK, &tw, i * BK,
                                    n0 + rank * HALF, 0, f, (uint16_t)0x3);
          } else {
            for (int hh = 0; hh < 2; ++hh)
              if (n0 + hh * HALF < N)
                tma_load_3d(base + C::SM_B + sl.s * C::B_BYTES + hh * HALF * BK, &tw, i * BK, n0 + hh * HALF, 0, f);
          }
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x % 128, t4 = tid % 4;
    // the staging buffer: boxes of 64 rows x 64 columns (128-byte rows, the
    // 128-byte swizzle), or of N columns unswizzled where N < 64
    const uint32_t ob = base + C::SM_OUT + c * OUT_BYTES, col_s = base + C::SM_COL;
    Slot<STAGES> sl, prev;
    for (int t = cluster; t < tiles; t += clusters) {
      const int m0 = (CL * (t % mgroups) + rank) * BM, n0 = (t / mgroups) * BN;
      // the epilogue's scales and bias, loaded while the products run: this
      // thread's two rows' x_scale, and one column's w_scale and bias
      const int r = 16 * (tid / 32) + (tid % 32) / 4, row = m0 + 64 * c + r, ci = 128 * c + tid;
      const float xs0 = row < M ? __ldg(x_scale + row) : 0.0f, xs1 = row + 8 < M ? __ldg(x_scale + row + 8) : 0.0f;
      const bool col_live = ci < BN && n0 + ci < N;
      const float ws = col_live ? __ldg(w_scale + n0 + ci) : 0.0f;
      const bf16 bs = col_live && bias != nullptr ? bias[n0 + ci] : __float2bfloat16_rn(0.0f);
      int acc[HALF];
#pragma unroll
      for (int i = 0; i < HALF; ++i) acc[i] = 0;
      for (int i = 0; i < nk; ++i, sl.next()) {
        mbar_wait(full + 8 * sl.s, sl.phase);
        const uint32_t ta_s = base + C::SM_A + sl.s * A_BYTES, tb_s = base + C::SM_B + sl.s * C::B_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)  // 32 bytes of K a product: the bf16 k16 step's bytes
          wgmma_s8(acc, desc_kmajor<BM>(ta_s, 64 * c, kk), desc_kmajor<BN>(tb_s, 0, kk), static_cast<C*>(nullptr));
        wgmma_commit();
        if (i > 0) {  // the stage before is done: free it in both CTAs
          wgmma_wait<1>();
          fence_acc<HALF>(acc);
          free_stage<CL>(empty + 8 * prev.s, peer, lane);
          prev.next();
        }
      }
      wgmma_wait0();
      fence_acc<HALF>(acc);
      free_stage<CL>(empty + 8 * prev.s, peer, lane);  // the tile's last stage
      prev.next();

      // epilogue: (float(acc) * x_scale[m]) * w_scale[n], one rounding to
      // bf16, + bias[n] in bf16 (N is a multiple of 16, so a live column
      // pair is whole), box by box (64 columns) into a ring of two staging
      // boxes a warpgroup, each stored by TMA while the next is computed
      // (rows and columns past (M, N) are not written); the columns' scales
      // and bias from shared memory. One flat unrolled loop, so that acc is
      // indexed by constants.
      named_barrier<3, 256>();  // both warpgroups are done with the last tile's columns
      if (ci < BN) {
        sts32(col_s + 4 * ci, __float_as_uint(ws));
        sts16(col_s + 4 * BN + 2 * ci, __bfloat16_as_ushort(bs));
      }
      named_barrier<3, 256>();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t box = ob + (j / 8 % 2) * BOX_BYTES;
        // (row r, column pair t) of the swizzled box, its 16-byte chunk j % 8: (r, 8j + 2t) in the box
        const uint32_t a = (box + r * 128 + ((r & 7) << 4) + 4 * t4) ^ ((j % 8) << 4);
        if (j % 8 == 0) {  // a new box: its buffer's store two boxes ago has read it
          if (tid == 0) bulk_wait_read<1>();
          named_barrier<128>(1 + c);
        }
        const int cl = 8 * j + 2 * t4;  // the thread's column pair in the tile
        if (n0 + cl < N) {
          const float2 sw = lds64f(col_s + 4 * cl);
          float2 b = make_float2(0.0f, 0.0f);
          if (bias != nullptr) {
            const uint32_t bb = lds32(col_s + 4 * BN + 2 * cl);
            b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bb));
          }
          sts32(a, out2(acc[4 * j], acc[4 * j + 1], xs0, sw.x, sw.y, b, bias != nullptr));
          sts32(a + 1024, out2(acc[4 * j + 2], acc[4 * j + 3], xs1, sw.x, sw.y, b, bias != nullptr));
        }
        if (j % 8 == 7) {  // the box is staged: store it
          fence_proxy_async();  // the staging is read by TMA (the async proxy)
          named_barrier<128>(1 + c);
          if (tid == 0) {
            if (m0 + 64 * c < M && n0 + 8 * (j - 7) < N) tma_store_2d(&ty, box, n0 + 8 * (j - 7), m0 + 64 * c);
            bulk_commit();
          }
        }
      }
    }
    if (tid == 0) bulk_wait_read();  // the stores have read the staging buffer
  }
  if constexpr (CL == 2) cluster_sync();  // the peer no longer loads into or arrives on this CTA's shared memory
}

// the pairs the card runs at once (one CTA an SM; both tile widths take the
// same threads and shared memory), asked once; 0 if it cannot say. Lone
// CTAs: twice as many.
int resident_pairs() {
  static int n = -1;
  if (n < 0) {
    using C = Cfg<256>;
    n = cudaFuncSetAttribute(w8a8_matmul_kernel<256, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM) == cudaSuccess
            ? max_active_clusters(w8a8_matmul_kernel<256, 2>, NT, C::SMEM, 2)
            : 0;
  }
  return n;
}

// the persistent launch with BN-column tiles and CL CTAs a cluster, at most
// as many clusters as are resident
template <int BN, int CL>
int launch(const CUtensorMap* maps, const float* x_scale, const float* w_scale, const bf16* bias, int M, int N, int K,
           uint32_t a_bytes, cudaStream_t s) {
  using C = Cfg<BN>;
  const cudaError_t e =
      cudaFuncSetAttribute(w8a8_matmul_kernel<BN, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int mgroups = ((M + BM - 1) / BM + CL - 1) / CL, resident = resident_pairs() * 2 / CL;
  const int tiles = mgroups * ((N + BN - 1) / BN), clusters = tiles < resident ? tiles : resident;
  const int brows = N < BN / 2 ? N : BN / 2;
  return launch_cluster(w8a8_matmul_kernel<BN, CL>, dim3(CL * clusters), NT, C::SMEM, s, CL, maps[0], maps[1],
                        maps[2], x_scale, w_scale, bias, M, N, K, mgroups, tiles, a_bytes, (uint32_t)(brows * BK));
}

}  // namespace

// The 2-CTA clusters kernel H keeps resident on this card (a persistent
// launch runs at most that many pairs, or twice as many lone CTAs), or 0 if
// the card cannot say.
extern "C" int w8a8_resident_clusters() { return resident_pairs(); }

// Kernel H. a (M, K) int8, w (N, K) int8, x_scale (M,) fp32, w_scale (N,) fp32,
// bias (N,) bf16 or null, y (M, N) bf16; all contiguous, a, w and y 16-byte
// aligned, bias 4-byte aligned; K a multiple of 128, N a multiple of 16;
// tile_n the output tiles' width, 128 or 256, and pair whether the CTAs run
// in clusters of two along M (ops/w8a8_matmul.py:tile_plan chooses both).
// Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int w8a8_matmul(const void* a, const void* w, const void* x_scale, const void* w_scale, const void* bias,
                           void* y, int M, int N, int K, int tile_n, int pair, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || N % 16 || (tile_n != 128 && tile_n != 256))
    return (int)cudaErrorInvalidValue;
  if (resident_pairs() <= 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap maps[3];
  const int arows = M < BM ? M : BM, brows = N < tile_n / 2 ? N : tile_n / 2;  // boxes no larger than the tensor
  {  // a (M, K) int8: boxes of 128 K x arows rows, 128-byte swizzle
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)M * K};
    const cuuint32_t box[3] = {BK, (cuuint32_t)arows, 1};
    const int err = encode_map(&maps[0], a, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                               CU_TENSOR_MAP_DATA_TYPE_UINT8);
    if (err) return err;
  }
  {  // w (N, K) int8: boxes of 128 K x brows rows (half a tile), 128-byte swizzle
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 1};
    const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)N * K};
    const cuuint32_t box[3] = {BK, (cuuint32_t)brows, 1};
    const int err = encode_map(&maps[1], w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                               CU_TENSOR_MAP_DATA_TYPE_UINT8);
    if (err) return err;
  }
  {  // y (M, N) bf16: stored by boxes of 64 columns x 64 rows, 128-byte swizzle (columns past N are not written)
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
    const cuuint32_t box[2] = {64, 64};
    const int err = encode_map(&maps[2], y, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  const float *xs = static_cast<const float*>(x_scale), *ws = static_cast<const float*>(w_scale);
  const bf16* b = static_cast<const bf16*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t a_bytes = (uint32_t)(arows * BK);
  if (tile_n == 128) {
    if (pair) return launch<128, 2>(maps, xs, ws, b, M, N, K, a_bytes, s);
    return launch<128, 1>(maps, xs, ws, b, M, N, K, a_bytes, s);
  }
  if (pair) return launch<256, 2>(maps, xs, ws, b, M, N, K, a_bytes, s);
  return launch<256, 1>(maps, xs, ws, b, M, N, K, a_bytes, s);
}
