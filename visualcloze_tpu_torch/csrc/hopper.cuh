// Hopper (sm_90a) building blocks of the warp-specialised kernels
// (flash_attn_rope.cu, flash_attn_bwd.cu, flash_attn_d512.cu,
// conv3x3_gn_swish.cu, weight_only_wide.cuh, w8a8_matmul.cu,
// layernorm_modulate_bwd.cu, group_norm.cu): mbarriers and ring slots, named
// barriers, 16-byte shared-memory loads and stores, 1-D bulk loads, 16-byte
// cp.async, TMA tile loads
// (multicast to a cluster too) and stores and the host-side
// tensor maps they read, thread-block clusters (ranks, the peer's shared
// memory, cluster barriers, a launch with a cluster shape), warpgroup MMA
// (wgmma) with shared-memory descriptors for the 128-byte swizzle and for
// the unswizzled K-major layout, register reallocation.
//
// Tile layout in shared memory (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B
// and a box of 64 columns x 64 rows): a tile of R rows x 128 bf16 columns is
// two column halves [half][R][64], each row 128 bytes, 16-byte chunks XORed
// with (row % 8) inside every 1024-byte group of 8 rows. Tiles start on
// 1024-byte boundaries, so the swizzle follows the address bits and a
// descriptor may start anywhere inside a tile.
//
// wgmma operand descriptors for that layout (PTX ISA, "matrix descriptor";
// CUTLASS's canonical GMMA layouts):
//   K-major (rows are M or N, the 128 columns are K): start = tile + half *
//     R * 128 + row0 * 128 + (k16 step % 4) * 32 bytes, SBO = 1024 (8 rows),
//     LBO unused (1);
//   MN-major (rows are K, the 128 columns are N; the transposed B of dl.K):
//     start = tile + k16 step * 16 rows * 128 bytes, LBO = R * 128 (from one
//     64-column half to the next), SBO = 1024 (from 8 rows of K to the next).
// Accumulator of m64nN (per warp w of the warpgroup, g = lane / 4, t = lane %
// 4): d[4j + 0..1] = (row 16w + g, columns 8j + 2t..+1), d[4j + 2..3] = (row
// 16w + g + 8, same columns): mma.sync's C layout. A register A operand of
// m64k16 is mma.sync's A fragment, so two neighbouring 8-column accumulator
// blocks, rounded to bf16 in pairs, are the A operand of the next product.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace vc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. (A bounded spin
// that traps would guard against a hang, but its exit path costs the
// consumers spills and serialises their wgmma.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy writes to shared memory -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier ID (1..15) among COUNT threads (whole warps)
template <int ID, int COUNT>
__device__ __forceinline__ void named_barrier() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
}

// arrive on barrier ID without waiting: COUNT counts the arriving threads
// and those that wait in named_barrier<ID, COUNT>
template <int ID, int COUNT>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
}

// the same with the barrier ID in a register (a warpgroup's own barrier)
template <int COUNT>
__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(COUNT) : "memory");
}

// the warpgroup index, warp-uniform as the compiler sees it (a shuffle from
// lane 0, as CUTLASS derives it; F-dkv measured 0.70-0.71 ms on the H100
// with threadIdx.x / 128 instead, 0.67-0.69 with the shuffle)
__device__ __forceinline__ int warpgroup() { return __shfl_sync(0xffffffff, (int)threadIdx.x / 128, 0); }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// a stage of an N-stage ring and the parity of its current phase
template <int N>
struct Slot {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == N) {
      s = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds64f(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// ---------------------------------------------------------------- clusters
//
// A CTA of a cluster reaches its peers' shared memory through shared::cluster
// addresses (mapa). Data moves to a peer only through the async proxy (a TMA
// multicast, a bulk copy), whose bytes complete on the peer's mbarrier as a
// TMA load's do; a consumer frees a peer's buffer with a remote arrive of
// the default (release, CTA) semantics, as CUTLASS's cluster barriers do:
// what it orders are its wgmma reads, done at wgmma.wait_group. (Generic
// stores to a peer published by cluster-scope fences and arrives cost the
// H100 ~1-2 us a stage in this repository's matmuls.) A CTA must not exit
// while a peer may still write to its shared memory or arrive on its
// barriers: cluster_sync() before the end.

// this CTA's rank in its cluster (blockIdx.x % 2 for a (2, 1, 1) cluster)
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the shared::cluster address of this CTA's shared address `addr` in the CTA
// of rank `rank`. The map is an offset (mapa(a + d) = mapa(a) + d), so a
// kernel maps its base once and adds the difference to every address.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// every thread of every CTA of the cluster: writes before it are seen after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// cluster_sync() in two halves, so that work may run between them: every
// thread arrives once its reads of its peers' shared memory are done, and
// waits before the CTA exits
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }

// a float of a peer's shared memory (a shared::cluster address, mapa), read
// after a cluster_sync() that follows the peer's store
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// arrive on a peer's mbarrier (a shared::cluster address)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// `bytes` (a multiple of 16) of this CTA's shared memory at src to the
// shared::cluster address dst of a peer, completing them on the peer's
// mbarrier at `bar` (a shared::cluster address); the source is read by the
// async proxy, so generic writes to it need fence_proxy_async first
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst, uint32_t src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   dst),
               "r"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// `bytes` (a multiple of 16) of global memory at src (16-byte aligned) into
// this CTA's shared memory at dst, completing them on the mbarrier at `bar`:
// a 1-D bulk copy, no tensor map (one row of a tensor with strided rows)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// host: launch `kernel` on a grid of clusters of `cluster` CTAs along x
// (gridDim.x a multiple of it; 1: no cluster); a cudaError_t, 0 on success
// (a launch the card refuses is reported here, never run)
template <typename... Exp, typename... Act>
inline int launch_cluster(void (*kernel)(Exp...), dim3 grid, int threads, size_t smem, cudaStream_t s, int cluster,
                          Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// host: how many clusters of `cluster` CTAs of `kernel` the card runs at
// once (one CTA an SM): the persistent grid's size; 0 if it cannot say
template <typename... Exp>
inline int max_active_clusters(void (*kernel)(Exp...), int threads, size_t smem, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : 0;
}

// ---------------------------------------------------------------- cp.async

// 16 bytes of global memory at src (16-byte aligned) into this CTA's shared
// memory at dst, through L2 only (.cg); seen by this thread after
// cp_async_wait, by the others after a barrier that follows it
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `pending` of this thread's committed groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// ---------------------------------------------------------------- TMA

// one 64-column x box-rows box of a 3-D tensor map {D, L, B*H} at (col,
// row, bh) into shared memory; completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int col, int row, int bh,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// tma_load_3d into the same shared address of every CTA of the cluster in
// `mask` (bit r: rank r), completing bytes on the barrier at the same
// address in each
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst, const CUtensorMap* map, int col, int row, int bh,
                                                      uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(bh), "h"(mask)
      : "memory");
}

// rows [row0, row0 + ROWS) x 128 columns of head bh into a [2][ROWS][64]
// swizzled tile, as ROWS / 64 x 2 boxes of 64 x 64; rows past L arrive as zeros
template <int ROWS>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, int row0, int bh,
                                              uint32_t bar) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < ROWS; r += 64) tma_load_3d(dst + h * ROWS * 128 + r * 128, map, h * 64, row0 + r, bh, bar);
}

// one box of a 4-D tensor map at (c0, c1, c2, c3) into shared memory;
// completion counted in bytes on `bar`; coordinates may be negative or past
// the end: those elements arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of shared memory to a 4-D tensor map at (c0, c1, c2, c3); elements
// past the tensor's end are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

// one box of shared memory to a 2-D tensor map at (c0, c1); elements past
// the tensor's end are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// the committed stores have read their shared memory (it may be rewritten)
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// all but the last N committed store groups have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// the committed stores are complete
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// ---------------------------------------------------------------- registers

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);  // layout type 1: 128-byte swizzle
}

// the unswizzled ("interleave") layout: 8 x 16-byte core matrices, each 128
// contiguous bytes. K-major: LBO = bytes from one core matrix to the next
// along K, SBO = bytes from one 8-row group to the next along M (or N)
__device__ __forceinline__ uint64_t gmma_desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// K-major operand: rows [row0, row0 + 64) (or the N rows of B) of a [2][R][64]
// tile at `tile`, k16 step kk of the 128 columns
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int row0, int kk) {
  return gmma_desc(tile + (kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major B: k16 step kk over the R rows of a [2][R][64] tile, N = 128 columns
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 16 * 128, R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// wait until at most N committed groups are still running (groups complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across the async MMAs
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for register A operands, live until the MMAs that read them are done
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define VC_F4(d, i, c) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define VC_F16(d, i, c) VC_F4(d, i, c), VC_F4(d, i + 4, c), VC_F4(d, i + 8, c), VC_F4(d, i + 12, c)

#define VC_WGMMA_M64N64_SS                                                                \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                          \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
  "%32, %33, p, 1, 1, 0, 0;\n}\n"

// d (64 x 64, fp32) (+)= A (64 x 16, smem K-major) . B (16 x 64, smem K-major).
// Without `accumulate` d is write-only (scale-d = 0), so its old values are
// dead and hold no registers across the products that come before it.
__device__ __forceinline__ void wgmma_m64n64_ss(float* d, uint64_t a, uint64_t b, bool accumulate) {
  if (accumulate)
    asm volatile(VC_WGMMA_M64N64_SS : VC_F16(d, 0, "+f"), VC_F16(d, 16, "+f") : "l"(a), "l"(b), "r"(1));
  else
    asm volatile(VC_WGMMA_M64N64_SS : VC_F16(d, 0, "=f"), VC_F16(d, 16, "=f") : "l"(a), "l"(b), "r"(0));
}

#define VC_WGMMA_M64N128_RS                                                                \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                          \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
  "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"

// d (64 x 128, fp32) (+)= A (64 x 16, bf16 registers) . B (16 x 128, smem K-major)
__device__ __forceinline__ void wgmma_m64n128_rs(float* d, const uint32_t* a, uint64_t b, bool accumulate) {
  if (accumulate)
    asm volatile(VC_WGMMA_M64N128_RS
                 : VC_F16(d, 0, "+f"), VC_F16(d, 16, "+f"), VC_F16(d, 32, "+f"), VC_F16(d, 48, "+f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  else
    asm volatile(VC_WGMMA_M64N128_RS
                 : VC_F16(d, 0, "=f"), VC_F16(d, 16, "=f"), VC_F16(d, 32, "=f"), VC_F16(d, 48, "=f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 registers) . B (16 x 128, smem MN-major)
__device__ __forceinline__ void wgmma_m64n128_rs_tb(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : VC_F16(d, 0, "+f"), VC_F16(d, 16, "+f"), VC_F16(d, 32, "+f"), VC_F16(d, 48, "+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define VC_WGMMA_M64N32_RS                                                                \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                          \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "            \
  "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"

// d (64 x 32, fp32) (+)= A (64 x 16, bf16 registers) . B (16 x 32, smem K-major)
__device__ __forceinline__ void wgmma_m64n32_rs(float* d, const uint32_t* a, uint64_t b, bool accumulate) {
  if (accumulate)
    asm volatile(VC_WGMMA_M64N32_RS
                 : VC_F16(d, 0, "+f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  else
    asm volatile(VC_WGMMA_M64N32_RS
                 : VC_F16(d, 0, "=f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// d (64 x 256, fp32) += A (64 x 16, bf16 registers) . B (16 x 256, smem MN-major)
__device__ __forceinline__ void wgmma_m64n256_rs_tb(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : VC_F16(d, 0, "+f"), VC_F16(d, 16, "+f"), VC_F16(d, 32, "+f"), VC_F16(d, 48, "+f"),
        VC_F16(d, 64, "+f"), VC_F16(d, 80, "+f"), VC_F16(d, 96, "+f"), VC_F16(d, 112, "+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, smem K-major) . B (16 x 128, smem MN-major)
__device__ __forceinline__ void wgmma_m64n128_ss_tb(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : VC_F16(d, 0, "+f"), VC_F16(d, 16, "+f"), VC_F16(d, 32, "+f"), VC_F16(d, 48, "+f")
      : "l"(a), "l"(b), "r"(1));
}

#undef VC_WGMMA_M64N64_SS
#undef VC_WGMMA_M64N32_RS
#undef VC_WGMMA_M64N128_RS
#undef VC_F16
#undef VC_F4

// ---------------------------------------------------------------- host: tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tiled tensor map of `rank` dimensions over elements of `type` (bf16
// unless told otherwise) at ptr (dims innermost first, strides in bytes of
// dims 1.., box in elements), out-of-range elements read as zeros; 0 or a
// cudaError_t (a base or stride that is not 16-byte aligned is refused)
inline int encode_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                      CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16 != 0) return (int)cudaErrorMisalignedAddress;
  EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the 3-D map {D, L, B*H} of a contiguous (B, H, L, D) bf16 tensor, boxes of
// 64 columns x `box_rows` rows, 128-byte swizzle, out-of-range rows read as zeros
inline int tensor_map(CUtensorMap* map, const void* ptr, int L, int BH, int D = 128, int box_rows = 64) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace vc
