// The second pass of the backward kernels' column sums (J', K', L'): the
// per-CTA fp32 partials summed over their rows in a fixed order, so a
// gradient that reduces over thousands of tokens has the same bits at every
// launch (no atomics).
#pragma once

#include <cuda_runtime.h>

namespace vc {

constexpr int COLSUM_COLS = 32;   // a warp's consecutive columns: coalesced reads of the partials
constexpr int COLSUM_WARPS = 8;   // each warp sums every 8th row; the 8 sums are then added in order

// partial: sets x groups x nrows x C fp32; out_s[g * C + c] = the sum over r
// of partial[s][g][r][c], for set s = 0 (out0) and 1 (out1): warp w sums
// rows w, w + 8, ... in order, then warp 0 adds the 8 warps' sums in order
// (a fixed order, so the same bits at every launch). Grid
// (ceil(C / COLSUM_COLS), groups, sets), COLSUM_COLS * COLSUM_WARPS threads.
__global__ void __launch_bounds__(COLSUM_COLS * COLSUM_WARPS)
    column_sums(const float* __restrict__ partial, int groups, int nrows, int C, float* __restrict__ out0,
                float* __restrict__ out1) {
  __shared__ float sums[COLSUM_WARPS][COLSUM_COLS];
  const int lane = threadIdx.x % COLSUM_COLS, w = threadIdx.x / COLSUM_COLS;
  const int c = blockIdx.x * COLSUM_COLS + lane;
  const int g = blockIdx.y, s = blockIdx.z;
  float acc = 0.0f;
  if (c < C) {
    const float* p = partial + ((size_t)s * groups + g) * nrows * (size_t)C + c;
#pragma unroll 4
    for (int r = w; r < nrows; r += COLSUM_WARPS) acc += __ldg(p + (size_t)r * C);
  }
  sums[w][lane] = acc;
  __syncthreads();
  if (w != 0 || c >= C) return;
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < COLSUM_WARPS; ++i) total += sums[i][lane];
  (s == 0 ? out0 : out1)[(size_t)g * C + c] = total;
}

inline cudaError_t launch_column_sums(const float* partial, int sets, int groups, int nrows, int C, float* out0,
                                      float* out1, cudaStream_t stream) {
  const dim3 grid((C + COLSUM_COLS - 1) / COLSUM_COLS, groups, sets);
  column_sums<<<grid, COLSUM_COLS * COLSUM_WARPS, 0, stream>>>(partial, groups, nrows, C, out0, out1);
  return cudaGetLastError();
}

}  // namespace vc
